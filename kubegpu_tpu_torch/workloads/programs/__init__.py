"""Programs a pod runs: ``python -m kubegpu_tpu_torch.workloads.programs.<name>``
(so far ``llama_serve``, ``llama_pjit``, ``vit_train``, ``t5_train`` and
``resnet_single``)."""
