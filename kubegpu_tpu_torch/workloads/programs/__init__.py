"""Programs a pod runs: ``python -m kubegpu_tpu_torch.workloads.programs.<name>``
(``llama_serve``, ``llama_pjit``, ``allreduce_bench``, ``vit_train``,
``t5_train``, ``resnet_single``, ``mnist_mlp`` and ``mnist_torch``)."""
