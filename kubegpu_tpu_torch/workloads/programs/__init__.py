"""Programs a pod runs: ``python -m kubegpu_tpu_torch.workloads.programs.<name>``
(so far ``llama_serve``)."""
