"""KubeTPU's workloads in PyTorch on an NVIDIA H100.

A port of ``kubegpu_tpu`` with the same module layout: plain tensor code is
PyTorch, and each Pallas kernel of the reference becomes a hand-written
Hopper kernel (``csrc/``, built and bound by :mod:`kubegpu_tpu_torch.kernels`).
The package imports neither JAX nor ``kubegpu_tpu``.  Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
