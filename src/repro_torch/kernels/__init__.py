"""Hand-written Hopper kernels and their plain PyTorch versions.

``ops`` dispatches on the tensors' device: CUDA tensors launch the kernel
(CUDA C++ built by ``_build`` or Triton JIT), CPU tensors run ``ref``.
"""
