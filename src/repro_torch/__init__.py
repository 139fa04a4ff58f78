"""CollaFuse in PyTorch with hand-written CUDA kernels for one NVIDIA H100.

The counterpart of the JAX/Pallas package ``repro``: each module sits at
the same relative path as the one it ports.  It imports neither JAX nor
``repro``.  Entry points run on CUDA unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
version, on CUDA it launches the kernel or raises.
"""
