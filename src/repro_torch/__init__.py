"""PyTorch/CUDA port of the SDIM reproduction (``repro``), for the NVIDIA
H100. It mirrors ``repro``'s layout module for module, imports only torch,
numpy and the standard library, and runs every kernel of its path as a
hand-written CUDA kernel for Hopper (``kernels/*/csrc``) with a plain
PyTorch version beside it for CPU tensors."""
