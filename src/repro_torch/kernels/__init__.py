"""Hand-written CUDA kernels for Hopper (``*/csrc``), each with its Python
wrapper, its plain PyTorch version and a launch counter. A wrapper runs the
plain version only for CPU tensors; for CUDA tensors it launches the kernel
or raises."""
