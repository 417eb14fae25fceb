"""The sdim_update kernel: wrapper, plain version and CUDA source (csrc/)."""
