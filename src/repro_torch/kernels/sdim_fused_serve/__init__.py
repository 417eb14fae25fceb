"""The sdim_fused_serve kernel: wrapper, plain version and CUDA source (csrc/)."""
