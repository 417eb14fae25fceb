"""The sdim_bucket kernel: wrapper, plain version and CUDA source (csrc/)."""
