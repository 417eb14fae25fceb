"""The sdim_query kernel: wrapper, plain version and CUDA source (csrc/)."""
