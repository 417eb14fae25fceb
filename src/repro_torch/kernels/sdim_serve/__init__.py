"""The sdim_serve kernel (bse_serve): wrapper, plain version and CUDA source (csrc/)."""
