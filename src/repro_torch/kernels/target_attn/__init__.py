"""The target_attn kernel (target_attention_flash): wrapper, plain version and CUDA source (csrc/)."""
