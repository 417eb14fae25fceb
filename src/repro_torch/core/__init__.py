"""SDIM core: SimHash, the bucket form, the engine and the CTR interest branch."""
