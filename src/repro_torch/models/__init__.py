"""CTR models."""
