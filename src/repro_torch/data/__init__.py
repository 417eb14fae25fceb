"""Synthetic data (numpy on the host)."""
