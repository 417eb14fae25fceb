"""Training: optimizer, gradient compression, checkpoints and the loop."""
