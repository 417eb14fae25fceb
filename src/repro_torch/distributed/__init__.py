"""Analytical models of the card (the roofline the profiler predicts with)."""
