"""Model configurations and the arch registry."""
