"""Dense layers as nn.Modules."""
