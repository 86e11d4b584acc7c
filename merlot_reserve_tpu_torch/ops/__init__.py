"""Tensor ops of the port: attention (flash kernel + dense), rotary, pooling."""
