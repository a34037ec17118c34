"""Tensor ops of the port: preprocessing, image primitives, warp, TV-L1."""
