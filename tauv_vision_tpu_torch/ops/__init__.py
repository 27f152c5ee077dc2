"""Tensor ops of the port: plain PyTorch functions and kernel wrappers."""
