"""Decode and fused serving pipelines of the port."""
