"""Model definitions of the port (NCHW inside, JAX layouts at the outputs)."""
