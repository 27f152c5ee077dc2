"""Detection evaluation (copied from the JAX package, numpy only)."""
