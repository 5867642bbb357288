"""Dataset readers of the port (jax-free)."""
