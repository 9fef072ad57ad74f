"""Sequence-parallel paths of the port (the JAX package's `parallel/`)."""
