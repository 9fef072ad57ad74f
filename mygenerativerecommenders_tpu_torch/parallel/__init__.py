"""The parallel paths of the port (the JAX package's `parallel/` and its mesh):
the ring, the sharded table and top-k on one card, and data parallel over
processes (`process_group`)."""
