"""The plain reference: HSTU retrieval in plain PyTorch, float32.

It imports nothing of the port, of JAX or of the JAX package, and takes no
weight, table or scale that the port made: the benchmark makes the weights
and the inputs and hands the same to both sides.
"""
