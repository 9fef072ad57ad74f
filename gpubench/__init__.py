"""The benchmark of the PyTorch and CUDA port (`python3 gpubench/run.py`).

See gpubench/README.md. Nothing here imports JAX or the JAX package.
"""
