"""PyTorch + CUDA port of mygenerativerecommenders_tpu for one NVIDIA H100.

The JAX package beside it is the reference; this package mirrors its module
paths and imports nothing of it. Entry points run on `cuda` unless the caller
passes `device="cpu"`; on the CPU every kernel wrapper computes its plain
PyTorch version instead.
"""

import torch

# Full float32 matmuls and convolutions on the card: TF32 keeps ~3 decimal
# digits, which would break the float32 parity with the JAX reference that
# the tests and chip_smoke.py hold the port to.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

