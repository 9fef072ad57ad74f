"""Multiplicity matrix of the sampled negatives: the Hopper kernel's wrapper
and its plain version.

`count_offsets(offsets [BT, R], positive [BT], num_catalog)` returns
`count [BT, X]` uint8 with `count[i, x] = #{r : offsets[i, r] == x}`, where a
draw equal to the row's positive offset (an accidental hit; -1 = the row has
no positive in the catalog) and a draw outside `[0, X)` (the sentinel that
pads rows) count 0. It is what `count_offsets_packed4` of the JAX package
(ops/dense_negatives.py:96) computes, in another layout: that one packs four
128-wide catalog slices into the radix-256 digits of a [BT, S/4, 128] uint32,
because its TPU consumers unpack digit planes along lanes and its MXU
accumulates in 32 bits. The CUDA consumer (ops/kernels/dense_neg_lse.py) reads
count a byte per logit, so the count stays a plain [BT, X] byte matrix.

On a CUDA tensor it launches csrc/count_offsets.cu (built by nvcc at first
use) or raises; on a CPU tensor it computes `count_offsets_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mygenerativerecommenders_tpu_torch.ops.kernels import _build

KERNEL = "count_offsets"
SOURCE = "mygenerativerecommenders_tpu_torch/csrc/count_offsets.cu"
REPLACES = "mygenerativerecommenders_tpu/ops/pallas/count_kernel.py:58"
# kernel launches so far; callers that count (chip_smoke.py) reset it to 0
launches = 0

_lib: Optional[ctypes.CDLL] = None


def count_offsets_plain(
    offsets: torch.Tensor, positive: torch.Tensor, num_catalog: int
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, [BT, X] uint8."""
    offsets = offsets.long()
    live = (offsets >= 0) & (offsets < num_catalog) & (offsets != positive.long()[:, None])
    # dead draws go to a spare column that is cut off again
    count = torch.zeros(
        (offsets.shape[0], num_catalog + 1), dtype=torch.int32, device=offsets.device
    )
    index = torch.where(live, offsets, num_catalog)
    count.scatter_add_(1, index, torch.ones_like(index, dtype=torch.int32))
    return count[:, :num_catalog].to(torch.uint8)


def _check(offsets, positive, num_catalog):
    if offsets.ndim != 2 or tuple(positive.shape) != (offsets.shape[0],):
        raise ValueError(
            f"offsets must be [BT, R] and positive [BT], got {tuple(offsets.shape)} "
            f"and {tuple(positive.shape)}"
        )
    if offsets.shape[1] > 255:
        raise ValueError(f"R={offsets.shape[1]} draws a row overflow a uint8 count")
    if num_catalog < 1:
        raise ValueError(f"num_catalog must be positive, got {num_catalog}")
    if offsets.device != positive.device:
        raise ValueError(f"inputs on {offsets.device} and {positive.device}")


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(KERNEL)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.count_offsets.argtypes = [p, p, p, i, i, i, p]
        lib.count_offsets.restype = i
        lib.count_offsets_smem_bytes.argtypes = [i]
        lib.count_offsets_smem_bytes.restype = ctypes.c_longlong
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(offsets, positive, num_catalog):
    global launches
    bt, r = offsets.shape
    lib = _kernel_lib()
    smem = lib.count_offsets_smem_bytes(num_catalog)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(
            f"catalog of {num_catalog} rows: a block would need {smem} bytes of shared memory"
        )
    offsets = offsets.to(torch.int32).contiguous()
    positive = positive.to(torch.int32).contiguous()
    count = torch.empty((bt, num_catalog), dtype=torch.uint8, device=offsets.device)
    if bt == 0:
        return count
    err = lib.count_offsets(
        offsets.data_ptr(), positive.data_ptr(), count.data_ptr(), bt, r, num_catalog,
        torch.cuda.current_stream(offsets.device).cuda_stream,
    )
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err} ({msg})")
    launches += 1
    return count


def count_offsets(
    offsets: torch.Tensor, positive: torch.Tensor, num_catalog: int
) -> torch.Tensor:
    """offsets [BT, R] int, positive [BT] int -> count [BT, num_catalog] uint8."""
    _check(offsets, positive, num_catalog)
    if offsets.device.type == "cpu":
        return count_offsets_plain(offsets, positive, num_catalog)
    if offsets.device.type != "cuda":
        raise ValueError(f"no kernel for device {offsets.device}")
    return _launch(offsets, positive, num_catalog)
