"""Multiplicity matrix of the sampled negatives: the Hopper kernel's wrapper
and its plain version.

`count_offsets(offsets [BT, R], positive [BT], num_catalog)` returns
`count [BT, X]` with `count[i, x] = #{r : offsets[i, r] == x}`, where a
draw equal to the row's positive offset (an accidental hit; -1 = the row has
no positive in the catalog) and a draw outside `[0, X)` (the sentinel that
pads rows) count 0. count is uint8 for R <= 255 draws a row and int32 above,
where a byte could overflow (the JAX package keeps bf16 counts there,
ops/dense_negatives.py:88-92, exact up to 256). It is what
`count_offsets_packed4` of the JAX package
(ops/dense_negatives.py:96) computes, in another layout: that one packs four
128-wide catalog slices into the radix-256 digits of a [BT, S/4, 128] uint32,
because its TPU consumers unpack digit planes along lanes and its MXU
accumulates in 32 bits. The CUDA consumer (ops/kernels/dense_neg_lse.py) reads
count a byte (or, above 255 draws, a word) per logit, so the count stays a
plain [BT, X] matrix.

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
# draws a row above which the count is int32: a bin may then pass 255
MAX_BYTE_DRAWS = 255
# kernel launches so far; callers that count (chip_smoke.py) reset it to 0
launches = 0

_lib: Optional[ctypes.CDLL] = None


def count_offsets_plain(
    offsets: torch.Tensor, positive: torch.Tensor, num_catalog: int
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, [BT, X] uint8 or, above
    MAX_BYTE_DRAWS draws a row, int32."""
    offsets = offsets.long()
    live = (offsets >= 0) & (offsets < num_catalog) & (offsets != positive.long()[:, None])
    # dead draws go to a spare column that is cut off again
    count = torch.zeros(
        (offsets.shape[0], num_catalog + 1), dtype=torch.int32, device=offsets.device
    )
    index = torch.where(live, offsets, num_catalog)
    count.scatter_add_(1, index, torch.ones_like(index, dtype=torch.int32))
    return count[:, :num_catalog].to(count_dtype(offsets.shape[1]))


def count_dtype(draws: int) -> torch.dtype:
    """The count's type for `draws` draws a row: a byte while no bin can
    pass 255."""
    return torch.uint8 if draws <= MAX_BYTE_DRAWS else torch.int32


def _check(offsets, positive, num_catalog):
    if offsets.ndim != 2 or tuple(positive.shape) != (offsets.shape[0],):
        raise ValueError(
            f"offsets must be [BT, R] and positive [BT], got {tuple(offsets.shape)} "
            f"and {tuple(positive.shape)}"
        )
    if num_catalog < 1:
        raise ValueError(f"num_catalog must be positive, got {num_catalog}")
    if offsets.device != positive.device:
        raise ValueError(f"inputs on {offsets.device} and {positive.device}")


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(KERNEL)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.count_offsets.argtypes = [p, p, p, i, i, i, i, p]
        lib.count_offsets.restype = i
        lib.count_offsets_smem_bytes.argtypes = [i, i]
        lib.count_offsets_smem_bytes.restype = ctypes.c_longlong
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(offsets, positive, num_catalog):
    global launches
    bt, r = offsets.shape
    lib = _kernel_lib()
    dtype = count_dtype(r)
    wide = int(dtype == torch.int32)
    smem = lib.count_offsets_smem_bytes(num_catalog, wide)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(
            f"catalog of {num_catalog} rows at R={r}: a block would need {smem} bytes of "
            f"shared memory, the card gives {_build.MAX_SMEM_BYTES}"
        )
    offsets = offsets.to(torch.int32).contiguous()
    positive = positive.to(torch.int32).contiguous()
    count = torch.empty((bt, num_catalog), dtype=dtype, device=offsets.device)
    if bt == 0:
        return count
    err = lib.count_offsets(
        offsets.data_ptr(), positive.data_ptr(), count.data_ptr(), bt, r, num_catalog, wide,
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
    """offsets [BT, R] int, positive [BT] int -> count [BT, num_catalog],
    uint8 for R <= 255 and int32 above."""
    _check(offsets, positive, num_catalog)
    if offsets.device.type == "cpu":
        return count_offsets_plain(offsets, positive, num_catalog)
    if offsets.device.type != "cuda":
        raise ValueError(f"no kernel for device {offsets.device}")
    return _launch(offsets, positive, num_catalog)
