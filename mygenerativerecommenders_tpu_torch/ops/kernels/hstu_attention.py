"""Fused HSTU attention forward: the Hopper kernel's wrapper and its plain version.

`hstu_attention_fused` has the interface of the JAX package's
`ops/pallas/hstu_attention.py:hstu_attention_fused` (:225): q, k [B, N, H, Dqk],
v [B, N, H, Dv], int timestamps [B, N], the bias tables pos_w [2L-1] and
ts_w [num_buckets+1], the static L = max_len and per-row `lengths`. Rows at or
past `lengths` come out zero (the fused contract; the dense reference is not
zero there).

On a CUDA tensor it launches csrc/hstu_attention_fwd.cu (built by nvcc at
first use) or raises; on a CPU tensor it computes
`hstu_attention_fused_plain`, the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from mygenerativerecommenders_tpu_torch import not_ported
from mygenerativerecommenders_tpu_torch.ops.hstu_attention import (
    relative_position_bias,
    relative_time_bias,
)
from mygenerativerecommenders_tpu_torch.ops.kernels import _build

KERNEL = "hstu_attention_fwd"
SOURCE = "mygenerativerecommenders_tpu_torch/csrc/hstu_attention_fwd.cu"
REPLACES = "mygenerativerecommenders_tpu/ops/pallas/hstu_attention.py:118"
# kernel launches so far; callers that count (chip_smoke.py) reset it to 0.
# The serving engine makes its calls under one lock, so `+= 1` stays exact.
launches = 0

_MAX_SMEM = 232448  # bytes a block may use on an H100
_lib: Optional[ctypes.CDLL] = None


def hstu_attention_fused_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    timestamps: torch.Tensor,
    pos_w: torch.Tensor,
    ts_w: torch.Tensor,
    max_len: int,
    num_buckets: int,
    lengths: torch.Tensor,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, [B, N, H, Dv] float32."""
    n = q.shape[1]
    bias = relative_position_bias(pos_w.float(), n, max_len)[None]
    bias = bias + relative_time_bias(ts_w.float(), timestamps, num_buckets)
    z = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) + bias[:, None]
    seq_len = torch.clamp(lengths.to(q.device), max=n)
    idx = torch.arange(n, device=q.device)
    valid = idx[None, :] < seq_len[:, None]  # [B, N]
    live = (idx[None, :] <= idx[:, None])[None] & valid[:, :, None] & valid[:, None, :]
    a = torch.where(live[:, None], F.silu(z) * (1.0 / max_len), 0.0)
    return torch.einsum("bhnm,bmhd->bnhd", a, v.float())


def _check(q, k, v, timestamps, pos_w, ts_w, max_len, num_buckets, lengths):
    b, n, h, dqk = q.shape
    dv = v.shape[-1]
    if k.shape != q.shape or v.shape[:3] != (b, n, h):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if n > max_len:
        raise ValueError(f"sequence dim {n} > max_len {max_len}")
    if tuple(timestamps.shape) != (b, n) or tuple(lengths.shape) != (b,):
        raise ValueError("timestamps must be [B, N] and lengths [B]")
    if pos_w.numel() != 2 * max_len - 1 or ts_w.numel() != num_buckets + 1:
        raise ValueError("pos_w must hold 2*max_len-1 and ts_w num_buckets+1 entries")
    devices = {t.device for t in (q, k, v, timestamps, pos_w, ts_w, lengths)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    return b, n, h, dqk, dv


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(KERNEL)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hstu_attention_fwd.argtypes = [p] * 8 + [i] * 5 + [ll] * 7 + [i, i, p]
        lib.hstu_attention_fwd.restype = i
        lib.hstu_attention_fwd_smem_bytes.argtypes = [i, i, i, i]
        lib.hstu_attention_fwd_smem_bytes.restype = ll
        lib.hstu_cuda_error_string.argtypes = [i]
        lib.hstu_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(q, k, v, timestamps, pos_w, ts_w, max_len, num_buckets, lengths):
    global launches
    b, n, h, dqk, dv = _check(
        q, k, v, timestamps, pos_w, ts_w, max_len, num_buckets, lengths
    )
    for name, t, d in (("q", q, dqk), ("k", k, dqk), ("v", v, dv)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 for the CUDA kernel, got {t.dtype}")
        # heads contiguous inside a row; rows and batches may be strided
        # (q, k, v are column slices of the uvqk projection)
        if t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError(f"{name} needs contiguous [H, d] rows, strides {t.stride()}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid.y limit 65535")
    lib = _kernel_lib()
    smem = lib.hstu_attention_fwd_smem_bytes(h, dqk, dv, num_buckets)
    if smem > _MAX_SMEM:
        raise ValueError(f"H*d too wide: a block would need {smem} bytes of shared memory")
    ts = timestamps.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    pos_w = pos_w.to(torch.float32).contiguous()
    ts_w = ts_w.to(torch.float32).contiguous()
    out = torch.empty((b, n, h, dv), dtype=torch.float32, device=q.device)
    err = lib.hstu_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ts.data_ptr(), lens.data_ptr(),
        pos_w.data_ptr(), ts_w.data_ptr(), out.data_ptr(),
        b, n, h, dqk, dv,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        ts.stride(0), max_len, num_buckets,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        msg = lib.hstu_cuda_error_string(err).decode()
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err} ({msg})")
    launches += 1
    return out


def hstu_attention_fused(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    timestamps: torch.Tensor,
    pos_w: torch.Tensor,
    ts_w: torch.Tensor,
    max_len: int,
    num_buckets: int,
    lengths: Optional[torch.Tensor] = None,
    seg_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused HSTU attention with the relative time+position bias built inside.

    Returns [B, N, H, Dv] float32, zero at rows >= lengths.
    """
    if seg_positions is not None:
        raise not_ported("packed seg_positions", "Packing")
    if lengths is None:
        lengths = torch.full((q.shape[0],), q.shape[1], dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        _check(q, k, v, timestamps, pos_w, ts_w, max_len, num_buckets, lengths)
        return hstu_attention_fused_plain(
            q, k, v, timestamps, pos_w, ts_w, max_len, num_buckets, lengths
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _launch(q, k, v, timestamps, pos_w, ts_w, max_len, num_buckets, lengths)
