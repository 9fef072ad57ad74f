"""Fused HSTU attention, forward and backward: the Hopper kernels' wrapper and
its plain version.

`hstu_attention_fused` has the interface of the JAX package's
`ops/pallas/hstu_attention.py:hstu_attention_fused` (:225): q, k [B, N, H, Dqk],
v [B, N, H, Dv], int timestamps [B, N], the bias tables pos_w [2L-1] and
ts_w [num_buckets+1], the static L = max_len, per-row `lengths` and, for
packed rows, `seg_positions` [B, N]: each token's position inside its segment.
Rows at or past `lengths` come out zero (the fused contract; the dense
reference is not zero there). With `seg_positions` a query sees only the keys
of its own segment, those from row - position on; `lengths` is then the row's
packed tokens, the row may be wider than L (its segments may not), and the
normaliser stays 1/L.

On a CUDA tensor it is a `torch.autograd.Function`: the forward launches
csrc/hstu_attention_fwd.cu, which writes each output row once (bit-identical
from run to run), and saves only its inputs (nothing [N, N]-shaped, as
`_fused_fwd` of the JAX package, :818); the backward launches
csrc/hstu_attention_bwd.cu, which recomputes the scores and returns dq, dk,
dv (bit-identical from run to run: no atomics touch them), d_pos_w and
d_ts_w. Heads up to 128 wide take each source's register-tiled kernel; wider
ones (any dqk and dv, as the JAX kernels) its wide kernel, which stages depth
in 128-column slices and writes one 128-column slice of each output a block,
through the same entry point and launch count. Both are built by nvcc at first use; a failed build or launch
raises. On a CPU tensor it computes `hstu_attention_fused_plain`,
the same function in plain PyTorch, and autograd differentiates that.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from mygenerativerecommenders_tpu_torch.ops.hstu_attention import (
    relative_position_bias,
    relative_time_bias,
)
from mygenerativerecommenders_tpu_torch.ops.kernels import _build

KERNEL = "hstu_attention_fwd"
SOURCE = "mygenerativerecommenders_tpu_torch/csrc/hstu_attention_fwd.cu"
REPLACES = "mygenerativerecommenders_tpu/ops/pallas/hstu_attention.py:118"
KERNEL_BWD = "hstu_attention_bwd"
SOURCE_BWD = "mygenerativerecommenders_tpu_torch/csrc/hstu_attention_bwd.cu"
REPLACES_BWD = "mygenerativerecommenders_tpu/ops/pallas/hstu_attention.py:425"
# kernel launches so far, forward and backward; callers that count
# (chip_smoke.py) reset them to 0. The serving engine makes its calls under
# one lock and the trainer runs one step at a time, so `+= 1` stays exact.
launches = 0
bwd_launches = 0

_lib: Optional[ctypes.CDLL] = None
_lib_bwd: Optional[ctypes.CDLL] = None


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
    seg_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, [B, N, H, Dv] float32."""
    n = q.shape[1]
    bias = relative_position_bias(pos_w.float(), n, max_len)[None]
    bias = bias + relative_time_bias(ts_w.float(), timestamps, num_buckets)
    z = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) + bias[:, None]
    seq_len = torch.clamp(lengths.to(q.device), max=n)
    idx = torch.arange(n, device=q.device)
    valid = idx[None, :] < seq_len[:, None]  # [B, N]
    # causal, and less than max_len apart: further than the table reaches a
    # pair is in two segments (it cannot occur in an unpacked row, n <= max_len)
    apart = idx[:, None] - idx[None, :]
    live = ((apart >= 0) & (apart < max_len))[None] & valid[:, :, None] & valid[:, None, :]
    if seg_positions is not None:
        start = idx[None, :] - seg_positions.to(q.device).long()  # [B, N] segment start per row
        live = live & (idx[None, None, :] >= start[:, :, None])
    a = torch.where(live[:, None], F.silu(z) * (1.0 / max_len), 0.0)
    return torch.einsum("bhnm,bmhd->bnhd", a, v.float())


def _check(q, k, v, timestamps, pos_w, ts_w, max_len, num_buckets, lengths, seg_positions):
    b, n, h, dqk = q.shape
    dv = v.shape[-1]
    if k.shape != q.shape or v.shape[:3] != (b, n, h):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if n > max_len and seg_positions is None:
        # only a packed row may be wider than max_len: its segments are not
        raise ValueError(f"sequence dim {n} > max_len {max_len}")
    if tuple(timestamps.shape) != (b, n) or tuple(lengths.shape) != (b,):
        raise ValueError("timestamps must be [B, N] and lengths [B]")
    if seg_positions is not None and tuple(seg_positions.shape) != (b, n):
        raise ValueError(f"seg_positions must be [B, N], got {tuple(seg_positions.shape)}")
    if pos_w.numel() != 2 * max_len - 1 or ts_w.numel() != num_buckets + 1:
        raise ValueError("pos_w must hold 2*max_len-1 and ts_w num_buckets+1 entries")
    operands = [q, k, v, timestamps, pos_w, ts_w, lengths]
    if seg_positions is not None:
        operands.append(seg_positions)
    devices = {t.device for t in operands}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    return b, n, h, dqk, dv


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(KERNEL)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hstu_attention_fwd.argtypes = [p] * 9 + [i] * 5 + [ll] * 8 + [i, i, p]
        lib.hstu_attention_fwd.restype = i
        lib.hstu_attention_fwd_smem_bytes.argtypes = [i, i, i]
        lib.hstu_attention_fwd_smem_bytes.restype = ll
        lib.hstu_cuda_error_string.argtypes = [i]
        lib.hstu_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _kernel_lib_bwd() -> ctypes.CDLL:
    global _lib_bwd
    if _lib_bwd is None:
        lib = _build.load(KERNEL_BWD)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hstu_attention_bwd.argtypes = [p] * 14 + [i] * 5 + [ll] * 8 + [i, i, p]
        lib.hstu_attention_bwd.restype = i
        lib.hstu_attention_bwd_smem_bytes.argtypes = [i] * 5
        lib.hstu_attention_bwd_smem_bytes.restype = ll
        lib.hstu_bwd_cuda_error_string.argtypes = [i]
        lib.hstu_bwd_cuda_error_string.restype = ctypes.c_char_p
        _lib_bwd = lib
    return _lib_bwd


def _prepare(q, k, v, timestamps, pos_w, ts_w, max_len, num_buckets, lengths, seg_positions):
    """Checks what the kernels do not take and brings the small operands to
    the types they read: int32 timestamps, lengths and segment positions (None
    stays None: the kernels' null pointer), float32 tables."""
    b, n, h, dqk, dv = _check(
        q, k, v, timestamps, pos_w, ts_w, max_len, num_buckets, lengths, seg_positions
    )
    for name, t, d in (("q", q, dqk), ("k", k, dqk), ("v", v, dv)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 for the CUDA kernel, got {t.dtype}")
        # heads contiguous inside a row; rows and batches may be strided
        # (q, k, v are column slices of the uvqk projection)
        if t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError(f"{name} needs contiguous [H, d] rows, strides {t.stride()}")
    ts = timestamps.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    pos_w = pos_w.detach().to(torch.float32).contiguous()
    ts_w = ts_w.detach().to(torch.float32).contiguous()
    seg = None if seg_positions is None else seg_positions.to(torch.int32).contiguous()
    return ts, lens, seg, pos_w, ts_w


def _seg_args(seg):
    """(pointer, row stride) of the segment positions; the null pointer for
    unpacked rows."""
    return (None, 0) if seg is None else (seg.data_ptr(), seg.stride(0))


def _launch(q, k, v, ts, lens, seg, pos_w, ts_w, max_len, num_buckets):
    """The forward kernel on prepared operands -> out [B, N, H, Dv]."""
    global launches
    b, n, h, dqk = q.shape
    dv = v.shape[-1]
    lib = _kernel_lib()
    smem = lib.hstu_attention_fwd_smem_bytes(dqk, dv, num_buckets)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(
            f"dqk={dqk}, dv={dv}: a block would need {smem} bytes of shared "
            f"memory, the card gives {_build.MAX_SMEM_BYTES}"
        )
    out = torch.empty((b, n, h, dv), dtype=torch.float32, device=q.device)
    seg_ptr, seg_sb = _seg_args(seg)
    err = lib.hstu_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ts.data_ptr(), lens.data_ptr(), seg_ptr,
        pos_w.data_ptr(), ts_w.data_ptr(), out.data_ptr(),
        b, n, h, dqk, dv,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        ts.stride(0), seg_sb, max_len, num_buckets,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        msg = lib.hstu_cuda_error_string(err).decode()
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err} ({msg})")
    launches += 1
    return out


def _launch_bwd(q, k, v, g, ts, lens, seg, pos_w, ts_w, max_len, num_buckets):
    """The backward kernel on prepared operands -> dq, dk, dv, d_pos_w, d_ts_w."""
    global bwd_launches
    b, n, h, dqk = q.shape
    dv = v.shape[-1]
    lib = _kernel_lib_bwd()
    smem = lib.hstu_attention_bwd_smem_bytes(n, dqk, dv, max_len, num_buckets)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(
            f"N={n}, dqk={dqk}, dv={dv}, max_len={max_len}: a block would need {smem} "
            f"bytes of shared memory, the card gives {_build.MAX_SMEM_BYTES}"
        )
    g = g.to(torch.float32).contiguous()
    dev = q.device
    # the kernel writes dq, dk and dv whole and adds into the tables
    dq = torch.empty((b, n, h, dqk), dtype=torch.float32, device=dev)
    dk = torch.empty((b, n, h, dqk), dtype=torch.float32, device=dev)
    dv_out = torch.empty((b, n, h, dv), dtype=torch.float32, device=dev)
    dpw = torch.zeros_like(pos_w)
    dtw = torch.zeros_like(ts_w)
    seg_ptr, seg_sb = _seg_args(seg)
    err = lib.hstu_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), ts.data_ptr(),
        lens.data_ptr(), seg_ptr, pos_w.data_ptr(), ts_w.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv_out.data_ptr(), dpw.data_ptr(), dtw.data_ptr(),
        b, n, h, dqk, dv,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        ts.stride(0), seg_sb, max_len, num_buckets,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.hstu_bwd_cuda_error_string(err).decode()
        raise RuntimeError(f"{KERNEL_BWD} launch failed: CUDA error {err} ({msg})")
    bwd_launches += 1
    return dq, dk, dv_out, dpw, dtw


class _FusedAttention(torch.autograd.Function):
    """Forward kernel, inputs saved, backward kernel."""

    @staticmethod
    def forward(
        ctx, q, k, v, pos_w, ts_w, timestamps, lengths, seg_positions, max_len, num_buckets
    ):
        ts, lens, seg, pw, tw = _prepare(
            q, k, v, timestamps, pos_w, ts_w, max_len, num_buckets, lengths, seg_positions
        )
        ctx.save_for_backward(q, k, v, ts, lens, seg, pw, tw)
        ctx.max_len, ctx.num_buckets = max_len, num_buckets
        ctx.table_dtypes = (pos_w.dtype, ts_w.dtype)
        return _launch(q, k, v, ts, lens, seg, pw, tw, max_len, num_buckets)

    @staticmethod
    def backward(ctx, g):
        q, k, v, ts, lens, seg, pw, tw = ctx.saved_tensors
        dq, dk, dv, dpw, dtw = _launch_bwd(
            q, k, v, g, ts, lens, seg, pw, tw, ctx.max_len, ctx.num_buckets
        )
        dpw, dtw = dpw.to(ctx.table_dtypes[0]), dtw.to(ctx.table_dtypes[1])
        return dq, dk, dv, dpw, dtw, None, None, None, None, None


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

    Returns [B, N, H, Dv] float32, zero at rows >= lengths; differentiable in
    q, k, v, pos_w and ts_w. `seg_positions` [B, N] marks packed rows: the
    attention is block-diagonal over the segments.
    """
    if lengths is None:
        lengths = torch.full((q.shape[0],), q.shape[1], dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        _check(q, k, v, timestamps, pos_w, ts_w, max_len, num_buckets, lengths, seg_positions)
        return hstu_attention_fused_plain(
            q, k, v, timestamps, pos_w, ts_w, max_len, num_buckets, lengths, seg_positions
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _FusedAttention.apply(
        q, k, v, pos_w, ts_w, timestamps, lengths, seg_positions, max_len, num_buckets
    )
