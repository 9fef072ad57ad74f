"""Chunk HSTU attention of one ring step, forward and backward: the Hopper
kernels' wrapper and its plain version.

`hstu_chunk_attention` has the interface of the JAX package's
`ops/pallas/hstu_chunk.py:hstu_chunk_attention` (:515): the partial HSTU
attention of Nq query rows against one Nc-row K/V chunk,

    out[b, n, h, :] = sum_m silu(q[b,n,h].k[b,m,h] + pos_w[clip(m - n + off_delta + L - 1)]
                                 + ts_w[bucket(tsq_next[b,n] - tsk[b,m])]) * inv_n * v[b,m,h,:]

over the pairs with n - m >= off_delta (n < Nq, m < Nc), where off_delta is
the chunk's first global column less the query rows' first global row, a
Python int. The table index is clipped to [0, 2L-2]: rows of a sequence
padded past L reach below the table and read its first entry. Nq and Nc may
differ. Unlike the fused full-sequence kernel there is no `lengths`: rows
past a user's length are live here, and the model is indifferent to them
only because the block's u is silu(0) = 0 on its zero rows.

On a CUDA tensor it is a `torch.autograd.Function`: the forward launches
csrc/hstu_chunk_fwd.cu and saves only its inputs; the backward launches
csrc/hstu_chunk_bwd.cu, which recomputes the scores in two passes of one
launch (one owns dk and dv, the other dq and the tables) and returns dq, dk,
dv, d_pos_w and d_ts_w (adding a clipped pair's gradient into the slot it
read). The output, dq, dk and dv take no atomics and are bit-identical from
call to call; only the two table gradients are summed with float atomics. A
chunk with off_delta >= Nq has no live pair: both kernels then write zeros,
as does the backward for key rows no live pair reaches. Heads of any width:
above 128 columns (dqk or dv) both sources launch their wide kernel, which
stages depth in 128-column slices and puts one 128-column output slice a
block on the grid, with the same shared memory at every width.
On a CPU tensor it computes `hstu_chunk_attention_plain`, the port's copy of
the JAX ring's jnp chunk body (`parallel/ring_attention.py:_chunk_contribution`
with use_pallas=False, :85-101), and autograd differentiates that.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from mygenerativerecommenders_tpu_torch.ops.hstu_attention import bucketize_timedelta
from mygenerativerecommenders_tpu_torch.ops.kernels import _build

KERNEL = "hstu_chunk_fwd"
SOURCE = "mygenerativerecommenders_tpu_torch/csrc/hstu_chunk_fwd.cu"
REPLACES = "mygenerativerecommenders_tpu/ops/pallas/hstu_chunk.py:70"
KERNEL_BWD = "hstu_chunk_bwd"
SOURCE_BWD = "mygenerativerecommenders_tpu_torch/csrc/hstu_chunk_bwd.cu"
REPLACES_BWD = "mygenerativerecommenders_tpu/ops/pallas/hstu_chunk.py:254"
# kernel launches so far, forward and backward; callers that count
# (chip_smoke.py) reset them to 0
launches = 0
bwd_launches = 0

_lib: Optional[ctypes.CDLL] = None
_lib_bwd: Optional[ctypes.CDLL] = None


def hstu_chunk_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tsq_next: torch.Tensor,
    tsk: torch.Tensor,
    off_delta: int,
    pos_w: torch.Tensor,
    ts_w: torch.Tensor,
    *,
    inv_n: float,
    max_len: int,
    num_buckets: int,
) -> torch.Tensor:
    """The kernels' function in plain PyTorch, [B, Nq, H, Dv] float32."""
    nq, nc = q.shape[1], k.shape[1]
    rows = torch.arange(nq, device=q.device)[:, None]
    cols = off_delta + torch.arange(nc, device=q.device)[None, :]
    # pos term: pos_w[(m - n) + max_len - 1], clipped like the kernels
    pos_idx = torch.clamp(cols - rows + (max_len - 1), 0, 2 * max_len - 2)
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    bias = pos_w.float()[pos_idx][None]  # [1, Nq, Nc]
    delta = tsq_next.to(torch.int32)[:, :, None] - tsk.to(torch.int32)[:, None, :]
    bias = bias + ts_w.float()[bucketize_timedelta(delta, num_buckets)]
    attn = F.silu(s + bias[:, None]) * inv_n
    attn = torch.where((rows >= cols)[None, None], attn, 0.0)
    return torch.einsum("bhnm,bmhd->bnhd", attn, v.float())


def _check(q, k, v, tsq_next, tsk, pos_w, ts_w, max_len, num_buckets):
    b, nq, h, dqk = q.shape
    nc, dv = k.shape[1], v.shape[-1]
    if k.shape[0] != b or k.shape[2:] != (h, dqk) or v.shape[:3] != (b, nc, h):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if tuple(tsq_next.shape) != (b, nq) or tuple(tsk.shape) != (b, nc):
        raise ValueError("tsq_next must be [B, Nq] and tsk [B, Nc]")
    if pos_w.numel() != 2 * max_len - 1 or ts_w.numel() != num_buckets + 1:
        raise ValueError("pos_w must hold 2*max_len-1 and ts_w num_buckets+1 entries")
    devices = {t.device for t in (q, k, v, tsq_next, tsk, pos_w, ts_w)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    return b, nq, nc, h, dqk, dv


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(KERNEL)
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.hstu_chunk_fwd.argtypes = [p] * 8 + [i] * 6 + [ll] * 8 + [i, i, i, f, p]
        lib.hstu_chunk_fwd.restype = i
        lib.hstu_chunk_fwd_smem_bytes.argtypes = [i, i, i]
        lib.hstu_chunk_fwd_smem_bytes.restype = ll
        lib.hstu_chunk_cuda_error_string.argtypes = [i]
        lib.hstu_chunk_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _kernel_lib_bwd() -> ctypes.CDLL:
    global _lib_bwd
    if _lib_bwd is None:
        lib = _build.load(KERNEL_BWD)
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.hstu_chunk_bwd.argtypes = [p] * 13 + [i] * 6 + [ll] * 8 + [i, i, i, f, p]
        lib.hstu_chunk_bwd.restype = i
        lib.hstu_chunk_bwd_smem_bytes.argtypes = [i] * 4
        lib.hstu_chunk_bwd_smem_bytes.restype = ll
        lib.hstu_chunk_bwd_cuda_error_string.argtypes = [i]
        lib.hstu_chunk_bwd_cuda_error_string.restype = ctypes.c_char_p
        _lib_bwd = lib
    return _lib_bwd


def _prepare(q, k, v, tsq_next, tsk, pos_w, ts_w):
    """Checks what the kernels do not take and brings the small operands to
    the types they read: int32 timestamps (rows may be strided), float32
    tables."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 for the CUDA kernel, got {t.dtype}")
        # heads contiguous inside a row; rows and batches may be strided
        # (q, k, v are chunk slices of the uvqk projection's column slices)
        if t.stride(3) != 1 or t.stride(2) != t.shape[3]:
            raise ValueError(f"{name} needs contiguous [H, d] rows, strides {t.stride()}")

    def stamps(ts):
        ts = ts.to(torch.int32)
        return ts if ts.stride(1) == 1 else ts.contiguous()

    pos_w = pos_w.detach().to(torch.float32).contiguous()
    ts_w = ts_w.detach().to(torch.float32).contiguous()
    return stamps(tsq_next), stamps(tsk), pos_w, ts_w


def _strides(q, k, v, tsq, tsk):
    return (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            tsq.stride(0), tsk.stride(0))


def _launch(q, k, v, tsq, tsk, pos_w, ts_w, off_delta, inv_n, max_len, num_buckets):
    """The forward kernel on prepared operands -> out [B, Nq, H, Dv]."""
    global launches
    b, nq, h, dqk = q.shape
    nc, dv = k.shape[1], v.shape[-1]
    lib = _kernel_lib()
    smem = lib.hstu_chunk_fwd_smem_bytes(dqk, dv, num_buckets)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(
            f"dqk={dqk}, dv={dv}: a block would need {smem} bytes of shared "
            f"memory, the card gives {_build.MAX_SMEM_BYTES}"
        )
    out = torch.empty((b, nq, h, dv), dtype=torch.float32, device=q.device)
    err = lib.hstu_chunk_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), tsq.data_ptr(), tsk.data_ptr(),
        pos_w.data_ptr(), ts_w.data_ptr(), out.data_ptr(),
        b, nq, nc, h, dqk, dv, *_strides(q, k, v, tsq, tsk),
        off_delta, max_len, num_buckets, inv_n,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        msg = lib.hstu_chunk_cuda_error_string(err).decode()
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err} ({msg})")
    launches += 1
    return out


def _launch_bwd(q, k, v, g, tsq, tsk, pos_w, ts_w, off_delta, inv_n, max_len, num_buckets):
    """The backward kernel on prepared operands -> dq, dk, dv, d_pos_w, d_ts_w."""
    global bwd_launches
    b, nq, h, dqk = q.shape
    nc, dv = k.shape[1], v.shape[-1]
    lib = _kernel_lib_bwd()
    smem = lib.hstu_chunk_bwd_smem_bytes(dqk, dv, max_len, num_buckets)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(
            f"dqk={dqk}, dv={dv}, max_len={max_len}: a block would need {smem} "
            f"bytes of shared memory, the card gives {_build.MAX_SMEM_BYTES}"
        )
    g = g.to(torch.float32).contiguous()
    dev = q.device
    # the kernel writes dq, dk and dv whole and adds into the tables
    dq = torch.empty((b, nq, h, dqk), dtype=torch.float32, device=dev)
    dk = torch.empty((b, nc, h, dqk), dtype=torch.float32, device=dev)
    dv_out = torch.empty((b, nc, h, dv), dtype=torch.float32, device=dev)
    dpw = torch.zeros_like(pos_w)
    dtw = torch.zeros_like(ts_w)
    err = lib.hstu_chunk_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), tsq.data_ptr(),
        tsk.data_ptr(), pos_w.data_ptr(), ts_w.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv_out.data_ptr(), dpw.data_ptr(), dtw.data_ptr(),
        b, nq, nc, h, dqk, dv, *_strides(q, k, v, tsq, tsk),
        off_delta, max_len, num_buckets, inv_n,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.hstu_chunk_bwd_cuda_error_string(err).decode()
        raise RuntimeError(f"{KERNEL_BWD} launch failed: CUDA error {err} ({msg})")
    bwd_launches += 1
    return dq, dk, dv_out, dpw, dtw


class _ChunkAttention(torch.autograd.Function):
    """Forward kernel, inputs saved (no scores), backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, pos_w, ts_w, tsq_next, tsk, off_delta, inv_n, max_len,
                num_buckets):
        tsq, tsk, pw, tw = _prepare(q, k, v, tsq_next, tsk, pos_w, ts_w)
        ctx.save_for_backward(q, k, v, tsq, tsk, pw, tw)
        ctx.args = (off_delta, inv_n, max_len, num_buckets)
        ctx.table_dtypes = (pos_w.dtype, ts_w.dtype)
        return _launch(q, k, v, tsq, tsk, pw, tw, *ctx.args)

    @staticmethod
    def backward(ctx, g):
        q, k, v, tsq, tsk, pw, tw = ctx.saved_tensors
        dq, dk, dv, dpw, dtw = _launch_bwd(q, k, v, g, tsq, tsk, pw, tw, *ctx.args)
        dpw, dtw = dpw.to(ctx.table_dtypes[0]), dtw.to(ctx.table_dtypes[1])
        return dq, dk, dv, dpw, dtw, None, None, None, None, None, None


def hstu_chunk_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tsq_next: torch.Tensor,
    tsk: torch.Tensor,
    off_delta: int,
    pos_w: torch.Tensor,
    ts_w: torch.Tensor,
    *,
    inv_n: float,
    max_len: int,
    num_buckets: int,
) -> torch.Tensor:
    """Partial HSTU attention of local queries vs one K/V chunk.

    q [B, Nq, H, Dqk], k [B, Nc, H, Dqk], v [B, Nc, H, Dv]; tsq_next [B, Nq]
    (the next-item timestamps of the query rows), tsk [B, Nc]; off_delta =
    col_off - row_off. Returns [B, Nq, H, Dv] float32, differentiable in q,
    k, v, pos_w and ts_w.
    """
    off_delta, inv_n = int(off_delta), float(inv_n)
    max_len, num_buckets = int(max_len), int(num_buckets)
    _check(q, k, v, tsq_next, tsk, pos_w, ts_w, max_len, num_buckets)
    if q.device.type == "cpu":
        return hstu_chunk_attention_plain(
            q, k, v, tsq_next, tsk, off_delta, pos_w, ts_w,
            inv_n=inv_n, max_len=max_len, num_buckets=num_buckets,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _ChunkAttention.apply(
        q, k, v, pos_w, ts_w, tsq_next, tsk, off_delta, inv_n, max_len, num_buckets
    )
