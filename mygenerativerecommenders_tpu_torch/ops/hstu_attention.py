"""HSTU pointwise attention: the plain PyTorch reference ops.

Port of mygenerativerecommenders_tpu/ops/hstu_attention.py:38-124. HSTU
attention is not softmax attention:

    attn[b, h, n, m] = silu(q[b,n,h,:] . k[b,m,h,:] + bias[b,n,m]) / N
    out[b, n, h, :]  = sum_m attn[b,h,n,m] * causal[n,m] * v[b,m,h,:]

with N the static max length. The relative bias is
  pos term:  pos_w[(m - n) + N - 1]
  time term: ts_w[clip(int(log(max(|ts[n+1] - ts[m]|, 1)) / 0.301), 0, num_buckets)]
where ts[n+1] repeats the last column for the last row.

The fused kernel (ops/kernels/hstu_attention.py) builds the same bias
in-kernel; these functions are what every attention kernel is held to.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def bucketize_timedelta(delta: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """floor(ln(max(|d|, 1)) / 0.301) in float32, clipped to [0, num_buckets]."""
    # the divisor is a tensor on delta's device: on CUDA torch divides by a
    # Python scalar as a multiplication by its reciprocal, which rounds some
    # deltas at a bucket boundary into the neighbouring bucket; tensor by
    # tensor it is the IEEE division that the CPU, XLA and the kernels do
    divisor = torch.full((), 0.301, dtype=torch.float32, device=delta.device)
    x = torch.log(torch.clamp(delta.abs().to(torch.float32), min=1.0)) / divisor
    return torch.clamp(x.to(torch.int32), 0, num_buckets)


def relative_position_bias(
    pos_w: torch.Tensor, n: int, max_len: Optional[int] = None
) -> torch.Tensor:
    """[2*max_len-1] table -> [N, N] bias, bias[i, j] = pos_w[j - i + max_len - 1]."""
    if max_len is None:
        max_len = n
    idx = torch.arange(n, device=pos_w.device)
    return pos_w[(idx[None, :] - idx[:, None]) + (max_len - 1)]


def next_timestamps(timestamps: torch.Tensor) -> torch.Tensor:
    """ts[:, n+1] for each query row n, the last column repeated."""
    return torch.cat([timestamps[:, 1:], timestamps[:, -1:]], dim=1)


def relative_time_bias(
    ts_w: torch.Tensor, timestamps: torch.Tensor, num_buckets: int
) -> torch.Tensor:
    """[B, N] timestamps -> [B, N, N], bias[b, n, m] = ts_w[bucket(ts[b,n+1] - ts[b,m])]."""
    ts = timestamps.to(torch.int32)
    delta = next_timestamps(ts)[:, :, None] - ts[:, None, :]
    return ts_w[bucketize_timedelta(delta, num_buckets).long()]


def hstu_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    *,
    max_len: int,
    causal: bool = True,
    seg_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense HSTU attention.

    q, k: [B, N, H, Dqk]; v: [B, N, H, Dv]; bias: optional [B, N, N];
    max_len: the 1/N normalizer; seg_ids: optional [B, N] ids of packed
    segments (attention is masked to same-segment pairs).
    Returns [B, N, H, Dv] in v's dtype.
    """
    n = q.shape[1]
    qk = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    if bias is not None:
        qk = qk + bias[:, None, :, :].to(qk.dtype)
    attn = F.silu(qk) / max_len
    if causal:
        keep = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
        attn = torch.where(keep[None, None], attn, 0.0)
    if seg_ids is not None:
        same_seg = seg_ids[:, :, None] == seg_ids[:, None, :]
        attn = torch.where(same_seg[:, None], attn, 0.0)
    out = torch.einsum("bhnm,bmhd->bnhd", attn, v.to(attn.dtype))
    return out.to(v.dtype)
