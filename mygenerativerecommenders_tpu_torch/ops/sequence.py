"""Static-shape sequence ops on dense [B, N, ...] tensors plus a lengths vector.

Port of mygenerativerecommenders_tpu/ops/sequence.py:27-125.
"""

from __future__ import annotations

import torch


def lengths_to_mask(
    lengths: torch.Tensor, max_len: int, dtype: torch.dtype = torch.bool
) -> torch.Tensor:
    """[B] lengths -> [B, max_len] mask with mask[b, i] = i < lengths[b]."""
    pos = torch.arange(max_len, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).to(dtype)


def get_current_embeddings(lengths: torch.Tensor, encoded: torch.Tensor) -> torch.Tensor:
    """out[b] = encoded[b, lengths[b] - 1], the last valid position ([B, D])."""
    idx = torch.clamp(lengths.long() - 1, 0, encoded.shape[1] - 1)
    return encoded[torch.arange(encoded.shape[0], device=encoded.device), idx]


def scatter_at_lengths(
    seq: torch.Tensor, lengths: torch.Tensor, values: torch.Tensor
) -> torch.Tensor:
    """Write values[b] at position lengths[b] of each row (out of place)."""
    pos = torch.arange(seq.shape[1], device=seq.device)
    return torch.where(pos[None, :] == lengths[:, None], values[:, None], seq)


def compact_by_mask(x: torch.Tensor, keep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable left-compaction of the kept positions of each row, zeros after
    them: the static-shape form of boolean indexing a jagged tensor.
    x [B, N, ...], keep [B, N] bool -> (compacted [B, N, ...], kept counts [B])."""
    keep_i = keep.to(torch.int64)
    n = keep.shape[1]
    # each kept position's slot; the dropped ones go to a spare slot N
    dest = torch.where(keep, torch.cumsum(keep_i, dim=1) - 1, n)
    dest = dest.reshape(dest.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    out = x.new_zeros((x.shape[0], n + 1) + tuple(x.shape[2:]))
    return out.scatter(1, dest, x)[:, :n], keep_i.sum(dim=1)


def mask_dense_by_aux_mask(
    dense: torch.Tensor, aux_mask: torch.Tensor, lengths: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop the positions that `aux_mask` marks False or that lie at or past
    `lengths`, and compact the rest to the left of each row.
    dense [B, N, D] -> (compacted [B, N, D], new lengths [B], lengths' dtype)."""
    keep = aux_mask.to(torch.bool) & lengths_to_mask(lengths, dense.shape[1])
    compacted, new_lengths = compact_by_mask(dense, keep)
    return compacted, new_lengths.to(lengths.dtype)
