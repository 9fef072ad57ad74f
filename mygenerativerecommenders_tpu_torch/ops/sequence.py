"""Static-shape sequence ops on dense [B, N, ...] tensors plus a lengths vector.

Port of mygenerativerecommenders_tpu/ops/sequence.py:27-66.
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
