"""Autoregressive losses. Port of `sampled_softmax_loss` and `_weighted_mean`
(mygenerativerecommenders_tpu/models/losses.py:19-44). Every loss runs dense
over [B, T, ...] with a `weights` mask and returns
`sum(per_pos * weights) / sum(weights)`.

The training step computes its loss through the dense-catalog path
(ops/dense_negatives.py); the per-sample form here is what that path is held
to in the tests.
"""

from __future__ import annotations

import torch

_ACCIDENTAL_HIT_LOGIT = -5e4


def _weighted_mean(per_pos: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    w = weights.to(per_pos.dtype)
    return (per_pos * w).sum() / torch.clamp(w.sum(), min=1e-12)


def sampled_softmax_loss(
    positive_logits: torch.Tensor,  # [B, T] (already / temperature)
    negative_logits: torch.Tensor,  # [B, T, R] (already / temperature)
    accidental_hits: torch.Tensor,  # [B, T, R] bool: sampled id == positive id
    weights: torch.Tensor,  # [B, T]
) -> torch.Tensor:
    """-log softmax(pos | pos ++ negs), accidental hits replaced by -5e4."""
    negative_logits = torch.where(accidental_hits, _ACCIDENTAL_HIT_LOGIT, negative_logits)
    neg_lse = torch.logsumexp(negative_logits, dim=-1)
    per_pos = torch.logaddexp(positive_logits, neg_lse) - positive_logits
    return _weighted_mean(per_pos, weights)
