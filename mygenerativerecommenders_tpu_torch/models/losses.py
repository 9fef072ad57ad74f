"""Autoregressive losses. Port of `sampled_softmax_loss`, `bce_loss`,
`ce_rating_loss` and `_weighted_mean`
(mygenerativerecommenders_tpu/models/losses.py:19-61, 75-84). Every loss runs dense
over [B, T, ...] with a `weights` mask and returns
`sum(per_pos * weights) / sum(weights)`. Within a data-parallel step
(parallel/process_group.py) the divisor is the weight sum of the global
batch, all-reduced in the step, as JAX's mean over the sharded batch sums
`w` over the data axis: each rank's loss is its part of the global mean,
and the gradients are summed over the ranks.

`sampled_softmax_loss` is the per-sample form: the training step takes it
for the per-sample gather loss and the shared-negatives loss
(train/task_retrieval.py, train/lazy_embedding.py), and the tests hold the
dense-catalog path (ops/dense_negatives.py) to it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mygenerativerecommenders_tpu_torch.parallel.process_group import global_sum

_ACCIDENTAL_HIT_LOGIT = -5e4


def _weighted_mean(per_pos: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    w = weights.to(per_pos.dtype)
    return (per_pos * w).sum() / torch.clamp(global_sum(w.sum()), min=1e-12)


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


def bce_loss(
    positive_logits: torch.Tensor,  # [B, T]
    negative_logits: torch.Tensor,  # [B, T] (one negative a position)
    negative_is_accidental: torch.Tensor,  # [B, T] bool
    weights: torch.Tensor,  # [B, T]
) -> torch.Tensor:
    """Binary cross-entropy with one negative a position,
    0.5 * (softplus(-pos) + softplus(neg)); a position whose negative is the
    positive itself leaves the numerator and the denominator alike."""
    loss_weights = weights * (~negative_is_accidental).to(weights.dtype)
    per_pos = (F.softplus(-positive_logits) + F.softplus(negative_logits)) * 0.5
    return _weighted_mean(per_pos, loss_weights)


def ce_rating_loss(
    logits: torch.Tensor,  # [B, T, R] scores against the R rating embeddings
    ratings: torch.Tensor,  # [B, T] int class labels
    weights: torch.Tensor,  # [B, T]
) -> torch.Tensor:
    """Multiclass cross-entropy over the rating classes, the labels clipped to
    [0, R - 1]."""
    log_probs = torch.log_softmax(logits, dim=-1)
    safe = ratings.long().clamp(0, logits.shape[-1] - 1)
    per_pos = -torch.gather(log_probs, -1, safe[..., None])[..., 0]
    return _weighted_mean(per_pos, weights)
