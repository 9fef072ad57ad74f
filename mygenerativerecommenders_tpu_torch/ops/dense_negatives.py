"""Dense-catalog evaluation of the per-position sampled-softmax negatives.

Port of `sampled_softmax_dense_neg_lse`
(mygenerativerecommenders_tpu/ops/dense_negatives.py:144-255). The loss draws
R negatives per supervision position; instead of gathering each one's
embedding row, the negative term is computed through the whole catalog:

    count[i, x] = #{r : offsets[i, r] == x}, 0 at the positive's own offset
    neg_lse[i]  = log sum_x count[i, x] * exp(q[i] . cat[x] / tau)

which equals the log-sum-exp over the R sampled logits with accidental hits
left out (the reference replaces a hit's logit by -5e4, whose exponential is
0.0 in float32 beside any live logit). A row whose every draw hit the
positive gets -inf, which `logaddexp(pos, -inf)` treats like that reference
row. Both steps are kernels on the card (ops/kernels/count_offsets.py,
ops/kernels/dense_neg_lse.py) and plain PyTorch on the CPU.
"""

from __future__ import annotations

import torch

from mygenerativerecommenders_tpu_torch.ops.kernels.count_offsets import count_offsets
from mygenerativerecommenders_tpu_torch.ops.kernels.dense_neg_lse import dense_neg_lse


def sampled_softmax_dense_neg_lse(
    query: torch.Tensor,  # [..., D] postprocessed outputs
    norm_catalog: torch.Tensor,  # [X, D] normalized catalog embeddings
    neg_offsets: torch.Tensor,  # [..., R] sampled catalog offsets
    positive_offsets: torch.Tensor,  # [...] the positive's offset, -1 if outside the catalog
    temperature: float,
) -> torch.Tensor:
    """Log-sum-exp of the R sampled negative logits, hits excluded ([...])."""
    lead = query.shape[:-1]
    count = count_offsets(
        neg_offsets.reshape(-1, neg_offsets.shape[-1]),
        positive_offsets.reshape(-1),
        norm_catalog.shape[0],
    )
    lse = dense_neg_lse(
        query.reshape(-1, query.shape[-1]), norm_catalog, count, temperature
    )
    return lse.reshape(lead)
