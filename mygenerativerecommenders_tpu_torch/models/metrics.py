"""Retrieval metrics. Port of `compute_ranks` and `retrieval_metrics`
(mygenerativerecommenders_tpu/models/metrics.py:23-48): the rank is found by
appending the target as a sentinel column to the top-k ids and taking the
first match, so a miss ranks k+1 (0 to ndcg and hr, 1/(k+1) to mrr).
Accumulation over batches is a numpy concat in the trainer.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def compute_ranks(top_k_ids: np.ndarray, target_ids: np.ndarray) -> np.ndarray:
    """[M, K] top-k ids + [M] or [M, 1] targets -> [M] 1-based ranks (K+1 = miss)."""
    top_k_ids, target_ids = np.asarray(top_k_ids), np.asarray(target_ids)
    if target_ids.ndim == 1:
        target_ids = target_ids[:, None]
    hits = np.concatenate([top_k_ids, target_ids], axis=1) == target_ids
    return np.argmax(hits, axis=1) + 1


def retrieval_metrics(
    top_k_ids: np.ndarray, target_ids: np.ndarray, at_k_list: Sequence[int]
) -> Dict[str, float]:
    """NDCG@k, HR@k and MRR from accumulated top-k ids and targets."""
    ranks = compute_ranks(top_k_ids, target_ids).astype(np.float64)
    out: Dict[str, float] = {}
    for at_k in at_k_list:
        out[f"ndcg@{at_k}"] = float(
            np.where(ranks <= at_k, 1.0 / np.log2(ranks + 1), 0.0).mean()
        )
    for at_k in at_k_list:
        out[f"hr@{at_k}"] = float((ranks <= at_k).mean())
    out["mrr"] = float((1.0 / ranks).mean())
    return out
