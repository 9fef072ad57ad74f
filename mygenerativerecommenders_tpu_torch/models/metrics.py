"""Retrieval and multiclass metrics. Port of `compute_ranks`,
`retrieval_metrics` and `multiclass_metrics`
(mygenerativerecommenders_tpu/models/metrics.py:23-94). Retrieval: the rank
is found by appending the target as a sentinel column to the top-k ids and
taking the first match, so a miss ranks k+1 (0 to ndcg and hr, 1/(k+1) to
mrr). Ranking: macro one-vs-rest AUROC and AP over the rating classes, and
top-1 accuracy as precision and recall. Accumulation over batches is a
numpy concat in the trainer.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def compute_ranks(top_k_ids: np.ndarray, target_ids: np.ndarray) -> np.ndarray:
    """[M, K] top-k ids + [M] or [M, 1] targets -> [M] 1-based ranks (K+1 = miss)."""
    top_k_ids, target_ids = np.asarray(top_k_ids), np.asarray(target_ids)
    if target_ids.ndim == 1:
        target_ids = target_ids[:, None]
    hits = np.concatenate([top_k_ids, target_ids], axis=1) == target_ids
    return np.argmax(hits, axis=1) + 1


def retrieval_metric_names(at_k_list: Sequence[int]) -> Tuple[str, ...]:
    """The keys of `retrieval_metrics`, in its order."""
    return (*(f"ndcg@{k}" for k in at_k_list), *(f"hr@{k}" for k in at_k_list), "mrr")


# the keys of `multiclass_metrics`
MULTICLASS_METRIC_NAMES = ("auroc", "ap", "precision", "recall")


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


def multiclass_metrics(
    probs: np.ndarray, targets: np.ndarray, num_classes: int
) -> Dict[str, float]:
    """Macro AUROC and AP over the classes, one against the rest; a class
    absent from `targets`, or the only one there, is skipped. AUROC is the
    rank statistic with tied scores at their average rank; AP sums the
    cumulative precision at each positive. Precision and recall are both
    the micro average of a single-label task: top-1 accuracy."""
    probs, targets = np.asarray(probs), np.asarray(targets)
    aurocs, aps = [], []
    accuracy = float((probs.argmax(axis=1) == targets).mean()) if len(targets) else 0.0
    for c in range(num_classes):
        y = (targets == c).astype(np.float64)
        if y.sum() == 0 or y.sum() == len(y):
            continue
        s = probs[:, c].astype(np.float64)
        y_sorted = y[np.argsort(-s, kind="stable")]
        n_pos = y_sorted.sum()
        n_neg = len(y_sorted) - n_pos
        ranks = np.empty(len(s))
        ranks[np.argsort(s, kind="stable")] = np.arange(1, len(s) + 1)
        _, inv = np.unique(s, return_inverse=True)
        ranks = (np.bincount(inv, weights=ranks) / np.bincount(inv))[inv]
        aurocs.append((ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
        precision = np.cumsum(y_sorted) / np.arange(1, len(y_sorted) + 1)
        aps.append((precision * y_sorted).sum() / n_pos)
    return {
        "auroc": float(np.mean(aurocs)) if aurocs else 0.0,
        "ap": float(np.mean(aps)) if aps else 0.0,
        "precision": accuracy,
        "recall": accuracy,
    }
