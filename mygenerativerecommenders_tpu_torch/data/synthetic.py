"""Synthetic power-law interaction data, made in memory.

The port's copy, in numpy and the stdlib, of
`SyntheticDataProcessor.preprocess_rating`
(mygenerativerecommenders_tpu/data/preprocessor.py:269-306) and of the
user-id split of `_write_sequences` (:83-87). It draws from the same
`default_rng(seed)` stream in the same order (catalog choice, then per user:
length, items, timestamps, ratings; the rating draw is kept even where the
ratings come from the quality model, so the stream stays aligned), so both
packages train on identical sequences. Nothing is written to disk: the JAX
package's CSV round trip and its synthetic user-feature columns (drawn after
everything else) are left out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from mygenerativerecommenders_tpu_torch.data.catalog import SYNTHETIC_SEED, synthetic_catalog

_BASE_TS = 978_000_000  # ~2001, ml-1m-era timestamps
_MIN_SEQ_LEN = 5


@dataclass
class SyntheticInteractions:
    """Per-user chronological sequences, users 1..U in order."""

    catalog: np.ndarray  # [X] sorted item ids
    user_ids: np.ndarray  # [U] int64
    item_ids: List[np.ndarray]  # U arrays of int64
    ratings: List[np.ndarray]
    timestamps: List[np.ndarray]

    def train_user_threshold(self) -> int:
        """Users with id <= this are the 90 % train split, the rest the test
        split (the split files the JAX package writes beside the full one)."""
        ids = np.sort(self.user_ids)
        return int(ids[int(len(np.unique(ids)) * 0.9) - 1])


def synthetic_interactions(
    num_users: int,
    num_items: int,
    max_item_id: int,
    max_seq_len: int = 200,
    rating_by_item_quality: bool = False,
    seed: int = SYNTHETIC_SEED,
) -> SyntheticInteractions:
    rng = np.random.default_rng(seed)
    catalog = synthetic_catalog(num_items, max_item_id, rng)
    pop = 1.0 / np.arange(1, num_items + 1) ** 0.8  # zipf-ish
    pop /= pop.sum()

    # a separate stream, so items and timestamps do not depend on the rating model
    rng_q = np.random.default_rng(seed + 1)
    quality = rng_q.normal(0.0, 0.5, size=num_items)
    quality_of_id = np.zeros(max_item_id + 1)
    quality_of_id[catalog] = quality
    user_bias = rng_q.normal(3.0, 1.1, size=num_users + 1)

    item_ids, ratings, timestamps = [], [], []
    for u in range(1, num_users + 1):
        n = int(rng.integers(_MIN_SEQ_LEN, max_seq_len + 1))
        items = catalog[rng.choice(num_items, size=n, p=pop)]
        ts = np.sort(_BASE_TS + rng.integers(0, 3 * 365 * 86400, size=n))
        rated = rng.integers(1, 6, size=n)
        if rating_by_item_quality:
            rated = np.clip(
                np.rint(user_bias[u] + quality_of_id[items] + rng_q.normal(0, 0.5, size=n)),
                1, 5,
            ).astype(np.int64)
        item_ids.append(items.astype(np.int64))
        ratings.append(rated.astype(np.int64))
        timestamps.append(ts.astype(np.int64))
    return SyntheticInteractions(
        catalog=catalog,
        user_ids=np.arange(1, num_users + 1, dtype=np.int64),
        item_ids=item_ids,
        ratings=ratings,
        timestamps=timestamps,
    )
