"""The one traffic generator. A mix is a data file, gpubench/traffic/<mix>.json:

    {"driver": "train",                   # gpubench/drivers/<driver>.py runs the mix
     "users": U,                          # the user pool
     "lengths": {"min": a, "max": b},     # items a user has, spread evenly over [a, b]
     "popularity_exponent": 0.8,          # Zipf: the item of rank r drawn ~ r^-s
     "span_days": 1095,                   # the timestamps' spread
     ... the driver's own keys (see gpubench/drivers/)}

Every seed gets the same multiset of history lengths (evenly spread over
[a, b], then shuffled by the seed), so the seed changes which items and in
what order, not how much work. Items and timestamps are drawn as the port's
synthetic data draws them (a frozen copy of
mygenerativerecommenders_tpu_torch/data/synthetic.py:65-87 and
data/catalog.py:56-62 at commit bb02319): the catalog is `num_items`
distinct ids of [1, max_item_id], an item of popularity rank r is drawn with
probability ~ r^-s, timestamps are sorted uniform draws over the span from a
base time.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

BASE_TS = 978_000_000  # ~2001, as the port's synthetic data


@dataclasses.dataclass
class Histories:
    catalog: np.ndarray  # [X] sorted item ids
    item_ids: List[np.ndarray]  # U chronological histories
    timestamps: List[np.ndarray]
    ratings: List[np.ndarray]


def catalog(num_items: int, max_item_id: int, rng: np.random.Generator) -> np.ndarray:
    return np.sort(rng.choice(np.arange(1, max_item_id + 1), size=num_items, replace=False))


def histories(mix: dict, num_items: int, max_item_id: int, seed: int) -> Histories:
    rng = np.random.default_rng(seed)
    cat = catalog(num_items, max_item_id, rng)
    pop = 1.0 / np.arange(1, num_items + 1) ** float(mix.get("popularity_exponent", 0.8))
    cdf = np.cumsum(pop / pop.sum())
    cdf /= cdf[-1]
    users = int(mix["users"])
    lo, hi = int(mix["lengths"]["min"]), int(mix["lengths"]["max"])
    lengths = rng.permutation(np.rint(np.linspace(lo, hi, users)).astype(np.int64))
    span = int(mix.get("span_days", 1095)) * 86400
    items, stamps, ratings = [], [], []
    for n in lengths:
        items.append(cat[cdf.searchsorted(rng.random(n), side="right")].astype(np.int64))
        stamps.append(np.sort(BASE_TS + rng.integers(0, span, size=n)).astype(np.int64))
        ratings.append(rng.integers(1, 6, size=n).astype(np.int64))
    return Histories(cat, items, stamps, ratings)

