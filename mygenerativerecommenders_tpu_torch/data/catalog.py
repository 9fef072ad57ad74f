"""The item catalog: which item ids exist, and the largest id.

The port's counterpart of `RecoData._init_item_ids`
(mygenerativerecommenders_tpu/data/dataset.py:358-378) without pandas and
without writing any data files:

- a processed `movies.csv` under `<data_dir>/processed/<dataset>/` is read
  with the stdlib `csv` module (its `movie_id` column);
- a `synthetic*` dataset redoes the catalog draw of `SyntheticDataProcessor`
  (data/preprocessor.py:269-275): `default_rng(0)`, then
  `sort(choice(1..max_id, num_items, replace=False))`;
- anything else is `range(1, expected_num_unique_items + 1)`.
"""

from __future__ import annotations

import csv
import os
from typing import Tuple

import numpy as np

from mygenerativerecommenders_tpu_torch.configs import DataConfig

# build_processor (data/preprocessor.py:336-352) pins these for MovieLens
_MOVIELENS_MAX_ITEM_ID = {"ml-1m": 3952, "ml-20m": 131262}
_MOVIELENS_NUM_ITEMS = {"ml-1m": 3706, "ml-20m": 26744}
# SyntheticDataProcessor.seed: the JAX package never overrides it
_SYNTHETIC_SEED = 0


def _expected_max_item_id(cfg: DataConfig) -> int:
    if cfg.dataset_name in _MOVIELENS_MAX_ITEM_ID:
        return _MOVIELENS_MAX_ITEM_ID[cfg.dataset_name]
    if cfg.dataset_name.startswith("synthetic"):
        return cfg.expected_max_item_id
    return 0


def _expected_num_items(cfg: DataConfig) -> int:
    if cfg.dataset_name in _MOVIELENS_NUM_ITEMS:
        return _MOVIELENS_NUM_ITEMS[cfg.dataset_name]
    if cfg.dataset_name.startswith("synthetic"):
        return cfg.expected_num_unique_items
    return 0


def item_csv_path(cfg: DataConfig) -> str:
    return os.path.join(cfg.data_dir, "processed", cfg.dataset_name, "movies.csv")


def synthetic_catalog(num_items: int, max_item_id: int) -> np.ndarray:
    rng = np.random.default_rng(_SYNTHETIC_SEED)
    all_ids = np.arange(1, max_item_id + 1)
    return np.sort(rng.choice(all_ids, size=num_items, replace=False))


def load_catalog(cfg: DataConfig) -> Tuple[np.ndarray, int]:
    """-> (all_item_ids int32 [X], max_item_id)."""
    path = item_csv_path(cfg)
    if os.path.exists(path):
        with open(path, newline="") as f:
            ids = [int(row["movie_id"]) for row in csv.DictReader(f)]
        max_item_id = _expected_max_item_id(cfg) or max(ids)
        return np.asarray(ids, dtype=np.int32), int(max_item_id)
    if cfg.dataset_name.startswith("synthetic"):
        ids = synthetic_catalog(cfg.expected_num_unique_items, cfg.expected_max_item_id)
        return ids.astype(np.int32), int(cfg.expected_max_item_id)
    n = _expected_num_items(cfg)
    return np.arange(1, n + 1, dtype=np.int32), n
