"""The item catalog: which item ids exist, and the largest id.

The port's counterpart of `RecoData._init_item_ids`
(mygenerativerecommenders_tpu/data/dataset.py:358-378) without pandas and
without writing any data files:

- a processed `movies.csv` under `<data_dir>/processed/<dataset>/` is read
  with the stdlib `csv` module: its `movie_id` column in file order, and its
  `year` column into `year_of_item`; the largest id is the one
  `build_processor` pins for MovieLens (`preprocessor.MOVIELENS_ITEMS`), else
  the largest listed;
- a `synthetic*` dataset redoes the catalog draw of `SyntheticDataProcessor`
  (data/preprocessor.py:269-275): `default_rng(0)`, then
  `sort(choice(1..max_id, num_items, replace=False))`, each item's year
  1920 + id % 80 as that processor writes it (`RecoData` draws it with the
  interactions);
- a processed dataset without an item file (ml-20mx16x32) lists the distinct
  ids of its `sasrec_format.csv`. The JAX package gives such a dataset an
  empty catalog (its processor pins no item count), on which no model can
  be built;
- anything else is `range(1, n + 1)`, n the MovieLens item count (else
  empty).
"""

from __future__ import annotations

import csv
import os
from typing import Optional, Tuple

import numpy as np

from mygenerativerecommenders_tpu_torch.configs import DataConfig
from mygenerativerecommenders_tpu_torch.data.preprocessor import MOVIELENS_ITEMS

# SyntheticDataProcessor.seed: the JAX package never overrides it
SYNTHETIC_SEED = 0


def _expected_max_item_id(cfg: DataConfig) -> int:
    if cfg.dataset_name in MOVIELENS_ITEMS:
        return MOVIELENS_ITEMS[cfg.dataset_name][1]
    if cfg.dataset_name.startswith("synthetic"):
        return cfg.expected_max_item_id
    return 0


def item_csv_path(cfg: DataConfig) -> str:
    return os.path.join(cfg.data_dir, "processed", cfg.dataset_name, "movies.csv")


def sequence_csv_path(cfg: DataConfig) -> str:
    return os.path.join(cfg.data_dir, "processed", cfg.dataset_name, "sasrec_format.csv")


def synthetic_catalog(num_items: int, max_item_id: int, rng=None) -> np.ndarray:
    """The synthetic catalog's ids, the first draw of the seed's stream; pass
    `rng` to go on drawing the interactions from the same stream."""
    if rng is None:
        rng = np.random.default_rng(SYNTHETIC_SEED)
    all_ids = np.arange(1, max_item_id + 1)
    return np.sort(rng.choice(all_ids, size=num_items, replace=False))


def synthetic_years(ids: np.ndarray, max_item_id: int) -> np.ndarray:
    """year_of_item of a synthetic catalog: the years SyntheticDataProcessor
    writes into its movies.csv."""
    year_of_item = np.zeros(max_item_id + 1, dtype=np.int32)
    year_of_item[ids] = 1920 + ids % 80
    return year_of_item


def load_catalog(cfg: DataConfig) -> Tuple[np.ndarray, int]:
    """-> (all_item_ids int32 [X], max_item_id)."""
    ids, max_item_id, _ = item_catalog(cfg)
    return ids, max_item_id


def item_catalog(cfg: DataConfig) -> Tuple[np.ndarray, int, Optional[np.ndarray]]:
    """-> (all_item_ids int32 [X], max_item_id, year_of_item int32
    [max_item_id + 1], or None where the item file has no year column)."""
    path = item_csv_path(cfg)
    if os.path.exists(path):
        with open(path, newline="", encoding="utf-8") as f:
            rows = list(csv.DictReader(f))
        ids = np.asarray([int(row["movie_id"]) for row in rows], dtype=np.int32)
        max_item_id = _expected_max_item_id(cfg) or int(ids.max(initial=0))
        year_of_item = None
        if rows and "year" in rows[0]:
            year_of_item = np.zeros(max_item_id + 1, dtype=np.int32)
            year_of_item[ids] = [int(row["year"]) for row in rows]
        return ids, int(max_item_id), year_of_item
    if cfg.dataset_name.startswith("synthetic"):
        ids = synthetic_catalog(cfg.expected_num_unique_items, cfg.expected_max_item_id)
        max_item_id = int(cfg.expected_max_item_id)
        return ids.astype(np.int32), max_item_id, synthetic_years(ids, max_item_id)
    sequences = sequence_csv_path(cfg)
    if os.path.exists(sequences):
        with open(sequences, newline="", encoding="utf-8") as f:
            seen = set()
            for row in csv.DictReader(f):
                body = row["sequence_item_ids"].strip()[1:-1]
                seen.update(int(x) for x in body.split(",") if x.strip())
        ids = np.asarray(sorted(seen), dtype=np.int32)
        return ids, int(ids.max(initial=0)), None
    n = MOVIELENS_ITEMS.get(cfg.dataset_name, (0, 0))[0]
    return np.arange(1, n + 1, dtype=np.int32), n, None
