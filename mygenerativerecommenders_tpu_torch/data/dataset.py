"""Sequence dataset and batch loader.

Port of `SequenceDataset`, the unbucketed `BatchLoader` and `RecoData`
(mygenerativerecommenders_tpu/data/dataset.py:104-177, 208-277, 309-334,
337-419) for synthetic data. Each split is a set of dense numpy arrays
([U, L] ids / ratings / timestamps, [U] lengths and targets) built once, in
memory, from the generated sequences; a step's loader work is a numpy gather.
Split semantics are the JAX package's:

  seq (chronological) -> drop the ignore_last_n tail (1 for train) ->
  target = new last item -> history = the rest, the most recent
  max_sequence_length of it -> right-pad with 0.

Every split reads all users, as the JAX package's `RecoData.dataset` does.
With `data.pack_sequences` the trainer reads the same splits through
data/packing.py. The data has the shape the configuration states: the
ml-20m presets on `data.dataset_name=synthetic` give 26,744 catalog items
spread over ids up to 131,262. Length buckets, the multi-process stride,
positional subsampling, reverse-chronological histories and real (MovieLens)
data raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from mygenerativerecommenders_tpu_torch import not_ported
from mygenerativerecommenders_tpu_torch.configs import DataConfig
from mygenerativerecommenders_tpu_torch.data.synthetic import (
    SyntheticInteractions,
    synthetic_interactions,
)


@dataclass
class SequenceDataset:
    """Dense-array view of one split."""

    lengths: np.ndarray  # [U] int32
    ids: np.ndarray  # [U, L] int32
    ratings: np.ndarray  # [U, L] int32
    timestamps: np.ndarray  # [U, L] int32
    target_id: np.ndarray  # [U] int32
    target_rating: np.ndarray  # [U] int32
    target_timestamp: np.ndarray  # [U] int32
    user_ids: np.ndarray  # [U] int64

    def __len__(self) -> int:
        return len(self.lengths)

    @staticmethod
    def from_sequences(
        data: SyntheticInteractions, max_sequence_length: int, ignore_last_n: int
    ) -> "SequenceDataset":
        L, u = max_sequence_length, len(data.user_ids)
        lengths = np.zeros(u, dtype=np.int32)
        ids = np.zeros((u, L), dtype=np.int32)
        ratings = np.zeros((u, L), dtype=np.int32)
        timestamps = np.zeros((u, L), dtype=np.int32)
        target_id = np.zeros(u, dtype=np.int32)
        target_rating = np.zeros(u, dtype=np.int32)
        target_timestamp = np.zeros(u, dtype=np.int32)
        for i in range(u):
            end = len(data.item_ids[i]) - ignore_last_n
            if end <= 0:
                continue
            s_ids, s_ratings, s_ts = (
                a[i][:end] for a in (data.item_ids, data.ratings, data.timestamps)
            )
            target_id[i], target_rating[i], target_timestamp[i] = (
                s_ids[-1], s_ratings[-1], s_ts[-1]
            )
            hist = slice(max(end - 1 - L, 0), end - 1)  # the most recent L
            n = hist.stop - hist.start
            lengths[i] = n
            ids[i, :n], ratings[i, :n], timestamps[i, :n] = s_ids[hist], s_ratings[hist], s_ts[hist]
        return SequenceDataset(
            lengths, ids, ratings, timestamps, target_id, target_rating,
            target_timestamp, data.user_ids,
        )


class BatchLoader:
    """Shuffling fixed-shape batch iterator: the permutation of an epoch comes
    from `seed + epoch`, and the last partial batch is padded to a full one
    with rows of `sample_weight` 0."""

    def __init__(
        self, dataset: SequenceDataset, batch_size: int, shuffle: bool = False, seed: int = 0
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _emit(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        ds = self.dataset
        weight = (idx >= 0).astype(np.float32)
        idx = np.maximum(idx, 0)
        return {
            "lengths": np.maximum(ds.lengths[idx], 1),
            "ids": ds.ids[idx],
            "ratings": ds.ratings[idx],
            "timestamps": ds.timestamps[idx],
            "target_id": ds.target_id[idx],
            "target_rating": ds.target_rating[idx],
            "target_timestamp": ds.target_timestamp[idx],
            "sample_weight": weight,
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        bs = self.batch_size
        for b in range(len(self)):
            idx = order[b * bs : (b + 1) * bs]
            if len(idx) < bs:
                idx = np.concatenate([idx, np.full(bs - len(idx), -1, dtype=idx.dtype)])
            yield self._emit(idx)


class RecoData:
    """The data module: the generated interactions, the three splits and the
    item catalog (all_item_ids, max_item_id) the model is built from."""

    def __init__(self, cfg: DataConfig, seed: int = 42):
        if not cfg.dataset_name.startswith("synthetic"):
            raise not_ported(f"data.dataset_name={cfg.dataset_name} (real data files)", "Real data")
        if cfg.length_buckets:
            raise not_ported("data.length_buckets", "Training variants")
        if cfg.additional_columns or cfg.item_year_feature:
            raise not_ported("data.additional_columns / item_year_feature", "Other model families")
        if cfg.positional_sampling_ratio < 1.0 or not cfg.chronological:
            raise not_ported(
                "data.positional_sampling_ratio < 1 / chronological=false", "Real data"
            )
        self.cfg = cfg
        self._seed = seed
        self.interactions = synthetic_interactions(
            num_users=cfg.synthetic_num_users,
            num_items=cfg.expected_num_unique_items,
            max_item_id=cfg.expected_max_item_id,
            max_seq_len=cfg.synthetic_max_seq_len,
            rating_by_item_quality=cfg.synthetic_rating_quality,
        )
        self.all_item_ids = self.interactions.catalog.astype(np.int32)
        self.max_item_id = int(cfg.expected_max_item_id)
        self._splits: Dict[str, SequenceDataset] = {}

    def dataset(self, split: str) -> SequenceDataset:
        if split not in self._splits:
            self._splits[split] = SequenceDataset.from_sequences(
                self.interactions,
                max_sequence_length=self.cfg.max_sequence_length,
                ignore_last_n=1 if split == "train" else 0,
            )
        return self._splits[split]

    def loader(self, split: str, batch_size: Optional[int] = None) -> BatchLoader:
        bs = batch_size or (
            self.cfg.batch_size if split == "train" else self.cfg.eval_batch_size
        )
        return BatchLoader(
            self.dataset(split),
            batch_size=bs or self.cfg.batch_size,
            shuffle=(split == "train"),
            seed=self._seed,
        )
