"""Sequence dataset and batch loader.

Port of `SequenceDataset`, `BatchLoader` (length buckets included) and
`RecoData` (mygenerativerecommenders_tpu/data/dataset.py:104-177, 180-334,
337-419) for synthetic data on one process. Each split is a set of dense numpy arrays
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
spread over ids up to 131,262. The multi-process stride,
positional subsampling, reverse-chronological histories and real (MovieLens)
data raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Sequence

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
    with rows of `sample_weight` 0.

    Length buckets (`buckets`, ascending capacities whose largest covers the
    longest history): each example goes to the smallest capacity that holds
    its history, and each batch holds one bucket's examples with the history
    arrays cut to that capacity, so short histories run in narrow batches.
    Each bucket's last batch is padded as above. The epoch's permutation
    orders the examples inside each bucket; the order of the buckets is
    shuffled from the same generator, with the batches of one capacity kept
    adjacent, so that the trainer's k-step calls find runs of one shape."""

    def __init__(
        self, dataset: SequenceDataset, batch_size: int, shuffle: bool = False, seed: int = 0,
        buckets: Optional[Sequence[int]] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.buckets = sorted(buckets) if buckets else None
        if self.buckets:
            longest = int(dataset.lengths.max()) if len(dataset) else 0
            if self.buckets[-1] < longest:
                raise ValueError(
                    f"length_buckets max {self.buckets[-1]} < dataset max sequence length {longest}"
                )
            # each example's bucket: the smallest capacity >= its length
            self._bucket_of = np.searchsorted(
                np.asarray(self.buckets), np.maximum(dataset.lengths, 1)
            )

    def __len__(self) -> int:
        bs = self.batch_size
        if self.buckets:
            sizes = np.bincount(self._bucket_of, minlength=len(self.buckets))
            return int(sum(-(-int(c) // bs) for c in sizes))
        return (len(self.dataset) + bs - 1) // bs

    def _emit(self, idx: np.ndarray, cap: Optional[int] = None) -> Dict[str, np.ndarray]:
        ds = self.dataset
        weight = (idx >= 0).astype(np.float32)
        idx = np.maximum(idx, 0)
        cols = slice(None) if cap is None else slice(0, cap)
        return {
            "lengths": np.maximum(ds.lengths[idx], 1),
            "ids": ds.ids[idx, cols],
            "ratings": ds.ratings[idx, cols],
            "timestamps": ds.timestamps[idx, cols],
            "target_id": ds.target_id[idx],
            "target_rating": ds.target_rating[idx],
            "target_timestamp": ds.target_timestamp[idx],
            "sample_weight": weight,
        }

    def _pad(self, idx: np.ndarray) -> np.ndarray:
        """A short batch's indices padded with -1 (rows of sample_weight 0)."""
        short = self.batch_size - len(idx)
        return np.concatenate([idx, np.full(short, -1, dtype=idx.dtype)]) if short else idx

    def _iter_bucketed(self, order: np.ndarray, rng) -> Iterator[Dict[str, np.ndarray]]:
        bs = self.batch_size
        bucket_of = self._bucket_of[order]
        batches = []  # (capacity, example indices)
        for bi, cap in enumerate(self.buckets):
            members = order[bucket_of == bi]
            for start in range(0, len(members), bs):
                batches.append((cap, self._pad(members[start : start + bs])))
        if rng is not None:
            # shuffle the order of the buckets, keep same-capacity batches adjacent
            cap_rank = {c: i for i, c in enumerate(rng.permutation(self.buckets))}
            batches.sort(key=lambda t: cap_rank[t[0]])
        for cap, idx in batches:
            yield self._emit(idx, cap)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        rng = None
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        self.epoch += 1
        if self.buckets:
            yield from self._iter_bucketed(order, rng)
            return
        bs = self.batch_size
        for b in range(len(self)):
            yield self._emit(self._pad(order[b * bs : (b + 1) * bs]))


class RecoData:
    """The data module: the generated interactions, the three splits and the
    item catalog (all_item_ids, max_item_id) the model is built from."""

    def __init__(self, cfg: DataConfig, seed: int = 42):
        if not cfg.dataset_name.startswith("synthetic"):
            raise not_ported(f"data.dataset_name={cfg.dataset_name} (real data files)", "Real data")
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
            buckets=list(self.cfg.length_buckets) or None,
        )
