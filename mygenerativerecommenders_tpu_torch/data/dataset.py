"""Sequence dataset and batch loader.

Port of `SequenceDataset` (`from_csv` included), `BatchLoader` (length
buckets included) and `RecoData` (mygenerativerecommenders_tpu/data/dataset.py:42-178,
180-334, 337-419) on one process. Each split is a set of dense numpy arrays
([U, L] ids / ratings / timestamps, [U] lengths and targets) built once; a
step's loader work is a numpy gather. Split semantics are the JAX package's:

  seq (chronological) -> drop the ignore_last_n tail (1 for train) ->
  with positional_sampling_ratio < 1, keep each event with that chance (the
  target always; a seeded `default_rng`) -> target = new last item ->
  history = the rest, the most recent max_sequence_length of it
  (chronological=false: newest first) -> right-pad with 0.

A real dataset (ml-1m, ml-20m, ml-20mx16x32, amzn-*) is read from the
processed `sasrec_format.csv` under `<data_dir>/processed/<name>/`, which
data/preprocessor.py writes from the raw files when it is missing: by the
native parser (native/, C++ built at first use) where the JAX package takes
its own (no subsampling, no id shift), else by the plain parser here. A
synthetic dataset is drawn in memory (data/synthetic.py) and goes through
the plain parser's split. Every split reads all users, as the JAX package's
`RecoData.dataset` does. `data.additional_columns` (the users' coded
features, which the aux preprocessor reads) come from the sequence CSV's
columns of those names, or from the synthetic draw's user columns, one int32
value a user; every batch carries each as a [B] array under its name.
`check_aux_codes` holds them to the aux preprocessor's table sizes once, on
the host. With `data.pack_sequences` the trainer reads the same splits
through data/packing.py. The multi-process stride is not ported.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from mygenerativerecommenders_tpu_torch.configs import DataConfig, PreprocessorConfig
from mygenerativerecommenders_tpu_torch.data.catalog import item_catalog, synthetic_years
from mygenerativerecommenders_tpu_torch.data.preprocessor import (
    SEQUENCE_COLUMNS,
    USER_FEATURES,
    DataProcessor,
    build_processor,
    typed_column,
)
from mygenerativerecommenders_tpu_torch.data.synthetic import (
    SyntheticInteractions,
    synthetic_interactions,
)

Sequences = Iterable[Tuple[np.ndarray, np.ndarray, np.ndarray]]


def _parse_list(text: str, dtype) -> np.ndarray:
    """A Python-list string "[a, b, ...]" -> int64 values (floats truncated)."""
    body = text.strip()[1:-1]
    if not body.strip():
        return np.zeros(0, dtype=np.int64)
    return np.asarray(body.split(","), dtype=str).astype(dtype).astype(np.int64)


def read_sequence_csv(path: str) -> Tuple[List[str], List[List[str]]]:
    """The sequence CSV's header and rows, as strings."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    return (rows[0], rows[1:]) if rows else (list(SEQUENCE_COLUMNS), [])


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
    additional: Dict[str, np.ndarray] = field(default_factory=dict)  # per-user columns

    def __len__(self) -> int:
        return len(self.lengths)

    @staticmethod
    def from_sequences(
        sequences: Sequences,
        user_ids: np.ndarray,
        max_sequence_length: int,
        ignore_last_n: int,
        chronological: bool = True,
        shift_id_by: int = 0,
        sample_ratio: float = 1.0,
        seed: int = 42,
    ) -> "SequenceDataset":
        """Per-user chronological (ids, ratings, timestamps) -> the split (the
        plain parser's loop, JAX :104-157)."""
        L, u = max_sequence_length, len(user_ids)
        lengths = np.zeros(u, dtype=np.int32)
        ids = np.zeros((u, L), dtype=np.int32)
        ratings = np.zeros((u, L), dtype=np.int32)
        timestamps = np.zeros((u, L), dtype=np.int32)
        target_id = np.zeros(u, dtype=np.int32)
        target_rating = np.zeros(u, dtype=np.int32)
        target_timestamp = np.zeros(u, dtype=np.int32)
        rng = np.random.default_rng(seed)
        for i, (s_ids, s_ratings, s_ts) in enumerate(sequences):
            if ignore_last_n > 0:
                s_ids, s_ratings, s_ts = (
                    a[:-ignore_last_n] for a in (s_ids, s_ratings, s_ts)
                )
            if sample_ratio < 1.0:
                keep = rng.random(len(s_ids)) < sample_ratio
                keep[-1:] = True  # never drop the target
                s_ids, s_ratings, s_ts = s_ids[keep], s_ratings[keep], s_ts[keep]
            if shift_id_by:
                s_ids = s_ids + shift_id_by
            if len(s_ids) == 0:
                continue
            target_id[i], target_rating[i], target_timestamp[i] = s_ids[-1], s_ratings[-1], s_ts[-1]
            hist = (s_ids[:-1], s_ratings[:-1], s_ts[:-1])
            if chronological:  # the most recent L
                hist = tuple(a[max(len(a) - L, 0):] for a in hist)
            else:  # newest first, the newest L (JAX :145-152)
                hist = tuple(a[::-1][:L] for a in hist)
            n = len(hist[0])
            lengths[i] = n
            ids[i, :n], ratings[i, :n], timestamps[i, :n] = hist
        return SequenceDataset(
            lengths, ids, ratings, timestamps, target_id, target_rating,
            target_timestamp, np.asarray(user_ids, dtype=np.int64),
        )

    @staticmethod
    def from_csv(
        csv_path: str,
        max_sequence_length: int,
        ignore_last_n: int,
        chronological: bool = True,
        shift_id_by: int = 0,
        sample_ratio: float = 1.0,
        seed: int = 42,
        additional_columns: Optional[Sequence[str]] = None,
        parser: str = "auto",
    ) -> "SequenceDataset":
        """A sequence CSV -> the split. `parser`: "native" (the C++ parser; no
        subsampling or id shift), "python" (the plain parser), or "auto": the
        native one where it applies, as in the JAX package (:70-96)."""
        if parser not in ("auto", "native", "python"):
            raise ValueError(f"Unknown parser {parser!r}")
        native_ok = sample_ratio >= 1.0 and shift_id_by == 0
        if parser == "native" and not native_ok:
            raise ValueError("the native parser takes no sample_ratio < 1 or shift_id_by")
        header, rows = None, None
        if parser == "native" or (parser == "auto" and native_ok):
            from mygenerativerecommenders_tpu_torch import native

            ds = SequenceDataset(**native.parse_sequences_native(
                csv_path, max_sequence_length, ignore_last_n, chronological
            ))
        else:
            header, rows = read_sequence_csv(csv_path)
            at = [header.index(name) for name in SEQUENCE_COLUMNS]
            ds = SequenceDataset.from_sequences(
                ((_parse_list(r[at[1]], np.int64), _parse_list(r[at[2]], np.float64),
                  _parse_list(r[at[3]], np.int64)) for r in rows),
                np.asarray([int(r[at[0]]) for r in rows], dtype=np.int64),
                max_sequence_length, ignore_last_n, chronological, shift_id_by,
                sample_ratio, seed,
            )
        if additional_columns:
            if rows is None:
                header, rows = read_sequence_csv(csv_path)
            for name in additional_columns:
                if name not in header:
                    raise ValueError(f"Column {name!r} not in the sequence CSV")
                i = header.index(name)
                ds.additional[name] = typed_column([r[i] for r in rows]).astype(np.int32)
        return ds


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
    adjacent, so that the trainer's k-step calls find runs of one shape.

    Over processes (`process_index` of `process_count`; JAX :241-246,
    :279-326): every process draws the same permutation and takes its
    strided slice of it, padded with -1 rows to the largest share, so that
    every process runs the same number of batches of `batch_size` rows (the
    global batch over process_count). With buckets the partition and the
    batch boundaries come from the global permutation, in global batches of
    `batch_size * process_count` rows, and each process takes its strided
    rows of each."""

    def __init__(
        self, dataset: SequenceDataset, batch_size: int, shuffle: bool = False, seed: int = 0,
        buckets: Optional[Sequence[int]] = None, with_index: bool = False,
        process_index: int = 0, process_count: int = 1,
    ):
        self.dataset = dataset
        self.with_index = with_index
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
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

    def _local_count(self) -> int:
        """The largest process's share of the examples."""
        return -(-len(self.dataset) // self.process_count)

    def __len__(self) -> int:
        bs = self.batch_size
        if self.buckets:
            gbs = bs * self.process_count
            sizes = np.bincount(self._bucket_of, minlength=len(self.buckets))
            return int(sum(-(-int(c) // gbs) for c in sizes))
        return -(-self._local_count() // bs)

    def _emit(self, idx: np.ndarray, cap: Optional[int] = None) -> Dict[str, np.ndarray]:
        """The batch of dataset rows `idx` (-1: padding); with `with_index`
        also "example", `idx` itself, which cli/predict.py orders its rows by."""
        ds = self.dataset
        weight = (idx >= 0).astype(np.float32)
        index = {"example": idx.astype(np.int64)} if self.with_index else {}
        idx = np.maximum(idx, 0)
        cols = slice(None) if cap is None else slice(0, cap)
        return index | {col: values[idx] for col, values in ds.additional.items()} | {
            "lengths": np.maximum(ds.lengths[idx], 1),
            "ids": ds.ids[idx, cols],
            "ratings": ds.ratings[idx, cols],
            "timestamps": ds.timestamps[idx, cols],
            "target_id": ds.target_id[idx],
            "target_rating": ds.target_rating[idx],
            "target_timestamp": ds.target_timestamp[idx],
            "sample_weight": weight,
        }

    @staticmethod
    def _pad(idx: np.ndarray, size: int) -> np.ndarray:
        """Indices padded with -1 (rows of sample_weight 0) to `size`."""
        short = size - len(idx)
        return np.concatenate([idx, np.full(short, -1, dtype=idx.dtype)]) if short > 0 else idx

    def _iter_bucketed(self, order: np.ndarray, rng) -> Iterator[Dict[str, np.ndarray]]:
        pi, pc = self.process_index, self.process_count
        gbs = self.batch_size * pc
        bucket_of = self._bucket_of[order]
        batches = []  # (capacity, the global batch's example indices)
        for bi, cap in enumerate(self.buckets):
            members = order[bucket_of == bi]
            for start in range(0, len(members), gbs):
                batches.append((cap, self._pad(members[start : start + gbs], gbs)))
        if rng is not None:
            # shuffle the order of the buckets, keep same-capacity batches adjacent
            cap_rank = {c: i for i, c in enumerate(rng.permutation(self.buckets))}
            batches.sort(key=lambda t: cap_rank[t[0]])
        for cap, idx in batches:
            yield self._emit(idx[pi::pc], cap)

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
        if self.process_count > 1:
            # this process's strided share, padded to the largest share
            order = self._pad(order[self.process_index :: self.process_count],
                              self._local_count())
        bs = self.batch_size
        for b in range(len(self)):
            yield self._emit(self._pad(order[b * bs : (b + 1) * bs], bs))


class RecoData:
    """The data module: the interactions (read from the processed files, or
    drawn in memory for a synthetic dataset), the three splits, and the item
    catalog the model is built from: all_item_ids (movies.csv's ids in its
    order), max_item_id (the dataset's pinned largest id, else the largest
    listed) and year_of_item ([max_item_id + 1], None without a year
    column)."""

    def __init__(self, cfg: DataConfig, seed: int = 42):
        if cfg.item_year_feature:
            # JAX declares the field (configs/__init__.py:268) and reads it nowhere
            raise ValueError(
                "data.item_year_feature: the reference ignores this field; the item/year "
                "split is model.embedding.kind=item_year, which reads the catalog's years"
            )
        self.cfg = cfg
        self._seed = seed
        self.processor: Optional[DataProcessor] = None
        self.interactions: Optional[SyntheticInteractions] = None
        if cfg.dataset_name.startswith("synthetic"):
            self.interactions = synthetic_interactions(
                num_users=cfg.synthetic_num_users,
                num_items=cfg.expected_num_unique_items,
                max_item_id=cfg.expected_max_item_id,
                max_seq_len=cfg.synthetic_max_seq_len,
                rating_by_item_quality=cfg.synthetic_rating_quality,
            )
            self.all_item_ids = self.interactions.catalog.astype(np.int32)
            self.max_item_id = int(cfg.expected_max_item_id)
            self.year_of_item = synthetic_years(self.all_item_ids, self.max_item_id)
        else:
            self.processor = build_processor(cfg.dataset_name, cfg.data_dir)
            if not os.path.exists(self.processor.output_format_csv()):
                self.processor.preprocess_rating()
            self.all_item_ids, self.max_item_id, self.year_of_item = item_catalog(cfg)
        self._splits: Dict[str, SequenceDataset] = {}

    def dataset(self, split: str) -> SequenceDataset:
        if split not in self._splits:
            cfg = self.cfg
            kwargs = dict(
                max_sequence_length=cfg.max_sequence_length,
                ignore_last_n=1 if split == "train" else 0,
                chronological=cfg.chronological,
                sample_ratio=cfg.positional_sampling_ratio if split == "train" else 1.0,
                seed=self._seed,
            )
            columns = list(cfg.additional_columns)
            if self.interactions is not None:
                data = self.interactions
                ds = SequenceDataset.from_sequences(
                    zip(data.item_ids, data.ratings, data.timestamps), data.user_ids, **kwargs
                )
                for name in columns:
                    if name not in data.users:
                        raise ValueError(f"Column {name!r} not in the sequence CSV")
                    ds.additional[name] = data.users[name].astype(np.int32)
                self._splits[split] = ds
            else:
                self._splits[split] = SequenceDataset.from_csv(
                    self.processor.output_format_csv(), additional_columns=columns, **kwargs
                )
        return self._splits[split]

    def sequence_table(self) -> Tuple[List[str], List[List[str]]]:
        """The full sequence CSV's header and rows as strings, one row per
        example of every split, in dataset order (what cli/predict.py writes
        its top-k beside); a synthetic dataset's rows are formatted as the
        JAX package writes them, its drawn user-feature columns after the
        sequences."""
        if self.processor is not None:
            return read_sequence_csv(self.processor.output_format_csv())
        data = self.interactions
        users = list(zip(*(data.users[c].tolist() for c in USER_FEATURES)))
        rows = [
            [str(u), str(a.tolist()), str(b.tolist()), str(c.tolist())] + [str(v) for v in f]
            for u, a, b, c, f in zip(data.user_ids.tolist(), data.item_ids, data.ratings,
                                     data.timestamps, users)
        ]
        return list(SEQUENCE_COLUMNS) + list(USER_FEATURES), rows

    def loader(self, split: str, batch_size: Optional[int] = None,
               with_index: bool = False, process_index: int = 0,
               process_count: int = 1) -> BatchLoader:
        """The split's loader; over processes, this process's strided rows
        (`BatchLoader`), `batch_size` of them a batch."""
        bs = batch_size or (
            self.cfg.batch_size if split == "train" else self.cfg.eval_batch_size
        )
        return BatchLoader(
            self.dataset(split),
            batch_size=bs or self.cfg.batch_size,
            shuffle=(split == "train"),
            seed=self._seed,
            buckets=list(self.cfg.length_buckets) or None,
            with_index=with_index,
            process_index=process_index,
            process_count=process_count,
        )


def check_aux_codes(pre: PreprocessorConfig, dataset: SequenceDataset) -> None:
    """Raise a ValueError unless every code of each aux column encoded
    `onehot` or `embed` lies in [0, categorical_dims[i]): on the card a code
    past the table would stop the step at a device assert (the JAX package
    gives a NaN row for `embed` and a zero row for `onehot` instead, without
    an error). `numeric` columns are values, not codes, and are not held."""
    specs = zip(pre.auxiliary_columns, pre.encoding_types, pre.categorical_dims)
    for col, enc, size in specs:
        if enc not in ("onehot", "embed"):
            continue
        if col not in dataset.additional:
            raise ValueError(
                f"aux column {col!r} is not among data.additional_columns "
                f"{sorted(dataset.additional)}"
            )
        codes = dataset.additional[col]
        lo, hi = (int(codes.min()), int(codes.max())) if len(codes) else (0, 0)
        if lo < 0 or hi >= size:
            raise ValueError(
                f"aux column {col!r} ({enc}): its codes run from {lo} to {hi} (largest "
                f"{hi}), but categorical_dims gives its table {size} rows; every code "
                f"must lie in [0, {size})"
            )
