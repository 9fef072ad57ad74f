"""Sequence packing: fixed-shape [P, L] batches with several sequences laid
end to end in each row.

The port's copy, in numpy, of mygenerativerecommenders_tpu/data/packing.py
(`pack_rows` :33, `pack_rows_best_fit` :51, `PackedBatchLoader` :79) for one
process: on the same dataset and seed it emits the same batches, array for
array. Each row packs several SEGMENTS, one example each, so padding shrinks
to the row's end. Train segments (`include_target=True`) are the history
followed by the target as the last token; eval segments
(`include_target=False`) are the history followed by an inert id-0 token that
carries the target's timestamp. Attention goes block-diagonal through the
`positions` payload (within-segment offsets; ops/kernels/hstu_attention.py),
the positional embedding reads the same payload (models/preprocessors.py) and
the supervision weights are zero across segment boundaries
(train/task_retrieval.py).

Over processes (`process_index` of `process_count`, JAX :96-104) the plan is
made on the global stream, in global batches of `rows_of[cap] *
process_count` rows, and each process takes the rows `row % process_count
== process_index` of each; a tail batch that leaves a process no row gives
it an empty batch of the same shape. The eval's segment slots per class come
from the global plan, the most that any process's share of a batch holds.
A rank evaluates its own rows, so `seg_last_flat` addresses them (JAX's
addresses the stitched global batch, :322-330).
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from mygenerativerecommenders_tpu_torch.data.dataset import SequenceDataset


def pack_rows(seg_lens: np.ndarray, capacity: int) -> np.ndarray:
    """Next-fit packing in stream order: a row is closed when the next segment
    does not fit. -> [S] int64 row ids (non-decreasing)."""
    rows = np.zeros(len(seg_lens), dtype=np.int64)
    row, used = 0, 0
    for i, length in enumerate(seg_lens):
        if used + length > capacity:
            row += 1
            used = 0
        rows[i] = row
        used += length
    return rows


def pack_rows_best_fit(seg_lens: np.ndarray, capacity: int) -> np.ndarray:
    """Best-fit packing: each segment goes to the open row with the smallest
    remaining capacity that still takes it (bisect over the sorted remainders).
    Rows are not in stream order; the emitter sorts a batch's entries by row.
    -> [S] int64 row ids."""
    rem: list = []  # sorted (remaining capacity, row id)
    rows = np.empty(len(seg_lens), dtype=np.int64)
    n_rows = 0
    for i, length in enumerate(seg_lens):
        li = int(length)
        j = bisect.bisect_left(rem, (li, -1))
        if j == len(rem):
            r = n_rows
            n_rows += 1
            rest = capacity - li
        else:
            rrem, r = rem.pop(j)
            rest = rrem - li
        rows[i] = r
        if rest > 0:
            bisect.insort(rem, (rest, r))
    return rows


class PackedBatchLoader:
    """Packs a SequenceDataset's examples into fixed-shape batches.

    A batch holds ids / ratings / timestamps / positions / seg_ids [P, L]
    int32 (seg_ids -1 at padding, positions restart at 0 in each segment),
    lengths [P] (packed tokens of the row: the attention kernels' tile skip)
    and num_segments [P] (examples of the row, for examples/s).

    With `capacities` (ascending) each example packs with the smallest
    capacity that takes its segment, so short segments ride narrow rows and
    only the long ones pay for wide rows; every class emits batches of about
    `segments_per_batch` examples. One capacity is plain packing.

    `include_target=False` (eval) adds per-SEGMENT fields of a static size
    S_cap, the most segments any batch of the class holds in the epoch-0 plan
    (eval never shuffles, so every epoch reuses it):

      seg_last_flat    [S_cap] flat index (row * cap + col) of the segment's
                       last history token: the retrieval query
      seg_target       [S_cap] the held-out target id (0 in a padding slot)
      seg_weight       [S_cap] 1.0 for a real segment, 0.0 for a padding slot
      seg_example      [S_cap] the example's index in the dataset, -1 padding
      seg_invalid_ids  [S_cap, cap] the segment's own ids, 0-padded: the
                       top-k filter of that query alone
    """

    def __init__(
        self,
        dataset: SequenceDataset,
        rows_per_batch: int,
        row_capacity: int,
        shuffle: bool = False,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        capacities: Optional[Sequence[int]] = None,  # None -> [row_capacity]
        row_multiple: int = 1,  # a batch's row count is rounded up to this
        segments_per_batch: Optional[int] = None,  # target examples per batch
        include_target: bool = True,
    ):
        self.dataset = dataset
        self.rows_per_batch = rows_per_batch
        self.row_capacity = row_capacity
        self.capacities = sorted(capacities) if capacities else [row_capacity]
        m = max(1, row_multiple)
        self.shuffle = shuffle
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.include_target = include_target
        self.epoch = 0

        ds = dataset
        u, l_hist = ds.ids.shape
        # both modes keep one slot past the history: the target (train) or
        # the inert carrier of the target's timestamp (eval)
        self.seg_lens = ds.lengths.astype(np.int64) + 1
        if int(self.seg_lens.max(initial=0)) > self.capacities[-1]:
            raise ValueError(
                f"pack row_capacity {self.capacities[-1]} < longest segment "
                f"{int(self.seg_lens.max())} (history + target)"
            )
        self._class_of = np.searchsorted(np.asarray(self.capacities), self.seg_lens)
        self.rows_of: Dict[int, int] = {}
        for ci, cap in enumerate(self.capacities):
            if segments_per_batch:
                sel = self._class_of == ci
                mean_seg = float(self.seg_lens[sel].mean()) if sel.any() else cap
                rows = int(np.ceil(segments_per_batch * mean_seg / cap))
            else:  # constant tokens per batch
                rows = int(round(rows_per_batch * self.capacities[-1] / cap))
            self.rows_of[cap] = -(-max(1, rows) // m) * m
        if not segments_per_batch:
            self.rows_of[self.capacities[-1]] = -(-rows_per_batch // m) * m

        def ext(hist: np.ndarray, last: np.ndarray) -> np.ndarray:
            """[U, L+1] token table with `last` as each segment's final token."""
            out = np.zeros((u, l_hist + 1), dtype=np.int32)
            out[:, :l_hist] = hist
            out[np.arange(u), ds.lengths] = last
            return out

        if include_target:
            self._ids_ext = ext(ds.ids, ds.target_id)
            self._ratings_ext = ext(ds.ratings, ds.target_rating)
        else:
            self._ids_ext = np.pad(ds.ids.astype(np.int32), ((0, 0), (0, 1)))
            self._ratings_ext = np.pad(ds.ratings.astype(np.int32), ((0, 0), (0, 1)))
        self._ts_ext = ext(ds.timestamps, ds.target_timestamp)
        self._plans: Dict[int, List[Tuple[int, np.ndarray]]] = {}
        if not include_target:
            self.seg_cap: Dict[int, int] = {}
            for cap, bp in self._plan(0):
                # the most segments any process's rows of the batch hold
                shares = np.bincount(bp[:, 1] % process_count, minlength=process_count)
                self.seg_cap[cap] = max(self.seg_cap.get(cap, 1), int(shares.max(initial=1)))
            for cap in self.seg_cap:
                self.seg_cap[cap] = -(-self.seg_cap[cap] // m) * m

    def _plan(self, epoch: int) -> List[Tuple[int, np.ndarray]]:
        """The epoch's global batches: (capacity, [S, 2] array of (example
        index, row within the global batch))."""
        if epoch in self._plans:
            return self._plans[epoch]
        rng = np.random.default_rng(self.seed + epoch) if self.shuffle else None
        order = np.arange(len(self.dataset))
        if rng is not None:
            rng.shuffle(order)
        batches = []
        for ci, cap in enumerate(self.capacities):
            members = order[self._class_of[order] == ci]
            if len(members) == 0:
                continue
            rows = pack_rows_best_fit(self.seg_lens[members], cap)
            per_batch = self.rows_of[cap] * self.process_count  # the global batch's rows
            for b in range(int(rows.max() // per_batch + 1)):
                sel = (rows >= b * per_batch) & (rows < (b + 1) * per_batch)
                batches.append((cap, np.stack([members[sel], rows[sel] - b * per_batch], axis=1)))
        if rng is not None and len(self.capacities) > 1:
            # shuffle the order of the classes, keep same-shape batches adjacent
            cap_rank = {c: i for i, c in enumerate(rng.permutation(self.capacities))}
            batches.sort(key=lambda t: cap_rank[t[0]])
        self._plans = {epoch: batches}  # one epoch only
        return batches

    def __len__(self) -> int:
        return len(self._plan(self.epoch))

    def _emit(self, cap: int, plan: np.ndarray) -> Dict[str, np.ndarray]:
        p, l_cap = self.rows_of[cap], cap
        examples, grow = plan[:, 0], plan[:, 1]
        pc, pi = self.process_count, self.process_index
        if pc > 1:
            mine = grow % pc == pi
            examples, grow = examples[mine], grow[mine] // pc
        if len(examples) == 0:  # a tail batch with no rows for this process
            return self._empty(cap)
        # best-fit rows are not in stream order: group the entries by row
        # (stable, so arrival order inside a row is kept)
        order = np.argsort(grow, kind="stable")
        examples, grow = examples[order], grow[order]
        seg_lens = self.seg_lens[examples]
        total = int(seg_lens.sum())
        # per token: example, row, position within the segment, column
        tok_ex = np.repeat(examples, seg_lens)
        tok_row = np.repeat(grow, seg_lens)
        starts = np.concatenate([[0], np.cumsum(seg_lens)[:-1]])
        tok_pos = np.arange(total, dtype=np.int64) - np.repeat(starts, seg_lens)
        # a segment's offset in its row: the tokens of the row's earlier segments
        row_change = np.concatenate([[True], grow[1:] != grow[:-1]])
        row_start_tok = np.where(row_change, starts, 0)
        np.maximum.accumulate(row_start_tok, out=row_start_tok)
        offsets = starts - row_start_tok
        tok_col = tok_pos + np.repeat(offsets, seg_lens)
        seg_in_row = np.arange(len(examples)) - np.maximum.accumulate(
            np.where(row_change, np.arange(len(examples)), 0)
        )
        flat = tok_row * l_cap + tok_col

        def scatter(table: np.ndarray, fill: int = 0) -> np.ndarray:
            out = np.full(p * l_cap, fill, dtype=np.int32)
            out[flat] = table
            return out.reshape(p, l_cap)

        batch = {
            "ids": scatter(self._ids_ext[tok_ex, tok_pos]),
            "ratings": scatter(self._ratings_ext[tok_ex, tok_pos]),
            "timestamps": scatter(self._ts_ext[tok_ex, tok_pos]),
            "positions": scatter(tok_pos.astype(np.int32)),
            "seg_ids": scatter(np.repeat(seg_in_row, seg_lens).astype(np.int32), -1),
            "lengths": np.zeros(p, dtype=np.int32),
            "num_segments": np.zeros(p, dtype=np.int32),
        }
        np.add.at(batch["lengths"], tok_row, 1)
        np.add.at(batch["num_segments"], grow, 1)
        if not self.include_target:
            s_cap = self.seg_cap[cap]
            n_seg = len(examples)
            assert n_seg <= s_cap, (n_seg, s_cap)
            # the query is the segment's last HISTORY token; the final slot is
            # the inert carrier of the target's timestamp
            seg_last_flat = np.zeros(s_cap, dtype=np.int32)
            seg_last_flat[:n_seg] = (
                grow * l_cap + offsets + np.maximum(seg_lens - 2, 0)
            ).astype(np.int32)
            seg_target = np.zeros(s_cap, dtype=np.int32)
            seg_target[:n_seg] = self.dataset.target_id[examples]
            seg_weight = np.zeros(s_cap, dtype=np.float32)
            seg_weight[:n_seg] = 1.0
            seg_example = np.full(s_cap, -1, dtype=np.int32)
            seg_example[:n_seg] = examples.astype(np.int32)
            seg_invalid = np.zeros(s_cap * l_cap, dtype=np.int32)
            tok_seg = np.repeat(np.arange(n_seg, dtype=np.int64), seg_lens)
            seg_invalid[tok_seg * l_cap + tok_pos] = self._ids_ext[tok_ex, tok_pos]
            batch.update(
                seg_last_flat=seg_last_flat,
                seg_target=seg_target,
                seg_weight=seg_weight,
                seg_example=seg_example,
                seg_invalid_ids=seg_invalid.reshape(s_cap, l_cap),
            )
        return batch

    def _empty(self, cap: int) -> Dict[str, np.ndarray]:
        """A batch of the class's shape without a segment."""
        p = self.rows_of[cap]
        batch = {key: np.zeros((p, cap), dtype=np.int32)
                 for key in ("ids", "ratings", "timestamps", "positions")}
        batch.update(seg_ids=np.full((p, cap), -1, dtype=np.int32),
                     lengths=np.zeros(p, dtype=np.int32),
                     num_segments=np.zeros(p, dtype=np.int32))
        if not self.include_target:
            s_cap = self.seg_cap[cap]
            batch.update(
                seg_last_flat=np.zeros(s_cap, dtype=np.int32),
                seg_target=np.zeros(s_cap, dtype=np.int32),
                seg_weight=np.zeros(s_cap, dtype=np.float32),
                seg_example=np.full(s_cap, -1, dtype=np.int32),
                seg_invalid_ids=np.zeros((s_cap, cap), dtype=np.int32),
            )
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        plan = self._plan(self.epoch)
        self.epoch += 1
        for cap, batch_plan in plan:
            yield self._emit(cap, batch_plan)
