"""Schema-agnostic sequence dataset front end.

Port of mygenerativerecommenders_tpu/data/dynamic_dataset.py (the
reference's side package `src/miaoxin_recodata/`): competition-style CSVs
with arbitrary column names, consumed without per-dataset code.

- `FeatureLookupTable`: a feature CSV with an auto-detected id column
  becomes id -> feature arrays.
- `DynamicSequenceDataset`: auto-detects the user-id column and every
  `sequence_*` column, parses each into a dense [U, L] int64 array,
  right-pads, applies `shift_id_by`, and takes each row's target as the
  LAST element of its item sequence.

The batches carry the keys of data/dataset.py's loader, so the trainer's
step takes them as they are. Nothing else in the port calls this module (nor
in the JAX package).

JAX reads the CSV with pandas; the port reads it with `csv` and numpy, and
decides where pandas decides:
- a column's type (`pd.read_csv`'s default inference): int64 where every
  present cell is an integer and none is missing, float64 where every present
  cell is a number (a missing cell is NaN; a column with no present cell is
  all NaN), bool where every cell is True or False, else strings (missing
  cells NaN). Missing means an empty cell or one of pandas' default NA
  strings. `csv` strips the quotes of a quoted cell as pandas does;
- "numeric" (`pd.api.types.is_numeric_dtype`): int64, float64 and bool;
- a list column: not numeric, its first cell's text starting with "[";
  a list cell is parsed by numpy's `np.fromstring(..., sep=",")` as JAX's
  `_parse_num_list` does (float64, truncated to int64 where stored);
- `pd.to_numeric(errors="coerce").fillna(0)` of a scalar column: a cell that
  is not a number (and a missing one) becomes 0; int64 where every cell is an
  integer, else float64, truncated towards zero where stored into int64.
JAX's constructors also take a DataFrame; the port's take a path.
"""

from __future__ import annotations

import csv
import re
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

# pandas' default NA strings (pd.read_csv's na_values)
_NA = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_INT = re.compile(r"\s*[+-]?\d+\s*")
_BOOL = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False,
         "false": False}


def _number(cell: str) -> Optional[float]:
    try:
        return float(cell)
    except ValueError:
        return None


def _typed(cells: List[str]) -> np.ndarray:
    """One column's cells as pandas' read_csv types them."""
    missing = [c in _NA for c in cells]
    present = [c for c, m in zip(cells, missing) if not m]
    if all(_INT.fullmatch(c) for c in present):
        if not any(missing):
            return np.array([int(c) for c in cells], dtype=np.int64)
        return np.array([np.nan if m else float(int(c)) for c, m in zip(cells, missing)],
                        dtype=np.float64)
    if all(_number(c) is not None for c in present):
        return np.array([np.nan if m else float(c) for c, m in zip(cells, missing)],
                        dtype=np.float64)
    if not any(missing) and all(c in _BOOL for c in cells):
        return np.array([_BOOL[c] for c in cells], dtype=bool)
    return np.array([np.nan if m else c for c, m in zip(cells, missing)], dtype=object)


def _read_columns(csv_path: str) -> Dict[str, np.ndarray]:
    """A CSV with a header row -> column name -> typed array, in file order
    (blank lines skipped, as pandas skips them)."""
    with open(csv_path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        raise ValueError(f"{csv_path}: no header row")
    header, body = rows[0], rows[1:]
    columns = [[] for _ in header]
    for r in body:
        for j in range(len(header)):
            columns[j].append(r[j] if j < len(r) else "")
    return {name: _typed(cells) for name, cells in zip(header, columns)}


def _is_numeric(values: np.ndarray) -> bool:
    return values.dtype != object


def _to_numeric(values: np.ndarray) -> np.ndarray:
    """`pd.to_numeric(values, errors="coerce").fillna(0).to_numpy()`."""
    if _is_numeric(values):
        return np.nan_to_num(values, nan=0.0) if values.dtype == np.float64 else values
    if all(isinstance(v, str) and _INT.fullmatch(v) for v in values):
        return np.array([int(v) for v in values], dtype=np.int64)
    parsed = [_number(v) if isinstance(v, str) else None for v in values]
    return np.array([0.0 if x is None or x != x else x for x in parsed], dtype=np.float64)


def _parse_num_list(s) -> np.ndarray:
    return np.fromstring(str(s).strip()[1:-1], dtype=np.float64, sep=",")


def _detect_user_col(columns: List[str]) -> str:
    for col in columns:
        if "user" in col.lower() and "sequence" not in col.lower():
            return col
    return columns[0]


class FeatureLookupTable:
    """Feature CSV -> per-feature numpy lookup keyed by the id column."""

    def __init__(self, csv_path: str, id_column: Optional[str] = None):
        frame = _read_columns(csv_path)
        names = list(frame)
        if id_column is None:
            candidates = [c for c in names if c.lower().endswith("_id") or c.lower() == "id"]
            id_column = candidates[0] if candidates else names[0]
        self.id_column = id_column
        ids = frame[id_column].astype(np.int64)
        self.max_id = int(ids.max())
        self.tables: Dict[str, np.ndarray] = {}
        for col in names:
            if col == id_column:
                continue
            values = frame[col]
            is_list_col = not _is_numeric(values) and str(values[0]).strip().startswith("[")
            if is_list_col:
                parsed = [_parse_num_list(v) for v in values]
                width = max(len(p) for p in parsed)
                table = np.zeros((self.max_id + 1, width), dtype=np.int64)
                for i, p in zip(ids, parsed):
                    table[i, : len(p)] = p
            else:
                table = np.zeros(self.max_id + 1, dtype=np.int64)
                table[ids] = _to_numeric(values)
            self.tables[col] = table

    def lookup(self, feature: str, item_ids: np.ndarray) -> np.ndarray:
        table = self.tables[feature]
        return table[np.clip(item_ids, 0, self.max_id)]


@dataclass
class DynamicSequenceDataset:
    """Dense arrays for an arbitrary-schema sequence CSV."""

    lengths: np.ndarray  # [U]
    sequences: Dict[str, np.ndarray]  # name (sans sequence_ prefix) -> [U, L]
    targets: Dict[str, np.ndarray]  # name -> [U]
    user_ids: np.ndarray
    item_column: str = "item_ids"

    def __len__(self) -> int:
        return len(self.lengths)

    @staticmethod
    def from_csv(
        csv_path: str,
        max_sequence_length: int,
        ignore_last_n: int = 0,
        shift_id_by: int = 0,
        item_column: Optional[str] = None,
    ) -> "DynamicSequenceDataset":
        frame = _read_columns(csv_path)
        columns = list(frame)
        user_col = _detect_user_col(columns)
        seq_cols = [c for c in columns if c.lower().startswith("sequence_")]
        if not seq_cols:
            raise ValueError("No sequence_* columns found")
        names = [c[len("sequence_"):] for c in seq_cols]
        if item_column is None:
            item_column = next((n for n in names if "item" in n.lower()), names[0])

        u, L = len(frame[user_col]), max_sequence_length
        lengths = np.zeros(u, dtype=np.int32)
        sequences = {n: np.zeros((u, L), dtype=np.int64) for n in names}
        targets = {n: np.zeros(u, dtype=np.int64) for n in names}
        parsed_cols = {n: frame[c] for n, c in zip(names, seq_cols)}
        for i in range(u):
            row = {n: _parse_num_list(parsed_cols[n][i]) for n in names}
            n_items = len(row[item_column]) - ignore_last_n
            if n_items < 1:
                continue
            for name in names:
                vals = row[name][:n_items].astype(np.int64)
                if name == item_column and shift_id_by:
                    vals = vals + shift_id_by
                targets[name][i] = vals[-1]
                hist = vals[:-1][-L:]
                sequences[name][i, : len(hist)] = hist
            lengths[i] = min(n_items - 1, L)

        return DynamicSequenceDataset(
            lengths=lengths,
            sequences=sequences,
            targets=targets,
            user_ids=frame[user_col],
            item_column=item_column,
        )

    def batches(
        self, batch_size: int, shuffle: bool = False, seed: int = 0
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yields batches in the training stack's canonical schema."""
        n = len(self)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        num_batches = (n + batch_size - 1) // batch_size
        item = self.item_column
        ts_name = next((k for k in self.sequences if "time" in k.lower()), None)
        rating_name = next((k for k in self.sequences if "rating" in k.lower()), None)
        for bi in range(num_batches):
            idx = order[bi * batch_size : (bi + 1) * batch_size]
            pad = batch_size - len(idx)
            weight = np.ones(batch_size, dtype=np.float32)
            if pad:
                idx = np.concatenate([idx, np.zeros(pad, dtype=idx.dtype)])
                weight[batch_size - pad :] = 0.0
            batch = {
                "lengths": np.maximum(self.lengths[idx], 1),
                "ids": self.sequences[item][idx].astype(np.int32),
                "target_id": self.targets[item][idx].astype(np.int32),
                "sample_weight": weight,
            }
            ts = (
                self.sequences[ts_name][idx]
                if ts_name
                else np.cumsum(np.ones_like(batch["ids"]), axis=1)
            )
            batch["timestamps"] = ts.astype(np.int32)
            batch["target_timestamp"] = (
                self.targets[ts_name][idx].astype(np.int32)
                if ts_name
                else (batch["timestamps"].max(axis=1) + 1)
            )
            ratings = (
                self.sequences[rating_name][idx]
                if rating_name
                else np.zeros_like(batch["ids"])
            )
            batch["ratings"] = ratings.astype(np.int32)
            batch["target_rating"] = (
                self.targets[rating_name][idx].astype(np.int32)
                if rating_name
                else np.zeros(batch_size, dtype=np.int32)
            )
            yield batch
