"""Offline ETL: raw interaction files -> per-user chronological sequence CSVs.

Port of mygenerativerecommenders_tpu/data/preprocessor.py:31-240 and
`build_processor` (:336-370) without pandas: the files are read with the
stdlib (`csv`, `zipfile`) and numpy and written with `csv` as pandas'
`to_csv` writes them (minimal quoting, "\\n" line ends, Python's repr of each
number), so the processed files are byte for byte the JAX package's:

- `MovielensDataProcessor`: ml-1m's `::`-separated latin-1 `ratings.dat`,
  `movies.dat` and `users.dat`, or ml-20m's `ratings.csv` and `movies.csv`,
  from `<data_dir>/movielens_<name>.zip` -> `sasrec_format.csv` (user_id and
  the Python-list strings sequence_item_ids, sequence_ratings,
  sequence_timestamps, sorted by time; ml-1m adds the users' coded features),
  its 90/10 user-id split, `movies.csv` (title, year from a trailing
  "(YYYY)" else 0, the title without it) and for ml-1m `users.csv`;
- `MovielensNpzDataProcessor`: the ml-20mx16x32 shards `trainx16x32_<i>.npz`
  (user, movie pairs; rating and timestamp are placeholders);
- `AmazonDataProcessor`: a headerless `ratings_<Category>.csv` of (user, item,
  rating, time), users and items with fewer than `min_count` interactions
  dropped and both coded 1.. in order of first appearance.

Each column of a file read is typed as pandas' `read_csv` types it: ints if
every value is an integer, else floats if every value is a number, else
strings (so an all-digit ASIN column is read as ints, as pandas reads it).
Nothing downloads: a missing raw file raises `FileNotFoundError` naming the
file and the public source to take it from. Synthetic data is made in memory
(data/synthetic.py), not written here.
"""

from __future__ import annotations

import csv
import os
import re
import zipfile
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

SEQUENCE_COLUMNS = ("user_id", "sequence_item_ids", "sequence_ratings", "sequence_timestamps")
MOVIE_COLUMNS = ("movie_id", "title", "genres", "year", "cleaned_title")
USER_FEATURES = ("sex", "age_group", "occupation", "zip_code")
# the (item count, largest item id) build_processor pins for MovieLens
MOVIELENS_ITEMS = {"ml-1m": (3706, 3952), "ml-20m": (26744, 131262)}
# pandas' read_csv reads these as missing values (its default na_values)
_NA = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_YEAR = re.compile(r"\((\d{4})\)\s*$")
_YEAR_SUFFIX = re.compile(r"\s*\(\d{4}\)\s*$")


def typed_column(values: Sequence[str]) -> np.ndarray:
    """One column of strings, typed as pandas' read_csv types it: int64 if
    every value is an integer, float64 if every value is a number (or the
    integers have gaps: missing values are NaN), else an object array of str
    with None for the missing."""
    arr = np.asarray(values, dtype=str)
    missing = np.isin(arr, sorted(_NA))
    if not missing.any():
        for dtype in (np.int64, np.float64):
            try:
                return arr.astype(dtype)
            except (ValueError, OverflowError):
                pass
        return arr.astype(object)
    try:
        return np.where(missing, "nan", arr).astype(np.float64)
    except ValueError:
        out = arr.astype(object)
        out[missing] = None
        return out


def _cell(v) -> str:
    """A value as pandas' to_csv writes it: missing -> "", numbers by repr."""
    if v is None or (isinstance(v, float) and v != v):
        return ""
    return str(v)


def write_csv(path: str, columns: Sequence[str], rows) -> None:
    """Write `rows` (sequences of python values) under a header, as
    `DataFrame.to_csv(path, index=False)` does."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        writer.writerows([_cell(v) for v in row] for row in rows)


def _read_table(path: str, names: Optional[Sequence[str]] = None, sep: str = ",",
                encoding: str = "utf-8") -> Dict[str, np.ndarray]:
    """A delimited file -> {column: typed array}. `names` given: the file has
    no header. `sep="::"` splits each stripped line on "::" with no quoting
    (pandas' python engine with a regex separator); "," reads it as CSV."""
    with open(path, newline="", encoding=encoding) as f:
        if sep == ",":
            rows = [r for r in csv.reader(f) if r]
        else:
            rows = [line.strip().split(sep) for line in f if line.strip()]
    if names is None:
        names, rows = rows[0], rows[1:]
    width = len(names)
    for i, r in enumerate(rows):
        if len(r) != width:
            raise ValueError(f"{path}: line {i + 1} has {len(r)} fields, expected {width}")
    cols = list(zip(*rows)) if rows else [()] * width
    return {name: typed_column(list(col)) for name, col in zip(names, cols)}


def _codes(values: np.ndarray) -> np.ndarray:
    """`pd.Categorical(values).codes`: each value's index among the sorted
    distinct values."""
    return np.unique(values, return_inverse=True)[1].reshape(-1)


def _factorize(values: np.ndarray) -> tuple:
    """`pd.factorize(values)`: codes 0.. in order of first appearance, and the
    distinct values in that order."""
    uniques, first, inverse = np.unique(values, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return rank[inverse.reshape(-1)], uniques[order]


@dataclass
class DataProcessor:
    download_path: str = ""
    saved_name: str = ""
    prefix: str = "ml-1m"
    data_dir: str = "tmp"
    expected_num_unique_items: int = 0
    expected_max_item_id: int = 0

    def processed_dir(self) -> str:
        return os.path.join(self.data_dir, "processed", self.prefix)

    def output_format_csv(self) -> str:
        return os.path.join(self.processed_dir(), "sasrec_format.csv")

    def processed_item_csv(self) -> str:
        return os.path.join(self.processed_dir(), "movies.csv")

    def train_split_csv(self) -> str:
        return os.path.join(self.processed_dir(), "sasrec_format_train.csv")

    def test_split_csv(self) -> str:
        return os.path.join(self.processed_dir(), "sasrec_format_test.csv")

    def preprocess_rating(self) -> int:
        raise NotImplementedError

    def _missing(self, path: str, what: str) -> FileNotFoundError:
        source = f" (public source: {self.download_path})" if self.download_path else ""
        return FileNotFoundError(
            f"{what} not found at {path}{source}; nothing is downloaded: put the "
            f"file there, or point data.data_dir at the directory that holds it"
        )

    def _write_sequences(self, ratings: Dict[str, np.ndarray],
                         users: Optional[Dict[str, np.ndarray]] = None) -> int:
        """Sort the ratings by (user, time), stably; one row per user in user
        order with the Python-list strings of its items, ratings and times;
        the users' features merged on user_id; then the 90/10 user-id split
        (JAX :60-88)."""
        os.makedirs(self.processed_dir(), exist_ok=True)
        user, ts = ratings["user_id"], ratings["unix_timestamp"]
        order = np.lexsort((ts, user))  # stable: ties keep the file's order
        cols = [ratings[k][order] for k in ("user_id", "movie_id", "rating", "unix_timestamp")]
        user_ids, starts = np.unique(cols[0], return_index=True)
        bounds = list(starts[1:]) + [len(order)]
        lists = [
            [str(c[a:b].tolist()) for a, b in zip(starts, bounds)] for c in cols[1:]
        ]
        columns = list(SEQUENCE_COLUMNS)
        rows = [[u, *vals] for u, *vals in zip(user_ids.tolist(), *lists)]
        if users is not None:
            features = [k for k in users if k != "user_id"]
            columns += features
            at = {u: i for i, u in enumerate(users["user_id"].tolist())}
            known = [at.get(u) for u in user_ids.tolist()]
            # a user absent from the features file: pandas' left merge makes
            # the feature columns float, with the absent ones empty
            as_float = any(i is None for i in known)
            for row, i in zip(rows, known):
                for k in features:
                    v = None if i is None else users[k][i].item()
                    row.append(float(v) if as_float and v is not None else v)
        write_csv(self.output_format_csv(), columns, rows)

        num_users = len(user_ids)
        threshold = user_ids[int(num_users * 0.9) - 1]  # user_ids is sorted
        write_csv(self.train_split_csv(), columns, [r for r in rows if r[0] <= threshold])
        write_csv(self.test_split_csv(), columns, [r for r in rows if r[0] > threshold])
        return len(rows)


@dataclass
class MovielensDataProcessor(DataProcessor):
    def extract(self) -> str:
        """Extract the zip already at `saved_name` into <data_dir>/raw (the
        JAX package's `download`, which fetches it first when missing)."""
        if not os.path.exists(self.saved_name):
            raise self._missing(self.saved_name, f"the MovieLens {self.prefix} zip")
        extract_dir = os.path.join(self.data_dir, "raw")
        os.makedirs(extract_dir, exist_ok=True)
        with zipfile.ZipFile(self.saved_name) as zf:
            zf.extractall(extract_dir)
        return os.path.join(extract_dir, self.prefix)

    def preprocess_rating(self) -> int:
        raw_dir = self.extract()
        users = None
        names = ["user_id", "movie_id", "rating", "unix_timestamp"]
        if self.prefix == "ml-1m":
            def dat(name, columns):
                return _read_table(os.path.join(raw_dir, name), columns, "::", "latin-1")

            ratings = dat("ratings.dat", names)
            movies = dat("movies.dat", ["movie_id", "title", "genres"])
            users = dat("users.dat", ["user_id", *USER_FEATURES])
            for col in USER_FEATURES:  # categorical codes (JAX :131-132)
                users[col] = _codes(users[col])
        else:  # ml-20m style (no user features)
            ratings = dict(zip(names, _read_table(os.path.join(raw_dir, "ratings.csv")).values()))
            movies = dict(zip(["movie_id", "title", "genres"],
                              _read_table(os.path.join(raw_dir, "movies.csv")).values()))

        years, cleaned = [], []
        for title in movies["title"].tolist():
            if title is None:
                years.append(0)
                cleaned.append(None)
                continue
            m = _YEAR.search(title)
            years.append(int(m.group(1)) if m else 0)
            cleaned.append(_YEAR_SUFFIX.sub("", title).strip())
        os.makedirs(self.processed_dir(), exist_ok=True)
        write_csv(self.processed_item_csv(), MOVIE_COLUMNS, zip(
            movies["movie_id"].tolist(), movies["title"].tolist(), movies["genres"].tolist(),
            years, cleaned,
        ))
        if users is not None:
            cols = ["user_id", *USER_FEATURES]
            write_csv(os.path.join(self.processed_dir(), "users.csv"), cols,
                      zip(*(users[c].tolist() for c in cols)))
        return self._write_sequences(ratings, users)


@dataclass
class MovielensNpzDataProcessor(DataProcessor):
    """ml-20mx16x32: 16 shards `trainx16x32_{i}.npz` under
    `<data_dir>/raw/<prefix>/`, each `arr_0` rows of (user_id, movie_id); the
    rating and timestamp columns are placeholders (user_id and movie_id), as
    in the JAX package (:153-187)."""

    num_shards: int = 16

    def raw_dir(self) -> str:
        return os.path.join(self.data_dir, "raw", self.prefix)

    def preprocess_rating(self) -> int:
        pairs = []
        for i in range(self.num_shards):
            path = os.path.join(self.raw_dir(), f"trainx16x32_{i}.npz")
            if not os.path.exists(path):
                raise self._missing(path, f"ml-20mx16x32 shard {i} of {self.num_shards}")
            with np.load(path) as data:
                pairs.append(np.asarray(data["arr_0"], dtype=np.int64))
        arr = np.concatenate(pairs, axis=0)
        os.makedirs(self.processed_dir(), exist_ok=True)
        return self._write_sequences({
            "user_id": arr[:, 0], "movie_id": arr[:, 1],
            "rating": arr[:, 0], "unix_timestamp": arr[:, 1],
        })


@dataclass
class AmazonDataProcessor(DataProcessor):
    # the reference's >= 5 interactions filter, for users and items alike
    min_count: int = 5

    def preprocess_rating(self) -> int:
        if not os.path.exists(self.saved_name):
            raise self._missing(self.saved_name, "the Amazon ratings CSV")
        table = _read_table(self.saved_name, ["user_id", "movie_id", "rating", "unix_timestamp"])
        if self.min_count > 1:
            # drop the interactions of users and items seen fewer than
            # min_count times, both counted before either filter
            keep = np.ones(len(table["user_id"]), dtype=bool)
            for col in ("movie_id", "user_id"):
                _, inverse, counts = np.unique(
                    table[col], return_inverse=True, return_counts=True)
                keep &= counts[inverse.reshape(-1)] >= self.min_count
            table = {k: v[keep] for k, v in table.items()}
        # integer codes, 1-based (0 pads), in order of first appearance
        table["user_id"] = _factorize(table["user_id"])[0] + 1
        item_codes, item_uniques = _factorize(table["movie_id"])
        table["movie_id"] = item_codes + 1
        os.makedirs(self.processed_dir(), exist_ok=True)
        titles = item_uniques.tolist()
        write_csv(self.processed_item_csv(), MOVIE_COLUMNS, (
            (i + 1, t, "unknown", 0, t) for i, t in enumerate(titles)
        ))
        return self._write_sequences(table)


def build_processor(dataset_name: str, data_dir: str, **kwargs) -> DataProcessor:
    """The processor of a dataset name (JAX :336-370); synthetic names have
    none here (data/synthetic.py makes them in memory)."""
    if dataset_name == "ml-20mx16x32":
        return MovielensNpzDataProcessor(prefix=dataset_name, data_dir=data_dir, **kwargs)
    if dataset_name in MOVIELENS_ITEMS:
        num_items, max_item_id = MOVIELENS_ITEMS[dataset_name]
        return MovielensDataProcessor(
            download_path=f"http://files.grouplens.org/datasets/movielens/{dataset_name}.zip",
            saved_name=os.path.join(data_dir, f"movielens_{dataset_name}.zip"),
            prefix=dataset_name,
            data_dir=data_dir,
            expected_num_unique_items=num_items,
            expected_max_item_id=max_item_id,
            **kwargs,
        )
    if dataset_name.startswith("amzn") or dataset_name.startswith("amazon"):
        # amzn-books -> ratings_Books.csv (snap.stanford.edu Amazon product data)
        category = dataset_name.split("-", 1)[1].capitalize() if "-" in dataset_name else ""
        extra: Dict[str, str] = {}
        if category:
            extra = dict(
                download_path=(
                    "http://snap.stanford.edu/data/amazon/productGraph/"
                    f"categoryFiles/ratings_{category}.csv"
                ),
                saved_name=os.path.join(data_dir, f"ratings_{category}.csv"),
            )
        extra.update(kwargs)
        return AmazonDataProcessor(prefix=dataset_name, data_dir=data_dir, **extra)
    raise ValueError(f"Unknown dataset {dataset_name}")

