"""Raw interaction files in the published formats, small, for the port's
real-data tests: MovieLens 1M (`::`, latin-1) and 20M (CSV) zips, an Amazon
ratings CSV and ml-20mx16x32 npz shards. No JAX here: the card's tests
(tests/test_torch_port_gpu.py) write their fixture with it too.
"""

import csv
import io
import zipfile
from pathlib import Path

import numpy as np

# titles as MovieLens writes them: commas, quotes (one leading), latin-1
# letters, trailing blanks, no year, a year-like number that is not "(YYYY)"
TITLES = [
    "Toy Story (1995)", "Amélie (Fabuleux destin d'Amélie Poulain, Le) (2001)",
    "Shawshank Redemption, The (1994)", '"Great" Escape, The (1963)', "Untitled Project",
    'Mid "quote", here (1999) ', "Babylon 5", "Señor Español (1988)", "Ça (2010)",
    "2001: A Space Odyssey (1968)", "Blade Runner 2049", "Los Años (19999)",
]


def _title(i: int, m: int) -> str:
    """The i-th listed movie's title: every other one from TITLES."""
    return TITLES[i // 2 % len(TITLES)] if i % 2 == 0 else f"Movie {m} ({1930 + m % 70})"


def write_ml1m_zip(root: Path, num_users: int = 40, seed: int = 0, max_len: int = 30) -> Path:
    """`movielens_ml-1m.zip` with ml-1m/{ratings,movies,users}.dat: ids up to
    3 x the listed movies, some listed movies never rated, ties in time."""
    rng = np.random.default_rng(seed)
    listed = np.arange(1, 3 * 60, 3)
    rated = listed[: len(listed) - 7]
    lines = []
    for u in range(1, num_users + 1):
        for _ in range(int(rng.integers(3, max_len + 1))):
            lines.append(f"{u}::{rng.choice(rated)}::{rng.integers(1, 6)}::"
                         f"{978_300_000 + int(rng.integers(0, 40))}")
    rng.shuffle(lines)
    movies = "".join(f"{m}::{_title(i, m)}::Drama|Comedy\n" for i, m in enumerate(listed))
    zips = ["48067", "55117-1234", "10001", "02139", "9"]
    users = "".join(
        f"{u}::{'MF'[u % 2]}::{[1, 18, 25, 35, 56][u % 5]}::{u % 21}::{zips[u % 5]}\n"
        for u in range(1, num_users + 1)
    )
    path = root / "movielens_ml-1m.zip"
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("ml-1m/ratings.dat", ("\n".join(lines) + "\n").encode("latin-1"))
        z.writestr("ml-1m/movies.dat", movies.encode("latin-1"))
        z.writestr("ml-1m/users.dat", users.encode("latin-1"))
    return path


def write_ml20m_zip(root: Path, num_users: int = 30, seed: int = 1) -> Path:
    """`movielens_ml-20m.zip` with ml-20m/{ratings,movies}.csv: half-star
    float ratings, quoted titles."""
    rng = np.random.default_rng(seed)
    listed = np.arange(2, 5 * 40, 5)
    ratings, movies = io.StringIO(), io.StringIO()
    w = csv.writer(ratings, lineterminator="\n")
    w.writerow(["userId", "movieId", "rating", "timestamp"])
    for u in range(1, num_users + 1):
        for _ in range(int(rng.integers(3, 20))):
            w.writerow([u, int(rng.choice(listed)), float(rng.integers(1, 11)) / 2,
                        1_100_000_000 + int(rng.integers(0, 30))])
    w = csv.writer(movies, lineterminator="\n")
    w.writerow(["movieId", "title", "genres"])
    for i, m in enumerate(listed):
        w.writerow([m, _title(i, m), "(no genres listed)" if m % 2 else "Action|Sci-Fi"])
    path = root / "movielens_ml-20m.zip"
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("ml-20m/ratings.csv", ratings.getvalue())
        z.writestr("ml-20m/movies.csv", movies.getvalue())
    return path


def write_amazon_csv(path: Path, num_users: int = 30, num_items: int = 40, seed: int = 2,
                     digit_asins: bool = False) -> Path:
    """A headerless ratings CSV (user, ASIN, float rating, time) with
    power-law item popularity; `digit_asins`: every ASIN all digits (pandas
    reads the column as ints)."""
    rng = np.random.default_rng(seed)
    asins = [f"{i:010d}" if digit_asins else (f"B{i:09d}" if i % 3 else f"{i:09d}X")
             for i in range(num_items)]
    pop = 1.0 / np.arange(1, num_items + 1)
    pop /= pop.sum()
    with open(path, "w") as f:
        for _ in range(num_users * 7):
            user = f"A{int(rng.integers(0, num_users)) * 7919 % 100000:05d}Z"
            f.write(f"{user},{asins[rng.choice(num_items, p=pop)]},"
                    f"{float(rng.integers(1, 6))},{1_300_000_000 + int(rng.integers(0, 50))}\n")
    return path


def write_npz_shards(root: Path, shards: int = 3, seed: int = 3) -> None:
    raw = root / "raw" / "ml-20mx16x32"
    raw.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(shards):
        pairs = np.stack([rng.integers(1, 12, size=40), rng.integers(1, 90, size=40)], axis=1)
        np.savez(raw / f"trainx16x32_{i}.npz", pairs)
