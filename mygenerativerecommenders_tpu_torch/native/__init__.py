"""The native (C++) sequence-CSV parser, loaded with ctypes.

The port's own copy of mygenerativerecommenders_tpu/native/: `seq_parser.cpp`
streams a `sasrec_format.csv` once and writes the dense [U, L] arrays of
`SequenceDataset` (data/dataset.py). It is compiled by `g++ -O3 -std=c++17
-shared -fPIC` at first use, never at import, into the package's gitignored
`_build/` as `seq_parser-<hash>.so` (the hash covers the source and the
flags, so an edited source rebuilds). A failed build raises with the
compiler's output: nothing falls back silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "seq_parser.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _target() -> Path:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + _SRC.read_bytes())
    return BUILD_DIR / f"seq_parser-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a current one exists; -> its path."""
    target = _target()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"the native sequence parser needs g++: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"building the native sequence parser failed ({' '.join(cmd)}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, target)  # another process may build it too: last one wins
    return target


def load() -> ctypes.CDLL:
    """Build (at first use) and load the library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.mgr_count_rows.restype = ctypes.c_int64
            lib.mgr_count_rows.argtypes = [ctypes.c_char_p]
            lib.mgr_parse_sequences.restype = ctypes.c_int64
            lib.mgr_parse_sequences.argtypes = [
                ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int64, i32p, i32p, i32p, i32p, i32p, i32p, i32p, i64p,
            ]
            _lib = lib
    return _lib


def parse_sequences_native(
    path: str, max_len: int, ignore_last_n: int, chronological: bool
) -> Dict[str, np.ndarray]:
    """The sequence CSV at `path` -> the dense arrays of SequenceDataset
    (lengths, ids, ratings, timestamps, target_id, target_rating,
    target_timestamp, user_ids)."""
    lib = load()
    encoded = os.fsencode(path)
    u = lib.mgr_count_rows(encoded)
    if u < 0:
        raise FileNotFoundError(f"cannot open the sequence CSV {path}")
    L = max_len
    out = {
        "lengths": np.zeros(u, dtype=np.int32),
        "ids": np.zeros((u, L), dtype=np.int32),
        "ratings": np.zeros((u, L), dtype=np.int32),
        "timestamps": np.zeros((u, L), dtype=np.int32),
        "target_id": np.zeros(u, dtype=np.int32),
        "target_rating": np.zeros(u, dtype=np.int32),
        "target_timestamp": np.zeros(u, dtype=np.int32),
        "user_ids": np.zeros(u, dtype=np.int64),
    }
    i32p = ctypes.POINTER(ctypes.c_int32)
    ptrs = [out[k].ctypes.data_as(i32p) for k in (
        "lengths", "ids", "ratings", "timestamps", "target_id", "target_rating",
        "target_timestamp",
    )]
    rows = lib.mgr_parse_sequences(
        encoded, L, ignore_last_n, int(chronological), u, *ptrs,
        out["user_ids"].ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rows != u:
        raise ValueError(f"the native parser read {rows} rows of {path}, expected {u}")
    return out
