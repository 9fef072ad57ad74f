"""HSTU attention's work: one kernel call over rows described by `rows_desc`
(see `describe`), forward and backward, as chip_smoke.py counts it."""

from typing import List

import numpy as np

from gpubench.roofline import F32, least_s


def describe(lengths: np.ndarray, n: int, positions: np.ndarray = None) -> dict:
    """One call's rows: `lengths` [B] valid rows of each row (the kernel's
    lengths), `n` the padded width, `positions` [B, n] within-segment
    positions of packed rows (None: row index). -> {"b", "n", "rows",
    "stamps", "small_pos", "pairs", "packed"}: valid rows, timestamps read,
    the largest position, and the live pairs (a valid row sees the keys
    from its segment's start on: position + 1 of them)."""
    b = len(lengths)
    seq = np.minimum(lengths.astype(np.int64), n)
    valid = np.arange(n)[None, :] < seq[:, None]
    pos = np.broadcast_to(np.arange(n), (b, n)) if positions is None else positions.astype(np.int64)
    live = pos[valid]
    return {"b": b, "n": n, "rows": int(seq.sum()), "stamps": int(np.minimum(seq + 1, n).sum()),
            "max_pos": int(live.max()) if live.size else 0, "pairs": int((live + 1).sum()),
            "packed": positions is not None}


def _small(c: dict, ts_entries: int) -> int:
    return c["b"] + c["max_pos"] + 1 + ts_entries + (c["rows"] if c["packed"] else 0)


def forward_s(calls: List[dict], heads: int, dqk: int, dv: int, ts_entries: int) -> float:
    """Reads q, k, v and the stamps of the valid rows, the lengths, the bias
    entries reached; writes the whole output; q.k and p.v over live pairs."""
    total = 0.0
    for c in calls:
        reads = c["rows"] * heads * (2 * dqk + dv) + c["stamps"] + _small(c, ts_entries)
        total += least_s(F32 * (reads + c["b"] * c["n"] * heads * dv),
                         c["pairs"] * heads * 2 * (dqk + dv))
    return total


def backward_s(calls: List[dict], heads: int, dqk: int, dv: int, ts_entries: int,
               pos_entries: int) -> float:
    """Reads q, k, v and g of the valid rows; writes dq, dk, dv whole and both
    tables' gradients; q.k, g.v, dz k, dz q and p g over live pairs."""
    total = 0.0
    for c in calls:
        reads = c["rows"] * heads * (2 * dqk + 2 * dv) + c["stamps"] + _small(c, ts_entries)
        writes = c["b"] * c["n"] * heads * (2 * dqk + dv) + pos_entries + ts_entries
        total += least_s(F32 * (reads + writes), c["pairs"] * heads * 2 * (3 * dqk + 2 * dv))
    return total
