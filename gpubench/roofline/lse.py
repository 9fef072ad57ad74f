"""The dense-negative lse pair and its count (ops/dense_negatives.py): for
BT positions with R draws each over a catalog of X rows, the count writes a
[BT, X] table (1 byte a cell at R <= 255, else 4) from the draws; the
forward and the backward walk the live logits, those of a distinct draw
other than the positive. A row's distinct draws are counted at their
expectation, X (1 - (1 - 1/X)^R) (the draws are uniform and independent)."""

from gpubench.roofline import F32, least_s


def live_logits(bt: int, x: int, r: int) -> float:
    return bt * x * (1.0 - (1.0 - 1.0 / x) ** r) * (1.0 - 1.0 / x)


def step_s(bt: int, x: int, r: int, d: int) -> float:
    """Least seconds of one step's count, forward and backward."""
    count_bytes = bt * x * (1 if r <= 255 else 4)
    nnz = live_logits(bt, x, r)
    count = least_s(F32 * (bt * r + bt) + count_bytes)
    fwd = least_s(F32 * (bt * d + x * d + 3 * bt) + count_bytes, nnz * 2 * d)
    bwd = least_s(F32 * (2 * bt * d + 2 * x * d + 3 * bt) + count_bytes, nnz * 6 * d)
    return count + fwd + bwd
