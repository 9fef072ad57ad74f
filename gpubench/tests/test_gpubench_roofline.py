"""The yardstick's counts against hand counts at tiny shapes."""

import numpy as np
import pytest

from gpubench.reference.hstu import Dims
from gpubench.roofline import PEAKS, least_s
from gpubench.roofline import adamw, attention, lse, step

F, B = PEAKS["fp32_flops_per_s"], PEAKS["hbm_bytes_per_s"]


def test_attention_counts_unpacked_and_packed():
    c = attention.describe(np.array([3, 1]), 4)
    # rows 0-2 see 1, 2, 3 keys; row 0 of the second sees 1
    assert (c["rows"], c["pairs"], c["stamps"], c["max_pos"]) == (4, 7, 6, 2)
    pos = np.array([[0, 1, 0, 1, 2, 0]])  # segments of 2 and 3 tokens, one pad
    p = attention.describe(np.array([5]), 6, pos)
    assert (p["rows"], p["pairs"], p["max_pos"]) == (5, 1 + 2 + 1 + 2 + 3, 2)
    h, d = 2, 4
    want = least_s(4 * (4 * h * 3 * d + 6 + (2 + 2 + 1 + 9) + 2 * 4 * h * d), 7 * h * 2 * 2 * d)
    assert attention.forward_s([c], h, d, d, 9) == pytest.approx(want)
    bwd = least_s(4 * (4 * h * 4 * d + 6 + 14 + 2 * 4 * h * 3 * d + 7 + 9), 7 * h * 2 * 5 * d)
    assert attention.backward_s([c], h, d, d, 9, 7) == pytest.approx(bwd)


def test_adamw_and_lse():
    assert adamw.step_s(1000) == pytest.approx(28000 / B)
    # every one of X = 1 rows drawn: one live logit a row, less the positive's share 0
    assert lse.live_logits(10, 1, 3) == 0.0
    assert lse.live_logits(10, 2, 1) == pytest.approx(10 * 2 * 0.5 * 0.5)
    bt, x, r, d = 8, 100, 4, 16
    nnz = bt * x * (1 - (1 - 1 / x) ** r) * (1 - 1 / x)
    want = (least_s(4 * (bt * r + bt) + bt * x)
            + least_s(4 * (bt * d + x * d + 3 * bt) + bt * x, nnz * 2 * d)
            + least_s(4 * (2 * bt * d + 2 * x * d + 3 * bt) + bt * x, nnz * 6 * d))
    assert lse.step_s(bt, x, r, d) == pytest.approx(want)


def _dims(**kw):
    base = dict(d=8, heads=2, dqk=4, dv=4, blocks=3, max_len=12, max_history=10, max_out=2,
                num_buckets=8, eps=1e-6, dropout=0.0, linear_dropout=0.0, temperature=0.05,
                num_negatives=5, l2_eps=1e-6)
    base.update(kw)
    return Dims(**base)


def test_train_step():
    dims = _dims()
    s = {"attn": {"pairs": 10, "b": 1, "rows": 4}, "tokens": 4, "supervised": 3}
    mm = 2 * 4 * 8 * 2 * 2 * 8 + 2 * 4 * 2 * 4 * 8
    # a pair and head: q.k and p.v forward (2 x 8), then dp, dv, dq, dk (2 x 16)
    flops = 3 * (3 * mm + 10 * 2 * 2 * 8 + 10 * 2 * 2 * 16) + 3 * 2 * 3 * 8 * 6
    nbytes = 28 * 50 + 4 * 8 * (4 + 3 * 5)
    assert step.train_step_s(s, dims, 50) == pytest.approx(max(flops / F, nbytes / B))


def test_readers_read_or_return_nothing():
    """Every per-layer reader gives a value from a context that has what it
    reads, and nothing (never 0) from one that has not."""
    import json
    import os

    from gpubench import bench

    from gpubench.tests import tiny

    root = tiny.REPO
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    dims = _dims()
    attn = attention.describe(np.array([3, 1]), 4)
    work = {"attn": attn, "tokens": attn["rows"], "supervised": 3, "drawn_rows": 6}
    summary = {"window_s": 2.0, "busy_s": 1.5, "kernel_s": {
        "hstu_attention_fwd_kernel<2>": 1e-3, "hstu_attention_bwd_kernel<2>": 2e-3,
        "count_offsets_kernel": 1e-3, "dense_neg_lse_fwd_kernel": 1e-3,
        "multi_tensor_apply_kernel<FusedAdamMathFunctor>": 1e-3}}
    full = {"summary": summary, "dims": dims, "steps": [work], "window_steps": [work],
            "window_s": 1.0, "params": 50, "catalog_size": 100, "peak_bytes": 2 ** 30}
    for m in spec["per_layer"]:
        read = bench.reader(m["name"], root)
        value = read(full)
        assert value is not None and value > 0, m["name"]
        if m["unit"] == "%" and "idle" not in m["name"]:
            assert value <= 100.0, (m["name"], value)
        assert read({"dims": dims}) is None, m["name"]
