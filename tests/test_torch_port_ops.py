"""The PyTorch port's attention, sequence and top-k ops against the JAX
package's, on the CPU, from the same numpy inputs.

The fused attention is held to the JAX `hstu_attention_fused` run in Pallas
interpret mode (as tests/test_pallas_hstu.py runs it), at that file's
tolerance: rtol 2e-4 / atol 2e-5, for fp32 sums taken in another order.
Integer and gather ops must agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mygenerativerecommenders_tpu.ops import hstu_attention as jax_attn
from mygenerativerecommenders_tpu.ops import sequence as jax_seq
from mygenerativerecommenders_tpu.ops import topk as jax_topk
from mygenerativerecommenders_tpu.ops.pallas.hstu_attention import (
    hstu_attention_fused as jax_fused,
)
from mygenerativerecommenders_tpu_torch.ops import hstu_attention as pt_attn
from mygenerativerecommenders_tpu_torch.ops import sequence as pt_seq
from mygenerativerecommenders_tpu_torch.ops import topk as pt_topk
from mygenerativerecommenders_tpu_torch.ops.kernels import hstu_attention as pt_kernel
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL, ATOL = 2e-4, 2e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _attn_inputs(seed, b, n, h, dqk, dv, max_len):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, n, h, dqk)).astype(np.float32)
    k = rng.normal(size=(b, n, h, dqk)).astype(np.float32)
    v = rng.normal(size=(b, n, h, dv)).astype(np.float32)
    # ml-1m-era unix timestamps: deltas span seconds to years
    ts = np.sort(978_000_000 + rng.integers(0, 3 * 365 * 86400, size=(b, n)), axis=1)
    pos_w = (rng.normal(size=(2 * max_len - 1,)) * 0.02).astype(np.float32)
    ts_w = (rng.normal(size=(129,)) * 0.02).astype(np.float32)
    return q, k, v, ts.astype(np.int32), pos_w, ts_w


def test_bucketize_timedelta_matches_exactly():
    # integers on both sides of every bucket boundary exp(0.301 * j)
    edges = np.exp(0.301 * np.arange(0, 72))
    near = np.concatenate([np.floor(edges) + d for d in (-1, 0, 1, 2)])
    near = near[(near > -2**31) & (near < 2**31)].astype(np.int64)
    extra = np.array([0, 1, -1, 2, -2**31, 2**31 - 1, -(2**31 - 1)], dtype=np.int64)
    delta = np.concatenate([near, -near, extra]).astype(np.int32)
    want = np.asarray(jax_attn.bucketize_timedelta(jnp.asarray(delta), 128))
    got = pt_attn.bucketize_timedelta(_t(delta), 128).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,max_len", [(9, 9), (7, 12)])
def test_relative_biases_match_exactly(n, max_len):
    _, _, _, ts, pos_w, ts_w = _attn_inputs(1, 3, n, 1, 4, 4, max_len)
    want = np.asarray(jax_attn.relative_position_bias(jnp.asarray(pos_w), n, max_len))
    got = pt_attn.relative_position_bias(_t(pos_w), n, max_len).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jax_attn.relative_time_bias(jnp.asarray(ts_w), jnp.asarray(ts), 128))
    got = pt_attn.relative_time_bias(_t(ts_w), _t(ts), 128).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,packed", [(1, False), (2, False), (2, True)])
def test_attention_reference_matches_jax(h, packed):
    b, n = 2, 24
    q, k, v, ts, pos_w, ts_w = _attn_inputs(2, b, n, h, 8, 6, n)
    seg = None
    if packed:  # two segments per row, split at different points
        seg = (np.arange(n)[None, :] >= np.array([[10], [17]])).astype(np.int32)
    bias_j = jax_attn.relative_position_bias(jnp.asarray(pos_w), n)[None]
    bias_j = bias_j + jax_attn.relative_time_bias(jnp.asarray(ts_w), jnp.asarray(ts), 128)
    want = jax_attn.hstu_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias_j, max_len=n,
        seg_ids=None if seg is None else jnp.asarray(seg),
    )
    bias_t = pt_attn.relative_position_bias(_t(pos_w), n)[None]
    bias_t = bias_t + pt_attn.relative_time_bias(_t(ts_w), _t(ts), 128)
    got = pt_attn.hstu_attention_reference(
        _t(q), _t(k), _t(v), bias_t, max_len=n, seg_ids=None if seg is None else _t(seg)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "b,n,h,dqk,dv,max_len",
    [(3, 37, 1, 9, 11, 37), (2, 64, 2, 16, 16, 64), (2, 40, 1, 8, 8, 53)],
)
def test_fused_attention_matches_jax_interpret(b, n, h, dqk, dv, max_len):
    q, k, v, ts, pos_w, ts_w = _attn_inputs(3, b, n, h, dqk, dv, max_len)
    lengths = np.linspace(1, n, b).astype(np.int32)  # ragged, includes 1 and n
    with pltpu.force_tpu_interpret_mode():
        want = jax_fused(
            *map(jnp.asarray, (q, k, v, ts, pos_w, ts_w)), max_len, 128,
            lengths=jnp.asarray(lengths),
        )
    got = pt_kernel.hstu_attention_fused(
        *map(_t, (q, k, v, ts, pos_w, ts_w)), max_len, 128, lengths=_t(lengths)
    )
    assert got.shape == (b, n, h, dv) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # the fused contract: rows at or past the length are exactly zero
    for i, length in enumerate(lengths):
        assert not got[i, length:].any()


def test_fused_attention_plain_path_launches_nothing_and_rejects_bad_input():
    q, k, v, ts, pos_w, ts_w = map(_t, _attn_inputs(4, 2, 8, 1, 4, 4, 8))
    before = pt_kernel.launches
    pt_kernel.hstu_attention_fused(q, k, v, ts, pos_w, ts_w, 8, 128)
    assert pt_kernel.launches == before  # CPU tensors take the plain version
    with pytest.raises(ValueError, match="seg_positions"):  # packed rows: [B, N] positions
        pt_kernel.hstu_attention_fused(
            q, k, v, ts, pos_w, ts_w, 8, 128, seg_positions=torch.zeros(2, 7)
        )
    with pytest.raises(ValueError, match="max_len"):
        pt_kernel.hstu_attention_fused(q, k, v, ts, pos_w[:9], ts_w, 5, 128)
    with pytest.raises(ValueError, match="pos_w"):
        pt_kernel.hstu_attention_fused(q, k, v, ts, pos_w[:9], ts_w, 8, 128)


def test_sequence_ops_match_exactly():
    rng = np.random.default_rng(5)
    lengths = np.array([1, 4, 7, 3], dtype=np.int32)
    enc = rng.normal(size=(4, 7, 5)).astype(np.float32)
    seq = rng.integers(1, 50, size=(4, 8)).astype(np.int32)
    vals = rng.integers(100, 200, size=4).astype(np.int32)
    np.testing.assert_array_equal(
        pt_seq.lengths_to_mask(_t(lengths), 7).numpy(),
        np.asarray(jax_seq.lengths_to_mask(jnp.asarray(lengths), 7)),
    )
    np.testing.assert_array_equal(
        pt_seq.get_current_embeddings(_t(lengths), _t(enc)).numpy(),
        np.asarray(jax_seq.get_current_embeddings(jnp.asarray(lengths), jnp.asarray(enc))),
    )
    np.testing.assert_array_equal(
        pt_seq.scatter_at_lengths(_t(seq), _t(lengths), _t(vals)).numpy(),
        np.asarray(jax_seq.scatter_at_lengths(
            jnp.asarray(seq), jnp.asarray(lengths), jnp.asarray(vals)
        )),
    )


@pytest.mark.parametrize("filter_past", [False, True])
def test_mips_top_k_matches_jax(filter_past):
    rng = np.random.default_rng(6)
    max_id, x, d, k = 90, 70, 12, 20
    item_ids = np.sort(rng.choice(np.arange(1, max_id + 1), size=x, replace=False))
    items = rng.normal(size=(x, d)).astype(np.float32)
    queries = rng.normal(size=(5, d)).astype(np.float32)
    past = rng.integers(0, max_id + 1, size=(5, 15)).astype(np.int32)
    invalid = past if filter_past else None
    want_ids, want_scores = jax_topk.mips_top_k(
        jnp.asarray(queries), jnp.asarray(items), jnp.asarray(item_ids.astype(np.int32)),
        k=k, invalid_ids=None if invalid is None else jnp.asarray(invalid), max_item_id=max_id,
    )
    got_ids, got_scores = pt_topk.mips_top_k(
        _t(queries), _t(items), _t(item_ids), k=k,
        invalid_ids=None if invalid is None else _t(invalid), max_item_id=max_id,
    )
    # fp32 dot products of 12 terms summed in another order
    problem = pt_topk.topk_agree(
        got_ids.numpy(), got_scores.numpy(), np.asarray(want_ids), np.asarray(want_scores),
        atol=1e-5,
    )
    assert problem is None, problem
    if filter_past:
        for row, hist in zip(got_ids.numpy(), past):
            assert not set(row.tolist()) & set(hist.tolist()) - {0}


def test_topk_agree_flags_a_real_difference_but_not_a_tie():
    ids = [[5, 6, 7]]
    assert pt_topk.topk_agree(ids, [[0.9, 0.5, 0.1]], [[5, 6, 7]], [[0.9, 0.5, 0.1]], 1e-5) is None
    # 6 and 7 tie: swapping them is no disagreement
    assert pt_topk.topk_agree(
        [[5, 6, 7, 8]], [[0.9, 0.5, 0.5, 0.1]], [[5, 7, 6, 8]], [[0.9, 0.5, 0.5, 0.1]], 1e-5
    ) is None
    assert "not a near-tie" in pt_topk.topk_agree(
        ids, [[0.9, 0.5, 0.1]], [[6, 5, 7]], [[0.9, 0.5, 0.1]], 1e-5
    )
    assert "score" in pt_topk.topk_agree(ids, [[0.9, 0.5, 0.1]], ids, [[0.9, 0.4, 0.1]], 1e-5)
