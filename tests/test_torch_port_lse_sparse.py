"""The lse backward in its sparse form (`dense_neg_lse_bwd_plain`: the live
(i, x) pairs only, cat gathered at them, `index_add_` into dq and dcat), on
the CPU, against autograd of the dense plain version and against the JAX
package's gradients from the same numpy inputs: `sampled_softmax_dense_neg_lse`
with `use_pallas=True` and `fused_dense_neg_lse` (with `sup_off`), their
Pallas kernels in interpret mode.

It is the function the sparse CUDA backward computes (csrc/dense_neg_lse.cu),
given the forward's per-row (m_safe, s). Tolerances: dq at rtol 2e-4 / atol
2e-5 and dcat at rtol 5e-4 / atol 2e-5 (float32 sums in another order; dcat
sums a catalog row's terms over every row of q).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mygenerativerecommenders_tpu.ops.dense_negatives import (
    sampled_softmax_dense_neg_lse as jax_dense_neg_lse,
)
from mygenerativerecommenders_tpu.ops.pallas import dense_softmax as jax_dense_softmax
from mygenerativerecommenders_tpu_torch.ops.kernels import count_offsets as count_mod
from mygenerativerecommenders_tpu_torch.ops.kernels import dense_neg_lse as lse_mod

TAU = 0.05
DQ_TOL = dict(rtol=2e-4, atol=2e-5)
DCAT_TOL = dict(rtol=5e-4, atol=2e-5)


def _draws(seed, bt, d, x, r):
    """Unit queries and catalog, R draws a row and the positives: row 0 draws
    only its positive (all hits: s == 0), row 1 draws one item R times, row 2
    has no positive in the catalog, row 3 draws its positive half the time."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(bt, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    cat = rng.normal(size=(x, d)).astype(np.float32)
    cat /= np.linalg.norm(cat, axis=-1, keepdims=True)
    offs = rng.integers(0, x, size=(bt, r)).astype(np.int32)
    sup = rng.integers(0, x, size=bt).astype(np.int32)
    sup[0], offs[0] = 5, 5
    sup[1], offs[1] = 9, 3
    sup[2] = -1
    offs[3, : r // 2] = sup[3]
    gl = rng.normal(size=(bt,)).astype(np.float32)
    return q, cat, offs, sup, gl


def _sparse(q, cat, count, gl, sup_off=None, stats_count=None):
    tq, tcat = torch.tensor(q), torch.tensor(cat)
    m_safe, s = lse_mod.dense_neg_lse_stats_plain(
        tq, tcat, count if stats_count is None else stats_count, TAU)
    return lse_mod.dense_neg_lse_bwd_plain(tq, tcat, count, m_safe, s, torch.tensor(gl), TAU,
                                           sup_off)


@pytest.mark.parametrize(
    "bt,d,x,r",
    [(40, 50, 300, 128), (40, 64, 300, 128), (24, 16, 48, 300), (24, 16, 48, 255)],
    ids=["d50", "d64", "int32-bin-above-255", "every-column-live"],
)
def test_sparse_backward_matches_autograd_of_the_dense_plain_version(bt, d, x, r):
    q, cat, offs, sup, gl = _draws(bt + d + r, bt, d, x, r)
    if r == 255:  # dense rows: 255 draws into 48 columns leave none out
        offs[4:] = np.arange(bt * r).reshape(bt, r)[4:] % x
        sup[4:] = -1
    count = count_mod.count_offsets(torch.tensor(offs), torch.tensor(sup), x)
    assert count.dtype == (torch.uint8 if r <= 255 else torch.int32)
    assert not count[0].any() and int(count[1, 3]) == r
    if r == 255:
        assert bool((count[4:] > 0).all())
    tq, tcat = torch.tensor(q, requires_grad=True), torch.tensor(cat, requires_grad=True)
    lse = lse_mod.dense_neg_lse_plain(tq, tcat, count, TAU)
    loss = (torch.where(torch.isfinite(lse), lse, 0.0) * torch.tensor(gl)).sum()
    want = torch.autograd.grad(loss, [tq, tcat])
    dq, dcat = _sparse(q, cat, count, gl)
    assert not dq[0].any()  # the all-hit row: s == 0
    np.testing.assert_allclose(dq.numpy(), want[0].numpy(), **DQ_TOL)
    np.testing.assert_allclose(dcat.numpy(), want[1].numpy(), **DCAT_TOL)


@pytest.mark.parametrize("d,r", [(50, 128), (64, 256)], ids=["d50-uint8", "d64-int32"])
def test_sparse_backward_matches_the_jax_pallas_gradients(d, r):
    bt, x = 32, 200
    q, cat, offs, sup, gl = _draws(d + r, bt, d, x, r)

    def jax_f(q_, cat_):
        lse = jax_dense_neg_lse(q_, cat_, jnp.asarray(offs), jnp.asarray(sup), TAU,
                                use_pallas=True)
        return (jnp.where(jnp.isfinite(lse), lse, 0.0) * gl).sum()

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jax_f, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(cat))
    count = count_mod.count_offsets(torch.tensor(offs), torch.tensor(sup), x)
    dq, dcat = _sparse(q, cat, count, gl)
    assert not dq[0].any()
    np.testing.assert_allclose(dq.numpy(), np.asarray(want[0]), **DQ_TOL)
    np.testing.assert_allclose(dcat.numpy(), np.asarray(want[1]), **DCAT_TOL)


@pytest.mark.parametrize("xb,x,padded", [(4096, 300, True), (256, 600, False)],
                         ids=["one-x-block-padded", "five-x-blocks"])
def test_sparse_backward_with_sup_off_matches_the_jax_fused_kernels(monkeypatch, xb, x, padded):
    """sup_off masks each row's positive inside the backward; the count's rows
    may be padded to the catalog rounded up to 128, as the JAX counts are."""
    bt, d = 40, 64
    q, cat, offs, sup, gl = _draws(x, bt, d, x, 24)
    sup[5] = -1
    width = -(-x // 128) * 128 if padded else x
    count = np.zeros((bt, width), dtype=np.uint8)
    for i in range(bt):
        np.add.at(count[i], offs[i], 1)  # positives included: sup_off takes them out
    count[0] = 0
    count[0, sup[0]] = 3  # an all-hit row
    monkeypatch.setattr(jax_dense_softmax, "_XB", xb)

    def jax_f(q_, cat_):
        lse = jax_dense_softmax.fused_dense_neg_lse(
            q_, cat_, jnp.asarray(count), jnp.asarray(sup), TAU)
        return (jnp.where(jnp.isfinite(lse), lse, 0.0) * gl).sum()

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jax_f, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(cat))
    masked = torch.tensor(count[:, :x])
    hit = sup >= 0
    masked[np.flatnonzero(hit), sup[hit]] = 0
    dq, dcat = _sparse(q, cat, torch.tensor(count), gl, torch.tensor(sup), masked)
    assert not dq[0].any()
    np.testing.assert_allclose(dq.numpy(), np.asarray(want[0]), **DQ_TOL)
    np.testing.assert_allclose(dcat.numpy(), np.asarray(want[1]), **DCAT_TOL)


def test_dcat_accuracy_tool_holds_the_plain_versions_to_the_float64_sum():
    """tools/lse_dcat_accuracy.py on the CPU, where the wrapper's "kernel" is
    autograd of the plain version: every float32 dcat lies well inside rtol
    2e-4 / atol 2e-5 of the float64 sum at a small dense size, and the plain
    version gives the same bits in every call."""
    from mygenerativerecommenders_tpu_torch.tools.lse_dcat_accuracy import measure

    r = measure(bt=300, d=16, x=40, draws=60, calls=2, tau=TAU, device="cpu")
    assert r["same_bits"] and r["past_edge"] == 0
    for key in ("kernel_exact", "kernel_autograd", "kernel_sparse", "autograd_exact",
                "sparse_exact"):
        assert 0 <= r[key] < 0.5, (key, r[key])
