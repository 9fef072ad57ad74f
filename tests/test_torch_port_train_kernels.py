"""The training kernels' wrappers of the PyTorch port against the JAX package,
on the CPU, from the same numpy inputs.

On the CPU each wrapper computes its kernel's plain PyTorch version, and
autograd differentiates it; the JAX functions run their Pallas kernels in
interpret mode (`pltpu.force_tpu_interpret_mode()`), as the JAX package's own
tests do (tests/test_pallas_hstu.py, tests/test_dense_negatives.py).

Tolerances are those tests': attention outputs and dq/dk/dv at rtol 2e-4 /
atol 2e-5, the bias tables' gradients at rtol 5e-4 (they sum ~n^2 float32
terms in another order); the negative lse at rtol 1e-5 and its gradients at
rtol 1e-4 / atol 1e-6; counts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mygenerativerecommenders_tpu.models.losses import sampled_softmax_loss as jax_ssl
from mygenerativerecommenders_tpu.ops.dense_negatives import count_offsets as jax_count_offsets
from mygenerativerecommenders_tpu.ops.dense_negatives import (
    sampled_softmax_dense_neg_lse as jax_dense_neg_lse,
)
from mygenerativerecommenders_tpu.ops.pallas.hstu_attention import (
    hstu_attention_fused as jax_fused,
)
from mygenerativerecommenders_tpu_torch.models.losses import _weighted_mean, sampled_softmax_loss
from mygenerativerecommenders_tpu_torch.ops.dense_negatives import (
    sampled_softmax_dense_neg_lse,
)
from mygenerativerecommenders_tpu_torch.ops.kernels import count_offsets as count_mod
from mygenerativerecommenders_tpu_torch.ops.kernels import dense_neg_lse as lse_mod
from mygenerativerecommenders_tpu_torch.ops.kernels.hstu_attention import hstu_attention_fused
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _attention_inputs(seed, b, n, h, dqk, dv):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, n, h, dqk)).astype(np.float32)
    k = rng.normal(size=(b, n, h, dqk)).astype(np.float32)
    v = rng.normal(size=(b, n, h, dv)).astype(np.float32)
    ts = np.sort(978_000_000 + rng.integers(0, 10**7, size=(b, n)), axis=1).astype(np.int32)
    pos_w = (rng.normal(size=(2 * n - 1,)) * 0.02).astype(np.float32)
    ts_w = (rng.normal(size=(129,)) * 0.02).astype(np.float32)
    g = rng.normal(size=(b, n, h, dv)).astype(np.float32)
    return q, k, v, ts, pos_w, ts_w, g


@pytest.mark.parametrize(
    "b,n,h,dqk,dv,lengths",
    [
        (2, 37, 1, 9, 11, None),  # no lengths: every row attends
        (3, 40, 1, 16, 16, [40, 13, 1]),  # ragged, one row of length 1
        (2, 64, 2, 8, 6, [33, 64]),  # two heads, dqk != dv
    ],
)
def test_attention_gradients_match_jax_fused_kernel(b, n, h, dqk, dv, lengths):
    q, k, v, ts, pos_w, ts_w, g = _attention_inputs(n, b, n, h, dqk, dv)
    lens = None if lengths is None else np.asarray(lengths, dtype=np.int32)

    def jax_loss(q_, k_, v_, pw_, tw_):
        out = jax_fused(
            q_, k_, v_, jnp.asarray(ts), pw_, tw_, n, 128,
            lengths=None if lens is None else jnp.asarray(lens),
        )
        return (out * g).sum(), out

    with pltpu.force_tpu_interpret_mode():
        (_, want_out), want = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            *map(jnp.asarray, (q, k, v, pos_w, ts_w))
        )

    args = [torch.tensor(a, requires_grad=True) for a in (q, k, v, pos_w, ts_w)]
    tq, tk, tv, tpw, ttw = args
    out = hstu_attention_fused(
        tq, tk, tv, torch.tensor(ts), tpw, ttw, n, 128,
        lengths=None if lens is None else torch.tensor(lens),
    )
    got = torch.autograd.grad((out * torch.tensor(g)).sum(), args)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=2e-4, atol=2e-5)
    for i, (a, w) in enumerate(zip(got, want)):
        rtol = 5e-4 if i >= 3 else 2e-4
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=rtol, atol=2e-5)
    if lens is not None:  # rows at or past the length get exactly zero
        for i, length in enumerate(lens):
            for a in got[:3]:
                assert not a[i, length:].any()


def test_attention_plain_takes_strided_column_slices_and_backpropagates_into_them():
    # q, k, v arrive as column slices of one projection; their gradients flow
    # back into slices of one gradient tensor
    b, n, h, d = 2, 19, 1, 8
    rng = np.random.default_rng(0)
    proj = torch.tensor(rng.normal(size=(b, n, 4 * d)), dtype=torch.float32, requires_grad=True)
    ts = torch.tensor(np.sort(rng.integers(1000, 10**6, size=(b, n)), axis=1), dtype=torch.int32)
    pw = torch.tensor(rng.normal(size=(2 * n - 1,)) * 0.02, dtype=torch.float32)
    tw = torch.tensor(rng.normal(size=(129,)) * 0.02, dtype=torch.float32)
    _, v, q, k = torch.split(proj, [d] * 4, dim=-1)
    out = hstu_attention_fused(
        q.unflatten(-1, (h, d)), k.unflatten(-1, (h, d)), v.unflatten(-1, (h, d)),
        ts, pw, tw, n, 128, lengths=torch.tensor([n, 5]),
    )
    (grad,) = torch.autograd.grad(out.square().sum(), proj)
    assert not grad[..., :d].any()  # u takes no part in the attention
    assert grad[0, :, d:].abs().sum() > 0
    assert not grad[1, 5:].any()


def _count_reference(offsets, positive, x):
    want = np.zeros((offsets.shape[0], x), dtype=np.int64)
    for i, row in enumerate(offsets):
        for o in row:
            if 0 <= o < x and o != positive[i]:
                want[i, o] += 1
    return want


@pytest.mark.parametrize("x,r,sentinels", [(200, 16, False), (333, 64, True), (40, 255, False)])
def test_counts_match_jax_count_with_hit_mask(x, r, sentinels):
    rng = np.random.default_rng(x)
    bt = 50
    offsets = rng.integers(0, x, size=(bt, r)).astype(np.int32)
    positive = np.where(rng.random(bt) < 0.2, -1, rng.integers(0, x, size=bt)).astype(np.int32)
    offsets[0, :] = max(positive[0], 0)  # an all-hit row (if the row has a positive)
    offsets[1, :5] = positive[1] if positive[1] >= 0 else 3
    # the JAX package: count every draw, then zero the positive's column
    count = np.asarray(jax_count_offsets(jnp.asarray(offsets), x), dtype=np.int64)
    want = count * (np.arange(x)[None, :] != positive[:, None])
    if sentinels:  # padding rows carry offsets past the catalog: no JAX count for them
        offsets[-7:, r // 2 :] = x + 11
        offsets[-3:, 0] = -1
        want = _count_reference(offsets, positive, x)
    else:
        np.testing.assert_array_equal(want, _count_reference(offsets, positive, x))
    got = count_mod.count_offsets(torch.tensor(offsets), torch.tensor(positive), x)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (bt, x)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


def test_counts_refuse_more_draws_than_a_byte_holds():
    # 256 draws of one offset: a bin of 256 does not fit a byte, so the count
    # comes out int32 (the JAX package keeps bf16 counts there, exact to 256)
    got = count_mod.count_offsets(
        torch.full((2, 256), 3, dtype=torch.int32), torch.tensor([-1, 3], dtype=torch.int32), 10
    )
    assert got.dtype == torch.int32
    assert got[0, 3] == 256 and int(got[0].sum()) == 256 and not got[1].any()


def _lse_inputs(seed, bt, d, x, r, normalize=True):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(bt, d)).astype(np.float32)
    cat = rng.normal(size=(x, d)).astype(np.float32)
    if normalize:
        cat /= np.linalg.norm(cat, axis=-1, keepdims=True)
    offs = rng.integers(0, x, size=(bt, r)).astype(np.int32)
    sup = np.where(rng.random(bt) < 0.2, -1, rng.integers(0, x, size=bt)).astype(np.int32)
    sup[0], sup[1] = 7, -1  # row 0 all hits; row 1's positive is outside the catalog
    offs[0, :] = 7
    offs[2, :3] = sup[2] if sup[2] >= 0 else 5
    return q, cat, offs, sup


@pytest.mark.parametrize("bt,d,x,r,tau", [(70, 12, 150, 16, 0.07), (33, 16, 200, 16, 0.05)])
def test_dense_neg_lse_value_and_gradients_match_jax_pallas(bt, d, x, r, tau):
    q, cat, offs, sup = _lse_inputs(bt, bt, d, x, r)
    gl = np.random.default_rng(1).normal(size=(bt,)).astype(np.float32)

    def jax_f(q_, cat_):
        lse = jax_dense_neg_lse(q_, cat_, jnp.asarray(offs), jnp.asarray(sup), tau, use_pallas=True)
        return (jnp.where(jnp.isfinite(lse), lse, 0.0) * gl).sum(), lse

    with pltpu.force_tpu_interpret_mode():
        (_, want_lse), want = jax.value_and_grad(jax_f, argnums=(0, 1), has_aux=True)(
            jnp.asarray(q), jnp.asarray(cat)
        )
    want_lse = np.asarray(want_lse)

    tq, tcat = torch.tensor(q, requires_grad=True), torch.tensor(cat, requires_grad=True)
    lse = sampled_softmax_dense_neg_lse(tq, tcat, torch.tensor(offs), torch.tensor(sup), tau)
    loss = (torch.where(torch.isfinite(lse), lse, 0.0) * torch.tensor(gl)).sum()
    got = torch.autograd.grad(loss, [tq, tcat])
    assert lse[0] == -torch.inf and want_lse[0] == -np.inf
    assert np.isfinite(want_lse[1:]).all()
    np.testing.assert_allclose(lse.detach().numpy(), want_lse, rtol=1e-5)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)


def test_dense_neg_lse_takes_leading_dims_and_matches_per_sample_loss():
    # [B, T] layout, against the per-sample sampled softmax of both packages
    b, t, d, x, r, tau = 3, 11, 16, 200, 16, 0.05
    q, cat, offs, sup = _lse_inputs(5, b * t, d, x, r)
    pos = np.random.default_rng(2).normal(size=(b, t)).astype(np.float32)
    w = (np.random.default_rng(3).random((b, t)) < 0.8).astype(np.float32)
    q3, offs3, sup2 = q.reshape(b, t, d), offs.reshape(b, t, r), sup.reshape(b, t)

    neg_logits = np.einsum("btd,btrd->btr", q3, cat[offs3]) / tau
    hits = offs3 == sup2[..., None]
    want = float(jax_ssl(jnp.asarray(pos), jnp.asarray(neg_logits), jnp.asarray(hits), jnp.asarray(w)))

    tq = torch.tensor(q3, requires_grad=True)
    tcat = torch.tensor(cat, requires_grad=True)
    lse = sampled_softmax_dense_neg_lse(tq, tcat, torch.tensor(offs3), torch.tensor(sup2), tau)
    assert tuple(lse.shape) == (b, t) and lse[0, 0] == -torch.inf
    tpos = torch.tensor(pos)
    dense = _weighted_mean(torch.logaddexp(tpos, lse) - tpos, torch.tensor(w))
    g_dense = torch.autograd.grad(dense, [tq, tcat])

    tneg = torch.einsum("btd,btrd->btr", tq, tcat[torch.tensor(offs3).long()]) / tau
    per_sample = sampled_softmax_loss(tpos, tneg, torch.tensor(hits), torch.tensor(w))
    g_sample = torch.autograd.grad(per_sample, [tq, tcat])
    np.testing.assert_allclose(dense.item(), want, rtol=1e-5)
    np.testing.assert_allclose(per_sample.item(), want, rtol=1e-5)
    for a, s in zip(g_dense, g_sample):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), s.numpy(), rtol=2e-4, atol=2e-6)


def test_all_hit_row_gives_finite_loss_and_zero_gradient_into_the_row():
    q, cat, offs, sup = _lse_inputs(9, 4, 8, 40, 6, normalize=False)
    tq = torch.tensor(q, requires_grad=True)
    lse = sampled_softmax_dense_neg_lse(tq, torch.tensor(cat), torch.tensor(offs), torch.tensor(sup), 0.05)
    pos = torch.ones(4)
    loss = (torch.logaddexp(pos, lse) - pos).sum()
    (grad,) = torch.autograd.grad(loss, tq)
    assert lse[0] == -torch.inf and torch.isfinite(lse[1:]).all()
    assert torch.isfinite(loss) and torch.isfinite(grad).all()
    assert not grad[0].any()


def test_dead_logit_above_the_live_maximum_does_not_overflow():
    # unnormalized embeddings: a column with count 0 whose logit would overflow exp
    q = torch.tensor([[100.0, 0.0]], requires_grad=True)
    cat = torch.tensor([[100.0, 0.0], [0.01, 0.0], [0.02, 0.0]])
    count = torch.tensor([[0, 1, 2]], dtype=torch.uint8)
    lse = lse_mod.dense_neg_lse(q, cat, count, 0.05)
    want = np.log(np.exp(20.0) + 2 * np.exp(40.0))
    np.testing.assert_allclose(lse.item(), want, rtol=1e-6)
    (grad,) = torch.autograd.grad(lse.sum(), q)
    assert torch.isfinite(grad).all()


@pytest.mark.parametrize(
    "call",
    [
        lambda: lse_mod.dense_neg_lse(torch.zeros(2, 3), torch.zeros(4, 3), torch.zeros(2, 4), 0.05),
        lambda: lse_mod.dense_neg_lse(
            torch.zeros(2, 3), torch.zeros(4, 5), torch.zeros(2, 4, dtype=torch.uint8), 0.05
        ),
        lambda: count_mod.count_offsets(torch.zeros(2, 3, dtype=torch.int32), torch.zeros(3), 5),
    ],
)
def test_wrappers_refuse_shapes_and_types_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()


def test_lse_backward_breakdown_tool_still_finds_its_patterns_in_the_source():
    from mygenerativerecommenders_tpu_torch.ops.kernels import _build
    from mygenerativerecommenders_tpu_torch.tools.lse_bwd_breakdown import variants

    made = variants((_build.CSRC_DIR / "dense_neg_lse.cu").read_text())
    assert set(made) == {"as_is", "scan_only", "no_gather_logits", "no_dq", "no_dcat_atomics"}
    assert len(set(made.values())) == 5


def test_lse_backward_source_adds_atomically_into_dcat_only():
    """The sparse lse backward stores dq once from the warp that owns the row
    (bit-identical from call to call); only dcat (in device memory, or a
    block's partial sum of it in shared memory), which every row reaches,
    takes atomics, and the forward takes none."""
    import re

    from mygenerativerecommenders_tpu_torch.ops.kernels import _build

    src = (_build.CSRC_DIR / "dense_neg_lse.cu").read_text()
    targets = re.findall(r"atomicAdd\(\s*(?:reinterpret_cast<[^>]*>\()?\s*&?\s*([\w.]+)", src)
    assert targets and set(targets) == {"dcat"}, targets
    assert len(targets) == src.count("atomicAdd")


def test_lse_forward_source_walks_the_live_logits_with_the_backward_scan():
    """The lse forward computes the live logits only: no dense product of
    q with staged catalog tiles (the former `logits_4x4` path, its shared
    memory tiles) is left. Both kernels call the one row scan (`scan_row`,
    the count's only 16-byte loads) and form al in the one pair step
    (`RowPairs::logits`), so the forward's al is the backward's."""
    from mygenerativerecommenders_tpu_torch.ops.kernels import _build

    src = (_build.CSRC_DIR / "dense_neg_lse.cu").read_text()
    for gone in ("logits_4x4", "stage_tile", "extern __shared__", "smem_bytes"):
        assert gone not in src, gone
    bwd_at = src.index("// " + "-" * 64 + " backward")
    fwd = src[src.index("dense_neg_lse_fwd_kernel("):bwd_at]
    bwd = src[src.index("dense_neg_lse_bwd_kernel(", bwd_at):]
    for kernel in (fwd, bwd):
        assert "scan_row<kMasked>(" in kernel and "w.step();" in kernel
    assert src.count("void scan_row(") == 1 and src.count("__ldcs(") == 1
    assert src.count("p.logits(jb, xs, cnt, cv, al);") == 2


@pytest.mark.parametrize("source", ["hstu_attention_bwd.cu", "hstu_chunk_bwd.cu"])
def test_attention_backward_source_adds_atomically_into_the_tables_only(source):
    """dq, dk and dv of the attention backward (full-sequence and ring chunk)
    are written once by the block that owns them (bit-identical from call to
    call); only the bias tables' gradients and their shared-memory partials
    take atomics. Both stream their tiles with cp.async."""
    import re

    from mygenerativerecommenders_tpu_torch.ops.kernels import _build

    src = (_build.CSRC_DIR / source).read_text()
    targets = re.findall(r"atomicAdd\(\s*&\s*([\w.]+)", src)
    assert targets and set(targets) <= {"diag_s", "hist_s", "a.dpw", "a.dtw"}, targets
    assert "copy_rows_async" in src


@pytest.mark.parametrize("source", ["hstu_attention_fwd.cu", "hstu_chunk_fwd.cu"])
def test_attention_forward_source_writes_without_atomics(source):
    """The attention forwards (full-sequence and ring chunk) write each output
    row once from the block that owns it (bit-identical from call to call):
    no atomics. Both stream their key tiles with cp.async through the shared
    forward tile step."""
    from mygenerativerecommenders_tpu_torch.ops.kernels import _build

    src = (_build.CSRC_DIR / source).read_text()
    assert "atomicAdd" not in src
    assert "copy_rows_async" in src and "forward_tile" in src
