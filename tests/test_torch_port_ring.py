"""Ring (sequence-parallel) HSTU attention and the 2-D-count lse of the port,
on the CPU, against the JAX package.

- The chunk op (`ops/kernels/hstu_chunk.py`, its plain version here) against
  the JAX chunk kernel in interpret mode and the JAX ring's jnp chunk body, at
  every kind of offset: negative (fully live), 0 (the causal diagonal),
  between 0 and Nq, at or past Nq (dead), and one whose live diagonals fall off
  the position table. Output and all five gradients at rtol 2e-4 / atol 2e-5,
  the bias tables' at rtol 5e-4 (the kernel tests' tolerances,
  tests/test_pallas_hstu.py).
- Both ring layouts against the JAX dense `hstu_attention_reference`.
- The port's model with `encoder.sp_shards=4`, both layouts, against the JAX
  model with `sp_shards=1` and the same weights: the loss at rtol 1e-5 and
  every gradient at rtol 2e-4 / atol 2e-6 (tests/test_torch_port_train_step.py).
- `Trainer.fit` with the ring, with resume; packed rows with the ring raise.
- `fused_dense_neg_lse` against the JAX one in interpret mode, on one and on
  several x-blocks.

No JAX `Mesh` is built here: the JAX package's own tests hold its ring at
sp=4 to sp=1 (tests/test_ring_attention.py), and a mesh left behind by another
test on the same worker would break any test that builds one.
"""

import functools
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mygenerativerecommenders_tpu.configs import resolve as jax_resolve
from mygenerativerecommenders_tpu.configs.presets import get_preset as jax_preset
from mygenerativerecommenders_tpu.models.model import build_model as jax_build_model
from mygenerativerecommenders_tpu.ops.hstu_attention import (
    hstu_attention_reference,
    relative_position_bias,
    relative_time_bias,
)
from mygenerativerecommenders_tpu.ops.pallas import dense_softmax as jax_dense_softmax
from mygenerativerecommenders_tpu.ops.pallas.hstu_chunk import (
    hstu_chunk_attention as jax_chunk_attention,
)
from mygenerativerecommenders_tpu.parallel.ring_attention import _chunk_contribution
from mygenerativerecommenders_tpu.train import task_retrieval as jax_task
from mygenerativerecommenders_tpu.utils.features import seq_features_from_batch as jax_features
from mygenerativerecommenders_tpu_torch.checkpoint import (
    CheckpointManager,
    grads_to_state_dict,
    params_to_state_dict,
)
from mygenerativerecommenders_tpu_torch.cli import train as cli_train
from mygenerativerecommenders_tpu_torch.configs import resolve as pt_resolve
from mygenerativerecommenders_tpu_torch.configs.presets import get_preset as pt_preset
from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
from mygenerativerecommenders_tpu_torch.models.model import build_model as pt_build_model
from mygenerativerecommenders_tpu_torch.ops.kernels import dense_neg_lse as lse_kern
from mygenerativerecommenders_tpu_torch.ops.kernels import hstu_chunk as chunk_kern
from mygenerativerecommenders_tpu_torch.parallel import ring_attention as ring
from mygenerativerecommenders_tpu_torch.train import task_retrieval as pt_task
from mygenerativerecommenders_tpu_torch.train.driver import Trainer
from mygenerativerecommenders_tpu_torch.utils.features import seq_features_from_batch

RTOL, ATOL, TABLE_RTOL = 2e-4, 2e-5, 5e-4
NUM_BUCKETS = 128


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _chunk_inputs(seed, b, nq, nc, h, d, max_len):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, nq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, nc, h, d)).astype(np.float32)
    v = rng.normal(size=(b, nc, h, d)).astype(np.float32)
    stamps = np.sort(rng.integers(10**8, 10**8 + 3 * 10**7, size=(b, nq + nc)), axis=1)
    tsq, tsk = stamps[:, :nq].astype(np.int32), stamps[:, nq:].astype(np.int32)
    pos_w = (rng.normal(size=(2 * max_len - 1,)) * 0.1).astype(np.float32)
    ts_w = (rng.normal(size=(NUM_BUCKETS + 1,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(b, nq, h, d)).astype(np.float32)
    return (q, k, v, tsq, tsk, pos_w, ts_w), g


# off_delta of a 24-row query block against a 40-row chunk (one shape, so the
# JAX kernel compiles once): fully live, the causal diagonal, a partial chunk,
# a dead one, and a fully live chunk whose diagonals reach below the table
# (local m - n + offd + L - 1 < 0 for n > m + 3): the clipped slot
@pytest.mark.parametrize(
    "offd", [-40, 0, 9, 24, -60], ids=["negative", "zero", "partial", "dead", "off-table"]
)
def test_chunk_op_matches_the_jax_chunk_kernel_and_jnp_body(offd):
    nq, nc, max_len = 24, 40, 64
    (q, k, v, tsq, tsk, pos_w, ts_w), g = _chunk_inputs(offd + 100, 2, nq, nc, 2, 8, max_len)
    kw = dict(max_len=max_len, num_buckets=NUM_BUCKETS)

    def jax_kernel(q_, k_, v_, pw_, tw_):
        out = jax_chunk_attention(q_, k_, v_, tsq, tsk, offd, pw_, tw_,
                                  inv_n=1.0 / max_len, interpret=True, **kw)
        return (out * g).sum(), out

    def jax_body(q_, k_, v_, pw_, tw_):
        out = _chunk_contribution(q_, k_, v_, tsq, tsk, 0, offd, pw_, tw_,
                                  max_len, NUM_BUCKETS, use_pallas=False)
        return (out * g).sum(), out

    grad_args = (0, 1, 2, 3, 4)
    wants = [
        jax.value_and_grad(f, argnums=grad_args, has_aux=True)(q, k, v, pos_w, ts_w)
        for f in (jax_kernel, jax_body)
    ]
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v, pos_w, ts_w)]
    out = chunk_kern.hstu_chunk_attention(
        leaves[0], leaves[1], leaves[2], torch.tensor(tsq), torch.tensor(tsk), offd,
        leaves[3], leaves[4], inv_n=1.0 / max_len, **kw,
    )
    got = torch.autograd.grad(out, leaves, torch.tensor(g))
    for (_, want_out), want_grads in wants:
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=RTOL, atol=ATOL)
        for i, (a, w) in enumerate(zip(got, want_grads)):
            rtol = TABLE_RTOL if i >= 3 else RTOL
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=rtol, atol=ATOL, err_msg=str(i))
    if offd >= nq:
        assert not out.any() and not any(x.any() for x in got)
    if offd == -60:  # the off-table case: the first table slot took clipped pairs
        assert float(got[3][0].abs()) > 0


def _ring_inputs(seed, b, n, h, d):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32) for _ in range(3))
    ts = np.sort(rng.integers(10**8, 10**8 + 3 * 10**7, size=(b, n)), axis=1).astype(np.int32)
    pos_w = (rng.normal(size=(2 * n - 1,)) * 0.1).astype(np.float32)
    ts_w = (rng.normal(size=(NUM_BUCKETS + 1,)) * 0.1).astype(np.float32)
    return q, k, v, ts, pos_w, ts_w


@pytest.mark.parametrize("zigzag", [False, True])
def test_ring_layouts_match_the_jax_dense_reference(zigzag):
    b, n, h, d, shards = 3, 32, 2, 8, 4
    q, k, v, ts, pos_w, ts_w = _ring_inputs(5, b, n, h, d)
    bias = relative_position_bias(jnp.asarray(pos_w), n, n)[None] + relative_time_bias(
        jnp.asarray(ts_w), jnp.asarray(ts), NUM_BUCKETS)
    want = hstu_attention_reference(q, k, v, bias, max_len=n, causal=True)
    got = ring.ring_hstu_attention(
        *(torch.tensor(x) for x in (q, k, v, ts, pos_w, ts_w)),
        num_shards=shards, zigzag=zigzag, max_len=n, num_buckets=NUM_BUCKETS,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_zigzag_order_and_its_inverse():
    perm = ring.zigzag_order(4, 16)
    np.testing.assert_array_equal(perm, [0, 1, 14, 15, 2, 3, 12, 13, 4, 5, 10, 11, 6, 7, 8, 9])
    np.testing.assert_array_equal(perm[ring.inverse_permutation(perm)], np.arange(16))


class _CountingRing(ring.OneDeviceRing):
    """Records the (shard, step) -> originating shard rotation the bodies read."""

    def __init__(self, *args):
        super().__init__(*args)
        self.visits = []

    def resident(self, p, t):
        out = super().resident(p, t)
        self.visits.append((p, t, out[0]))
        return out


@pytest.mark.parametrize("zigzag,launches", [(False, 10), (True, 36)])
def test_ring_bodies_rotate_and_skip_dead_chunks(monkeypatch, zigzag, launches):
    """Each shard reads every chunk once, the one from shard (p - t) mod P at
    step t; a block makes 10 chunk calls contiguous (the 6 dead chunks
    skipped) and 16 + 10 + 10 zigzag at P=4."""
    calls = []
    real = ring.hstu_chunk_attention
    monkeypatch.setattr(ring, "hstu_chunk_attention",
                        lambda *a, **kw: calls.append(a[5]) or real(*a, **kw))
    b, n, h, d, shards = 2, 16, 1, 4, 4
    q, k, v, ts, pos_w, ts_w = (torch.tensor(x) for x in _ring_inputs(7, b, n, h, d))
    body = ring.ring_hstu_attention_zigzag_local if zigzag else ring.ring_hstu_attention_local
    rg = _CountingRing(k, v, ts, shards)
    for p in range(shards):
        body(q.chunk(shards, 1)[p], ts.chunk(shards, 1)[p], rg, p, pos_w, ts_w,
             max_len=n, num_buckets=NUM_BUCKETS)
    assert rg.visits == [(p, t, (p - t) % shards) for p in range(shards) for t in range(shards)]
    assert len(calls) == launches
    nq = n // shards // (2 if zigzag else 1)
    assert all(offd < nq for offd in calls)  # no dead chunk reaches the op


@functools.lru_cache(maxsize=1)
def _jax_side():
    """synthetic-smoke (2 blocks, H=2, N=43) in the JAX package at
    sp_shards=1, one train batch, and its encoder output, loss and gradients
    with the negatives the JAX loss draws: the reference of both layouts,
    computed once."""
    jcfg = jax_preset("synthetic-smoke")
    jcfg.model.encoder.use_pallas = "false"
    _small_model(jcfg)
    data = RecoData(pt_preset("synthetic-smoke").data, seed=42)
    jax_resolve(jcfg, data.max_item_id)
    batch = next(iter(data.loader("train")))
    jmodel = jax_build_model(jcfg)
    seq, _, _ = jax_features(batch, jcfg.model.gr_output_length + 1)
    key = jax.random.PRNGKey(0)
    params = jmodel.init({"params": key, "dropout": key}, seq, method=jmodel.init_all)
    enc, _ = jax.jit(lambda p, s: jmodel.apply(p, s, deterministic=True))(params, seq)
    rng = jax.random.fold_in(jax.random.PRNGKey(7), 0)
    jloss = jax_task.make_loss_fn(jmodel, jcfg, data.all_item_ids)
    dev_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(jloss))(params, dev_batch, rng)
    _, neg_rng = jax.random.split(rng)
    n = batch["ids"].shape[1] + jcfg.model.gr_output_length + 1
    shape = (batch["ids"].shape[0], n - 1, jcfg.model.loss.num_to_sample)
    offsets = np.array(jax.random.randint(neg_rng, shape, 0, len(data.all_item_ids)))
    return dict(
        max_item_id=data.max_item_id, item_ids=data.all_item_ids, batch=batch, n=n,
        state_dict=params_to_state_dict(_np_tree(params)), enc=np.asarray(enc),
        loss=float(loss), grads=grads_to_state_dict(_np_tree(grads)), offsets=offsets,
    )


def _small_model(cfg):
    cfg.model.preprocessor.dropout_rate = 0.0
    cfg.model.encoder.linear_dropout_rate = 0.0
    cfg.model.encoder.num_heads = 2
    cfg.model.encoder.attention_dim = cfg.model.encoder.linear_dim = 8


def _model_setup(sp_zigzag):
    """The port's model at sp_shards=4 (N=43 padded to 44 or 48 in the ring)
    with the JAX weights carried in. -> (config, model, the JAX side)."""
    ref = _jax_side()
    pcfg = pt_preset("synthetic-smoke")
    _small_model(pcfg)
    pcfg.model.encoder.sp_shards = 4
    pcfg.model.encoder.sp_zigzag = sp_zigzag
    pt_resolve(pcfg, ref["max_item_id"])
    pmodel = pt_build_model(pcfg, device="cpu")
    pmodel.load_state_dict(ref["state_dict"])
    return pcfg, pmodel, ref


@pytest.mark.parametrize("zigzag", [False, True])
def test_ring_model_loss_and_every_gradient_match_jax_unsharded(zigzag):
    pcfg, pmodel, ref = _model_setup(zigzag)
    assert ref["n"] % (8 if zigzag else 4)  # the ring pads the sequence
    tbatch = {key: torch.from_numpy(val) for key, val in ref["batch"].items()}
    with torch.no_grad():
        pseq, _, _ = seq_features_from_batch(tbatch, pcfg.model.gr_output_length + 1)
        got_enc, _ = pmodel(pseq)
    np.testing.assert_allclose(got_enc.numpy(), ref["enc"], rtol=RTOL, atol=ATOL)

    loss = pt_task.make_loss_fn(pmodel, pcfg, ref["item_ids"])(
        tbatch, neg_offsets=torch.from_numpy(ref["offsets"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    named = dict(pmodel.named_parameters())
    assert named.keys() == ref["grads"].keys()
    for name, p in named.items():
        np.testing.assert_allclose(
            p.grad.numpy(), ref["grads"][name].numpy(), rtol=2e-4, atol=2e-6, err_msg=name
        )


def _fit_args(tmp_path, *extra):
    return [
        "experiment=synthetic-smoke", "trainer.device=cpu", "model.encoder.sp_shards=4",
        "model.encoder.sp_zigzag=true", f"trainer.output_dir={tmp_path / 'out'}", *extra,
    ]


def test_fit_with_the_ring_trains_and_resumes(tmp_path, caplog):
    logger = logging.getLogger("mygenerativerecommenders_tpu_torch.train.driver")
    logger.addHandler(caplog.handler)
    try:
        trainer = Trainer(cli_train.parse_args(_fit_args(tmp_path, "trainer.max_epochs=1")))
        assert not trainer._packed
        layers = trainer.model.sequence_encoder["_hstu"]._attention_layers
        assert all(block.sp_shards == 4 and block.sp_zigzag for block in layers)
        results = trainer.fit()
        path = tmp_path / "out" / "synthetic-smoke" / "metrics.jsonl"
        rows = [json.loads(line) for line in path.read_text().splitlines()]
        losses = [r["train/loss"] for r in rows if "train/loss" in r]
        assert np.isfinite(losses).all() and np.mean(losses[-3:]) < np.mean(losses[:3])
        assert [r["epoch"] for r in rows if "val/ndcg@10" in r] == [0]
        assert all(0.0 <= val <= 1.0 for val in results.values())
        steps = trainer.global_step
        last = tmp_path / "out" / "synthetic-smoke" / "checkpoints" / "last.pt"
        assert CheckpointManager.load(str(last))["step"] == steps
        resumed = Trainer(cli_train.parse_args(
            _fit_args(tmp_path, "trainer.max_epochs=2", f"trainer.ckpt_path={last}")))
        resumed.fit()
        assert f"resumed from {last} at epoch 1, step {steps}" in caplog.text
        assert resumed.global_step > steps
    finally:
        logger.removeHandler(caplog.handler)


def test_packed_rows_with_the_ring_raise(tmp_path):
    with pytest.raises(ValueError, match="sp_shards=1 .packing replaces the ring"):
        Trainer(cli_train.parse_args(_fit_args(tmp_path, "data.pack_sequences=true")))
    # the block itself refuses segment positions with the ring
    pcfg, pmodel, _ = _model_setup(True)
    block = pmodel.sequence_encoder["_hstu"]._attention_layers[0]
    x = torch.zeros((1, 8, pcfg.model.item_embedding_dim))
    ts = torch.arange(8, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="packed rows are not supported with ring"):
        block(x, ts, torch.tensor([8]), torch.arange(8)[None])
    with pytest.raises(ValueError, match="time_position"):
        block(x, None, torch.tensor([8]))


def test_ring_builds_and_tensor_parallel_still_raises():
    cfg = pt_preset("synthetic-smoke")
    cfg.model.encoder.sp_shards = 2
    pt_resolve(cfg, 220)
    assert pt_build_model(cfg, device="cpu") is not None
    cfg.model.encoder.tp_shards = 2
    with pytest.raises(NotImplementedError, match="Distributed"):
        pt_build_model(cfg, device="cpu")


def _lse_inputs(seed, bt, d, x, r, padded):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(bt, d)).astype(np.float32)
    cat = rng.normal(size=(x, d)).astype(np.float32)
    cat /= np.linalg.norm(cat, axis=-1, keepdims=True)
    width = -(-x // 128) * 128 if padded else x
    count = np.zeros((bt, width), dtype=np.uint8)
    sup = np.where(rng.random(bt) < 0.2, -1, rng.integers(0, x, size=bt)).astype(np.int32)
    for i in range(bt):
        np.add.at(count[i], rng.integers(0, x, size=r), 1)
    sup[0] = x - 7
    count[0] = 0
    count[0, x - 7] = 3  # an all-hit row: only its positive is drawn
    count[2, sup[2]] += 4 if sup[2] >= 0 else 0
    gl = rng.normal(size=(bt,)).astype(np.float32)
    return q, cat, count, sup, gl


@pytest.mark.parametrize("xb,x,padded", [(4096, 300, True), (256, 600, False)],
                         ids=["one-x-block", "five-x-blocks"])
def test_fused_dense_neg_lse_matches_jax_kernels(monkeypatch, xb, x, padded):
    bt, d, tau = 40, 12, 0.05
    q, cat, count, sup, gl = _lse_inputs(3, bt, d, x, 24, padded)
    monkeypatch.setattr(jax_dense_softmax, "_XB", xb)

    def jax_f(q_, cat_):
        lse = jax_dense_softmax.fused_dense_neg_lse(
            q_, cat_, jnp.asarray(count), jnp.asarray(sup), tau)
        return (jnp.where(jnp.isfinite(lse), lse, 0.0) * gl).sum(), lse

    with pltpu.force_tpu_interpret_mode():
        (_, want_lse), want = jax.value_and_grad(jax_f, argnums=(0, 1), has_aux=True)(
            jnp.asarray(q), jnp.asarray(cat))
    tq, tcat = torch.tensor(q, requires_grad=True), torch.tensor(cat, requires_grad=True)
    lse = lse_kern.fused_dense_neg_lse(tq, tcat, torch.tensor(count), torch.tensor(sup), tau)
    loss = (torch.where(torch.isfinite(lse), lse, 0.0) * torch.tensor(gl)).sum()
    got = torch.autograd.grad(loss, [tq, tcat])
    want_lse = np.asarray(want_lse)
    assert lse[0] == -torch.inf and want_lse[0] == -np.inf and np.isfinite(want_lse[1:]).all()
    np.testing.assert_allclose(lse.detach().numpy(), want_lse, rtol=1e-5)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)
    assert not got[0][0].any()
    # an all -1 sup_off masks nothing: it is the training path's dense_neg_lse
    none = torch.full((bt,), -1, dtype=torch.int32)
    plain = lse_kern.dense_neg_lse(tq, tcat, torch.tensor(count[:, :x]), tau)
    torch.testing.assert_close(
        lse_kern.fused_dense_neg_lse(tq, tcat, torch.tensor(count), none, tau), plain,
        rtol=0, atol=0,
    )


def test_fused_dense_neg_lse_takes_uint8_counts_only():
    q, cat, count, sup, _ = _lse_inputs(4, 8, 4, 50, 4, False)
    args = (torch.tensor(q), torch.tensor(cat))
    with pytest.raises(ValueError, match="uint8"):
        lse_kern.fused_dense_neg_lse(*args, torch.tensor(count).int(), torch.tensor(sup), 0.05)
    with pytest.raises(ValueError, match="count must be"):
        lse_kern.fused_dense_neg_lse(*args, torch.tensor(count)[:, :40], torch.tensor(sup), 0.05)
