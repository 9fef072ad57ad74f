"""Packed rows through the port's attention, model, loss and eval step against
the JAX package, on the CPU, from the same numpy inputs and weights.

The model is small (D=16, 3 blocks, H=2, histories up to 36 so L = 47) and the
rows are packed into capacities (16, 32, 48): the widest row is wider than L,
as the 1152-token rows of ml-20m-hstu-long are wider than its L = 1035. The
JAX attention kernel runs in interpret mode, as tests/test_packing.py runs it;
the JAX model runs its jnp path (`encoder.use_pallas=false`), which that
package's tests hold to its kernels. torch cannot replay `jax.random`, so the
negatives are the JAX package's own draw, injected into the port; dropout is
off on both sides.

Tolerances (ROADMAP.md): outputs at rtol 2e-4 / atol 2e-5, the bias tables'
gradients at rtol 5e-4, the loss at rtol 1e-5, parameter gradients at rtol
2e-4 / atol 2e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mygenerativerecommenders_tpu.configs import resolve as jax_resolve
from mygenerativerecommenders_tpu.configs.presets import get_preset as jax_preset
from mygenerativerecommenders_tpu.models.model import build_model as jax_build_model
from mygenerativerecommenders_tpu.ops import dense_negatives as jax_dense
from mygenerativerecommenders_tpu.ops.pallas import dense_softmax as jax_dense_softmax
from mygenerativerecommenders_tpu.ops.pallas.hstu_attention import (
    hstu_attention_fused as jax_fused,
)
from mygenerativerecommenders_tpu.train import task_retrieval as jax_task
from mygenerativerecommenders_tpu.utils.features import packed_seq_features as jax_packed_features
from mygenerativerecommenders_tpu_torch.checkpoint import (
    grads_to_state_dict,
    params_to_state_dict,
)
from mygenerativerecommenders_tpu_torch.configs import resolve as pt_resolve
from mygenerativerecommenders_tpu_torch.configs.presets import get_preset as pt_preset
from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
from mygenerativerecommenders_tpu_torch.data.packing import PackedBatchLoader
from mygenerativerecommenders_tpu_torch.models.model import build_model as pt_build_model
from mygenerativerecommenders_tpu_torch.ops.dense_negatives import (
    sampled_softmax_dense_neg_lse,
)
from mygenerativerecommenders_tpu_torch.ops.hstu_attention import relative_position_bias
from mygenerativerecommenders_tpu_torch.ops.kernels import hstu_attention as pt_kernel
from mygenerativerecommenders_tpu_torch.ops.topk import topk_agree
from mygenerativerecommenders_tpu_torch.train import task_retrieval as pt_task
from mygenerativerecommenders_tpu_torch.utils.features import packed_seq_features
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

CAPACITIES = (16, 32, 48)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _segments(spans, b, n):
    """Within-segment positions [b, n] from {row: [(start, end), ...]}."""
    pos = np.zeros((b, n), dtype=np.int32)
    for r, row_spans in spans.items():
        for lo, hi in row_spans:
            pos[r, lo:hi] = np.arange(hi - lo)
    return pos


@pytest.mark.parametrize(
    "b,n,h,d,max_len,spans,lengths",
    [
        # rows wider than the bias table reaches; segments of 1 and of max_len
        (2, 48, 2, 8, 40, {0: [(0, 1), (1, 41), (41, 44)], 1: [(0, 30), (30, 48)]}, [44, 48]),
        (3, 32, 1, 16, 32, {0: [(0, 32)], 1: [(0, 5), (5, 6), (6, 20)], 2: [(0, 9)]}, [32, 20, 9]),
    ],
)
def test_plain_attention_with_segments_matches_jax_fused_kernel(b, n, h, d, max_len, spans, lengths):
    rng = np.random.default_rng(n)
    q, k, v, g = (rng.normal(size=(b, n, h, d)).astype(np.float32) for _ in range(4))
    ts = np.sort(978_000_000 + rng.integers(0, 10**7, size=(b, n)), axis=1).astype(np.int32)
    pos_w = (rng.normal(size=(2 * max_len - 1,)) * 0.02).astype(np.float32)
    ts_w = (rng.normal(size=(129,)) * 0.02).astype(np.float32)
    pos, lens = _segments(spans, b, n), np.asarray(lengths, dtype=np.int32)

    def jax_loss(q_, k_, v_, pw_, tw_):
        out = jax_fused(
            q_, k_, v_, jnp.asarray(ts), pw_, tw_, max_len, 128,
            lengths=jnp.asarray(lens), seg_positions=jnp.asarray(pos),
        )
        return (out * g).sum(), out

    with pltpu.force_tpu_interpret_mode():
        (_, want_out), want = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            *map(jnp.asarray, (q, k, v, pos_w, ts_w))
        )
    args = [torch.tensor(a, requires_grad=True) for a in (q, k, v, pos_w, ts_w)]
    before = pt_kernel.launches
    out = pt_kernel.hstu_attention_fused(
        args[0], args[1], args[2], torch.tensor(ts), args[3], args[4], max_len, 128,
        lengths=torch.tensor(lens), seg_positions=torch.tensor(pos),
    )
    assert pt_kernel.launches == before  # CPU tensors take the plain version
    got = torch.autograd.grad((out * torch.tensor(g)).sum(), args)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=2e-4, atol=2e-5)
    for i, (a, w) in enumerate(zip(got, want)):
        rtol = 5e-4 if i >= 3 else 2e-4
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=rtol, atol=2e-5)
    for r, length in enumerate(lens):  # rows past the packed length: exactly zero
        assert not out[r, length:].any()
        for a in got[:3]:
            assert not a[r, length:].any()


def test_segments_do_not_see_each_other_and_one_segment_is_an_unpacked_row():
    b, n, h, d, max_len = 1, 24, 2, 8, 24
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.normal(size=(b, n, h, d)), dtype=torch.float32) for _ in range(3))
    ts = torch.tensor(np.sort(rng.integers(1000, 10**6, size=(b, n)), axis=1), dtype=torch.int32)
    pos_w = torch.tensor(rng.normal(size=(2 * max_len - 1,)) * 0.02, dtype=torch.float32)
    ts_w = torch.tensor(rng.normal(size=(129,)) * 0.02, dtype=torch.float32)
    pos = torch.tensor(_segments({0: [(0, 10), (10, 24)]}, b, n))

    def run(q_, k_, v_, seg):
        return pt_kernel.hstu_attention_fused(
            q_, k_, v_, ts, pos_w, ts_w, max_len, 128, seg_positions=seg
        )

    base = run(q, k, v, pos)
    k2, v2 = k.clone(), v.clone()
    k2[:, :10], v2[:, :10] = 7.0, -3.0  # change the first segment's keys and values
    np.testing.assert_array_equal(run(q, k2, v2, pos)[:, 10:].numpy(), base[:, 10:].numpy())
    whole = torch.arange(n, dtype=torch.int32)[None]
    np.testing.assert_array_equal(run(q, k, v, whole).numpy(), run(q, k, v, None).numpy())
    with pytest.raises(ValueError, match="seg_positions"):
        run(q, k, v, torch.zeros(2, n, dtype=torch.int32))
    with pytest.raises(ValueError, match="max_len"):  # only packed rows may be wider than L
        pt_kernel.hstu_attention_fused(q, k, v, ts, pos_w[:41], ts_w, 21, 128)


def test_position_bias_clamps_the_offsets_of_a_row_wider_than_the_table():
    pos_w = torch.arange(9, dtype=torch.float32)  # max_len 5
    got = relative_position_bias(pos_w, 8, 5).numpy()
    i, j = np.indices((8, 8))
    np.testing.assert_array_equal(got, np.clip(j - i + 4, 0, 8).astype(np.float32))


def _setup(heads=2, blocks=3):
    """Both packages' model on synthetic-smoke data with histories up to 36
    (L = 47), the JAX weights carried into the port, and the packed train and
    eval loaders over capacities (16, 32, 48)."""
    jcfg, pcfg = jax_preset("synthetic-smoke"), pt_preset("synthetic-smoke")
    jcfg.model.encoder.use_pallas = "false"
    for cfg in (jcfg, pcfg):
        cfg.data.max_sequence_length = 36
        cfg.data.synthetic_max_seq_len = 45
        cfg.data.pack_sequences = True
        cfg.data.pack_capacities = CAPACITIES
        cfg.model.preprocessor.dropout_rate = 0.0
        cfg.model.encoder.linear_dropout_rate = 0.0
        cfg.model.encoder.num_blocks = blocks
        cfg.model.encoder.num_heads = heads
        cfg.model.encoder.attention_dim = cfg.model.encoder.linear_dim = 16 // heads
    data = RecoData(pcfg.data, seed=42)
    jax_resolve(jcfg, data.max_item_id)
    pt_resolve(pcfg, data.max_item_id)

    def loader(split):
        return PackedBatchLoader(
            data.dataset(split), rows_per_batch=1, row_capacity=max(CAPACITIES),
            capacities=CAPACITIES, segments_per_batch=8, shuffle=split == "train", seed=42,
            include_target=split == "train",
        )

    train = list(loader("train"))
    jmodel = jax_build_model(jcfg)
    key = jax.random.PRNGKey(0)
    params = jmodel.init(
        {"params": key, "dropout": key}, jax_packed_features(train[0]), method=jmodel.init_all
    )
    pmodel = pt_build_model(pcfg, device="cpu")
    pmodel.load_state_dict(params_to_state_dict(_np_tree(params)))
    return jcfg, pcfg, jmodel, params, pmodel, data, train, list(loader("val"))


def _widest(batches):
    return max(batches, key=lambda b: b["ids"].shape[1])


@pytest.mark.parametrize("blocks", [3, 8])  # 8 blocks, 2 heads: the ml-20m presets' depth
def test_model_forward_on_packed_batches_matches_jax(blocks):
    jcfg, pcfg, jmodel, params, pmodel, _, train, val = _setup(blocks=blocks)
    assert len(pmodel.sequence_encoder["_hstu"]._attention_layers) == blocks
    assert {b["ids"].shape[1] for b in train} == set(CAPACITIES)  # 48 > L = 47
    for batch in (_widest(train), train[0], _widest(val)):
        want, _ = jmodel.apply(params, jax_packed_features(batch), deterministic=True)
        with torch.no_grad():
            got, lengths = pmodel(packed_seq_features(_torch_batch(batch)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
        np.testing.assert_array_equal(lengths.numpy(), batch["lengths"])
        assert not got[torch.from_numpy(batch["ids"] == 0)].any()  # padding stays zero


def _jax_neg_offsets(rng, batch, cfg, num_catalog):
    """The offsets the JAX `loss_fn_dense` draws for this packed batch."""
    _, neg_rng = jax.random.split(rng)
    p, l_cap = batch["ids"].shape
    shape = (p, l_cap - 1, cfg.model.loss.num_to_sample)
    return np.array(jax.random.randint(neg_rng, shape, 0, num_catalog))


@pytest.mark.parametrize("which", ["widest", "first"])
def test_packed_loss_and_every_gradient_match_jax(which):
    jcfg, pcfg, jmodel, params, pmodel, data, train, _ = _setup()
    batch = _widest(train) if which == "widest" else train[0]
    item_ids = data.all_item_ids
    rng = jax.random.PRNGKey(7)
    jloss = jax_task.make_loss_fn(jmodel, jcfg, item_ids, packed=True)
    assert jloss.__name__ == "loss_fn_dense"
    dev_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, want_grads = jax.value_and_grad(jloss)(params, dev_batch, rng)
    want_grads = grads_to_state_dict(_np_tree(want_grads))

    ploss = pt_task.make_loss_fn(pmodel, pcfg, item_ids, packed=True)
    offsets = torch.from_numpy(_jax_neg_offsets(rng, batch, jcfg, len(item_ids)))
    loss = ploss(_torch_batch(batch), neg_offsets=offsets)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    named = dict(pmodel.named_parameters())
    assert named.keys() == want_grads.keys()
    for name, p in named.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(
            p.grad.numpy(), want_grads[name].numpy(), rtol=2e-4, atol=2e-6, err_msg=name
        )


def test_packed_loss_supervises_the_pairs_of_the_padded_layout():
    """Same examples, same weights: the number of supervised positions and the
    positive term of the packed batch equal the padded batch's."""
    _, pcfg, _, _, pmodel, data, _, _ = _setup()
    ds = data.dataset("train")
    loader = PackedBatchLoader(ds, rows_per_batch=40, row_capacity=48)
    batch = next(iter(loader))
    assert int(batch["num_segments"].sum()) == len(ds)  # every example in one batch
    seg, ids = batch["seg_ids"], batch["ids"]
    supervised = (ids[:, 1:] != 0) & (seg[:, 1:] == seg[:, :-1]) & (seg[:, :-1] >= 0)
    assert int(supervised.sum()) == int(ds.lengths.sum())  # one per history item
    # a loss with no negatives at all is the positives' alone: both layouts agree
    pcfg.data.pack_sequences = False
    padded = {
        "lengths": np.maximum(ds.lengths, 1), "ids": ds.ids, "ratings": ds.ratings,
        "timestamps": ds.timestamps, "target_id": ds.target_id,
        "target_rating": ds.target_rating, "target_timestamp": ds.target_timestamp,
        "sample_weight": np.ones(len(ds), dtype=np.float32),
    }
    sentinel = len(data.all_item_ids) + 5  # every draw outside the catalog: lse = -inf

    def loss_of(packed, b):
        fn = pt_task.make_loss_fn(pmodel, pcfg, data.all_item_ids, packed=packed)
        n = b["ids"].shape[1] + (0 if packed else pcfg.model.gr_output_length + 1)
        offsets = torch.full((b["ids"].shape[0], n - 1, 4), sentinel, dtype=torch.int32)
        with torch.no_grad():
            return fn(_torch_batch(b), neg_offsets=offsets).item()

    assert loss_of(True, batch) == loss_of(False, padded) == 0.0


def test_packed_eval_step_matches_jax_and_the_unpacked_step():
    jcfg, pcfg, jmodel, params, pmodel, data, _, val = _setup()
    item_ids, max_id = data.all_item_ids, data.max_item_id
    jstep = jax_task.make_packed_eval_step(jmodel, jcfg, item_ids, max_id)
    jcand = jax_task.make_candidate_fn(jmodel, jcfg, item_ids)(params)
    pstep = pt_task.make_packed_eval_step(pmodel, pcfg, item_ids, max_id)
    ustep = pt_task.make_eval_step(pmodel, pcfg, item_ids, max_id)
    ds = data.dataset("val")
    seen = []
    with torch.no_grad():
        pcand = pt_task.make_candidate_fn(pmodel, pcfg, item_ids)()
        np.testing.assert_allclose(pcand.numpy(), np.asarray(jcand), rtol=2e-4, atol=2e-5)
        for batch in val:
            want = jstep(params, {k: jnp.asarray(v) for k, v in batch.items()}, jcand)
            ids, scores, target, weight = pstep(_torch_batch(batch), pcand)
            assert ids.shape == (len(batch["seg_weight"]), pcfg.model.index.k)
            np.testing.assert_array_equal(target.numpy(), np.asarray(want[2]))
            np.testing.assert_array_equal(weight.numpy(), np.asarray(want[3]))
            real = batch["seg_weight"] > 0
            problem = topk_agree(
                ids.numpy()[real], scores.numpy()[real],
                np.asarray(want[0])[real], np.asarray(want[1])[real], atol=2e-5,
            )
            assert problem is None, problem
            # the same examples through the padded eval step of the port
            ex = batch["seg_example"][real]
            padded = {
                "lengths": ds.lengths[ex], "ids": ds.ids[ex], "ratings": ds.ratings[ex],
                "timestamps": ds.timestamps[ex], "target_id": ds.target_id[ex],
                "target_rating": ds.target_rating[ex],
                "target_timestamp": ds.target_timestamp[ex],
                "sample_weight": np.ones(len(ex), dtype=np.float32),
            }
            np.testing.assert_array_equal(batch["seg_target"][real], ds.target_id[ex])
            u_ids, u_scores = ustep(_torch_batch(padded), pcand)
            problem = topk_agree(
                ids.numpy()[real], scores.numpy()[real], u_ids.numpy(), u_scores.numpy(),
                atol=2e-5,
            )
            assert problem is None, problem
            # a query never gets an id of its own history back
            for row, hist in zip(ids.numpy()[real], batch["seg_invalid_ids"][real]):
                assert not set(row.tolist()) & set(hist[hist > 0].tolist())
            seen.extend(ex.tolist())
    assert sorted(seen) == list(range(len(ds)))


def test_dense_neg_lse_matches_jax_multi_x_block_kernels(monkeypatch):
    """A catalog tiled over three x-blocks, forced small by shrinking the JAX
    kernels' x-block: the forward's per-block partials and the split dq / dcat
    backward kernels, against the port's one lse and its gradients."""
    bt, d, x, r, tau = 40, 12, 2500, 16, 0.05
    rng = np.random.default_rng(6)
    q = rng.normal(size=(bt, d)).astype(np.float32)
    cat = rng.normal(size=(x, d)).astype(np.float32)
    cat /= np.linalg.norm(cat, axis=-1, keepdims=True)
    offs = rng.integers(0, x, size=(bt, r)).astype(np.int32)
    sup = np.where(rng.random(bt) < 0.2, -1, rng.integers(0, x, size=bt)).astype(np.int32)
    sup[0] = 2100
    offs[0, :] = 2100  # an all-hit row, in the last x-block
    offs[2, :3] = sup[2] if sup[2] >= 0 else 5
    gl = rng.normal(size=(bt,)).astype(np.float32)
    monkeypatch.setattr(jax_dense_softmax, "_XB", 1024)
    assert jax_dense_softmax.hi_blocks(x) == (8, 3)

    def jax_f(q_, cat_):
        lse = jax_dense.sampled_softmax_dense_neg_lse(
            q_, cat_, jnp.asarray(offs), jnp.asarray(sup), tau, use_pallas=True
        )
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
    assert lse[0] == -torch.inf and want_lse[0] == -np.inf and np.isfinite(want_lse[1:]).all()
    np.testing.assert_allclose(lse.detach().numpy(), want_lse, rtol=1e-5)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)
    assert not got[0][0].any()
