"""The ranking task of the PyTorch port against the JAX package's, on the CPU.

The same numpy inputs and the same weights (`params_to_state_dict`) go
through both packages: the two rating preprocessors (padded and packed),
the aux-mask compaction, the model forward with the combined item-and-rating
preprocessor, the rating cross-entropy with every gradient (padded and
packed), the eval step's class probabilities and the multiclass metrics.
The JAX model runs its jnp path (`encoder.use_pallas=false`), which that
package's tests hold to its Pallas kernels; the port runs its kernels'
plain versions. Dropout is off where the two packages are compared: torch
cannot replay `jax.random`.

The model is small: D=16, 2 blocks, histories of up to 16 items, so the
input rows hold 27 positions and the encoder 54 (packed rows of capacity 32
double to 64, wider than the 54 the bias table reaches).

Tolerances: the preprocessors' embeddings at atol 1e-6, masks, lengths and
payloads exactly, the compaction exactly; the forward and the eval
probabilities at rtol 2e-4 / atol 2e-5; the loss at rtol 1e-5 and every
gradient at rtol 2e-4 / atol 2e-6 (tests/test_torch_port_train_step.py's);
the metrics to 1e-12. Then the trainer: k steps a call against k single
steps, `fit` with `fast_dev_run`, the CLIs' lines, and the JAX tests'
convergence guards at their settings.
"""

import copy
import io
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.configs import resolve as jax_resolve
from mygenerativerecommenders_tpu.configs import to_dict as jax_to_dict
from mygenerativerecommenders_tpu.configs.presets import get_preset as jax_preset
from mygenerativerecommenders_tpu.models import metrics as jax_metrics
from mygenerativerecommenders_tpu.models import preprocessors as jax_pre
from mygenerativerecommenders_tpu.models.model import build_model as jax_build_model
from mygenerativerecommenders_tpu.ops.sequence import (
    mask_dense_by_aux_mask as jax_mask_dense_by_aux_mask,
)
from mygenerativerecommenders_tpu.train import task_ranking as jax_task
from mygenerativerecommenders_tpu.utils.features import packed_seq_features as jax_packed
from mygenerativerecommenders_tpu.utils.features import seq_features_from_batch as jax_features
from mygenerativerecommenders_tpu_torch.checkpoint import (
    grads_to_state_dict,
    params_to_state_dict,
)
from mygenerativerecommenders_tpu_torch.cli import eval as cli_eval
from mygenerativerecommenders_tpu_torch.cli import train as cli_train
from mygenerativerecommenders_tpu_torch.configs import resolve as pt_resolve
from mygenerativerecommenders_tpu_torch.configs import to_dict as pt_to_dict
from mygenerativerecommenders_tpu_torch.configs.presets import get_preset as pt_preset
from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
from mygenerativerecommenders_tpu_torch.data.packing import PackedBatchLoader
from mygenerativerecommenders_tpu_torch.models import preprocessors as pt_pre
from mygenerativerecommenders_tpu_torch.models.metrics import multiclass_metrics
from mygenerativerecommenders_tpu_torch.models.model import build_model as pt_build_model
from mygenerativerecommenders_tpu_torch.ops.sequence import mask_dense_by_aux_mask
from mygenerativerecommenders_tpu_torch.serving.service import ServingEngine
from mygenerativerecommenders_tpu_torch.train import task_ranking as pt_task
from mygenerativerecommenders_tpu_torch.train.driver import Trainer
from mygenerativerecommenders_tpu_torch.utils.features import packed_seq_features
from mygenerativerecommenders_tpu_torch.utils.features import seq_features_from_batch
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

L = 16  # data.max_sequence_length: 27 input positions, 54 encoder tokens
CAPACITIES = (16, 32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------- the parts


def test_mask_dense_by_aux_mask_matches_jax_exactly():
    rng = np.random.default_rng(0)
    b, n, d = 5, 23, 3
    dense = rng.normal(size=(b, n, d)).astype(np.float32)
    aux = rng.random((b, n)) < 0.6
    aux[0] = True  # all kept up to the length
    aux[1] = False  # nothing kept
    lengths = np.array([n, 7, 0, 12, 19], dtype=np.int32)
    want, want_len = jax_mask_dense_by_aux_mask(jnp.asarray(dense), jnp.asarray(aux),
                                                jnp.asarray(lengths))
    got, got_len = mask_dense_by_aux_mask(torch.from_numpy(dense), torch.from_numpy(aux),
                                          torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got_len.dtype == torch.int32


def _preprocessor_inputs(packed, seed=1):
    """[B, N] ids, timestamps, ratings (some outside [0, R-1], which both
    packages clip), embeddings, lengths; packed rows add within-segment
    positions and segment ids, with trailing padding in row 0."""
    rng = np.random.default_rng(seed)
    b, n, d = 3, 20, 16
    lengths = np.array([20, 11, 1], dtype=np.int32)
    ids = np.zeros((b, n), dtype=np.int32)
    for r, length in enumerate(lengths):
        ids[r, :length] = rng.integers(1, 60, size=length)
    ratings = rng.integers(-1, 8, size=(b, n)).astype(np.int32)
    payloads = {
        "timestamps": np.sort(rng.integers(0, 10**6, size=(b, n)), axis=1).astype(np.int32),
        "ratings": ratings,
    }
    if packed:
        lengths = np.array([14, 11, 20], dtype=np.int32)
        spans = {0: [(0, 5), (5, 6), (6, 14)], 1: [(0, 11)], 2: [(0, 9), (9, 20)]}
        pos = np.zeros((b, n), dtype=np.int32)
        seg = np.full((b, n), -1, dtype=np.int32)
        ids[:] = 0
        for r, row in spans.items():
            for s, (lo, hi) in enumerate(row):
                pos[r, lo:hi] = np.arange(hi - lo)
                seg[r, lo:hi] = s
                ids[r, lo:hi] = rng.integers(1, 60, size=hi - lo)
        payloads.update(positions=pos, seg_ids=seg)
    emb = (rng.normal(size=(b, n, d)) * (ids != 0)[..., None]).astype(np.float32)
    return lengths, ids, emb, payloads


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
@pytest.mark.parametrize("kind", ["combined", "rated"])
def test_preprocessors_match_jax(kind, packed):
    max_len = 27
    if kind == "combined":
        jmod = jax_pre.CombinedItemAndRatingPreprocessor(
            max_sequence_len=max_len, embedding_dim=16, num_ratings=6)
        pmod = pt_pre.CombinedItemAndRatingPreprocessor(max_len, 16, 6)
    else:
        jmod = jax_pre.LearnablePositionalEmbeddingRatedPreprocessor(
            max_sequence_len=max_len, item_embedding_dim=16, rating_embedding_dim=8,
            num_ratings=6)
        pmod = pt_pre.LearnablePositionalEmbeddingRatedPreprocessor(max_len, 16, 8, 6)
    lengths, ids, emb, payloads = _preprocessor_inputs(packed)
    jargs = (jnp.asarray(lengths), jnp.asarray(ids), jnp.asarray(emb),
             {k: jnp.asarray(v) for k, v in payloads.items()})
    params = jmod.init(jax.random.PRNGKey(3), *jargs)
    state = params_to_state_dict({"preprocessor": _np_tree(params["params"])})
    pmod.load_state_dict({k[len("preprocessor."):]: v for k, v in state.items()})
    want = jmod.apply(params, *jargs)
    with torch.no_grad():
        got = pmod(torch.from_numpy(lengths), torch.from_numpy(ids), torch.from_numpy(emb),
                   {k: torch.from_numpy(v) for k, v in payloads.items()})
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # lengths
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))  # valid mask
    if kind == "combined":
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))  # aux mask
        assert got[1].shape[1] == 2 * ids.shape[1]
        np.testing.assert_array_equal(pmod.ratings_emb().detach().numpy(),
                                      np.asarray(params["params"]["rating_emb"]))
    else:
        assert got[3] is None and want[3] is None
        assert got[1].shape[-1] == 24
    assert got[4].keys() == want[4].keys()
    for key in got[4]:  # doubled timestamps, positions and segment ids
        np.testing.assert_array_equal(got[4][key].numpy(), np.asarray(want[4][key]), key)


# ---------------------------------------------------------------- the model


def _configs(*overrides, preset="synthetic-rank-smoke"):
    jcfg, pcfg = jax_preset(preset), pt_preset(preset)
    jcfg.model.encoder.use_pallas = "false"
    for cfg in (jcfg, pcfg):
        cfg.data.max_sequence_length = L
        cfg.data.pack_capacities = CAPACITIES
        cfg.model.preprocessor.dropout_rate = 0.0
        cfg.model.encoder.linear_dropout_rate = 0.0
        for override in overrides:
            node, (key, value) = cfg, override.split("=")
            *parents, leaf = key.split(".")
            for p in parents:
                node = getattr(node, p)
            setattr(node, leaf, type(getattr(node, leaf))(value))
    return jcfg, pcfg


def _setup(*overrides):
    """Both packages' ranking model with the JAX weights carried into the port,
    padded and packed train batches and padded val batches."""
    jcfg, pcfg = _configs(*overrides)
    data = RecoData(pcfg.data, seed=42)
    jax_resolve(jcfg, data.max_item_id)
    pt_resolve(pcfg, data.max_item_id)
    padded = list(data.loader("train"))[:2]
    packed = list(PackedBatchLoader(
        data.dataset("train"), rows_per_batch=1, row_capacity=max(CAPACITIES),
        capacities=CAPACITIES, segments_per_batch=8, shuffle=True, seed=42,
    ))
    jmodel = jax_build_model(jcfg)
    seq, _, _ = jax_features(padded[0], jcfg.model.gr_output_length + 1)
    key = jax.random.PRNGKey(0)
    params = jmodel.init({"params": key, "dropout": key}, seq, method=jmodel.init_all)
    pmodel = pt_build_model(pcfg, device="cpu")
    pmodel.load_state_dict(params_to_state_dict(_np_tree(params)))
    return jcfg, pcfg, jmodel, params, pmodel, padded, packed, list(data.loader("val"))


def _widest(batches):
    return max(batches, key=lambda b: b["ids"].shape[1])


def test_weights_carry_over_with_the_reference_keys():
    _, pcfg, _, params, pmodel, *_ = _setup()
    state = params_to_state_dict(_np_tree(params))
    assert state.keys() == pmodel.state_dict().keys()
    n_in = pcfg.data.max_sequence_length + pcfg.model.gr_output_length + 1
    assert state["preprocessor._pos_emb.weight"].shape == (2 * n_in, 16)
    assert state["preprocessor._rating_emb.weight"].shape == (6, 16)
    # the encoder's relative table spans the doubled row: 2 * (2 * n_in) - 1
    pos_w = "sequence_encoder._hstu._attention_layers.0._rel_attn_bias._pos_w"
    assert state[pos_w].shape == (4 * n_in - 1,)


def test_model_forward_with_the_combined_preprocessor_matches_jax():
    jcfg, _, jmodel, params, pmodel, padded, packed, val = _setup()
    max_out = jcfg.model.gr_output_length + 1
    for batch in (padded[0], val[0]):
        want, want_len = jmodel.apply(params, jax_features(batch, max_out)[0])
        with torch.no_grad():
            got, got_len = pmodel(seq_features_from_batch(_torch_batch(batch), max_out)[0])
        assert got.shape == (batch["ids"].shape[0], batch["ids"].shape[1] + max_out, 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
        np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    batch = _widest(packed)
    assert batch["ids"].shape[1] == max(CAPACITIES)
    want, want_len = jmodel.apply(params, jax_packed(batch))
    with torch.no_grad():
        got, got_len = pmodel(packed_seq_features(_torch_batch(batch)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(got_len.numpy(), batch["lengths"])


def test_retrieval_forward_with_the_rated_preprocessor_matches_jax():
    """The rated preprocessor widens the encoder to D + rating_embedding_dim
    and the postprocessor truncates back to D."""
    jcfg, pcfg = _configs("model.preprocessor.kind=learnable_positional_rated",
                          "model.preprocessor.rating_embedding_dim=8", preset="synthetic-smoke")
    data = RecoData(pcfg.data, seed=42)
    jax_resolve(jcfg, data.max_item_id)
    pt_resolve(pcfg, data.max_item_id)
    batch = next(iter(data.loader("train")))
    max_out = jcfg.model.gr_output_length + 1
    jmodel = jax_build_model(jcfg)
    seq = jax_features(batch, max_out)[0]
    key = jax.random.PRNGKey(0)
    params = jmodel.init({"params": key, "dropout": key}, seq, method=jmodel.init_all)
    pmodel = pt_build_model(pcfg, device="cpu")
    pmodel.load_state_dict(params_to_state_dict(_np_tree(params)))
    assert pmodel.sequence_encoder["_hstu"]._attention_layers[0]._uvqk.shape[0] == 24
    want, _ = jmodel.apply(params, seq)
    with torch.no_grad():
        got, _ = pmodel(seq_features_from_batch(_torch_batch(batch), max_out)[0])
    assert got.shape[-1] == 16
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("which", ["padded", "packed-widest", "packed-first"])
def test_ranking_loss_and_every_gradient_match_jax(which):
    jcfg, pcfg, jmodel, params, pmodel, padded, packed, _ = _setup()
    is_packed = which.startswith("packed")
    batch = (padded[0] if not is_packed else
             _widest(packed) if which == "packed-widest" else packed[0])
    jloss = jax_task.make_loss_fn(jmodel, jcfg, packed=is_packed)
    want, want_grads = jax.value_and_grad(jloss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1)
    )
    want_grads = grads_to_state_dict(_np_tree(want_grads))
    pmodel.train()  # dropout rates are 0
    loss = pt_task.make_loss_fn(pmodel, pcfg, packed=is_packed)(_torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    named = dict(pmodel.named_parameters())
    assert named.keys() == want_grads.keys()
    for name, p in named.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(
            p.grad.numpy(), want_grads[name].numpy(), rtol=2e-4, atol=2e-6, err_msg=name
        )


def test_eval_probabilities_match_jax():
    jcfg, pcfg, jmodel, params, pmodel, _, _, val = _setup()
    jstep = jax_task.make_eval_step(jmodel, jcfg)
    pstep = pt_task.make_eval_step(pmodel, pcfg)
    for batch in val[:2]:
        want = np.asarray(jstep(params, {k: jnp.asarray(v) for k, v in batch.items()}))
        with torch.no_grad():
            got = pstep(_torch_batch(batch)).numpy()
        assert got.shape == (batch["ids"].shape[0], 6)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("case", ["ties", "absent-class", "one-class-fills-a-column"])
def test_multiclass_metrics_match_jax(case):
    rng = np.random.default_rng({"ties": 0, "absent-class": 1, "one-class-fills-a-column": 2}[case])
    m, r = 300, 6
    probs = rng.random((m, r))
    probs[: m // 2] = np.round(probs[: m // 2], 1)  # many tied scores
    probs /= probs.sum(axis=1, keepdims=True)
    targets = rng.integers(0, r, size=m)
    if case == "absent-class":
        targets[targets == 3] = 4
    if case == "one-class-fills-a-column":
        targets[:] = 2
    want = jax_metrics.multiclass_metrics(probs, targets, num_classes=r)
    got = multiclass_metrics(probs, targets, num_classes=r)
    assert got.keys() == want.keys() == {"auroc", "ap", "precision", "recall"}
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-12, (key, got[key], want[key])
    assert got["precision"] == got["recall"]


def test_the_packed_gate_raises_as_the_jax_package_does():
    jcfg, pcfg, jmodel, _, pmodel, *_ = _setup()
    for cfg in (jcfg, pcfg):
        cfg.model.encoder.normalization = "softmax_rel_bias"
        cfg.model.preprocessor.kind = "learnable_positional_aux"
    with pytest.raises(ValueError) as want:
        jax_task.make_loss_fn(jmodel, jcfg, packed=True)
    with pytest.raises(ValueError) as got:
        pt_task.make_loss_fn(pmodel, pcfg, packed=True)
    assert str(got.value) == str(want.value)
    assert "encoder.kind=hstu with rel_bias normalization" in str(got.value)


def test_the_rated_preprocessor_has_no_rating_table_for_the_ranking_head():
    _, pcfg = _configs("model.preprocessor.kind=learnable_positional_rated",
                       "model.preprocessor.rating_embedding_dim=8")
    pt_resolve(pcfg, 220)
    model = pt_build_model(pcfg, device="cpu")
    assert model.preprocessor._pos_emb.weight.shape[1] == 24  # D + rating_embedding_dim
    with pytest.raises(ValueError, match="combined_item_and_rating"):
        model.ratings_embeddings()


@pytest.mark.parametrize("name", ["ml-1m-rank", "synthetic-rank-smoke", "synthetic-rank"])
def test_ranking_presets_equal_the_jax_presets(name):
    want, got = jax_to_dict(jax_preset(name)), pt_to_dict(pt_preset(name))
    got["trainer"].pop("device")  # the port's own knob

    def lists(tree):
        return {k: lists(v) if isinstance(v, dict) else
                list(v) if isinstance(v, (list, tuple)) else v for k, v in tree.items()}

    want["trainer"].pop("device", None)
    assert lists(got) == lists(want)


def test_serving_a_ranking_model_raises_naming_the_roadmap_item():
    _, pcfg = _configs()
    pt_resolve(pcfg, 220)
    model = pt_build_model(pcfg, device="cpu")
    with pytest.raises(ValueError, match="model.task=retrieval, got model.task=ranking"):
        ServingEngine(model, pcfg, np.arange(1, 221), 220, device="cpu")


def test_ranking_with_the_ring_gives_the_unsharded_loss_and_gradients():
    """sp_shards=4 composes with the doubled rows: the ring's shards (run in
    turn on the one device) give the sp_shards=1 loss and gradients."""
    results = {}
    for shards in (1, 4):
        _, pcfg = _configs(f"model.encoder.sp_shards={shards}", "model.encoder.sp_zigzag=true")
        data = RecoData(pcfg.data, seed=42)
        pt_resolve(pcfg, data.max_item_id)
        model = pt_build_model(pcfg, device="cpu", seed=5)
        loss = pt_task.make_loss_fn(model, pcfg)(_torch_batch(next(iter(data.loader("train")))))
        loss.backward()
        results[shards] = loss.item(), {k: p.grad for k, p in model.named_parameters()}
    np.testing.assert_allclose(results[4][0], results[1][0], rtol=1e-5)
    for name, want in results[1][1].items():
        np.testing.assert_allclose(results[4][1][name].numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-6, err_msg=name)


# ---------------------------------------------------------------- the trainer


def _args(tmp_path, *extra):
    return ["experiment=synthetic-rank-smoke", "trainer.device=cpu",
            f"trainer.output_dir={tmp_path / 'out'}", *extra]


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_k_steps_a_call_equal_k_single_steps(tmp_path, packed):
    """steps_per_call=8 on the CPU (its steps run eagerly) against 8 calls of
    one step, dropout on: the same losses and parameters."""
    extra = ["data.pack_sequences=true"] if packed else []
    runs = []
    for k in (1, 8):
        trainer = Trainer(cli_train.parse_args(_args(tmp_path, f"trainer.steps_per_call={k}",
                                                     *extra)))
        assert trainer._packed == packed and not trainer._eval_packed
        trainer.model.train()
        batches = [trainer._put(b) for _, b in zip(range(8), trainer._loader("train", packed))]
        assert len(batches) == 8
        torch.manual_seed(5)
        if k == 1:
            losses = torch.stack([trainer.train_step(b, trainer.lr1) for b in batches])
        else:
            losses = trainer.train_steps(batches, trainer.lr1)
        runs.append((losses.numpy(), copy.deepcopy(trainer.model.state_dict())))
    (single, p_single), (multi, p_multi) = runs
    np.testing.assert_allclose(multi, single, rtol=1e-6)
    assert single[-1] < single[0]
    for name, want in p_single.items():
        np.testing.assert_allclose(p_multi[name].numpy(), want.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


def test_fit_fast_dev_run(tmp_path):
    """As tests/test_train_e2e.py:49-58 does for the JAX trainer."""
    cfg = cli_train.parse_args(_args(tmp_path, "trainer.fast_dev_run=true"))
    results = Trainer(cfg).fit()
    assert {"auroc", "ap", "precision", "recall"} <= results.keys()
    assert all(0.0 <= v <= 1.0 for v in results.values())


def test_cli_train_and_eval_print_the_ranking_metrics(tmp_path):
    # the port's loggers write to the stdout of their creation and do not
    # propagate: read their lines through a handler of our own
    lines = io.StringIO()
    handler = logging.StreamHandler(lines)
    names = [f"mygenerativerecommenders_tpu_torch.{m}" for m in ("train.driver", "cli.train",
                                                               "cli.eval")]
    for name in names:
        logging.getLogger(name).addHandler(handler)
    try:
        monitored = cli_train.main(_args(tmp_path, "trainer.max_epochs=2"))
        run = tmp_path / "out" / "synthetic-rank-smoke"
        results = cli_eval.main(_args(tmp_path, f"trainer.ckpt_path={run / 'checkpoints' / 'best.pt'}"))
    finally:
        for name in names:
            logging.getLogger(name).removeHandler(handler)
    out = lines.getvalue().splitlines()
    val = [line for line in out if "val/auroc=" in line]
    test = [line for line in out if line.startswith("test: {")]
    assert len(val) == 2 and len(test) == 2, out  # cli.train's and cli.eval's
    for key in ("auroc", "ap", "precision", "recall"):
        assert f"val/{key}=" in val[0] and all(f"'{key}':" in line for line in test)
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert monitored == [r for r in rows if "val/ap" in r][-1]["val/ap"]
    assert any("test/auroc" in r for r in rows)
    assert {"auroc", "ap", "precision", "recall"} == results.keys()


def _convergence_cfg(tmp_path, packed):
    """The JAX convergence guards' settings: tests/test_train_e2e.py:252-280
    and tests/test_packing.py:497-523."""
    cfg = pt_preset("synthetic-rank")
    cfg.trainer.device = "cpu"
    cfg.trainer.output_dir = str(tmp_path / "out")
    cfg.data.synthetic_num_users = 192
    cfg.data.batch_size = 32
    cfg.data.max_sequence_length = 24
    cfg.data.expected_num_unique_items = 150
    cfg.data.expected_max_item_id = 160
    cfg.model.item_embedding_dim = 16
    cfg.model.encoder.num_blocks = 2
    cfg.data.pack_sequences = packed
    cfg.trainer.max_epochs = 12
    cfg.trainer.min_epochs = 12
    cfg.trainer.check_val_every_n_epoch = 12
    return cfg


def test_ranking_converges_on_quality_ratings(tmp_path):
    results = Trainer(_convergence_cfg(tmp_path, packed=False)).fit()
    assert results["auroc"] > 0.62, results
    assert results["precision"] == results["recall"]
    assert results["precision"] > 0.25, results  # chance ~0.2 over 5 ratings


def test_packed_ranking_trains_in_band(tmp_path):
    results = Trainer(_convergence_cfg(tmp_path, packed=True)).fit()
    assert results["auroc"] > 0.62, results
