"""Muon, Scion and the two-optimizer split of the PyTorch port against the
JAX package's train/optimizers.py, on the CPU, and the trainer around them.

Both packages get the same weights (`params_to_state_dict`), gradients,
batches and negatives (the JAX package's own draw, injected as in
tests/test_torch_port_train_step.py); dropout is off.

Newton-Schulz-5 runs in bfloat16 on both sides, and there the two cannot
agree bit for bit past the normalisation: CPU BLAS and XLA round the
bfloat16 products in another order, which five iterations compound. So NS-5
is held bit for bit at 0 steps, to a relative Frobenius difference of 1e-2
at 1 step and 0.15 at 5, and to JAX's own singular-value band (0.2, 2.0)
(tests/test_optimizers.py). The optimizers' algebra is held at rtol 2e-4 /
atol 2e-6 with NS-5 replaced on both sides by the same float32 iteration
(`monkeypatch` of each module's `zeropower_via_newtonschulz5`), and three
two-optimizer train steps at atol 2e-5 so (the AdamW test's tolerance). With
the real bfloat16 NS-5 the same three steps hold each encoder matrix within
BF16_UPDATE_BAND of its movement and the rest at BF16_ATOL.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.configs import OptimizerConfig as JaxOptimizerConfig
from mygenerativerecommenders_tpu.configs import SchedulerConfig as JaxSchedulerConfig
from mygenerativerecommenders_tpu.configs import resolve as jax_resolve
from mygenerativerecommenders_tpu.configs.presets import get_preset as jax_preset
from mygenerativerecommenders_tpu.models.model import build_model as jax_build_model
from mygenerativerecommenders_tpu.train import lazy_embedding as jax_lazy
from mygenerativerecommenders_tpu.train import optimizers as jax_opt
from mygenerativerecommenders_tpu.train import task_retrieval as jax_task
from mygenerativerecommenders_tpu.utils.features import seq_features_from_batch as jax_features
from mygenerativerecommenders_tpu_torch.checkpoint import (
    jax_tree_to_state_dict,
    params_to_state_dict,
)
from mygenerativerecommenders_tpu_torch.cli import train as cli_train
from mygenerativerecommenders_tpu_torch.configs import OptimizerConfig
from mygenerativerecommenders_tpu_torch.configs import resolve as pt_resolve
from mygenerativerecommenders_tpu_torch.configs.presets import get_preset as pt_preset
from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
from mygenerativerecommenders_tpu_torch.models.model import build_model as pt_build_model
from mygenerativerecommenders_tpu_torch.train import lazy_embedding as pt_lazy
from mygenerativerecommenders_tpu_torch.train import optimizers as pt_opt
from mygenerativerecommenders_tpu_torch.train import task_retrieval as pt_task
from mygenerativerecommenders_tpu_torch.train.driver import Trainer
from tests.test_torch_port_lazy_embedding import _offsets_of
from tests.test_torch_port_train_step import _jax_neg_offsets, _np_tree, _torch_batch
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

ALGEBRA_RTOL, ALGEBRA_ATOL = 2e-4, 2e-6
STEP_ATOL = 2e-5
# three two-optimizer steps with the bfloat16 NS-5 on both sides: each
# encoder matrix within 0.15 of its own movement (NS-5's band at 5 steps; the
# update of a matrix is its NS-5 output times the rate; measured 0.05-0.095),
# the other parameters, whose gradients see the matrices' differences, at
# atol 1e-4 (measured up to 1.7e-5)
BF16_UPDATE_BAND, BF16_ATOL = 0.15, 1e-4

MUON = dict(kind="muon", lr=5e-3, momentum=0.95, nesterov=True, weight_decay=0.0)
SCION = dict(kind="scion", lr=1e-3, momentum=0.1, norm="auto", unconstrained=True)


def _ns_f32(g, steps, xp):
    """NS-5 in float32, the same iteration on both sides."""
    a, b, c = 3.4445, -4.7750, 2.0315
    transpose = g.shape[-2] > g.shape[-1]
    x = g.T if transpose else g
    x = x / (xp.linalg.norm(x) + 1e-7)
    for _ in range(steps):
        xxt = x @ x.T
        x = a * x + (b * xxt + c * (xxt @ xxt)) @ x
    return x.T if transpose else x


@pytest.fixture
def ns_f32(monkeypatch):
    monkeypatch.setattr(jax_opt, "zeropower_via_newtonschulz5",
                        lambda g, steps=5: _ns_f32(g.astype(jnp.float32), steps, jnp))
    monkeypatch.setattr(pt_opt, "zeropower_via_newtonschulz5",
                        lambda g, steps=5: _ns_f32(g.float(), steps, torch))


def _set(cfg, **values):
    for path, value in values.items():
        node = cfg
        *parents, leaf = path.split("__")
        for p in parents:
            node = getattr(node, p)
        setattr(node, leaf, value)


def _both(concat_ua=False, **values):
    """Both packages' synthetic-smoke model (2 blocks, D=16, N=43, X=200)
    with the JAX weights carried into the port, and three train batches."""
    jcfg, pcfg = jax_preset("synthetic-smoke"), pt_preset("synthetic-smoke")
    jcfg.model.encoder.use_pallas = "false"
    for cfg in (jcfg, pcfg):
        cfg.model.preprocessor.dropout_rate = 0.0
        cfg.model.encoder.linear_dropout_rate = 0.0
        cfg.model.encoder.concat_ua = concat_ua
        _set(cfg, **values)
    data = RecoData(pcfg.data, seed=42)
    jax_resolve(jcfg, data.max_item_id)
    pt_resolve(pcfg, data.max_item_id)
    batches = [b for _, b in zip(range(2), data.loader("train"))]
    jmodel = jax_build_model(jcfg)
    seq, _, _ = jax_features(batches[0], jcfg.model.gr_output_length + 1)
    key = jax.random.PRNGKey(0)
    params = jmodel.init({"params": key, "dropout": key}, seq, method=jmodel.init_all)
    pmodel = pt_build_model(pcfg, device="cpu")
    pmodel.load_state_dict(params_to_state_dict(_np_tree(params)))
    return jcfg, pcfg, jmodel, params, pmodel, data.all_item_ids, [*batches, batches[0]]


def _shapes(preset, **values):
    """(the JAX model's parameter shapes, `jax.eval_shape` of its init, and
    the port's model) for a preset, without running the JAX init."""
    jcfg, pcfg = jax_preset(preset), pt_preset(preset)
    for cfg in (jcfg, pcfg):
        _set(cfg, **values)
    data = RecoData(pcfg.data, seed=42)
    jax_resolve(jcfg, data.max_item_id)
    pt_resolve(pcfg, data.max_item_id)
    jmodel = jax_build_model(jcfg)
    seq, _, _ = jax_features(next(iter(data.loader("train"))), jcfg.model.gr_output_length + 1)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": key, "dropout": key}, seq, method=jmodel.init_all))
    return shapes, pt_build_model(pcfg, device="cpu")


@pytest.fixture(scope="module")
def concat_ua_model():
    """Weights and two gradient-like trees, drawn from a seed, in the
    parameter tree of the concat_ua=true model (o is [3 * 16, 16] in JAX's
    layout)."""
    shapes, _ = _shapes("synthetic-smoke", model__encoder__concat_ua=True)
    rng = np.random.default_rng(0)
    params, *grads = (
        jax.tree.map(lambda p: (rng.normal(size=p.shape) * scale).astype(np.float32), shapes)
        for scale in (0.1, 0.01, 0.01)
    )
    return params, grads


def _momentum_of(state):
    """The MuonState / ScionState momentum tree inside a JAX optimizer state."""
    if isinstance(state, (jax_opt.MuonState, jax_opt.ScionState)):
        return state.momentum
    children = state.values() if isinstance(state, dict) else (
        state if isinstance(state, tuple) else getattr(state, "__dict__", {}).values())
    for child in children:
        found = _momentum_of(child)
        if found is not None:
            return found
    return None


def _assert_params(pmodel_params, jparams, rtol, atol):
    want = params_to_state_dict(_np_tree(jparams))
    for name, p in pmodel_params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=rtol, atol=atol,
                                   err_msg=name)


# ---------------------------------------------------------------- NS-5


@pytest.mark.parametrize("steps", [0, 1, 5])
@pytest.mark.parametrize("shape", [(50, 200), (50, 50), (150, 50), (64, 16)])
def test_newton_schulz_in_bfloat16_against_jax(shape, steps):
    rng = np.random.default_rng(sum(shape) + steps)
    for scale in (1e-4, 1e-2, 1.0):
        g = (rng.normal(size=shape) * scale).astype(np.float32)
        want = np.asarray(jax_opt.zeropower_via_newtonschulz5(jnp.asarray(g), steps)
                          .astype(jnp.float32))
        got = pt_opt.zeropower_via_newtonschulz5(torch.tensor(g), steps)
        assert got.dtype == torch.bfloat16 and got.shape == shape
        got = got.float().numpy()
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        if steps == 0:
            np.testing.assert_array_equal(got, want)
        else:
            assert rel <= (1e-2 if steps == 1 else 0.15), (scale, rel)
        if steps == 5:
            for s in (np.linalg.svd(got, compute_uv=False), np.linalg.svd(want, compute_uv=False)):
                assert 0.2 < s.min() and s.max() < 2.0


# ---------------------------------------------------------------- the algebra


@pytest.mark.parametrize(
    "opt2",
    [dict(MUON, weight_decay=0.01), dict(MUON, nesterov=False, weight_decay=0.01)]
    + [dict(SCION, norm=norm, unconstrained=unconstrained)
       for norm in ("auto", "spectral", "bias_rms", "col", "row", "sign")
       for unconstrained in (True, False)],
    ids=lambda d: f"{d['kind']}-" + (f"nesterov{d['nesterov']}" if d["kind"] == "muon"
                                     else f"{d['norm']}-unconstrained{d['unconstrained']}"),
)
def test_split_optimizer_two_steps_match_multi_transform(opt2, concat_ua_model, ns_f32):
    """AdamW on the primary parameters and Muon / Scion on the encoder's
    matrices, two steps from zeros at concat_ua=true: every parameter, and
    the momentum the second step starts from and ends with."""
    params, grads = concat_ua_model
    adamw = dict(kind="adamw", lr=1e-3, weight_decay=1e-3)
    lr1, lr2 = 1e-3, opt2["lr"]
    tx = jax_opt.build_optimizer(JaxOptimizerConfig(**adamw), JaxOptimizerConfig(**opt2),
                                 params, lr1, lr2)
    jstate = tx.init(params)
    named = {k: torch.nn.Parameter(v) for k, v in params_to_state_dict(params).items()}
    opt = pt_opt.build_optimizer(OptimizerConfig(**adamw), OptimizerConfig(**opt2),
                                 list(named.items()), lr1, lr2)
    assert isinstance(opt.matrix, pt_opt.Muon if opt2["kind"] == "muon" else pt_opt.Scion)
    jparams = params
    for g in grads:
        updates, jstate = tx.update(g, jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        for name, value in params_to_state_dict(g).items():
            named[name].grad = value
        opt.step()
    _assert_params(named, jparams, ALGEBRA_RTOL, ALGEBRA_ATOL)
    momentum = jax_tree_to_state_dict(_momentum_of(jstate))
    assert momentum and all(opt.matrix.state[named[k]]["momentum_buffer"].any() or
                            opt2["momentum"] == 1.0 for k in momentum)
    for name, want in momentum.items():
        np.testing.assert_allclose(opt.matrix.state[named[name]]["momentum_buffer"].numpy(),
                                   want.numpy(), rtol=ALGEBRA_RTOL, atol=ALGEBRA_ATOL)


@pytest.mark.parametrize("nesterov", [True, False])
def test_muon_over_every_parameter_from_a_jax_mid_run_state(nesterov, concat_ua_model, ns_f32):
    """optimizer1.kind=muon steps every parameter, the vectors (biases, the
    bias tables) as SGD-momentum: one JAX step, then its weights and its
    momentum (`load_jax_momentum`) into the port, and one more step on each."""
    params, (g0, g1) = concat_ua_model
    cfg = dict(MUON, nesterov=nesterov, weight_decay=0.01)
    tx = jax_opt.build_optimizer(JaxOptimizerConfig(**cfg), None, params, cfg["lr"], cfg["lr"])
    jstate = tx.init(params)
    updates, jstate = tx.update(g0, jstate, params)
    mid = jax.tree.map(lambda p, u: p + u, params, updates)
    named = {k: torch.nn.Parameter(v) for k, v in params_to_state_dict(_np_tree(mid)).items()}
    assert any(p.ndim == 1 for p in named.values())
    opt = pt_opt.build_optimizer(OptimizerConfig(**cfg), None, list(named.items()), cfg["lr"])
    pt_opt.load_jax_momentum(opt, named.items(), _np_tree(_momentum_of(jstate)))
    updates, jstate = tx.update(g1, jstate, mid)
    after = jax.tree.map(lambda p, u: p + u, mid, updates)
    for name, value in params_to_state_dict(g1).items():
        named[name].grad = value
    opt.step()
    _assert_params(named, after, ALGEBRA_RTOL, ALGEBRA_ATOL)


# ---------------------------------------------------------------- labels and init


@pytest.mark.parametrize(
    "preset,values",
    [("synthetic-smoke", {}), ("synthetic-rank-smoke", {}),
     ("synthetic-smoke", {"model__encoder__concat_ua": True})],
    ids=["retrieval", "ranking", "concat_ua"],
)
def test_param_labels_are_the_jax_packages(preset, values):
    shapes, pmodel = _shapes(preset, **values)
    marks = jax.tree.map(lambda label, p: np.full(p.shape, label == "matrix", np.float32),
                         jax_opt.param_labels(shapes), shapes)
    want = {k: "matrix" if v.all() else "primary" for k, v in params_to_state_dict(marks).items()}
    got = pt_opt.param_labels(pmodel.named_parameters())
    assert got == want
    assert sorted(k for k, v in got.items() if v == "matrix") == sorted(
        k for k in got if k.endswith(("_uvqk", "_o.weight")))


def test_scion_init_is_orthogonal_in_the_jax_layout_as_in_jax(tmp_path):
    """Every matrix of the split gets an orthogonal init in its JAX layout
    times (d_out/d_in)^0.5 * scale: all singular values that scale, as the
    JAX package's; the primary parameters are left alone. The trainer
    applies it under optimizer2.scion_init."""
    scale = 0.5
    shapes, pmodel = _shapes("synthetic-smoke", model__encoder__concat_ua=True)
    params = jax.tree.map(lambda p: np.zeros(p.shape, np.float32), shapes)
    before = {k: v.clone() for k, v in pmodel.state_dict().items()}
    pt_opt.scion_init_params(pmodel.named_parameters(), OptimizerConfig(kind="scion", scale=scale),
                             torch.Generator().manual_seed(0))
    want = params_to_state_dict(_np_tree(jax_opt.scion_init_params(
        jax.random.PRNGKey(0), params, jax_opt.param_labels(params),
        JaxOptimizerConfig(kind="scion", scale=scale))))
    labels = pt_opt.param_labels(pmodel.named_parameters())
    assert "matrix" in labels.values()
    for name, p in pmodel.named_parameters():
        if labels[name] == "primary":
            assert torch.equal(p.detach(), before[name]), name
            continue
        got, jax_got = p.detach(), want[name]
        if name.endswith("_o.weight"):  # into the JAX layout
            got, jax_got = got.t(), jax_got.t()
        d_out, d_in = got.shape
        got_s = np.linalg.svd(got.numpy(), compute_uv=False)
        np.testing.assert_allclose(got_s, np.linalg.svd(jax_got.numpy(), compute_uv=False),
                                   rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(got_s, (d_out / d_in) ** 0.5 * scale, rtol=1e-5, err_msg=name)
    seeded, plain = (
        Trainer(cli_train.parse_args(_args(tmp_path, "optimizer2.enabled=true",
                                           "optimizer2.kind=scion", f"optimizer2.scion_init={on}")))
        for on in ("true", "false")
    )
    labels = pt_opt.param_labels(plain.model.named_parameters())
    for (name, p), q in zip(seeded.model.named_parameters(), plain.model.parameters()):
        assert torch.equal(p, q) == (labels[name] == "primary"), name


# ---------------------------------------------------------------- train steps


@pytest.mark.parametrize("ns", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt2", [MUON, SCION], ids=["muon", "scion"])
def test_three_two_optimizer_train_steps_match_jax(opt2, ns, request):
    if ns == "float32":
        request.getfixturevalue("ns_f32")
    jcfg, pcfg, jmodel, params, pmodel, item_ids, batches = _both()
    jcfg.optimizer1 = JaxOptimizerConfig(kind="adamw", lr=5e-4, weight_decay=1e-3)
    jcfg.optimizer2 = JaxOptimizerConfig(**opt2)
    pcfg.optimizer1 = OptimizerConfig(kind="adamw", lr=5e-4, weight_decay=1e-3)
    pcfg.optimizer2 = OptimizerConfig(**opt2)
    rng, lr1, lr2 = jax.random.PRNGKey(11), 5e-4, opt2["lr"]
    jstep = jax_task.make_train_step(jmodel, jcfg, item_ids)
    jstate = jax_opt.build_optimizer(jcfg.optimizer1, jcfg.optimizer2, params, lr1, lr2).init(params)
    optimizer = pt_opt.build_optimizer(pcfg.optimizer1, pcfg.optimizer2,
                                       pmodel.named_parameters(), lr1, lr2)
    pstep = pt_task.make_train_step(pmodel, pcfg, item_ids, optimizer)
    before = {k: v.clone() for k, v in pmodel.state_dict().items()}
    jparams = params
    for step, batch in enumerate(batches):
        out = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                    rng, lr1, lr2, step)
        jparams, jstate = out.params, out.opt_state
        offsets = torch.from_numpy(_jax_neg_offsets(rng, step, batch, jcfg, len(item_ids)))
        loss = pstep(_torch_batch(batch), lr1, lr2, neg_offsets=offsets)
        np.testing.assert_allclose(loss.item(), float(out.loss), rtol=1e-4)
    want = params_to_state_dict(_np_tree(jparams))
    labels = pt_opt.param_labels(pmodel.named_parameters())
    for name, p in pmodel.named_parameters():
        moved = float((p.detach() - before[name]).abs().max())
        if labels[name] == "matrix":
            assert moved > 10 * STEP_ATOL, name  # the matrix optimizer moved it
        atol = STEP_ATOL if ns == "float32" else (
            BF16_UPDATE_BAND * moved if labels[name] == "matrix" else BF16_ATOL)
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=atol,
                                   err_msg=name)


def test_three_lazy_steps_with_muon_match_jax(ns_f32):
    """embedding.lazy_update with optimizer2: the item table by the lazy row
    AdamW at lr1, the other primary parameters by AdamW, the encoder's
    matrices by Muon at lr2."""
    jcfg, pcfg, jmodel, params, pmodel, item_ids, batches = _both(
        model__loss__shared_negatives=True, model__embedding__lazy_update=True)
    for cfg, opt_cls in ((jcfg, JaxOptimizerConfig), (pcfg, OptimizerConfig)):
        cfg.optimizer2 = opt_cls(**MUON)
    rng, lr1, lr2 = jax.random.PRNGKey(11), jcfg.optimizer1.lr, MUON["lr"]
    r = pcfg.model.loss.num_to_sample
    j_ids_fn, _ = jax_lazy.make_lazy_parts(jmodel, jcfg, item_ids)
    jstep = jax_task.make_train_step(jmodel, jcfg, item_ids)
    jstate = jax_lazy.init_lazy_opt_state(jcfg, params)
    optimizer = pt_lazy.init_lazy_optimizer(pcfg, pmodel)
    assert isinstance(optimizer.rest, pt_opt.SplitOptimizer)
    pstep = pt_task.make_train_step(pmodel, pcfg, item_ids, optimizer)
    jparams = params
    for step, batch in enumerate(batches):
        dev_batch = {k: jnp.asarray(v) for k, v in batch.items()}
        ids_all = np.asarray(j_ids_fn(dev_batch, jax.random.fold_in(rng, step)))
        out = jstep(jparams, jstate, dev_batch, rng, lr1, lr2, step)
        jparams, jstate = out.params, out.opt_state
        loss = pstep(_torch_batch(batch), lr1, lr2, neg_offsets=_offsets_of(ids_all, item_ids, r))
        np.testing.assert_allclose(loss.item(), float(out.loss), rtol=1e-4)
    _assert_params(dict(pmodel.named_parameters()), jparams, 5e-4, 1e-6)
    np.testing.assert_allclose(optimizer.mv.numpy(), np.asarray(jstate.table.mv), rtol=5e-4,
                               atol=1e-6)
    # the table's rate is optimizer1's, the matrices' optimizer2's
    first, second = pt_opt.rate_groups(optimizer)
    assert {float(g["lr"]) for g in first} == {lr1}
    assert {float(g["lr"]) for g in second} == {float(np.float32(lr2))}


# ---------------------------------------------------------------- the trainer


def _args(tmp_path, *extra):
    return ["experiment=synthetic-smoke", "trainer.device=cpu", "trainer.log_every_n_steps=1",
            f"trainer.output_dir={tmp_path / 'out'}", *extra]


MUON_ARGS = ("optimizer1.lr=5e-4", "optimizer2.enabled=true", "optimizer2.kind=muon",
             "optimizer2.lr=5e-3", "optimizer2.weight_decay=0.0", "scheduler2.kind=plateau")
SCION_ARGS = ("optimizer2.enabled=true", "optimizer2.kind=scion", "optimizer2.lr=1e-3",
              "optimizer2.momentum=0.1", "scheduler2.kind=plateau")


@pytest.mark.parametrize("args", [MUON_ARGS, SCION_ARGS], ids=["muon", "scion"])
def test_two_optimizer_training_decreases_loss(args, tmp_path):
    """The port's mirror of the JAX package's test of the same name: two
    batches, six epochs, the loss falls."""
    trainer = Trainer(cli_train.parse_args(_args(
        tmp_path, *args, "trainer.overfit_batches=2", "trainer.check_val_every_n_epoch=100")))
    assert isinstance(trainer.optimizer, pt_opt.SplitOptimizer)
    first = trainer.train_epoch(trainer.data.loader("train"))
    for _ in range(5):
        trainer.epoch += 1
        last = trainer.train_epoch(trainer.data.loader("train"))
    assert np.isfinite(last) and last < first, (first, last)


def test_resume_from_last_gives_the_uninterrupted_run(tmp_path):
    """Two epochs of AdamW + Muon (both plateau controllers on) against one
    epoch, then a resume from its last.pt: the same losses, weights, both
    optimizers' state and both controllers."""
    extra = MUON_ARGS + ("scheduler2.patience=0", "scheduler2.factor=0.5")
    whole = Trainer(cli_train.parse_args(_args(tmp_path / "whole", *extra, "trainer.max_epochs=2")))
    whole.fit()
    Trainer(cli_train.parse_args(_args(tmp_path / "cut", *extra, "trainer.max_epochs=1"))).fit()
    last = tmp_path / "cut" / "out" / "synthetic-smoke" / "checkpoints" / "last.pt"
    saved = torch.load(last, weights_only=True)
    assert set(saved["optimizer"]) == {"primary", "matrix"} and saved["extra"]["lr2"]
    resumed = Trainer(cli_train.parse_args(_args(
        tmp_path / "cut", *extra, "trainer.max_epochs=2", f"trainer.ckpt_path={last}")))
    resumed.fit()

    def rows(out):
        path = out / "out" / "synthetic-smoke" / "metrics.jsonl"
        return [json.loads(line) for line in path.read_text().splitlines()]

    def losses(out):
        return [(r["train/loss"], r["lr1"], r["lr2"]) for r in rows(out)
                if "train/loss" in r and r["epoch"] == 1]

    assert losses(tmp_path / "cut") == losses(tmp_path / "whole")
    for (name, p), q in zip(whole.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, q), name
    for part in ("primary", "matrix"):
        a, b = (getattr(t.optimizer, part).state_dict()["state"] for t in (whole, resumed))
        assert a.keys() == b.keys()
        for key in a:
            for field, value in a[key].items():
                assert torch.equal(torch.as_tensor(value), torch.as_tensor(b[key][field]))
    assert resumed.lr2_ctrl.state_dict() == whole.lr2_ctrl.state_dict()
    assert resumed.lr1_ctrl.state_dict() == whole.lr1_ctrl.state_dict()
    assert (resumed.lr1, resumed.lr2) == (whole.lr1, whole.lr2)


def test_fit_raises_when_the_monitored_metric_is_not_computed(tmp_path):
    """The eval computes ndcg / hr at metrics.at_k_list and mrr: a monitor
    outside them raises before the first epoch, naming both. Building the
    trainer (as eval and predict do) still works."""
    trainer = Trainer(cli_train.parse_args(_args(tmp_path, "trainer.monitor=val/ndcg@100")))
    with pytest.raises(ValueError, match=r"val/ndcg@100.*ndcg@5, ndcg@10, ndcg@20, hr@5"):
        trainer.fit()
    assert trainer.global_step == 0
    assert not (tmp_path / "out" / "synthetic-smoke" / "checkpoints" / "last.pt").exists()


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    """One JAX trainer, synthetic-smoke with the matrix optimizer, whose
    monitor names a metric its eval does not compute."""
    from mygenerativerecommenders_tpu.train.driver import Trainer as JaxTrainer

    out = tmp_path_factory.mktemp("jax")
    cfg = jax_preset("synthetic-smoke")
    cfg.data.data_dir = str(out / "data")
    cfg.trainer.output_dir = str(out / "out")
    cfg.trainer.max_epochs = 1
    cfg.trainer.monitor = "val/ndcg@100"
    cfg.optimizer2 = JaxOptimizerConfig(**MUON)
    cfg.scheduler2 = JaxSchedulerConfig(kind="plateau")
    return JaxTrainer(cfg), out / "out" / "synthetic-smoke"


def test_jax_fit_is_silent_when_the_monitored_metric_is_not_computed(jax_trainer):
    """The JAX package's fault, shown: its fit runs, computes the metrics, and
    writes no best checkpoint, steps no controller."""
    trainer, out = jax_trainer
    results = trainer.fit()
    assert "ndcg@10" in results and "ndcg@100" not in results
    assert trainer.ckpt.best_path is None
    assert not list((out / "checkpoints").glob("best*"))
    assert trainer.lr2_ctrl.best is None and trainer.lr1_ctrl.best is None
