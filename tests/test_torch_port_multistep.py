"""Several steps a call (`trainer.steps_per_call`) in the PyTorch port, on the
CPU, against one step a call and against the JAX package.

On the CPU the k-step call and the k-batch eval run their steps eagerly (the
CUDA graphs of train/graphs.py are the card's; tests/test_torch_port_gpu.py
holds them to the eager step there), so a call of k steps must give what k
calls of one step give, and the trainer's k-step epoch (the JAX package's
`_train_epoch_multi`, mirrored by tests/test_multistep.py) must count the
same steps and examples and reach the same parameters. The plain versions'
`index_add_` / `scatter_reduce` sums run on several CPU threads, so two runs
of the same epoch differ by a few float32 ulps: parameters are held at atol
1e-6 (a step moves them by ~1e-3).

The AdamW with a tensor learning rate (the card's optimizer) is held to
`optax.adamw` after three steps at the tolerances of
tests/test_torch_port_train_step.py, built fused and unfused: the CPU's
PyTorch has a fused AdamW too.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.configs import resolve as jax_resolve
from mygenerativerecommenders_tpu.configs.presets import get_preset as jax_preset
from mygenerativerecommenders_tpu.models.model import build_model as jax_build_model
from mygenerativerecommenders_tpu.train import task_retrieval as jax_task
from mygenerativerecommenders_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from mygenerativerecommenders_tpu.utils.features import seq_features_from_batch as jax_features
from mygenerativerecommenders_tpu_torch.checkpoint import params_to_state_dict
from mygenerativerecommenders_tpu_torch.cli import train as cli_train
from mygenerativerecommenders_tpu_torch.configs import resolve as pt_resolve
from mygenerativerecommenders_tpu_torch.configs.presets import get_preset as pt_preset
from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
from mygenerativerecommenders_tpu_torch.models.model import build_model as pt_build_model
from mygenerativerecommenders_tpu_torch.parallel import ring_attention
from mygenerativerecommenders_tpu_torch.train import graphs
from mygenerativerecommenders_tpu_torch.train import task_retrieval as pt_task
from mygenerativerecommenders_tpu_torch.train.driver import Trainer
from mygenerativerecommenders_tpu_torch.train.optimizers import (
    build_optimizer,
    load_optimizer_state,
    set_lr,
)
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _args(tmp_path, *extra):
    return [
        "experiment=synthetic-smoke", "trainer.device=cpu",
        f"trainer.output_dir={tmp_path / 'out'}", *extra,
    ]


def _packed(packed):
    return ["data.pack_sequences=true", "data.pack_eval=true"] if packed else []


def _max_diff(a: torch.nn.Module, b: torch.nn.Module) -> float:
    return max(float((p - q).detach().abs().max()) for p, q in zip(a.parameters(), b.parameters()))


@pytest.mark.parametrize("packed", [False, True])
def test_train_steps_give_the_losses_and_parameters_of_single_steps(tmp_path, packed):
    """A call of 3 steps against 3 calls of one, the same weights, batches,
    dropout stream and injected negatives."""
    trainer = Trainer(cli_train.parse_args(_args(tmp_path, *_packed(packed))))
    batches = [trainer._put(b) for _, b in zip(range(3), trainer._loader("train", packed))]
    cfg, ids = trainer.cfg, trainer.all_item_ids
    gen = torch.Generator().manual_seed(5)
    offsets = []
    for b in batches:
        rows, cols = b["ids"].shape
        n = cols - 1 + (0 if packed else cfg.model.gr_output_length + 1)
        offsets.append(torch.randint(0, len(ids), (rows, n, cfg.model.loss.num_to_sample),
                                     generator=gen, dtype=torch.int32))
    results = []
    for steps in (1, 3):
        model = pt_build_model(cfg, device="cpu", seed=3)
        model.train()
        opt = build_optimizer(cfg.optimizer1, None, model.parameters(), cfg.optimizer1.lr)
        step = pt_task.make_train_step(model, cfg, ids, opt, steps=steps, packed=packed)
        torch.manual_seed(1)  # dropout
        if steps == 1:
            losses = torch.stack([step(b, 1e-3, neg_offsets=o) for b, o in zip(batches, offsets)])
        else:
            assert step.graphs is None  # eager on the CPU
            losses = step(batches, 1e-3, neg_offsets=offsets)
        results.append((losses, model))
    (single, m1), (multi, m3) = results
    assert multi.shape == (3,)
    np.testing.assert_allclose(multi.numpy(), single.numpy(), rtol=1e-6)
    assert _max_diff(m1, m3) <= 1e-6


def test_train_steps_refuse_more_batches_than_steps(tmp_path):
    trainer = Trainer(cli_train.parse_args(_args(tmp_path, "trainer.steps_per_call=2")))
    batches = [trainer._put(b) for _, b in zip(range(3), trainer.data.loader("train"))]
    with pytest.raises(ValueError, match="up to 2"):
        trainer.train_steps(batches, trainer.lr1)
    assert trainer.train_steps(batches[:1], trainer.lr1).shape == (1,)


@pytest.mark.parametrize("packed", [False, True])
def test_trainer_epoch_in_calls_of_two_matches_single_steps(tmp_path, packed):
    """An epoch of 7 (padded) or 9 (packed) steps, an odd remainder for
    steps_per_call=2: the same optimizer steps, examples and parameters as
    one step a call (tests/test_multistep.py's driver tests)."""
    trainers = []
    for k in (1, 2):
        trainer = Trainer(cli_train.parse_args(_args(
            tmp_path / str(k), *_packed(packed), f"trainer.steps_per_call={k}",
            "trainer.limit_train_batches=0.9", "trainer.log_every_n_steps=3",
        )))
        loss = trainer.train_epoch(trainer._loader("train", packed=packed))
        assert np.isfinite(loss)
        trainers.append((trainer, loss))
    (one, loss1), (two, loss2) = trainers
    assert two.train_steps is not None and one.train_steps is None
    assert two.global_step == one.global_step == (9 if packed else 7)
    assert two.epoch_examples == one.epoch_examples > 0
    np.testing.assert_allclose(loss2, loss1, rtol=1e-5)
    assert _max_diff(one.model, two.model) <= 1e-6
    # a loss is logged for each log_every_n_steps boundary: for k=2 at the
    # end of the call that crosses it
    logged = []
    for k in (1, 2):
        path = tmp_path / str(k) / "out" / "synthetic-smoke" / "metrics.jsonl"
        rows = [json.loads(line) for line in path.read_text().splitlines()]
        logged.append([r["step"] for r in rows if "train/loss" in r])
    assert logged[0] == [3, 6, 9][: len(logged[0])] and len(logged[1]) == len(logged[0])
    assert all(0 <= b - a < 2 for a, b in zip(*logged))


@pytest.mark.parametrize("packed", [False, True])
def test_eval_epoch_in_calls_of_three_gives_the_single_batch_metrics(tmp_path, packed):
    """eval_epoch at steps_per_call=3 (8 batches: two calls of 3, then a
    remainder of one-batch calls) against one batch a call."""
    results = []
    for k in (1, 3):
        trainer = Trainer(cli_train.parse_args(_args(
            tmp_path / str(k), *_packed(packed), f"trainer.steps_per_call={k}"
        )))
        loader = trainer._loader("val", packed=trainer._eval_packed)
        assert trainer._eval_packed == packed
        results.append(trainer.eval_epoch(loader))
    base, batched = results
    assert base.keys() == batched.keys()
    for key in base:
        np.testing.assert_allclose(batched[key], base[key], rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("packed", [False, True])
def test_eval_steps_stack_the_single_batch_results(tmp_path, packed):
    trainer = Trainer(cli_train.parse_args(_args(
        tmp_path, *_packed(packed), "trainer.steps_per_call=3"
    )))
    trainer.model.eval()
    loader = trainer._loader("val", packed=packed)
    batches = [trainer._put(b) for _, b in zip(range(3), loader)]
    single = trainer.packed_eval_step if packed else trainer.eval_step
    many = trainer.packed_eval_steps if packed else trainer.eval_steps
    candidates = trainer.candidate_fn()
    with torch.no_grad():
        got = many(batches, candidates)
        want = [single(b, candidates) for b in batches]
    assert len(got) == len(want[0]) == (4 if packed else 2)
    for i, parts in enumerate(want):
        for g, w in zip(got, parts):
            assert torch.equal(g[i], w)


def test_stacked_batches_keep_the_loader_order_and_flush_at_shape_changes(tmp_path):
    """Length buckets change the batch shape; every chunk of k holds one
    shape, and the batches come in the loader's order
    (test_multistep.py::test_driver_multi_matches_single_examples)."""
    trainer = Trainer(cli_train.parse_args(_args(tmp_path, "data.length_buckets=[8,16,32]")))
    loader = trainer.data.loader("train")
    want = [b["target_id"].copy() for b in loader]
    shapes = {b["ids"].shape for b in trainer.data.loader("train")}
    assert len(shapes) > 1
    got = []
    again = trainer.data.loader("train")
    for host, dev, n_steps in trainer._stacked_batches(again, len(again), 3):
        assert n_steps in (1, 3) and len(host) == len(dev) == n_steps
        assert len({h["ids"].shape for h in host}) == 1
        for h, d in zip(host, dev):
            np.testing.assert_array_equal(d["ids"].numpy(), h["ids"])
        got.extend(h["target_id"] for h in host)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetching_batches_come_in_order_with_their_device_copies(tmp_path, depth):
    trainer = Trainer(cli_train.parse_args(_args(tmp_path, f"trainer.prefetch={depth}")))
    want = list(trainer.data.loader("val"))
    got = list(trainer._batches(trainer.data.loader("val"), 5))
    assert len(got) == 5
    for (host, dev), ref in zip(got, want):
        for key, value in ref.items():
            np.testing.assert_array_equal(host[key], value)
            np.testing.assert_array_equal(dev[key].numpy(), value)


def test_the_graph_counters_name_every_kernel_wrappers_count():
    for module, name in graphs._COUNTERS:
        assert isinstance(getattr(module, name), int), (module.__name__, name)
    kinds = {name for _, name in graphs._COUNTERS}
    assert kinds == {"launches", "bwd_launches", "fused_launches", "fused_bwd_launches"}


def test_the_zigzag_index_is_made_once_per_shape_and_device():
    a = ring_attention._zigzag_index(4, 40, torch.device("cpu"))
    b = ring_attention._zigzag_index(4, 40, torch.device("cpu"))
    assert a[0] is b[0] and a[1] is b[1]
    order = ring_attention.zigzag_order(4, 40)
    np.testing.assert_array_equal(a[0].numpy(), order)
    np.testing.assert_array_equal(a[0][a[1]].numpy(), np.arange(40))


def test_set_lr_fills_a_tensor_rate_in_place_and_assigns_a_float():
    p = torch.nn.Parameter(torch.zeros(3))
    fused = build_optimizer(pt_preset("synthetic-smoke").optimizer1, None, [p], 1e-3, fused=True)
    rate = fused.param_groups[0]["lr"]
    assert isinstance(rate, torch.Tensor) and rate.shape == (1,) and rate.dtype == torch.float32
    set_lr(fused, 5e-4)
    assert fused.param_groups[0]["lr"] is rate and float(rate) == pytest.approx(5e-4)
    plain = build_optimizer(pt_preset("synthetic-smoke").optimizer1, None, [p], 1e-3)
    set_lr(plain, 5e-4)
    assert plain.param_groups[0]["lr"] == 5e-4


def test_optimizer_state_loads_across_fused_and_plain_keeping_its_own_rate():
    """A checkpoint of the plain optimizer (float rate, host step counts)
    into a fused one, and back: each keeps its own rate object and flags,
    takes the checkpoint's rate and moments, and steps on as the writer
    would have."""
    cfg = pt_preset("synthetic-smoke").optimizer1

    def stepped(fused):
        torch.manual_seed(0)
        p = torch.nn.Parameter(torch.randn(6))
        opt = build_optimizer(cfg, None, [p], 1e-3, fused=fused)
        for _ in range(2):
            p.grad = torch.randn(6)
            opt.step()
        set_lr(opt, 7e-4)
        return p, opt

    for src, dst in ((False, True), (True, False)):
        p_src, opt_src = stepped(src)
        state = copy.deepcopy(opt_src.state_dict())
        p_dst = torch.nn.Parameter(p_src.detach().clone())
        opt_dst = build_optimizer(cfg, None, [p_dst], 1e-3, fused=dst)
        own = opt_dst.param_groups[0]["lr"]
        load_optimizer_state(opt_dst, state)
        group = opt_dst.param_groups[0]
        assert group["lr"] is own if dst else group["lr"] == pytest.approx(7e-4)
        assert float(group["lr"]) == pytest.approx(7e-4)
        assert bool(group.get("fused")) == dst
        grad = torch.randn(6)
        p_src.grad, p_dst.grad = grad, grad.clone()
        opt_src.step()
        opt_dst.step()
        np.testing.assert_allclose(p_dst.detach().numpy(), p_src.detach().numpy(),
                                   rtol=0, atol=1e-7)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("fused", [False, True])
def test_adamw_with_a_tensor_lr_matches_optax_after_three_steps(fused):
    """tests/test_torch_port_train_step.py's three AdamW steps against JAX,
    with the learning rate a tensor set in place by `set_lr`."""
    jcfg, pcfg = jax_preset("synthetic-smoke"), pt_preset("synthetic-smoke")
    jcfg.model.encoder.use_pallas = "false"
    for cfg in (jcfg, pcfg):
        cfg.model.preprocessor.dropout_rate = cfg.model.encoder.linear_dropout_rate = 0.0
    data = RecoData(pcfg.data, seed=42)
    jax_resolve(jcfg, data.max_item_id)
    pt_resolve(pcfg, data.max_item_id)
    batches = [b for _, b in zip(range(2), data.loader("train"))]
    item_ids = data.all_item_ids
    jmodel = jax_build_model(jcfg)
    seq, _, _ = jax_features(batches[0], jcfg.model.gr_output_length + 1)
    key = jax.random.PRNGKey(0)
    params = jmodel.init({"params": key, "dropout": key}, seq, method=jmodel.init_all)
    pmodel = pt_build_model(pcfg, device="cpu")
    pmodel.load_state_dict(params_to_state_dict(_np_tree(params)))

    rng, lr = jax.random.PRNGKey(11), jcfg.optimizer1.lr
    jstep = jax_task.make_train_step(jmodel, jcfg, item_ids)
    opt_state = jax_build_optimizer(jcfg.optimizer1, None, params, lr, lr).init(params)
    optimizer = build_optimizer(pcfg.optimizer1, None, pmodel.parameters(), 0.5, fused=fused)
    assert isinstance(optimizer.param_groups[0]["lr"], torch.Tensor) == fused
    pstep = pt_task.make_train_step(pmodel, pcfg, item_ids, optimizer)
    jparams = params
    for step in range(3):
        batch = batches[step % 2]
        out = jstep(jparams, opt_state, {k: jnp.asarray(v) for k, v in batch.items()},
                    rng, lr, lr, step)
        jparams, opt_state = out.params, out.opt_state
        _, neg_rng = jax.random.split(jax.random.fold_in(rng, step))
        n = batch["ids"].shape[1] + jcfg.model.gr_output_length + 1
        shape = (batch["ids"].shape[0], n - 1, jcfg.model.loss.num_to_sample)
        offsets = torch.from_numpy(np.array(jax.random.randint(neg_rng, shape, 0, len(item_ids))))
        loss = pstep({k: torch.from_numpy(v) for k, v in batch.items()}, lr, neg_offsets=offsets)
        np.testing.assert_allclose(loss.item(), float(out.loss), rtol=1e-4)
    want = params_to_state_dict(_np_tree(jparams))
    for name, p in pmodel.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=2e-5, err_msg=name)


def test_resume_in_calls_of_two_gives_the_uninterrupted_next_epoch_losses(tmp_path):
    """The checkpoint of epoch 0 resumed for epoch 1 (the generators' states,
    the optimizer's, and the loader's shuffle of epoch 1) gives the losses of
    a run that went on."""

    def epoch_losses(out, epoch):
        path = out / "out" / "synthetic-smoke" / "metrics.jsonl"
        rows = [json.loads(line) for line in path.read_text().splitlines()]
        return [r["train/loss"] for r in rows if "train/loss" in r and r["epoch"] == epoch]

    extra = ("trainer.steps_per_call=2", "trainer.log_every_n_steps=1")
    Trainer(cli_train.parse_args(_args(tmp_path / "whole", *extra, "trainer.max_epochs=2"))).fit()
    Trainer(cli_train.parse_args(_args(tmp_path / "cut", *extra, "trainer.max_epochs=1"))).fit()
    last = tmp_path / "cut" / "out" / "synthetic-smoke" / "checkpoints" / "last.pt"
    resumed = Trainer(cli_train.parse_args(_args(
        tmp_path / "cut", *extra, "trainer.max_epochs=2", f"trainer.ckpt_path={last}"
    )))
    resumed.fit()
    want, got = epoch_losses(tmp_path / "whole", 1), epoch_losses(tmp_path / "cut", 1)
    assert len(got) == len(want) == 4  # one loss a call of two steps
    np.testing.assert_allclose(got, want, rtol=1e-5)
