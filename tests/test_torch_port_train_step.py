"""The training path as a whole: one loss, its gradients and three AdamW
steps of the PyTorch port against the JAX package, on the CPU.

Both packages get the same weights (`params_to_state_dict`), the same batch
and the same negatives: torch cannot replay `jax.random`, so the test makes
the JAX package's own draw (`fold_in(rng, step)`, `split`, `randint(neg_rng)`,
train/task_retrieval.py:173, 266, 357) and injects it into the port. Dropout
rates are 0 on both sides. The JAX loss runs its jnp path
(`encoder.use_pallas=false`), which that package's tests hold to its Pallas
kernels; the port's kernels' plain versions are held to those kernels in
tests/test_torch_port_train_kernels.py.

Tolerances: the loss at rtol 1e-5; every parameter's gradient at rtol 2e-4 /
atol 2e-6 (the JAX package's own dense-vs-per-sample test's); the parameters
after three AdamW steps at atol 2e-5 against a movement of up to 3e-3 a
parameter (Adam divides by sqrt(v): where a gradient is float32 noise around
zero its sign, and with it the step, is not determined).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.configs.presets import get_preset as jax_preset
from mygenerativerecommenders_tpu.configs import resolve as jax_resolve
from mygenerativerecommenders_tpu.models.model import build_model as jax_build_model
from mygenerativerecommenders_tpu.train import task_retrieval as jax_task
from mygenerativerecommenders_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from mygenerativerecommenders_tpu.utils.features import seq_features_from_batch as jax_features
from mygenerativerecommenders_tpu_torch.checkpoint import (
    grads_to_state_dict,
    params_to_state_dict,
)
from mygenerativerecommenders_tpu_torch.configs import resolve as pt_resolve
from mygenerativerecommenders_tpu_torch.configs.presets import get_preset as pt_preset
from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
from mygenerativerecommenders_tpu_torch.models.model import build_model as pt_build_model
from mygenerativerecommenders_tpu_torch.train import task_retrieval as pt_task
from mygenerativerecommenders_tpu_torch.train.optimizers import build_optimizer as pt_build_optimizer


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(dropout=0.0, heads=1):
    """Both packages' synthetic-smoke model (2 blocks, D=16, N=43, X=200,
    R=16) with the JAX weights carried into the port, and two train batches."""
    jcfg, pcfg = jax_preset("synthetic-smoke"), pt_preset("synthetic-smoke")
    jcfg.model.encoder.use_pallas = "false"
    for cfg in (jcfg, pcfg):
        cfg.model.preprocessor.dropout_rate = dropout
        cfg.model.encoder.linear_dropout_rate = dropout
        cfg.model.encoder.num_heads = heads
        cfg.model.encoder.attention_dim = cfg.model.encoder.linear_dim = 16 // heads
    data = RecoData(pcfg.data, seed=42)  # held to the JAX data in test_torch_port_train_data.py
    jax_resolve(jcfg, data.max_item_id)
    pt_resolve(pcfg, data.max_item_id)
    batches = [b for _, b in zip(range(2), data.loader("train"))]
    jmodel = jax_build_model(jcfg)
    seq, _, _ = jax_features(batches[0], jcfg.model.gr_output_length + 1)
    key = jax.random.PRNGKey(0)
    params = jmodel.init({"params": key, "dropout": key}, seq, method=jmodel.init_all)
    pmodel = pt_build_model(pcfg, device="cpu")
    pmodel.load_state_dict(params_to_state_dict(_np_tree(params)))
    return jcfg, pcfg, jmodel, params, pmodel, data.all_item_ids, batches


def _jax_neg_offsets(rng, step, batch, cfg, num_catalog):
    """The offsets `loss_fn_dense` draws at this step."""
    _, neg_rng = jax.random.split(jax.random.fold_in(rng, step))
    b, n = batch["ids"].shape[0], batch["ids"].shape[1] + cfg.model.gr_output_length + 1
    shape = (b, n - 1, cfg.model.loss.num_to_sample)
    return np.array(jax.random.randint(neg_rng, shape, 0, num_catalog))


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("heads", [1, 2])
def test_loss_and_every_gradient_match_jax(heads):
    jcfg, pcfg, jmodel, params, pmodel, item_ids, batches = _setup(heads=heads)
    rng = jax.random.PRNGKey(7)
    jloss = jax_task.make_loss_fn(jmodel, jcfg, item_ids)
    assert jloss.__name__ == "loss_fn_dense"
    dev_batch = {k: jnp.asarray(v) for k, v in batches[0].items()}
    want, want_grads = jax.value_and_grad(jloss)(params, dev_batch, jax.random.fold_in(rng, 0))
    want_grads = grads_to_state_dict(_np_tree(want_grads))

    ploss = pt_task.make_loss_fn(pmodel, pcfg, item_ids)
    offsets = torch.from_numpy(_jax_neg_offsets(rng, 0, batches[0], jcfg, len(item_ids)))
    loss = ploss(_torch_batch(batches[0]), neg_offsets=offsets)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    named = dict(pmodel.named_parameters())
    assert named.keys() == want_grads.keys()
    for name, p in named.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(
            p.grad.numpy(), want_grads[name].numpy(), rtol=2e-4, atol=2e-6, err_msg=name
        )


def test_parameters_after_three_adamw_steps_match_jax():
    jcfg, pcfg, jmodel, params, pmodel, item_ids, batches = _setup()
    rng = jax.random.PRNGKey(11)
    lr = jcfg.optimizer1.lr
    jstep = jax_task.make_train_step(jmodel, jcfg, item_ids)
    opt_state = jax_build_optimizer(jcfg.optimizer1, None, params, lr, lr).init(params)
    optimizer = pt_build_optimizer(pcfg.optimizer1, pcfg.optimizer2, pmodel.parameters(), lr)
    pstep = pt_task.make_train_step(pmodel, pcfg, item_ids, optimizer)
    before = copy.deepcopy(pmodel.state_dict())
    jparams = params
    for step in range(3):
        batch = batches[step % 2]
        out = jstep(jparams, opt_state, {k: jnp.asarray(v) for k, v in batch.items()},
                    rng, lr, lr, step)
        jparams, opt_state = out.params, out.opt_state
        offsets = torch.from_numpy(_jax_neg_offsets(rng, step, batch, jcfg, len(item_ids)))
        loss = pstep(_torch_batch(batch), lr, neg_offsets=offsets)
        np.testing.assert_allclose(loss.item(), float(out.loss), rtol=1e-4)
    want = params_to_state_dict(_np_tree(jparams))
    moved = 0.0
    for name, p in pmodel.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=2e-5, err_msg=name)
        moved = max(moved, float((p - before[name]).abs().max()))
    assert moved > 1e-3  # the steps did move the parameters


def test_negatives_come_from_the_generator_unless_injected():
    _, pcfg, _, _, pmodel, item_ids, batches = _setup()
    batch = _torch_batch(batches[0])

    def loss_with(seed):
        g = torch.Generator().manual_seed(seed)
        return pt_task.make_loss_fn(pmodel, pcfg, item_ids, generator=g)(batch).item()

    assert loss_with(3) == loss_with(3)
    assert loss_with(3) != loss_with(4)


def test_dropout_follows_the_seed_under_train_mode_and_is_off_in_eval():
    _, pcfg, _, _, pmodel, item_ids, batches = _setup(dropout=0.2)
    batch = _torch_batch(batches[0])
    offsets = torch.randint(0, len(item_ids), (8, 42, 16), generator=torch.Generator().manual_seed(0))
    ploss = pt_task.make_loss_fn(pmodel, pcfg, item_ids)

    def loss_with(seed):
        torch.manual_seed(seed)
        return ploss(batch, neg_offsets=offsets).item()

    pmodel.train()
    assert loss_with(5) == loss_with(5)
    assert loss_with(5) != loss_with(6)
    pmodel.eval()
    assert loss_with(5) == loss_with(6)


def test_ids_to_offsets_maps_catalog_ids_and_marks_the_rest():
    item_ids = RecoData(pt_preset("synthetic-smoke").data).all_item_ids
    ids_to_offsets = pt_task.make_ids_to_offsets(item_ids, torch.device("cpu"))
    missing = sorted(set(range(1, 221)) - set(item_ids.tolist()))[:3]
    ids = torch.tensor([[0, int(item_ids[0]), int(item_ids[-1])], missing], dtype=torch.int32)
    np.testing.assert_array_equal(
        ids_to_offsets(ids).numpy(), [[-1, 0, len(item_ids) - 1], [-1, -1, -1]]
    )


@pytest.mark.parametrize(
    "path,value,item",
    [
        ("model.loss.dense_catalog_negatives", "false", "Training variants"),
        ("model.loss.shared_negatives", True, "Other model families"),
        ("model.loss.kind", "bce", "Other model families"),
        ("model.sampler.kind", "in_batch", "Other model families"),
        ("optimizer1.kind", "muon", "Muon / Scion"),
        ("optimizer2.enabled", True, "Muon / Scion"),
        ("model.encoder.attn_dropout_rate", 0.1, "Training variants"),
    ],
)
def test_unported_training_knobs_raise_naming_the_roadmap_item(path, value, item):
    cfg = pt_preset("synthetic-smoke")
    obj = cfg
    *parents, leaf = path.split(".")
    for p in parents:
        obj = getattr(obj, p)
    setattr(obj, leaf, value)
    pt_resolve(cfg, 220)
    with pytest.raises(NotImplementedError, match=item):
        model = pt_build_model(cfg, device="cpu")
        opt = pt_build_optimizer(cfg.optimizer1, cfg.optimizer2, model.parameters(), 1e-3)
        pt_task.make_train_step(model, cfg, np.arange(1, 201), opt)


def test_steps_per_call_and_packed_raise_in_make_train_step():
    cfg = pt_preset("synthetic-smoke")
    pt_resolve(cfg, 220)
    model = pt_build_model(cfg, device="cpu")
    opt = pt_build_optimizer(cfg.optimizer1, cfg.optimizer2, model.parameters(), 1e-3)
    with pytest.raises(NotImplementedError, match="Training variants"):
        pt_task.make_train_step(model, cfg, np.arange(1, 201), opt, steps=8)
    with pytest.raises(NotImplementedError, match="Packing"):
        pt_task.make_train_step(model, cfg, np.arange(1, 201), opt, packed=True)


def test_sgd_step_matches_optax_sgd_with_momentum():
    jcfg, pcfg, jmodel, params, pmodel, item_ids, batches = _setup()
    for cfg in (jcfg, pcfg):
        cfg.optimizer1.kind = "sgd"
        cfg.optimizer1.momentum = 0.9
    rng, lr = jax.random.PRNGKey(1), 0.05
    jstep = jax_task.make_train_step(jmodel, jcfg, item_ids)
    opt_state = jax_build_optimizer(jcfg.optimizer1, None, params, lr, lr).init(params)
    optimizer = pt_build_optimizer(pcfg.optimizer1, pcfg.optimizer2, pmodel.parameters(), lr)
    pstep = pt_task.make_train_step(pmodel, pcfg, item_ids, optimizer)
    jparams = params
    for step in range(2):
        out = jstep(jparams, opt_state, {k: jnp.asarray(v) for k, v in batches[step].items()},
                    rng, lr, lr, step)
        jparams, opt_state = out.params, out.opt_state
        offsets = torch.from_numpy(_jax_neg_offsets(rng, step, batches[step], jcfg, len(item_ids)))
        pstep(_torch_batch(batches[step]), lr, neg_offsets=offsets)
    want = params_to_state_dict(_np_tree(jparams))
    for name, p in pmodel.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=2e-4, atol=2e-6, err_msg=name)
