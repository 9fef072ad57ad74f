"""The lazy (sparse-row) AdamW of the item table in the PyTorch port against
the JAX package's train/lazy_embedding.py, on the CPU, padded and packed.

Both packages get the same weights, batches and shared negatives: the
negatives are the tail of the JAX package's own `ids_fn` at each step
(`fold_in(rng, step)`), handed to the port as catalog offsets. Dropout is
off. After three steps the table, the packed moments `mv`, the step count
and every other parameter are held at rtol 5e-4 / atol 1e-6; rows that no
step touched are held bit for bit to their initial values, with zero
moments. The applicability errors are JAX's, word for word. A trainer
stopped after its first epoch and resumed gives the losses and `mv` of the
run that went on.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.configs.presets import get_preset as jax_preset
from mygenerativerecommenders_tpu.train import lazy_embedding as jax_lazy
from mygenerativerecommenders_tpu.train import task_retrieval as jax_task
from mygenerativerecommenders_tpu_torch.checkpoint import grads_to_state_dict, params_to_state_dict
from mygenerativerecommenders_tpu_torch.cli import train as cli_train
from mygenerativerecommenders_tpu_torch.configs.presets import get_preset as pt_preset
from mygenerativerecommenders_tpu_torch.train import lazy_embedding as pt_lazy
from mygenerativerecommenders_tpu_torch.train import task_retrieval as pt_task
from mygenerativerecommenders_tpu_torch.train.driver import Trainer
from mygenerativerecommenders_tpu_torch.train.optimizers import build_optimizer
from tests.test_torch_port_packing_model import _setup as _packed_setup
from tests.test_torch_port_train_step import _np_tree, _setup, _torch_batch
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL, ATOL = 5e-4, 1e-6
TABLE = pt_lazy.TABLE_KEY


def _lazy(cfgs):
    for cfg in cfgs:
        cfg.model.loss.shared_negatives = True
        cfg.model.embedding.lazy_update = True


def _both(packed):
    """(jcfg, pcfg, jmodel, params, pmodel, item_ids, three batches)."""
    if packed:
        jcfg, pcfg, jmodel, params, pmodel, data, train, _ = _packed_setup()
        item_ids, batches = data.all_item_ids, train[:3]
    else:
        jcfg, pcfg, jmodel, params, pmodel, item_ids, batches = _setup()
        batches = [batches[0], batches[1], batches[0]]
    _lazy((jcfg, pcfg))
    return jcfg, pcfg, jmodel, params, pmodel, item_ids, batches


def _offsets_of(ids_all, item_ids, r):
    """The catalog offsets of the R shared negatives that end `ids_all`."""
    return torch.from_numpy(np.searchsorted(item_ids, ids_all[-r:]).astype(np.int32))


@pytest.mark.parametrize(
    "path,value,word",
    [
        ("model.loss.shared_negatives", False, "shared_negatives"),
        ("model.sampler.kind", "in_batch", "sampler.kind"),
        ("model.similarity.kind", "mol", "similarity.kind"),
        ("model.embedding.kind", "item_year", "embedding.kind"),
        ("optimizer1.kind", "sgd", "adamw"),
    ],
)
def test_applicability_errors_are_the_jax_packages(path, value, word):
    cfgs = [jax_preset("synthetic-smoke"), pt_preset("synthetic-smoke")]
    _lazy(cfgs)
    assert all(m.lazy_applicable(c) for m, c in zip((jax_lazy, pt_lazy), cfgs))
    messages = []
    for module, cfg in zip((jax_lazy, pt_lazy), cfgs):
        obj = cfg
        *parents, leaf = path.split(".")
        for p in parents:
            obj = getattr(obj, p)
        setattr(obj, leaf, value)
        assert not module.lazy_applicable(cfg, raise_on_error=False)
        with pytest.raises(ValueError, match=word) as err:
            module.lazy_applicable(cfg)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("packed", [False, True])
def test_ids_loss_and_factored_gradients_match_jax(packed):
    jcfg, pcfg, jmodel, params, pmodel, item_ids, batches = _both(packed)
    batch = batches[0]
    key = jax.random.PRNGKey(5)
    dev_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    j_ids_fn, j_loss_rows = jax_lazy.make_lazy_parts(jmodel, jcfg, item_ids, packed=packed)
    table, rest = jax_lazy.split_table(params)
    touched = j_ids_fn(dev_batch, key)
    rows = jnp.take(table, touched, axis=0)
    want, (g_rest, g_rows) = jax.value_and_grad(
        lambda rr: j_loss_rows(rr[0], rr[1], dev_batch, key))((rest, rows))

    ids_fn, loss_rows_fn, shape, _ = pt_lazy.make_lazy_parts(pmodel, pcfg, item_ids, packed)
    offsets = _offsets_of(np.asarray(touched), item_ids, pcfg.model.loss.num_to_sample)
    assert shape(_torch_batch(batch)) == tuple(offsets.shape)
    got_ids = ids_fn(_torch_batch(batch), offsets)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(touched))
    prows = pmodel.state_dict()[TABLE][got_ids].requires_grad_()
    loss = loss_rows_fn(prows, _torch_batch(batch), offsets)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(prows.grad.numpy(), np.asarray(g_rows), rtol=RTOL, atol=ATOL)
    # the loss of the rows is the shared-negatives loss of the table
    shared = pt_task.make_loss_fn(pmodel, pcfg, item_ids, packed=packed)
    assert shared.variant == "shared"
    np.testing.assert_allclose(shared(_torch_batch(batch), neg_offsets=offsets).item(),
                               loss.item(), rtol=1e-6)
    grads = {n: p.grad for n, p in pmodel.named_parameters() if p.grad is not None}
    want_rest = grads_to_state_dict(_np_tree(g_rest))
    assert set(grads) == set(want_rest) and TABLE not in grads
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_rest[name].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("packed", [False, True])
def test_three_lazy_steps_match_jax(packed):
    jcfg, pcfg, jmodel, params, pmodel, item_ids, batches = _both(packed)
    rng, lr = jax.random.PRNGKey(11), jcfg.optimizer1.lr
    r = pcfg.model.loss.num_to_sample
    j_ids_fn, _ = jax_lazy.make_lazy_parts(jmodel, jcfg, item_ids, packed=packed)
    jstep = jax_task.make_train_step(jmodel, jcfg, item_ids, packed=packed)
    jstate = jax_lazy.init_lazy_opt_state(jcfg, params)
    optimizer = pt_lazy.init_lazy_optimizer(pcfg, pmodel)
    pstep = pt_task.make_train_step(pmodel, pcfg, item_ids, optimizer, packed=packed)
    before = copy.deepcopy(pmodel.state_dict())
    touched = set()
    jparams = jax.tree.map(jnp.copy, params)
    for step, batch in enumerate(batches):
        dev_batch = {k: jnp.asarray(v) for k, v in batch.items()}
        ids_all = np.asarray(j_ids_fn(dev_batch, jax.random.fold_in(rng, step)))
        touched |= set(ids_all.tolist())
        out = jstep(jparams, jstate, dev_batch, rng, lr, lr, step)
        jparams, jstate = out.params, out.opt_state
        loss = pstep(_torch_batch(batch), lr, neg_offsets=_offsets_of(ids_all, item_ids, r))
        np.testing.assert_allclose(loss.item(), float(out.loss), rtol=1e-4)
    assert int(optimizer.count) == int(jstate.table.count) == 3
    np.testing.assert_allclose(optimizer.mv.numpy(), np.asarray(jstate.table.mv), rtol=RTOL,
                               atol=ATOL)
    want = params_to_state_dict(_np_tree(jparams))
    after = pmodel.state_dict()
    for name, p in after.items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    rows = np.asarray(sorted(touched))
    untouched = np.setdiff1d(np.arange(after[TABLE].shape[0]), rows)
    assert untouched.size > 0 and 0 in rows  # padding is a touched row, as in JAX
    np.testing.assert_array_equal(after[TABLE][untouched].numpy(),
                                  before[TABLE][untouched].numpy())
    assert not optimizer.mv[untouched].any()
    assert (after[TABLE][rows[1:]] != before[TABLE][rows[1:]]).any(dim=1).all()


def test_duplicate_ids_sum_their_gradients_and_unused_slots_change_nothing():
    """The static-shape dedup against torch's dense AdamW step on the touched
    rows: a row looked up three times takes the sum of its three gradients
    once. The two order their float32 operations differently (torch decays
    p first and divides by the bias corrections apart): rtol 1e-5 / atol 1e-6."""
    torch.manual_seed(0)
    v, d = 12, 4
    table = torch.randn(v, d)
    table[3] = -0.0  # a row of negative zeros: an add of -0.0 keeps their sign
    ids = torch.tensor([5, 2, 5, 9, 5, 2, 0])
    grads = torch.randn(len(ids), d)
    got = table.clone()
    mv = torch.zeros(v + 1, 2 * d)
    count = torch.zeros((), dtype=torch.int64)
    pt_lazy.lazy_adamw_update(got, mv, count, ids, grads, 0.1, (0.9, 0.999), 1e-8, 0.01)
    dense = torch.zeros(v, d).index_add_(0, ids, grads)
    want = table.clone().requires_grad_()
    opt = torch.optim.AdamW([want], lr=0.1, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    want.grad = dense
    opt.step()
    rows = torch.tensor([0, 2, 5, 9])
    np.testing.assert_allclose(got[rows].numpy(), want.detach()[rows].numpy(), rtol=1e-5,
                               atol=1e-6)
    others = torch.tensor([i for i in range(v) if i not in rows.tolist()])
    assert torch.equal(got[others].view(torch.int32), table[others].view(torch.int32))
    np.testing.assert_allclose(mv[rows, :d].numpy(), (0.1 * dense[rows]).numpy(), rtol=1e-6)
    assert not mv[others].any() and not mv[v].any()  # the scratch row stays zero
    assert int(count) == 1


def test_the_lazy_step_wants_the_lazy_optimizer():
    _, pcfg, _, _, pmodel, item_ids, _ = _both(False)
    plain = build_optimizer(pcfg.optimizer1, None, pmodel.parameters(), 1e-3)
    with pytest.raises(ValueError, match="init_lazy_optimizer"):
        pt_task.make_train_step(pmodel, pcfg, item_ids, plain)
    optimizer = pt_lazy.init_lazy_optimizer(pcfg, pmodel)
    table = dict(pmodel.named_parameters())[TABLE]
    assert all(p is not table for g in optimizer.param_groups for p in g["params"])
    with pytest.raises(RuntimeError, match="no table rows"):
        optimizer.step()


def _args(tmp_path, *extra):
    return [
        "experiment=synthetic-smoke", "trainer.device=cpu", "trainer.log_every_n_steps=1",
        "model.loss.shared_negatives=true", "model.embedding.lazy_update=true",
        f"trainer.output_dir={tmp_path / 'out'}", *extra,
    ]


@pytest.mark.parametrize("k", [1, 2])
def test_resume_with_the_lazy_update_gives_the_uninterrupted_run(tmp_path, k):
    """Epoch 0's checkpoint (with `mv` and the count) resumed for epoch 1
    gives the losses and the moments of the run that went on."""

    def epoch_losses(out, epoch):
        path = out / "out" / "synthetic-smoke" / "metrics.jsonl"
        rows = [json.loads(line) for line in path.read_text().splitlines()]
        return [r["train/loss"] for r in rows if "train/loss" in r and r["epoch"] == epoch]

    extra = (f"trainer.steps_per_call={k}",)
    whole = Trainer(cli_train.parse_args(_args(tmp_path / "whole", *extra, "trainer.max_epochs=2")))
    assert isinstance(whole.optimizer, pt_lazy.LazyEmbeddingAdamW)
    steps = len(whole.data.loader("train"))
    whole.fit()
    Trainer(cli_train.parse_args(_args(tmp_path / "cut", *extra, "trainer.max_epochs=1"))).fit()
    last = tmp_path / "cut" / "out" / "synthetic-smoke" / "checkpoints" / "last.pt"
    saved = torch.load(last, weights_only=True)["optimizer"]
    assert int(saved["count"]) == steps and saved["mv"].any()
    resumed = Trainer(cli_train.parse_args(_args(
        tmp_path / "cut", *extra, "trainer.max_epochs=2", f"trainer.ckpt_path={last}"
    )))
    resumed.fit()
    want, got = epoch_losses(tmp_path / "whole", 1), epoch_losses(tmp_path / "cut", 1)
    assert len(got) == len(want) == -(-steps // k)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert int(resumed.optimizer.count) == int(whole.optimizer.count) == 2 * steps
    np.testing.assert_allclose(resumed.optimizer.mv.numpy(), whole.optimizer.mv.numpy(),
                               rtol=1e-5, atol=1e-7)
