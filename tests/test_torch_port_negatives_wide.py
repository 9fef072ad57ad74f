"""More than 255 sampled negatives a row (`loss.num_to_sample` > 255) in the
PyTorch port against the JAX package, on the CPU, from the same numpy inputs.

Above 255 draws a count bin can pass a byte, so `count_offsets` returns int32
there (uint8 at or below), and the lse takes either type; the JAX package
keeps bf16 counts at that setting (ops/dense_negatives.py:88-92), exact up
to 256. The JAX lse runs its jnp path and its Pallas kernels in interpret
mode; the whole training loss runs both packages' synthetic-smoke model at
num_to_sample=256 with the JAX draw injected into the port.

Tolerances are tests/test_torch_port_train_kernels.py's for the lse (value at
rtol 1e-5, gradients at rtol 1e-4 / atol 1e-6) and
tests/test_torch_port_train_step.py's for the loss (rtol 1e-5) and every
parameter's gradient (rtol 2e-4 / atol 2e-6); counts exactly.
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
from mygenerativerecommenders_tpu.ops.dense_negatives import (
    sampled_softmax_dense_neg_lse as jax_dense_neg_lse,
)
from mygenerativerecommenders_tpu.train import task_retrieval as jax_task
from mygenerativerecommenders_tpu.utils.features import seq_features_from_batch as jax_features
from mygenerativerecommenders_tpu_torch.checkpoint import grads_to_state_dict, params_to_state_dict
from mygenerativerecommenders_tpu_torch.configs import resolve as pt_resolve
from mygenerativerecommenders_tpu_torch.configs.presets import get_preset as pt_preset
from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
from mygenerativerecommenders_tpu_torch.models.model import build_model as pt_build_model
from mygenerativerecommenders_tpu_torch.ops.dense_negatives import sampled_softmax_dense_neg_lse
from mygenerativerecommenders_tpu_torch.ops.kernels import count_offsets as count_mod
from mygenerativerecommenders_tpu_torch.ops.kernels import dense_neg_lse as lse_mod
from mygenerativerecommenders_tpu_torch.train import task_retrieval as pt_task
from mygenerativerecommenders_tpu_torch.train.optimizers import build_optimizer as pt_build_optimizer
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _wide_inputs(seed, bt, d, x, r):
    """Queries, a normalized catalog, R draws a row and the positives: row 0
    draws only its positive (all hits), row 1 draws one item R times (a bin
    of R > 255), row 2's positive lies outside the catalog."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(bt, d)).astype(np.float32)
    cat = rng.normal(size=(x, d)).astype(np.float32)
    cat /= np.linalg.norm(cat, axis=-1, keepdims=True)
    offs = rng.integers(0, x, size=(bt, r)).astype(np.int32)
    sup = rng.integers(0, x, size=bt).astype(np.int32)
    sup[0], offs[0] = 5, 5
    sup[1], offs[1] = 9, 3
    sup[2] = -1
    offs[3, : r // 2] = sup[3]  # half the draws are accidental hits
    return q, cat, offs, sup


@pytest.mark.parametrize("r", [16, 255, 256, 300])
def test_count_is_a_byte_up_to_255_draws_and_int32_above(r):
    _, _, offs, sup = _wide_inputs(r, 12, 4, 40, r)
    got = count_mod.count_offsets(torch.tensor(offs), torch.tensor(sup), 40)
    assert got.dtype == (torch.uint8 if r <= 255 else torch.int32)
    want = np.zeros((12, 40), dtype=np.int64)
    for i, row in enumerate(offs):
        for o in row:
            want[i, o] += o != sup[i]
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    assert want[1, 3] == r  # past a byte where r > 255


@pytest.mark.parametrize("use_pallas", [False, True])
def test_wide_lse_value_and_gradients_match_jax(use_pallas):
    bt, d, x, r, tau = 24, 16, 48, 256, 0.05
    q, cat, offs, sup = _wide_inputs(31, bt, d, x, r)
    gl = np.random.default_rng(1).normal(size=(bt,)).astype(np.float32)

    def jax_f(q_, cat_):
        lse = jax_dense_neg_lse(q_, cat_, jnp.asarray(offs), jnp.asarray(sup), tau,
                                use_pallas=use_pallas)
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


def test_int32_and_uint8_counts_give_the_same_lse():
    q, cat, offs, sup = _wide_inputs(7, 20, 8, 30, 200)
    count = count_mod.count_offsets(torch.tensor(offs), torch.tensor(sup), 30)
    assert count.dtype == torch.uint8
    tq = torch.tensor(q)
    narrow = lse_mod.dense_neg_lse(tq, torch.tensor(cat), count, 0.05)
    wide = lse_mod.dense_neg_lse(tq, torch.tensor(cat), count.int(), 0.05)
    torch.testing.assert_close(wide, narrow, rtol=0, atol=0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_training_loss_and_every_gradient_match_jax_at_256_draws():
    """Both packages' synthetic-smoke model (2 blocks, D=16, X=200) at
    loss.num_to_sample=256, one batch, the JAX draw injected into the port;
    then three AdamW steps of the port at that setting."""
    jcfg, pcfg = jax_preset("synthetic-smoke"), pt_preset("synthetic-smoke")
    jcfg.model.encoder.use_pallas = "false"
    for cfg in (jcfg, pcfg):
        cfg.model.loss.num_to_sample = 256
        cfg.model.preprocessor.dropout_rate = 0.0
        cfg.model.encoder.linear_dropout_rate = 0.0
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
    item_ids = data.all_item_ids

    rng = jax.random.PRNGKey(7)
    jloss = jax_task.make_loss_fn(jmodel, jcfg, item_ids)
    dev_batch = {k: jnp.asarray(v) for k, v in batches[0].items()}
    want, want_grads = jax.value_and_grad(jloss)(params, dev_batch, jax.random.fold_in(rng, 0))
    want_grads = grads_to_state_dict(_np_tree(want_grads))
    # the offsets loss_fn_dense draws at step 0 (train/task_retrieval.py of the JAX package)
    _, neg_rng = jax.random.split(jax.random.fold_in(rng, 0))
    b, n = batches[0]["ids"].shape[0], batches[0]["ids"].shape[1] + jcfg.model.gr_output_length + 1
    offsets = np.array(jax.random.randint(neg_rng, (b, n - 1, 256), 0, len(item_ids)))

    batch = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    loss = pt_task.make_loss_fn(pmodel, pcfg, item_ids)(batch, neg_offsets=torch.from_numpy(offsets))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for name, p in pmodel.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), want_grads[name].numpy(), rtol=2e-4, atol=2e-6, err_msg=name
        )

    lr = pcfg.optimizer1.lr
    optimizer = pt_build_optimizer(pcfg.optimizer1, pcfg.optimizer2, pmodel.parameters(), lr)
    step = pt_task.make_train_step(pmodel, pcfg, item_ids, optimizer,
                                   generator=torch.Generator().manual_seed(0))
    losses = [step({k: torch.from_numpy(v) for k, v in batches[i % 2].items()}, lr).item()
              for i in range(3)]
    assert all(np.isfinite(losses))
