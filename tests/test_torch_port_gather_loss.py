"""The per-sample gather loss and the shared-negatives loss of the PyTorch
port against the JAX package's `loss_fn` and `loss_fn_shared`
(train/task_retrieval.py:210-250, :284-312), on the CPU, padded and packed.

Both packages get the same weights (`params_to_state_dict`), batch and
negatives: the test makes the JAX package's own draw (`fold_in`, `split`,
`randint(neg_rng)`) and hands it to the port. Dropout is off. Tolerances: the
loss at rtol 1e-5, every parameter's gradient at rtol 5e-4 / atol 1e-6 (the
float32 sums of the two packages run in different orders; the catalog rows'
gradients gather from up to B*T*R draws). On the same offsets the gather
loss also equals the port's dense-catalog loss, at the JAX package's own
tolerances for that pair (tests/test_dense_negatives.py:50: loss rtol 1e-5,
gradients rtol 2e-4 / atol 2e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.train import task_retrieval as jax_task
from mygenerativerecommenders_tpu_torch.checkpoint import grads_to_state_dict
from mygenerativerecommenders_tpu_torch.configs.presets import get_preset as pt_preset
from mygenerativerecommenders_tpu_torch.train import task_retrieval as pt_task
from tests.test_torch_port_packing_model import _setup as _packed_setup
from tests.test_torch_port_packing_model import _widest
from tests.test_torch_port_train_step import _np_tree, _setup, _torch_batch
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 5e-4, 1e-6


def _set(cfgs, **loss):
    for cfg in cfgs:
        for key, value in loss.items():
            setattr(cfg.model.loss, key, value)


def _jax_offsets(rng, shape, num_catalog, packed):
    """The offsets the JAX losses draw: `split` of the step's key (the
    trainer's `fold_in(rng, step)`; a packed test passes its key as is)."""
    _, neg_rng = jax.random.split(rng if packed else jax.random.fold_in(rng, 0))
    return torch.from_numpy(np.array(jax.random.randint(neg_rng, shape, 0, num_catalog)))


def _compare(jloss, ploss, params, pmodel, batch, offsets, key):
    dev_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, want_grads = jax.value_and_grad(jloss)(params, dev_batch, key)
    want_grads = grads_to_state_dict(_np_tree(want_grads))
    pmodel.zero_grad(set_to_none=True)
    loss = ploss(_torch_batch(batch), neg_offsets=offsets)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    named = dict(pmodel.named_parameters())
    assert named.keys() == want_grads.keys()
    for name, p in named.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(
            p.grad.numpy(), want_grads[name].numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
            err_msg=name,
        )
    return loss.item(), {n: p.grad.clone() for n, p in named.items()}


def _padded(variant, heads=1):
    jcfg, pcfg, jmodel, params, pmodel, item_ids, batches = _setup(heads=heads)
    if variant == "shared":
        _set((jcfg, pcfg), shared_negatives=True)
    else:
        _set((jcfg, pcfg), dense_catalog_negatives="false")
    return jcfg, pcfg, jmodel, params, pmodel, item_ids, batches[0]


def _packed(variant):
    jcfg, pcfg, jmodel, params, pmodel, data, train, _ = _packed_setup()
    if variant == "shared":
        _set((jcfg, pcfg), shared_negatives=True)
    else:
        _set((jcfg, pcfg), dense_catalog_negatives="false")
    return jcfg, pcfg, jmodel, params, pmodel, data.all_item_ids, _widest(train)


def _shape(variant, cfg, batch, packed):
    r = cfg.model.loss.num_to_sample
    if variant == "shared":
        return (r,)
    rows, cols = batch["ids"].shape
    return (rows, cols - 1 + (0 if packed else cfg.model.gr_output_length + 1), r)


@pytest.mark.parametrize("variant,packed,heads", [
    ("gather", False, 1), ("gather", False, 2), ("gather", True, 2),
    ("shared", False, 1), ("shared", True, 2),
])
def test_loss_and_every_gradient_match_jax(variant, packed, heads):
    jcfg, pcfg, jmodel, params, pmodel, item_ids, batch = (
        _packed(variant) if packed else _padded(variant, heads)
    )
    rng = jax.random.PRNGKey(7)
    jloss = jax_task.make_loss_fn(jmodel, jcfg, item_ids, packed=packed)
    assert jloss.__name__ == {"gather": "loss_fn", "shared": "loss_fn_shared"}[variant]
    ploss = pt_task.make_loss_fn(pmodel, pcfg, item_ids, packed=packed)
    assert ploss.variant == variant
    offsets = _jax_offsets(rng, _shape(variant, jcfg, batch, packed), len(item_ids), packed)
    if variant == "gather":  # some accidental hits: the -5e4 replacement runs
        assert bool((pt_task.make_ids_to_offsets(item_ids, torch.device("cpu"))(
            _torch_batch(batch)["ids"])[:, 1:, None] == offsets[:, : batch["ids"].shape[1] - 1]
        ).any())
    key = rng if packed else jax.random.fold_in(rng, 0)
    _compare(jloss, ploss, params, pmodel, batch, offsets, key)


@pytest.mark.parametrize("packed", [False, True])
def test_gather_loss_equals_the_dense_loss_on_the_same_offsets(packed):
    jcfg, pcfg, jmodel, params, pmodel, item_ids, batch = (
        _packed("gather") if packed else _padded("gather")
    )
    offsets = _jax_offsets(jax.random.PRNGKey(3), _shape("gather", pcfg, batch, packed),
                           len(item_ids), packed)
    results = {}
    for mode in ("false", "true"):
        pcfg.model.loss.dense_catalog_negatives = mode
        ploss = pt_task.make_loss_fn(pmodel, pcfg, item_ids, packed=packed)
        assert ploss.variant == {"false": "gather", "true": "dense"}[mode]
        pmodel.zero_grad(set_to_none=True)
        loss = ploss(_torch_batch(batch), neg_offsets=offsets)
        loss.backward()
        results[mode] = loss.item(), {n: p.grad.clone() for n, p in pmodel.named_parameters()}
    (l_gather, g_gather), (l_dense, g_dense) = results["false"], results["true"]
    np.testing.assert_allclose(l_gather, l_dense, rtol=1e-5)
    for name, want in g_dense.items():
        np.testing.assert_allclose(g_gather[name].numpy(), want.numpy(), rtol=2e-4, atol=2e-6,
                                   err_msg=name)


@pytest.mark.parametrize("num_catalog,setting,want", [
    # synthetic-large-vocab: 64 x 211 rows x 10,000,000 items is 45 times the gate
    (10_000_000, "auto", "gather"),
    (10_000_000, "true", "dense"),
    # the same rows at the gate: 64 x 211 x 222,080 <= 3e9 < 64 x 211 x 222,208
    # (the catalog padded to a multiple of 128)
    (222_080, "auto", "dense"),
    (222_081, "auto", "gather"),
    (5_000, "false", "gather"),
])
def test_the_auto_gate_picks_the_gather_loss_past_3e9(num_catalog, setting, want):
    cfg = pt_preset("synthetic-large-vocab")
    cfg.model.loss.dense_catalog_negatives = setting
    assert pt_task.loss_variant(cfg, num_catalog) == want
    cfg.model.loss.shared_negatives = True
    assert pt_task.loss_variant(cfg, num_catalog) == "shared"


def test_the_negatives_draw_their_shape_from_the_generator():
    _, pcfg, _, _, pmodel, item_ids, batch = _padded("shared")
    gen = torch.Generator().manual_seed(5)
    loss_fn, shape, draw = pt_task._loss_parts(pmodel, pcfg, item_ids, False, gen)
    assert shape(_torch_batch(batch)) == (pcfg.model.loss.num_to_sample,)
    first = draw(_torch_batch(batch))
    assert first.dtype == torch.int32 and first.shape == (pcfg.model.loss.num_to_sample,)
    assert 0 <= int(first.min()) and int(first.max()) < len(item_ids)
    torch.manual_seed(0)
    assert np.isfinite(loss_fn(_torch_batch(batch)).item())  # draws its own
    pcfg.model.similarity.kind = "mol"
    with pytest.raises(ValueError, match="shared_negatives requires"):
        pt_task.loss_variant(pcfg, len(item_ids))


def test_sample_offsets_gathers_then_normalizes_the_rows_jax_gathers():
    """JAX's `sample_offsets` normalizes the whole catalog and gathers; the
    port gathers the rows at the offsets and normalizes those: the same
    values (rtol 1e-6), the draw that of `offsets_only`."""
    from mygenerativerecommenders_tpu.models.negatives import LocalNegativesSampler as JaxSampler
    from mygenerativerecommenders_tpu_torch.models.negatives import LocalNegativesSampler

    rng = np.random.default_rng(4)
    table = rng.normal(size=(301, 16)).astype(np.float32)
    catalog = np.sort(rng.choice(np.arange(1, 301), size=200, replace=False))
    positives = np.zeros((3, 7), dtype=np.int32)
    jax_norm = JaxSampler().normalize_embeddings(jnp.asarray(table[catalog]))
    offsets, rows = JaxSampler().sample_offsets(jax.random.PRNGKey(0), jnp.asarray(positives), 5,
                                                jax_norm)
    sampler = LocalNegativesSampler()
    lookup = torch.nn.Embedding.from_pretrained(torch.from_numpy(table))
    cat = torch.from_numpy(catalog)
    got = sampler.rows_at(torch.from_numpy(np.asarray(offsets)), cat, lookup)
    np.testing.assert_allclose(got.numpy(), np.asarray(rows), rtol=1e-6, atol=1e-7)
    drawn, drawn_rows = sampler.sample_offsets(torch.Generator().manual_seed(1), (3, 7), 5, cat,
                                               lookup)
    want = sampler.offsets_only(torch.Generator().manual_seed(1), (3, 7), 5, 200,
                                torch.device("cpu"))
    assert torch.equal(drawn, want) and drawn.shape == (3, 7, 5)
    assert torch.equal(drawn_rows, sampler.rows_at(want, cat, lookup))
