"""MoL (Mixture-of-Logits) similarity of the PyTorch port against the JAX
package's models/similarity_mol.py, on the CPU.

The module, forward and every gradient (its parameters and both inputs),
over the four gate combinations x the gate kinds (linear, geglu, swiglu on
all three gates; none on the context gate, which glu_silu and glu_silu_ln
refuse on both sides) at the loss's [B, T, X, D] shapes, and with linear
gates (the model's) also at the eval's broadcast [1, X, D] items; with
`dot_product_l2_norm` on and off; the item
side information with and without `combine_item_sideinfo_into_ci` and
`gating_use_custom_tau`; the LnX estimator over three batches, updating and
not. Then synthetic-smoke with `similarity.kind=mol`: the gather loss and
every gradient, padded and packed, on the JAX step's own negatives; the
ranking loss through `model.score`; the eval top-k (the dot product, as
JAX's eval); the split optimizer's labels; and the raises (a non-default
`gating_combination_type`, the dense and shared-negatives losses, the
lazy update).

Tolerances: the module's outputs at rtol 2e-4 / atol 2e-5 and gradients at
rtol 5e-4 / atol 2e-6 of the tensor's largest entry (the logits, divided by
temperature 0.05, reach ~20, and a gradient sums terms of that size, whose
float32 rounding in another order moves its small entries by ~1e-6 of them); the
LnX frequencies at rtol 1e-6, its integer state exactly; the model's loss at
rtol 1e-5 and gradients at the gather loss's rtol 5e-4 / atol 1e-6
(tests/torch_port_families.py), the atol raised to 5e-6 of the tensor's
largest entry (the loss divides MoL's logits by its own temperature and the
loss's, 0.05 x 0.05, the gradients reach ~100, and an entry sums ~B*T terms
of that size); the ranking loss's gradients at rtol 2e-4 with the same atol; top-k
by `topk_agree` at atol 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.models import similarity_mol as jax_mol
from mygenerativerecommenders_tpu.train import task_ranking as jax_ranking
from mygenerativerecommenders_tpu_torch.checkpoint import grads_to_state_dict, params_to_state_dict
from mygenerativerecommenders_tpu_torch.configs.presets import get_preset as pt_preset
from mygenerativerecommenders_tpu_torch.configs import resolve as pt_resolve
from mygenerativerecommenders_tpu_torch.models import similarity_mol as pt_mol
from mygenerativerecommenders_tpu_torch.models.model import build_model as pt_build_model
from mygenerativerecommenders_tpu_torch.train import task_ranking as pt_ranking
from mygenerativerecommenders_tpu_torch.train import task_retrieval as pt_task
from mygenerativerecommenders_tpu_torch.train.lazy_embedding import lazy_applicable
from tests import torch_port_families as fam
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

MOL = (("model.similarity.kind", "mol"),)
# a model gradient entry sums ~B*T terms up to its tensor's largest entry
MODEL_ATOL_OF_MAX = 5e-6
GATHER = dict(grad_rtol=fam.GATHER_GRAD_RTOL, grad_atol=fam.GATHER_GRAD_ATOL,
              grad_atol_of_max=MODEL_ATOL_OF_MAX)
OUT_RTOL, OUT_ATOL, GRAD_RTOL, GRAD_ATOL_OF_MAX = 2e-4, 2e-5, 5e-4, 2e-6
D, P, Q, DD = 16, 2, 3, 8


def _gates(kind: str) -> dict:
    """The gate MLPs of a case: `kind` on all three, but 'none' on the
    context gate alone (no gate at all leaves nothing to combine)."""
    if kind == "none":
        return dict(gating_context_mlp="none", gating_item_mlp="linear", gating_ci_mlp="linear")
    return dict(gating_context_mlp=kind, gating_item_mlp=kind, gating_ci_mlp=kind)


def _inputs(seed: int, broadcast: bool, side: int = 0):
    """(queries, items, sideinfo): the loss's [B, T, D] x [B, T, X, D], or
    the eval's [B, D] x [1, X, D]."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(3, D) if broadcast else (2, 3, D)).astype(np.float32)
    items_shape = (1, 5, D) if broadcast else (2, 3, 5, D)
    items = rng.normal(size=items_shape).astype(np.float32)
    sideinfo = rng.normal(size=items_shape[:-1] + (side,)).astype(np.float32) if side else None
    return q, items, sideinfo


@functools.lru_cache(maxsize=None)
def _jax_case(kwargs: tuple, shapes: tuple):
    """JAX's module, its params and one jitted value-and-grad for a case."""
    mol = jax_mol.MoLSimilarity(embedding_dim=D, query_dot_product_groups=P,
                                item_dot_product_groups=Q, dot_product_dimension=DD,
                                **dict(kwargs))
    q_shape, items_shape, side_shape = shapes
    args = [jnp.zeros(q_shape), jnp.zeros(items_shape)]
    side = jnp.zeros(side_shape) if side_shape else None
    params = mol.init(jax.random.PRNGKey(3), *args, item_sideinfo=side)

    @jax.jit
    def value_and_grads(params, q, items, side, w):
        def loss(p, q, items):
            return (mol.apply(p, q, items, item_sideinfo=side) * w).sum()

        out = mol.apply(params, q, items, item_sideinfo=side)
        return out, jax.grad(loss, argnums=(0, 1, 2))(params, q, items)

    return params, value_and_grads


def _port_module(kwargs: dict, params) -> pt_mol.MoLSimilarity:
    mol = pt_mol.MoLSimilarity(D, query_dot_product_groups=P, item_dot_product_groups=Q,
                               dot_product_dimension=DD, **kwargs)
    state = params_to_state_dict({"similarity": fam.np_tree(params["params"])})
    mol.load_state_dict({k[len("similarity."):]: v for k, v in state.items()})
    return mol


def _close_grads(got: np.ndarray, want: np.ndarray, name: str = "") -> None:
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_OF_MAX * float(np.abs(want).max()), err_msg=name)


def _compare_module(kwargs: dict, seed: int, broadcast: bool, side: int = 0) -> None:
    q, items, sideinfo = _inputs(seed, broadcast, side)
    shapes = (q.shape, items.shape, None if sideinfo is None else sideinfo.shape)
    params, value_and_grads = _jax_case(tuple(sorted(kwargs.items())), shapes)
    w = np.random.default_rng(seed + 1).normal(
        size=np.broadcast_shapes(q.shape[:-1], items.shape[:-2]) + (5,)).astype(np.float32)
    want, (want_p, want_q, want_items) = value_and_grads(
        params, jnp.asarray(q), jnp.asarray(items),
        None if sideinfo is None else jnp.asarray(sideinfo), jnp.asarray(w))
    mol = _port_module(kwargs, params)
    tq, titems = torch.tensor(q, requires_grad=True), torch.tensor(items, requires_grad=True)
    got = mol(tq, titems, item_sideinfo=None if sideinfo is None else torch.from_numpy(sideinfo))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=OUT_RTOL,
                               atol=OUT_ATOL)
    (got * torch.from_numpy(w)).sum().backward()
    _close_grads(tq.grad.numpy(), np.asarray(want_q), "queries")
    _close_grads(titems.grad.numpy(), np.asarray(want_items), "items")
    want_grads = params_to_state_dict({"similarity": fam.np_tree(want_p["params"])})
    named = dict(mol.named_parameters())
    assert {f"similarity.{k}" for k in named} == want_grads.keys()
    for name, p in named.items():
        _close_grads(p.grad.numpy(), want_grads[f"similarity.{name}"].numpy(), name)


@pytest.mark.parametrize("gate", pt_mol.GATE_KINDS)
@pytest.mark.parametrize("combination", pt_mol.COMBINATIONS)
def test_module_matches_jax_for_every_combination_and_gate(combination, gate):
    kwargs = dict(gating_combination_type=combination, **_gates(gate))
    if combination.startswith("glu_silu") and gate == "none":
        # ctx * item + ci: JAX fails on the missing gate, the port says why
        with pytest.raises(TypeError):
            _jax_case(tuple(sorted(kwargs.items())), ((2, 3, D), (2, 3, 5, D), None))
        with pytest.raises(ValueError, match="none of them may be 'none'"):
            pt_mol.MoLSimilarity(D, **kwargs)
        return
    # the eval's broadcast items with the gate kind the model builds
    for broadcast in (False, True) if gate == "linear" else (False,):
        _compare_module(kwargs, seed=len(combination) + len(gate), broadcast=broadcast)


@pytest.mark.parametrize("l2", [True, False])
def test_module_matches_jax_with_and_without_the_group_l2_norm(l2):
    _compare_module(dict(dot_product_l2_norm=l2, temperature=0.1), seed=5, broadcast=False)


@pytest.mark.parametrize("combine,tau", [(True, True), (False, True), (True, False)])
def test_item_sideinfo_pathways_and_custom_tau_match_jax(combine, tau):
    kwargs = dict(item_sideinfo_dim=3, combine_item_sideinfo_into_ci=combine,
                  gating_use_custom_tau=tau, gating_tau_alpha=0.01)
    _compare_module(kwargs, seed=9, broadcast=False, side=3)
    with pytest.raises(ValueError, match="item_sideinfo"):
        pt_mol.MoLSimilarity(D, **kwargs)(torch.zeros(2, D), torch.zeros(2, 5, D))


@pytest.mark.parametrize("update", [True, False])
def test_lnx_frequency_estimator_over_three_batches_matches_jax(update):
    num_ids, alpha, b_cap = 23, 0.25, 50.0
    rng = np.random.default_rng(11)
    jstate, pstate = jax_mol.lnx_init_state(num_ids), pt_mol.lnx_init_state(num_ids)
    if not update:  # a warmed-up state, read without changing it
        warm = rng.integers(0, num_ids, size=(40,))
        jstate = jax_mol.lnx_frequency_estimate(jstate, jnp.asarray(warm), alpha=alpha,
                                                b_cap=b_cap)[1]
        pstate = pt_mol.lnx_frequency_estimate(pstate, torch.from_numpy(warm), alpha=alpha,
                                               b_cap=b_cap)[1]
    for step in range(3):
        ids = rng.integers(0, num_ids, size=(3, 4))
        want, jstate = jax_mol.lnx_frequency_estimate(jstate, jnp.asarray(ids), alpha=alpha,
                                                      b_cap=b_cap, update=update)
        got, pstate = pt_mol.lnx_frequency_estimate(pstate, torch.from_numpy(ids), alpha=alpha,
                                                    b_cap=b_cap, update=update)
        assert got.shape == ids.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(pstate["A"].numpy(), np.asarray(jstate["A"]))
        np.testing.assert_allclose(pstate["B"].numpy(), np.asarray(jstate["B"]), rtol=1e-6)
        assert int(pstate["num_elements"]) == int(jstate["num_elements"])
        assert pstate["A"].dtype == torch.int32 and pstate["B"].dtype == torch.float32
    assert int(pstate["num_elements"]) == (36 if update else 40)


def test_gather_loss_and_every_gradient_of_a_mol_model_match_jax():
    s = fam.shared(overrides=MOL, heads=2)
    assert pt_task.make_loss_fn(s.pmodel, s.pcfg, s.item_ids).variant == "gather"
    assert isinstance(s.pmodel.similarity, pt_mol.MoLSimilarity)
    fam.compare_loss_and_grads(s, s.batches[0], jax.random.fold_in(jax.random.PRNGKey(7), 0),
                               expect="loss_fn", **GATHER)


def test_packed_gather_loss_and_every_gradient_of_a_mol_model_match_jax():
    s = fam.packed_setup(overrides=MOL)
    widest = max(s.batches, key=lambda b: b["ids"].shape[1])
    fam.compare_loss_and_grads(s, widest, jax.random.PRNGKey(5), packed=True, expect="loss_fn",
                               **GATHER)


def test_ranking_loss_scores_ratings_through_mol_as_jax_does():
    s = fam.setup(preset="synthetic-rank-smoke", overrides=MOL, heads=2, num_batches=1)
    batch = s.batches[0]
    want, want_grads = jax.jit(jax.value_and_grad(jax_ranking.make_loss_fn(s.jmodel, s.jcfg)))(
        s.params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
    want_grads = grads_to_state_dict(fam.np_tree(want_grads))
    loss = pt_ranking.make_loss_fn(s.pmodel, s.pcfg)(fam.torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=fam.LOSS_RTOL)
    named = dict(s.pmodel.named_parameters())
    assert named.keys() == want_grads.keys()
    assert any(name.startswith("similarity.") for name in named)
    for name, p in named.items():
        want = want_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=fam.GRAD_RTOL,
                                   atol=max(fam.GRAD_ATOL,
                                            MODEL_ATOL_OF_MAX * float(np.abs(want).max())),
                                   err_msg=name)


def test_eval_top_k_of_a_mol_model_equals_jax():
    """JAX's eval ranks by the dot product with the catalog rows whatever
    `similarity.kind` says (ROADMAP.md queue 3); so does the port's."""
    fam.compare_eval_topk(fam.shared(overrides=MOL, heads=2))


def test_param_labels_of_a_mol_model_equal_jax():
    """JAX's rule sends a parameter to optimizer2 only with "encoder" in its
    path: MoL's kernels and biases all stay with optimizer1."""
    got = fam.check_param_labels(fam.shared(overrides=MOL, heads=2))
    assert got["similarity.context_proj.kernel"] == "primary"
    assert got["similarity.gate_ci.bias"] == "primary"


def test_mol_raises_where_jax_ignores_or_refuses_it():
    cfg = pt_preset("synthetic-smoke")
    cfg.model.similarity.kind = "mol"
    pt_resolve(cfg, 200)
    cfg.model.similarity.gating_combination_type = "silu"
    with pytest.raises(ValueError, match="gating_combination_type=silu.*ignores"):
        pt_build_model(cfg, device="cpu")
    cfg.model.similarity.gating_combination_type = "glu_silu"
    for field in ("dense_catalog_negatives", "shared_negatives"):
        other = pt_preset("synthetic-smoke")
        other.model.similarity.kind = "mol"
        setattr(other.model.loss, field, "true" if field.startswith("dense") else True)
        with pytest.raises(ValueError, match="dot_product similarity"):
            pt_task.loss_variant(other, 200)
    other.model.embedding.lazy_update = True
    with pytest.raises(ValueError, match="similarity.kind=dot_product"):
        lazy_applicable(other)
