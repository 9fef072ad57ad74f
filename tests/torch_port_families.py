"""Shared set-up of the tests that hold the model families of the PyTorch
port (the aux preprocessor, SASRec, the in-batch sampler, BCE, the
item_year embedding, MoL, softmax_rel_bias, the layer_norm postprocessor)
to the JAX package, on the CPU.

`setup` builds both packages' model on one preset with dotted overrides,
dropout off (torch cannot replay `jax.random`), the JAX weights carried into
the port (`params_to_state_dict`), and a few train batches of the port's
loader (held to the JAX loader's in tests/test_torch_port_aux.py and
tests/test_torch_port_train_data.py). The JAX model runs its jnp path
(`encoder.use_pallas=false`); the port runs its kernels' plain versions.

Both models get the catalog's item -> year table (read by the item_year
embedding only). `packed_setup` is `setup` over packed batches
(tests/test_torch_port_packing_model.py's loader). `shared` caches a set-up
for the tests that leave its weights as they are. `compare_eval_topk` holds
the port's eval step to JAX's on a set-up's batches.
`jax_draw` is the JAX step's own draw for its negatives at a step (the
trainer's `fold_in(rng, step)`, `split`, then `randint` for catalog offsets
or `uniform` for the in-batch sampler), which the port is handed.
"""

import functools
from typing import Any, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mygenerativerecommenders_tpu.configs import resolve as jax_resolve
from mygenerativerecommenders_tpu.configs.presets import get_preset as jax_preset
from mygenerativerecommenders_tpu.models.model import build_model as jax_build_model
from mygenerativerecommenders_tpu.train import task_retrieval as jax_task
from mygenerativerecommenders_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from mygenerativerecommenders_tpu.train.optimizers import param_labels as jax_param_labels
from mygenerativerecommenders_tpu.utils.features import packed_seq_features as jax_packed_features
from mygenerativerecommenders_tpu.utils.features import seq_features_from_batch as jax_features
from mygenerativerecommenders_tpu_torch.checkpoint import (
    grads_to_state_dict,
    params_to_state_dict,
)
from mygenerativerecommenders_tpu_torch.configs import resolve as pt_resolve
from mygenerativerecommenders_tpu_torch.configs.presets import get_preset as pt_preset
from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
from mygenerativerecommenders_tpu_torch.data.packing import PackedBatchLoader
from mygenerativerecommenders_tpu_torch.models.model import build_model as pt_build_model
from mygenerativerecommenders_tpu_torch.ops.topk import topk_agree
from mygenerativerecommenders_tpu_torch.train import task_retrieval as pt_task
from mygenerativerecommenders_tpu_torch.train.optimizers import build_optimizer as pt_build_optimizer
from mygenerativerecommenders_tpu_torch.train.optimizers import param_labels as pt_param_labels

# tests/test_torch_port_train_step.py's: the loss, every gradient, the
# parameters after three AdamW steps (Adam divides by sqrt(v), so a gradient
# that is float32 noise around zero moves its parameter either way)
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL, STEP_ATOL = 1e-5, 2e-4, 2e-6, 2e-5
# a gathered table row sums up to B*T*R terms (tests/test_torch_port_gather_loss.py)
GATHER_GRAD_RTOL, GATHER_GRAD_ATOL = 5e-4, 1e-6
# top-k scores (tests/test_torch_port_serving.py's)
TOPK_ATOL = 1e-5
# packed rows (tests/test_torch_port_packing_model.py's)
CAPACITIES = (16, 32, 48)


class Setup(NamedTuple):
    jcfg: Any
    pcfg: Any
    jmodel: Any
    params: Any
    pmodel: torch.nn.Module
    item_ids: np.ndarray
    batches: list


def set_path(cfg, path: str, value) -> None:
    obj = cfg
    *parents, leaf = path.split(".")
    for p in parents:
        obj = getattr(obj, p)
    setattr(obj, leaf, value)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _configs(preset: str, overrides: Sequence[Tuple[str, Any]], heads: int):
    jcfg, pcfg = jax_preset(preset), pt_preset(preset)
    jcfg.model.encoder.use_pallas = "false"
    for cfg in (jcfg, pcfg):
        for path, value in overrides:
            set_path(cfg, path, value)
        cfg.model.preprocessor.dropout_rate = 0.0
        cfg.model.encoder.linear_dropout_rate = 0.0
        cfg.model.encoder.num_heads = heads
        if cfg.model.encoder.kind == "hstu":
            dim = cfg.model.item_embedding_dim // heads
            cfg.model.encoder.attention_dim = cfg.model.encoder.linear_dim = dim
    return jcfg, pcfg


def _both_models(jcfg, pcfg, data, seq) -> Tuple[Any, Any, torch.nn.Module]:
    """(JAX model, its params initialised on `seq`, the port's model with
    those weights), both given the catalog's item -> year table."""
    jax_resolve(jcfg, data.max_item_id)
    pt_resolve(pcfg, data.max_item_id)
    jmodel = jax_build_model(jcfg, year_of_item=data.year_of_item)
    key = jax.random.PRNGKey(0)
    params = jmodel.init({"params": key, "dropout": key}, seq, method=jmodel.init_all)
    pmodel = pt_build_model(pcfg, device="cpu", year_of_item=data.year_of_item)
    pmodel.load_state_dict(params_to_state_dict(np_tree(params)))
    return jmodel, params, pmodel


def setup(preset: str = "synthetic-smoke", overrides: Sequence[Tuple[str, Any]] = (),
          heads: int = 1, num_batches: int = 2) -> Setup:
    jcfg, pcfg = _configs(preset, overrides, heads)
    data = RecoData(pcfg.data, seed=42)
    batches = [b for _, b in zip(range(num_batches), data.loader("train"))]
    seq, _, _ = jax_features(batches[0], jcfg.model.gr_output_length + 1)
    jmodel, params, pmodel = _both_models(jcfg, pcfg, data, seq)
    return Setup(jcfg, pcfg, jmodel, params, pmodel, data.all_item_ids, batches)


def packed_setup(overrides: Sequence[Tuple[str, Any]] = (), heads: int = 2) -> Setup:
    """`setup` over packed train batches: synthetic-smoke data with histories
    up to 36 (L = 47), rows of 16-48 tokens (capacities CAPACITIES, up to 8
    segments a batch); `batches` is the packed train loader's whole epoch."""
    jcfg, pcfg = _configs("synthetic-smoke", overrides, heads)
    for cfg in (jcfg, pcfg):
        cfg.data.max_sequence_length = 36
        cfg.data.synthetic_max_seq_len = 45
        cfg.data.pack_sequences = True
        cfg.data.pack_capacities = CAPACITIES
    data = RecoData(pcfg.data, seed=42)
    train = list(PackedBatchLoader(
        data.dataset("train"), rows_per_batch=1, row_capacity=max(CAPACITIES),
        capacities=CAPACITIES, segments_per_batch=8, shuffle=True, seed=42,
        include_target=True,
    ))
    jmodel, params, pmodel = _both_models(jcfg, pcfg, data, jax_packed_features(train[0]))
    return Setup(jcfg, pcfg, jmodel, params, pmodel, data.all_item_ids, train)


@functools.lru_cache(maxsize=None)
def shared(preset: str = "synthetic-smoke", overrides: Tuple[Tuple[str, Any], ...] = (),
           heads: int = 1) -> Setup:
    """`setup`, made once a process for each argument set: for the tests that
    leave the weights as they are (the gradients are set anew by each use)."""
    return setup(preset, overrides, heads)


def draw_shape(cfg, batch, packed: bool = False) -> Tuple[int, ...]:
    """[B, N-1, R] of the JAX loss's draw (R = 1 for BCE)."""
    rows, cols = batch["ids"].shape
    r = cfg.model.loss.num_to_sample if cfg.model.loss.kind == "sampled_softmax" else 1
    return rows, cols - 1 + (0 if packed else cfg.model.gr_output_length + 1), r


def jax_draw(key, shape, in_batch: bool, num_catalog: int) -> torch.Tensor:
    """What the JAX loss draws from its key: offsets, or in-batch uniforms."""
    _, neg_rng = jax.random.split(key)
    if in_batch:
        return torch.from_numpy(np.array(jax.random.uniform(neg_rng, shape)))
    return torch.from_numpy(np.array(jax.random.randint(neg_rng, shape, 0, num_catalog)))


def drawn_name(pcfg) -> str:
    return "neg_uniforms" if pcfg.model.sampler.kind == "in_batch" else "neg_offsets"


def compare_loss_and_grads(s: Setup, batch, key, packed: bool = False,
                           grad_rtol: float = GRAD_RTOL, grad_atol: float = GRAD_ATOL,
                           expect: str = "", grad_atol_of_max: float = 0.0) -> float:
    """The JAX loss and every gradient at `key` against the port's loss on
    the JAX draw; -> the loss. `grad_atol_of_max` raises a gradient's atol
    to that share of its largest entry (MoL's logits are divided by two
    temperatures, and its gradients reach ~100)."""
    jloss = jax_task.make_loss_fn(s.jmodel, s.jcfg, s.item_ids, packed=packed)
    if expect:
        assert jloss.__name__ == expect
    dev_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, want_grads = jax.jit(jax.value_and_grad(jloss))(s.params, dev_batch, key)
    want_grads = grads_to_state_dict(np_tree(want_grads))
    ploss = pt_task.make_loss_fn(s.pmodel, s.pcfg, s.item_ids, packed=packed)
    drawn = jax_draw(key, draw_shape(s.pcfg, batch, packed),
                     s.pcfg.model.sampler.kind == "in_batch", len(s.item_ids))
    s.pmodel.zero_grad(set_to_none=True)
    loss = ploss(torch_batch(batch), **{drawn_name(s.pcfg): drawn})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    named = dict(s.pmodel.named_parameters())
    assert named.keys() == want_grads.keys()
    for name, p in named.items():
        assert p.grad is not None, name
        want = want_grads[name].numpy()
        atol = max(grad_atol, grad_atol_of_max * float(np.abs(want).max()))
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=grad_rtol, atol=atol, err_msg=name)
    return loss.item()


def compare_eval_topk(s: Setup, atol: float = TOPK_ATOL) -> None:
    """The port's eval step (top-k ids and scores of each row's last
    position against the catalog) equal to JAX's on each batch, up to
    near-ties (`topk_agree`)."""
    max_id = int(s.pcfg.model.embedding.num_items)
    jcands = jax_task.make_candidate_fn(s.jmodel, s.jcfg, s.item_ids)(s.params)
    jstep = jax_task.make_eval_step(s.jmodel, s.jcfg, s.item_ids, max_id)
    cands = pt_task.make_candidate_fn(s.pmodel, s.pcfg, s.item_ids)()
    pstep = pt_task.make_eval_step(s.pmodel, s.pcfg, s.item_ids, max_id)
    for batch in s.batches:
        with torch.no_grad():
            ids, scores = pstep(torch_batch(batch), cands)
        want = jstep(s.params, {k: jnp.asarray(v) for k, v in batch.items()}, jcands)
        problem = topk_agree(ids.numpy(), scores.numpy(), np.asarray(want[0]),
                             np.asarray(want[1]), atol)
        assert problem is None, problem


def check_param_labels(s: Setup) -> dict:
    """The port's `param_labels` on its parameter names against JAX's on
    its leaves (each leaf's label carried to the port's key through
    `params_to_state_dict`); -> the port's labels."""
    labels = jax_param_labels(s.params["params"])
    as_codes = jax.tree_util.tree_map(
        lambda label, p: np.full(p.shape, label == "matrix", np.float32), labels,
        s.params["params"])
    want = {k: ("matrix" if v.flatten()[0] else "primary")
            for k, v in params_to_state_dict(as_codes).items()}
    got = pt_param_labels(s.pmodel.named_parameters())
    assert got == want
    return got


def compare_three_adamw_steps(s: Setup, seed: int = 11, undetermined: Sequence[str] = ()
                              ) -> None:
    """Three AdamW steps of JAX's `make_train_step` against the port's, each
    on the JAX step's draw; the parameters after them at STEP_ATOL, but for
    those named in `undetermined`: parameters whose exact gradient is zero,
    so that Adam steps them by lr along the sign of float32 noise (the
    caller holds their gradients to zero instead)."""
    rng = jax.random.PRNGKey(seed)
    lr = s.jcfg.optimizer1.lr
    jstep = jax_task.make_train_step(s.jmodel, s.jcfg, s.item_ids)
    opt_state = jax_build_optimizer(s.jcfg.optimizer1, None, s.params, lr, lr).init(s.params)
    optimizer = pt_build_optimizer(s.pcfg.optimizer1, s.pcfg.optimizer2,
                                   s.pmodel.parameters(), lr)
    pstep = pt_task.make_train_step(s.pmodel, s.pcfg, s.item_ids, optimizer)
    before = {k: v.clone() for k, v in s.pmodel.state_dict().items()}
    jparams = s.params
    for step in range(3):
        batch = s.batches[step % len(s.batches)]
        out = jstep(jparams, opt_state, {k: jnp.asarray(v) for k, v in batch.items()},
                    rng, lr, lr, step)
        jparams, opt_state = out.params, out.opt_state
        drawn = jax_draw(jax.random.fold_in(rng, step), draw_shape(s.pcfg, batch),
                         s.pcfg.model.sampler.kind == "in_batch", len(s.item_ids))
        loss = pstep(torch_batch(batch), lr, **{drawn_name(s.pcfg): drawn})
        np.testing.assert_allclose(loss.item(), float(out.loss), rtol=1e-4)
    want = params_to_state_dict(np_tree(jparams))
    moved = 0.0
    for name, p in s.pmodel.state_dict().items():
        if name in undetermined:
            continue
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=STEP_ATOL,
                                   err_msg=name)
        moved = max(moved, float((p - before[name]).abs().max()))
    assert moved > 1e-3  # the steps did move the parameters
