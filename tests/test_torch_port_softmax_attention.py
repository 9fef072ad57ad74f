"""`encoder.normalization=softmax_rel_bias` and `postprocessor.kind=layer_norm`
of the PyTorch port against the JAX package, on the CPU.

The softmax HSTU block at H = 2 (q and k in the all-heads-as-one layout, one
logit a pair scaled by 1/sqrt(dqk) with dqk the per-head width; the causal
mask after the softmax), with and without the time bias, forward and every
gradient (its weights and its input) against JAX's `HSTUBlock`; the
2-block, 2-head synthetic-smoke model with it, the time_position and the
position bias, loss and every gradient on the JAX step's own negatives; the
layer_norm postprocessor in the model's forward and its loss and
gradients; and the raises (packed rows, `sp_shards > 1`, generation).

Tolerances: outputs at rtol 2e-4 / atol 2e-5, the block's gradients (of
sum(out * w), w ~ N(0, 1): entries up to ~4) at rtol 5e-4 / atol 2e-5 (the
JAX kernel tests'); the model's loss at rtol 1e-5
and gradients at rtol 2e-4 / atol 2e-6 (tests/torch_port_families.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.models.hstu import HSTUBlock as JaxBlock
from mygenerativerecommenders_tpu.utils.features import seq_features_from_batch as jax_features
from mygenerativerecommenders_tpu_torch.checkpoint import params_to_state_dict
from mygenerativerecommenders_tpu_torch.configs import resolve as pt_resolve
from mygenerativerecommenders_tpu_torch.configs.presets import get_preset as pt_preset
from mygenerativerecommenders_tpu_torch.models.decode import check_decodable
from mygenerativerecommenders_tpu_torch.models.hstu import HSTUBlock
from mygenerativerecommenders_tpu_torch.models.model import build_model as pt_build_model
from mygenerativerecommenders_tpu_torch.models.postprocessors import LayerNormPostprocessor
from mygenerativerecommenders_tpu_torch.train import task_retrieval as pt_task
from mygenerativerecommenders_tpu_torch.utils.features import seq_features_from_batch
from tests import torch_port_families as fam
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

SOFTMAX = (("model.encoder.normalization", "softmax_rel_bias"),)
LAYER_NORM = (("model.postprocessor.kind", "layer_norm"),)
B, N, D, H, DH, MAX_LEN = 3, 20, 16, 2, 8, 24


@pytest.mark.parametrize("with_time", [True, False], ids=["time-bias", "position-bias"])
def test_softmax_block_matches_jax_at_two_heads(with_time):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    ts = np.cumsum(rng.integers(0, 5000, size=(B, N)), axis=1).astype(np.int32)
    w = rng.normal(size=(B, N, D)).astype(np.float32)
    kw = dict(embedding_dim=D, linear_dim=DH, attention_dim=DH, num_heads=H,
              max_attn_len=MAX_LEN, normalization="softmax_rel_bias")
    jblock = JaxBlock(**kw)
    jts = jnp.asarray(ts) if with_time else None
    params = jblock.init(jax.random.PRNGKey(2), jnp.asarray(x), jts)

    def loss(p, x):
        return (jblock.apply(p, x, jts) * w).sum()

    want = np.asarray(jblock.apply(params, jnp.asarray(x), jts))
    want_p, want_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    prefix = "sequence_encoder._hstu._attention_layers.0."

    def block_state(tree):
        state = params_to_state_dict({"encoder": {"block_0": fam.np_tree(tree["params"])}})
        return {k[len(prefix):]: v for k, v in state.items()}

    block = HSTUBlock(**kw)
    state = block_state(params)
    if not with_time:  # JAX makes no time table without timestamps; the port has its own
        state["_rel_attn_bias._ts_w"] = block.state_dict()["_rel_attn_bias._ts_w"]
    block.load_state_dict(state)
    tx = torch.tensor(x, requires_grad=True)
    got = block(tx, torch.from_numpy(ts) if with_time else None)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-4, atol=2e-5)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x), rtol=5e-4, atol=2e-5)
    want_grads = block_state(want_p)
    for name, p in block.named_parameters():
        if name in want_grads:
            np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=5e-4,
                                       atol=2e-5, err_msg=name)
        else:  # the unused time table
            assert name == "_rel_attn_bias._ts_w" and p.grad is None


@pytest.mark.parametrize("bias", ["time_position", "position"])
def test_two_block_softmax_model_loss_and_every_gradient_match_jax(bias):
    s = fam.shared(overrides=SOFTMAX + (("model.encoder.relative_bias_type", bias),), heads=2)
    assert s.pcfg.model.encoder.num_blocks == 2
    fam.compare_loss_and_grads(s, s.batches[0], jax.random.fold_in(jax.random.PRNGKey(7), 0),
                               expect="loss_fn_dense")


def test_layer_norm_postprocessor_in_the_model_forward_matches_jax():
    s = fam.shared(overrides=LAYER_NORM, heads=2)
    assert isinstance(s.pmodel.postprocessor, LayerNormPostprocessor)
    batch = s.batches[0]
    max_out = s.jcfg.model.gr_output_length + 1
    want, _ = s.jmodel.apply(s.params, jax_features(batch, max_out)[0])
    with torch.no_grad():
        got, _ = s.pmodel(seq_features_from_batch(fam.torch_batch(batch), max_out)[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    live = got.abs().sum(-1) > 0
    np.testing.assert_allclose(got[live].mean(-1).numpy(), 0.0, atol=1e-5)
    fam.compare_loss_and_grads(s, batch, jax.random.fold_in(jax.random.PRNGKey(7), 1),
                               expect="loss_fn_dense")


def test_softmax_rel_bias_raises_where_jax_raises_or_ignores_the_knob():
    cfg = pt_preset("synthetic-smoke")
    cfg.model.encoder.normalization = "softmax_rel_bias"
    pt_resolve(cfg, 200)
    # JAX's softmax branch is dense and ignores sp_shards
    cfg.model.encoder.sp_shards = 2
    with pytest.raises(ValueError, match="sp_shards=2.*softmax_rel_bias"):
        pt_build_model(cfg, device="cpu")
    cfg.model.encoder.sp_shards = 1
    # packed rows: the loss's packing check and the block itself, as in JAX
    with pytest.raises(ValueError, match="rel_bias normalization"):
        pt_task.make_loss_fn(pt_build_model(cfg, device="cpu"), cfg, np.arange(1, 201),
                             packed=True)
    block = HSTUBlock(D, DH, DH, H, MAX_LEN, normalization="softmax_rel_bias")
    with pytest.raises(ValueError, match="packed rows"):
        block(torch.zeros(1, N, D), None, seg_pos=torch.zeros(1, N, dtype=torch.int32))
    # generation decodes the pointwise attention only (JAX's decode step)
    with pytest.raises(ValueError, match="model.encoder.normalization='rel_bias'"):
        check_decodable(cfg.model)
