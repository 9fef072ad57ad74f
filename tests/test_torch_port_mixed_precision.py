"""`model.compute_dtype=bfloat16`: the port against the JAX package at
bfloat16, on the CPU, with the JAX weights carried over.

For each encoder path (HSTU padded, packed and on the zigzag ring at
sp_shards=4 against JAX's sp_shards=1; SASRec; the rated preprocessor of
ranking; the softmax branch) the same numpy inputs go through both models:
the encoder's input must be the same bfloat16 bits, block 0's first
LayerNorm output (the rounding point inside the encoder,
models/precision.py) is compared bit for bit and its flips to a neighbouring
bfloat16 value are counted, and the encoded output and the gradient of every
parameter of sum(encoded * w) (w a fixed random [B, N, D]) must lie within
the band measured here: rtol 2e-4 / atol 2e-5 on the output and rtol 2e-4
/ atol 2e-6 on the gradients (tests/torch_port_families.py's), but for
gradient flips: an element one of whose bfloat16 cotangents rounded to the
neighbouring value, at most 0.1% of the elements, each within 2^-8 of its
tensor's largest entry (measured: none at block 0's LayerNorm output, no
gradient flip but in the softmax branch, 3 of 7,244 there). The port at
float32 against JAX at bfloat16 falls outside that band (40-80% of the
outputs and gradients): the band tells the two dtypes apart.

Also: generation refuses a bfloat16 model (JAX's decode step ignores the
knob), and `index.approx_top_k_recall` selects what JAX's
`jax.lax.approx_max_k` does off the TPU, ids bit for bit, through one
trainer eval as JAX's `test_trainer_eval_with_approx_topk`.
"""

import copy

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.ops.topk import mips_top_k as jax_mips_top_k
from mygenerativerecommenders_tpu.train import task_retrieval as jax_task
from mygenerativerecommenders_tpu.utils.features import packed_seq_features as jax_packed
from mygenerativerecommenders_tpu.utils.features import seq_features_from_batch as jax_features
from mygenerativerecommenders_tpu_torch.checkpoint import grads_to_state_dict
from mygenerativerecommenders_tpu_torch.cli import train as cli_train
from mygenerativerecommenders_tpu_torch.models import precision
from mygenerativerecommenders_tpu_torch.models.decode import check_decodable
from mygenerativerecommenders_tpu_torch.models.model import build_model as pt_build_model
from mygenerativerecommenders_tpu_torch.ops.topk import mips_top_k
from mygenerativerecommenders_tpu_torch.train import task_retrieval as pt_task
from mygenerativerecommenders_tpu_torch.train.driver import Trainer
from mygenerativerecommenders_tpu_torch.utils.features import packed_seq_features as pt_packed
from mygenerativerecommenders_tpu_torch.utils.features import seq_features_from_batch as pt_features
from tests import torch_port_families as fam
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OUT_RTOL, OUT_ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-6
# a gradient element whose bfloat16 cotangent rounded the other way in one
# of its terms: at most this share of the elements, each off by at most one
# bfloat16 step of its tensor's largest entry
MAX_FLIP_SHARE, BF16_ULP = 1e-3, 2.0**-8
BF16 = (("model.compute_dtype", "bfloat16"),)

CASES = {
    "hstu-padded": dict(overrides=()),
    "hstu-packed": dict(overrides=(), packed=True),
    "hstu-zigzag-ring": dict(overrides=(), ring=True),
    "hstu-softmax": dict(overrides=(("model.encoder.normalization", "softmax_rel_bias"),)),
    "hstu-rated": dict(overrides=(("model.preprocessor.kind", "learnable_positional_rated"),
                                  ("model.preprocessor.rating_embedding_dim", 8))),
    "sasrec": dict(overrides=(("model.encoder.kind", "sasrec"),), heads=2),
}


def _setup(case):
    spec = CASES[case]
    overrides = BF16 + spec["overrides"]
    if spec.get("packed"):
        return fam.packed_setup(overrides, heads=1)
    return fam.setup(overrides=overrides, heads=spec.get("heads", 1), num_batches=1)


def _port_model(s, case, dtype):
    """The set-up's port model, or a twin at another dtype or on the ring,
    with the same weights."""
    if dtype == "bfloat16" and not CASES[case].get("ring"):
        return s.pmodel
    pcfg = copy.deepcopy(s.pcfg)
    pcfg.model.compute_dtype = dtype
    if CASES[case].get("ring"):
        pcfg.model.encoder.sp_shards, pcfg.model.encoder.sp_zigzag = 4, True
    model = pt_build_model(pcfg, device="cpu")
    model.load_state_dict(s.pmodel.state_dict())
    return model


def _jax_run(s, seq, w):
    """JAX's encoded output, the encoder's input, block 0's first LayerNorm
    output and the gradients of sum(encoded * w)."""
    seen = {}

    def grab(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and "user_embeddings" in kwargs:
            seen["input"] = kwargs["user_embeddings"]
        return next_fun(*args, **kwargs)

    def forward(params):
        (enc, _), state = s.jmodel.apply(params, seq, capture_intermediates=True,
                                         mutable=["intermediates"])
        inter = state["intermediates"]["encoder"]
        ln = (inter["block_0"] if "block_0" in inter else inter)["LayerNorm_0"]["__call__"][0]
        return enc, ln

    with nn.intercept_methods(grab):
        enc, ln = forward(s.params)
    grads = jax.grad(lambda p: jnp.sum(forward(p)[0] * w))(s.params)
    return (np.asarray(enc), np.asarray(seen["input"].astype(jnp.float32)),
            np.asarray(ln.astype(jnp.float32)), grads_to_state_dict(fam.np_tree(grads)))


def _port_run(model, seq, w, monkeypatch):
    seen = {}
    key = model.encoder_key
    hook = model.sequence_encoder[key].register_forward_pre_hook(
        lambda mod, args: seen.update(input=args[1]))
    first_ln = precision.layer_norm

    def record(*args):
        out = first_ln(*args)
        seen.setdefault("ln", out)
        return out

    monkeypatch.setattr(precision, "layer_norm", record)
    model.zero_grad(set_to_none=True)
    enc, _ = model(seq)
    (enc * torch.from_numpy(w)).sum().backward()
    hook.remove()
    return enc.detach().numpy(), seen, {k: p.grad for k, p in model.named_parameters()}


def _off_band(got, want, rtol, atol):
    """(elements outside rtol / atol, the largest of their distances over
    their tensor's largest |want|)."""
    diff = np.abs(got - want)
    bad = diff > atol + rtol * np.abs(want)
    scale = float(np.abs(want).max()) or 1.0
    return int(bad.sum()), float(diff[bad].max() / scale) if bad.any() else 0.0


def _gradient_flips(grads, want_grads):
    """(gradient elements outside the band, all elements, the largest
    distance of one over its tensor's largest |want|)."""
    flips, total, worst = 0, 0, 0.0
    for name, g in grads.items():
        n, far = _off_band(g.numpy(), want_grads[name].numpy(), GRAD_RTOL, GRAD_ATOL)
        flips, total, worst = flips + n, total + g.numel(), max(worst, far)
    return flips, total, worst


@pytest.mark.parametrize("case", sorted(CASES))
def test_bfloat16_forward_and_gradients_match_jax(case, monkeypatch):
    s = _setup(case)
    batch = s.batches[0]
    packed = CASES[case].get("packed", False)
    if packed:
        jseq, pseq = jax_packed(batch), pt_packed(fam.torch_batch(batch))
    else:
        jseq, _, _ = jax_features(batch, s.jcfg.model.gr_output_length + 1)
        pseq, _, _ = pt_features(fam.torch_batch(batch), s.pcfg.model.gr_output_length + 1)
    pseq = pseq._replace(past_embeddings=None)
    enc_shape = s.jmodel.apply(s.params, jseq)[0].shape
    w = np.random.default_rng(5).normal(size=enc_shape).astype(np.float32)
    want, want_input, want_ln, want_grads = _jax_run(s, jseq, w)

    model = _port_model(s, case, "bfloat16")
    got, seen, grads = _port_run(model, pseq, w, monkeypatch)
    assert seen["input"].dtype == torch.bfloat16
    np.testing.assert_array_equal(seen["input"].detach().float().numpy(), want_input)
    assert seen["ln"].dtype == torch.bfloat16
    ln_flips = int((seen["ln"].detach().float().numpy() != want_ln).sum())
    assert ln_flips == 0, f"{ln_flips} of {want_ln.size} LayerNorm outputs rounded the other way"
    np.testing.assert_allclose(got, want, rtol=OUT_RTOL, atol=OUT_ATOL)
    assert grads.keys() == want_grads.keys()
    assert all(g is not None for g in grads.values())
    flips, total, worst = _gradient_flips(grads, want_grads)
    # measured: 0 everywhere but the softmax branch, 3 of 7,244 there
    assert flips <= MAX_FLIP_SHARE * total and worst <= BF16_ULP, (flips, total, worst)

    # the band tells the dtypes apart: the float32 port falls outside it
    # (measured: 40-80% of the outputs and gradients)
    got32, _, grads32 = _port_run(_port_model(s, case, "float32"), pseq, w, monkeypatch)
    out32, _ = _off_band(got32, want, OUT_RTOL, OUT_ATOL)
    flips32, _, _ = _gradient_flips(grads32, want_grads)
    assert out32 > 0 and flips32 > MAX_FLIP_SHARE * total, (out32, flips32)


def test_generation_refuses_a_bfloat16_model():
    s = fam.shared(overrides=BF16)
    with pytest.raises(ValueError, match="model.compute_dtype"):
        check_decodable(s.pcfg.model)


def test_approx_top_k_selects_as_jax_does_off_the_tpu():
    """mips_top_k at approx_recall 0.95 against JAX's (jax.lax.approx_max_k,
    exact on the CPU): ids bit for bit, scores within float32 noise."""
    rng = np.random.default_rng(0)
    b, x, d, k = 8, 512, 16, 32
    q = rng.normal(size=(b, d)).astype(np.float32)
    items = rng.normal(size=(x, d)).astype(np.float32)
    ids = np.arange(1, x + 1, dtype=np.int32)
    invalid = rng.integers(0, x + 1, size=(b, 6)).astype(np.int32)
    want_ids, want_scores = jax_mips_top_k(jnp.asarray(q), jnp.asarray(items), jnp.asarray(ids),
                                           k, jnp.asarray(invalid), x, approx_recall=0.95)
    got_ids, got_scores = mips_top_k(torch.from_numpy(q), torch.from_numpy(items),
                                     torch.from_numpy(ids), k, torch.from_numpy(invalid), x,
                                     approx_recall=0.95)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="at most 1"):
        mips_top_k(torch.from_numpy(q), torch.from_numpy(items), torch.from_numpy(ids), k,
                   approx_recall=1.5)


def test_trainer_eval_with_approx_top_k_equals_jax(tmp_path):
    """index.approx_top_k_recall=0.95 through the trainer's eval, as JAX's
    test_trainer_eval_with_approx_topk runs it: the eval step's top-k ids
    equal to JAX's bit for bit on the set-up's batches, and a trainer's val
    metrics at 0.95 equal to those at 0.0."""
    s = fam.setup(overrides=(("model.index.approx_top_k_recall", 0.95),), num_batches=2)
    max_id = int(s.pcfg.model.embedding.num_items)
    jcands = jax_task.make_candidate_fn(s.jmodel, s.jcfg, s.item_ids)(s.params)
    jstep = jax_task.make_eval_step(s.jmodel, s.jcfg, s.item_ids, max_id)
    pstep = pt_task.make_eval_step(s.pmodel, s.pcfg, s.item_ids, max_id)
    cands = pt_task.make_candidate_fn(s.pmodel, s.pcfg, s.item_ids)()
    for batch in s.batches:
        with torch.no_grad():
            ids, scores = pstep(fam.torch_batch(batch), cands)
        want_ids, want_scores = jstep(s.params, {k: jnp.asarray(v) for k, v in batch.items()},
                                      jcands)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
        np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), atol=fam.TOPK_ATOL)
    results = {}
    for recall in (0.0, 0.95):
        trainer = Trainer(cli_train.parse_args([
            "experiment=synthetic-smoke", "trainer.device=cpu",
            f"trainer.output_dir={tmp_path / str(recall)}",
            f"model.index.approx_top_k_recall={recall}"]))
        results[recall] = trainer.eval_epoch(trainer.data.loader("val"), "val")
    assert results[0.95].keys() == results[0.0].keys()
    for key in results[0.0]:
        np.testing.assert_allclose(results[0.95][key], results[0.0][key], rtol=1e-6,
                                   err_msg=key)
