"""Heads and embeddings wider than 128: a one-block model at width 192 in the
port against the JAX package, on the CPU.

`model.item_embedding_dim=192` alone gives a 192-wide head (the config sets
`attention_dim` and `linear_dim` to the embedding width when they are 0) and
a 192-wide lse, the widths at which the port's CUDA kernels take their wide
paths (csrc/hstu_attention_{fwd,bwd}.cu, csrc/dense_neg_lse.cu). Here the
port runs those kernels' plain versions; the JAX model runs its Pallas
kernels (the fused attention and the dense-negative lse) in interpret mode,
`pltpu.force_tpu_interpret_mode()`, as the JAX package's tests run them: both
take this width, so no plain reference stands in for them. Forward, loss and
every gradient at rtol 2e-4 / atol 2e-5 (the loss at rtol 1e-5). The card's
own checks of the wide kernels against their plain versions are in
tests/test_torch_port_gpu.py.

The ring's chunk op at width 192 (the width at which
csrc/hstu_chunk_{fwd,bwd}.cu take their wide kernels) against the JAX
chunk kernel in interpret mode at three kinds of offset, output and all five
gradients as tests/test_torch_port_ring.py holds them at width 8; and the
model at width 192 with `encoder.sp_shards=4`, both layouts, against the JAX
model at sp_shards=1 (its jnp attention): the encoder output at rtol 2e-4 /
atol 2e-5, the loss at rtol 1e-5 and every gradient at rtol 2e-4 / atol 2e-6.
"""

import copy

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mygenerativerecommenders_tpu.models.model import build_model as jax_build_model
from mygenerativerecommenders_tpu.ops.pallas.hstu_chunk import (
    hstu_chunk_attention as jax_chunk_attention,
)
from mygenerativerecommenders_tpu_torch.models.model import build_model as pt_build_model
from mygenerativerecommenders_tpu_torch.ops.kernels import hstu_chunk as chunk_kern
from mygenerativerecommenders_tpu.utils.features import seq_features_from_batch as jax_features
from mygenerativerecommenders_tpu_torch.utils.features import seq_features_from_batch as pt_features
from tests import torch_port_families as fam
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL, ATOL = 2e-4, 2e-5
WIDE = (("model.item_embedding_dim", 192), ("model.encoder.num_blocks", 1))


@pytest.fixture(scope="module")
def wide():
    """synthetic-smoke at width 192, one block, one head (N = 43), with the
    JAX model switched to its Pallas kernels."""
    s = fam.setup(overrides=WIDE, heads=1, num_batches=1)
    jcfg = copy.deepcopy(s.jcfg)
    jcfg.model.encoder.use_pallas = "true"
    return s._replace(jcfg=jcfg, jmodel=jax_build_model(jcfg))


def test_the_wide_model_has_192_wide_heads_and_rows(wide):
    enc = wide.pcfg.model.encoder
    assert (enc.attention_dim, enc.linear_dim, enc.num_heads) == (192, 192, 1)
    assert wide.pmodel.item_embeddings(torch.tensor([1])).shape[-1] == 192


def test_wide_forward_matches_jax_kernels(wide):
    batch = wide.batches[0]
    jseq, _, _ = jax_features(batch, wide.jcfg.model.gr_output_length + 1)
    assert jseq.past_ids.shape[1] <= 64
    with pltpu.force_tpu_interpret_mode():
        want, _ = wide.jmodel.apply(wide.params, jseq)
    pseq, _, _ = pt_features(fam.torch_batch(batch), wide.pcfg.model.gr_output_length + 1)
    with torch.no_grad():
        got, _ = wide.pmodel(pseq._replace(past_embeddings=None))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_wide_loss_and_every_gradient_match_jax_kernels(wide):
    # loss_fn_dense: the count and the 192-wide lse (JAX's Pallas kernels)
    with pltpu.force_tpu_interpret_mode():
        fam.compare_loss_and_grads(wide, wide.batches[0], jax.random.PRNGKey(3),
                                   grad_rtol=RTOL, grad_atol=ATOL, expect="loss_fn_dense")


@pytest.mark.parametrize(
    "offd", [-40, 9, -60], ids=["negative", "partial", "off-table"]
)
def test_wide_chunk_op_matches_the_jax_chunk_kernel(offd):
    """Row 9 and 10's function at dqk = dv = 192, one head: a 24-row query
    block against a 40-row chunk, fully live, partial, and fully live with
    diagonals below the position table (the clipped slot)."""
    b, nq, nc, h, d, max_len, nb = 1, 24, 40, 1, 192, 64, 128
    rng = np.random.default_rng(offd + 300)
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32) for n in (nq, nc, nc))
    stamps = np.sort(rng.integers(10**8, 10**8 + 3 * 10**7, size=(b, nq + nc)), axis=1)
    tsq, tsk = stamps[:, :nq].astype(np.int32), stamps[:, nq:].astype(np.int32)
    pos_w = (rng.normal(size=(2 * max_len - 1,)) * 0.1).astype(np.float32)
    ts_w = (rng.normal(size=(nb + 1,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(b, nq, h, d)).astype(np.float32)
    kw = dict(max_len=max_len, num_buckets=nb)

    def jax_kernel(q_, k_, v_, pw_, tw_):
        out = jax_chunk_attention(q_, k_, v_, tsq, tsk, offd, pw_, tw_,
                                  inv_n=1.0 / max_len, interpret=True, **kw)
        return (out * g).sum(), out

    (_, want), want_grads = jax.value_and_grad(jax_kernel, argnums=(0, 1, 2, 3, 4),
                                               has_aux=True)(q, k, v, pos_w, ts_w)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v, pos_w, ts_w)]
    out = chunk_kern.hstu_chunk_attention(
        leaves[0], leaves[1], leaves[2], torch.tensor(tsq), torch.tensor(tsk), offd,
        leaves[3], leaves[4], inv_n=1.0 / max_len, **kw,
    )
    got = torch.autograd.grad(out, leaves, torch.tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    for i, (a, w) in enumerate(zip(got, want_grads)):
        rtol = 5e-4 if i >= 3 else RTOL  # the bias tables' (tests/test_pallas_hstu.py)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=rtol, atol=ATOL, err_msg=str(i))
    if offd == -60:
        assert float(got[3][0].abs()) > 0  # the first table slot took the clipped pairs


@pytest.fixture(scope="module")
def wide_jnp(wide):
    """`wide` with the JAX model on its jnp attention (sp_shards=1): the
    reference of the ring."""
    jcfg = copy.deepcopy(wide.jcfg)
    jcfg.model.encoder.use_pallas = "false"
    return wide._replace(jcfg=jcfg, jmodel=jax_build_model(jcfg))


@pytest.mark.parametrize("zigzag", [False, True], ids=["contiguous", "zigzag"])
def test_wide_ring_model_matches_jax_unsharded(wide_jnp, zigzag):
    pcfg = copy.deepcopy(wide_jnp.pcfg)
    pcfg.model.encoder.sp_shards = 4
    pcfg.model.encoder.sp_zigzag = zigzag
    pmodel = pt_build_model(pcfg, device="cpu")
    pmodel.load_state_dict(wide_jnp.pmodel.state_dict())
    ring = wide_jnp._replace(pcfg=pcfg, pmodel=pmodel)
    batch = ring.batches[0]
    max_out = pcfg.model.gr_output_length + 1
    jseq, _, _ = jax_features(batch, max_out)
    want, _ = ring.jmodel.apply(ring.params, jseq, deterministic=True)
    pseq, _, _ = pt_features(fam.torch_batch(batch), max_out)
    with torch.no_grad():
        got, _ = pmodel(pseq._replace(past_embeddings=None))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    fam.compare_loss_and_grads(ring, batch, jax.random.PRNGKey(4), expect="loss_fn_dense")
