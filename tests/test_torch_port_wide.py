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
"""

import copy

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mygenerativerecommenders_tpu.models.model import build_model as jax_build_model
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
