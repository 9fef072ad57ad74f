"""The in-batch negatives sampler and the BCE loss of the PyTorch port
against the JAX package (models/negatives.py:98-157, models/losses.py
`bce_loss`, train/task_retrieval.py:210-250), on the CPU.

The pool and its count exactly, with and without dedup; `bce_loss`; the
retrieval loss with every gradient for the in-batch sampler (sampled
softmax with and without dedup, padded and packed; BCE) and for BCE over
the catalog, each on the JAX step's own draw (`jax.random.uniform` for the
in-batch sampler, `randint` for the catalog) handed to the port; three
AdamW steps with the in-batch sampler; the port's draw from its generator.

Tolerances: the pool and count exactly; `bce_loss` at rtol 1e-6; the loss
at rtol 1e-5; every gradient at rtol 5e-4 / atol 1e-6, the gather loss's
(tests/test_torch_port_gather_loss.py: a table row's gradient sums up to
B*T*R gathered terms in another order); the parameters after three AdamW
steps at atol 2e-5 (tests/test_torch_port_train_step.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.models import losses as jax_losses
from mygenerativerecommenders_tpu.models.negatives import (
    InBatchNegativesSampler as JaxInBatchSampler,
)
from mygenerativerecommenders_tpu_torch.models import losses as pt_losses
from mygenerativerecommenders_tpu_torch.models.negatives import InBatchNegativesSampler
from mygenerativerecommenders_tpu_torch.train import task_retrieval as pt_task
from tests import torch_port_families as fam
from tests.test_torch_port_packing_model import _setup as _packed_setup
from tests.test_torch_port_packing_model import _widest
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

IN_BATCH = (("model.sampler.kind", "in_batch"),)
GATHER = dict(grad_rtol=fam.GATHER_GRAD_RTOL, grad_atol=fam.GATHER_GRAD_ATOL)


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_pool_and_count_equal_jax_exactly(dedup, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 30, size=(6, 11)).astype(np.int32)  # repeats and padding
    presences = (ids != 0) & (rng.random(ids.shape) < 0.8)
    want_pool, want_count = JaxInBatchSampler(dedup_embeddings=dedup).process_batch(
        jnp.asarray(ids), jnp.asarray(presences))
    pool, count = InBatchNegativesSampler(dedup_embeddings=dedup).process_batch(
        torch.from_numpy(ids), torch.from_numpy(presences))
    assert pool.dtype == torch.int32 and count.ndim == 0
    np.testing.assert_array_equal(pool.numpy(), np.asarray(want_pool))
    assert int(count) == int(want_count)
    valid = ids[presences]
    assert int(count) == (len(np.unique(valid)) if dedup else len(valid))
    # the draw: slot min(int(u * count), count - 1), as JAX maps its uniforms
    u = np.array(jax.random.uniform(jax.random.PRNGKey(seed), (5, 7)))
    got = InBatchNegativesSampler().offsets(torch.from_numpy(u), count)
    want = np.minimum((u * np.float32(int(want_count))).astype(np.int32), int(want_count) - 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bce_loss_equals_jax():
    rng = np.random.default_rng(3)
    pos, neg = (rng.normal(scale=4, size=(4, 9)).astype(np.float32) for _ in range(2))
    hits = rng.random((4, 9)) < 0.2
    weights = (rng.random((4, 9)) < 0.8).astype(np.float32)
    want = jax_losses.bce_loss(*(jnp.asarray(a) for a in (pos, neg, hits, weights)))
    got = pt_losses.bce_loss(*(torch.from_numpy(a) for a in (pos, neg, hits, weights)))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("overrides", [
    IN_BATCH,
    IN_BATCH + (("model.sampler.dedup_embeddings", False),),
    IN_BATCH + (("model.loss.kind", "bce"),),
    (("model.loss.kind", "bce"),),
], ids=["in-batch", "in-batch-no-dedup", "in-batch-bce", "bce"])
def test_loss_and_every_gradient_match_jax(overrides):
    s = fam.shared(overrides=overrides, heads=2)
    assert pt_task.make_loss_fn(s.pmodel, s.pcfg, s.item_ids).variant == "gather"
    fam.compare_loss_and_grads(s, s.batches[0], jax.random.fold_in(jax.random.PRNGKey(7), 0),
                               expect="loss_fn", **GATHER)


def test_packed_in_batch_loss_and_every_gradient_match_jax():
    jcfg, pcfg, jmodel, params, pmodel, data, train, _ = _packed_setup(blocks=2)
    for cfg in (jcfg, pcfg):
        cfg.model.sampler.kind = "in_batch"
    s = fam.Setup(jcfg, pcfg, jmodel, params, pmodel, data.all_item_ids, train)
    fam.compare_loss_and_grads(s, _widest(train), jax.random.PRNGKey(5), packed=True,
                               expect="loss_fn", **GATHER)


def test_three_adamw_steps_with_the_in_batch_sampler_match_jax():
    fam.compare_three_adamw_steps(fam.setup(overrides=IN_BATCH))


def test_in_batch_uniforms_come_from_the_generator_unless_injected():
    s = fam.shared(overrides=IN_BATCH, heads=2)
    batch = fam.torch_batch(s.batches[0])

    def loss_with(seed):
        g = torch.Generator().manual_seed(seed)
        return pt_task.make_loss_fn(s.pmodel, s.pcfg, s.item_ids, generator=g)(batch).item()

    assert loss_with(3) == loss_with(3) != loss_with(4)
    u = torch.rand(fam.draw_shape(s.pcfg, s.batches[0]), generator=torch.Generator().manual_seed(3))
    injected = pt_task.make_loss_fn(s.pmodel, s.pcfg, s.item_ids)(batch, neg_uniforms=u).item()
    assert injected == loss_with(3)
