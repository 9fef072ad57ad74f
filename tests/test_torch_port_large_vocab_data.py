"""`synthetic-large-vocab` on the CPU: the synthetic draw made with its cdf
built once, and the preset at reduced size through the port's trainer and
engine.

The draw must give `rng.choice(num_items, size=n, p=pop)`'s ids bit for bit
(the JAX package's `SyntheticDataProcessor` draws with it). The preset runs
with the JAX package's one-chip overlay (`model.embedding.kind=local
model.embedding.num_shards=1`), cut to 64 users, 1 block, 16 negatives and
250,000 items, which keeps its batch of 64 x 211 rows past the auto gate of
the dense-catalog loss (64 x 211 x 250,112 > 3e9): one epoch each of the
gather loss under the auto gate, of shared negatives with dense AdamW and of
the lazy update, each evaluated on the int8 index, then served from it.
"""

import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu_torch.cli import train as cli_train
from mygenerativerecommenders_tpu_torch.data.catalog import SYNTHETIC_SEED, synthetic_catalog
from mygenerativerecommenders_tpu_torch.data.synthetic import synthetic_interactions
from mygenerativerecommenders_tpu_torch.ops.quantized_topk import QuantizedCatalog
from mygenerativerecommenders_tpu_torch.serving.service import ServingEngine
from mygenerativerecommenders_tpu_torch.train.driver import Trainer
from mygenerativerecommenders_tpu_torch.train.lazy_embedding import LazyEmbeddingAdamW
from mygenerativerecommenders_tpu_torch.train.task_retrieval import loss_variant
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _choice_draw(num_users, num_items, max_item_id, max_seq_len):
    """The items of each user as the JAX package draws them (data/preprocessor.py:273-286)."""
    rng = np.random.default_rng(SYNTHETIC_SEED)
    catalog = synthetic_catalog(num_items, max_item_id, rng)
    pop = 1.0 / np.arange(1, num_items + 1) ** 0.8
    pop /= pop.sum()
    out = []
    for _ in range(num_users):
        n = int(rng.integers(5, max_seq_len + 1))
        out.append(catalog[rng.choice(num_items, size=n, p=pop)])
        rng.integers(0, 3 * 365 * 86400, size=n)
        rng.integers(1, 6, size=n)
    return catalog, out


@pytest.mark.parametrize("num_items,max_item_id", [(200, 220), (5_000, 5_000), (4_000, 9_000)])
def test_the_draw_gives_rng_choice_ids(num_items, max_item_id):
    catalog, want = _choice_draw(40, num_items, max_item_id, 200)
    got = synthetic_interactions(40, num_items, max_item_id, 200)
    np.testing.assert_array_equal(got.catalog, catalog)
    assert len(got.item_ids) == len(want)
    for a, b in zip(got.item_ids, want):
        np.testing.assert_array_equal(a, b)


REDUCED = [
    "experiment=synthetic-large-vocab", "model.embedding.kind=local",
    "model.embedding.num_shards=1", "trainer.device=cpu", "trainer.max_epochs=1",
    "trainer.min_epochs=1", "data.synthetic_num_users=64",
    "data.expected_num_unique_items=250000", "data.expected_max_item_id=250000",
    "model.encoder.num_blocks=1", "model.loss.num_to_sample=16",
]
VARIANTS = {
    "gather": [],  # the auto gate: 64 x 211 x 250,112 > 3e9
    "shared": ["model.loss.shared_negatives=true"],
    "lazy": ["model.loss.shared_negatives=true", "model.embedding.lazy_update=true"],
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_reduced_preset_trains_evaluates_and_serves_on_int8(tmp_path, variant):
    cfg = cli_train.parse_args(REDUCED + VARIANTS[variant] + [f"trainer.output_dir={tmp_path}"])
    assert cfg.model.index.quantize == "int8" and cfg.data.batch_size == 64
    trainer = Trainer(cfg)
    assert loss_variant(cfg, len(trainer.all_item_ids)) == (
        "gather" if variant == "gather" else "shared")
    assert isinstance(trainer.optimizer, LazyEmbeddingAdamW) == (variant == "lazy")
    results = trainer.fit()
    assert trainer.global_step == 1  # 64 users, one batch of 64
    assert all(0.0 <= v <= 1.0 for v in results.values()) and "ndcg@100" in results
    assert np.isfinite(trainer.train_epoch(trainer._loader("train")))
    assert isinstance(trainer.candidate_fn(), QuantizedCatalog)
    engine = ServingEngine(trainer.model, cfg, trainer.all_item_ids, trainer.data.max_item_id,
                           batch_size=4, device="cpu")
    seqs = [[1, 2, 3], [7, 70_000, 249_999]]
    ids, scores = engine.retrieve(seqs)
    for seq, row, sc in zip(seqs, ids, scores):
        assert len(row) == 200 and not set(seq) & set(row)
        assert set(row) <= set(range(1, 250_001)) and sc == sorted(sc, reverse=True)
    (greedy,) = engine.generate(seqs[:1], steps=2)
    assert len(greedy) == 2 and not set(seqs[0]) & set(greedy)
    with torch.no_grad():
        assert torch.isfinite(trainer.model.embeddings._item_emb.weight).all()
