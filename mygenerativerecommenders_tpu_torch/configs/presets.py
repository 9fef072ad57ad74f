"""Named experiment presets, mirroring the reference's Hydra experiment
overlays (configs/experiment/*.yaml): ml-1m-hstu (AdamW), -muon, -scion,
sasrec baseline, ranking, plus synthetic variants for no-network runs.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict

from mygenerativerecommenders_tpu_torch.configs import (
    Config,
    OptimizerConfig,
    SchedulerConfig,
)

_REGISTRY: Dict[str, Callable[[], Config]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_preset(name: str) -> Config:
    if name not in _REGISTRY:
        raise ValueError(f"Unknown preset {name!r}; available: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    cfg.experiment = name
    return cfg


def list_presets() -> list[str]:
    return sorted(_REGISTRY)


@register("ml-1m-hstu")
def ml_1m_hstu() -> Config:
    """configs/experiment/ml-1m-hstu.yaml: AdamW lr 1e-3 β(0.9,0.98) wd 1e-3,
    batch 128, plateau on val/ndcg@100, early stop 20, <=500 epochs."""
    cfg = Config()
    cfg.data.dataset_name = "ml-1m"
    cfg.data.batch_size = 128
    cfg.trainer.max_epochs = 500
    cfg.trainer.min_epochs = 10
    # 8 optimizer steps per device dispatch (lax.scan): the ml-1m step is
    # ~10 ms on a v5e chip, where per-call host overhead would otherwise
    # cost ~15%
    cfg.trainer.steps_per_call = 8
    return cfg


@register("ml-1m-hstu-packed")
def ml_1m_hstu_packed() -> Config:
    """The ml-1m parity recipe with SEQUENCE PACKING (r3): best-fit
    packs ~2.3 mean-111 segments per 256-token row, so a 128-example
    step runs on ~56 rows instead of 128 padded ones — measured 24.3k
    ex/s/chip vs 12.9k padded on v5e, convergence band equal
    (PARITY.md packed row). The plain ml-1m-hstu preset keeps the
    exact-RNG-parity padded path."""
    cfg = ml_1m_hstu()
    cfg.data.pack_sequences = True
    return cfg


@register("ml-1m-hstu-muon")
def ml_1m_hstu_muon() -> Config:
    """configs/experiment/ml-1m-hstu-muon.yaml: AdamW lr 5e-4 on
    embeddings+scalars, Muon lr 5e-3 on encoder matrices."""
    cfg = ml_1m_hstu()
    cfg.optimizer1 = OptimizerConfig(
        kind="adamw", lr=5e-4, betas=(0.9, 0.98), weight_decay=1e-3
    )
    cfg.optimizer2 = OptimizerConfig(
        kind="muon", lr=5e-3, momentum=0.95, nesterov=True, weight_decay=0.0
    )
    cfg.scheduler2 = SchedulerConfig(kind="plateau")
    return cfg


@register("ml-1m-hstu-scion")
def ml_1m_hstu_scion() -> Config:
    """configs/experiment/ml-1m-hstu-scion.yaml: AdamW on emb+scalars,
    Scion lr 1e-3 momentum 0.1 Auto-norm unconstrained on matrices."""
    cfg = ml_1m_hstu()
    cfg.optimizer2 = OptimizerConfig(
        kind="scion", lr=1e-3, momentum=0.1, norm="auto", unconstrained=True
    )
    cfg.scheduler2 = SchedulerConfig(kind="plateau")
    return cfg


@register("ml-1m-hstu-aux")
def ml_1m_hstu_aux() -> Config:
    """experiment/ml-1m-hstu-aux.yaml: prepend a projected user-feature
    token (sex/age_group/occupation one-hot + zip_code embedding)."""
    cfg = ml_1m_hstu()
    cfg.data.additional_columns = ("sex", "age_group", "occupation", "zip_code")
    cfg.model.preprocessor.kind = "learnable_positional_aux"
    cfg.model.preprocessor.auxiliary_columns = cfg.data.additional_columns
    cfg.model.preprocessor.encoding_types = ("onehot", "onehot", "onehot", "embed")
    cfg.model.preprocessor.categorical_dims = (2, 7, 21, 3439)
    cfg.model.preprocessor.categorical_embedding_dims = (0, 0, 0, 32)
    return cfg


@register("ml-1m-sasrec")
def ml_1m_sasrec() -> Config:
    cfg = ml_1m_hstu()
    cfg.model.encoder.kind = "sasrec"
    cfg.model.encoder.num_heads = 1
    return cfg


@register("ml-1m-rank")
def ml_1m_rank() -> Config:
    """Ranking task: CE rating loss + multiclass metrics (ranking.py)."""
    cfg = ml_1m_hstu()
    cfg.model.task = "ranking"
    cfg.model.preprocessor.kind = "combined_item_and_rating"
    cfg.model.preprocessor.num_ratings = 6
    cfg.model.loss.kind = "ce_rating"
    cfg.model.loss.temperature = 0.05
    cfg.trainer.monitor = "val/ap"
    return cfg


@register("ml-20m-hstu")
def ml_20m_hstu() -> Config:
    cfg = ml_1m_hstu()
    cfg.data.dataset_name = "ml-20m"
    cfg.data.expected_num_unique_items = 26744
    cfg.data.expected_max_item_id = 131262
    cfg.model.encoder.num_blocks = 8
    cfg.model.encoder.num_heads = 2
    return cfg


@register("ml-20m-hstu-long")
def ml_20m_hstu_long() -> Config:
    """ml-20m with 1k sequences (BASELINE config #3: "HSTU-base, longer
    sequences (1k) with jagged Pallas attention"). The fused attention
    kernel keeps memory O(B·N·D) — no [B, N, N] bias/attention tensor —
    so N=1024 fits easily; the dense [B,N,N] reference path would need
    134 MB per block-tensor at this shape. D=dqk=dv=64, H=2, 8 blocks.

    Default-on SEQUENCE PACKING with capacity classes (r3): best-fit
    packs segments into 256/512/1024/1152-token rows, each class
    emitting ~batch_size-example batches — measured 1761 ex/s vs 377
    padded (4.7x) / 1564 bucketed at realistic lognormal lengths, with
    the convergence band equal to padded (PARITY.md batching_long:
    packed ndcg@100 0.0314 vs padded 0.0304, within seed noise).
    Set data.pack_sequences=false for the exact-RNG-parity padded path."""
    cfg = ml_20m_hstu()
    cfg.data.max_sequence_length = 1024
    cfg.data.batch_size = 32
    cfg.model.item_embedding_dim = 64
    cfg.data.pack_sequences = True
    cfg.data.pack_capacities = (256, 512, 1024, 1152)
    return cfg


@register("synthetic-hstu")
def synthetic_hstu() -> Config:
    """ml-1m-shaped synthetic data (no downloads): full recipe otherwise."""
    cfg = ml_1m_hstu()
    cfg.data.dataset_name = "synthetic"
    return cfg


@register("synthetic-rank-smoke")
def synthetic_rank_smoke() -> Config:
    """Tiny ranking-task config (combined item+rating preprocessor)."""
    cfg = synthetic_smoke()
    cfg.model.task = "ranking"
    cfg.model.preprocessor.kind = "combined_item_and_rating"
    cfg.model.preprocessor.num_ratings = 6
    cfg.model.loss.kind = "ce_rating"
    cfg.trainer.monitor = "val/ap"
    return cfg


@register("synthetic-aux-smoke")
def synthetic_aux_smoke() -> Config:
    """Tiny aux-preprocessor config (synthetic user features)."""
    cfg = synthetic_smoke()
    cfg.data.additional_columns = ("sex", "age_group", "occupation", "zip_code")
    cfg.model.preprocessor.kind = "learnable_positional_aux"
    cfg.model.preprocessor.auxiliary_columns = cfg.data.additional_columns
    cfg.model.preprocessor.encoding_types = ("onehot", "onehot", "onehot", "embed")
    cfg.model.preprocessor.categorical_dims = (2, 7, 21, 100)
    cfg.model.preprocessor.categorical_embedding_dims = (0, 0, 0, 8)
    return cfg


@register("synthetic-smoke")
def synthetic_smoke() -> Config:
    """Tiny fast config for tests/CI."""
    cfg = Config()
    cfg.data.dataset_name = "synthetic-small"
    cfg.data.batch_size = 8
    cfg.data.max_sequence_length = 32
    cfg.data.synthetic_num_users = 64
    cfg.data.expected_num_unique_items = 200
    cfg.data.expected_max_item_id = 220
    cfg.model.item_embedding_dim = 16
    cfg.model.encoder.num_blocks = 2
    cfg.model.loss.num_to_sample = 16
    cfg.model.index.k = 20
    cfg.model.metrics.at_k_list = (5, 10, 20)
    cfg.trainer.monitor = "val/ndcg@10"
    cfg.trainer.max_epochs = 2
    cfg.trainer.min_epochs = 1
    cfg.trainer.log_every_n_steps = 1
    return cfg


@register("amzn-books")
def amzn_books() -> Config:
    """Amazon-Books HSTU retrieval (BASELINE config #4; reference ETL
    preprocessor.py:286-394). ~2M-item vocab after the >=5 filter, long
    tail of short sequences -> length-bucketed batching + lazy (sparse-
    row) embedding updates. Single-host runnable; see amzn-books-sharded
    for the multi-host row-sharded-table variant. Needs the raw
    ratings_Books.csv (downloaded automatically when egress exists)."""
    cfg = Config()
    cfg.data.dataset_name = "amzn-books"
    cfg.data.batch_size = 128
    cfg.data.max_sequence_length = 512
    # train: SEQUENCE PACKING (r3) — the Amazon length tail (mean ~15-20
    # after the >=5 filter) packs ~7-30 segments per row, the biggest
    # padding win in the suite; composes with lazy_update (the touched
    # row set comes from the packed layout). Eval stays length-bucketed.
    cfg.data.pack_sequences = True
    cfg.data.pack_capacities = (128, 256, 576)  # max segment 512+1 <= 576
    cfg.data.length_buckets = (64, 128, 256, 512)
    # vocab discovered from the processed item CSV at load time
    cfg.data.expected_num_unique_items = 0
    cfg.data.expected_max_item_id = 0
    cfg.model.item_embedding_dim = 64
    cfg.model.embedding.lazy_update = True
    # lazy row updates require the shared-negatives sampled-softmax fast
    # path (the per-row dense-catalog loss would densify the grad anyway)
    cfg.model.loss.shared_negatives = True
    cfg.model.encoder.num_blocks = 8
    cfg.model.encoder.num_heads = 2
    cfg.model.loss.num_to_sample = 512
    cfg.model.index.k = 200
    cfg.trainer.monitor = "val/ndcg@100"
    cfg.model.metrics.at_k_list = (10, 50, 100, 200)
    return cfg


@register("amzn-books-sharded")
def amzn_books_sharded() -> Config:
    """amzn-books with the item table row-sharded over an 8-way model
    mesh axis using OWNER-ROUTED all-to-all lookups
    (embedding.kind=sharded_a2a: ids ship to their owning shard, rows
    ship back — O(n*D/8) per-device traffic vs the psum-broadcast form's
    full [B*N, D] reduce) — the multi-host large-vocab recipe."""
    cfg = amzn_books()
    cfg.model.embedding.kind = "sharded_a2a"
    cfg.model.embedding.num_shards = 8
    cfg.model.embedding.lazy_update = False  # dense update is sharded too
    return cfg


@register("synthetic-large-vocab")
def synthetic_large_vocab() -> Config:
    """10M-item synthetic retrieval (BASELINE config #5): row-sharded
    embedding table with owner-routed all-to-all lookups (8 shards;
    10M x 64 f32 = 2.6 GB split 320 MB/shard), sharded top-k, int8
    pre-ranked eval scan. Scale knobs: data.expected_max_item_id /
    embedding.num_shards. See synthetic-large-vocab-100m for the full
    BASELINE scale with 2-D (row x column) sharding."""
    cfg = Config()
    cfg.data.dataset_name = "synthetic-large"
    cfg.data.batch_size = 64
    cfg.data.max_sequence_length = 200
    cfg.data.synthetic_num_users = 4096
    cfg.data.expected_num_unique_items = 10_000_000
    cfg.data.expected_max_item_id = 10_000_000
    cfg.model.item_embedding_dim = 64
    cfg.model.embedding.kind = "sharded_a2a"
    cfg.model.embedding.num_shards = 8
    cfg.model.encoder.num_blocks = 4
    cfg.model.encoder.num_heads = 2
    cfg.model.loss.num_to_sample = 512
    cfg.model.index.k = 200
    cfg.model.index.quantize = "int8"
    cfg.model.metrics.at_k_list = (10, 50, 100, 200)
    cfg.trainer.monitor = "val/ndcg@100"
    return cfg


@register("synthetic-large-vocab-100m")
def synthetic_large_vocab_100m() -> Config:
    """BASELINE config #5 at its stated scale: 100M-item synthetic
    retrieval with the item table 2-D sharded — 8 row shards ("model",
    owner-routed all-to-all id exchange) x 2 column shards ("col", tiled
    all_gather), 16 table devices.

    Memory plan per table device at 100M x 64 f32 (table rows padded to
    the row-shard multiple):
      table slice        100e6*64*4 / 16 = 1.6 GB
      AdamW m+v          2x table slice  = 3.2 GB
      int8 index slice   100e6*64*1 / 16 = 0.4 GB (+ f32 scales 0.025 GB)
      total              ~5.2 GB of a v5e's 16 GB HBM, leaving ~10 GB for
                         activations + the dense model.
    Scale knobs: embedding.num_shards x embedding.col_shards must divide
    the mesh (model x col axes); halve the per-device slice by doubling
    either. Lookup traffic per device per step is
    B*N*D*4/num_shards bytes each way (a2a) — independent of vocab.
    Tested at reduced vocab on the 8-device CPU mesh
    (tests/test_sharded_a2a_model.py); single-chip v5e runs the 10M
    variant (synthetic-large-vocab, PERFORMANCE.md lazy_update row).
    """
    cfg = synthetic_large_vocab()
    cfg.data.expected_num_unique_items = 100_000_000
    cfg.data.expected_max_item_id = 100_000_000
    cfg.model.embedding.kind = "sharded_2d"
    cfg.model.embedding.num_shards = 8
    cfg.model.embedding.col_shards = 2
    # SHARDED top-k (index.sharded auto-engages): the candidate matrix
    # stays row-sharded and eval merges per-shard winners — no device
    # ever holds the 25.6 GB [100M, 64] matrix. The inherited int8
    # pre-ranking composes: each shard pre-ranks its own int8 slice and
    # re-scores locally against its own exact rows.
    return cfg


@register("synthetic-rank")
def synthetic_rank() -> Config:
    """Ranking-recipe convergence study on learnable synthetic data:
    ratings drawn around a per-item latent quality
    (data.synthetic_rating_quality), so AUROC/AP/precision/recall must
    rise well above chance — the ranking analog of PARITY.md's retrieval
    convergence bands."""
    cfg = ml_1m_rank()
    cfg.data.dataset_name = "synthetic-rankq"
    cfg.data.synthetic_rating_quality = True
    cfg.data.synthetic_num_users = 2048
    cfg.trainer.max_epochs = 30
    cfg.trainer.min_epochs = 5
    return cfg
