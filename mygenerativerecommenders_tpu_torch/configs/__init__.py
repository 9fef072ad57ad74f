"""Dataclass config tree + dotted-path CLI overrides.

The PyTorch port's own copy of `mygenerativerecommenders_tpu/configs`: the
same fields, defaults and override grammar, so one command line configures
either package. Knobs the port does not implement yet raise where they are
read (see ROADMAP.md, queue 1).

The JAX package's replacement for the reference's Hydra tree (configs/*.yaml
+ utils/instantiators.py): nested frozen-less dataclasses, named
experiment presets (configs/presets.py), `key.path=value` overrides with
dataclass-driven type coercion, and derived-dim resolution
(`resolve(config, data_info)`) mirroring the reference's "dims inferred
from datamodule" behavior (generative_recommenders.py:105-239).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


# --------------------------------------------------------------------------
# Component configs (mirror the reference's component families, SURVEY §2)
# --------------------------------------------------------------------------


@dataclass
class EmbeddingConfig:
    # local | item_year | categorical
    # | sharded_local  (rows over "model", psum-broadcast lookup)
    # | sharded_a2a    (rows over "model", owner-routed all-to-all lookup —
    #                   O(n*D/num_shards) per-device traffic; the production
    #                   mechanism at large vocab / batch)
    # | sharded_column (columns over "model": local gathers + one all_gather)
    # | sharded_2d     (rows over "model" x columns over "col": a2a exchange
    #                   of D/col_shards slices + col all_gather; pod-scale)
    kind: str = "local"
    item_embedding_dim: int = 50
    num_items: int = 0  # 0 -> filled from data (max item id)
    init_std: float = 0.02
    # sharded_*: row shards over the "model" axis (column shards for
    # sharded_column, which also rides "model")
    num_shards: int = 1
    # sharded_2d only: column shards over the "col" mesh axis
    col_shards: int = 1
    # sharded_a2a / sharded_2d: per-owner bucket capacity as a multiple of
    # the balanced share n/num_shards; overflow stays exact via a psum
    # residual, so this trades skew headroom against exchange buffer size
    a2a_capacity_factor: float = 2.0
    # Opt-in ALGORITHM CHANGE (torch SparseAdam analog): update only the
    # table rows a step touches (B*T positives + R shared negatives) —
    # untouched rows get no momentum motion and no weight decay. Kills
    # the dense [V, D] gradient + p/m/v optimizer passes that dominate
    # at production vocab scales (~7 full-table passes over device memory
    # a step).
    # Requires loss.shared_negatives + local sampler + dot_product +
    # embedding.kind=local + optimizer1.kind=adamw
    # (train/lazy_embedding.py).
    lazy_update: bool = False


@dataclass
class PreprocessorConfig:
    kind: str = "learnable_positional"  # | learnable_positional_rated | ..._aux | combined_item_and_rating
    dropout_rate: float = 0.2
    num_ratings: int = 6
    rating_embedding_dim: int = 0
    # aux variant (ml-1m user features; experiment/ml-1m-hstu-aux.yaml)
    auxiliary_columns: Tuple[str, ...] = ()
    encoding_types: Tuple[str, ...] = ()
    categorical_dims: Tuple[int, ...] = ()
    categorical_embedding_dims: Tuple[int, ...] = ()


@dataclass
class EncoderConfig:
    kind: str = "hstu"  # hstu | sasrec
    num_blocks: int = 2
    num_heads: int = 1
    attention_dim: int = 0  # 0 -> item_embedding_dim
    linear_dim: int = 0  # 0 -> item_embedding_dim
    linear_dropout_rate: float = 0.2
    attn_dropout_rate: float = 0.0
    normalization: str = "rel_bias"
    linear_activation: str = "silu"
    concat_ua: bool = False
    enable_relative_attention_bias: bool = True
    relative_bias_type: str = "time_position"
    num_time_buckets: int = 128
    # "auto" or true: the fused attention (the CUDA kernel on the card, its
    # plain version on the CPU); the port has no other path, so false raises
    use_pallas: str = "auto"
    # >1: ring (sequence-parallel) attention (parallel/ring_attention.py);
    # hstu only, padded rows only (packing raises). The JAX package shards
    # the sequence axis over an "sp" mesh axis of this many devices; the
    # port runs the P shards of the ring in turn on its one device, each
    # chunk product through the chunk kernels (ops/kernels/hstu_chunk.py)
    sp_shards: int = 1
    # >1: tensor-parallel encoder matrices over the "model" mesh axis —
    # uvqk kernels column-sharded P(None, "model"), output-projection
    # kernels row-sharded P("model", None); XLA/GSPMD partitions the
    # matmuls and inserts the collectives (Megatron-style column->row
    # split, reference has no TP at all — SURVEY §2.4). hstu only;
    # composes with embedding.kind=sharded_local when the shard counts
    # match (both ride the same "model" axis). Incompatible with
    # sp_shards>1 (the ring's shard_map body consumes unsharded heads).
    tp_shards: int = 1
    # zigzag (load-balanced) ring layout: shard p holds the sequence
    # chunk pair (p, 2P-1-p), halving per-step causal attention work. On
    # the port's one device the shards run in turn, so the balance buys no
    # time; a block then makes 36 chunk launches at P=4 (10 contiguous,
    # where the chunks with no live pair are skipped)
    sp_zigzag: bool = False
    # rematerialize each HSTU block under jax.checkpoint: the training
    # forward then keeps NO per-block [B*H, N, N] z residuals (2.7 GB at
    # the ml-20m-hstu-long shape) — each block's forward reruns inside
    # its backward. Trades ~1 extra fwd of compute for O(blocks * N^2)
    # activation memory; enables much larger B*N per chip.
    remat: bool = False
    # sasrec only
    ffn_hidden_dim: int = 0


@dataclass
class PostprocessorConfig:
    kind: str = "l2_norm"  # l2_norm | layer_norm
    eps: float = 1e-6


@dataclass
class SimilarityConfig:
    kind: str = "dot_product"  # dot_product | mol
    # MoL params (similarity/mol.py)
    query_dot_product_groups: int = 4
    item_dot_product_groups: int = 4
    dot_product_dimension: int = 16
    dot_product_l2_norm: bool = True
    gating_combination_type: str = "glu_silu"
    temperature: float = 0.05


@dataclass
class SamplerConfig:
    kind: str = "local"  # local | in_batch
    l2_norm: bool = True
    l2_norm_eps: float = 1e-6
    dedup_embeddings: bool = True


@dataclass
class LossConfig:
    kind: str = "sampled_softmax"  # sampled_softmax | bce | bce_ratings | ce_rating
    num_to_sample: int = 128
    temperature: float = 0.05
    # Dense-catalog evaluation of the sampled-softmax negatives (local
    # sampler only): the negatives' multiplicities over the catalog (the
    # count kernel) and a log-sum-exp over the live q.catalog logits (the
    # lse kernels) replace the per-sample [B,T,R,D] gather/scatter.
    # Mathematically identical loss/grads — see ops/dense_negatives.py.
    # auto -> on when applicable.
    dense_catalog_negatives: str = "auto"  # auto | true | false
    # Opt-in ALGORITHM CHANGE (off the reference-parity path): draw ONE
    # set of num_to_sample negatives per optimizer step, shared by every
    # supervision position, instead of the reference's independent
    # per-position draw (autoregressive_losses.py:272-279). Negative
    # scoring collapses to a single [B*T, D] @ [D, R] matmul — no count
    # histogram, no catalog-wide scoring — which removes the last big
    # single op of the dense path (PERFORMANCE.md "next optimizations").
    # Standard large-scale sampled-softmax practice; takes precedence
    # over dense_catalog_negatives when set.
    shared_negatives: bool = False


@dataclass
class IndexConfig:
    k: int = 200
    filter_past_ids: bool = True
    # "int8": store the candidate matrix as symmetric per-row int8 and
    # pre-rank on the int8 rows (a quarter of the float32 catalog's
    # bytes), then re-score rescore_over_fetch*k candidates against the
    # exact f32 rows (ops/quantized_topk.py). "none" = reference-exact scan.
    # NOTE: the eval step is shared between serving and the training
    # driver, so enabling int8 also makes val/test metrics, plateau-LR
    # scheduling, and best-checkpoint selection run on the approximate
    # pre-ranked scan. Intended as a serving MEMORY lever (4x smaller
    # catalog residency — NOT faster at D=50-64, see
    # ops/quantized_topk.py); keep "none" for training runs whose
    # checkpoint selection must be exact.
    quantize: str = "none"  # none | int8
    rescore_over_fetch: int = 4
    # > 0: the JAX package routes the (non-sharded, non-int8) top-k
    # selection through jax.lax.approx_max_k with this per-element recall
    # target, which is approximate on the TPU only and exact on every
    # other backend. The port takes the exact selection for it, on the
    # CPU and the card (ops/topk.py). 0.0 = exact.
    approx_top_k_recall: float = 0.0
    # SHARDED candidate index: keep the [X, D] candidate matrix row-
    # sharded over the "model" axis and evaluate top-k as local-topk +
    # O(shards*k) merge (parallel/topk_sharded.py) — no device ever holds
    # the full matrix (required at 100M-item catalogs). "auto" -> on when
    # the embedding table is sharded. Composes with quantize=int8: each
    # shard pre-ranks its own int8 slice and re-scores locally against
    # its own exact rows, so the merge runs on exact scores.
    sharded: str = "auto"  # auto | true | false


@dataclass
class MetricsConfig:
    at_k_list: Tuple[int, ...] = (10, 50, 100, 200)


@dataclass
class ModelConfig:
    task: str = "retrieval"  # retrieval | ranking
    gr_output_length: int = 10
    item_embedding_dim: int = 50
    embedding: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    preprocessor: PreprocessorConfig = field(default_factory=PreprocessorConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    postprocessor: PostprocessorConfig = field(default_factory=PostprocessorConfig)
    similarity: SimilarityConfig = field(default_factory=SimilarityConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    # compute dtype for the encoder ("float32" | "bfloat16")
    compute_dtype: str = "float32"


@dataclass
class OptimizerConfig:
    kind: str = "adamw"  # adamw | muon | scion | scion_light | sgd
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.98)
    weight_decay: float = 1e-3
    eps: float = 1e-8
    momentum: float = 0.95  # muon/scion
    nesterov: bool = True  # muon
    ns_steps: int = 5  # muon/scion newton-schulz iterations
    norm: str = "auto"  # scion norm strategy
    scale: float = 1.0  # scion
    unconstrained: bool = True  # scion
    scion_init: bool = False  # re-init managed params per the Scion norm
    enabled: bool = True  # optimizer2 slot can be disabled


@dataclass
class SchedulerConfig:
    kind: str = "plateau"  # plateau | none | cosine
    mode: str = "max"
    factor: float = 0.1
    patience: int = 10
    threshold: float = 1e-4
    min_lr: float = 0.0


@dataclass
class DataConfig:
    dataset_name: str = "ml-1m"
    batch_size: int = 128
    eval_batch_size: int = 0  # 0 -> batch_size
    max_sequence_length: int = 200
    chronological: bool = True
    positional_sampling_ratio: float = 1.0
    data_dir: str = "tmp"
    # dataset constants (filled by the preprocessor / presets)
    expected_num_unique_items: int = 3706
    expected_max_item_id: int = 3952
    # synthetic fallback (no-egress environments)
    synthetic_num_users: int = 2048
    # longest generated synthetic history (uniform [5, this]); raise to
    # max_sequence_length for long-N (N=1024) recipe studies
    synthetic_max_seq_len: int = 200
    # item-quality-correlated synthetic ratings (learnable ranking task)
    synthetic_rating_quality: bool = False
    item_year_feature: bool = False
    # per-user scalar feature columns to carry into batches (aux variant)
    additional_columns: Tuple[str, ...] = ()
    # length-bucketed batching: ascending history-length capacities; each
    # batch holds sequences of one bucket, truncated to that capacity, so
    # short sequences stop paying max_sequence_length compute (the jagged
    # no-padding-waste property; one XLA compile per bucket shape). The
    # last bucket must equal max_sequence_length. () = off.
    length_buckets: Tuple[int, ...] = ()
    # SEQUENCE PACKING (train path): lay several examples end-to-end per
    # row — each segment is its history + target as the final token —
    # with block-diagonal attention via seg_ids and per-segment
    # positional embeddings (data/packing.py). Removes within-row padding
    # entirely (the true analog of the reference's jagged [sum(N_i), D]
    # layout, hstu.py:439-480) under ONE compiled program, unlike
    # bucketing's program-per-capacity. Retrieval task + HSTU rel_bias +
    # learnable_positional preprocessor only; eval stays unpacked.
    pack_sequences: bool = False
    # tokens per packed row; 0 -> 2 * round_up(max_sequence_length+1, 128)
    pack_row_capacity: int = 0
    # rows per packed batch; 0 -> sized so a batch carries about
    # batch_size segments on average (from the dataset's mean length)
    pack_rows: int = 0
    # ascending capacity CLASSES for packing-inside-buckets: each example
    # packs with the smallest capacity >= its segment length, so short
    # segments ride narrow rows (keeping the O(row_len^2) bias-gradient
    # terms small) while rare long ones get wide rows. () = single
    # capacity (pack_row_capacity). The largest must cover the longest
    # segment (max_sequence_length + 1).
    pack_capacities: Tuple[int, ...] = ()
    # EVAL packing policy when pack_sequences is on (train packing never
    # depends on this). "auto" packs eval iff max_sequence_length >= 512:
    # the JAX package's threshold, kept for parity (the port has not
    # timed packed against padded eval). "true"/"false" force.
    pack_eval: str = "auto"


@dataclass
class TrainerConfig:
    # the port's own field: where the trainer runs. "cuda" (the default: a
    # machine without a card raises) or "cpu" (the kernels' plain versions)
    device: str = "cuda"
    seed: int = 42
    max_epochs: int = 500
    min_epochs: int = 10
    monitor: str = "val/ndcg@100"
    mode: str = "max"
    early_stop_patience: int = 20
    check_val_every_n_epoch: int = 1
    limit_train_batches: float = 1.0
    limit_val_batches: float = 1.0
    fast_dev_run: bool = False
    overfit_batches: int = 0
    log_every_n_steps: int = 50
    # in-place per-step console progress line (the reference's
    # callbacks/rich_progress_bar.yaml analog); renders only when stderr
    # is a TTY, so CI/log-file runs are unaffected
    progress_bar: bool = True
    output_dir: str = "outputs"
    ckpt_path: str = ""  # resume path
    save_top_k: int = 1
    detect_anomaly: bool = False  # jax.debug_nans
    profiler: bool = False
    tensorboard: bool = False  # also write TB event files (tensorboardX)
    # MLflow file-store tracking dir ("" = off): writes the mlruns/ layout
    # the real MLflow UI reads, with no mlflow dependency
    mlflow_dir: str = ""

    # data-parallel ranks: 0 -> the world size; any other value must equal
    # it (one card a process, so more than 1 needs `distributed`)
    num_devices: int = 0
    # data parallel over processes launched by torchrun: start the default
    # process group from torchrun's environment (RANK, WORLD_SIZE,
    # LOCAL_RANK, MASTER_ADDR, MASTER_PORT; NCCL on cuda, gloo on the CPU)
    # and give each rank its data coordinate, the rank, of the data size,
    # the world size: its strided rows of every global batch
    # (parallel/process_group.py)
    distributed: bool = False
    # the layout of the ranks over the JAX mesh's axes: the port has the
    # data axis alone (one card a process), so a rank loads its strided
    # rows either way and the flag changes nothing
    mesh_data_innermost: bool = False
    # host->device pipeline depth: batches resident on device ahead of
    # the step consuming them (2 = classic double buffering; 0/1 = off)
    prefetch: int = 2
    # train steps fused into one device call (lax.scan over stacked
    # batches): amortizes per-step host dispatch overhead, which
    # dominates once the step itself is a few ms. 1 = one call per step.
    # Quality-neutral: per-step RNG keys are fold_in(base, global_step),
    # so the training stream is bit-identical at every steps_per_call.
    steps_per_call: int = 1
    # async checkpointing: orbax writes the checkpoint to disk in a
    # background thread while the next epoch trains (the device->host
    # copy stays synchronous); the meta.json sidecar is written at the
    # next save / restore / teardown flush
    async_checkpoint: bool = False
    # the JAX package's persistent XLA compilation cache directory ("" =
    # off); the port compiles nothing with XLA and reads it nowhere
    jax_cache_dir: str = "~/.cache/mygenerativerecommenders_tpu/xla"


@dataclass
class Config:
    experiment: str = "ml-1m-hstu"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optimizer1: OptimizerConfig = field(default_factory=OptimizerConfig)
    optimizer2: OptimizerConfig = field(
        default_factory=lambda: OptimizerConfig(enabled=False)
    )
    scheduler1: SchedulerConfig = field(default_factory=SchedulerConfig)
    scheduler2: SchedulerConfig = field(
        default_factory=lambda: SchedulerConfig(kind="none")
    )
    trainer: TrainerConfig = field(default_factory=TrainerConfig)


# --------------------------------------------------------------------------
# Derived-dim resolution (the reference's datamodule->model dim flow)
# --------------------------------------------------------------------------


def resolve(cfg: Config, max_item_id: int) -> Config:
    """Fill 0-valued derived dims from data, like the reference's
    __hydra_init_submodules (generative_recommenders.py:105-239)."""
    m = cfg.model
    if m.embedding.num_items == 0:
        m.embedding.num_items = max_item_id
    if m.embedding.item_embedding_dim != m.item_embedding_dim:
        m.embedding.item_embedding_dim = m.item_embedding_dim
    if m.encoder.attention_dim == 0:
        m.encoder.attention_dim = m.item_embedding_dim
    if m.encoder.linear_dim == 0:
        m.encoder.linear_dim = m.item_embedding_dim
    if m.encoder.ffn_hidden_dim == 0:
        m.encoder.ffn_hidden_dim = m.item_embedding_dim
    if cfg.data.eval_batch_size == 0:
        cfg.data.eval_batch_size = cfg.data.batch_size
    return cfg


def max_seq_len(cfg: Config) -> int:
    """data.max_sequence_length + gr_output_length + 1 (model/hstu.yaml:13)."""
    return cfg.data.max_sequence_length + cfg.model.gr_output_length + 1


# --------------------------------------------------------------------------
# Dotted overrides:  model.encoder.num_blocks=4  trainer.fast_dev_run=true
# --------------------------------------------------------------------------


def _coerce(value: str, target_type: Any) -> Any:
    if target_type is bool or isinstance(target_type, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if target_type is int:
        return int(value)
    if target_type is float:
        return float(value)
    if target_type is str:
        return value
    # tuples / Optional / etc: try JSON then literal string
    try:
        parsed = json.loads(value)
        if isinstance(parsed, list):
            return tuple(parsed)
        return parsed
    except (json.JSONDecodeError, ValueError):
        return value


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override must be key.path=value, got: {ov!r}")
        path, value = ov.split("=", 1)
        obj = cfg
        parts = path.split(".")
        for p in parts[:-1]:
            if not hasattr(obj, p):
                raise ValueError(f"Unknown config path: {path!r} (at {p!r})")
            obj = getattr(obj, p)
        leaf = parts[-1]
        if not hasattr(obj, leaf):
            raise ValueError(f"Unknown config key: {path!r}")
        current = getattr(obj, leaf)
        ftypes = {f.name: f.type for f in dataclasses.fields(obj)}
        target = type(current) if current is not None else ftypes.get(leaf, str)
        setattr(obj, leaf, _coerce(value, target))
    return cfg


def to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(x) for x in cfg]
    return cfg
