"""The composed generative-recommender model.

Port of mygenerativerecommenders_tpu/models/model.py:59-291 for the
components the retrieval and ranking tasks run: local, item/year or sharded
embedding (the four `sharded_*` kinds, their shards run in turn on this
device, or one a rank once parallel/tensor_parallel.py:place_model has
placed the model on a mesh: models/embeddings.py) -> learnable positional preprocessor (plain, rated, combined
item-and-rating or aux; with dropout) -> HSTU (pointwise or softmax
attention) or SASRec -> aux-mask compaction -> L2 or LayerNorm
postprocessor, dot-product or MoL similarity. The encoder's dims follow the preprocessor's layout:
the rated variant widens D (the postprocessor truncates back to
item_embedding_dim), the combined one doubles N, and its aux_mask maps the
encoder's output back to the item slots (the aux variant's drops its user
token). Other kinds raise, naming the ROADMAP.md item that ports them.
Submodule names follow the reference checkpoint's keys, so `state_dict()`
reads `embeddings._item_emb.weight` (and `embeddings._year_emb.weight`),
`preprocessor._pos_emb.weight`,
`preprocessor._rating_emb.weight`, `sequence_encoder._hstu._attention_layers.{i}...`;
the aux preprocessor's, SASRec's and MoL's parameters, which the JAX
converter maps to no reference key, keep the JAX leaves' names
(`preprocessor.aux_projection.kernel`, `sequence_encoder._sasrec.mha_{i}...`,
`similarity.gate_ci.bias`; checkpoint.py).

Only the training loss scores through `score` (MoL or the dot product), as
in the JAX package: its eval, candidate index, serving and decode rank by
the dot product with the catalog rows whatever `similarity.kind` says
(ROADMAP.md queue 3).

`model.compute_dtype=bfloat16` casts the encoder's input to bfloat16 and its
output to float32, as JAX's `__call__` does (:275-282); the encoders round
at JAX's points and nowhere else. The list of those points, taken from
`jax.make_jaxpr` of JAX's forward, is in models/precision.py. Parameters stay
float32.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from mygenerativerecommenders_tpu_torch.configs import Config, ModelConfig, max_seq_len
from mygenerativerecommenders_tpu_torch.models.embeddings import (
    ColumnShardedLocalEmbedding,
    ItemYearEmbedding,
    LocalEmbedding,
    Sharded2DEmbedding,
    ShardedA2AEmbedding,
    ShardedLocalEmbedding,
)
from mygenerativerecommenders_tpu_torch.models import precision
from mygenerativerecommenders_tpu_torch.models.hstu import HSTU
from mygenerativerecommenders_tpu_torch.models.postprocessors import (
    L2NormPostprocessor,
    LayerNormPostprocessor,
)
from mygenerativerecommenders_tpu_torch.models.preprocessors import (
    CombinedItemAndRatingPreprocessor,
    LearnablePositionalEmbeddingAuxPreprocessor,
    LearnablePositionalEmbeddingPreprocessor,
    LearnablePositionalEmbeddingRatedPreprocessor,
)
from mygenerativerecommenders_tpu_torch.models.sasrec import SASRec
from mygenerativerecommenders_tpu_torch.models.similarity import DotProductSimilarity
from mygenerativerecommenders_tpu_torch.models.similarity_mol import MoLSimilarity
from mygenerativerecommenders_tpu_torch.ops.sequence import mask_dense_by_aux_mask
from mygenerativerecommenders_tpu_torch.utils.features import SequenceBatch


class GenerativeRecommender(nn.Module):
    """Embedding + preprocessor + encoder + postprocessor (+ similarity)."""

    def __init__(
        self,
        cfg: ModelConfig,
        total_seq_len: int,  # data.max_sequence_length + gr_output_length + 1
        generator: Optional[torch.Generator] = None,
        year_of_item: Optional[Sequence[int]] = None,  # item id -> year, for item_year
    ):
        super().__init__()
        m = cfg
        self.cfg = m
        # the encoder's input dtype; the encoder rounds where JAX's does
        # (models/precision.py) and returns float32
        self.compute_dtype = precision.compute_dtype(m.compute_dtype)
        e = m.embedding
        emb_shards = e.num_shards if e.kind.startswith("sharded") else 1
        tp_shards = m.encoder.tp_shards if m.encoder.kind == "hstu" else 1
        if emb_shards > 1 and tp_shards > 1 and emb_shards != tp_shards:
            # the JAX trainer's check (train/driver.py:125-147)
            raise ValueError(
                "embedding.num_shards and encoder.tp_shards both use the "
                f"'model' mesh axis and must match ({emb_shards} vs {tp_shards})"
            )
        if e.kind == "local":
            self.embeddings = LocalEmbedding(
                e.num_items, m.item_embedding_dim, e.init_std, generator
            )
        elif e.kind == "sharded_local":
            self.embeddings = ShardedLocalEmbedding(
                e.num_items, m.item_embedding_dim, e.num_shards, e.init_std, generator
            )
        elif e.kind == "sharded_a2a":
            self.embeddings = ShardedA2AEmbedding(
                e.num_items, m.item_embedding_dim, e.num_shards, e.a2a_capacity_factor,
                e.init_std, generator,
            )
        elif e.kind == "sharded_column":
            self.embeddings = ColumnShardedLocalEmbedding(
                e.num_items, m.item_embedding_dim, e.num_shards, e.init_std, generator
            )
        elif e.kind == "sharded_2d":
            self.embeddings = Sharded2DEmbedding(
                e.num_items, m.item_embedding_dim, e.num_shards, e.col_shards,
                e.a2a_capacity_factor, e.init_std, generator,
            )
        elif e.kind == "item_year":
            if year_of_item is None or len(year_of_item) == 0:
                raise ValueError(
                    "item_year embedding requires year_of_item (pass the "
                    "data catalog's item->year table to build_model)"
                )
            self.embeddings = ItemYearEmbedding(
                e.num_items, m.item_embedding_dim, year_of_item, e.init_std, generator,
            )
        else:
            raise ValueError(f"Unknown embedding kind {e.kind}")
        p = m.preprocessor
        if p.kind == "learnable_positional":
            self.preprocessor = LearnablePositionalEmbeddingPreprocessor(
                total_seq_len, m.item_embedding_dim, generator, p.dropout_rate
            )
        elif p.kind == "learnable_positional_rated":
            self.preprocessor = LearnablePositionalEmbeddingRatedPreprocessor(
                total_seq_len, m.item_embedding_dim, p.rating_embedding_dim, p.num_ratings,
                generator, p.dropout_rate,
            )
        elif p.kind == "combined_item_and_rating":
            self.preprocessor = CombinedItemAndRatingPreprocessor(
                total_seq_len, m.item_embedding_dim, p.num_ratings, generator, p.dropout_rate
            )
        elif p.kind == "learnable_positional_aux":
            self.preprocessor = LearnablePositionalEmbeddingAuxPreprocessor(
                total_seq_len, m.item_embedding_dim, p.auxiliary_columns, p.encoding_types,
                p.categorical_dims, p.categorical_embedding_dims, generator, p.dropout_rate,
            )
        else:
            raise ValueError(f"Unknown preprocessor kind {p.kind}")
        # the combined variant doubles N, the rated one widens D
        seq_mult = 2 if p.kind == "combined_item_and_rating" else 1
        enc_dim = m.item_embedding_dim + (
            p.rating_embedding_dim if p.kind == "learnable_positional_rated" else 0
        )
        enc = m.encoder
        if enc.attn_dropout_rate != 0.0:
            # JAX's HSTU takes the field and never reads it; its SASRec is
            # not given it (model.py:169, :183-190)
            raise ValueError(
                f"encoder.attn_dropout_rate={enc.attn_dropout_rate}: the reference ignores "
                "this field (neither of its encoders applies attention dropout); set it to 0.0"
            )
        if enc.kind == "sasrec" and enc.remat:
            # JAX passes remat to the HSTU encoder only (model.py:180)
            raise ValueError(
                "encoder.remat=true with encoder.kind=sasrec: the reference ignores remat "
                "for SASRec (only its HSTU encoder rematerialises); set encoder.remat=false"
            )
        if enc.kind == "sasrec":
            # keyed "_sasrec"; the JAX wiring (:182-192): the linear dropout
            # rate, ffn_hidden_dim (resolved to D when 0), max_sequence_len unread
            self.encoder_key = "_sasrec"
            self.sequence_encoder = nn.ModuleDict({"_sasrec": SASRec(
                max_sequence_len=seq_mult * total_seq_len,
                embedding_dim=enc_dim,
                num_blocks=enc.num_blocks,
                num_heads=enc.num_heads,
                ffn_hidden_dim=enc.ffn_hidden_dim or enc_dim,
                dropout_rate=enc.linear_dropout_rate,
                generator=generator,
            )})
        elif enc.kind == "hstu":
            self._build_hstu(m, total_seq_len, seq_mult, enc_dim, generator)
        else:
            raise ValueError(f"Unknown encoder kind {enc.kind}")
        if m.postprocessor.kind == "l2_norm":
            self.postprocessor = L2NormPostprocessor(m.item_embedding_dim, m.postprocessor.eps)
        elif m.postprocessor.kind == "layer_norm":
            self.postprocessor = LayerNormPostprocessor(m.item_embedding_dim, m.postprocessor.eps)
        else:
            raise ValueError(f"Unknown postprocessor kind {m.postprocessor.kind}")
        sim = m.similarity
        if sim.kind == "dot_product":
            self.similarity = DotProductSimilarity()
        elif sim.kind == "mol":
            if sim.gating_combination_type != "glu_silu":
                # JAX builds MoLSimilarity without it (model.py:212-219)
                raise ValueError(
                    f"similarity.gating_combination_type={sim.gating_combination_type}: the "
                    "reference ignores this field and builds every MoL model as glu_silu "
                    "with linear gates; leave it at glu_silu"
                )
            self.similarity = MoLSimilarity(
                m.item_embedding_dim,
                query_dot_product_groups=sim.query_dot_product_groups,
                item_dot_product_groups=sim.item_dot_product_groups,
                dot_product_dimension=sim.dot_product_dimension,
                dot_product_l2_norm=sim.dot_product_l2_norm,
                temperature=sim.temperature,
                generator=generator,
            )
        else:
            raise ValueError(f"Unknown similarity kind {sim.kind}")

    def _build_hstu(self, m: ModelConfig, total_seq_len: int, seq_mult: int, enc_dim: int,
                    generator: Optional[torch.Generator]) -> None:
        enc = m.encoder
        if str(enc.use_pallas).lower() not in ("auto", "1", "true", "yes", "on"):
            # the port has one attention path: the fused wrapper (the CUDA
            # kernel on the card, its plain version on the CPU)
            raise ValueError(
                f"encoder.use_pallas={enc.use_pallas}: the port always runs the fused "
                "attention; set it to auto or true"
            )
        out_len = m.gr_output_length + 1
        # keyed "_hstu" like the reference's sequence_encoder._hstu
        self.encoder_key = "_hstu"
        self.sequence_encoder = nn.ModuleDict({"_hstu": HSTU(
            max_sequence_len=seq_mult * (total_seq_len - out_len),
            max_output_len=seq_mult * out_len,
            embedding_dim=enc_dim,
            num_blocks=enc.num_blocks,
            num_heads=enc.num_heads,
            linear_dim=enc.linear_dim,
            attention_dim=enc.attention_dim,
            normalization=enc.normalization,
            linear_activation=enc.linear_activation,
            enable_relative_attention_bias=enc.enable_relative_attention_bias,
            relative_bias_type=enc.relative_bias_type,
            num_time_buckets=enc.num_time_buckets,
            concat_ua=enc.concat_ua,
            sp_shards=enc.sp_shards,
            tp_shards=enc.tp_shards,
            remat=enc.remat,
            sp_zigzag=enc.sp_zigzag,
            generator=generator,
            linear_dropout_rate=enc.linear_dropout_rate,
        )})

    def item_embeddings(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embeddings(ids)

    def ratings_embeddings(self) -> torch.Tensor:
        """The rating table [R, D] the ranking head scores against."""
        if not hasattr(self.preprocessor, "ratings_emb"):
            raise ValueError(
                "Preprocessor has no ratings embeddings; the ranking task "
                "requires the combined_item_and_rating preprocessor"
            )
        return self.preprocessor.ratings_emb()

    def score(
        self, input_embeddings: torch.Tensor, item_embeddings: torch.Tensor,
        item_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        return self.similarity(input_embeddings, item_embeddings, item_ids)

    def forward(
        self, seq: SequenceBatch,
        kv: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (encoded [B, N, D] postprocessed, lengths [B]); N is past_ids' N
        and lengths are the item positions', also where the preprocessor
        doubled the row. A `kv` list collects each HSTU block's (k, v), the
        rows of the decode cache (models/decode.py:prefill); SASRec takes
        none."""
        past_embeddings = seq.past_embeddings
        if past_embeddings is None:
            past_embeddings = self.embeddings(seq.past_ids)
        lengths, user_embeddings, valid_mask, aux_mask, payloads = self.preprocessor(
            seq.past_lengths, seq.past_ids, past_embeddings, seq.past_payloads
        )
        extra = ()
        if kv is not None:
            if self.encoder_key != "_hstu":
                raise ValueError("the decode cache (kv) is built by the HSTU encoder only")
            extra = (kv,)
        encoded = self.sequence_encoder[self.encoder_key](
            lengths, user_embeddings.to(self.compute_dtype), valid_mask, payloads, *extra
        ).float()
        if aux_mask is not None:
            # back to the kept (item) positions, cropped to past_ids' N: at
            # most `lengths` <= N positions survive
            encoded, lengths = mask_dense_by_aux_mask(encoded, aux_mask, lengths)
            encoded = encoded[:, : seq.past_ids.shape[1]]
        return self.postprocessor(encoded), lengths


def build_model(
    cfg: Config, device: Union[str, torch.device] = "cuda", seed: Optional[int] = None,
    year_of_item: Optional[Sequence[int]] = None,
) -> GenerativeRecommender:
    """A model with weights drawn from `seed` (default trainer.seed) on the
    CPU, then moved to `device` in eval mode; `resolve(cfg, ...)` first.
    `year_of_item` (the catalog's item -> year table) is read by the
    item_year embedding only."""
    g = torch.Generator().manual_seed(cfg.trainer.seed if seed is None else seed)
    if cfg.model.embedding.kind != "item_year":
        year_of_item = None
    model = GenerativeRecommender(cfg.model, max_seq_len(cfg), generator=g,
                                  year_of_item=year_of_item)
    return model.to(device).eval()
