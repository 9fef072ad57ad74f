"""The composed generative-recommender model.

Port of mygenerativerecommenders_tpu/models/model.py:252-291 for the
components retrieval serving and training run: local embedding -> learnable
positional preprocessor (with dropout) -> HSTU -> L2 postprocessor,
dot-product similarity. Other
kinds raise, naming the ROADMAP.md item that ports them. Submodule names
follow the reference checkpoint's keys, so `state_dict()` reads
`embeddings._item_emb.weight`, `preprocessor._pos_emb.weight`,
`sequence_encoder._hstu._attention_layers.{i}...`.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from mygenerativerecommenders_tpu_torch import not_ported
from mygenerativerecommenders_tpu_torch.configs import Config, ModelConfig, max_seq_len
from mygenerativerecommenders_tpu_torch.models.embeddings import LocalEmbedding
from mygenerativerecommenders_tpu_torch.models.hstu import HSTU
from mygenerativerecommenders_tpu_torch.models.postprocessors import L2NormPostprocessor
from mygenerativerecommenders_tpu_torch.models.preprocessors import (
    LearnablePositionalEmbeddingPreprocessor,
)
from mygenerativerecommenders_tpu_torch.models.similarity import DotProductSimilarity
from mygenerativerecommenders_tpu_torch.utils.features import SequenceBatch


class GenerativeRecommender(nn.Module):
    """Embedding + preprocessor + encoder + postprocessor (+ similarity)."""

    def __init__(
        self,
        cfg: ModelConfig,
        total_seq_len: int,  # data.max_sequence_length + gr_output_length + 1
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        m = cfg
        self.cfg = m
        if m.task != "retrieval":
            raise not_ported(f"model.task={m.task}", "Other model families")
        if m.compute_dtype != "float32":
            raise not_ported(f"model.compute_dtype={m.compute_dtype}", "Mixed precision")
        if m.embedding.kind == "item_year":
            raise not_ported("embedding.kind=item_year", "Other model families")
        if m.embedding.kind.startswith("sharded"):
            raise not_ported(f"embedding.kind={m.embedding.kind}", "Distributed")
        if m.embedding.kind != "local":
            raise ValueError(f"Unknown embedding kind {m.embedding.kind}")
        if m.embedding.lazy_update:
            raise not_ported("embedding.lazy_update", "Lazy embedding update")
        self.embeddings = LocalEmbedding(
            m.embedding.num_items, m.item_embedding_dim, m.embedding.init_std, generator
        )
        if m.preprocessor.kind != "learnable_positional":
            raise not_ported(f"preprocessor.kind={m.preprocessor.kind}", "Other model families")
        self.preprocessor = LearnablePositionalEmbeddingPreprocessor(
            total_seq_len, m.item_embedding_dim, generator, m.preprocessor.dropout_rate
        )
        enc = m.encoder
        if enc.kind != "hstu":
            raise not_ported(f"encoder.kind={enc.kind}", "Other model families")
        if str(enc.use_pallas).lower() not in ("auto", "1", "true", "yes", "on"):
            # the port has one attention path: the fused wrapper (the CUDA
            # kernel on the card, its plain version on the CPU)
            raise ValueError(
                f"encoder.use_pallas={enc.use_pallas}: the port always runs the fused "
                "attention; set it to auto or true"
            )
        out_len = m.gr_output_length + 1
        # keyed "_hstu" like the reference's sequence_encoder._hstu
        self.sequence_encoder = nn.ModuleDict({"_hstu": HSTU(
            max_sequence_len=total_seq_len - out_len,
            max_output_len=out_len,
            embedding_dim=m.item_embedding_dim,
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
            attn_dropout_rate=enc.attn_dropout_rate,
        )})
        if m.postprocessor.kind != "l2_norm":
            raise not_ported(f"postprocessor.kind={m.postprocessor.kind}", "Other model families")
        self.postprocessor = L2NormPostprocessor(m.item_embedding_dim, m.postprocessor.eps)
        if m.similarity.kind != "dot_product":
            raise not_ported(f"similarity.kind={m.similarity.kind}", "Other model families")
        self.similarity = DotProductSimilarity()

    def item_embeddings(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embeddings(ids)

    def score(
        self, input_embeddings: torch.Tensor, item_embeddings: torch.Tensor
    ) -> torch.Tensor:
        return self.similarity(input_embeddings, item_embeddings)

    def forward(self, seq: SequenceBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (encoded [B, N, D] postprocessed, lengths [B])."""
        past_embeddings = seq.past_embeddings
        if past_embeddings is None:
            past_embeddings = self.embeddings(seq.past_ids)
        lengths, user_embeddings, valid_mask, _, payloads = self.preprocessor(
            seq.past_lengths, seq.past_ids, past_embeddings, seq.past_payloads
        )
        encoded = self.sequence_encoder["_hstu"](
            lengths, user_embeddings.float(), valid_mask, payloads
        )
        return self.postprocessor(encoded), lengths


def build_model(
    cfg: Config, device: Union[str, torch.device] = "cuda", seed: Optional[int] = None
) -> GenerativeRecommender:
    """A model with weights drawn from `seed` (default trainer.seed) on the
    CPU, then moved to `device` in eval mode; `resolve(cfg, ...)` first."""
    g = torch.Generator().manual_seed(cfg.trainer.seed if seed is None else seed)
    model = GenerativeRecommender(cfg.model, max_seq_len(cfg), generator=g)
    return model.to(device).eval()
