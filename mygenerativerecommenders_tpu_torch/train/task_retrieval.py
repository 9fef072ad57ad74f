"""The retrieval eval step and its candidate matrix.

Port of mygenerativerecommenders_tpu/train/task_retrieval.py:423-501
(`make_candidate_fn`, replicated exact path) and :580-612 (`make_eval_step`,
`_eval_body`). Serving and, later, the trainer's eval share them. The
training losses and step come with the training slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from mygenerativerecommenders_tpu_torch import not_ported
from mygenerativerecommenders_tpu_torch.configs import Config
from mygenerativerecommenders_tpu_torch.models.model import GenerativeRecommender
from mygenerativerecommenders_tpu_torch.models.postprocessors import l2_normalize
from mygenerativerecommenders_tpu_torch.ops.sequence import get_current_embeddings
from mygenerativerecommenders_tpu_torch.ops.topk import mips_top_k
from mygenerativerecommenders_tpu_torch.utils.features import seq_features_from_batch


def _check_index(cfg: Config) -> None:
    index = cfg.model.index
    if index.quantize not in ("", "none"):
        if index.quantize == "int8":
            raise not_ported("index.quantize=int8", "Index variants")
        raise ValueError(f"Unknown index.quantize {index.quantize!r}")
    if str(index.sharded).lower() in ("true", "1", "yes", "on"):
        raise not_ported("index.sharded=true", "Distributed")


def make_candidate_fn(
    model: GenerativeRecommender, cfg: Config, all_item_ids: np.ndarray
) -> Callable[[], torch.Tensor]:
    """candidates() -> [X, D]: the catalog's embeddings, normalized as the
    sampler normalizes them (sampler.l2_norm, sampler.l2_norm_eps)."""
    _check_index(cfg)
    sampler = cfg.model.sampler
    device = next(model.parameters()).device
    catalog = torch.as_tensor(np.asarray(all_item_ids, dtype=np.int64), device=device)

    def candidates() -> torch.Tensor:
        emb = model.item_embeddings(catalog)
        return l2_normalize(emb, sampler.l2_norm_eps) if sampler.l2_norm else emb

    return candidates


def make_eval_step(
    model: GenerativeRecommender, cfg: Config, all_item_ids: np.ndarray, max_item_id: int
) -> Callable[[Dict[str, torch.Tensor], torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """eval_step(batch, candidates) -> (top_k_ids [B, k], top_k_scores [B, k])."""
    _check_index(cfg)
    device = next(model.parameters()).device
    catalog = torch.as_tensor(np.asarray(all_item_ids, dtype=np.int64), device=device)
    k = min(cfg.model.index.k, len(all_item_ids))
    filter_past = cfg.model.index.filter_past_ids
    approx_recall = float(cfg.model.index.approx_top_k_recall)
    max_out = cfg.model.gr_output_length + 1

    def eval_step(batch, candidates):
        seq, _, _ = seq_features_from_batch(batch, max_out)
        seq = seq._replace(past_embeddings=model.item_embeddings(seq.past_ids))
        encoded, lengths = model(seq)
        current = get_current_embeddings(lengths, encoded)  # [B, D]
        return mips_top_k(
            current, candidates, catalog, k=k,
            invalid_ids=seq.past_ids if filter_past else None,
            max_item_id=max_item_id, approx_recall=approx_recall,
        )

    return eval_step
