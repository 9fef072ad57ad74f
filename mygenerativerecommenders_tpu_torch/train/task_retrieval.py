"""The retrieval task: the training loss and step, the eval step and its
candidate matrix.

Port of mygenerativerecommenders_tpu/train/task_retrieval.py: `make_loss_fn`
with `ids_to_offsets`, `encode_for_loss` and the dense-catalog
`loss_fn_dense` (:65-282), `make_train_step` (:315-394) for one optimizer
step per call, `make_candidate_fn` (:423-501, replicated exact path) and
`make_eval_step` (:580-612). Serving and the trainer's eval share the eval
step.

The training step is: scatter the target into the history at position
`length`, embed, forward (dropout on under `model.train()`), supervise
position p with the id at p+1, draw R negative catalog offsets per position,
and take the sampled-softmax loss through the dense-catalog path
(ops/dense_negatives.py). The per-sample gather loss, the shared-negatives
loss, the in-batch sampler, BCE, packed batches and several steps per call
raise, naming their ROADMAP.md item.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mygenerativerecommenders_tpu_torch import not_ported
from mygenerativerecommenders_tpu_torch.configs import Config
from mygenerativerecommenders_tpu_torch.models.losses import _weighted_mean
from mygenerativerecommenders_tpu_torch.models.model import GenerativeRecommender
from mygenerativerecommenders_tpu_torch.models.negatives import LocalNegativesSampler
from mygenerativerecommenders_tpu_torch.ops.dense_negatives import (
    sampled_softmax_dense_neg_lse,
)
from mygenerativerecommenders_tpu_torch.ops.sequence import (
    get_current_embeddings,
    scatter_at_lengths,
)
from mygenerativerecommenders_tpu_torch.ops.topk import mips_top_k
from mygenerativerecommenders_tpu_torch.utils.features import seq_features_from_batch


def make_sampler(cfg: Config) -> LocalNegativesSampler:
    s = cfg.model.sampler
    if s.kind == "local":
        return LocalNegativesSampler(l2_norm=s.l2_norm, l2_norm_eps=s.l2_norm_eps)
    if s.kind == "in_batch":
        raise not_ported("sampler.kind=in_batch", "Other model families")
    raise ValueError(f"Unknown sampler kind {s.kind}")


def make_ids_to_offsets(
    all_item_ids: np.ndarray, device: torch.device
) -> Callable[[torch.Tensor], torch.Tensor]:
    """ids_to_offsets(ids) -> each id's row in the catalog, -1 for ids outside
    it (padding): the accidental-hit mask compares offsets and gathers no
    [B, T, R] ids."""
    table_np = np.full(int(np.max(all_item_ids)) + 1, -1, dtype=np.int32)
    table_np[np.asarray(all_item_ids)] = np.arange(len(all_item_ids), dtype=np.int32)
    table = torch.as_tensor(table_np, device=device)

    def ids_to_offsets(ids: torch.Tensor) -> torch.Tensor:
        ids = ids.long()
        inside = (ids >= 0) & (ids < table.shape[0])
        return torch.where(inside, table[ids.clamp(0, table.shape[0] - 1)], -1)

    return ids_to_offsets


def make_loss_fn(
    model: GenerativeRecommender,
    cfg: Config,
    all_item_ids: np.ndarray,
    packed: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Callable[..., torch.Tensor]:
    """Builds loss_fn(batch, neg_offsets=None) -> scalar loss.

    The negatives are drawn from `generator` (on the model's device; None:
    the device's default), unless the caller hands in `neg_offsets`
    [B, N-1, R] itself, as the parity tests do with the JAX package's draw."""
    if packed:
        raise not_ported("data.pack_sequences (packed batches)", "Packing")
    sampler = make_sampler(cfg)
    loss_cfg = cfg.model.loss
    if loss_cfg.kind == "bce":
        raise not_ported("loss.kind=bce", "Other model families")
    if loss_cfg.kind != "sampled_softmax":
        raise ValueError(f"Unknown retrieval loss {loss_cfg.kind}")
    if loss_cfg.shared_negatives:
        raise not_ported("loss.shared_negatives", "Other model families")
    max_out = cfg.model.gr_output_length + 1
    # dense-catalog negatives: valid exactly when the negative logits are
    # plain dot products against normalized catalog rows; auto also gates
    # on the [B*T, X] uint8 count footprint, as the JAX package does
    dense_neg = str(loss_cfg.dense_catalog_negatives).lower()
    applicable = cfg.model.similarity.kind == "dot_product"
    bt_rows = cfg.data.batch_size * (
        cfg.data.max_sequence_length + cfg.model.gr_output_length + 1
    )
    x_pad = ((len(all_item_ids) + 127) // 128) * 128
    fits = bt_rows * x_pad <= 3e9
    if dense_neg in ("true", "1", "yes") and not applicable:
        raise ValueError(
            "loss.dense_catalog_negatives=true requires sampled_softmax + "
            "local sampler + dot_product similarity"
        )
    if not applicable or not (
        dense_neg in ("true", "1", "yes") or (dense_neg == "auto" and fits)
    ):
        raise not_ported(
            "the per-sample gather loss (loss.dense_catalog_negatives=false, or a "
            "[B*T, X] count past the auto gate)", "Training variants",
        )

    device = next(model.parameters()).device
    catalog = torch.as_tensor(np.asarray(all_item_ids, dtype=np.int64), device=device)
    ids_to_offsets = make_ids_to_offsets(all_item_ids, device)

    def encode_for_loss(batch: Dict[str, torch.Tensor]):
        """Target scatter, embed, forward, the shift-by-one supervision layout
        (outputs[:, :-1] against ids[:, 1:]) and the presence weights."""
        seq, target_ids, _ = seq_features_from_batch(batch, max_out)
        # the target goes at position `length`
        past_ids = scatter_at_lengths(seq.past_ids, seq.past_lengths, target_ids)
        input_embeddings = model.item_embeddings(past_ids)
        seq = seq._replace(past_ids=past_ids, past_embeddings=input_embeddings)
        encoded, _ = model(seq)  # [B, N, D]
        outputs = encoded[:, :-1, :]
        sup_ids = past_ids[:, 1:]
        sup_emb = input_embeddings[:, 1:, :]
        weights = (sup_ids != 0).to(torch.float32)
        if "sample_weight" in batch:
            weights = weights * batch["sample_weight"][:, None]
        return outputs, sup_ids, sup_emb, weights

    def loss_fn_dense(
        batch: Dict[str, torch.Tensor], neg_offsets: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        outputs, sup_ids, sup_emb, weights = encode_for_loss(batch)
        norm_catalog = sampler.normalize_embeddings(model.item_embeddings(catalog))
        if neg_offsets is None:
            neg_offsets = sampler.offsets_only(
                generator, sup_ids, loss_cfg.num_to_sample, norm_catalog.shape[0]
            )
        sup_offsets = ids_to_offsets(sup_ids)
        t = loss_cfg.temperature
        pos_emb = sampler.normalize_embeddings(sup_emb)
        pos_logits = (outputs * pos_emb).sum(-1) / t
        neg_lse = sampled_softmax_dense_neg_lse(
            outputs, norm_catalog, neg_offsets, sup_offsets, t
        )
        per_pos = torch.logaddexp(pos_logits, neg_lse) - pos_logits
        return _weighted_mean(per_pos, weights)

    return loss_fn_dense


def make_train_step(
    model: GenerativeRecommender,
    cfg: Config,
    all_item_ids: np.ndarray,
    optimizer: torch.optim.Optimizer,
    steps: int = 1,
    packed: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Callable[..., torch.Tensor]:
    """train_step(batch, lr1, neg_offsets=None) -> the step's loss (detached).
    Sets the optimizer's learning rate to lr1, takes one step and updates the
    model's parameters in place."""
    if steps > 1:
        raise not_ported("trainer.steps_per_call > 1", "Training variants")
    if cfg.model.embedding.lazy_update:
        raise not_ported("embedding.lazy_update", "Lazy embedding update")
    loss_fn = make_loss_fn(model, cfg, all_item_ids, packed=packed, generator=generator)

    def train_step(batch, lr1: float, neg_offsets: Optional[torch.Tensor] = None):
        for group in optimizer.param_groups:
            group["lr"] = lr1
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch, neg_offsets=neg_offsets)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


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
    sampler = make_sampler(cfg)
    device = next(model.parameters()).device
    catalog = torch.as_tensor(np.asarray(all_item_ids, dtype=np.int64), device=device)

    def candidates() -> torch.Tensor:
        return sampler.normalize_embeddings(model.item_embeddings(catalog))

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
