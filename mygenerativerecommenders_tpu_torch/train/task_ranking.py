"""The ranking task: rating prediction.

Port of mygenerativerecommenders_tpu/train/task_ranking.py:

- the loss (:32-102): scatter the target id and the target rating at
  position `length`, forward (dropout on under `model.train()`), score every
  output position against the L2-normalised rating table, divide by the
  temperature and take the cross-entropy over the R rating classes at every
  position that holds an item (the history and the target: no shift),
  weighted by `sample_weight`. A packed batch (data/packing.py) has its
  targets, id and rating, inline as each segment's last token; the combined
  item-and-rating preprocessor doubles its rows as it doubles padded ones,
  and the model's aux compaction maps the encoder's output back to the item
  slots;
- the step (:105-110): `train_step_from_loss` of the retrieval task, which
  graphs the k-step form on cuda; it binds no drawn input, since ranking
  samples no negatives;
- the eval step (:113-135): the last position's normalised embedding scored
  against the normalised rating table, softmaxed: [B, R] probabilities,
  which the trainer reduces with `multiclass_metrics`. Eval is never packed.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from mygenerativerecommenders_tpu_torch.configs import Config
from mygenerativerecommenders_tpu_torch.models.losses import ce_rating_loss
from mygenerativerecommenders_tpu_torch.models.model import GenerativeRecommender
from mygenerativerecommenders_tpu_torch.ops.sequence import (
    get_current_embeddings,
    scatter_at_lengths,
)
from mygenerativerecommenders_tpu_torch.train.task_retrieval import (
    _eval_many,
    make_sampler,
    train_step_from_loss,
)
from mygenerativerecommenders_tpu_torch.utils.features import (
    packed_seq_features,
    seq_features_from_batch,
)


def _check_packable(cfg: Config) -> None:
    """The preconditions of packed ranking batches (the JAX package's, :41-61)."""
    m = cfg.model
    problems = []
    if m.preprocessor.kind not in (
        "learnable_positional", "learnable_positional_rated", "combined_item_and_rating",
    ):
        problems.append(
            "a preprocessor that models packed positions "
            "(learnable_positional[_rated] or combined_item_and_rating)"
        )
    # only the HSTU rel_bias path reads seg_ids and positions
    if m.encoder.kind != "hstu" or m.encoder.normalization not in ("rel_bias", "hstu_rel_bias"):
        problems.append("encoder.kind=hstu with rel_bias normalization")
    if problems:
        raise ValueError(
            "data.pack_sequences with model.task=ranking requires: " + ", ".join(problems)
        )


def make_loss_fn(
    model: GenerativeRecommender, cfg: Config, packed: bool = False
) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """loss_fn(batch) -> the scalar rating cross-entropy. packed=True takes
    PackedBatchLoader batches: every packed token is supervised, the
    padded layout's terms for the same examples."""
    if packed:
        _check_packable(cfg)
    sampler = make_sampler(cfg)
    t = cfg.model.loss.temperature
    max_out = cfg.model.gr_output_length + 1

    def loss_fn(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if packed:
            seq = packed_seq_features(batch)
            past_ids = seq.past_ids
            ratings = seq.past_payloads["ratings"]
        else:
            seq, target_ids, target_ratings = seq_features_from_batch(batch, max_out)
            past_ids = scatter_at_lengths(seq.past_ids, seq.past_lengths, target_ids)
            ratings = scatter_at_lengths(
                seq.past_payloads["ratings"], seq.past_lengths, target_ratings
            )
            seq = seq._replace(past_ids=past_ids,
                               past_payloads={**seq.past_payloads, "ratings": ratings})
        encoded, _ = model(seq)  # [B, N, D]
        table = sampler.normalize_embeddings(model.ratings_embeddings())  # [R, D]
        logits = model.score(encoded, table[None, None]) / t  # [B, N, R]
        weights = (past_ids != 0).to(torch.float32)
        if not packed and "sample_weight" in batch:
            weights = weights * batch["sample_weight"][:, None]
        return ce_rating_loss(logits, ratings, weights)

    return loss_fn


def make_train_step(
    model: GenerativeRecommender,
    cfg: Config,
    optimizer: torch.optim.Optimizer,
    steps: int = 1,
    packed: bool = False,
) -> Callable[..., torch.Tensor]:
    """steps=1: train_step(batch, lr1, lr2=None) -> the step's loss, eagerly.
    steps=k > 1: train_steps(batches, lr1, lr2=None) -> [len(batches)] losses, each step
    a CUDA graph replay on cuda (`train_step_from_loss`)."""
    return train_step_from_loss(model, optimizer, make_loss_fn(model, cfg, packed), steps)


def make_eval_step(
    model: GenerativeRecommender, cfg: Config, steps: int = 1
) -> Callable[..., torch.Tensor]:
    """eval_step(batch) -> [B, R] class probabilities. steps > 1:
    eval_steps(batches) -> a 1-tuple of [len(batches), B, R], each batch a
    CUDA graph replay on cuda (the retrieval task's `_eval_many`)."""
    sampler = make_sampler(cfg)
    max_out = cfg.model.gr_output_length + 1

    def eval_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        seq, _, _ = seq_features_from_batch(batch, max_out)
        encoded, lengths = model(seq)
        current = sampler.normalize_embeddings(get_current_embeddings(lengths, encoded))
        table = sampler.normalize_embeddings(model.ratings_embeddings())
        return torch.softmax(model.score(current, table[None]), dim=-1)

    if steps > 1:
        return _eval_many(model, lambda batch: (eval_step(batch),), steps)
    return eval_step
