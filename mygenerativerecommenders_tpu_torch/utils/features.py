"""Sequence feature schema: the loader batch -> model input.

Port of mygenerativerecommenders_tpu/utils/features.py:23-99: the history
arrays are padded by `max_output_length` zeros and the target timestamp is
written at position `lengths`, so the last attended query row sees the
"next-item" timestamp. A packed batch (data/packing.py) needs neither: its
targets and their timestamps are already tokens of the row.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from mygenerativerecommenders_tpu_torch.ops.sequence import scatter_at_lengths


class SequenceBatch(NamedTuple):
    past_lengths: torch.Tensor  # [B] int, all >= 1 for real rows
    past_ids: torch.Tensor  # [B, N] int, 0 = padding
    past_embeddings: Optional[torch.Tensor]  # [B, N, D] float or None
    past_payloads: Dict[str, torch.Tensor]  # timestamps/ratings/years [B, N]


_KNOWN = {
    "lengths", "ids", "timestamps", "ratings", "years",
    "target_id", "target_rating", "target_timestamp", "target_year",
    "sample_weight",
}


def seq_features_from_batch(
    batch: Dict[str, torch.Tensor], max_output_length: int
) -> Tuple[SequenceBatch, torch.Tensor, torch.Tensor]:
    """Raw loader batch -> (SequenceBatch padded to N, target_ids, target_ratings)."""
    lengths = batch["lengths"].to(torch.int32)

    def pad(x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.int32)
        return torch.cat([x, x.new_zeros((x.shape[0], max_output_length))], dim=1)

    timestamps = scatter_at_lengths(
        pad(batch["timestamps"]), lengths, batch["target_timestamp"].to(torch.int32)
    )
    payloads = {"timestamps": timestamps, "ratings": pad(batch["ratings"])}
    if "years" in batch:
        payloads["years"] = pad(batch["years"])
    # extra columns (user features etc.) ride along as payloads
    payloads.update({key: val for key, val in batch.items() if key not in _KNOWN})
    features = SequenceBatch(
        past_lengths=lengths,
        past_ids=pad(batch["ids"]),
        past_embeddings=None,
        past_payloads=payloads,
    )
    return (
        features,
        batch["target_id"].to(torch.int32),
        batch["target_rating"].to(torch.int32),
    )


def packed_seq_features(batch: Dict[str, torch.Tensor]) -> SequenceBatch:
    """PackedBatchLoader batch -> SequenceBatch. The `positions` payload drives
    the positional gather (models/preprocessors.py) and, because `seg_ids` is
    present, the block-diagonal attention (models/hstu.py)."""
    return SequenceBatch(
        past_lengths=batch["lengths"].to(torch.int32),
        past_ids=batch["ids"].to(torch.int32),
        past_embeddings=None,
        past_payloads={
            key: batch[key].to(torch.int32)
            for key in ("timestamps", "ratings", "positions", "seg_ids")
        },
    )
