"""Negative samplers. Port of `LocalNegativesSampler`
(mygenerativerecommenders_tpu/models/negatives.py:29-37, 84-95): uniform
catalog offsets with replacement, and the optional L2 normalization applied
to catalog and supervision embeddings. Only the offset-space draw of the
dense-catalog loss is ported; the in-batch sampler raises in
train/task_retrieval.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mygenerativerecommenders_tpu_torch.models.postprocessors import l2_normalize


@dataclasses.dataclass(frozen=True)
class LocalNegativesSampler:
    l2_norm: bool = True
    l2_norm_eps: float = 1e-6

    def normalize_embeddings(self, x: torch.Tensor) -> torch.Tensor:
        if self.l2_norm:
            return l2_normalize(x, self.l2_norm_eps)
        return x

    def offsets_only(
        self,
        generator: Optional[torch.Generator],
        positive_ids: torch.Tensor,  # [...]: gives the shape and the device
        num_to_sample: int,
        num_catalog: int,
    ) -> torch.Tensor:
        """[..., R] int32 offsets, uniform over [0, num_catalog), drawn on
        positive_ids' device from `generator` (None: the device's default)."""
        shape = tuple(positive_ids.shape) + (num_to_sample,)
        return torch.randint(
            0, num_catalog, shape, generator=generator, dtype=torch.int32,
            device=positive_ids.device,
        )
