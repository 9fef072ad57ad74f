"""Negative samplers. Port of `LocalNegativesSampler`
(mygenerativerecommenders_tpu/models/negatives.py:29-37, 66-95): uniform
catalog offsets with replacement, the rows of the catalog at those offsets,
and the optional L2 normalization applied to catalog and supervision
embeddings. The in-batch sampler raises in train/task_retrieval.py.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from mygenerativerecommenders_tpu_torch.models.postprocessors import l2_normalize

# Maps item ids -> [..., D] embeddings (the live embedding table lookup).
EmbeddingLookup = Callable[[torch.Tensor], torch.Tensor]


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
        shape: Tuple[int, ...],  # the positives' shape
        num_to_sample: int,
        num_catalog: int,
        device: torch.device,
        out: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """[*shape, R] int32 offsets, uniform over [0, num_catalog), drawn on
        `device` from `generator` (None: the device's default), into `out`
        when given: the same numbers either way."""
        return torch.randint(
            0, num_catalog, tuple(shape) + (num_to_sample,), generator=generator,
            dtype=torch.int32, device=device, out=out,
        )

    def rows_at(
        self, offsets: torch.Tensor, catalog: torch.Tensor, lookup: EmbeddingLookup
    ) -> torch.Tensor:
        """[..., D] normalized embeddings of the catalog items at `offsets`.

        The JAX sampler normalizes the whole [X, D] catalog and gathers from
        it; normalization is row-wise, so gathering first and normalizing the
        gathered rows gives the same values, and no [X, D] normalize (or its
        backward) runs a step, whatever the catalog's size."""
        return self.normalize_embeddings(lookup(catalog[offsets.long()]))

    def sample_offsets(
        self,
        generator: Optional[torch.Generator],
        shape: Tuple[int, ...],
        num_to_sample: int,
        catalog: torch.Tensor,  # [X] catalog ids
        lookup: EmbeddingLookup,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(offsets [*shape, R], their normalized embeddings [*shape, R, D]):
        the draw of `offsets_only`, then `rows_at` those offsets."""
        offsets = self.offsets_only(
            generator, shape, num_to_sample, catalog.shape[0], catalog.device
        )
        return offsets, self.rows_at(offsets, catalog, lookup)
