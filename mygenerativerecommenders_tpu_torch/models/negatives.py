"""Negative samplers. Port of mygenerativerecommenders_tpu/models/negatives.py:

- `LocalNegativesSampler` (:40-95): uniform catalog offsets with
  replacement and the rows of the catalog at those offsets;
- `InBatchNegativesSampler` (:98-157): uniform over the batch's valid
  (optionally deduplicated) ids, in fixed shapes: `process_batch` compacts
  them into a pool [P] with its count on the device (a sort and the first of
  each run for dedup, invalid ids parked at the int max), and the draw maps
  uniforms u [..., R] to pool slots min(int(u * count), max(count - 1, 0)).
  Nothing reads the count on the host, so the step captures in a CUDA graph;
  the uniforms are drawn outside it (`uniforms`) or handed in, as the parity
  tests hand in JAX's `jax.random.uniform` draw.

Both own the optional L2 normalization applied to sampled and supervision
embeddings (:28-37).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from mygenerativerecommenders_tpu_torch.models.postprocessors import l2_normalize

# Maps item ids -> [..., D] embeddings (the live embedding table lookup).
EmbeddingLookup = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class NegativesSampler:
    l2_norm: bool = True
    l2_norm_eps: float = 1e-6

    def normalize_embeddings(self, x: torch.Tensor) -> torch.Tensor:
        if self.l2_norm:
            return l2_normalize(x, self.l2_norm_eps)
        return x


@dataclasses.dataclass(frozen=True)
class LocalNegativesSampler(NegativesSampler):
    """Uniform negatives over the catalog, with replacement (JAX :40-95)."""

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


@dataclasses.dataclass(frozen=True)
class InBatchNegativesSampler(NegativesSampler):
    """Uniform negatives over the batch's valid ids (JAX :98-157)."""

    dedup_embeddings: bool = True

    def process_batch(
        self, ids: torch.Tensor, presences: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The valid ids, flattened and compacted -> (pool [P] of ids's dtype,
        the first `count` slots valid; count, a 0-d int64 tensor). With dedup
        the pool holds each valid id once, in ascending order; without, every
        valid position's id in order."""
        flat_ids, flat_pres = ids.reshape(-1), presences.reshape(-1)
        p = flat_ids.shape[0]
        if self.dedup_embeddings:
            # a unique of fixed shape: sort (invalid ids parked at the int
            # max), keep the first of each run
            big = torch.iinfo(flat_ids.dtype).max
            keys = torch.sort(torch.where(flat_pres, flat_ids, big)).values
            first = torch.ones_like(flat_pres)
            first[1:] = keys[1:] != keys[:-1]
            keep, values = first & (keys != big), keys
        else:
            keep, values = flat_pres, flat_ids
        count = keep.sum()
        # kept slot j goes to j's rank among the kept; the rest to slot p, dropped
        dest = torch.where(keep, torch.cumsum(keep, 0) - 1, p)
        pool = flat_ids.new_zeros(p + 1).index_put_((dest,), values)
        return pool[:p], count

    def offsets(self, u: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
        """Uniforms u [...] in [0, 1) -> pool slots in [0, count), int64:
        min(int(u * count), max(count - 1, 0)), the product in float32."""
        scaled = (u * count.to(torch.float32)).to(torch.int32).long()
        return torch.minimum(scaled, torch.clamp(count - 1, min=0))

    def uniforms(
        self,
        generator: Optional[torch.Generator],
        shape: Tuple[int, ...],  # the positives' shape
        num_to_sample: int,
        device: torch.device,
        out: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """[*shape, R] float32 uniforms in [0, 1), drawn on `device` from
        `generator` (None: the device's default), into `out` when given."""
        size = tuple(shape) + (num_to_sample,)
        if out is None:
            out = torch.empty(size, dtype=torch.float32, device=device)
        return out.uniform_(generator=generator)
