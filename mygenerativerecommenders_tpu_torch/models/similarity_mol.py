"""MoL (Mixture-of-Logits) learned similarity. Port of
mygenerativerecommenders_tpu/models/similarity_mol.py (arXiv:2306.04039).

  - context projection D -> P groups of dd, item projection D -> Q groups of
    dd, each group L2-normalised when `dot_product_l2_norm`;
  - the all-pairs group logits [..., X, P*Q], divided by `temperature`;
  - three gates over those P*Q logits: context-only, item-only (its input
    [item ++ sideinfo] when the items carry side information) and
    context-item (on the logits, optionally with the sideinfo), each a
    linear layer, a GeGLU, a SwiGLU or absent; combined by glu_silu,
    glu_silu_ln, silu or none;
  - optionally a per-item temperature (`TauFn`) dividing the gate weights;
  - the combiner: softmax over the P*Q groups, renormalised by max(sum, eps)
    (the softmax dropout of the JAX module never runs: its callers take the
    default `deterministic=True`), then the weighted sum of the logits.

The model's MoL divides by two temperatures: its own here, then the loss's
`loss.temperature` (JAX `train/task_retrieval.py:243-244`), 0.05 x 0.05 at
the defaults. The port keeps both, as the JAX package computes them.

Parameters keep the JAX module's paths and flax's [in, out] layout
(models/dense.py): `context_proj.{kernel,bias}`, `item_proj.*`,
`gate_context.*`, `gate_item.*`, `gate_ci.*` (`w`, `b` for a GLU gate),
`tau_fn.*`; inits as JAX's: the projections, linear gates and tau
Xavier-uniform with zero biases, the GLUs' `w` normal(0.02) and `b` zeros.

`lnx_init_state` / `lnx_frequency_estimate` are the LnX frequency estimator
(JAX :247-289) as functions over an explicit state dict.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mygenerativerecommenders_tpu_torch.models.dense import Dense
from mygenerativerecommenders_tpu_torch.models.postprocessors import l2_normalize

COMBINATIONS = ("glu_silu", "glu_silu_ln", "silu", "none")
GATE_KINDS = ("linear", "geglu", "swiglu", "none")


class GLU(nn.Module):
    """act(lhs) * rhs of x . w + b split in two: JAX's GeGLU (gelu, its
    default tanh approximation) or SwiGLU (silu)."""

    def __init__(self, in_features: int, out_features: int, act,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.act = act
        self.w = nn.Parameter(torch.randn(in_features, 2 * out_features, generator=generator)
                              * 0.02)
        self.b = nn.Parameter(torch.zeros(2 * out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lhs, rhs = torch.chunk(x @ self.w + self.b, 2, dim=-1)
        return self.act(lhs) * rhs


def _gating_mlp(kind: str, in_features: int, out_features: int,
                generator: Optional[torch.Generator]) -> Optional[nn.Module]:
    if kind == "linear":
        return Dense((in_features,), (out_features,), generator, init="xavier_uniform")
    if kind == "geglu":
        return GLU(in_features, out_features, lambda x: F.gelu(x, approximate="tanh"), generator)
    if kind == "swiglu":
        return GLU(in_features, out_features, F.silu, generator)
    if kind == "none":
        return None
    raise ValueError(f"Unknown gating mlp kind {kind}")


class MoLSimilarity(nn.Module):
    """scores(queries [..., D], items [..., X, D]) -> [..., X]."""

    def __init__(
        self,
        embedding_dim: int,
        query_dot_product_groups: int = 4,
        item_dot_product_groups: int = 4,
        dot_product_dimension: int = 16,
        dot_product_l2_norm: bool = True,
        temperature: float = 0.05,
        gating_combination_type: str = "glu_silu",
        gating_context_mlp: str = "linear",
        gating_item_mlp: str = "linear",
        gating_ci_mlp: str = "linear",
        item_sideinfo_dim: int = 0,
        combine_item_sideinfo_into_ci: bool = False,
        gating_use_custom_tau: bool = False,
        gating_tau_alpha: float = 0.01,
        eps: float = 1e-6,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if gating_combination_type not in COMBINATIONS:
            raise ValueError(f"Unknown combination_type {gating_combination_type}")
        p, q, dd = query_dot_product_groups, item_dot_product_groups, dot_product_dimension
        if gating_combination_type.startswith("glu_silu") and "none" in (
            gating_context_mlp, gating_item_mlp, gating_ci_mlp
        ):
            # ctx * item + ci takes all three (JAX fails on the missing one)
            raise ValueError(
                f"gating_combination_type={gating_combination_type} multiplies the context "
                "and item gates and adds the context-item gate: none of them may be 'none'"
            )
        if (gating_context_mlp, gating_item_mlp, gating_ci_mlp) == ("none",) * 3:
            raise ValueError("MoL needs at least one gate that is not 'none'")
        self.p, self.q, self.dd = p, q, dd
        self.dot_product_l2_norm = dot_product_l2_norm
        self.temperature = temperature
        self.combination = gating_combination_type
        self.item_sideinfo_dim = item_sideinfo_dim
        self.combine_item_sideinfo_into_ci = combine_item_sideinfo_into_ci
        self.gating_tau_alpha = gating_tau_alpha
        self.eps = eps
        num_logits = p * q
        g = generator
        self.context_proj = Dense((embedding_dim,), (p * dd,), g, init="xavier_uniform")
        self.item_proj = Dense((embedding_dim,), (q * dd,), g, init="xavier_uniform")
        self.gate_context = _gating_mlp(gating_context_mlp, embedding_dim, num_logits, g)
        self.gate_item = _gating_mlp(gating_item_mlp, embedding_dim + item_sideinfo_dim,
                                     num_logits, g)
        ci_in = num_logits + (item_sideinfo_dim if combine_item_sideinfo_into_ci else 0)
        self.gate_ci = _gating_mlp(gating_ci_mlp, ci_in, num_logits, g)
        self.tau_fn = None
        if gating_use_custom_tau:
            self.tau_fn = Dense((item_sideinfo_dim,), (1,), g, init="xavier_uniform")

    def forward(
        self,
        input_embeddings: torch.Tensor,  # [..., D]
        item_embeddings: torch.Tensor,  # [..., X, D], broadcastable against the input
        item_ids: Optional[torch.Tensor] = None,
        item_sideinfo: Optional[torch.Tensor] = None,  # [..., X, F]
    ) -> torch.Tensor:
        del item_ids
        if self.item_sideinfo_dim > 0 and item_sideinfo is None:
            raise ValueError("item_sideinfo_dim > 0 but no item_sideinfo passed")
        x = input_embeddings.float()
        items = item_embeddings.float()
        ctx = self.context_proj(x).unflatten(-1, (self.p, self.dd))
        itm = self.item_proj(items).unflatten(-1, (self.q, self.dd))
        if self.dot_product_l2_norm:
            ctx = l2_normalize(ctx, self.eps)
            itm = l2_normalize(itm, self.eps)
        logits = torch.einsum("...pd,...xqd->...xpq", ctx, itm)
        logits = logits.flatten(-2) / self.temperature  # [..., X, P*Q]

        ctx_gate = itm_gate = ci_gate = None
        if self.gate_context is not None:
            ctx_gate = self.gate_context(x)[..., None, :]  # [..., 1, L]
        if self.gate_item is not None:
            item_in = items
            if self.item_sideinfo_dim > 0:
                item_in = torch.cat([items, item_sideinfo.float()], dim=-1)
            itm_gate = self.gate_item(item_in)  # [..., X, L]
        if self.gate_ci is not None:
            ci_in = logits
            if self.combine_item_sideinfo_into_ci:
                side = item_sideinfo.float().expand(*logits.shape[:-1], self.item_sideinfo_dim)
                ci_in = torch.cat([logits, side], dim=-1)
            ci_gate = self.gate_ci(ci_in)  # [..., X, L]

        if self.combination in ("glu_silu", "glu_silu_ln"):
            inputs = ctx_gate * itm_gate + ci_gate
            if self.combination == "glu_silu":
                weights = F.silu(inputs)
            else:  # x * sigmoid(LN(x)), eps 1e-5
                mean = inputs.mean(dim=-1, keepdim=True)
                var = ((inputs - mean) ** 2).mean(dim=-1, keepdim=True)
                weights = inputs * torch.sigmoid((inputs - mean) * torch.rsqrt(var + 1e-5))
        else:
            inputs = None
            for gate in (ctx_gate, itm_gate, ci_gate):
                if gate is not None:
                    inputs = gate if inputs is None else inputs + gate
            weights = F.silu(inputs) if self.combination == "silu" else inputs

        if self.tau_fn is not None:
            # [..., X, 1], broadcast over the logit groups
            tau = (torch.sigmoid(self.tau_fn(item_sideinfo.float())) + self.gating_tau_alpha
                   ) / self.gating_tau_alpha
            weights = weights / tau

        weights = torch.softmax(weights, dim=-1)
        weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True), min=self.eps)
        return (weights * logits).sum(dim=-1)


# ---------------------------------------------------------------------------
# the LnX frequency estimator (JAX :247-289)
# ---------------------------------------------------------------------------


def lnx_init_state(num_ids: int, device=None) -> Dict[str, torch.Tensor]:
    """Zero state for ids in [0, num_ids): int32 `A` (each id's last
    position), float32 `B` (its mean gap's EMA), int32 `num_elements`."""
    return {
        "A": torch.zeros(num_ids, dtype=torch.int32, device=device),
        "B": torch.zeros(num_ids, dtype=torch.float32, device=device),
        "num_elements": torch.zeros((), dtype=torch.int32, device=device),
    }


def lnx_frequency_estimate(
    state: Dict[str, torch.Tensor],
    ids: torch.Tensor,
    *,
    alpha: float = 0.1,
    b_cap: float = 1e6,
    update: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Each id's estimated frequency 1 / E[gap] (inf on its first sighting),
    shaped like `ids`, and the new state (the same state with update=False)."""
    flat = ids.reshape(-1).long()
    n = flat.shape[0]
    a, b = state["A"], state["B"]
    positions = torch.arange(n, dtype=a.dtype, device=a.device) + state["num_elements"]
    most_recent = torch.full_like(a, torch.iinfo(a.dtype).min).scatter_reduce(
        0, flat, positions, reduce="amax")
    counts = torch.zeros_like(b).index_add(0, flat, torch.ones(n, dtype=b.dtype, device=b.device))
    seen = counts > 0
    delta = torch.where(seen, (most_recent - a).to(torch.float32), 0.0) / torch.clamp(counts,
                                                                                     min=1.0)
    temp = torch.clamp((1.0 - alpha) * b + alpha * delta, max=b_cap)
    freqs = (1.0 / temp[flat]).reshape(ids.shape)
    if update:
        state = {
            "A": torch.where(seen, most_recent, a),
            "B": torch.where(seen, temp, b),
            "num_elements": state["num_elements"] + n,
        }
    return freqs, state
