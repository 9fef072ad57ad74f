"""HSTU next-item retrieval in plain PyTorch: the encoder, the sampled-softmax
loss and AdamW, as HSTU (arXiv:2402.17152) and the reference repo
(generative-recommenders' `HSTUJagged` with the relative bucketed time and
position bias) define them, dense over [B, N, ...] with masks.

    x_0      = dropout(E[ids] * sqrt(D) + P[pos]) * valid
    block i: n = LN(x); u, v, q, k = split(silu(n @ W_uvqk))
             z[b,h,i,j] = q_i . k_j + pos_w[j - i + M - 1] + ts_w[bucket(t_{i+1} - t_j)]
             a_i = sum_j live(i, j) * silu(z) / M * v_j   (M: the static max length)
             x = (dropout(u * LN(a)) @ W_o^T + b_o + x) * valid
    out      = x / max(||x||, eps)
    bucket(d) = clip(int(ln(max(|d|, 1)) / 0.301), 0, num_buckets)

A pair (i, j) is live when j <= i < row length, i - j < M and j lies in i's
segment (packed rows hold several users' sequences end to end). LayerNorms
have no scale or bias. Dropout draws come from torch's default generator,
in the order above, as `torch.nn.functional.dropout` draws them.

Nothing here imports the port: the weights are a dict of tensors under the
reference checkpoint's names, and the batches are numpy arrays.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

ACCIDENTAL_HIT_LOGIT = -5e4  # the reference repo's masked logit

TABLE = "embeddings._item_emb.weight"
POS_EMB = "preprocessor._pos_emb.weight"
BLOCK = "sequence_encoder._hstu._attention_layers.{}."


@dataclasses.dataclass(frozen=True)
class Dims:
    """The model's sizes, read from a configuration (`from_config`)."""

    d: int  # item embedding width
    heads: int
    dqk: int
    dv: int
    blocks: int
    max_len: int  # history length + gr_output_length + 1: the 1/M and the table centre
    max_history: int  # data.max_sequence_length
    max_out: int  # gr_output_length + 1: the padded tail of an unpacked row
    num_buckets: int
    eps: float
    dropout: float  # the input's dropout rate
    linear_dropout: float  # each block's, on u * LN(a)
    temperature: float
    num_negatives: int
    l2_eps: float

    @staticmethod
    def from_config(m: dict) -> "Dims":
        """`m`: the benchmark configuration's resolved `model` and `data` keys."""
        d = int(m["item_embedding_dim"])
        return Dims(
            d=d, heads=int(m["num_heads"]), dqk=int(m["attention_dim"] or d),
            dv=int(m["linear_dim"] or d), blocks=int(m["num_blocks"]),
            max_len=int(m["max_sequence_length"]) + int(m["gr_output_length"]) + 1,
            max_history=int(m["max_sequence_length"]), max_out=int(m["gr_output_length"]) + 1,
            num_buckets=int(m["num_time_buckets"]), eps=1e-6,
            dropout=float(m["dropout_rate"]), linear_dropout=float(m["linear_dropout_rate"]),
            temperature=float(m["temperature"]), num_negatives=int(m["num_to_sample"]),
            l2_eps=float(m["l2_norm_eps"]),
        )


def l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=eps * eps))


def _layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], eps=eps)


def time_bucket(delta: torch.Tensor, num_buckets: int) -> torch.Tensor:
    divisor = torch.full((), 0.301, dtype=torch.float32, device=delta.device)
    x = torch.log(torch.clamp(delta.abs().to(torch.float32), min=1.0)) / divisor
    return torch.clamp(x.to(torch.int32), 0, num_buckets).long()


def attention(q, k, v, ts, pos_w, ts_w, dims: Dims, valid, seg_start) -> torch.Tensor:
    """q, k [B, N, H, dqk], v [B, N, H, dv], ts [B, N] int64, valid [B, N]
    (row index below the row's length), seg_start [B, N] (the first row of
    each row's segment) -> [B, N, H, dv]."""
    b, n = ts.shape
    m = dims.max_len
    idx = torch.arange(n, device=q.device)
    rel = (idx[None, :] - idx[:, None] + m - 1).clamp(0, 2 * m - 2)
    ts_next = torch.cat([ts[:, 1:], ts[:, -1:]], dim=1)
    bias = pos_w[rel][None] + ts_w[time_bucket(ts_next[:, :, None] - ts[:, None, :], dims.num_buckets)]
    z = torch.einsum("bnhd,bmhd->bhnm", q, k) + bias[:, None]
    apart = idx[:, None] - idx[None, :]
    live = ((apart >= 0) & (apart < m))[None] & valid[:, :, None] & valid[:, None, :]
    live = live & (idx[None, None, :] >= seg_start[:, :, None])
    a = torch.where(live[:, None], F.silu(z) / m, 0.0)
    return torch.einsum("bhnm,bmhd->bnhd", a, v)


def encode(w: Dict[str, torch.Tensor], dims: Dims, ids: torch.Tensor, ts: torch.Tensor,
           positions: Optional[torch.Tensor], training: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids, ts [B, N]; positions [B, N] within-segment positions of a packed
    row (None: one sequence a row, positions 0..N-1) -> (outputs [B, N, D]
    L2-normalized, the input rows E[ids] [B, N, D])."""
    b, n = ids.shape
    h, dqk, dv = dims.heads, dims.dqk, dims.dv
    rows = F.embedding(ids, w[TABLE])
    idx = torch.arange(n, device=ids.device)
    if positions is None:
        pos = w[POS_EMB][None, :n]
        seg_start = torch.zeros((b, n), dtype=torch.long, device=ids.device)
    else:
        pos = F.embedding(positions, w[POS_EMB])
        seg_start = idx[None, :] - positions
    mask = (ids != 0)[:, :, None].to(torch.float32)
    x = F.dropout(rows * math.sqrt(dims.d) + pos, dims.dropout, training) * mask
    # the row's length: its last valid position + 1
    length = (mask[:, :, 0] * (idx[None, :] + 1)).amax(dim=1)
    valid = idx[None, :] < length[:, None]
    for i in range(dims.blocks):
        p = BLOCK.format(i)
        x = x * mask
        proj = F.silu(_layer_norm(x, dims.eps) @ w[p + "_uvqk"])
        u, v, q, k = torch.split(proj, [dv * h, dv * h, dqk * h, dqk * h], dim=-1)
        a = attention(q.unflatten(-1, (h, dqk)), k.unflatten(-1, (h, dqk)), v.unflatten(-1, (h, dv)),
                      ts, w[p + "_rel_attn_bias._pos_w"], w[p + "_rel_attn_bias._ts_w"], dims,
                      valid, seg_start).reshape(b, n, h * dv)
        o_in = F.dropout(u * _layer_norm(a, dims.eps), dims.linear_dropout, training)
        x = F.linear(o_in, w[p + "_o.weight"], w[p + "_o.bias"]) + x
    x = x * mask
    return l2_normalize(x, dims.eps), rows


def catalog_offsets(catalog: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Each id's row in the sorted catalog, -1 where it is not in it."""
    at = torch.searchsorted(catalog, ids.long().contiguous()).clamp(max=catalog.numel() - 1)
    return torch.where(catalog[at] == ids.long(), at, -1)


def unpacked_layout(batch: Dict[str, torch.Tensor], dims: Dims, with_target: bool):
    """A padded batch (ids [B, L], lengths, timestamps, target_*) -> ids and
    timestamps [B, L + max_out]: the target's timestamp at the row's length,
    and, for training, the target id there too."""
    lengths = batch["lengths"].long()
    b = lengths.shape[0]
    ids = F.pad(batch["ids"].long(), (0, dims.max_out))
    ts = F.pad(batch["timestamps"].long(), (0, dims.max_out))
    rows = torch.arange(b, device=ids.device)
    ts[rows, lengths] = batch["target_timestamp"].long()
    if with_target:
        ids[rows, lengths] = batch["target_id"].long()
    return ids, ts


def train_loss(w: Dict[str, torch.Tensor], dims: Dims, batch: Dict[str, torch.Tensor],
               neg_offsets: torch.Tensor, catalog: torch.Tensor, packed: bool,
               half_batch: bool = False) -> torch.Tensor:
    """The sampled-softmax loss of one batch: position p predicts the id at
    p + 1 against its R negatives (catalog offsets), hits with the positive
    masked, weighted by presence (and, packed, by both positions lying in
    one segment; unpacked, by the row's sample weight). `half_batch` drops
    the second half of the rows from the mean (a planted fault)."""
    if packed:
        ids, ts = batch["ids"].long(), batch["timestamps"].long()
        positions = batch["positions"].long()
    else:
        ids, ts = unpacked_layout(batch, dims, with_target=True)
        positions = None
    out, rows = encode(w, dims, ids, ts, positions, training=True)
    outputs, sup_ids, sup_rows = out[:, :-1], ids[:, 1:], rows[:, 1:]
    weights = (sup_ids != 0).to(torch.float32)
    if packed:
        seg = batch["seg_ids"].long()
        weights = weights * ((seg[:, 1:] == seg[:, :-1]) & (seg[:, :-1] >= 0)).to(torch.float32)
    else:
        weights = weights * batch["sample_weight"].to(torch.float32)[:, None]
    if half_batch:
        weights[weights.shape[0] // 2:] = 0.0
    t = dims.temperature
    pos_logits = (outputs * l2_normalize(sup_rows, dims.l2_eps)).sum(-1) / t
    neg_rows = l2_normalize(F.embedding(catalog[neg_offsets.long()], w[TABLE]), dims.l2_eps)
    neg_logits = torch.einsum("btd,btrd->btr", outputs, neg_rows) / t
    hits = catalog_offsets(catalog, sup_ids)[..., None] == neg_offsets.long()
    neg_logits = torch.where(hits, ACCIDENTAL_HIT_LOGIT, neg_logits)
    per_pos = torch.logaddexp(pos_logits, torch.logsumexp(neg_logits, dim=-1)) - pos_logits
    return (per_pos * weights).sum() / torch.clamp(weights.sum(), min=1e-12)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float
    beta1: float
    beta2: float
    eps: float
    weight_decay: float

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             state: Dict[str, List[torch.Tensor]], t: int) -> None:
        """Decoupled weight decay, then Adam with bias correction (step t >= 1)."""
        bc1, bc2 = 1 - self.beta1 ** t, 1 - self.beta2 ** t
        for name, p in params.items():
            g = grads[name]
            m, v = state.setdefault(name, [torch.zeros_like(p), torch.zeros_like(p)])
            p.mul_(1 - self.lr * self.weight_decay)
            m.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
            v.mul_(self.beta2).addcmul_(g, g, value=1 - self.beta2)
            denom = (v.sqrt() / math.sqrt(bc2)).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / bc1)


def negatives_shape(batch: Dict[str, np.ndarray], dims: Dims, packed: bool) -> Tuple[int, ...]:
    rows, cols = batch["ids"].shape
    return rows, cols - 1 + (0 if packed else dims.max_out), dims.num_negatives


def follow_training(weights: Dict[str, torch.Tensor], dims: Dims, batches: List[Dict[str, np.ndarray]],
                    catalog: np.ndarray, seed: int, opt: AdamW, packed: bool,
                    half_batch: bool = False) -> dict:
    """Train from `weights` (consumed: updated in place) through `batches`,
    one step each, drawing each step's negatives with `torch.randint` from a
    generator on the device seeded with `seed`, and the dropout masks from
    the default generator seeded with `seed`. -> {"losses": [...],
    "grad_norms": {leaf: norm of step 1's gradient}, "change_norms": {leaf:
    norm of the change over all the steps}}."""
    device = next(iter(weights.values())).device
    cat = torch.as_tensor(np.asarray(catalog, dtype=np.int64), device=device)
    start = {name: p.detach().clone() for name, p in weights.items()}
    params = {name: p.detach().requires_grad_() for name, p in weights.items()}
    torch.manual_seed(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    state: Dict[str, List[torch.Tensor]] = {}
    losses, grad_norms = [], {}
    for step, host in enumerate(batches, start=1):
        batch = {k: torch.as_tensor(np.asarray(v), device=device) for k, v in host.items()
                 if k != "example"}
        offsets = torch.randint(0, len(catalog), negatives_shape(host, dims, packed),
                                generator=gen, dtype=torch.int32, device=device)
        loss = train_loss(params, dims, batch, offsets, cat, packed, half_batch)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
        losses.append(loss.item())
        if step == 1:
            grad_norms = {n: float(g.norm()) for n, g in grads.items()}
        del loss
        opt.step(params, grads, state, step)
        del grads
    change = {n: float((params[n].detach() - start[n]).norm()) for n in params}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
