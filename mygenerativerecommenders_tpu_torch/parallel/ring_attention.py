"""Ring (sequence-parallel) HSTU attention: its P shards run in turn on one
device, or one a rank over the "sp" group of a mesh of processes.

Port of mygenerativerecommenders_tpu/parallel/ring_attention.py. HSTU
attention is a plain sum over keys (no row max, no denominator), so a shard
can add the partial attention of its query rows against one K/V chunk at a
time, in a fixed order:

    out[n] = sum_m silu(q[n].k[m] + bias[n, m]) / max_len * causal * v[m]

The sequence axis of length N splits into P shards of Nl = N / P rows. At
ring step t shard p holds the K/V chunk that originated on shard
(p - t) mod P and adds its contribution, with the chunk's global row and
column offsets driving the causal mask and the relative biases; after P steps
every (query row, key column) pair has been visited once.

The bodies `ring_hstu_attention_local` and `ring_hstu_attention_zigzag_local`
compute for one shard exactly what the JAX bodies (:104-146, :178-274) do on
one device: the same chunk calls with the same offsets, the same next-item
timestamp bookkeeping, and the contributions added in the same order. They
reach the other shards only through a ring object with two methods, which
every shard calls alike (over a group each call is a collective):

- `resident(p, t)`: (src, k, v, timestamps) of the chunk shard p holds at
  step t, the JAX body's ppermute rotation;
- `all_gather(fn)`: fn of every shard's timestamps, stacked [P, ...], the
  JAX body's collectives on the first timestamps.

`OneDeviceRing` holds all P shards on one device, so the rotation is a
change of which slice a shard reads, not a copy (`ring_hstu_attention`).
`ProcessGroupRing` is the ring over an sp group of ranks, one shard a rank
(`ring_hstu_attention_group`, the counterpart of the JAX block's
`shard_map`, models/hstu.py:256-277): its K/V chunk and timestamps travel
one rank forward each step (`ProcessGroupShards.rotate`), and the first
timestamps are all-gathered over the group. It takes and returns the
rank's own rows: the stack pads, orders and splits the rows once at its
entry and gathers them at its exit (`StackRows`), and every block between
runs on the rank's rows, as JAX's compiled program does in the contiguous
layout (GSPMD carries the `shard_map`'s sequence sharding back through the
block; in the zigzag layout the permutation stops it there).

Where a chunk has no live pair (its first column at or past the last row of
the shard, `col_off - row_off >= Nl`) the body skips it on the host, as the
zigzag `lax.cond` does (:254-264); the JAX contiguous body adds the chunk
kernel's zeros there, which leaves the sum the same. Over a group a skipped
chunk skips its compute only: the rotation of that step runs on every rank.
Each chunk goes through `ops/kernels/hstu_chunk.py`: the CUDA kernels on the
card, the plain version on the CPU.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from mygenerativerecommenders_tpu_torch.ops.kernels.hstu_chunk import hstu_chunk_attention
from mygenerativerecommenders_tpu_torch.parallel.embedding_sharding import ProcessGroupShards


def chunk_contribution(
    q, k_chunk, v_chunk, tsq_next, tsk_chunk, row_off: int, col_off: int,
    pos_w, ts_w, max_len: int, num_buckets: int,
) -> torch.Tensor:
    """Partial HSTU attention of local queries [B, Nq, H, D] vs one K/V chunk
    [B, Nc, H, D*] whose rows start at global row `col_off`, the queries at
    `row_off` (`_chunk_contribution`, :56-84). -> [B, Nq, H, Dv] float32."""
    return hstu_chunk_attention(
        q, k_chunk, v_chunk, tsq_next, tsk_chunk, col_off - row_off, pos_w, ts_w,
        inv_n=1.0 / max_len, max_len=max_len, num_buckets=num_buckets,
    )


class OneDeviceRing:
    """The K/V chunks and timestamps of P shards held by one device: shard s
    holds rows [s * Nl, (s + 1) * Nl) of k, v and timestamps (in the ring's
    layout, contiguous or zigzag)."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, timestamps: torch.Tensor,
                 num_shards: int):
        self.num_shards = num_shards
        # views of each shard's rows: no copy
        self._k = k.chunk(num_shards, dim=1)
        self._v = v.chunk(num_shards, dim=1)
        self._ts = timestamps.chunk(num_shards, dim=1)

    def resident(self, p: int, t: int):
        src = (p - t) % self.num_shards  # the shard the chunk originated on
        return src, self._k[src], self._v[src], self._ts[src]

    def all_gather(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        return torch.stack([fn(ts) for ts in self._ts])


def _add(acc: Optional[torch.Tensor], part: torch.Tensor) -> torch.Tensor:
    # the JAX bodies start from zeros: 0 + part is part
    return part if acc is None else acc + part


def ring_hstu_attention_local(
    q, timestamps, ring, p: int, pos_w, ts_w, *, max_len: int, num_buckets: int,
) -> torch.Tensor:
    """The contiguous body for shard p: q [B, Nl, H, Dqk] and timestamps
    [B, Nl] are the shard's own rows. max_len is the GLOBAL N (the 1/n
    normaliser and the position table's centre). -> [B, Nl, H, Dv] float32."""
    num_shards = ring.num_shards
    nl = q.shape[1]
    ts = timestamps.to(torch.int32)
    # ext[n+1] per local query row: shift left, the last row takes the first
    # timestamp of the next shard, except the globally last row, which
    # repeats itself (:121-128). Every shard gathers, the last too, as every
    # JAX shard takes part in the ppermute
    firsts = ring.all_gather(lambda t: t[:, :1].to(torch.int32))
    tail = ts[:, -1:] if p == num_shards - 1 else firsts[p + 1]
    tsq_next = torch.cat([ts[:, 1:], tail], dim=1)

    row_off = p * nl
    acc = None
    for t in range(num_shards):
        src, k_c, v_c, tsk_c = ring.resident(p, t)
        if src * nl - row_off >= nl:
            continue  # a chunk past the causal frontier: no live pair
        acc = _add(acc, chunk_contribution(
            q, k_c, v_c, tsq_next, tsk_c.to(torch.int32), row_off, src * nl,
            pos_w, ts_w, max_len, num_buckets,
        ))
    return acc


def zigzag_order(num_shards: int, n: int) -> np.ndarray:
    """Permutation taking a contiguous sequence to zigzag layout (:149-167):
    the sequence splits into 2P chunks and shard p holds the pair
    (p, 2P-1-p). zigzag[i] = contiguous[perm[i]]; n must divide by 2P."""
    nh = n // (2 * num_shards)
    if nh * 2 * num_shards != n:
        raise ValueError(f"sequence length {n} does not divide by 2 * {num_shards} shards")
    chunks = []
    for p in range(num_shards):
        chunks.append(np.arange(p * nh, (p + 1) * nh))
        c2 = 2 * num_shards - 1 - p
        chunks.append(np.arange(c2 * nh, (c2 + 1) * nh))
    return np.concatenate(chunks)


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


@functools.lru_cache(maxsize=None)
def _zigzag_index(
    num_shards: int, n: int, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`zigzag_order` and its inverse as index tensors on `device`, made once
    per (P, N, device): a forward then copies nothing from the host, which a
    CUDA graph of the step could not capture. A run meets one or two N."""
    order = zigzag_order(num_shards, n)
    return (
        torch.as_tensor(order, device=device),
        torch.as_tensor(inverse_permutation(order), device=device),
    )


def ring_hstu_attention_zigzag_local(
    q, timestamps, ring, p: int, pos_w, ts_w, *, max_len: int, num_buckets: int,
) -> torch.Tensor:
    """The load-balanced body for shard p, inputs in zigzag layout: its rows
    are the chunk pair (front = chunk p, back = chunk 2P-1-p) of 2P global
    chunks. Each ring step adds back x front always, front x front when the
    resident pair originated at src <= p and back x back when src >= p; the
    other half-blocks have no live pair and are skipped. -> [B, Nl, H, Dv]."""
    num_shards = ring.num_shards
    nl = q.shape[1]
    nh = nl // 2  # rows per chunk; 2P chunks globally
    ts = timestamps.to(torch.int32)

    # first timestamp of every global chunk, chunk-indexed [2P, B]: chunk
    # c < P is shard c's front half, chunk c >= P shard 2P-1-c's back half
    ag = ring.all_gather(lambda t: torch.stack([t[:, 0], t[:, nh]]).to(torch.int32))
    chunk_firsts = torch.cat([ag[:, 0], ag.flip(0)[:, 1]], dim=0)
    # ext[n+1] per chunk: the last row of chunk c takes the first timestamp
    # of chunk c+1, except the globally last row (chunk 2P-1, shard 0's back
    # half), which repeats (:213-229)
    tail_f = chunk_firsts[p + 1][:, None]
    tail_b = ts[:, -1:] if p == 0 else chunk_firsts[2 * num_shards - p][:, None]
    tsq_next = torch.cat([ts[:, 1:nh], tail_f, ts[:, nh + 1:], tail_b], dim=1)

    def halves(x):
        return x[:, :nh], x[:, nh:]

    qf, qb = halves(q)
    nf, nb = halves(tsq_next)
    row_f = p * nh
    row_b = (2 * num_shards - 1 - p) * nh

    def contrib(qh, kc, vc, tsqn, tskc, row_off, col_off):
        return chunk_contribution(
            qh, kc, vc, tsqn, tskc, row_off, col_off, pos_w, ts_w, max_len, num_buckets,
        )

    acc_f = acc_b = None
    for t in range(num_shards):
        s, k_c, v_c, tsk_c = ring.resident(p, t)
        col_f = s * nh
        col_b = (2 * num_shards - 1 - s) * nh
        kcf, kcb = halves(k_c)
        vcf, vcb = halves(v_c)
        tf, tb = halves(tsk_c.to(torch.int32))
        # back queries x front keys: always causally live
        acc_b = _add(acc_b, contrib(qb, kcf, vcf, nb, tf, row_b, col_f))
        # front x front: live iff the resident front chunk s <= p
        if s <= p:
            acc_f = _add(acc_f, contrib(qf, kcf, vcf, nf, tf, row_f, col_f))
        # back x back: live iff s >= p (s == p is the causal diagonal)
        if s >= p:
            acc_b = _add(acc_b, contrib(qb, kcb, vcb, nb, tb, row_b, col_b))
    return torch.cat([acc_f, acc_b], dim=1)


def ring_hstu_attention(
    q, k, v, timestamps, pos_w, ts_w, *, num_shards: int, zigzag: bool,
    max_len: int, num_buckets: int,
) -> torch.Tensor:
    """Ring attention over the whole sequence on one device: the P shard
    bodies run in turn (`make_ring_hstu_attention`, :277-321, without a
    mesh). q, k [B, N, H, Dqk], v [B, N, H, Dv], timestamps [B, N] in
    contiguous order; N must divide by P (2P for zigzag). -> [B, N, H, Dv]."""
    if zigzag:
        # contiguous -> zigzag -> (ring) -> contiguous
        perm, inverse = _zigzag_index(num_shards, q.shape[1], q.device)
        q, k, v, timestamps = (x.index_select(1, perm) for x in (q, k, v, timestamps))
    ring = OneDeviceRing(k, v, timestamps, num_shards)
    body = ring_hstu_attention_zigzag_local if zigzag else ring_hstu_attention_local
    q_shards = q.chunk(num_shards, dim=1)
    ts_shards = timestamps.chunk(num_shards, dim=1)
    out = torch.cat([
        body(q_shards[p], ts_shards[p], ring, p, pos_w, ts_w,
             max_len=max_len, num_buckets=num_buckets)
        for p in range(num_shards)
    ], dim=1)
    if zigzag:
        out = out.index_select(1, inverse)
    return out


class ProcessGroupRing:
    """The ring over an sp group of ranks (`ProcessGroupShards` of the mesh's
    "sp" axis, parallel/process_group.py), rank p holding shard p. Its K/V
    chunk and timestamps travel as one float32 block [B, Nl, H*Dqk + H*Dv +
    1] (the int32 timestamps' bits in the last column): each ring step every
    rank sends its resident block one rank forward and takes the one from
    the rank behind (`ProcessGroupShards.rotate`, JAX's ppermute, :133-143),
    whatever chunk its body skips, and none after the last step (JAX's last
    ppermute moves blocks nothing reads). With `leaves` each resident block
    is a leaf that requires grad (`_GroupRingAttention` sends its gradient
    back around the ring)."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, timestamps: torch.Tensor,
                 group: ProcessGroupShards, leaves: bool = False):
        self.group, self.num_shards = group, group.size
        self._leaves = leaves
        self._ts = timestamps.to(torch.int32)
        b, nl, h, dqk = k.shape
        self._widths = (h, dqk, v.shape[3])
        # concatenated as int32 words: an exact copy of every bit
        words = torch.cat([k.reshape(b, nl, -1).view(torch.int32),
                           v.reshape(b, nl, -1).view(torch.int32), self._ts[..., None]], dim=-1)
        self.blocks = [self._leaf(words.view(torch.float32))]

    def _leaf(self, block: torch.Tensor) -> torch.Tensor:
        return block.requires_grad_() if self._leaves else block

    def kv(self, block: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(k [B, Nl, H, Dqk], v [B, Nl, H, Dv]): views of a block (or of its
        gradient)."""
        h, dqk, dv = self._widths
        return (block[..., : h * dqk].unflatten(-1, (h, dqk)),
                block[..., h * dqk : h * (dqk + dv)].unflatten(-1, (h, dv)))

    def resident(self, p: int, t: int):
        if p != self.group.rank:
            raise ValueError(f"rank {self.group.rank} of the sp group asked for shard {p}'s chunk")
        while len(self.blocks) <= t:
            with torch.no_grad():
                self.blocks.append(self._leaf(self.group.rotate(self.blocks[-1].detach(), 1)))
        block = self.blocks[t]
        k, v = self.kv(block)
        return (p - t) % self.num_shards, k, v, block.detach()[..., -1].view(torch.int32)

    def all_gather(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        mine = fn(self._ts)
        return self.group.all_gather(mine[None], dim=0).unflatten(0, (self.num_shards, -1))

    def send_back(self, grads) -> torch.Tensor:
        """The gradient of the rank's own block from the gradients of its
        resident blocks, step by step: block t was block t-1 received from
        the rank behind, so its gradient goes back there (the inverse
        rotation, ppermute's transpose) and adds to block t-1's."""
        acc = grads[-1]
        for t in range(len(grads) - 1, 0, -1):
            acc = grads[t - 1] + self.group.rotate(acc, -1)
        return acc


def _keep(t: torch.Tensor) -> torch.Tensor:
    return t.detach()


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


class _GroupRingAttention(torch.autograd.Function):
    """One block's ring over an sp group: the forward runs the rank's body
    over a `ProcessGroupRing` (its rotations), building the body's graph on
    leaves; the backward takes that graph's gradients, then sends the
    resident blocks' gradients back around the ring. The body's chunk calls
    differ from rank to rank (each skips its dead chunks), so autograd would
    order the rotations' backwards differently on each; here every
    collective of the backward is in one node, issued in one order on every
    rank. The body's graph keeps its saved tensors as they are (`_keep`):
    under remat a checkpoint's hooks would recompute them from this node's
    backward, a graph task of its own, running the block's forward and its
    collectives a second time."""

    @staticmethod
    def forward(ctx, q, k, v, pos_w, ts_w, timestamps, group, body, max_len, num_buckets):
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(_keep, _same):
            q_, pos_, ts_w_ = (x.detach().requires_grad_() for x in (q, pos_w, ts_w))
            ring = ProcessGroupRing(k.detach(), v.detach(), timestamps, group, leaves=True)
            out = body(q_, timestamps, ring, group.rank, pos_, ts_w_, max_len=max_len,
                       num_buckets=num_buckets)
        ctx.graph = (out, (q_, pos_, ts_w_, *ring.blocks))
        ctx.ring = ring
        return out.detach()

    @staticmethod
    def backward(ctx, g):
        out, leaves = ctx.graph
        del ctx.graph
        grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
        dq, d_pos, d_ts, *blocks = (torch.zeros_like(x) if d is None else d
                                    for x, d in zip(leaves, grads))
        dk, dv = ctx.ring.kv(ctx.ring.send_back(blocks))
        return dq, dk, dv, d_pos, d_ts, None, None, None, None, None


def ring_hstu_attention_group(
    q, k, v, timestamps, pos_w, ts_w, *, group: ProcessGroupShards, zigzag: bool,
    max_len: int, num_buckets: int,
) -> torch.Tensor:
    """Ring attention over the sp group `group`, one shard a rank: the
    counterpart of the JAX block's `shard_map` over "sp" (hstu.py:256-277).
    q, k [B, Nl, H, Dqk], v [B, Nl, H, Dv] and timestamps [B, Nl] are the
    rank's own rows in the ring's layout (`StackRows`), as the stack holds
    them from its entry to its exit. -> the rank's rows of the output [B,
    Nl, H, Dv]. The gradients of pos_w and ts_w are the rank's part, from
    its rows alone: the step sums them over the group (a leaf partial over
    "sp", parallel/process_group.py:GradBuffer)."""
    p = group.rank
    body = ring_hstu_attention_zigzag_local if zigzag else ring_hstu_attention_local
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v, pos_w, ts_w)):
        return _GroupRingAttention.apply(q, k, v, pos_w, ts_w, timestamps, group, body, max_len,
                                         num_buckets)
    return body(q, timestamps, ProcessGroupRing(k, v, timestamps, group), p, pos_w, ts_w,
                max_len=max_len, num_buckets=num_buckets)


class StackRows:
    """The rows of the block stack over an sp group of P ranks: each rank
    runs the LayerNorms, the projections and the residual of every block
    on its own rows, as JAX's compiled program does in the contiguous
    layout (block 0's uvqk dot of the 8-device synthetic-smoke step is
    [local batch x N_pad / sp, uvqk width]; in the zigzag layout JAX runs it
    on every row). N pads once to a multiple of P (of
    2P in the zigzag layout), the rows go into the ring's order once, and
    rank p keeps rows [p * Nl, (p + 1) * Nl) of that layout: `enter` (x;
    backward, every rank's rows' cotangents gathered) and `local` (the mask,
    the timestamps, a dropout mask: no gradient). `exit` gathers the ranks'
    rows in rank order and puts them back in contiguous order, the N rows
    of a replicated x (backward, the rank's rows of the cotangent). Padded
    rows of x and the mask are zero; the timestamps pad by repeating the
    last column, so the last real row's next-item timestamp is the dense
    path's."""

    def __init__(self, group: ProcessGroupShards, n: int, zigzag: bool, device: torch.device):
        self.group, self.n = group, n
        chunks = 2 * group.size if zigzag else group.size
        self.n_pad = -(-n // chunks) * chunks
        self.nl = self.n_pad // group.size
        self._order = _zigzag_index(group.size, self.n_pad, device) if zigzag else None

    def _layout(self, x: torch.Tensor, edge: bool = False) -> torch.Tensor:
        pad = self.n_pad - self.n
        if pad:
            tail = x[:, -1:] if edge else torch.zeros_like(x[:, :1])
            x = torch.cat([x, tail.expand(-1, pad, *x.shape[2:])], dim=1)
        return x if self._order is None else x.index_select(1, self._order[0])

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's rows [B, Nl, ...] of x [B, N, ...]."""
        return self.group.own(self._layout(x), dim=1)

    def local(self, x: Optional[torch.Tensor], edge: bool = False) -> Optional[torch.Tensor]:
        """The rank's rows of x [B, N, ...], which takes no gradient; with
        `edge` the padded rows repeat the last one."""
        if x is None:
            return None
        return self._layout(x, edge).narrow(1, self.group.rank * self.nl, self.nl)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows [B, Nl, ...] -> [B, N, ...] in contiguous order."""
        out = self.group.all_gather(x[None], dim=1)
        if self._order is not None:
            out = out.index_select(1, self._order[1])
        return out[:, : self.n]
