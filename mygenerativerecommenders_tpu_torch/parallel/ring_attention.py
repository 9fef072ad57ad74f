"""Ring (sequence-parallel) HSTU attention, its P shards run in turn on one
device.

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
reach the other shards only through a ring object with two methods:

- `resident(p, t)`: (src, k, v, timestamps) of the chunk shard p holds at
  step t, the JAX body's ppermute rotation;
- `all_gather(fn)`: fn of every shard's timestamps, stacked [P, ...], the
  JAX body's collectives on the first timestamps.

`OneDeviceRing` holds all P shards on one device, so the rotation is a
change of which slice a shard reads, not a copy. A ring over a process group
supplies the same two methods with collectives.

Where a chunk has no live pair (its first column at or past the last row of
the shard, `col_off - row_off >= Nl`) the body skips it on the host, as the
zigzag `lax.cond` does (:254-264); the JAX contiguous body adds the chunk
kernel's zeros there, which leaves the sum the same. Each chunk goes through
`ops/kernels/hstu_chunk.py`: the CUDA kernels on the card, the plain version
on the CPU.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from mygenerativerecommenders_tpu_torch.ops.kernels.hstu_chunk import hstu_chunk_attention


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
    # repeats itself (:121-128)
    if p == num_shards - 1:
        tail = ts[:, -1:]
    else:
        tail = ring.all_gather(lambda t: t[:, :1].to(torch.int32))[p + 1]
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
        order = zigzag_order(num_shards, q.shape[1])
        perm = torch.as_tensor(order, device=q.device)
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
        out = out.index_select(1, torch.as_tensor(inverse_permutation(order), device=q.device))
    return out
