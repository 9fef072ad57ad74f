#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths (padded, packed and
through ring attention) on one NVIDIA card and check its kernels.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:

1. The card's name and power limit (nvidia-smi), then the nvcc build of every
   kernel from csrc/ (one nvcc per source, all started together), with the
   build time and the -Xptxas -v summary.
2. Each kernel against its plain PyTorch version on the card, then both timed
   with CUDA events and set against the kernel's bound:
   - the attention forward at the serving shape (B=32, N=L=211, H=1, d=50,
     ragged lengths including 1 and 211, ml-1m-era timestamps) and at the
     ml-20m-hstu-long widths (B=4, N=L=1035, H=2, d=64), rtol 2e-4 / atol 2e-5,
     rows past the length exactly zero and the output bit for bit the same in
     a second call (no atomics touch it);
   - the attention backward against autograd of the plain version at the
     training shape (B=128, N=L=211, H=1, d=50, ragged) and at the wide shape:
     dq, dk, dv at rtol 2e-4 / atol 2e-5, d_pos_w and d_ts_w at rtol 5e-4
     (they sum ~N^2 terms per row, here with float atomics whose order changes
     from run to run), rows past the length exactly zero, and dq, dk, dv bit
     for bit the same in a second call (no atomics touch them);
   - both attention kernels with `seg_positions` (packed rows) at a row of
     ml-1m-hstu-packed (B=56, N=256, L=211, H=1, d=50) and at the widest row
     of ml-20m-hstu-long (B=4, N=1152, L=1035, H=2, d=64: wider than the bias
     table reaches), segments of mixed lengths including 1 and L, one row with
     trailing padding, the same tolerances; a gradient sent into one segment
     must leave dq, dk, dv of every other segment and row exactly zero, and a
     null `seg_positions` must give the bits of one segment per row; the
     backward also at B=4, N=1121 (not a multiple of its 32-row tile), L=1035,
     H=2, d=64, packed, with rows of packed length 1 and 20;
   - the negative count at [26880, 128] into X=3,706 and X=26,744, with
     accidental hits and sentinels, exactly; and at [26880, 256] into X=3,706
     (int32 counts, one bin of 256), with the lse kernels on those counts;
   - the dense-negative lse forward and backward at [26880, 50] x [3706, 50]
     with those counts, tau 0.05, one all-hit row: lse, dq, dcat at rtol 2e-4
     / atol 2e-5, dq and dcat against autograd of the plain version and
     against the sparse plain backward (`dense_neg_lse_bwd_plain`, given the
     plain forward's m_safe and s), the all-hit row's dq exactly zero and dq
     bit for bit the same in a second call (no atomics touch it); the same
     over the ml-20m catalog, at [26880, 50] x [26744, 50] (the step of
     ml-20m-hstu), at [24552, 64] x [26744, 64] (the 1024-token class of a
     packed ml-20m-hstu-long step) and at [4297, 64] x [26744, 64] (its
     256-token class), where the dense plain version runs 2,048 rows at a
     time; and at [4096, 64] x [150, 64] with 255 draws a row, rows denser
     than the backward's list of 128 live logits, where each dcat entry sums
     thousands of terms (the kernel sums them in float64; dcat's bits in a
     second call are logged);
   - the same lse kernels with `sup_off` (`fused_dense_neg_lse`, each row's
     positive masked in the kernel) at [8192, 64] x [26744, 64], with the same
     checks, and an all -1 sup_off against the null pointer, lse and dq bit
     for bit;
   - the ring's chunk attention forward and backward against autograd of the
     plain version at ml-20m-hstu-long's widths (B=32, H=2, d=64, L=1035) on
     the zigzag ring's 130 x 130 chunks and the contiguous ring's 259 x 259,
     at the offsets the ring gives them (fully live, the diagonal, dead: all
     zeros), a partial one and padded rows past the bias table; neither
     kernel zero-fills anything or takes atomics on out, dq, dk, dv, so rows
     that no live pair reaches must come out exactly zero and a second call
     must give the same bits; each kernel's host time to queue a call.
3. The serving path at the full width of `synthetic-hstu`: `cli.serve.build_engine`
   on a .pt checkpoint written from a seeded init, the HTTP server on an
   ephemeral port, /healthz, a 32-row /v1/retrieve, a burst of concurrent
   single-row requests through the coalescer, then rounds of timed 32-row
   requests alternated with the same call made on the engine directly (the
   difference is the HTTP + JSON cost). The launch counts are set to 0 just
   before and read just after: each engine call must launch the attention
   kernel once per HSTU block. The same requests then go through an engine
   built with device="cpu" from the same checkpoint; the two must agree.
   Last, torch.profiler reads the device kernel time of a 32-row engine
   call, set against its host wall time.
4. The training path at the full width of `synthetic-hstu` (batch 128, so
   26,880 supervision rows, 128 negatives, 3,706 catalog rows, dropout 0.2,
   AdamW): `cli.train.main` on the card for 30 epochs (480 optimizer steps,
   validation after each, then the test pass on the best checkpoint), the
   run of the JAX package's recipe validation (PARITY.md, "Recipe
   validation": test ndcg@10 0.037-0.039 on the same data). The launch
   counts are set to 0 just before and read just after: per optimizer step 2
   attention forwards, 2 attention backwards, 1 count, 1 lse forward, 1 lse
   backward, and 2 attention forwards per eval batch. Every loss must be
   finite, the last five lower than the first five on average, the metrics in
   [0, 1] and the test ndcg@10 at least 0.03 (chance is 10 / 3706; torch's
   random streams are not JAX's, so the band itself is not asserted). Then a
   second trainer is stepped by hand for the step time, the per-step launch
   counts and a torch.profiler step.
5. One step on the card against the same step on the CPU: the same weights,
   batch and negative offsets, dropout off, through the port on `cuda`
   (kernels) and on `cpu` (plain versions): the loss at rtol 1e-5, every
   parameter's gradient at rtol 5e-4 / atol 1e-6.
6. The packed, long-sequence, wide-catalog training path at the full width of
   `ml-20m-hstu-long` on synthetic data (D=64, 8 blocks, H=2, L=1035, batches
   of 32 examples packed into rows of 256 / 512 / 1024 / 1152 tokens, 26,744
   catalog rows among ids up to 131,262, 128 negatives, dropout 0.2, AdamW):
   `cli.train.main` on the card for two epochs with the packed eval after
   each and the test pass on the best checkpoint. The launch counts are set
   to 0 just before and read just after: per optimizer step 8 attention
   forwards, 8 backwards, 1 count, 1 lse forward, 1 lse backward, and 8
   forwards per eval batch. Losses finite and falling, metrics in [0, 1].
   Then a second trainer is stepped by hand, class of capacity by class: step
   time, examples/s, tokens a step and a torch.profiler step.
7. Phase 5 once more on one packed batch of capacity 256 of that
   configuration.
8. Ring (sequence-parallel) attention at the full width of ml-20m-hstu-long
   on synthetic data with padded rows: `cli.train.main` with
   model.encoder.sp_shards=4 and the zigzag layout, the 4 shards of the ring
   run in turn on the card, for two epochs over 1,024 users with validation
   after each and the test pass. The launch counts are set to 0 just before
   and read just after: per optimizer step 8 x 36 chunk forwards and as many
   backwards, 1 count, 1 lse forward, 1 lse backward and no full attention
   kernel; 8 x 36 chunk forwards per eval batch. Then hand-stepped trainers
   in the zigzag and contiguous (8 x 10 chunk calls) layouts: step time,
   examples/s, per-step launch counts, a torch.profiler step with its device
   launches logged beside the expected 4,923 (zigzag) and 1,355 (contiguous);
   then zigzag eval batches, forward only, where the chunk forward runs alone:
   p50 of 8 synced batches, 288 chunk forwards each, a torch.profiler batch.
9. The ring model, zigzag and contiguous, against the same weights at
   sp_shards=1 on the card: one full-width batch, the same negatives, dropout
   off, the loss at rtol 1e-5 and every gradient at rtol 5e-4 / atol 1e-6.

It ends with one JSON line of the kernels' numbers and, last, the line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
OUT_DIR = HERE / "build" / "chip_smoke"
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 non-tensor FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
RTOL, ATOL = 2e-4, 2e-5  # kernel vs plain: fp32 sums in another order
BIAS_RTOL = 5e-4  # bias-table gradients: ~N^2 terms per entry, atomics in any order
# one step on the card vs on the CPU: loss and per-parameter gradients. The
# gradients sum float32 terms over 26,880 supervision rows in different orders
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_GRAD_ATOL = 1e-5, 5e-4, 1e-6
TRAIN_BT, TRAIN_R = 128 * 210, 128  # supervision rows and negatives of synthetic-hstu
# 30 epochs of synthetic-hstu: the JAX package lands at test ndcg@10
# 0.037-0.039; chance is 10 / 3706 = 0.0027. Below this the training is broken
MIN_TEST_NDCG10 = 0.03
# card vs CPU engine: L2-normalized fp32 scores (|s| <= 1) through two blocks,
# summed in different orders on the two devices
E2E_ATOL = 1e-4


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- phase 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def build_kernels(_build, names):
    built = _build.build(names)
    for name, res in built.items():
        log(f"built {name} in {res.seconds:.2f} s -> {res.path.name}")
        for line in res.log.splitlines():
            if "ptxas" in line or "reused" in line:
                log(f"  {line.strip()}")


# ---------------------------------------------------------------- phase 2


def packed_layout(seed, b, n, max_seg):
    """Within-segment positions [b, n] and packed lengths [b] of rows that hold
    segments of mixed lengths end to end. Row 0 keeps a fifth of the row as
    trailing padding (positions 0 there, as the loader leaves them); row 1
    starts with a segment of 1 and one of max_seg (or what the row has left)."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((b, n), dtype=np.int32)
    lengths, bounds = [], []
    for r in range(b):
        room = n - (n // 5 if r == 0 else 0)
        segs = [1, min(max_seg, room - 1)] if r == 1 else []
        while sum(segs) < room:
            segs.append(int(min(rng.integers(1, max_seg + 1), room - sum(segs))))
        at, row_bounds = 0, []
        for seg in segs:
            pos[r, at : at + seg] = np.arange(seg)
            row_bounds.append((at, at + seg))
            at += seg
        lengths.append(at)
        bounds.append(row_bounds)
    return pos, lengths, bounds


def attention_inputs(seed, b, n, h, d, lengths, proj_grad: bool = False, max_len=None,
                     seg=None):
    """q, k, v as column slices of one uvqk projection `proj`, as the block
    gives them; with proj_grad, proj is a leaf that takes their gradients and
    is returned beside the inputs. `max_len` (default n) sizes pos_w; `seg`
    [b, n] are the within-segment positions of packed rows."""
    rng = np.random.default_rng(seed)
    max_len = max_len or n
    proj = torch.tensor(rng.normal(size=(b, n, 4 * h * d)), dtype=torch.float32).cuda()
    proj.requires_grad_(proj_grad)
    _, v, q, k = torch.split(proj, [h * d] * 4, dim=-1)
    ts = np.sort(978_000_000 + rng.integers(0, 3 * 365 * 86400, size=(b, n)), axis=1)
    inputs = dict(
        q=q.unflatten(-1, (h, d)), k=k.unflatten(-1, (h, d)), v=v.unflatten(-1, (h, d)),
        timestamps=torch.tensor(ts, dtype=torch.int32).cuda(),
        pos_w=torch.tensor(rng.normal(size=(2 * max_len - 1,)) * 0.02, dtype=torch.float32).cuda(),
        ts_w=torch.tensor(rng.normal(size=(129,)) * 0.02, dtype=torch.float32).cuda(),
        max_len=max_len, num_buckets=128,
        lengths=torch.tensor(lengths, dtype=torch.int32).cuda(),
    )
    if seg is not None:
        inputs["seg_positions"] = torch.tensor(seg, dtype=torch.int32).cuda()
    return (inputs, proj) if proj_grad else inputs


def device_ms(fn, reps: int) -> float:
    """Device time per call: a sleep kernel holds the stream while the host
    queues all `reps` calls, so the events time them back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s at H100 clocks
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least ms the card could take: bytes at peak bandwidth or fp32
    operations at the peak non-tensor rate, whichever is longer."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def within(got, want, rtol: float, atol: float) -> tuple[bool, float]:
    diff = (got - want).detach().abs()
    return bool((diff <= atol + rtol * want.detach().abs()).all()), float(diff.max())


def attention_work(a) -> tuple[int, int, int, int]:
    """(valid rows, timestamps read, table entries read, live pairs) of this
    call's lengths and segments. A valid row sees the keys from its segment's
    start on: position + 1 of them, the position being the row index in an
    unpacked row. In a packed row the positions are read too."""
    b, n = a["q"].shape[:2]
    seq = torch.clamp(a["lengths"].cpu().long(), max=n)
    rows = int(seq.sum())
    stamps = int(torch.clamp(seq + 1, max=n).sum())
    idx = torch.arange(n)
    valid = idx[None, :] < seq[:, None]
    seg = a.get("seg_positions")
    pos = idx[None, :].expand(b, n) if seg is None else seg.cpu().long()
    pairs = int((pos + 1)[valid].sum())
    small = b + int(pos[valid].max()) + 1 + a["ts_w"].numel() + (0 if seg is None else rows)
    return rows, stamps, small, pairs


def attention_bound(a) -> tuple[float, str]:
    """Least time for this call: the bytes it must move at peak bandwidth vs
    the multiply-adds of q.k and p.v over the live pairs at peak fp32, both
    for this call's lengths and segments. Reads: q, k, v and the timestamps of
    the valid rows only (row m < len, and the next-item stamp of the last
    one), the lengths, the pos_w entries the live offsets reach and all of
    ts_w; writes: the whole output, zeros past the length included."""
    b, n, h, dqk = a["q"].shape
    dv = a["v"].shape[-1]
    rows, stamps, small, pairs = attention_work(a)
    reads = rows * h * (2 * dqk + dv) + stamps + small
    return bound(4 * (reads + b * n * h * dv), pairs * h * 2 * (dqk + dv))


def check_attention(kern, name, seed, b, n, h, d, lengths, max_len=None, seg=None) -> dict:
    a = attention_inputs(seed, b, n, h, d, lengths, max_len=max_len, seg=seg)
    got = kern.hstu_attention_fused(**a)
    want = kern.hstu_attention_fused_plain(**a)
    # each output row is written once by the block that owns it, without
    # atomics: a second call gives the same bits
    same = torch.equal(got, kern.hstu_attention_fused(**a))
    torch.cuda.synchronize()
    diff = (got - want).abs()
    max_abs = float(diff.max())
    big = want.abs() > 1e-3
    max_rel = float((diff[big] / want.abs()[big]).max()) if bool(big.any()) else 0.0
    ok = bool((diff <= ATOL + RTOL * want.abs()).all())
    dead = all(not bool(got[i, length:].any()) for i, length in enumerate(lengths))
    shape = f"B={b} N={n} L={a['max_len']} H={h} d={d}" + (" packed" if seg is not None else "")
    log(f"{name} {shape}: max_abs_err={max_abs:.3e} "
        f"max_rel_err={max_rel:.3e} (|want|>1e-3), within rtol {RTOL} atol {ATOL}: {ok}, "
        f"rows past length zero: {dead}, bit-identical in a second call: {same}")
    check(ok and dead, f"{name} disagrees with its plain version at {shape}")
    check(same, f"{name}: the output changed between two calls at {shape}")
    if seg is None:
        # one segment per row is an unpacked row: the null pointer and the
        # positions 0..n-1 must give the same bits
        whole = torch.arange(n, dtype=torch.int32, device="cuda").expand(b, n).contiguous()
        same = torch.equal(got, kern.hstu_attention_fused(**a, seg_positions=whole))
        log(f"  null seg_positions equals one segment per row bit for bit: {same}")
        check(same, f"{name}: the unpacked call differs from one segment per row")
    ms = device_ms(lambda: kern.hstu_attention_fused(**a), 200)
    plain_ms = device_ms(lambda: kern.hstu_attention_fused_plain(**a), 30)
    bound_ms, bound_by = attention_bound(a)
    log(f"  kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def attention_bwd_bound(a) -> tuple[float, str]:
    """As attention_bound, for the backward: it reads the valid rows of q, k,
    v and g, and writes dq, dk, dv whole and both table gradients; per live
    pair and head it does q.k, g.v, dz k, dz q and p g."""
    b, n, h, dqk = a["q"].shape
    dv = a["v"].shape[-1]
    rows, stamps, small, pairs = attention_work(a)
    reads = rows * h * (2 * dqk + 2 * dv) + stamps + small
    writes = b * n * h * (2 * dqk + dv) + a["pos_w"].numel() + a["ts_w"].numel()
    return bound(4 * (reads + writes), pairs * h * 2 * (3 * dqk + 2 * dv))


def check_attention_bwd(kern, seed, b, n, h, d, lengths, max_len=None, seg=None,
                        bounds=None) -> dict:
    """`bounds[r]` lists the (start, end) of row r's segments, for the check
    that no gradient crosses a segment's edge."""
    a, proj = attention_inputs(seed, b, n, h, d, lengths, proj_grad=True, max_len=max_len,
                               seg=seg)
    a["pos_w"].requires_grad_(), a["ts_w"].requires_grad_()
    leaves = [proj, a["pos_w"], a["ts_w"]]
    rng = np.random.default_rng(seed + 100)
    # a non-contiguous upstream gradient: the wrapper makes it contiguous
    g = torch.tensor(rng.normal(size=(b, h, n, d)), dtype=torch.float32).cuda().transpose(1, 2)

    def split(grads):
        # dq, dk, dv arrive as the column slices of proj's gradient (u's is zero)
        du, dv, dq, dk = torch.split(grads[0], [h * d] * 4, dim=-1)
        check(not bool(du.any()), "a gradient reached the u columns")
        return dq, dk, dv, grads[1], grads[2]

    out = kern.hstu_attention_fused(**a)
    got = split(torch.autograd.grad(out, leaves, g, retain_graph=True))
    again = split(torch.autograd.grad(out, leaves, g, retain_graph=True))
    same = all(torch.equal(x, y) for x, y in zip(got[:3], again[:3]))
    out_plain = kern.hstu_attention_fused_plain(**a)
    want = split(torch.autograd.grad(out_plain, leaves, g, retain_graph=True))
    torch.cuda.synchronize()
    ok, errs = True, []
    for i, name in enumerate(("dq", "dk", "dv", "d_pos_w", "d_ts_w")):
        good, err = within(got[i], want[i], BIAS_RTOL if i >= 3 else RTOL, ATOL)
        ok = ok and good
        errs.append(f"{name} {err:.3e}")
    dead = all(
        not bool(t[i, length:].any()) for t in got[:3] for i, length in enumerate(lengths)
    )
    shape = f"B={b} N={n} L={a['max_len']} H={h} d={d}" + (" packed" if seg is not None else "")
    log(f"{kern.KERNEL_BWD} {shape}: max_abs_err " + ", ".join(errs)
        + f"; within rtol {RTOL} (tables {BIAS_RTOL}) atol {ATOL}: {ok}, "
        f"rows past length zero: {dead}, dq, dk, dv bit-identical in a second call: {same}")
    check(ok and dead, f"{kern.KERNEL_BWD} disagrees with autograd of its plain version "
          f"at {shape}")
    check(same, f"{kern.KERNEL_BWD}: dq, dk, dv changed between two calls at {shape}")
    if bounds is not None:
        # an upstream gradient on one segment alone (row 1's second) must leave
        # dq, dk and dv of every other row and segment exactly zero
        lo, hi = bounds[1][1]
        inside = torch.zeros((b, n, 1, 1), dtype=torch.bool, device="cuda")
        inside[1, lo:hi] = True
        one = split(torch.autograd.grad(out, leaves, torch.where(inside, g, 0.0),
                                        retain_graph=True))
        crossed = any(bool(torch.where(inside.flatten(2), 0.0, t).any()) for t in one[:3])
        reached = all(bool(t[1, lo:hi].any()) for t in one[:3])
        log(f"  gradient sent into row 1 [{lo}, {hi}) alone: reaches it: {reached}, "
            f"dq, dk, dv exactly zero everywhere else: {not crossed}")
        check(reached and not crossed, f"{kern.KERNEL_BWD}: a gradient crossed a segment's edge")
    ms = device_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), 50)
    plain_ms = device_ms(
        lambda: torch.autograd.grad(out_plain, leaves, g, retain_graph=True), 5
    )
    bound_ms, bound_by = attention_bwd_bound(a)
    log(f"  kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return dict(max_abs_err=max(float((x - y).detach().abs().max()) for x, y in zip(got, want)),
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def negative_draws(seed, bt, r, x):
    """[bt, r] offsets and [bt] positives: some draws equal to the positive,
    one all-hit row (row 5), the last 100 rows half sentinels."""
    rng = np.random.default_rng(seed)
    offsets = rng.integers(0, x, size=(bt, r)).astype(np.int32)
    positive = rng.integers(-1, x, size=bt).astype(np.int32)
    offsets[::7, :5] = positive[::7, None]
    positive[5] = 11
    offsets[5, :] = 11
    offsets[-100:, r // 2 :] = x + 5
    if r > 255:  # a bin past a byte: every draw of row 6 on one item
        positive[6] = -1
        offsets[6, :] = 13
    return torch.tensor(offsets).cuda(), torch.tensor(positive).cuda()


def check_count(kern, bt, r, x) -> dict:
    offsets, positive = negative_draws(x, bt, r, x)
    got = kern.count_offsets(offsets, positive, x)
    want = kern.count_offsets_plain(offsets, positive, x)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    hits = int((offsets == positive[:, None]).sum())
    log(f"{kern.KERNEL} [{bt}, {r}] into X={x}: {got.dtype} counts equal to plain: {equal} "
        f"({int(got.sum())} draws counted, {hits} accidental hits and "
        f"{int((offsets >= x).sum())} sentinels dropped, largest bin {int(got.max())})")
    check(equal, f"{kern.KERNEL} disagrees with its plain version at X={x}")
    check(not bool(got[5].any()), "the all-hit row has a count")
    check(got.dtype == (torch.uint8 if r <= 255 else torch.int32),
          f"{r} draws a row gave {got.dtype} counts")
    check(r <= 255 or int(got[6, 13]) == r, "a bin past a byte was not counted whole")
    ms = device_ms(lambda: kern.count_offsets(offsets, positive, x), 50)
    plain_ms = device_ms(lambda: kern.count_offsets_plain(offsets, positive, x), 10)
    # one PyTorch call for the same counts: scatter_add_ into a zeroed int32
    # matrix with the dead draws already routed to a spare column (the mask
    # and the cast to uint8 are left out of its time)
    live = (offsets >= 0) & (offsets < x) & (offsets != positive[:, None])
    index = torch.where(live, offsets, x).long()
    ones = torch.ones_like(index, dtype=torch.int32)
    library_ms = device_ms(
        lambda: torch.zeros((bt, x + 1), dtype=torch.int32, device="cuda").scatter_add_(
            1, index, ones), 10)
    bound_ms, bound_by = bound(4 * (bt * r + bt) + bt * x, bt * r)
    log(f"  kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, scatter_add_ {library_ms:.5f} ms, "
        f"bound {bound_ms:.5f} ms ({bound_by})")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, count=got)


def plain_lse_in_chunks(kern, q, cat, count, tau, gl, chunk, with_grads=True):
    """`dense_neg_lse_plain` and its gradients on `chunk` rows at a time: at a
    wide catalog its [BT, X] float32 logits (2.9 GB at 26,880 x 26,744, several
    times that under autograd) do not have to exist at once."""
    lse, dq = [], []
    dcat = torch.zeros_like(cat)
    for lo in range(0, q.shape[0], chunk):
        qc = q[lo : lo + chunk].detach().requires_grad_(with_grads)
        part = kern.dense_neg_lse_plain(qc, cat, count[lo : lo + chunk], tau)
        lse.append(part.detach())
        if with_grads:
            g_q, g_cat = torch.autograd.grad(part, [qc, cat], gl[lo : lo + chunk])
            dq.append(g_q)
            dcat += g_cat
    return torch.cat(lse), (torch.cat(dq) if with_grads else None), dcat


def plain_lse_stats(kern, q, cat, count, tau, chunk):
    """The forward's per-row (m_safe, s) by `dense_neg_lse_stats_plain`,
    `chunk` rows at a time."""
    with torch.no_grad():
        parts = [kern.dense_neg_lse_stats_plain(q[lo : lo + chunk], cat, count[lo : lo + chunk],
                                                tau) for lo in range(0, q.shape[0], chunk)]
    return torch.cat([m for m, _ in parts]), torch.cat([s for _, s in parts])


def check_lse_bwd(name, got, want_dense, want_sparse, all_hit):
    """The backward kernel's (dq, dcat) against autograd of the dense plain
    version and against the sparse plain backward; dq of an all-hit row
    exactly zero. Returns the largest error of the two comparisons."""
    errs, oks = [], []
    for want in (want_dense, want_sparse):
        for g, w in zip(got, want):
            ok, err = within(g, w, RTOL, ATOL)
            oks.append(ok)
            errs.append(err)
    zero = not bool(got[0][all_hit].any())
    log(f"  {name}: dq, dcat max_abs_err vs autograd of the plain version {errs[0]:.3e}, "
        f"{errs[1]:.3e}, vs the sparse plain backward {errs[2]:.3e}, {errs[3]:.3e}; within "
        f"rtol {RTOL} atol {ATOL}: {all(oks)}; the all-hit row's dq zero: {zero}")
    check(all(oks) and zero, f"{name} disagrees with its plain versions")
    return max(errs)


def check_dense_neg_lse(kern, count, bt, d, x, tau, chunk=None) -> tuple[dict, dict]:
    """`chunk`: rows of the plain version at a time (None: all at once)."""
    chunk = chunk or bt
    rng = np.random.default_rng(17)
    q = torch.tensor(rng.normal(size=(bt, d)), dtype=torch.float32)
    cat = torch.tensor(rng.normal(size=(x, d)), dtype=torch.float32)
    q = (q / q.norm(dim=-1, keepdim=True)).cuda().requires_grad_()
    cat = (cat / cat.norm(dim=-1, keepdim=True)).cuda().requires_grad_()
    gl = torch.tensor(rng.normal(size=(bt,)), dtype=torch.float32).cuda()
    lse = kern.dense_neg_lse(q, cat, count, tau)
    # the -inf of an all-hit row passes no gradient on; the loss's logaddexp
    # sends it 0, and here the row's gl is zeroed
    finite = torch.isfinite(lse)
    gl = torch.where(finite, gl, 0.0)
    got = torch.autograd.grad(lse, [q, cat], gl, retain_graph=True)
    again = torch.autograd.grad(lse, [q, cat], gl, retain_graph=True)
    lse_plain, *want = plain_lse_in_chunks(kern, q, cat, count, tau, gl, chunk)
    m_safe, s = plain_lse_stats(kern, q, cat, count, tau, chunk)
    sparse = kern.dense_neg_lse_bwd_plain(q.detach(), cat.detach(), count, m_safe, s, gl, tau)
    torch.cuda.synchronize()
    same_inf = bool(torch.equal(finite, torch.isfinite(lse_plain)))
    ok_lse, err_lse = within(lse[finite], lse_plain[finite], RTOL, ATOL)
    same_dq = bool(torch.equal(got[0], again[0]))
    same_dcat = bool(torch.equal(got[1], again[1]))
    log(f"{kern.KERNEL} / {kern.KERNEL_BWD} [{bt}, {d}] x [{x}, {d}], tau {tau}, "
        f"{count.dtype} counts: max_abs_err lse {err_lse:.3e} within rtol {RTOL} atol {ATOL}: "
        f"{ok_lse}; all-hit row 5: lse {float(lse[5].detach())}, -inf rows agree: {same_inf}; "
        f"dq the same bits in a second call: {same_dq} (dcat: {same_dcat})")
    check(same_inf and float(lse[5].detach()) == float("-inf"), "the all-hit row's lse is not -inf")
    check(ok_lse, f"{kern.KERNEL} disagrees with its plain version")
    check(same_dq, f"{kern.KERNEL_BWD}: dq differs between two calls")
    err_bwd = check_lse_bwd(kern.KERNEL_BWD, got, want, sparse, 5)
    nnz = int(count.count_nonzero())
    with torch.no_grad():
        fwd_ms = device_ms(lambda: kern.dense_neg_lse(q, cat, count, tau), 50)
        fwd_plain = device_ms(
            lambda: plain_lse_in_chunks(kern, q, cat, count, tau, gl, chunk, with_grads=False), 5)
    bwd_ms = device_ms(lambda: torch.autograd.grad(lse, [q, cat], gl, retain_graph=True), 30)
    # the backward's own plain version: the sparse form, given (m_safe, s)
    bwd_plain = device_ms(lambda: kern.dense_neg_lse_bwd_plain(
        q.detach(), cat.detach(), count, m_safe, s, gl, tau), 5)
    # only the logits whose count is positive are needed: the operations
    # counted are those of this run's nnz live logits, not of all BT*X
    count_bytes = bt * x * count.element_size()
    fwd_bound = bound(4 * (bt * d + x * d + 3 * bt) + count_bytes, nnz * 2 * d)
    bwd_bound = bound(4 * (2 * bt * d + 2 * x * d + 3 * bt) + count_bytes, nnz * 6 * d)
    log(f"  forward: kernel {fwd_ms:.5f} ms, plain {fwd_plain:.5f} ms, bound "
        f"{fwd_bound[0]:.5f} ms ({fwd_bound[1]}); {nnz} live logits of {bt * x}; the "
        f"dense product is {2e-9 * bt * x * d:.2f} GFLOP, {2e-6 * bt * x * d / fwd_ms:.0f} "
        f"GFLOP/s as run")
    log(f"  backward: kernel {bwd_ms:.5f} ms, sparse plain {bwd_plain:.5f} ms, bound "
        f"{bwd_bound[0]:.5f} ms ({bwd_bound[1]})")
    fwd = dict(max_abs_err=err_lse, ms=fwd_ms, plain_ms=fwd_plain, bound_ms=fwd_bound[0],
               bound_by=fwd_bound[1])
    bwd = dict(max_abs_err=err_bwd, ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bwd_bound[0],
               bound_by=bwd_bound[1])
    return fwd, bwd


def check_fused_lse(kern, count, positive, bt, d, x, tau, chunk) -> tuple[dict, dict]:
    """`fused_dense_neg_lse` (the lse kernels with a `sup_off` pointer)
    against the plain version on the count with each row's positive zeroed;
    then an all -1 sup_off against the null pointer of the training path,
    lse and dq bit for bit (dcat sums in float64 with atomics in no fixed
    order)."""
    rng = np.random.default_rng(19)
    q = torch.tensor(rng.normal(size=(bt, d)), dtype=torch.float32)
    cat = torch.tensor(rng.normal(size=(x, d)), dtype=torch.float32)
    q = (q / q.norm(dim=-1, keepdim=True)).cuda().requires_grad_()
    cat = (cat / cat.norm(dim=-1, keepdim=True)).cuda().requires_grad_()
    gl = torch.tensor(rng.normal(size=(bt,)), dtype=torch.float32).cuda()
    # the count kernel dropped the accidental hits already: put some back,
    # for sup_off to take out
    count = count.clone()
    rows = torch.arange(0, bt, 3, device="cuda")
    hit = positive[rows] >= 0
    count[rows[hit], positive[rows[hit]].long()] += 2
    before = kern.fused_launches
    lse = kern.fused_dense_neg_lse(q, cat, count, positive, tau)
    finite = torch.isfinite(lse)
    gl = torch.where(finite, gl, 0.0)
    got = torch.autograd.grad(lse, [q, cat], gl, retain_graph=True)
    check(kern.fused_launches == before + 1, "fused_dense_neg_lse did not launch its kernel")
    again = torch.autograd.grad(lse, [q, cat], gl, retain_graph=True)
    masked = count.clone()
    live = positive >= 0
    masked[torch.arange(bt, device="cuda")[live], positive[live].long()] = 0
    lse_plain, *want = plain_lse_in_chunks(kern, q, cat, masked, tau, gl, chunk)
    m_safe, s = plain_lse_stats(kern, q, cat, masked, tau, chunk)
    sparse = kern.dense_neg_lse_bwd_plain(q.detach(), cat.detach(), count, m_safe, s, gl, tau,
                                          positive)
    torch.cuda.synchronize()
    ok_lse, err_lse = within(lse[finite], lse_plain[finite], RTOL, ATOL)
    same_inf = bool(torch.equal(finite, torch.isfinite(lse_plain)))
    same_dq = bool(torch.equal(got[0], again[0]))
    log(f"{kern.FUSED} (sup_off) [{bt}, {d}] x [{x}, {d}]: max_abs_err lse {err_lse:.3e} within "
        f"rtol {RTOL} atol {ATOL}: {ok_lse}, -inf rows agree: {same_inf}; dq the same bits in a "
        f"second call: {same_dq}")
    check(ok_lse and same_inf, f"{kern.FUSED} disagrees with its plain version")
    check(same_dq, f"{kern.FUSED} backward: dq differs between two calls")
    all_hit = torch.nonzero(~finite)[:1, 0]
    err_bwd = check_lse_bwd(kern.FUSED + " backward", got, want, sparse, all_hit)
    none = torch.full_like(positive, -1)
    lse_none = kern.fused_dense_neg_lse(q, cat, count, none, tau)
    lse_null = kern.dense_neg_lse(q, cat, count, tau)
    dq_none = torch.autograd.grad(lse_none, [q], gl)[0]
    dq_null = torch.autograd.grad(lse_null, [q], gl)[0]
    same = bool(torch.equal(lse_none, lse_null)) and bool(torch.equal(dq_none, dq_null))
    log(f"  all -1 sup_off equals the null pointer bit for bit (lse, dq): {same}")
    check(same, "an all -1 sup_off differs from the null pointer")
    nnz = int(masked.count_nonzero())
    with torch.no_grad():
        fwd_ms = device_ms(lambda: kern.fused_dense_neg_lse(q, cat, count, positive, tau), 30)
        fwd_plain = device_ms(lambda: plain_lse_in_chunks(
            kern, q, cat, masked, tau, gl, chunk, with_grads=False), 3)
    bwd_ms = device_ms(lambda: torch.autograd.grad(lse, [q, cat], gl, retain_graph=True), 20)
    bwd_plain = device_ms(lambda: kern.dense_neg_lse_bwd_plain(
        q.detach(), cat.detach(), count, m_safe, s, gl, tau, positive), 5)
    fwd_bound = bound(4 * (bt * d + x * d + 4 * bt) + bt * x, nnz * 2 * d)
    bwd_bound = bound(4 * (2 * bt * d + 2 * x * d + 4 * bt) + bt * x, nnz * 6 * d)
    log(f"  forward: kernel {fwd_ms:.5f} ms, plain {fwd_plain:.5f} ms, bound {fwd_bound[0]:.5f} "
        f"ms ({fwd_bound[1]}); backward: kernel {bwd_ms:.5f} ms, sparse plain "
        f"{bwd_plain:.5f} ms, bound {bwd_bound[0]:.5f} ms ({bwd_bound[1]})")
    fwd = dict(max_abs_err=err_lse, ms=fwd_ms, plain_ms=fwd_plain, bound_ms=fwd_bound[0],
               bound_by=fwd_bound[1])
    bwd = dict(max_abs_err=err_bwd, ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bwd_bound[0],
               bound_by=bwd_bound[1])
    return fwd, bwd


def chunk_inputs(seed, b, nq, nc, h, d, max_len):
    """q [b, nq], k, v [b, nc] as strided slices of one projection `proj` (a
    leaf that takes their gradients), as the ring hands a chunk over; the
    query rows' next-item timestamps and the chunk's, ml-20m-era."""
    rng = np.random.default_rng(seed)
    proj = torch.tensor(rng.normal(size=(b, nq + nc, 3 * h * d)), dtype=torch.float32).cuda()
    proj.requires_grad_()
    q, k, v = (t.unflatten(-1, (h, d)) for t in torch.split(proj, [h * d] * 3, dim=-1))
    ts = np.sort(1_100_000_000 + rng.integers(0, 10 * 365 * 86400, size=(b, nq + nc)), axis=1)
    ts = torch.tensor(ts, dtype=torch.int32).cuda()
    a = dict(
        q=q[:, :nq], k=k[:, nq:], v=v[:, nq:], tsq_next=ts[:, :nq], tsk=ts[:, nq:],
        pos_w=torch.tensor(rng.normal(size=(2 * max_len - 1,)) * 0.02,
                           dtype=torch.float32).cuda().requires_grad_(),
        ts_w=torch.tensor(rng.normal(size=(129,)) * 0.02,
                          dtype=torch.float32).cuda().requires_grad_(),
    )
    return a, proj


def chunk_bounds(b, nq, nc, h, d, offd, max_len) -> tuple:
    """(forward, backward) least times of one chunk call: the multiply-adds of
    its live pairs (n - m >= offd) at peak fp32, or the bytes it must move,
    each input read once (q and the query stamps; the k, v rows and stamps
    that a live pair reaches; the table entries) and each output written
    once, whichever is longer."""
    rows = np.arange(nq)
    pairs = int(np.clip(rows - offd + 1, 0, nc).sum())
    keys = int(np.clip(nq - offd, 0, nc))  # chunk rows some live pair reads
    entries = min(nq + keys, 2 * max_len - 1) + 129
    fwd_reads = b * (nq * h * d + nq + keys * (2 * h * d + 1)) + entries
    fwd = bound(4 * (fwd_reads + b * nq * h * d), b * pairs * h * 2 * 2 * d)
    bwd_reads = fwd_reads + b * nq * h * d  # g
    bwd_writes = b * (nq + 2 * nc) * h * d + 2 * max_len - 1 + 129
    bwd = bound(4 * (bwd_reads + bwd_writes), b * pairs * h * 2 * 5 * d)
    return fwd, bwd, pairs


def check_chunk(kern, seed, b, nq, nc, h, d, offd, max_len, timed=False):
    """The chunk kernels against their plain version, forward and (through
    autograd) dq, dk, dv, d_pos_w, d_ts_w, at one offset; with `timed` both
    kernels and the plain version are timed -> (forward, backward) dicts."""
    a, proj = chunk_inputs(seed, b, nq, nc, h, d, max_len)
    kw = dict(off_delta=offd, inv_n=1.0 / max_len, max_len=max_len, num_buckets=128)
    leaves = [proj, a["pos_w"], a["ts_w"]]
    g = torch.tensor(np.random.default_rng(seed + 1).normal(size=(b, nq, h, d)),
                     dtype=torch.float32).cuda()

    def split(grads):
        dq, dk, dv = torch.split(grads[0], [h * d] * 3, dim=-1)
        return dq[:, :nq], dk[:, nq:], dv[:, nq:], grads[1], grads[2]

    out = kern.hstu_chunk_attention(**a, **kw)
    got = split(torch.autograd.grad(out, leaves, g, retain_graph=True))
    out_plain = kern.hstu_chunk_attention_plain(**a, **kw)
    want = split(torch.autograd.grad(out_plain, leaves, g, retain_graph=True))
    torch.cuda.synchronize()
    ok_out, err_out = within(out, out_plain, RTOL, ATOL)
    ok, errs = ok_out, [f"out {err_out:.3e}"]
    for i, name in enumerate(("dq", "dk", "dv", "d_pos_w", "d_ts_w")):
        good, err = within(got[i], want[i], BIAS_RTOL if i >= 3 else RTOL, ATOL)
        ok = ok and good
        errs.append(f"{name} {err:.3e}")
    dead = offd >= nq
    zeros = not (bool(out.any()) or any(bool(t.any()) for t in got)) if dead else True
    # both kernels write their outputs whole (no zero fill): query rows
    # before offd and key rows from nq - offd on meet no live pair and must
    # come out exactly zero (out and dq; dk and dv); no atomics touch out, dq,
    # dk, dv, so a second call gives the same bits
    q_dead, k_reached = min(max(offd, 0), nq), min(max(nq - offd, 0), nc)
    unreached = not (bool(out[:, :q_dead].any()) or bool(got[0][:, :q_dead].any())
                     or bool(got[1][:, k_reached:].any()) or bool(got[2][:, k_reached:].any()))
    again = split(torch.autograd.grad(out, leaves, g, retain_graph=True))
    same = all(torch.equal(x, y) for x, y in zip(got[:3], again[:3]))
    same = same and torch.equal(out, kern.hstu_chunk_attention(**a, **kw))
    shape = f"B={b} Nq={nq} Nc={nc} H={h} d={d} L={max_len} offd={offd}"
    log(f"{kern.KERNEL} / {kern.KERNEL_BWD} {shape}: max_abs_err " + ", ".join(errs)
        + f"; within rtol {RTOL} (tables {BIAS_RTOL}) atol {ATOL}: {ok}"
        + (f"; dead chunk all zeros: {zeros}" if dead else "")
        + f"; {q_dead} query and {nc - k_reached} key rows without a live pair exactly zero: "
        f"{unreached}; out, dq, dk, dv bit-identical in a second call: {same}")
    check(ok and zeros, f"the chunk kernels disagree with their plain version at {shape}")
    check(unreached, f"rows without a live pair are not zero in the chunk kernels at {shape}")
    check(same, f"the chunk kernels' out, dq, dk, dv differ between two calls at {shape}")
    if not timed:
        return None
    # host time to queue a call: the wrapper's checks, ctypes and the launch
    # (the backward through autograd, with its outputs and zeroed tables)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        kern.hstu_chunk_attention(**a, **kw)
    fwd_host_us = 1e6 * (time.perf_counter() - t0) / 50
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        torch.autograd.grad(out, leaves, g, retain_graph=True)
    bwd_host_us = 1e6 * (time.perf_counter() - t0) / 50
    torch.cuda.synchronize()
    log(f"  host time to queue a call: forward {fwd_host_us:.1f} us, backward through autograd "
        f"{bwd_host_us:.1f} us")
    fwd_ms = device_ms(lambda: kern.hstu_chunk_attention(**a, **kw), 200)
    fwd_plain = device_ms(lambda: kern.hstu_chunk_attention_plain(**a, **kw), 30)
    bwd_ms = device_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), 100)
    bwd_plain = device_ms(lambda: torch.autograd.grad(out_plain, leaves, g, retain_graph=True), 20)
    fwd_bound, bwd_bound, pairs = chunk_bounds(b, nq, nc, h, d, offd, max_len)
    log(f"  {pairs} live pairs a row and head; forward: kernel {fwd_ms:.5f} ms, plain "
        f"{fwd_plain:.5f} ms, bound {fwd_bound[0]:.5f} ms ({fwd_bound[1]}); backward: kernel "
        f"{bwd_ms:.5f} ms, plain {bwd_plain:.5f} ms, bound {bwd_bound[0]:.5f} ms ({bwd_bound[1]})")
    fwd = dict(max_abs_err=err_out, ms=fwd_ms, plain_ms=fwd_plain, bound_ms=fwd_bound[0],
               bound_by=fwd_bound[1])
    bwd = dict(max_abs_err=max(float((x - y).detach().abs().max()) for x, y in zip(got, want)),
               ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bwd_bound[0], bound_by=bwd_bound[1])
    return fwd, bwd


# ---------------------------------------------------------------- phase 3


def http(port: int, path: str, payload=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as resp:
        body = json.loads(resp.read())
        check(resp.status == 200, f"{path} answered {resp.status}: {body}")
    return body, time.perf_counter() - t0


def make_requests(catalog: np.ndarray, seed: int):
    """32 ragged histories (1 to 250 items: the longest are truncated to the
    last 200) with ml-1m-era timestamps, and 48 single rows, half timed."""
    rng = np.random.default_rng(seed)
    lens = np.concatenate([[1, 200, 250], rng.integers(2, 200, size=29)])
    rows = [rng.choice(catalog, size=int(n)).tolist() for n in lens]
    stamps = [np.sort(978_000_000 + rng.integers(0, 10**8, size=len(r))).tolist() for r in rows]
    singles = []
    for i in range(48):
        r = rng.choice(catalog, size=int(rng.integers(1, 220))).tolist()
        one = {"sequences": [r], "k": 10}
        if i % 2:
            one["timestamps"] = [np.sort(978_000_000 + rng.integers(0, 10**8, size=len(r))).tolist()]
        singles.append(one)
    return {"sequences": rows, "timestamps": stamps, "k": 50}, singles


def check_answer(req: dict, body: dict, catalog_set: set, max_len: int, k: int) -> None:
    check(len(body["ids"]) == len(req["sequences"]), "one answer row per request row")
    for hist, ids, scores in zip(req["sequences"], body["ids"], body["scores"]):
        check(len(ids) == k and len(scores) == k, f"k={k} not honoured: {len(ids)}")
        check(set(ids) <= catalog_set, "an id outside the catalog")
        check(not set(hist[-max_len:]) & set(ids), "an id from the row's own history")
        s = np.asarray(scores)
        check(bool(np.isfinite(s).all()), "a non-finite score")
        check(bool((np.diff(s) <= 0).all()), "scores not descending")


def run_main_path(kern, num_blocks_expected: int, card: str):
    from mygenerativerecommenders_tpu_torch.cli.serve import build_engine
    from mygenerativerecommenders_tpu_torch.cli.train import parse_args
    from mygenerativerecommenders_tpu_torch.configs import resolve
    from mygenerativerecommenders_tpu_torch.data.catalog import load_catalog
    from mygenerativerecommenders_tpu_torch.models.model import build_model
    from mygenerativerecommenders_tpu_torch.ops.topk import topk_agree
    from mygenerativerecommenders_tpu_torch.serving.service import RecommenderHTTPServer

    args = ["experiment=synthetic-hstu", f"data.data_dir={OUT_DIR / 'data'}"]
    cfg = parse_args(args)
    catalog, max_id = load_catalog(cfg.data)
    resolve(cfg, max_id)
    num_blocks = cfg.model.encoder.num_blocks
    check(num_blocks == num_blocks_expected, f"synthetic-hstu has {num_blocks} blocks")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    ckpt = OUT_DIR / "synthetic-hstu.pt"
    torch.save(build_model(cfg, device="cpu", seed=1234).state_dict(), ckpt)
    argv = args + [f"trainer.ckpt_path={ckpt}"]
    t0 = time.perf_counter()
    engine, _ = build_engine(argv)  # default device: cuda
    log(f"engine on {engine.device}: synthetic-hstu D={cfg.model.item_embedding_dim} "
        f"blocks={num_blocks} H={cfg.model.encoder.num_heads} "
        f"N={cfg.data.max_sequence_length + cfg.model.gr_output_length + 1} "
        f"catalog={len(catalog)} (max id {max_id}) k={cfg.model.index.k} "
        f"batch={engine.batch_size}, built in {time.perf_counter() - t0:.2f} s")
    check(engine.device.type == "cuda", "the engine is not on the card")
    big, singles = make_requests(catalog, seed=7)
    catalog_set = set(catalog.tolist())
    server = RecommenderHTTPServer(engine, "127.0.0.1", 0).start()
    try:
        http(server.port, "/v1/retrieve", big)  # warm-up, before the counts
        kern.launches, engine.calls = 0, 0
        health, _ = http(server.port, "/healthz")
        check(health["status"] == "ok" and health["catalog_size"] == len(catalog), str(health))
        body_big, _ = http(server.port, "/v1/retrieve", big)
        check_answer(big, body_big, catalog_set, engine.max_len, 50)
        answers = [None] * len(singles)
        lat_single = [0.0] * len(singles)

        def one(i):
            answers[i], lat_single[i] = http(server.port, "/v1/retrieve", singles[i])

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(singles))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            check(not t.is_alive(), "a single-row request hung")
        for req, body in zip(singles, answers):
            check(body is not None, "a single-row request failed")
            check_answer(req, body, catalog_set, engine.max_len, 10)
        burst_calls = engine.calls - 1
        http_s, direct_s = timed_rounds(server.port, engine, big)
        launches, calls = kern.launches, engine.calls
    finally:
        server.stop()
    log(f"main path: {calls} engine calls ({burst_calls} for {len(singles)} coalesced "
        f"single rows), {launches} attention launches")
    check(launches > 0, "the attention kernel was not launched on the main path")
    check(launches == num_blocks * calls,
          f"launches {launches} != {num_blocks} blocks x {calls} engine calls")

    cpu_engine, _ = build_engine(argv + ["serve.device=cpu"])
    want_big = cpu_engine.retrieve(big["sequences"], big["timestamps"], k=50)
    problem = topk_agree(body_big["ids"], body_big["scores"], *want_big, atol=E2E_ATOL)
    check(problem is None, f"card vs CPU engine, 32-row request: {problem}")
    for req, body in zip(singles, answers):
        want = cpu_engine.retrieve(req["sequences"], req.get("timestamps"), k=10)
        problem = topk_agree(body["ids"], body["scores"], *want, atol=E2E_ATOL)
        check(problem is None, f"card vs CPU engine, single row: {problem}")
    err = max(
        float(np.abs(np.asarray(body_big["scores"]) - np.asarray(want_big[1])).max()), 0.0
    )
    log(f"card and CPU engines agree: max score diff {err:.3e} on the 32-row request "
        f"(atol {E2E_ATOL}), ids equal up to near-ties, {len(singles)} single rows too")

    p = np.percentile
    http_ms, direct_ms = 1e3 * http_s, 1e3 * direct_s
    lat_single_ms = 1e3 * np.asarray(lat_single)
    round_http, round_direct = np.median(http_ms, axis=1), np.median(direct_ms, axis=1)
    gap = round_http - round_direct
    log(f"32-row /v1/retrieve over HTTP, {http_ms.size} back to back in {len(http_ms)} rounds: "
        f"p50 {p(http_ms, 50):.3f} ms, p99 {p(http_ms, 99):.3f} ms, "
        f"{32e3 * http_ms.size / http_ms.sum():.1f} rows/s; round p50s "
        f"{round_http.min():.3f}-{round_http.max():.3f} ms on {card}")
    log(f"the same 32-row call on the engine directly, alternated with those rounds: "
        f"p50 {p(direct_ms, 50):.3f} ms, p99 {p(direct_ms, 99):.3f} ms; round p50s "
        f"{round_direct.min():.3f}-{round_direct.max():.3f} ms; HTTP + JSON per round "
        f"(HTTP p50 - engine p50): median {np.median(gap):.3f} ms, "
        f"range {gap.min():.3f}-{gap.max():.3f} ms on {card}")
    log(f"{len(singles)} concurrent single-row requests: p50 {p(lat_single_ms, 50):.3f} ms, "
        f"p99 {p(lat_single_ms, 99):.3f} ms on {card}")
    profile_device(
        lambda _: engine.retrieve(big["sequences"], big["timestamps"], k=big["k"]),
        reps=20, what="engine call, 32 rows, no HTTP, p50", wall_ms=float(p(direct_ms, 50)), top=6,
    )
    return launches


def timed_rounds(port: int, engine, req: dict, rounds: int = 3, reps: int = 10):
    """Host-clock seconds of the 32-row request over HTTP and of the same
    call made on the engine directly, alternated round by round so that both
    see the same host noise. -> two [rounds, reps] arrays."""
    over_http, direct = [], []
    for _ in range(rounds):
        over_http.append([http(port, "/v1/retrieve", req)[1] for _ in range(reps)])
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            engine.retrieve(req["sequences"], req["timestamps"], k=req["k"])
            times.append(time.perf_counter() - t0)
        direct.append(times)
    return np.asarray(over_http), np.asarray(direct)


def profile_device(fn, reps: int, what: str, wall_ms: float, top: int, by_count: int = 0) -> float:
    """Where the time of `fn` goes: torch.profiler's device time of the kernels
    one call launches, against its host wall time `wall_ms` (measured without
    the profiler); with `by_count`, also the kernels launched most often.
    -> the device launches of one call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    # device-side events only (an aten op's row repeats its kernels' time),
    # without annotation ranges such as the optimizer's, which do the same
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    ]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    launches = sum(e.count for e in kernels) / reps
    log(f"{what}: wall {wall_ms:.3f} ms; device kernels {device_ms:.3f} ms in "
        f"{launches:.0f} launches per call; device idle "
        f"{100 * max(0.0, 1 - device_ms / wall_ms):.1f}% of the wall time")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3 / reps:.4f} ms/call x{e.count / reps:.1f} "
            f"{e.key[:90]}")
    if by_count:
        log("  most launched: " + "; ".join(
            f"x{e.count / reps:.0f} {e.self_device_time_total / 1e3 / reps:.3f} ms {e.key[:60]}"
            for e in sorted(kernels, key=lambda e: -e.count)[:by_count]))
    return launches


# ---------------------------------------------------------------- phase 4


class Counts:
    """The launch counters of every kernel wrapper on the training paths, in
    the order attention forward and backward, count, lse forward and
    backward, chunk forward and backward."""

    def __init__(self, attn, count_kern, lse_kern, chunk):
        self.attn, self.count, self.lse, self.chunk = attn, count_kern, lse_kern, chunk

    def read(self) -> dict:
        a, c, l, k = self.attn, self.count, self.lse, self.chunk
        return {
            a.KERNEL: a.launches, a.KERNEL_BWD: a.bwd_launches, c.KERNEL: c.launches,
            l.KERNEL: l.launches, l.KERNEL_BWD: l.bwd_launches,
            k.KERNEL: k.launches, k.KERNEL_BWD: k.bwd_launches,
        }

    def reset(self) -> None:
        self.attn.launches = self.attn.bwd_launches = 0
        self.count.launches = 0
        self.lse.launches = self.lse.bwd_launches = 0
        self.chunk.launches = self.chunk.bwd_launches = 0

    def per_step(self, attn: int, chunk: int) -> list:
        """One optimizer step's launches: `attn` attention and `chunk` chunk
        forwards and as many backwards, one count, one lse pair."""
        return [attn, attn, 1, 1, 1, chunk, chunk]


def read_training_run(metrics: Path, epochs: int, monitored: float):
    """The losses, val rows and test row a `cli.train` run logged, checked:
    finite and falling losses, a val row per epoch and one test row, every
    metric and the monitored one in [0, 1]."""
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    losses = np.asarray([r["train/loss"] for r in rows if "train/loss" in r])
    val = [r for r in rows if "val/ndcg@100" in r]
    test = [r for r in rows if "test/ndcg@100" in r]
    log(f"  loss: first {losses[0]:.4f} (log 129 = {np.log(129):.4f}), first five mean "
        f"{losses[:5].mean():.4f}, last five mean {losses[-5:].mean():.4f}")
    check(bool(np.isfinite(losses).all()), "a non-finite training loss")
    check(losses[-5:].mean() < losses[:5].mean(), "the loss did not fall")
    check(len(val) == epochs and len(test) == 1, "val/ or test/ metric rows are missing")
    for r in val + test:
        for key, value in r.items():
            if "/" in key and not key.startswith("train/"):
                check(0.0 <= value <= 1.0, f"{key}={value} outside [0, 1]")
    check(0.0 <= monitored <= 1.0, f"the monitored metric {monitored} is outside [0, 1]")
    return losses, val, test[0]


def check_step_launches(kc: Counts, steps: int, eval_batches: int, counts: dict,
                        attn: int = 0, chunk: int = 0) -> None:
    """Per optimizer step `attn` attention forwards and backwards (one per
    block) or `chunk` chunk forwards and backwards (the ring's, per block
    times chunk calls), one count, one lse forward and backward; per eval
    batch the forwards alone."""
    per = kc.per_step(attn, chunk)
    want = dict(zip(kc.read(), (
        per[0] * (steps + eval_batches), per[1] * steps, steps, steps, steps,
        per[5] * (steps + eval_batches), per[6] * steps,
    )))
    check(counts == want, f"launches {counts} != expected {want}")


def run_training_path(kc: Counts, card: str) -> dict:
    """`cli.train.main` on the card at the full width of synthetic-hstu, then a
    second trainer stepped by hand for times. -> launch counts of the first."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    epochs = 30
    out_dir = OUT_DIR / "train"
    args = [
        "experiment=synthetic-hstu", f"trainer.output_dir={out_dir}",
        f"trainer.max_epochs={epochs}", "trainer.log_every_n_steps=1",
    ]
    metrics = out_dir / "synthetic-hstu" / "metrics.jsonl"
    metrics.unlink(missing_ok=True)
    cfg = cli_train.parse_args(args)
    check(cfg.trainer.device == "cuda", "cli.train does not default to the card")
    kc.reset()
    t0 = time.perf_counter()
    monitored = cli_train.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kc.read()

    blocks = cfg.model.encoder.num_blocks
    per_epoch = -(-cfg.data.synthetic_num_users // cfg.data.batch_size)
    eval_batches = (epochs + 1) * per_epoch  # validation each epoch, then the test pass
    log(f"training path: cli.train on {card}, synthetic-hstu D={cfg.model.item_embedding_dim} "
        f"blocks={blocks} N={cfg.data.max_sequence_length + cfg.model.gr_output_length + 1} "
        f"batch={cfg.data.batch_size} R={cfg.model.loss.num_to_sample} "
        f"dropout={cfg.model.encoder.linear_dropout_rate}: {epochs * per_epoch} optimizer steps, "
        f"{eval_batches} eval batches in {wall:.2f} s; launches {counts}")
    losses, val, test = read_training_run(metrics, epochs, monitored)
    steps = len(losses)
    check(steps == epochs * per_epoch, f"{steps} optimizer steps, expected {epochs * per_epoch}")
    best = max(val, key=lambda r: r["val/ndcg@100"])
    log(f"  val/ndcg@100 first epoch {val[0]['val/ndcg@100']:.5f}, best {best['val/ndcg@100']:.5f} "
        f"(epoch {best['epoch']}), last {val[-1]['val/ndcg@100']:.5f}; test on the best "
        f"checkpoint: ndcg@10 {test['test/ndcg@10']:.5f}, ndcg@100 "
        f"{test['test/ndcg@100']:.5f}, hr@200 {test['test/hr@200']:.5f} (the JAX "
        f"package's 30-epoch band on this data: ndcg@10 0.037-0.039, PARITY.md)")
    check(test["test/ndcg@10"] >= MIN_TEST_NDCG10,
          f"test ndcg@10 {test['test/ndcg@10']} below {MIN_TEST_NDCG10} after {epochs} epochs")
    check_step_launches(kc, steps, eval_batches, counts, attn=blocks)
    for name in ("best.pt", "last.pt"):
        check((out_dir / "synthetic-hstu" / "checkpoints" / name).exists(), f"no {name}")

    # a second trainer, stepped by hand: step time, per-step counts, profile
    trainer = Trainer(cli_train.parse_args(args[:1] + [f"trainer.output_dir={OUT_DIR / 'train2'}"]))
    trainer.model.train()
    batches = [trainer._put(b) for b in trainer.data.loader("train")]
    for batch in batches[:3]:
        trainer.train_step(batch, trainer.lr1)
    torch.cuda.synchronize()
    times = []
    for i in range(40):
        before = kc.read()
        t0 = time.perf_counter()
        trainer.train_step(batches[i % len(batches)], trainer.lr1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        after = kc.read()
        delta = [after[k] - before[k] for k in after]
        check(delta == kc.per_step(blocks, 0), f"launches of one step: {delta}")
    step_ms = 1e3 * np.asarray(times)
    p50 = float(np.percentile(step_ms, 50))
    log(f"train step, batch {cfg.data.batch_size} ({TRAIN_BT} supervision rows), synced each "
        f"step: p50 {p50:.3f} ms, p99 {np.percentile(step_ms, 99):.3f} ms, "
        f"{1e3 * cfg.data.batch_size / p50:.1f} examples/s on {card}; launches per step "
        f"{blocks} attention fwd, {blocks} attention bwd, 1 count, 1 lse fwd, 1 lse bwd")
    t0 = time.perf_counter()
    for i in range(40):
        trainer.train_step(batches[i % len(batches)], trainer.lr1)
    torch.cuda.synchronize()
    free_ms = 1e3 * (time.perf_counter() - t0) / 40
    log(f"  40 steps back to back, one sync at the end: {free_ms:.3f} ms per step, "
        f"{1e3 * cfg.data.batch_size / free_ms:.1f} examples/s on {card}")
    profile_device(
        lambda i: trainer.train_step(batches[i % len(batches)], trainer.lr1),
        reps=8, what="train step", wall_ms=free_ms, top=10,
    )
    return counts


# ---------------------------------------------------------------- phase 6

LONG_ARGS = [
    "experiment=ml-20m-hstu-long", "data.dataset_name=synthetic",
    "data.synthetic_max_seq_len=1024",
]


def run_long_path(kc: Counts, card: str) -> dict:
    """`cli.train.main` on the card at the full width of ml-20m-hstu-long on
    synthetic data: packed train batches, packed eval after each epoch, the
    test pass. Then a second trainer stepped by hand, class of capacity by
    class. -> launch counts of the first."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    epochs = 2
    out_dir = OUT_DIR / "long"
    args = LONG_ARGS + [
        f"trainer.output_dir={out_dir}", f"trainer.max_epochs={epochs}",
        "trainer.log_every_n_steps=1",
    ]
    name = "ml-20m-hstu-long"
    metrics = out_dir / name / "metrics.jsonl"
    metrics.unlink(missing_ok=True)
    cfg = cli_train.parse_args(args)
    check(cfg.trainer.device == "cuda" and cfg.data.pack_sequences, "not the packed card path")
    kc.reset()
    t0 = time.perf_counter()
    monitored = cli_train.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kc.read()

    # the batches that run must have held, from loaders of the same plan
    planner = Trainer(cli_train.parse_args(LONG_ARGS + [f"trainer.output_dir={OUT_DIR / 'long2'}"]))
    check(planner._packed and planner._eval_packed, "packing or packed eval is off")
    train_loader = planner._loader("train", packed=True)
    want_steps = sum(len(train_loader._plan(e)) for e in range(epochs))
    eval_batches = (epochs + 1) * len(planner._loader("val", packed=True))
    blocks = cfg.model.encoder.num_blocks
    log(f"long path: cli.train on {card}, {name} on synthetic data, packed: "
        f"D={cfg.model.item_embedding_dim} blocks={blocks} H={cfg.model.encoder.num_heads} "
        f"L={cfg.data.max_sequence_length + cfg.model.gr_output_length + 1} "
        f"batch={cfg.data.batch_size} examples, capacities {list(cfg.data.pack_capacities)}, "
        f"catalog={len(planner.all_item_ids)} (max id {planner.data.max_item_id}), "
        f"R={cfg.model.loss.num_to_sample}, dropout={cfg.model.encoder.linear_dropout_rate}: "
        f"{want_steps} optimizer steps, {eval_batches} packed eval batches in {wall:.2f} s; "
        f"launches {counts}")
    losses, val, test = read_training_run(metrics, epochs, monitored)
    steps = len(losses)
    check(steps == want_steps, f"{steps} optimizer steps, expected {want_steps}")
    log(f"  val/ndcg@100 by epoch {[round(r['val/ndcg@100'], 5) for r in val]}, test on the best "
        f"checkpoint: ndcg@10 {test['test/ndcg@10']:.5f}, ndcg@100 "
        f"{test['test/ndcg@100']:.5f}, hr@200 {test['test/hr@200']:.5f} (chance hr@200: "
        f"{200 / len(planner.all_item_ids):.5f})")
    check_step_launches(kc, steps, eval_batches, counts, attn=blocks)
    for ckpt in ("best.pt", "last.pt"):
        check((out_dir / name / "checkpoints" / ckpt).exists(), f"no {ckpt}")
    del planner

    # a second trainer, stepped by hand, class by class. Histories of up to
    # 1,200 items (cut to the newest 1,024) give the widest class, 1,152, its
    # segments of 1,025; the command line above leaves that class empty
    trainer = Trainer(cli_train.parse_args(
        LONG_ARGS[:2] + ["data.synthetic_max_seq_len=1200",
                         f"trainer.output_dir={OUT_DIR / 'long3'}"]))
    trainer.model.train()
    by_cap = {}
    for batch in trainer._loader("train", packed=True):
        by_cap.setdefault(batch["ids"].shape[1], []).append(batch)
    check(sorted(by_cap) == sorted(cfg.data.pack_capacities), f"classes {sorted(by_cap)}")
    epoch_s, epoch_examples = 0.0, 0
    for cap in sorted(by_cap):
        host = by_cap[cap]
        batches = [trainer._put(b) for b in host[:4]]
        for batch in batches[:2]:
            trainer.train_step(batch, trainer.lr1)
        torch.cuda.synchronize()
        times = []
        for i in range(8):
            before = kc.read()
            t0 = time.perf_counter()
            trainer.train_step(batches[i % len(batches)], trainer.lr1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            after = kc.read()
            delta = [after[k] - before[k] for k in after]
            check(delta == kc.per_step(blocks, 0), f"launches of one step: {delta}")
        p50 = 1e3 * float(np.percentile(times, 50))
        examples = float(np.mean([b["num_segments"].sum() for b in host[:4]]))
        tokens = float(np.mean([b["lengths"].sum() for b in host[:4]]))
        rows_cap = host[0]["ids"].shape[0]
        log(f"train step, class {cap}: {rows_cap} rows x {cap} ({rows_cap * (cap - 1)} supervision "
            f"rows), {examples:.1f} examples and {tokens:.0f} tokens a step, synced each step: "
            f"p50 {p50:.3f} ms, {1e3 * examples / p50:.1f} examples/s, "
            f"{1e3 * tokens / p50:.0f} tokens/s on {card}; {len(host)} such steps an epoch")
        profile_device(
            lambda i: trainer.train_step(batches[i % len(batches)], trainer.lr1),
            reps=4, what=f"train step, class {cap}", wall_ms=p50, top=6,
        )
        epoch_s += 1e-3 * p50 * len(host)
        epoch_examples += sum(int(b["num_segments"].sum()) for b in host)
    log(f"an epoch of these steps ({epoch_examples} examples, from the class p50s): "
        f"{epoch_s:.2f} s, {epoch_examples / epoch_s:.1f} examples/s on {card}")
    return counts


# ---------------------------------------------------------------- phases 5 and 7


def card_against_cpu_step(args, packed_capacity=None) -> None:
    """One loss and its gradients through the port on the card (kernels) and
    on the CPU (plain versions): same weights, batch and negatives, dropout
    off. With `packed_capacity` the batch is the first packed train batch of
    that class of capacity."""
    from mygenerativerecommenders_tpu_torch.cli.train import parse_args
    from mygenerativerecommenders_tpu_torch.configs import resolve
    from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
    from mygenerativerecommenders_tpu_torch.data.packing import PackedBatchLoader
    from mygenerativerecommenders_tpu_torch.models.model import build_model
    from mygenerativerecommenders_tpu_torch.train.task_retrieval import make_loss_fn

    cfg = parse_args(args)
    data = RecoData(cfg.data, seed=cfg.trainer.seed)
    resolve(cfg, data.max_item_id)
    if packed_capacity:
        loader = PackedBatchLoader(
            data.dataset("train"), rows_per_batch=1, row_capacity=max(cfg.data.pack_capacities),
            capacities=cfg.data.pack_capacities, segments_per_batch=cfg.data.batch_size,
        )
        batch = next(b for b in loader if b["ids"].shape[1] == packed_capacity)
    else:
        batch = next(iter(data.loader("train")))
    rows = batch["ids"].shape[0]
    n = batch["ids"].shape[1] + (0 if packed_capacity else cfg.model.gr_output_length + 1)
    gen = torch.Generator().manual_seed(3)
    offsets = torch.randint(
        0, len(data.all_item_ids), (rows, n - 1, cfg.model.loss.num_to_sample),
        generator=gen, dtype=torch.int32,
    )
    results = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg, device=device, seed=99)  # eval mode: dropout off
        loss_fn = make_loss_fn(model, cfg, data.all_item_ids, packed=bool(packed_capacity))
        dev_batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        loss = loss_fn(dev_batch, neg_offsets=offsets.to(device))
        loss.backward()
        results[device] = (
            loss.item(), {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
        )
    (loss_card, grads_card), (loss_cpu, grads_cpu) = results["cuda"], results["cpu"]
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    what = f"{cfg.experiment}, " + (
        f"a packed batch of {rows} rows x {packed_capacity}" if packed_capacity
        else f"a batch of {rows} rows")
    log(f"one step of {what}, card (kernels) vs CPU (plain versions): loss {loss_card:.6f} vs "
        f"{loss_cpu:.6f}, relative difference {rel:.3e} (rtol {STEP_LOSS_RTOL})")
    check(rel <= STEP_LOSS_RTOL, "the card's loss disagrees with the CPU's")
    worst = True
    for name, want in grads_cpu.items():
        ok, err = within(grads_card[name], want, STEP_GRAD_RTOL, STEP_GRAD_ATOL)
        log(f"  grad {name}: max_abs_err {err:.3e}, max |grad| {float(want.abs().max()):.3e}, "
            f"within rtol {STEP_GRAD_RTOL} atol {STEP_GRAD_ATOL}: {ok}")
        worst = worst and ok
    check(worst, "a parameter's gradient on the card disagrees with the CPU's")


# ---------------------------------------------------------------- phases 8 and 9

RING_ARGS = LONG_ARGS + [
    "data.pack_sequences=false", "model.encoder.sp_shards=4", "model.encoder.sp_zigzag=true",
]
RING_USERS = 1024  # the run's depth cut: users (ml-20m-hstu-long's default is 2,048)


def ring_chunk_calls(shards: int, zigzag: bool) -> int:
    """Chunk calls of one ring attention over P shards: zigzag 2 per step and
    shard (back x front, and the one of front x front or back x back that is
    live, both at the diagonal) = P*P + P*(P+1); contiguous the chunks at or
    before the diagonal, P*(P+1)/2."""
    return shards * shards + shards * (shards + 1) if zigzag else shards * (shards + 1) // 2


def run_ring_path(kc: Counts, card: str) -> dict:
    """`cli.train.main` on the card at the full width of ml-20m-hstu-long on
    synthetic data with padded rows and the zigzag ring at sp_shards=4, then
    hand-stepped trainers in both layouts for times. -> launch counts of the
    first."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    epochs = 2
    out_dir = OUT_DIR / "ring"
    args = RING_ARGS + [
        f"data.synthetic_num_users={RING_USERS}", f"trainer.output_dir={out_dir}",
        f"trainer.max_epochs={epochs}", "trainer.log_every_n_steps=1",
    ]
    name = "ml-20m-hstu-long"
    metrics = out_dir / name / "metrics.jsonl"
    metrics.unlink(missing_ok=True)
    cfg = cli_train.parse_args(args)
    enc = cfg.model.encoder
    check(cfg.trainer.device == "cuda" and not cfg.data.pack_sequences and enc.sp_shards == 4
          and enc.sp_zigzag, "not the ring card path")
    kc.reset()
    t0 = time.perf_counter()
    monitored = cli_train.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kc.read()

    per_epoch = -(-RING_USERS // cfg.data.batch_size)
    eval_batches = (epochs + 1) * per_epoch  # validation each epoch, then the test pass
    blocks = enc.num_blocks
    calls = blocks * ring_chunk_calls(enc.sp_shards, True)
    n = cfg.data.max_sequence_length + cfg.model.gr_output_length + 1
    log(f"ring path: cli.train on {card}, {name} on synthetic data, padded rows, zigzag ring "
        f"sp_shards={enc.sp_shards} on one device: D={cfg.model.item_embedding_dim} "
        f"blocks={blocks} H={enc.num_heads} N=L={n} (padded to {-(-n // 8) * 8}, chunks of "
        f"{-(-n // 8)} rows) batch={cfg.data.batch_size} ({cfg.data.batch_size * (n - 1)} "
        f"supervision rows) R={cfg.model.loss.num_to_sample} dropout={enc.linear_dropout_rate}, "
        f"{RING_USERS} users: {epochs * per_epoch} optimizer steps, {eval_batches} eval batches "
        f"in {wall:.2f} s; launches {counts}")
    losses, val, test = read_training_run(metrics, epochs, monitored)
    check(len(losses) == epochs * per_epoch, f"{len(losses)} optimizer steps")
    log(f"  val/ndcg@100 by epoch {[round(r['val/ndcg@100'], 5) for r in val]}, test on the best "
        f"checkpoint: ndcg@10 {test['test/ndcg@10']:.5f}, ndcg@100 "
        f"{test['test/ndcg@100']:.5f}, hr@200 {test['test/hr@200']:.5f}")
    check_step_launches(kc, len(losses), eval_batches, counts, chunk=calls)
    for ckpt in ("best.pt", "last.pt"):
        check((out_dir / name / "checkpoints" / ckpt).exists(), f"no {ckpt}")

    # hand-stepped trainers, zigzag then contiguous: step time, launches, profile
    for zigzag in (True, False):
        trainer = Trainer(cli_train.parse_args(RING_ARGS + [
            f"data.synthetic_num_users={RING_USERS}", f"model.encoder.sp_zigzag={zigzag}",
            f"trainer.output_dir={OUT_DIR / 'ring2'}"]))
        trainer.model.train()
        batches = [trainer._put(b) for _, b in zip(range(4), trainer.data.loader("train"))]
        for batch in batches[:2]:
            trainer.train_step(batch, trainer.lr1)
        torch.cuda.synchronize()
        times = []
        step_calls = blocks * ring_chunk_calls(enc.sp_shards, zigzag)
        for i in range(8):
            before = kc.read()
            t0 = time.perf_counter()
            trainer.train_step(batches[i % len(batches)], trainer.lr1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            after = kc.read()
            delta = [after[k] - before[k] for k in after]
            check(delta == kc.per_step(0, step_calls), f"launches of one ring step: {delta}")
        step_ms = 1e3 * np.asarray(times)
        p50 = float(np.percentile(step_ms, 50))
        layout = "zigzag" if zigzag else "contiguous"
        log(f"ring train step, {layout}, batch {cfg.data.batch_size}, synced each step: p50 "
            f"{p50:.3f} ms (range {step_ms.min():.3f}-{step_ms.max():.3f}), "
            f"{1e3 * cfg.data.batch_size / p50:.1f} examples/s on {card}; launches per step "
            f"{step_calls} chunk fwd, {step_calls} chunk bwd, 1 count, 1 lse fwd, 1 lse bwd")
        launches = profile_device(
            lambda i: trainer.train_step(batches[i % len(batches)], trainer.lr1),
            reps=4, what=f"ring train step, {layout}", wall_ms=p50, top=8, by_count=8,
        )
        # the chunk backward zero-fills nothing: a step launches 2 x step_calls
        # fewer kernels than with the atomic design's zeroed dk and dv; the lse
        # backward's call launches two (the walk and dcat's rounding)
        expected = 4923 if zigzag else 1355
        log(f"  profiled launches a {layout} step: {launches:.0f}, expected {expected} (the "
            f"zero-filling design's {expected + 2 * step_calls} less {2 * step_calls} fills)")
        if zigzag:
            ring_eval_read(trainer, kc, step_calls, cfg.data.batch_size, card)
        del trainer, batches
        torch.cuda.empty_cache()
    return counts


def ring_eval_read(trainer, kc: Counts, calls: int, batch_size: int, card: str) -> None:
    """The ring's eval batches, forward only (the chunk forward is the one
    attention kernel that runs there): p50 of 8 synced batches of the
    validation split, their launches, and a torch.profiler batch."""
    trainer.model.eval()
    candidates = trainer.candidate_fn()
    batches = [trainer._put(b) for _, b in zip(range(4), trainer.data.loader("val"))]
    with torch.no_grad():
        for batch in batches[:2]:
            trainer.eval_step(batch, candidates)
        torch.cuda.synchronize()
        times = []
        for i in range(8):
            before = kc.read()
            t0 = time.perf_counter()
            trainer.eval_step(batches[i % len(batches)], candidates)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            after = kc.read()
            delta = [after[k] - before[k] for k in after]
            check(delta == [0, 0, 0, 0, 0, calls, 0], f"launches of one ring eval batch: {delta}")
        step_ms = 1e3 * np.asarray(times)
        p50 = float(np.percentile(step_ms, 50))
        log(f"ring eval batch, zigzag, batch {batch_size}, synced each batch: p50 {p50:.3f} ms "
            f"(range {step_ms.min():.3f}-{step_ms.max():.3f}), {1e3 * batch_size / p50:.1f} "
            f"examples/s on {card}; launches per batch {calls} chunk fwd, nothing else counted")
        profile_device(lambda i: trainer.eval_step(batches[i % len(batches)], candidates),
                       reps=4, what="ring eval batch, zigzag", wall_ms=p50, top=6)
    trainer.model.train()


def ring_against_unsharded() -> None:
    """One loss and its gradients on the card through the ring model, zigzag
    and contiguous, against the same weights at sp_shards=1 (the fused
    attention kernels): the first full-width padded batch of
    ml-20m-hstu-long, the same negatives, dropout off."""
    from mygenerativerecommenders_tpu_torch.cli.train import parse_args
    from mygenerativerecommenders_tpu_torch.configs import resolve
    from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
    from mygenerativerecommenders_tpu_torch.models.model import build_model
    from mygenerativerecommenders_tpu_torch.train.task_retrieval import make_loss_fn

    base = LONG_ARGS + ["data.pack_sequences=false", f"data.synthetic_num_users={RING_USERS}"]
    cfg = parse_args(base)
    data = RecoData(cfg.data, seed=cfg.trainer.seed)
    resolve(cfg, data.max_item_id)
    batch = next(iter(data.loader("train")))
    rows, n = batch["ids"].shape[0], batch["ids"].shape[1] + cfg.model.gr_output_length + 1
    offsets = torch.randint(
        0, len(data.all_item_ids), (rows, n - 1, cfg.model.loss.num_to_sample),
        generator=torch.Generator().manual_seed(3), dtype=torch.int32,
    ).cuda()
    dev_batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    results = {}
    for layout, extra in (("sp_shards=1", []),
                          ("zigzag", ["model.encoder.sp_shards=4", "model.encoder.sp_zigzag=true"]),
                          ("contiguous", ["model.encoder.sp_shards=4"])):
        lcfg = parse_args(base + extra)
        resolve(lcfg, data.max_item_id)
        model = build_model(lcfg, device="cuda", seed=99)  # eval mode: dropout off
        loss = make_loss_fn(model, lcfg, data.all_item_ids)(dev_batch, neg_offsets=offsets)
        loss.backward()
        results[layout] = (loss.item(), {k: p.grad.detach().clone()
                                         for k, p in model.named_parameters()})
        del model, loss
        torch.cuda.empty_cache()
    loss_ref, grads_ref = results.pop("sp_shards=1")
    for layout, (loss, grads) in results.items():
        rel = abs(loss - loss_ref) / abs(loss_ref)
        log(f"ring ({layout}, sp_shards=4) vs sp_shards=1 on the card, {cfg.experiment} at full "
            f"width, a padded batch of {rows} rows x {n}: loss {loss:.6f} vs {loss_ref:.6f}, "
            f"relative difference {rel:.3e} (rtol {STEP_LOSS_RTOL})")
        check(rel <= STEP_LOSS_RTOL, f"the {layout} ring's loss disagrees with sp_shards=1")
        worst, worst_name, ok_all = 0.0, "", True
        for name, want in grads_ref.items():
            ok, err = within(grads[name], want, STEP_GRAD_RTOL, STEP_GRAD_ATOL)
            ok_all = ok_all and ok
            if err >= worst:
                worst, worst_name = err, name
            if not ok:
                log(f"  grad {name}: max_abs_err {err:.3e}, max |grad| "
                    f"{float(want.abs().max()):.3e}: outside rtol {STEP_GRAD_RTOL} atol "
                    f"{STEP_GRAD_ATOL}")
        log(f"  all {len(grads_ref)} gradients within rtol {STEP_GRAD_RTOL} atol {STEP_GRAD_ATOL}: "
            f"{ok_all}; largest difference {worst:.3e} in {worst_name} (max |grad| "
            f"{float(grads_ref[worst_name].abs().max()):.3e})")
        check(ok_all, f"a gradient of the {layout} ring disagrees with sp_shards=1")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import mygenerativerecommenders_tpu_torch as port
    from mygenerativerecommenders_tpu_torch.ops.kernels import _build
    from mygenerativerecommenders_tpu_torch.ops.kernels import count_offsets as count_kern
    from mygenerativerecommenders_tpu_torch.ops.kernels import dense_neg_lse as lse_kern
    from mygenerativerecommenders_tpu_torch.ops.kernels import hstu_attention as kern
    from mygenerativerecommenders_tpu_torch.ops.kernels import hstu_chunk as chunk_kern

    check(Path(port.__file__).resolve().parent.parent == HERE,
          f"the port was imported from {port.__file__}, not from this checkout")
    card = card_line()
    log(card)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {count} x {kind}")

    build_kernels(_build, [kern.KERNEL, kern.KERNEL_BWD, count_kern.KERNEL, lse_kern.LIBRARY,
                           chunk_kern.KERNEL, chunk_kern.KERNEL_BWD])

    ragged = np.random.default_rng(2).integers(2, 211, size=126).tolist()
    serving = check_attention(kern, kern.KERNEL, 1, 32, 211, 1, 50, [1, 211] + ragged[:30])
    check_attention(kern, kern.KERNEL, 3, 4, 1035, 2, 64, [1, 1035, 517, 900])
    attn_bwd = check_attention_bwd(kern, 5, 128, 211, 1, 50, [1, 211] + ragged)
    check_attention_bwd(kern, 7, 4, 1035, 2, 64, [1, 1035, 517, 900])
    # packed rows: a row of ml-1m-hstu-packed, and the widest row of
    # ml-20m-hstu-long, which is wider than the bias table reaches (1152 > 1035)
    for seed, (b, n, max_len, h, d) in enumerate([(56, 256, 211, 1, 50), (4, 1152, 1035, 2, 64)]):
        pos, lens, seg_bounds = packed_layout(20 + seed, b, n, max_len)
        check_attention(kern, kern.KERNEL, 30 + seed, b, n, h, d, lens, max_len, pos)
        check_attention_bwd(kern, 40 + seed, b, n, h, d, lens, max_len, pos, seg_bounds)
    # the backward's 32-row tiles at a ragged edge: N = 1121 = 35 x 32 + 1, and
    # rows of packed length 1 and 20 (positions 0 past the length)
    pos, lens, seg_bounds = packed_layout(22, 4, 1121, 1035)
    pos[2], lens[2] = 0, 1
    pos[3, 20:], lens[3] = 0, 20
    check_attention_bwd(kern, 42, 4, 1121, 2, 64, lens, 1035, pos, seg_bounds)
    counted = check_count(count_kern, TRAIN_BT, TRAIN_R, 3706)
    counted_wide = check_count(count_kern, TRAIN_BT, TRAIN_R, 26744)
    lse_fwd, lse_bwd = check_dense_neg_lse(
        lse_kern, counted.pop("count"), TRAIN_BT, 50, 3706, 0.05
    )
    # the ml-20m catalog: the step of ml-20m-hstu (batch 128, D=50), then the
    # 1024-token class of a packed ml-20m-hstu-long step (24 rows, D=64)
    _, lse_bwd_wide = check_dense_neg_lse(
        lse_kern, counted_wide.pop("count"), TRAIN_BT, 50, 26744, 0.05, chunk=2048
    )
    del counted_wide
    # loss.num_to_sample=256 at the padded shape: int32 counts, and the lse
    # kernels' int32 instantiation on them
    check_dense_neg_lse(lse_kern, check_count(count_kern, TRAIN_BT, 256, 3706)["count"],
                        TRAIN_BT, 50, 3706, 0.05)
    long_bt = 24 * 1023
    check_dense_neg_lse(
        lse_kern, check_count(count_kern, long_bt, TRAIN_R, 26744)["count"], long_bt, 64,
        26744, 0.05, chunk=2048,
    )
    # the 256-token class of that step (17 rows, 4,297 supervision rows): the
    # launch with the fewest rows on the packed path
    class256_bt = 4297
    check_dense_neg_lse(
        lse_kern, check_count(count_kern, class256_bt, TRAIN_R, 26744)["count"], class256_bt, 64,
        26744, 0.05, chunk=2048,
    )
    # dense rows: 255 draws into 150 columns leave few of them dead, more live
    # logits a row than the backward's list holds, which it takes in rounds.
    # 4,096 rows: each dcat entry sums ~3,300 terms with much cancelling,
    # where float32 sums in two orders part by most of the tolerance (the
    # kernel sums in float64); at 26,880 rows autograd's float32 product and
    # index_add_ in the sparse plain backward are themselves further than the
    # tolerance from the exact sum
    dense_bt = 4096
    check_dense_neg_lse(lse_kern, check_count(count_kern, dense_bt, 255, 150)["count"], dense_bt,
                        64, 150, 0.05)
    # rows 7-8: the lse with sup_off, over the ml-20m catalog at a quarter of
    # the ring step's 33,088 supervision rows
    fused_bt = 8192
    offsets, positive = negative_draws(23, fused_bt, TRAIN_R, 26744)
    fused_fwd, fused_bwd = check_fused_lse(
        lse_kern, count_kern.count_offsets(offsets, positive, 26744), positive, fused_bt, 64,
        26744, 0.05, chunk=2048,
    )
    del offsets, positive
    # rows 9-10: the ring's chunks at ml-20m-hstu-long's widths (B=32, H=2,
    # d=64, L=1035): zigzag 130 x 130 and contiguous 259 x 259, at the
    # offsets the ring gives them (fully live, the diagonal, dead) and a
    # partial one, then a chunk of padded rows past the bias table
    chunk_fwd, chunk_bwd = check_chunk(chunk_kern, 50, 32, 130, 130, 2, 64, -130, 1035, timed=True)
    check_chunk(chunk_kern, 51, 32, 130, 130, 2, 64, 0, 1035, timed=True)
    check_chunk(chunk_kern, 52, 32, 259, 259, 2, 64, -518, 1035, timed=True)
    check_chunk(chunk_kern, 53, 32, 259, 259, 2, 64, 0, 1035, timed=True)
    check_chunk(chunk_kern, 54, 32, 259, 259, 2, 64, 259, 1035)
    check_chunk(chunk_kern, 55, 32, 130, 130, 2, 64, 65, 1035)
    check_chunk(chunk_kern, 56, 32, 130, 130, 2, 64, -910, 1035)
    torch.cuda.empty_cache()

    kc = Counts(kern, count_kern, lse_kern, chunk_kern)
    lse_kern.fused_launches = lse_kern.fused_bwd_launches = 0
    serving_launches = run_main_path(kern, num_blocks_expected=2, card=kind)
    train_counts = run_training_path(kc, card=kind)
    card_against_cpu_step(["experiment=synthetic-hstu"])
    long_counts = run_long_path(kc, card=kind)
    card_against_cpu_step(LONG_ARGS, packed_capacity=256)
    ring_counts = run_ring_path(kc, card=kind)
    ring_against_unsharded()
    fused_on_paths = (lse_kern.fused_launches, lse_kern.fused_bwd_launches)

    # no PyTorch call computes HSTU's silu attention with this bias, its
    # backward, or a count-weighted log-sum-exp over a matrix product that is
    # never materialised: library_ms is null for those
    rows = [
        dict(name=kern.KERNEL, source=kern.SOURCE, replaces=kern.REPLACES,
             launches=serving_launches + train_counts[kern.KERNEL] + long_counts[kern.KERNEL],
             library_ms=None, **serving),
        dict(name=kern.KERNEL_BWD, source=kern.SOURCE_BWD, replaces=kern.REPLACES_BWD,
             launches=train_counts[kern.KERNEL_BWD] + long_counts[kern.KERNEL_BWD],
             library_ms=None, **attn_bwd),
        dict(name=count_kern.KERNEL, source=count_kern.SOURCE, replaces=count_kern.REPLACES,
             launches=sum(c[count_kern.KERNEL] for c in (train_counts, long_counts, ring_counts)),
             **counted),
        dict(name=lse_kern.KERNEL, source=lse_kern.SOURCE, replaces=lse_kern.REPLACES,
             launches=sum(c[lse_kern.KERNEL] for c in (train_counts, long_counts, ring_counts)),
             library_ms=None, **lse_fwd),
        dict(name=lse_kern.KERNEL_BWD, source=lse_kern.SOURCE, replaces=lse_kern.REPLACES_BWD,
             launches=train_counts[lse_kern.KERNEL_BWD], library_ms=None, **lse_bwd),
        # the same entry point over the ml-20m catalog, wider than one x-block
        # of the TPU kernels: its launches are the long path's, its numbers
        # those of the [26880, 50] x [26744, 50] check
        dict(name=lse_kern.KERNEL_BWD + " (wide catalog)", source=lse_kern.SOURCE,
             replaces=lse_kern.REPLACES_WIDE,
             launches=long_counts[lse_kern.KERNEL_BWD] + ring_counts[lse_kern.KERNEL_BWD],
             library_ms=None, **lse_bwd_wide),
        # rows 7-8: the same entry points with a sup_off pointer; nothing on
        # the paths calls fused_dense_neg_lse (nor does the JAX package)
        dict(name=lse_kern.KERNEL + " (fused_dense_neg_lse, sup_off)", source=lse_kern.SOURCE,
             replaces=lse_kern.REPLACES_FUSED, launches=fused_on_paths[0],
             library_ms=None, **fused_fwd),
        dict(name=lse_kern.KERNEL_BWD + " (fused_dense_neg_lse, sup_off)", source=lse_kern.SOURCE,
             replaces=lse_kern.REPLACES_FUSED_BWD, launches=fused_on_paths[1],
             library_ms=None, **fused_bwd),
        # rows 9-10: numbers of the fully live 130 x 130 chunk, the zigzag
        # ring's most common call (28 of 36 a block)
        dict(name=chunk_kern.KERNEL, source=chunk_kern.SOURCE, replaces=chunk_kern.REPLACES,
             launches=ring_counts[chunk_kern.KERNEL], library_ms=None, **chunk_fwd),
        dict(name=chunk_kern.KERNEL_BWD, source=chunk_kern.SOURCE_BWD,
             replaces=chunk_kern.REPLACES_BWD, launches=ring_counts[chunk_kern.KERNEL_BWD],
             library_ms=None, **chunk_bwd),
    ]
    for row in rows:
        row["route"] = "cuda"
    log(f"card: {card}")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
