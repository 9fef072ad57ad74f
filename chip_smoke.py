#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA card and
check its kernels.

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
     ml-20m-hstu-long widths (B=4, N=L=1035, H=2, d=64), rtol 2e-4 / atol 2e-5;
   - the attention backward against autograd of the plain version at the
     training shape (B=128, N=L=211, H=1, d=50, ragged) and at the wide shape:
     dq, dk, dv at rtol 2e-4 / atol 2e-5, d_pos_w and d_ts_w at rtol 5e-4
     (they sum ~N^2 terms per row, here with float atomics whose order changes
     from run to run), rows past the length exactly zero;
   - the negative count at [26880, 128] into X=3,706 and X=26,744, with
     accidental hits and sentinels, exactly;
   - the dense-negative lse forward and backward at [26880, 50] x [3706, 50]
     with those counts, tau 0.05, one all-hit row: lse, dq, dcat at rtol 2e-4
     / atol 2e-5.
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


def attention_inputs(seed, b, n, h, d, lengths, proj_grad: bool = False):
    """q, k, v as column slices of one uvqk projection `proj`, as the block
    gives them; with proj_grad, proj is a leaf that takes their gradients and
    is returned beside the inputs."""
    rng = np.random.default_rng(seed)
    proj = torch.tensor(rng.normal(size=(b, n, 4 * h * d)), dtype=torch.float32).cuda()
    proj.requires_grad_(proj_grad)
    _, v, q, k = torch.split(proj, [h * d] * 4, dim=-1)
    ts = np.sort(978_000_000 + rng.integers(0, 3 * 365 * 86400, size=(b, n)), axis=1)
    inputs = dict(
        q=q.unflatten(-1, (h, d)), k=k.unflatten(-1, (h, d)), v=v.unflatten(-1, (h, d)),
        timestamps=torch.tensor(ts, dtype=torch.int32).cuda(),
        pos_w=torch.tensor(rng.normal(size=(2 * n - 1,)) * 0.02, dtype=torch.float32).cuda(),
        ts_w=torch.tensor(rng.normal(size=(129,)) * 0.02, dtype=torch.float32).cuda(),
        max_len=n, num_buckets=128,
        lengths=torch.tensor(lengths, dtype=torch.int32).cuda(),
    )
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


def attention_bound(a) -> tuple[float, str]:
    """Least time for this call: the bytes it must move at peak bandwidth vs
    the multiply-adds of q.k and p.v over the live causal pairs at peak fp32,
    both for this call's lengths. Reads: q, k, v and the timestamps of the
    valid rows only (row m < len, and the next-item stamp of the last one),
    the lengths, the pos_w entries the live offsets reach and all of ts_w;
    writes: the whole output, zeros past the length included."""
    b, n, h, dqk = a["q"].shape
    dv = a["v"].shape[-1]
    seq = torch.clamp(a["lengths"].cpu().long(), max=n)
    rows = int(seq.sum())
    stamps = int(torch.clamp(seq + 1, max=n).sum())
    reads = rows * h * (2 * dqk + dv) + stamps + b + int(seq.max()) + a["ts_w"].numel()
    nbytes = 4 * (reads + b * n * h * dv)
    pairs = int((seq * (seq + 1) // 2).sum())
    return bound(nbytes, pairs * h * 2 * (dqk + dv))


def check_attention(kern, name, seed, b, n, h, d, lengths) -> dict:
    a = attention_inputs(seed, b, n, h, d, lengths)
    got = kern.hstu_attention_fused(**a)
    want = kern.hstu_attention_fused_plain(**a)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    max_abs = float(diff.max())
    big = want.abs() > 1e-3
    max_rel = float((diff[big] / want.abs()[big]).max()) if bool(big.any()) else 0.0
    ok = bool((diff <= ATOL + RTOL * want.abs()).all())
    dead = all(not bool(got[i, length:].any()) for i, length in enumerate(lengths))
    log(f"{name} B={b} N=L={n} H={h} d={d}: max_abs_err={max_abs:.3e} "
        f"max_rel_err={max_rel:.3e} (|want|>1e-3), within rtol {RTOL} atol {ATOL}: {ok}, "
        f"rows past length zero: {dead}")
    check(ok and dead, f"{name} disagrees with its plain version at B={b} N={n} H={h} d={d}")
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
    seq = torch.clamp(a["lengths"].cpu().long(), max=n)
    rows = int(seq.sum())
    stamps = int(torch.clamp(seq + 1, max=n).sum())
    reads = rows * h * (2 * dqk + 2 * dv) + stamps + b + int(seq.max()) + a["ts_w"].numel()
    writes = b * n * h * (2 * dqk + dv) + a["pos_w"].numel() + a["ts_w"].numel()
    pairs = int((seq * (seq + 1) // 2).sum())
    return bound(4 * (reads + writes), pairs * h * 2 * (3 * dqk + 2 * dv))


def check_attention_bwd(kern, seed, b, n, h, d, lengths) -> dict:
    a, proj = attention_inputs(seed, b, n, h, d, lengths, proj_grad=True)
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
    log(f"{kern.KERNEL_BWD} B={b} N=L={n} H={h} d={d}: max_abs_err " + ", ".join(errs)
        + f"; within rtol {RTOL} (tables {BIAS_RTOL}) atol {ATOL}: {ok}, "
        f"rows past length zero: {dead}")
    check(ok and dead, f"{kern.KERNEL_BWD} disagrees with autograd of its plain version "
          f"at B={b} N={n} H={h} d={d}")
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
    return torch.tensor(offsets).cuda(), torch.tensor(positive).cuda()


def check_count(kern, bt, r, x) -> dict:
    offsets, positive = negative_draws(x, bt, r, x)
    got = kern.count_offsets(offsets, positive, x)
    want = kern.count_offsets_plain(offsets, positive, x)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    hits = int((offsets == positive[:, None]).sum())
    log(f"{kern.KERNEL} [{bt}, {r}] into X={x}: equal to plain: {equal} "
        f"({int(got.sum())} draws counted, {hits} accidental hits and "
        f"{int((offsets >= x).sum())} sentinels dropped)")
    check(equal, f"{kern.KERNEL} disagrees with its plain version at X={x}")
    check(not bool(got[5].any()), "the all-hit row has a count")
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


def check_dense_neg_lse(kern, count, bt, d, x, tau) -> tuple[dict, dict]:
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
    lse_plain = kern.dense_neg_lse_plain(q, cat, count, tau)
    want = torch.autograd.grad(lse_plain, [q, cat], gl, retain_graph=True)
    torch.cuda.synchronize()
    same_inf = bool(torch.equal(finite, torch.isfinite(lse_plain)))
    ok_lse, err_lse = within(lse[finite], lse_plain[finite], RTOL, ATOL)
    ok_dq, err_dq = within(got[0], want[0], RTOL, ATOL)
    ok_dcat, err_dcat = within(got[1], want[1], RTOL, ATOL)
    log(f"{kern.KERNEL} / {kern.KERNEL_BWD} [{bt}, {d}] x [{x}, {d}], tau {tau}: max_abs_err "
        f"lse {err_lse:.3e}, dq {err_dq:.3e}, dcat {err_dcat:.3e}; within rtol {RTOL} atol "
        f"{ATOL}: {ok_lse and ok_dq and ok_dcat}; all-hit row 5: lse {float(lse[5].detach())}, "
        f"-inf rows agree: {same_inf}, its dq zero: {not bool(got[0][5].any())}")
    check(same_inf and float(lse[5].detach()) == float("-inf"), "the all-hit row's lse is not -inf")
    check(ok_lse, f"{kern.KERNEL} disagrees with its plain version")
    check(ok_dq and ok_dcat and not bool(got[0][5].any()),
          f"{kern.KERNEL_BWD} disagrees with autograd of its plain version")
    nnz = int(count.count_nonzero())
    with torch.no_grad():
        fwd_ms = device_ms(lambda: kern.dense_neg_lse(q, cat, count, tau), 50)
        fwd_plain = device_ms(lambda: kern.dense_neg_lse_plain(q, cat, count, tau), 10)
    bwd_ms = device_ms(lambda: torch.autograd.grad(lse, [q, cat], gl, retain_graph=True), 30)
    bwd_plain = device_ms(
        lambda: torch.autograd.grad(lse_plain, [q, cat], gl, retain_graph=True), 5)
    # only the logits whose count is positive are needed: the operations
    # counted are those of this run's nnz live logits, not of all BT*X
    fwd_bound = bound(4 * (bt * d + x * d + 3 * bt) + bt * x, nnz * 2 * d)
    bwd_bound = bound(4 * (2 * bt * d + 2 * x * d + 3 * bt) + bt * x, nnz * 6 * d)
    log(f"  forward: kernel {fwd_ms:.5f} ms, plain {fwd_plain:.5f} ms, bound "
        f"{fwd_bound[0]:.5f} ms ({fwd_bound[1]}); {nnz} live logits of {bt * x}; the "
        f"dense product is {2e-9 * bt * x * d:.2f} GFLOP, {2e-6 * bt * x * d / fwd_ms:.0f} "
        f"GFLOP/s as run")
    log(f"  backward: kernel {bwd_ms:.5f} ms, plain {bwd_plain:.5f} ms, bound "
        f"{bwd_bound[0]:.5f} ms ({bwd_bound[1]}); dense {6e-9 * bt * x * d:.2f} GFLOP")
    fwd = dict(max_abs_err=err_lse, ms=fwd_ms, plain_ms=fwd_plain, bound_ms=fwd_bound[0],
               bound_by=fwd_bound[1])
    bwd = dict(max_abs_err=max(err_dq, err_dcat), ms=bwd_ms, plain_ms=bwd_plain,
               bound_ms=bwd_bound[0], bound_by=bwd_bound[1])
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


def profile_device(fn, reps: int, what: str, wall_ms: float, top: int) -> None:
    """Where the time of `fn` goes: torch.profiler's device time of the kernels
    one call launches, against its host wall time `wall_ms` (measured without
    the profiler)."""
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


# ---------------------------------------------------------------- phase 4


def launch_counts(attn, count_kern, lse_kern) -> dict:
    return {
        attn.KERNEL: attn.launches, attn.KERNEL_BWD: attn.bwd_launches,
        count_kern.KERNEL: count_kern.launches,
        lse_kern.KERNEL: lse_kern.launches, lse_kern.KERNEL_BWD: lse_kern.bwd_launches,
    }


def reset_counts(attn, count_kern, lse_kern) -> None:
    attn.launches = attn.bwd_launches = 0
    count_kern.launches = 0
    lse_kern.launches = lse_kern.bwd_launches = 0


def run_training_path(attn, count_kern, lse_kern, card: str) -> dict:
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
    reset_counts(attn, count_kern, lse_kern)
    t0 = time.perf_counter()
    monitored = cli_train.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(attn, count_kern, lse_kern)

    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    losses = np.asarray([r["train/loss"] for r in rows if "train/loss" in r])
    val = [r for r in rows if "val/ndcg@100" in r]
    test = [r for r in rows if "test/ndcg@100" in r]
    steps = len(losses)
    blocks = cfg.model.encoder.num_blocks
    users = cfg.data.synthetic_num_users
    per_epoch = -(-users // cfg.data.batch_size)
    eval_batches = (epochs + 1) * per_epoch  # validation each epoch, then the test pass
    log(f"training path: cli.train on {card}, synthetic-hstu D={cfg.model.item_embedding_dim} "
        f"blocks={blocks} N={cfg.data.max_sequence_length + cfg.model.gr_output_length + 1} "
        f"batch={cfg.data.batch_size} R={cfg.model.loss.num_to_sample} "
        f"dropout={cfg.model.encoder.linear_dropout_rate}: {steps} optimizer steps, "
        f"{eval_batches} eval batches in {wall:.2f} s; launches {counts}")
    log(f"  loss: first {losses[0]:.4f} (log 129 = {np.log(129):.4f}), first five mean "
        f"{losses[:5].mean():.4f}, last five mean {losses[-5:].mean():.4f}")
    check(steps == epochs * per_epoch, f"{steps} optimizer steps, expected {epochs * per_epoch}")
    check(bool(np.isfinite(losses).all()), "a non-finite training loss")
    check(losses[-5:].mean() < losses[:5].mean(), "the loss did not fall")
    check(len(val) == epochs and len(test) == 1, "val/ or test/ metric rows are missing")
    for r in val + test:
        for key, value in r.items():
            if "/" in key and not key.startswith("train/"):
                check(0.0 <= value <= 1.0, f"{key}={value} outside [0, 1]")
    check(0.0 <= monitored <= 1.0, f"the monitored metric {monitored} is outside [0, 1]")
    best = max(val, key=lambda r: r["val/ndcg@100"])
    log(f"  val/ndcg@100 first epoch {val[0]['val/ndcg@100']:.5f}, best {best['val/ndcg@100']:.5f} "
        f"(epoch {best['epoch']}), last {val[-1]['val/ndcg@100']:.5f}; test on the best "
        f"checkpoint: ndcg@10 {test[0]['test/ndcg@10']:.5f}, ndcg@100 "
        f"{test[0]['test/ndcg@100']:.5f}, hr@200 {test[0]['test/hr@200']:.5f} (the JAX "
        f"package's 30-epoch band on this data: ndcg@10 0.037-0.039, PARITY.md)")
    check(test[0]["test/ndcg@10"] >= MIN_TEST_NDCG10,
          f"test ndcg@10 {test[0]['test/ndcg@10']} below {MIN_TEST_NDCG10} after {epochs} epochs")
    want = {
        attn.KERNEL: blocks * (steps + eval_batches), attn.KERNEL_BWD: blocks * steps,
        count_kern.KERNEL: steps, lse_kern.KERNEL: steps, lse_kern.KERNEL_BWD: steps,
    }
    check(counts == want, f"launches {counts} != expected {want}")
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
        before = launch_counts(attn, count_kern, lse_kern)
        t0 = time.perf_counter()
        trainer.train_step(batches[i % len(batches)], trainer.lr1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        after = launch_counts(attn, count_kern, lse_kern)
        delta = [after[k] - before[k] for k in after]
        check(delta == [blocks, blocks, 1, 1, 1], f"launches of one step: {delta}")
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


# ---------------------------------------------------------------- phase 5


def card_against_cpu_step() -> None:
    """One loss and its gradients through the port on the card (kernels) and
    on the CPU (plain versions): same weights, batch and negatives, dropout off."""
    from mygenerativerecommenders_tpu_torch.cli.train import parse_args
    from mygenerativerecommenders_tpu_torch.configs import resolve
    from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
    from mygenerativerecommenders_tpu_torch.models.model import build_model
    from mygenerativerecommenders_tpu_torch.train.task_retrieval import make_loss_fn

    cfg = parse_args(["experiment=synthetic-hstu"])
    data = RecoData(cfg.data, seed=cfg.trainer.seed)
    resolve(cfg, data.max_item_id)
    batch = next(iter(data.loader("train")))
    n = cfg.data.max_sequence_length + cfg.model.gr_output_length + 1
    gen = torch.Generator().manual_seed(3)
    offsets = torch.randint(
        0, len(data.all_item_ids), (cfg.data.batch_size, n - 1, cfg.model.loss.num_to_sample),
        generator=gen, dtype=torch.int32,
    )
    results = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg, device=device, seed=99)  # eval mode: dropout off
        loss_fn = make_loss_fn(model, cfg, data.all_item_ids)
        dev_batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        loss = loss_fn(dev_batch, neg_offsets=offsets.to(device))
        loss.backward()
        results[device] = (
            loss.item(), {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
        )
    (loss_card, grads_card), (loss_cpu, grads_cpu) = results["cuda"], results["cpu"]
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    log(f"one step, card (kernels) vs CPU (plain versions): loss {loss_card:.6f} vs "
        f"{loss_cpu:.6f}, relative difference {rel:.3e} (rtol {STEP_LOSS_RTOL})")
    check(rel <= STEP_LOSS_RTOL, "the card's loss disagrees with the CPU's")
    worst = True
    for name, want in grads_cpu.items():
        ok, err = within(grads_card[name], want, STEP_GRAD_RTOL, STEP_GRAD_ATOL)
        log(f"  grad {name}: max_abs_err {err:.3e}, max |grad| {float(want.abs().max()):.3e}, "
            f"within rtol {STEP_GRAD_RTOL} atol {STEP_GRAD_ATOL}: {ok}")
        worst = worst and ok
    check(worst, "a parameter's gradient on the card disagrees with the CPU's")


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

    check(Path(port.__file__).resolve().parent.parent == HERE,
          f"the port was imported from {port.__file__}, not from this checkout")
    card = card_line()
    log(card)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {count} x {kind}")

    build_kernels(_build, [kern.KERNEL, kern.KERNEL_BWD, count_kern.KERNEL, lse_kern.LIBRARY])

    ragged = np.random.default_rng(2).integers(2, 211, size=126).tolist()
    serving = check_attention(kern, kern.KERNEL, 1, 32, 211, 1, 50, [1, 211] + ragged[:30])
    check_attention(kern, kern.KERNEL, 3, 4, 1035, 2, 64, [1, 1035, 517, 900])
    attn_bwd = check_attention_bwd(kern, 5, 128, 211, 1, 50, [1, 211] + ragged)
    check_attention_bwd(kern, 7, 4, 1035, 2, 64, [1, 1035, 517, 900])
    counted = check_count(count_kern, TRAIN_BT, TRAIN_R, 3706)
    check_count(count_kern, TRAIN_BT, TRAIN_R, 26744)
    lse_fwd, lse_bwd = check_dense_neg_lse(
        lse_kern, counted.pop("count"), TRAIN_BT, 50, 3706, 0.05
    )
    torch.cuda.empty_cache()

    serving_launches = run_main_path(kern, num_blocks_expected=2, card=kind)
    train_counts = run_training_path(kern, count_kern, lse_kern, card=kind)
    card_against_cpu_step()

    # no PyTorch call computes HSTU's silu attention with this bias, its
    # backward, or a count-weighted log-sum-exp over a matrix product that is
    # never materialised: library_ms is null for those
    rows = [
        dict(name=kern.KERNEL, source=kern.SOURCE, replaces=kern.REPLACES,
             launches=serving_launches + train_counts[kern.KERNEL], library_ms=None, **serving),
        dict(name=kern.KERNEL_BWD, source=kern.SOURCE_BWD, replaces=kern.REPLACES_BWD,
             launches=train_counts[kern.KERNEL_BWD], library_ms=None, **attn_bwd),
        dict(name=count_kern.KERNEL, source=count_kern.SOURCE, replaces=count_kern.REPLACES,
             launches=train_counts[count_kern.KERNEL], **counted),
        dict(name=lse_kern.KERNEL, source=lse_kern.SOURCE, replaces=lse_kern.REPLACES,
             launches=train_counts[lse_kern.KERNEL], library_ms=None, **lse_fwd),
        dict(name=lse_kern.KERNEL_BWD, source=lse_kern.SOURCE, replaces=lse_kern.REPLACES_BWD,
             launches=train_counts[lse_kern.KERNEL_BWD], library_ms=None, **lse_bwd),
    ]
    for row in rows:
        row["route"] = "cuda"
    log(f"card: {card}")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
