#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA card and check its kernels.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:

1. The card's name and power limit (nvidia-smi), then the nvcc build of every
   kernel of the path from csrc/, with the build time and the -Xptxas -v summary.
2. Each kernel against its plain PyTorch version on the card, at the serving
   shape (B=32, N=L=211, H=1, d=50, ragged lengths including 1 and 211,
   ml-1m-era timestamps) and at the ml-20m-hstu-long widths (B=4, N=L=1035,
   H=2, d=64), at rtol 2e-4 / atol 2e-5; then both timed with CUDA events.
3. The main path at the full width of `synthetic-hstu`: `cli.serve.build_engine`
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


def attention_inputs(seed, b, n, h, d, lengths):
    """q, k, v as column slices of one uvqk projection, as the block gives them."""
    rng = np.random.default_rng(seed)
    proj = torch.tensor(rng.normal(size=(b, n, 4 * h * d)), dtype=torch.float32).cuda()
    _, v, q, k = torch.split(proj, [h * d] * 4, dim=-1)
    ts = np.sort(978_000_000 + rng.integers(0, 3 * 365 * 86400, size=(b, n)), axis=1)
    return dict(
        q=q.unflatten(-1, (h, d)), k=k.unflatten(-1, (h, d)), v=v.unflatten(-1, (h, d)),
        timestamps=torch.tensor(ts, dtype=torch.int32).cuda(),
        pos_w=torch.tensor(rng.normal(size=(2 * n - 1,)) * 0.02, dtype=torch.float32).cuda(),
        ts_w=torch.tensor(rng.normal(size=(129,)) * 0.02, dtype=torch.float32).cuda(),
        max_len=n, num_buckets=128,
        lengths=torch.tensor(lengths, dtype=torch.int32).cuda(),
    )


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
    ops = pairs * h * 2 * (dqk + dv)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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
    profile_engine_call(engine, big, wall_ms=float(p(direct_ms, 50)))
    return launches


def timed_rounds(port: int, engine, req: dict, rounds: int = 5, reps: int = 10):
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


def profile_engine_call(engine, req: dict, wall_ms: float, reps: int = 20) -> None:
    """Where an engine call's time goes: the device time of the kernels a
    32-row call launches against its host wall time `wall_ms` (no HTTP,
    measured without the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            engine.retrieve(req["sequences"], req["timestamps"], k=req["k"])
    # device-side events only: an aten op's row repeats its kernels' time
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    launches = sum(e.count for e in kernels) / reps
    log(f"engine call, 32 rows, no HTTP: wall p50 {wall_ms:.3f} ms; device kernels "
        f"{device_ms:.3f} ms in {launches:.0f} launches per call; device idle "
        f"{100 * (1 - device_ms / wall_ms):.1f}% of the wall time")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.self_device_time_total / 1e3 / reps:.4f} ms/call x{e.count // reps} "
            f"{e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import mygenerativerecommenders_tpu_torch as port
    from mygenerativerecommenders_tpu_torch.ops.kernels import _build
    from mygenerativerecommenders_tpu_torch.ops.kernels import hstu_attention as kern

    check(Path(port.__file__).resolve().parent.parent == HERE,
          f"the port was imported from {port.__file__}, not from this checkout")
    card = card_line()
    log(card)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {count} x {kind}")

    build_kernels(_build, [kern.KERNEL])

    serving = check_attention(
        kern, kern.KERNEL, 1, 32, 211, 1, 50,
        [1, 211] + np.random.default_rng(2).integers(2, 211, size=30).tolist(),
    )
    check_attention(kern, kern.KERNEL, 3, 4, 1035, 2, 64, [1, 1035, 517, 900])

    launches = run_main_path(kern, num_blocks_expected=2, card=kind)

    row = dict(
        name=kern.KERNEL, route="cuda", source=kern.SOURCE, replaces=kern.REPLACES,
        launches=launches, max_abs_err=serving["max_abs_err"], ms=serving["ms"],
        kernel_ms=serving["ms"], plain_ms=serving["plain_ms"], bound_ms=serving["bound_ms"],
        bound_by=serving["bound_by"],
        library_ms=None,  # no PyTorch call computes HSTU's silu attention with this bias
    )
    log(f"card: {card}")
    log(json.dumps({"kernels": [row]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
