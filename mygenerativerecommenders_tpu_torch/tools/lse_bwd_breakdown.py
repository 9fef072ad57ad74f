"""Where the dense-negative lse backward kernel spends its time.

Builds timing-only variants of csrc/dense_neg_lse.cu, each with one part of
`dense_neg_lse_bwd` switched off by a text substitution in the backward's own
part of the source (the variants compute wrong gradients and are never loaded
by the port; their forwards are the port's), and times every variant's
backward and forward with CUDA events, by default at the training shape of
synthetic-hstu: q [26880, 50], cat [3706, 50], 128 draws a row, tau 0.05.
The sources are written to a temporary directory and built with the port's
nvcc flags. Needs an NVIDIA card and nvcc:

    python -m mygenerativerecommenders_tpu_torch.tools.lse_bwd_breakdown [--bt N --d N --x N]

`--x 26744` is the ml-20m catalog (the step of ml-20m-hstu); `--bt 24552 --d 64
--x 26744` the 1024-token class of a packed ml-20m-hstu-long step. Prints one
line per variant and round: the difference from `as_is` is what the part
switched off costs (`scan_only`: all but reading the counts and listing the
live pairs).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from mygenerativerecommenders_tpu_torch.ops.kernels import _build
from mygenerativerecommenders_tpu_torch.ops.kernels.count_offsets import count_offsets

# the backward's own part of the source; the walk it shares with the forward
# lies above it and is left as it is, so each variant's forward stays right
_BWD_FROM = "// ---------------------------------------------------------------- backward"
_BWD_TO = "// ---------------------------------------------------------------- launch"
_PAIRS = "for (int jb = 0; jb < p.n; jb += p.kGroups * kPairUnroll) {"
_LOGITS = "p.logits(jb, xs, cnt, cv, al);"
_EXP = "expf(al[u] - mi)"
_DQ = "acc[r][v] = fmaf(dal[u], cv[u][r][v], acc[r][v]);"
_ATOMIC = "add_dcat(dcat, (int64_t)xs[u] * p.d, dal[u]);"
# the listed pairs read, nothing gathered, no dot product, no shuffle sum
_LIST_ONLY = (
    "for (int u = 0; u < kPairUnroll; ++u) { const int j = jb + u * p.kGroups + p.g;"
    " const int2 e = j < p.n ? p.pairs[j] : make_int2(-1, 0); xs[u] = e.x;"
    " cnt[u] = __int_as_float(e.y); al[u] = (float)e.x;"
    " for (int r = 0; r < kReps; ++r) for (int v = 0; v < kVec; ++v) cv[u][r][v] = (float)e.x; }"
)


def variants(src: str) -> dict:
    lo, hi = src.index(_BWD_FROM), src.index(_BWD_TO)

    def sub(*pairs) -> str:
        bwd = src[lo:hi]
        for old, new in pairs:
            if bwd.count(old) != 1:
                raise RuntimeError(f"the backward holds {old!r} {bwd.count(old)} times, not once")
            bwd = bwd.replace(old, new)
        return src[:lo] + bwd + src[hi:]

    return {
        "as_is": src,
        # the count scan and the lists; each list is read once, so that the
        # compiler keeps its stores, and not computed
        "scan_only": sub(
            (_PAIRS, _PAIRS + " acc[0][0] += __int_as_float(p.pairs[jb].y); continue;")),
        # no cat row gathered, no shuffle sum, no exponential: dal from the
        # lane's own registers
        "no_gather_logits": sub((_LOGITS, _LIST_ONLY), (_EXP, "(al[u] - mi)")),
        "no_dq": sub((_DQ, ";")),
        # a store the compiler cannot drop, in place of the atomics
        "no_dcat_atomics": sub((_ATOMIC, "if (dal[u] == 123.f) dcat[0] = qt[0];")),
    }


def device_ms(fn, reps: int = 30) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--bt", type=int, default=26880, help="rows of q")
    parser.add_argument("--d", type=int, default=50, help="embedding width")
    parser.add_argument("--x", type=int, default=3706, help="catalog rows")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("lse_bwd_breakdown: needs an NVIDIA card", file=sys.stderr)
        return 2
    src = (_build.CSRC_DIR / "dense_neg_lse.cu").read_text()
    tmp = Path(tempfile.mkdtemp())
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name, text in variants(src).items():
        (tmp / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *flags, "-o", str(tmp / f"{name}.so"), str(tmp / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        libs[name] = ctypes.CDLL(str(tmp / f"{name}.so"))

    bt, d, x, r, inv_tau = args.bt, args.d, args.x, 128, 20.0
    rng = np.random.default_rng(0)
    offsets = torch.tensor(rng.integers(0, x, size=(bt, r)), dtype=torch.int32).cuda()
    positive = torch.tensor(rng.integers(-1, x, size=(bt,)), dtype=torch.int32).cuda()
    count = count_offsets(offsets, positive, x)
    q = torch.tensor(rng.normal(size=(bt, d)), dtype=torch.float32)
    cat = torch.tensor(rng.normal(size=(x, d)), dtype=torch.float32)
    q = (q / q.norm(dim=-1, keepdim=True)).cuda()
    cat = (cat / cat.norm(dim=-1, keepdim=True)).cuda()
    gl = torch.tensor(rng.normal(size=(bt,)), dtype=torch.float32).cuda()
    lse, m_safe, s = (torch.empty(bt, device="cuda") for _ in range(3))
    dq, dcat = torch.empty_like(q), torch.empty_like(cat)
    acc = torch.zeros(cat.shape, dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    # no sup_off (null): nothing masked, as on the training path; uint8 counts
    # (wide 0): 128 draws a row
    fwd_args = (q.data_ptr(), cat.data_ptr(), count.data_ptr(), None, lse.data_ptr(),
                m_safe.data_ptr(), s.data_ptr(), bt, d, x, x, inv_tau, 0, stream)
    bwd_args = (q.data_ptr(), cat.data_ptr(), count.data_ptr(), None, m_safe.data_ptr(),
                s.data_ptr(), gl.data_ptr(), dq.data_ptr(), acc.data_ptr(), dcat.data_ptr(),
                bt, d, x, x, inv_tau, 0, stream)
    print(f"{torch.cuda.get_device_name(0)}: q [{bt}, {d}] x cat [{x}, {d}], {r} draws a row",
          flush=True)
    for rnd in range(2):
        for name, lib in libs.items():
            lib.dense_neg_lse_fwd.argtypes = [p] * 7 + [i, i, i, ll, f, i, p]
            lib.dense_neg_lse_bwd.argtypes = [p] * 10 + [i, i, i, ll, f, i, p]
            lib.dense_neg_lse_fwd(*fwd_args)  # fills m_safe and s
            bwd_ms = device_ms(lambda: lib.dense_neg_lse_bwd(*bwd_args))
            fwd_ms = device_ms(lambda: lib.dense_neg_lse_fwd(*fwd_args))
            print(f"round {rnd} {name}: backward {bwd_ms:.4f} ms, forward {fwd_ms:.4f} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
