"""Where the dense-negative lse backward kernel spends its time.

Builds timing-only variants of csrc/dense_neg_lse.cu, each with one part of
`dense_neg_lse_bwd` switched off by a text substitution (the variants compute
wrong gradients and are never loaded by the port), and times every variant's
backward and forward with CUDA events, by default at the training shape of
synthetic-hstu: q [26880, 50], cat [3706, 50], 128 draws a row, tau 0.05.
The sources are written to a temporary directory and built with the port's
nvcc flags. Needs an NVIDIA card and nvcc:

    python -m mygenerativerecommenders_tpu_torch.tools.lse_bwd_breakdown [--bt N --d N --x N]

`--x 26744` is the ml-20m catalog (the step of ml-20m-hstu); `--bt 24552 --d 64
--x 26744` the 1024-token class of a packed ml-20m-hstu-long step. Prints one
line per variant and round: the difference from `as_is` is what the part
switched off costs.
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

_DQ_LOOP = "for (int xx = 0; xx < kBN; ++xx) {"
_DCAT_LOOP = "for (int r = 0; r < kBM; ++r) {"
_ATOMIC = "atomicAdd(&dcat[(int64_t)col * d + e], dc[i][c]);"
_SKIP = "if (!__any_sync(0xffffffffu, any)) continue;"


def variants(src: str) -> dict:
    def off(text: str, loop: str) -> str:
        return text.replace(loop, loop.replace("< kBN", "< 0").replace("< kBM", "< 0"))

    out = {
        "as_is": src,
        # a store the compiler cannot drop, in place of the atomics
        "no_dcat_atomics": src.replace(_ATOMIC, "if (dc[i][c] == 123.f) dcat[0] = 1.f;"),
        "no_dcat_product": off(src, _DCAT_LOOP),
        "no_dq_product": off(src, _DQ_LOOP),
        "no_zero_skip": src.replace(_SKIP, ""),
        "logits_and_dal_only": off(off(src, _DCAT_LOOP), _DQ_LOOP),
    }
    for name, text in out.items():
        if name != "as_is" and text == src:
            raise RuntimeError(f"variant {name}: the source no longer holds its pattern")
    return out


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
    dq, dcat = torch.empty_like(q), torch.zeros_like(cat)
    stream = torch.cuda.current_stream().cuda_stream
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd_args = (q.data_ptr(), cat.data_ptr(), count.data_ptr(), lse.data_ptr(),
                m_safe.data_ptr(), s.data_ptr(), bt, d, x, inv_tau, stream)
    bwd_args = (q.data_ptr(), cat.data_ptr(), count.data_ptr(), m_safe.data_ptr(),
                s.data_ptr(), gl.data_ptr(), dq.data_ptr(), dcat.data_ptr(),
                bt, d, x, inv_tau, stream)
    print(f"{torch.cuda.get_device_name(0)}: q [{bt}, {d}] x cat [{x}, {d}], {r} draws a row",
          flush=True)
    for rnd in range(2):
        for name, lib in libs.items():
            lib.dense_neg_lse_fwd.argtypes = [p] * 6 + [i, i, i, f, p]
            lib.dense_neg_lse_bwd.argtypes = [p] * 8 + [i, i, i, f, p]
            lib.dense_neg_lse_fwd(*fwd_args)  # fills m_safe and s
            bwd_ms = device_ms(lambda: lib.dense_neg_lse_bwd(*bwd_args))
            fwd_ms = device_ms(lambda: lib.dense_neg_lse_fwd(*fwd_args))
            print(f"round {rnd} {name}: backward {bwd_ms:.4f} ms, forward {fwd_ms:.4f} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
