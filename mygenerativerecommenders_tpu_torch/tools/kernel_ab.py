"""Rows 1-5 at their padded shapes, timed from two checkouts in one call.

A kernel's time moves between cards and machines, so a kernel that no
change touched is compared with its parent only inside one run on one card.
This script times, in alternating processes (parent, change, change,
parent), the attention forward and backward at shape A (B=32 and B=128,
N=L=211, H=1, d=50) and at the large-vocab shape V (B=64, N=L=211, H=2,
d=64), and the count and the lse pair at the ml-1m catalog (X=3,883), each
through the checkout's own `chip_smoke.py` checks (CUDA events; the same
seeds and shapes as its phase 2). Each process builds its checkout's
kernels and imports that checkout's package only.

    python -m mygenerativerecommenders_tpu_torch.tools.kernel_ab PARENT CHANGE

prints one line a process and a last JSON line {name: {checkout: [ms, ms]}}.
Needs a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

_CHILD = r"""
import json, sys
sys.path.insert(0, ".")
import numpy as np
import chip_smoke as cs
import mygenerativerecommenders_tpu_torch as port
from mygenerativerecommenders_tpu_torch.ops.kernels import _build
from mygenerativerecommenders_tpu_torch.ops.kernels import count_offsets as count_kern
from mygenerativerecommenders_tpu_torch.ops.kernels import dense_neg_lse as lse_kern
from mygenerativerecommenders_tpu_torch.ops.kernels import hstu_attention as kern
from pathlib import Path
assert Path(port.__file__).resolve().parents[1] == Path(".").resolve(), port.__file__
cs.build_kernels(_build, [kern.KERNEL, kern.KERNEL_BWD, count_kern.KERNEL, lse_kern.LIBRARY])
ragged = np.random.default_rng(2).integers(2, 211, size=126).tolist()
out = {
    "row 1, A": cs.check_attention(kern, kern.KERNEL, 1, 32, 211, 1, 50, [1, 211] + ragged[:30]),
    "row 2, A": cs.check_attention_bwd(kern, 5, 128, 211, 1, 50, [1, 211] + ragged),
    "row 1, V": cs.check_attention(kern, kern.KERNEL, 70, 64, 211, 2, 64, [1, 211] + ragged[:62]),
    "row 2, V": cs.check_attention_bwd(kern, 71, 64, 211, 2, 64, [1, 211] + ragged[:62]),
}
counted = cs.check_count(count_kern, cs.TRAIN_BT, cs.TRAIN_R, 3883)
out["row 3, X=3883"] = counted
out["row 4, X=3883"], out["row 5, X=3883"] = cs.check_dense_neg_lse(
    lse_kern, counted.pop("count"), cs.TRAIN_BT, 50, 3883, 0.05)
print("AB " + json.dumps({k: v["ms"] for k, v in out.items()}), flush=True)
"""


def measure(tree: Path) -> dict:
    """One process in `tree`: {row: ms}."""
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=tree, capture_output=True,
                          text=True, check=False)
    line = next((x for x in proc.stdout.splitlines() if x.startswith("AB ")), None)
    if proc.returncode != 0 or line is None:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(line[3:])


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = (Path(a).resolve() for a in args)
    results: dict = {}
    for tree, label in ((parent, "parent"), (change, "change"), (change, "change"),
                        (parent, "parent")):
        got = measure(tree)
        print(f"{label} ({tree}): " + ", ".join(f"{k} {v:.5f} ms" for k, v in got.items()),
              flush=True)
        for row, ms in got.items():
            results.setdefault(row, {}).setdefault(label, []).append(ms)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
