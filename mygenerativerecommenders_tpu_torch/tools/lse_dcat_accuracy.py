"""How far the dense-negative lse backward's dcat lies from the exact sum.

Runs `dense_neg_lse` and its backward `calls` times on one input and holds
each call's dcat against the whole function in float64. The two float32
plain versions are held against it too: autograd of `dense_neg_lse_plain`
and the sparse `dense_neg_lse_bwd_plain` (`index_add_`). Each distance is
the largest |got - want| / (atol + rtol |want|) over the entries at rtol 2e-4
/ atol 2e-5, the tolerance `chip_smoke.py` holds the kernel to: 1 is the edge.
It also counts the calls whose dcat is past that edge against either float32
plain version, and whether every call gave the same bits. By default the
input is the densest case `chip_smoke.py` checks: q [4096, 64], cat [150, 64],
255 draws a row, tau 0.05, its seeds.

    python -m mygenerativerecommenders_tpu_torch.tools.lse_dcat_accuracy [--bt N --d N --x N]

On a card it runs the kernels; `--device cpu` runs the wrappers' plain
versions, where the "kernel" is autograd of the plain version.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from mygenerativerecommenders_tpu_torch.ops.kernels import count_offsets as count_kern
from mygenerativerecommenders_tpu_torch.ops.kernels import dense_neg_lse as lse_kern

RTOL, ATOL = 2e-4, 2e-5


def distance(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (ATOL + RTOL |want|), in float64."""
    want = want.double()
    return float(((got.double() - want).abs() / (ATOL + RTOL * want.abs())).max())


def inputs(bt: int, d: int, x: int, draws: int, tau: float, device: str):
    """q, cat (unit rows), count and gl as `chip_smoke.py` builds them for
    its lse checks: the count's seed is x, q's, cat's and gl's 17; row 5
    draws only its positive and has no live logit."""
    rng = np.random.default_rng(x)
    offsets = rng.integers(0, x, size=(bt, draws)).astype(np.int32)
    positive = rng.integers(-1, x, size=bt).astype(np.int32)
    offsets[::7, :5] = positive[::7, None]
    positive[5] = 11
    offsets[5, :] = 11
    offsets[-100:, draws // 2 :] = x + 5
    count = count_kern.count_offsets(
        torch.tensor(offsets, device=device), torch.tensor(positive, device=device), x)
    rng = np.random.default_rng(17)
    q = torch.tensor(rng.normal(size=(bt, d)), dtype=torch.float32)
    cat = torch.tensor(rng.normal(size=(x, d)), dtype=torch.float32)
    q = (q / q.norm(dim=-1, keepdim=True)).to(device)
    cat = (cat / cat.norm(dim=-1, keepdim=True)).to(device)
    gl = torch.tensor(rng.normal(size=(bt,)), dtype=torch.float32).to(device)
    lse = lse_kern.dense_neg_lse_plain(q, cat, count, tau)
    return q, cat, count, torch.where(torch.isfinite(lse), gl, 0.0)


def dcat_exact(q, cat, count, gl, tau: float) -> torch.Tensor:
    """d (gl . lse) / d cat in float64, 1,024 rows at a time."""
    cat64 = cat.double()
    out = torch.zeros_like(cat64)
    for lo in range(0, q.shape[0], 1024):
        q64, c = q[lo : lo + 1024].double(), count[lo : lo + 1024]
        al = torch.where(c > 0, q64 @ cat64.T / tau, -torch.inf)
        m = al.max(dim=-1, keepdim=True).values
        p = c.double() * torch.exp(al - torch.where(torch.isfinite(m), m, 0.0))
        s = p.sum(dim=-1, keepdim=True)
        w = torch.where(s > 0, p / s, 0.0) * gl[lo : lo + 1024].double()[:, None] / tau
        out += w.T @ q64
    return out


def measure(bt: int, d: int, x: int, draws: int, calls: int, tau: float, device: str) -> dict:
    q, cat, count, gl = inputs(bt, d, x, draws, tau, device)
    exact = dcat_exact(q, cat, count, gl, tau)
    cg = cat.clone().requires_grad_()
    dense = torch.zeros_like(cat)
    for lo in range(0, bt, 2048):
        part = lse_kern.dense_neg_lse_plain(q[lo : lo + 2048], cg, count[lo : lo + 2048], tau)
        dense += torch.autograd.grad(part, [cg], gl[lo : lo + 2048])[0]
    m_safe, s = lse_kern.dense_neg_lse_stats_plain(q, cat, count, tau)
    sparse = lse_kern.dense_neg_lse_bwd_plain(q, cat, count, m_safe, s, gl, tau)[1]
    lse = lse_kern.dense_neg_lse(q, cg, count, tau)
    got = [torch.autograd.grad(lse, [cg], gl, retain_graph=True)[0] for _ in range(calls)]
    return dict(
        kernel_exact=max(distance(g, exact) for g in got),
        kernel_autograd=max(distance(g, dense) for g in got),
        kernel_sparse=max(distance(g, sparse) for g in got),
        past_edge=sum(distance(g, dense) > 1 or distance(g, sparse) > 1 for g in got),
        same_bits=all(torch.equal(g, got[0]) for g in got),
        autograd_exact=distance(dense, exact),
        sparse_exact=distance(sparse, exact),
    )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--bt", type=int, default=4096, help="rows of q")
    parser.add_argument("--d", type=int, default=64, help="embedding width")
    parser.add_argument("--x", type=int, default=150, help="catalog rows")
    parser.add_argument("--draws", type=int, default=255, help="negatives drawn a row")
    parser.add_argument("--calls", type=int, default=30, help="backward calls")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("lse_dcat_accuracy: needs an NVIDIA card (or --device cpu)", file=sys.stderr)
        return 2
    r = measure(args.bt, args.d, args.x, args.draws, args.calls, 0.05, args.device)
    where = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(f"{where}: dcat of q [{args.bt}, {args.d}] x cat [{args.x}, {args.d}], {args.draws} "
          f"draws a row, {args.calls} calls; distance (1 = rtol {RTOL} / atol {ATOL}) of the "
          f"kernel to float64 {r['kernel_exact']:.3f}, to autograd {r['kernel_autograd']:.3f}, "
          f"to the sparse plain backward {r['kernel_sparse']:.3f}; calls past 1 against either "
          f"{r['past_edge']}; the same bits in every call: {r['same_bits']}; autograd to "
          f"float64 {r['autograd_exact']:.3f}, sparse plain to float64 {r['sparse_exact']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
