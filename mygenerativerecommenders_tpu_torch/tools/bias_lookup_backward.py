"""The relative-bias tables' lookup, forward and backward, by indexing
against by an embedding lookup, at the softmax_rel_bias step's shapes.

The softmax attention (`models/hstu.py`, `normalization=softmax_rel_bias`)
materialises its bias: the position table [2L - 1] read at a [N, N] index
and the time table [nb + 1] at a [B, N, N] index of bucketed time gaps,
with ~10^5 reads of each slot. `table[idx]`'s backward (`index_put_` with
accumulate) sums a slot's duplicates one after another; `F.embedding`'s
sorts and sums them in segments. Both give the same forward values. This
times one forward and backward of each form on real time buckets
(timestamps a day apart on average, the synthetic draw's scale) and on
uniform ones, and prints their largest gradient difference.

    python -m mygenerativerecommenders_tpu_torch.tools.bias_lookup_backward [--b 128 --n 211]

By default the ml-1m width: B=128, N=211, L=211, 128 time buckets.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.nn.functional as F

from mygenerativerecommenders_tpu_torch.ops.hstu_attention import (
    relative_position_index,
    relative_time_index,
)


def timed_ms(fn, reps: int, device: torch.device) -> float:
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b", type=int, default=128)
    ap.add_argument("--n", type=int, default=211)
    ap.add_argument("--buckets", type=int, default=128)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu", file=sys.stderr)
        return 2
    g = torch.Generator().manual_seed(0)
    gaps = torch.poisson(torch.full((args.b, args.n), 86400.0), generator=g)
    timestamps = torch.cumsum(gaps, dim=1).to(torch.int32).to(device)
    cases = {
        "time, real buckets": relative_time_index(timestamps, args.buckets),
        "time, uniform buckets": torch.randint(0, args.buckets + 1, (args.b, args.n, args.n),
                                               generator=g).to(device),
        "position": relative_position_index(args.n, args.n, device)[None].expand(args.b, -1, -1),
    }
    if device.type == "cuda":
        print(torch.cuda.get_device_name(0))
    for name, idx in cases.items():
        slots = int(idx.max()) + 1
        table = torch.randn(slots, generator=g).to(device).requires_grad_()
        up = torch.randn(idx.shape, generator=g).to(device)

        def by_index():
            table.grad = None
            (table[idx] * up).sum().backward()
            return table.grad

        def by_embedding():
            table.grad = None
            (F.embedding(idx, table[:, None])[..., 0] * up).sum().backward()
            return table.grad

        diff = float((by_index() - by_embedding()).abs().max())
        index_ms = timed_ms(by_index, args.reps, device)
        embedding_ms = timed_ms(by_embedding, args.reps, device)
        print(f"{name}: [{', '.join(map(str, idx.shape))}] index into {slots} slots, "
              f"the most read slot {int(torch.bincount(idx.flatten()).max())} times: "
              f"indexing {index_ms:.3f} ms, embedding {embedding_ms:.3f} ms forward and "
              f"backward; largest gradient difference {diff:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
