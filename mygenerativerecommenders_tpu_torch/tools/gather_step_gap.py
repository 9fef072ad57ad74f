"""How far one gather-loss step's gradients on the card lie from the CPU's.

Builds `synthetic-large-vocab-100m`'s model at `--items` items (the gather
loss held), with the 2-D table as shipped and with the local table, on each
device of `--devices`, from one seed (so the same weights), and takes one
loss and its gradients on the first `--rows` rows of the first train batch
with the same negatives, dropout off: what `chip_smoke.py`'s phase 5 check
does. It prints the losses and, for each pair of runs, the four parameters
whose gradients part most, each as max |a - b| over its tensor's largest
|b|.

    python -m mygenerativerecommenders_tpu_torch.tools.gather_step_gap [--items N --rows N]

`--devices cpu,cpu` compares two CPU runs. The device `cpu64` takes the
same step on the CPU in float64: the weights widened from the same float32
draw, and every `.float()` of the forward and backward widened to float64
for the length of the step, so its gradients stand for the exact sum that
the float32 runs round; each run is then also printed against it.
`--layouts local` leaves out the 2-D table. The device `cudaplain` takes the
step on the card with the attention's plain version (autograd of
`hstu_attention_fused_plain`) in place of its kernels. A CPU device with the
suffix `x` (`cpux`, `cpu64x`) takes the time buckets from the correctly
rounded float32 log (the float64 log rounded to float32), the card's rule,
in place of torch's float32 log on the CPU; `cpu64` keeps the CPU's. `--census` counts,
over the first batch's live (query, key) pairs, the time buckets that the
card's and the CPU's float32 log put on either side of a boundary, against
the bucket of the correctly rounded float32 log.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import sys

import torch

from mygenerativerecommenders_tpu_torch.cli import train as cli_train
from mygenerativerecommenders_tpu_torch.configs import resolve
from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
from mygenerativerecommenders_tpu_torch.models import hstu
from mygenerativerecommenders_tpu_torch.ops import hstu_attention as hstu_ops
from mygenerativerecommenders_tpu_torch.models.model import build_model
from mygenerativerecommenders_tpu_torch.ops.hstu_attention import (
    bucketize_timedelta,
    next_timestamps,
)
from mygenerativerecommenders_tpu_torch.ops.kernels.hstu_attention import (
    hstu_attention_fused_plain,
)
from mygenerativerecommenders_tpu_torch.train.task_retrieval import make_loss_fn
from mygenerativerecommenders_tpu_torch.utils.features import seq_features_from_batch

LAYOUTS = {"2d": [], "local": ["model.embedding.kind=local", "model.embedding.num_shards=1"]}


@contextlib.contextmanager
def float64_casts():
    """`Tensor.float()` gives float64 inside the block: the port's casts to
    float32 (attention, LayerNorm, the model's output) keep a float64 run's
    precision."""
    cast = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.double()
    try:
        yield
    finally:
        torch.Tensor.float = cast


def exact_buckets(delta: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """The bucket rule with the correctly rounded float32 log."""
    mag = torch.clamp(delta.abs().double(), min=1.0)
    x = torch.log(mag).to(torch.float32) / torch.tensor(0.301, dtype=torch.float32,
                                                         device=delta.device)
    return torch.clamp(x.to(torch.int32), 0, num_buckets)


@contextlib.contextmanager
def correctly_rounded_buckets():
    """The plain attention's time buckets by `exact_buckets` inside the block."""
    rule = hstu_ops.bucketize_timedelta
    hstu_ops.bucketize_timedelta = exact_buckets
    try:
        yield
    finally:
        hstu_ops.bucketize_timedelta = rule


@contextlib.contextmanager
def plain_attention():
    """The HSTU blocks' attention through its plain version inside the block."""
    kernel = hstu.hstu_attention_fused

    def plain(q, k, v, ts, pos_w, ts_w, max_len, num_buckets, lengths=None,
              seg_positions=None):
        if lengths is None:
            lengths = torch.full((q.shape[0],), q.shape[1], dtype=torch.int32, device=q.device)
        return hstu_attention_fused_plain(q, k, v, ts, pos_w, ts_w, max_len, num_buckets,
                                          lengths, seg_positions)

    hstu.hstu_attention_fused = plain
    try:
        yield
    finally:
        hstu.hstu_attention_fused = kernel


def first_batch(items: int, rows: int, layout: str = "local"):
    """(cfg, data, the first train batch's first `rows` rows on the CPU)."""
    cfg = cli_train.parse_args([
        "experiment=synthetic-large-vocab-100m", f"data.expected_max_item_id={items}",
        f"data.expected_num_unique_items={items}", "model.loss.dense_catalog_negatives=false",
        *LAYOUTS[layout]])
    data = RecoData(cfg.data, seed=cfg.trainer.seed)
    resolve(cfg, data.max_item_id)
    batch = {k: torch.as_tensor(v[:rows]) for k, v in next(iter(data.loader("train"))).items()}
    return cfg, data, batch


def census(items: int, rows: int) -> str:
    """Buckets of the first batch's live pairs by the card's and the CPU's
    float32 log, against the correctly rounded one's (float64 log rounded to
    float32, then the IEEE division)."""
    cfg, _, batch = first_batch(items, rows)
    seq, _, _ = seq_features_from_batch(batch, cfg.model.gr_output_length + 1)
    ts = seq.past_payloads["timestamps"]
    delta = next_timestamps(ts)[:, :, None] - ts[:, None, :]
    n = ts.shape[1]
    live = (torch.arange(n)[None, :, None] >= torch.arange(n)[None, None, :]) & (
        torch.arange(n)[None, None, :] < seq.past_lengths[:, None, None].long() + 1)
    buckets = cfg.model.encoder.num_time_buckets
    cpu = bucketize_timedelta(delta, buckets)
    card = bucketize_timedelta(delta.cuda(), buckets).cpu()
    exact = exact_buckets(delta, buckets)
    off = (cpu != exact) & live
    return (f"{int(live.sum())} live pairs: card != cpu {int(((card != cpu) & live).sum())}, "
            f"card != correctly rounded {int(((card != exact) & live).sum())}, cpu != "
            f"correctly rounded {int(off.sum())} (deltas {delta[off][:4].tolist()}: cpu buckets "
            f"{cpu[off][:4].tolist()}, correctly rounded {exact[off][:4].tolist()})")


def step_grads(items: int, rows: int, layout: str, device: str):
    """(loss, {name: gradient on the CPU}) of one step; device "cpu64": the
    CPU in float64; "cudaplain": the card with the attention's plain version."""
    exact = device in ("cpux", "cpu64x")
    wide = device.startswith("cpu64")
    plain = device == "cudaplain"
    device = "cuda" if plain else "cpu" if device.startswith("cpu") else device
    cfg, data, batch = first_batch(items, rows, layout)
    batch = {k: v.to(device) for k, v in batch.items()}
    n = batch["ids"].shape[1] + cfg.model.gr_output_length + 1
    offsets = torch.randint(0, len(data.all_item_ids), (rows, n - 1, cfg.model.loss.num_to_sample),
                            generator=torch.Generator().manual_seed(3), dtype=torch.int32)
    model = build_model(cfg, device=device, seed=99)  # eval mode: dropout off
    if wide:
        model.double()
        model.compute_dtype = torch.float64
    with contextlib.ExitStack() as stack:
        if wide:
            stack.enter_context(float64_casts())
        if plain:
            stack.enter_context(plain_attention())
        if exact:
            stack.enter_context(correctly_rounded_buckets())
        loss = make_loss_fn(model, cfg, data.all_item_ids)(batch, neg_offsets=offsets.to(device))
        loss.backward()
    return loss.item(), {k: p.grad.detach().cpu() for k, p in model.named_parameters()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--items", type=int, default=250_000)
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--devices", default="cuda,cpu")
    ap.add_argument("--layouts", default=",".join(LAYOUTS))
    ap.add_argument("--census", action="store_true")
    args = ap.parse_args(argv)
    devices = args.devices.split(",")
    if any(d.startswith("cuda") for d in devices) and not torch.cuda.is_available():
        print("gather_step_gap: no CUDA device (pass --devices cpu,cpu)", file=sys.stderr)
        return 2
    if args.census:
        print(f"time buckets of the first batch's {args.rows} rows: "
              + census(args.items, args.rows))
    runs = {}
    for layout in args.layouts.split(","):
        for i, device in enumerate(devices):
            runs[(layout, f"{device}{i}")] = step_grads(args.items, args.rows, layout, device)
    for a, b in itertools.combinations(runs, 2):
        (la, ga), (lb, gb) = runs[a], runs[b]
        parts = []
        for name, want in gb.items():
            got = ga[name][: want.shape[0]]  # the 2-D table's pad rows past the local one's
            want = want[: got.shape[0]]
            scale = float(want.abs().max()) or 1.0
            parts.append((float((got.double() - want.double()).abs().max()) / scale, name))
        worst = ", ".join(f"{name} {gap:.3e}" for gap, name in sorted(parts, reverse=True)[:4])
        print(f"{a} vs {b}: loss {la:.7f} vs {lb:.7f}; largest gaps: {worst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
