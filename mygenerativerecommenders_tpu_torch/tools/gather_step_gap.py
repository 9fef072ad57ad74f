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

`--devices cpu,cpu` compares two CPU runs.
"""

from __future__ import annotations

import argparse
import itertools
import sys

import torch

from mygenerativerecommenders_tpu_torch.cli import train as cli_train
from mygenerativerecommenders_tpu_torch.configs import resolve
from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
from mygenerativerecommenders_tpu_torch.models.model import build_model
from mygenerativerecommenders_tpu_torch.train.task_retrieval import make_loss_fn

LAYOUTS = {"2d": [], "local": ["model.embedding.kind=local", "model.embedding.num_shards=1"]}


def step_grads(items: int, rows: int, layout: str, device: str):
    """(loss, {name: gradient on the CPU}) of one step."""
    cfg = cli_train.parse_args([
        "experiment=synthetic-large-vocab-100m", f"data.expected_max_item_id={items}",
        f"data.expected_num_unique_items={items}", "model.loss.dense_catalog_negatives=false",
        *LAYOUTS[layout]])
    data = RecoData(cfg.data, seed=cfg.trainer.seed)
    resolve(cfg, data.max_item_id)
    batch = {k: torch.as_tensor(v[:rows]).to(device)
             for k, v in next(iter(data.loader("train"))).items()}
    n = batch["ids"].shape[1] + cfg.model.gr_output_length + 1
    offsets = torch.randint(0, len(data.all_item_ids), (rows, n - 1, cfg.model.loss.num_to_sample),
                            generator=torch.Generator().manual_seed(3), dtype=torch.int32)
    model = build_model(cfg, device=device, seed=99)  # eval mode: dropout off
    loss = make_loss_fn(model, cfg, data.all_item_ids)(batch, neg_offsets=offsets.to(device))
    loss.backward()
    return loss.item(), {k: p.grad.detach().cpu() for k, p in model.named_parameters()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--items", type=int, default=250_000)
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--devices", default="cuda,cpu")
    args = ap.parse_args(argv)
    devices = args.devices.split(",")
    if "cuda" in devices and not torch.cuda.is_available():
        print("gather_step_gap: no CUDA device (pass --devices cpu,cpu)", file=sys.stderr)
        return 2
    runs = {}
    for layout in LAYOUTS:
        for i, device in enumerate(devices):
            runs[(layout, f"{device}{i}")] = step_grads(args.items, args.rows, layout, device)
    for a, b in itertools.combinations(runs, 2):
        (la, ga), (lb, gb) = runs[a], runs[b]
        parts = []
        for name, want in gb.items():
            got = ga[name][: want.shape[0]]  # the 2-D table's pad rows past the local one's
            want = want[: got.shape[0]]
            scale = float(want.abs().max()) or 1.0
            parts.append((float((got - want).abs().max()) / scale, name))
        worst = ", ".join(f"{name} {gap:.3e}" for gap, name in sorted(parts, reverse=True)[:4])
        print(f"{a} vs {b}: loss {la:.7f} vs {lb:.7f}; largest gaps: {worst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
