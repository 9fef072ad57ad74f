#!/usr/bin/env python3
"""The readings that the limits of gpubench/limits/ were set from, on the
card at a training cell's own size (the benchmark's runs never run this):

    python3 gpubench/control.py --workload <name> --seeds 11,12,13

For each seed it makes the cell's inputs and weights as a run does, takes
the batches that a run checks (drivers/train.py:checked_batches), and reads
each compared number for
- the control: the plain reference computed with TF32 matmuls (the nearest
  precision below the configuration's float32), in the program's place;
- a fault planted in the reference in the program's place: half of each
  batch left out of the mean. (A step that leaves its state unchanged reads
  1 on `change_gap` by its definition and needs no run.)
One JSON line a seed.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpubench import bench  # noqa: E402

bench.pin_caches()


def _tf32(on: bool) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def train_readings(cell, seed: int, device: str) -> dict:
    import gc
    import tempfile

    import torch

    from gpubench import traffic, weights
    from gpubench.drivers import train
    from gpubench.reference.hstu import follow_training
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    sizes = cell.config["sizes"]
    dims = train.dims_of(cell.config)
    cfg = train.program_config(cell.config, seed, device, tempfile.mkdtemp(prefix="gpubench-"))
    hist = traffic.histories(cell.traffic, sizes["num_items"], sizes["max_item_id"], seed)
    trainer = Trainer(cfg, data=train.program_data(cfg, hist, seed))
    shapes = weights.shapes_of(trainer.model)
    loader = trainer._loader("train", packed=trainer._packed)
    hosts = train.checked_batches(loader)
    del trainer, loader
    gc.collect()
    torch.cuda.empty_cache()
    packed, opt = bool(sizes["pack_sequences"]), train.optimizer_of(cell.config)

    def follow(tf32: bool, half: bool) -> dict:
        _tf32(tf32)
        try:
            return follow_training(weights.make(shapes, seed, device), dims, hosts, hist.catalog,
                                   seed, opt, packed, half_batch=half)
        finally:
            _tf32(False)

    base = follow(False, False)
    again = follow(False, False)
    return {"seed": seed,
            "reference_twice": train._numbers(again, base),
            "control_tf32": train._numbers(follow(True, False), base),
            "fault_half_batch": train._numbers(follow(False, True), base)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("control.py reads on a CUDA card", file=sys.stderr)
        return 2
    cell = bench.Cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        line = train_readings(cell, seed, "cuda")
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
