"""Grid hyper-parameter sweep over any dotted config keys.

Port of mygenerativerecommenders_tpu/cli/sweep.py: a cartesian grid over
the dotted-override syntax, each point one run of the port's
`cli.train.main`, which returns the monitored metric. Usage:

  python -m mygenerativerecommenders_tpu_torch.cli.sweep experiment=ml-1m-hstu \\
      sweep.optimizer1.lr=1e-3,5e-4 sweep.model.encoder.num_blocks=2,4 \\
      trainer.max_epochs=30

`sweep.<dotted.key>=v1,v2,...` arguments are the grid's axes; every other
argument goes to each run unchanged. Each point trains in its own
`<output_dir>/sweep_<i>` directory; `<output_dir>/sweep_results.csv` gets a
row as each run ends, and the best row (by `trainer.mode` on
`trainer.monitor`, as the early-stopping controller reads it) is logged last
and returned.
"""

from __future__ import annotations

import csv
import itertools
import os
import sys
from typing import Dict, List, Optional, Tuple

from mygenerativerecommenders_tpu_torch.cli.train import main as train_main
from mygenerativerecommenders_tpu_torch.cli.train import parse_args
from mygenerativerecommenders_tpu_torch.train.loggers import get_logger

log = get_logger(__name__)


def split_sweep_args(argv: List[str]) -> Tuple[Dict[str, List[str]], List[str]]:
    """-> (the grid's axes in the order given, the pass-through arguments)."""
    grid: Dict[str, List[str]] = {}
    fixed: List[str] = []
    for arg in argv:
        if arg.startswith("sweep."):
            key, _, values = arg[len("sweep."):].partition("=")
            if not values:
                raise ValueError(f"sweep axis needs values: {arg!r}")
            grid[key] = values.split(",")
        else:
            fixed.append(arg)
    if not grid:
        raise ValueError("no sweep axes given — add at least one sweep.<dotted.key>=v1,v2")
    return grid, fixed


def main(argv: Optional[List[str]] = None) -> dict:
    grid, fixed = split_sweep_args(list(sys.argv[1:] if argv is None else argv))
    base_cfg = parse_args(list(fixed))  # checks the pass-through overrides
    out_dir = base_cfg.trainer.output_dir
    mode = base_cfg.trainer.mode
    keys = list(grid)

    os.makedirs(out_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, "sweep_results.csv")
    rows = []
    # a row is flushed as its run ends: a run that crashes loses no finished one
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["run", *keys, "metric"])
        writer.writeheader()
        for i, combo in enumerate(itertools.product(*grid.values())):
            overrides = fixed + [f"{k}={v}" for k, v in zip(keys, combo)] + [
                f"trainer.output_dir={os.path.join(out_dir, f'sweep_{i}')}"
            ]
            log.info(f"sweep run {i}: {dict(zip(keys, combo))}")
            metric = train_main(overrides)
            row = {**dict(zip(keys, combo)), "metric": metric, "run": i}
            rows.append(row)
            writer.writerow(row)
            f.flush()
            log.info(f"sweep run {i}: {base_cfg.trainer.monitor} = {metric:.6f}")

    best = (max if mode == "max" else min)(rows, key=lambda r: r["metric"])
    log.info(f"wrote {csv_path}")
    log.info(
        f"best ({base_cfg.trainer.monitor}, mode={mode}): "
        f"run {best['run']} {({k: best[k] for k in keys})} -> {best['metric']:.6f}"
    )
    return best


if __name__ == "__main__":
    main()
