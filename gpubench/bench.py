"""What every run shares: the caches' fixed places inside the checkout,
finding a cell's files by name, the card check, the import guard, the
per-layer readers and the result line."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".gpubench_cache")
# top-level module names that no run may hold (compared whole: the port's
# name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "mygenerativerecommenders_tpu")


def pin_caches() -> None:
    """Every build and kernel cache at a fixed directory of the checkout (the
    port's nvcc builds already live in its package's `_build/`)."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


class Cell:
    """One entry of BENCHMARK.json's `workloads`, with its configuration,
    traffic mix, limits and metrics, each found by name."""

    def __init__(self, name: str, root: str = ROOT):
        self.root = root
        spec = load_json(root, "BENCHMARK.json")
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.spec = spec
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(root, self.config_entry["file"])
        here = os.path.join(root, "gpubench")
        self.traffic = load_json(here, "traffic", self.entry["traffic"] + ".json")
        self.limits = load_json(here, "limits", name + ".json")
        self.end_to_end = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in spec["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)
        ]
        self.chips = int(self.entry["chips"])


def reader(metric: str, root: str = ROOT) -> Callable[[dict], Optional[float]]:
    """gpubench/metrics/<metric>.py's `read(ctx)`, or where that file is not
    there, that of the name without its last `.suffix` (`idle_share.train`
    is read by `idle_share.py`)."""
    folder = os.path.join(root, "gpubench", "metrics")
    path = os.path.join(folder, metric + ".py")
    if not os.path.isfile(path) and "." in metric:
        path = os.path.join(folder, metric.rsplit(".", 1)[0] + ".py")
    spec = importlib.util.spec_from_file_location("gpubench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> List[str]:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def checks_line(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def passed(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(k in numbers and numbers[k] == numbers[k] and numbers[k] <= lim
               for k, lim in limits.items())


def emit(result: dict, checks: Dict[str, dict]) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, and the result as the last line of standard output with
    the checks as its last key."""
    sys.stdout.flush()
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}), flush=True)
