#!/usr/bin/env python3
"""One run of one cell of BENCHMARK.json on the card this process sees:

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (data and weights from the seed, the cell's shapes warmed up) counts
as `setup_s`; the window then measures for `--seconds`; then the plain
reference judges what the window's path produced. The last line of standard
output is the result: the end-to-end metrics, or with `--trace 1` the
per-layer ones. Without a CUDA card, or with fewer cards than the cell asks
for, it exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpubench import bench  # noqa: E402

bench.pin_caches()


def card_info() -> dict:
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip().splitlines()[0]
        return dict(zip(("name", "power_limit", "max_sm_clock"), [x.strip() for x in line.split(",")]))
    except (OSError, IndexError, subprocess.SubprocessError):
        return {"name": "unread"}


def result_of(cell: bench.Cell, out: dict, trace: bool):
    """-> (the result line's object, the checks: each compared number and its limit)."""
    import torch

    if trace:
        ctx = out["ctx"]
        values = {m["name"]: bench.reader(m["name"], cell.root)(ctx) for m in cell.per_layer}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.per_layer if values[m["name"]] is not None}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(out["peak_bytes"])}
    result = {"correct": False, "attempted": int(out["attempted"]), "failed": int(out["failed"]),
              "metrics": metrics, "device": device}
    summary = out.get("summary")
    if trace and summary:
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    numbers = out.get("numbers", {})
    result["correct"] = (bench.passed(numbers, cell.limits) and out["attempted"] > 0
                         and out["failed"] == 0)
    return result, bench.checks_line(numbers, cell.limits)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = bench.Cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = importlib.import_module("gpubench.drivers." + cell.traffic["driver"])
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), T_START)
    result, checks = result_of(cell, out, bool(args.trace))
    print(json.dumps({"card": card_info(), "counters": out.get("counters", {})}), flush=True)
    found = bench.forbidden_modules()
    if found:
        print(f"modules that no run may hold were loaded: {found}", file=sys.stderr)
        return 3
    bench.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
