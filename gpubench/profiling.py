"""The traced slice of a `--trace 1` run: torch.profiler over a stretch of the
window, reduced to what the per-layer readers take.

busy_s is the union of the device's operation intervals (kernels, copies,
sets) inside the slice and window_s the slice's length on the host clock;
the device's idle share is 1 - busy_s / window_s (the arithmetic of the
port's chip_smoke.py `profile_device`, taken over a window rather than a
median step). Kernel seconds are summed by name. The breakdown lists the
operations that took most time and the longest idle gaps, each named by
the host's innermost operation or annotation under the gap's middle.
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, List, Tuple

import torch


class Slice:
    """with Slice() as s: ...; then s.summary() (see `summarize`), reduced
    once the measured window is over. Enter and exit it on the thread that
    launches the traced work."""

    def __enter__(self) -> "Slice":
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.stop()

    def summary(self) -> dict:
        return summarize(self._prof.events(), self.window_s)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def summarize(events, window_s: float) -> dict:
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                device.append((e.time_range.start, e.time_range.end, e.name))
        else:
            host.append((e.time_range.start, e.time_range.end, e.name))
    by_name: Dict[str, float] = collections.defaultdict(float)
    counts: Dict[str, int] = collections.Counter()
    for start, end, name in device:
        by_name[name] += (end - start) * 1e-6
        counts[name] += 1
    busy = _merge([(s, e) for s, e, _ in device])
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps = []
    if busy:
        lo = min([s for s, _, _ in host] + [busy[0][0]])
        edges = [lo] + [x for pair in busy for x in pair]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((a, b))
    host.sort()
    starts = [s for s, _, _ in host]
    named = collections.defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        under = [h for h in host[max(0, i - 2000):i] if h[1] >= mid]
        name = max(under, key=lambda h: h[0])[2] if under else "host: no traced operation"
        named[name] += (b - a) * 1e-6
    return {
        "window_s": window_s,
        "busy_s": busy_s,
        "kernel_s": dict(by_name),
        "kernel_count": dict(counts),
        "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda t: -t[1])[:10],
        "idle_gaps": sorted(([n, s] for n, s in named.items()), key=lambda t: -t[1])[:10],
    }


def kernel_seconds(summary: dict, *needles: str) -> float:
    """Device seconds of the kernels whose name holds any of `needles`
    (case-insensitive)."""
    low = [n.lower() for n in needles]
    return sum(s for name, s in summary["kernel_s"].items() if any(n in name.lower() for n in low))
