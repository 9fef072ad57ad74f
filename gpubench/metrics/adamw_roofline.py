"""torch's fused AdamW kernels against their least time (roofline/adamw.py)
over the traced steps."""

from gpubench.profiling import kernel_seconds
from gpubench.roofline.adamw import step_s


def read(ctx):
    summary, steps = ctx.get("summary"), ctx.get("steps")
    if not summary or not steps:
        return None
    spent = kernel_seconds(summary, "adam")
    if spent <= 0:
        return None
    return 100.0 * len(steps) * step_s(ctx["params"]) / spent
