"""The count and the dense-negative lse pair against their least time
(roofline/lse.py) over the traced steps, by kernel name."""

from gpubench.profiling import kernel_seconds
from gpubench.roofline.lse import step_s


def read(ctx):
    summary, steps = ctx.get("summary"), ctx.get("steps")
    if not summary or not steps:
        return None
    spent = kernel_seconds(summary, "count_offsets_kernel", "dense_neg_lse", "round_dcat_kernel")
    if spent <= 0:
        return None
    d = ctx["dims"]
    least = sum(step_s(s["drawn_rows"], ctx["catalog_size"], d.num_negatives, d.d) for s in steps)
    return 100.0 * least / spent
