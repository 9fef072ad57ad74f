"""Shared by the attention readers: the traced work's attention calls (one
a block), their least time and the kernels' device time by name."""

from gpubench.profiling import kernel_seconds
from gpubench.roofline.attention import backward_s, forward_s


def share(ctx, work_key: str, backward: bool):
    summary, work = ctx.get("summary"), ctx.get(work_key)
    if not summary or not work:
        return None
    spent = kernel_seconds(summary, "hstu_attention_bwd" if backward else "hstu_attention_fwd")
    if spent <= 0:
        return None
    d = ctx["dims"]
    calls = [w["attn"] for w in work] * d.blocks
    ts_entries, pos_entries = d.num_buckets + 1, 2 * d.max_len - 1
    least = (backward_s(calls, d.heads, d.dqk, d.dv, ts_entries, pos_entries) if backward
             else forward_s(calls, d.heads, d.dqk, d.dv, ts_entries))
    return 100.0 * least / spent
