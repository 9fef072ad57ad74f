"""The whole training step's share of the card's peak: the least time of
each step the window completed outside the traced slice (roofline/step.py),
summed, over that part of the window's host-clock time."""

from gpubench.roofline.step import train_step_s


def read(ctx):
    steps, seconds = ctx.get("window_steps"), ctx.get("window_s")
    if not steps or not seconds:
        return None
    return 100.0 * sum(train_step_s(s, ctx["dims"], ctx["params"]) for s in steps) / seconds
