"""1 - the union of the device's operation intervals over the traced slice
of the window (gpubench/profiling.py). Read for `idle_share.<suffix>`."""


def read(ctx):
    s = ctx.get("summary")
    if not s or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
