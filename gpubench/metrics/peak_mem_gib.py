"""torch.cuda.max_memory_allocated() over set-up and the window, in GiB.
Read for `peak_mem_gib.<suffix>`."""


def read(ctx):
    if not ctx.get("peak_bytes"):
        return None
    return ctx["peak_bytes"] / 2 ** 30
