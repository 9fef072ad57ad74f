"""The attention forward kernel's share of its least time over the traced
training steps (every block's call). Read for `attn_fwd_roofline.<suffix>`."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "gpubench_metric__attention", os.path.join(os.path.dirname(__file__), "_attention.py"))
_attention = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_attention)


def read(ctx):
    return _attention.share(ctx, "steps", backward=False)
