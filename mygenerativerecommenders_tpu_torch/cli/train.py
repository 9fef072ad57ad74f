"""Command-line config parsing shared by the port's entry points.

`parse_args` is the port's copy of `mygenerativerecommenders_tpu.cli.train
.parse_args`: the first `experiment=<preset>` picks the preset (default
ml-1m-hstu) and the remaining dotted overrides are applied on top. The
trainer itself comes with the training slice (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from mygenerativerecommenders_tpu_torch.configs import Config, apply_overrides
from mygenerativerecommenders_tpu_torch.configs.presets import get_preset


def parse_args(argv: list[str]) -> Config:
    preset = "ml-1m-hstu"
    overrides = []
    for arg in argv:
        if arg.startswith("experiment="):
            preset = arg.split("=", 1)[1]
        else:
            overrides.append(arg)
    cfg = get_preset(preset)
    apply_overrides(cfg, overrides)
    return cfg
