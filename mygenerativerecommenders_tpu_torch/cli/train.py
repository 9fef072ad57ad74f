"""Train entry point, and the command-line config parsing shared by the
port's entry points.

Port of mygenerativerecommenders_tpu/cli/train.py. Usage:

  python -m mygenerativerecommenders_tpu_torch.cli.train experiment=synthetic-hstu \\
      trainer.max_epochs=50 model.encoder.num_blocks=4

The first `experiment=<preset>` picks the preset (default ml-1m-hstu) and the
remaining dotted overrides are applied on top. Training runs on the card
unless `trainer.device=cpu` is passed; without a card and without that
override it raises.
"""

from __future__ import annotations

import json
import sys
from typing import Optional

from mygenerativerecommenders_tpu_torch.configs import Config, apply_overrides, to_dict
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


def main(argv: Optional[list[str]] = None) -> float:
    # imported here: cli/serve.py takes parse_args from this module and
    # needs none of the trainer
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer
    from mygenerativerecommenders_tpu_torch.train.loggers import get_logger

    log = get_logger(__name__)
    cfg = parse_args(argv if argv is not None else sys.argv[1:])
    log.info(f"config: {json.dumps(to_dict(cfg), default=str)}")
    trainer = Trainer(cfg)
    results = trainer.fit()
    test_results = trainer.test()
    log.info(f"test: {test_results}")
    monitor_key = cfg.trainer.monitor.split("/", 1)[-1]
    return results.get(monitor_key, 0.0)


if __name__ == "__main__":
    main()
