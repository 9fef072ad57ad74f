"""Train entry point, and the command-line config parsing shared by the
port's entry points.

Port of mygenerativerecommenders_tpu/cli/train.py. Usage:

  python -m mygenerativerecommenders_tpu_torch.cli.train experiment=synthetic-hstu \\
      trainer.max_epochs=50 model.encoder.num_blocks=4

The first `experiment=<preset>` picks the preset (default ml-1m-hstu) and the
remaining dotted overrides are applied on top. Training runs on the card
unless `trainer.device=cpu` is passed; without a card and without that
override it raises. Data parallel over processes, one card each:

  torchrun --nproc_per_node=N -m mygenerativerecommenders_tpu_torch.cli.train \
      experiment=synthetic-hstu trainer.distributed=true

(parallel/process_group.py; with `trainer.device=cpu` the ranks run on the
CPU over gloo). The world is data x model x col x sp: a sharded kind's
`model.embedding.num_shards` or `model.encoder.tp_shards` sizes the model
axis, sharded_2d's `col_shards` the col axis and `model.encoder.sp_shards`
the sp axis (the ring's sequence shards, one a rank), so N must be a
multiple of their product (4 processes of `num_shards=2 tp_shards=2` train 2
data indices of a 2-rank model group each; 2 processes of
`model.encoder.sp_shards=2` run one ring over both).
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
    from mygenerativerecommenders_tpu_torch.parallel.process_group import shutdown
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer
    from mygenerativerecommenders_tpu_torch.train.loggers import get_logger

    log = get_logger(__name__)
    cfg = parse_args(argv if argv is not None else sys.argv[1:])
    log.info(f"config: {json.dumps(to_dict(cfg), default=str)}")
    trainer = Trainer(cfg)
    results = trainer.fit()
    test_results = trainer.test()
    trainer.writer.close()
    log.info(f"test: {test_results}")
    if trainer.dp is not None:
        shutdown()
    monitor_key = cfg.trainer.monitor.split("/", 1)[-1]
    return results.get(monitor_key, 0.0)


if __name__ == "__main__":
    main()
