"""Eval entry point: the test metrics of a checkpoint. Port of
mygenerativerecommenders_tpu/cli/eval.py; `trainer.ckpt_path=<best.pt |
last.pt | a state_dict .pt>` is required."""

from __future__ import annotations

import sys
from typing import Optional

from mygenerativerecommenders_tpu_torch.cli.train import parse_args
from mygenerativerecommenders_tpu_torch.train.driver import Trainer
from mygenerativerecommenders_tpu_torch.train.loggers import get_logger

log = get_logger(__name__)


def main(argv: Optional[list[str]] = None):
    cfg = parse_args(argv if argv is not None else sys.argv[1:])
    if not cfg.trainer.ckpt_path:
        raise ValueError("trainer.ckpt_path=<checkpoint .pt> is required for eval")
    results = Trainer(cfg).test(cfg.trainer.ckpt_path)
    log.info(f"test: {results}")
    return results


if __name__ == "__main__":
    main()
