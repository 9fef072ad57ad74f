"""Predict entry point: every test example's top-k, written beside its row.

Port of mygenerativerecommenders_tpu/cli/predict.py. Usage:

  python -m mygenerativerecommenders_tpu_torch.cli.predict experiment=<preset> \\
      trainer.ckpt_path=<best.pt | model.pt | reference.ckpt | params.npz>

writes `<trainer.output_dir>/<experiment>/predictions.csv`: the sequence CSV
(one row per user, in its order) with `top_k_ids` and `top_k_scores`
appended as Python-list strings, written with `csv` as pandas writes it.
Without `trainer.ckpt_path` the model keeps its seeded initial weights.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

from mygenerativerecommenders_tpu_torch.cli.train import parse_args
from mygenerativerecommenders_tpu_torch.data.preprocessor import write_csv
from mygenerativerecommenders_tpu_torch.train.driver import Trainer
from mygenerativerecommenders_tpu_torch.train.loggers import get_logger

log = get_logger(__name__)


def main(argv: Optional[list[str]] = None) -> str:
    cfg = parse_args(argv if argv is not None else sys.argv[1:])
    trainer = Trainer(cfg)
    if cfg.trainer.ckpt_path:
        trainer.load_weights(cfg.trainer.ckpt_path)
    predictions = trainer.predict()
    header, rows = trainer.data.sequence_table()
    if len(rows) != len(predictions["top_k_ids"]):
        raise ValueError(
            f"{len(predictions['top_k_ids'])} predictions for {len(rows)} sequence rows"
        )
    if trainer.dp is not None and trainer.dp.world_rank != 0:
        return ""  # every rank gathered the same rows; rank 0 writes them
    columns = list(predictions)
    for row, *values in zip(rows, *(predictions[c] for c in columns)):
        row.extend(str(v) for v in values)
    out = os.path.join(trainer.out_dir, "predictions.csv")
    os.makedirs(trainer.out_dir, exist_ok=True)
    write_csv(out, header + columns, rows)
    log.info(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
