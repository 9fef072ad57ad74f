"""Metrics writer (CSV + JSONL under the run's output directory) and the
console logger.

Port of `MetricsWriter` and `RankedLogger`
(mygenerativerecommenders_tpu/train/loggers.py:110-165, 26-50). The
TensorBoard and MLflow channels are not ported and raise when asked for.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import sys
import time
from typing import Dict, Optional

from mygenerativerecommenders_tpu_torch import not_ported


class MetricsWriter:
    """Appends metric dicts to metrics.csv and metrics.jsonl under out_dir."""

    def __init__(self, out_dir: str, enable_tensorboard: bool = False, mlflow_dir: str = ""):
        if enable_tensorboard:
            raise not_ported("trainer.tensorboard", "Training variants")
        if mlflow_dir:
            raise not_ported("trainer.mlflow_dir (the MLflow file writer)", "Training variants")
        self.out_dir = out_dir
        self._csv_path = os.path.join(out_dir, "metrics.csv")
        self._jsonl_path = os.path.join(out_dir, "metrics.jsonl")
        self._csv_fields: Optional[list] = None
        os.makedirs(out_dir, exist_ok=True)

    def log(self, metrics: Dict[str, float], step: int, epoch: int) -> None:
        row = {"step": step, "epoch": epoch, "time": time.time(), **metrics}
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        # the CSV's columns are those of the first row written
        write_header = self._csv_fields is None and not os.path.exists(self._csv_path)
        if self._csv_fields is None:
            self._csv_fields = list(row.keys())
        with open(self._csv_path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._csv_fields, extrasaction="ignore")
            if write_header:
                writer.writeheader()
            writer.writerow({k: row.get(k, "") for k in self._csv_fields})


def get_logger(name: str) -> logging.Logger:
    """A console logger writing `[time][LEVEL] message` lines to stdout, as
    the JAX package's `RankedLogger` does (one process: no rank prefix)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("[%(asctime)s][%(levelname)s] %(message)s"))
        logger.addHandler(handler)
        logger.propagate = False
    logger.setLevel(logging.INFO)
    return logger
