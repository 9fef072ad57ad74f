"""Metrics writer (CSV + JSONL under the run's output directory, and the
optional TensorBoard and MLflow channels) and the console logger.

Port of `MetricsWriter`, `MlflowFileWriter` and `RankedLogger`
(mygenerativerecommenders_tpu/train/loggers.py:110-165, 50-107, 26-50).
`trainer.tensorboard` writes each row's numbers as scalars under
`<out_dir>/tb` through `tensorboardX` (JAX's choice) or, where that does not
import, `torch.utils.tensorboard`; where neither imports it raises a
`ValueError` naming them (the JAX writer then writes nothing, silently).
`trainer.mlflow_dir` writes MLflow's file store with no mlflow dependency,
in JAX's layout.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import sys
import time
import uuid
from typing import Dict, Optional


class MlflowFileWriter:
    """MLflow file-store tracking (the reference's optional MLflow channel,
    configs/logger/mlflow.yaml) with no dependency: the
    `<tracking_dir>/0/<run_id>/` layout that MLflow's UI and client read, a
    meta.yaml for the experiment and the run, one file per param, and per
    metric an append-only file of "<timestamp_ms> <value> <step>" lines."""

    def __init__(self, tracking_dir: str, experiment: str, run_name: str):
        self.exp_dir = os.path.join(tracking_dir, "0")
        self.run_id = uuid.uuid4().hex
        self.run_dir = os.path.join(self.exp_dir, self.run_id)
        for sub in ("metrics", "params", "tags"):
            os.makedirs(os.path.join(self.run_dir, sub), exist_ok=True)
        if not os.path.exists(os.path.join(self.exp_dir, "meta.yaml")):
            with open(os.path.join(self.exp_dir, "meta.yaml"), "w") as f:
                f.write(
                    f"artifact_location: {self.exp_dir}\n"
                    f"experiment_id: '0'\nlifecycle_stage: active\n"
                    f"name: {experiment}\n"
                )
        start = int(time.time() * 1000)
        with open(os.path.join(self.run_dir, "meta.yaml"), "w") as f:
            f.write(
                f"artifact_uri: {os.path.join(self.run_dir, 'artifacts')}\n"
                f"experiment_id: '0'\nlifecycle_stage: active\n"
                f"run_id: {self.run_id}\nrun_name: {run_name}\n"
                f"run_uuid: {self.run_id}\nstart_time: {start}\n"
                f"status: 1\nuser_id: {os.environ.get('USER', 'unknown')}\n"
            )
        with open(os.path.join(self.run_dir, "tags", "mlflow.runName"), "w") as f:
            f.write(run_name)

    def log_params(self, params: Dict[str, object]) -> None:
        for k, v in params.items():
            with open(os.path.join(self.run_dir, "params", k.replace("/", ".")), "w") as f:
                f.write(str(v))

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        ts = int(time.time() * 1000)
        for k, v in metrics.items():
            if not isinstance(v, (int, float)):
                continue
            with open(os.path.join(self.run_dir, "metrics", k.replace("/", ".")), "a") as f:
                f.write(f"{ts} {v} {step}\n")


def tensorboard_writer(log_dir: str):
    """A TensorBoard `SummaryWriter` on `log_dir`: tensorboardX's, else
    torch.utils.tensorboard's; a ValueError where neither imports."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            raise ValueError(
                "trainer.tensorboard=true needs the tensorboardX package or the tensorboard "
                "package (for torch.utils.tensorboard), and neither imports here; install "
                "one or set trainer.tensorboard=false"
            ) from None
    return SummaryWriter(log_dir)


class MetricsWriter:
    """Appends metric dicts to metrics.csv and metrics.jsonl under out_dir,
    and to the TensorBoard and MLflow channels where they are on.
    `enabled=False` (a data-parallel rank but 0, as JAX's `is_main_process`
    gate, :113) writes nothing."""

    def __init__(self, out_dir: str, enable_tensorboard: bool = False, mlflow_dir: str = "",
                 experiment: str = "default", enabled: bool = True):
        self.out_dir = out_dir
        self.enabled = enabled
        self._csv_path = os.path.join(out_dir, "metrics.csv")
        self._jsonl_path = os.path.join(out_dir, "metrics.jsonl")
        self._csv_fields: Optional[list] = None
        self._tb = self.mlflow = None
        if not enabled:
            return
        os.makedirs(out_dir, exist_ok=True)
        self._tb = tensorboard_writer(os.path.join(out_dir, "tb")) if enable_tensorboard else None
        self.mlflow = MlflowFileWriter(
            mlflow_dir, experiment, run_name=os.path.basename(out_dir)
        ) if mlflow_dir else None

    def log(self, metrics: Dict[str, float], step: int, epoch: int) -> None:
        if not self.enabled:
            return
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
        if self._tb is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)
            self._tb.flush()  # a row is on disk when log returns, as the CSV's
        if self.mlflow is not None:
            self.mlflow.log_metrics(metrics, step)

    def close(self) -> None:
        """Flush and close the TensorBoard channel (the files stay readable)."""
        if self._tb is not None:
            self._tb.close()
            self._tb = None


def _rank_zero(record: logging.LogRecord) -> bool:
    """Drop a record on every data-parallel rank but 0."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def get_logger(name: str) -> logging.Logger:
    """A console logger writing `[time][LEVEL] message` lines to stdout, as
    the JAX package's `RankedLogger` does: on rank 0 alone under a
    process group (JAX :21-45; one process: no rank prefix)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("[%(asctime)s][%(levelname)s] %(message)s"))
        handler.addFilter(_rank_zero)
        logger.addHandler(handler)
        logger.propagate = False
    logger.setLevel(logging.INFO)
    return logger
