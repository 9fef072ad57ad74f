"""Host-side training controllers: plateau LR + early stopping.

The port's own copy of mygenerativerecommenders_tpu/train/controllers.py
(plain Python, no array library).

Replaces torch.optim.lr_scheduler.ReduceLROnPlateau (stepped manually on
the last batch with the monitored val metric, retrieval.py:148-155) and
Lightning's EarlyStopping callback (configs/callbacks/early_stopping.yaml).
Both use relative-threshold comparison like torch's default
threshold_mode='rel'.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PlateauLRController:
    """ReduceLROnPlateau: lr *= factor after `patience` non-improving evals."""

    lr: float
    mode: str = "max"
    factor: float = 0.1
    patience: int = 10
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: float = field(default=None, init=False)  # type: ignore[assignment]
    num_bad: int = field(default=0, init=False)

    def _is_better(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "max":
            return value > self.best * (1.0 + self.threshold)
        return value < self.best * (1.0 - self.threshold)

    def step(self, value: float) -> float:
        if self._is_better(value):
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, state: dict) -> None:
        self.lr = state["lr"]
        self.best = state["best"]
        self.num_bad = state["num_bad"]


@dataclass
class EarlyStopping:
    """Stop after `patience` evals without improvement; guards non-finite."""

    mode: str = "max"
    patience: int = 20
    min_delta: float = 0.0
    check_finite: bool = True
    best: float = field(default=None, init=False)  # type: ignore[assignment]
    num_bad: int = field(default=0, init=False)
    stopped: bool = field(default=False, init=False)

    def step(self, value: float) -> bool:
        """Returns True if training should stop."""
        import math

        if self.check_finite and not math.isfinite(value):
            self.stopped = True
            return True
        improved = (
            self.best is None
            or (self.mode == "max" and value > self.best + self.min_delta)
            or (self.mode == "min" and value < self.best - self.min_delta)
        )
        if improved:
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad >= self.patience:
                self.stopped = True
        return self.stopped

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad": self.num_bad, "stopped": self.stopped}

    def load_state_dict(self, state: dict) -> None:
        self.best = state["best"]
        self.num_bad = state["num_bad"]
        self.stopped = state["stopped"]
