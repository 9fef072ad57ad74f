"""The trainer: one device, one optimizer step per call.

Port of `Trainer` (mygenerativerecommenders_tpu/train/driver.py:117,
232-297, 492-539, 588-656, 717-830, 832-886, 932-961): model and optimizer
set-up, the epoch loop over the host loader, validation (candidate refresh ->
filtered top-k -> metrics), plateau LR and early stopping keyed on the
monitored metric, best/last checkpoints with resume, CSV/JSONL metric logging,
and seeded randomness: the weights come from `trainer.seed`, dropout draws from the
device's default generator (seeded with `trainer.seed`) and the negatives
from a generator of their own on the device.

It runs on `trainer.device` (default cuda; a machine without a card raises,
it does not carry on on the CPU). The step runs eagerly, so
`trainer.steps_per_call`, a dispatch-amortising knob of the JAX package that
leaves the training stream unchanged, has no effect here. With
`data.pack_sequences` the train batches come packed from data/packing.py, and
`data.pack_eval` (auto: histories of 512 and longer) packs the eval splits
too, one query per segment; both eval paths are exact. With
`model.encoder.sp_shards` > 1 the model's attention is the ring of
parallel/ring_attention.py, whose shards run in turn on this one device: the
JAX trainer's (data, sp) mesh has no counterpart, and packed batches raise
with it, as there. The mesh (`trainer.num_devices` > 1), the multi-process
loader, the ranking task and the profiler hooks raise.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from mygenerativerecommenders_tpu_torch import not_ported
from mygenerativerecommenders_tpu_torch.checkpoint import CheckpointManager
from mygenerativerecommenders_tpu_torch.configs import Config, resolve
from mygenerativerecommenders_tpu_torch.data.dataset import BatchLoader, RecoData
from mygenerativerecommenders_tpu_torch.data.packing import PackedBatchLoader
from mygenerativerecommenders_tpu_torch.models.metrics import retrieval_metrics
from mygenerativerecommenders_tpu_torch.models.model import build_model
from mygenerativerecommenders_tpu_torch.train import task_retrieval
from mygenerativerecommenders_tpu_torch.train.controllers import (
    EarlyStopping,
    PlateauLRController,
)
from mygenerativerecommenders_tpu_torch.train.loggers import MetricsWriter, get_logger
from mygenerativerecommenders_tpu_torch.train.optimizers import build_optimizer

log = get_logger(__name__)

Loader = Union[BatchLoader, PackedBatchLoader]


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"trainer.device={name} but no CUDA device is available; pass "
            "trainer.device=cpu to run the kernels' plain versions on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"trainer.device must be cuda or cpu, got {name!r}")
    return device


class Trainer:
    def __init__(self, cfg: Config, data: Optional[RecoData] = None):
        self.cfg = cfg
        t = cfg.trainer
        self.device = resolve_device(t.device)
        if t.distributed or t.num_devices > 1:
            raise not_ported("trainer.distributed / num_devices > 1", "Distributed")
        if t.profiler:
            raise not_ported("trainer.profiler", "Training variants")
        if t.async_checkpoint:
            raise not_ported("trainer.async_checkpoint", "Training variants")
        if cfg.scheduler1.kind not in ("plateau", "none"):
            raise not_ported(f"scheduler1.kind={cfg.scheduler1.kind}", "Training variants")
        self.data = data or RecoData(cfg.data, seed=t.seed)
        resolve(cfg, self.data.max_item_id)
        torch.manual_seed(t.seed)  # dropout: the default generator of every device
        self.model = build_model(cfg, device=self.device)
        self.all_item_ids = np.asarray(self.data.all_item_ids, dtype=np.int32)
        self.neg_generator = torch.Generator(device=self.device).manual_seed(t.seed)

        self.optimizer = build_optimizer(
            cfg.optimizer1, cfg.optimizer2, self.model.parameters(), cfg.optimizer1.lr
        )
        self._packed = bool(cfg.data.pack_sequences)
        self.train_step = task_retrieval.make_train_step(
            self.model, cfg, self.all_item_ids, self.optimizer,
            packed=self._packed, generator=self.neg_generator,
        )
        self.eval_step = task_retrieval.make_eval_step(
            self.model, cfg, self.all_item_ids, self.data.max_item_id
        )
        # packed eval: history-only segments, one query each. Both eval paths
        # are exact, so the choice is throughput alone; auto packs long histories
        pack_eval = str(cfg.data.pack_eval).lower()
        if pack_eval in ("true", "1", "yes", "on"):
            eval_pack_ok = True
        elif pack_eval in ("false", "0", "no", "off"):
            eval_pack_ok = False
        elif pack_eval == "auto":
            eval_pack_ok = cfg.data.max_sequence_length >= 512
        else:
            raise ValueError(f"Unknown data.pack_eval {cfg.data.pack_eval!r}")
        self._eval_packed = self._packed and eval_pack_ok
        self.packed_eval_step = task_retrieval.make_packed_eval_step(
            self.model, cfg, self.all_item_ids, self.data.max_item_id
        ) if self._eval_packed else None
        self.candidate_fn = task_retrieval.make_candidate_fn(self.model, cfg, self.all_item_ids)

        self.lr1_ctrl = PlateauLRController(
            lr=cfg.optimizer1.lr,
            mode=cfg.scheduler1.mode,
            factor=cfg.scheduler1.factor,
            patience=cfg.scheduler1.patience,
            threshold=cfg.scheduler1.threshold,
            min_lr=cfg.scheduler1.min_lr,
        ) if cfg.scheduler1.kind == "plateau" else None
        self.early_stop = EarlyStopping(mode=t.mode, patience=t.early_stop_patience)
        self.out_dir = os.path.join(t.output_dir, cfg.experiment)
        self.writer = MetricsWriter(
            self.out_dir, enable_tensorboard=t.tensorboard, mlflow_dir=t.mlflow_dir
        )
        self.ckpt = CheckpointManager(
            os.path.join(self.out_dir, "checkpoints"), monitor=t.monitor, mode=t.mode
        )
        self.global_step = 0
        self.epoch = 0
        self.lr1 = cfg.optimizer1.lr
        if t.detect_anomaly:
            torch.autograd.set_detect_anomaly(True)
        if t.steps_per_call > 1:
            log.info(
                f"trainer.steps_per_call={t.steps_per_call} has no effect: the step runs "
                "eagerly, one optimizer step per call"
            )

        counts: Dict[str, int] = {}
        for name, p in self.model.named_parameters():
            family = name.split(".", 1)[0]
            counts[family] = counts.get(family, 0) + p.numel()
        log.info(
            f"model on {self.device}; params: "
            + ", ".join(f"{k}={v:,}" for k, v in sorted(counts.items()))
            + f" | total={sum(counts.values()):,}"
        )

    # ------------------------------------------------------------------
    def _put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}

    def _loader(self, split: str, packed: bool = False) -> Loader:
        """The split's loader. packed=True gives the PackedBatchLoader: train
        batches carry their targets inline, eval splits pack history-only
        segments with per-segment query, target and filter fields."""
        if not packed:
            return self.data.loader(split)
        d = self.cfg.data
        # one capacity: the longest segment rounded up to 128 tokens
        cap = d.pack_row_capacity or (d.max_sequence_length + 1 + 127) // 128 * 128
        ds = self.data.dataset(split)
        caps = list(d.pack_capacities) or None
        if caps:
            cap = max(caps)
        rows = d.pack_rows
        if not rows:
            mean_seg = float(np.mean(ds.lengths) + 1.0) if len(ds) else 1.0
            rows = max(1, int(round(d.batch_size * mean_seg / cap)))
        return PackedBatchLoader(
            ds,
            rows_per_batch=rows,
            row_capacity=cap,
            shuffle=(split == "train"),
            seed=self.cfg.trainer.seed,
            capacities=caps,
            # every class emits batches of about batch_size examples, as the
            # padded recipe's steps hold
            segments_per_batch=(0 if d.pack_rows else d.batch_size),
            include_target=(split == "train"),
        )

    def _batches(self, loader: Loader, limit: int):
        """Yield (host_batch, device_batch) for the first `limit` batches."""
        for i, batch in enumerate(loader):
            if i >= limit:
                break
            yield batch, self._put(batch)

    # ------------------------------------------------------------------
    def train_epoch(self, loader: Loader) -> float:
        t_cfg = self.cfg.trainer
        limit = len(loader)
        if t_cfg.fast_dev_run:
            limit = 1
        elif t_cfg.overfit_batches:
            limit = t_cfg.overfit_batches
        elif t_cfg.limit_train_batches < 1.0:
            limit = max(1, int(len(loader) * t_cfg.limit_train_batches))

        self.model.train()
        start = time.time()
        examples = 0
        loss = None
        for batch, dev_batch in self._batches(loader, limit):
            loss = self.train_step(dev_batch, self.lr1)
            self.global_step += 1
            examples += int(
                batch["num_segments"].sum() if "num_segments" in batch
                else batch["sample_weight"].sum()
            )
            if self.global_step % t_cfg.log_every_n_steps == 0:
                # reading the loss waits for the device: only at the log cadence
                self.writer.log(
                    {"train/loss": float(loss), "lr1": self.lr1},
                    self.global_step,
                    self.epoch,
                )
        final = float(loss)  # one more read per epoch, for the summary
        dt = time.time() - start
        log.info(
            f"epoch {self.epoch}: train loss {final:.4f} "
            f"({examples / max(dt, 1e-9):.0f} ex/s)"
        )
        return final

    # ------------------------------------------------------------------
    @torch.no_grad()
    def eval_epoch(self, loader: Loader, prefix: str = "val") -> Dict[str, float]:
        t_cfg = self.cfg.trainer
        limit = len(loader)
        if t_cfg.fast_dev_run:
            limit = 1
        elif prefix == "val" and t_cfg.limit_val_batches < 1.0:
            limit = max(1, int(len(loader) * t_cfg.limit_val_batches))

        self.model.eval()
        candidates = self.candidate_fn()
        all_topk, all_targets = [], []
        # a packed loader of history-only segments: one query per segment,
        # the padding slots (seg_weight 0) dropped
        packed = self._eval_packed and getattr(loader, "include_target", True) is False
        step = self.packed_eval_step if packed else self.eval_step
        weight_key, target_key = (
            ("seg_weight", "seg_target") if packed else ("sample_weight", "target_id")
        )
        for batch, dev_batch in self._batches(loader, limit):
            top_ids = step(dev_batch, candidates)[0]
            valid = batch[weight_key] > 0
            all_topk.append(top_ids.cpu().numpy()[valid])
            all_targets.append(batch[target_key][valid])
        results = retrieval_metrics(
            np.concatenate(all_topk, axis=0),
            np.concatenate(all_targets, axis=0)[:, None],
            self.cfg.model.metrics.at_k_list,
        )
        self.writer.log(
            {f"{prefix}/{k}": v for k, v in results.items()}, self.global_step, self.epoch
        )
        return results

    # ------------------------------------------------------------------
    def fit(self) -> Dict[str, float]:
        t = self.cfg.trainer
        monitor_key = t.monitor.split("/", 1)[1] if "/" in t.monitor else t.monitor
        train_loader = self._loader("train", packed=self._packed)
        val_loader = self._loader("val", packed=self._eval_packed)
        if t.ckpt_path:
            self.restore(t.ckpt_path)
        last_results: Dict[str, float] = {}
        max_epochs = 1 if t.fast_dev_run else t.max_epochs
        for self.epoch in range(self.epoch, max_epochs):
            self.train_epoch(train_loader)
            if (self.epoch + 1) % t.check_val_every_n_epoch != 0:
                continue
            results = self.eval_epoch(val_loader, "val")
            last_results = results
            metric = results.get(monitor_key)
            log.info(
                f"epoch {self.epoch}: "
                + " ".join(f"val/{k}={v:.4f}" for k, v in results.items())
            )
            if metric is not None:
                if self.lr1_ctrl is not None:
                    self.lr1 = self.lr1_ctrl.step(metric)
                self.ckpt.save(
                    self.model,
                    self.optimizer,
                    step=self.global_step,
                    epoch=self.epoch,
                    metric_value=metric,
                    extra=self._controller_state(),
                )
                if self.epoch + 1 >= t.min_epochs and self.early_stop.step(metric):
                    log.info(f"early stopping at epoch {self.epoch}")
                    break
        return last_results

    def test(self, ckpt_path: Optional[str] = None) -> Dict[str, float]:
        path = ckpt_path or self.ckpt.best_path
        if path and os.path.exists(str(path)):
            state = CheckpointManager.load(str(path), self.device)
            self.model.load_state_dict(state["model"] if "model" in state else state)
            log.info(f"loaded checkpoint {path}")
        return self.eval_epoch(self._loader("test", packed=self._eval_packed), "test")

    # ------------------------------------------------------------------
    def _controller_state(self) -> Dict[str, Any]:
        rng = {"neg": self.neg_generator.get_state(), "cpu": torch.get_rng_state()}
        if self.device.type == "cuda":
            rng["cuda"] = torch.cuda.get_rng_state(self.device)
        return {
            "lr1": self.lr1_ctrl.state_dict() if self.lr1_ctrl else None,
            "early_stop": self.early_stop.state_dict(),
            "rng": rng,
        }

    def restore(self, path: str) -> None:
        state = CheckpointManager.load(path, self.device)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.global_step = state["step"]
        self.epoch = state["epoch"] + 1
        extra = state.get("extra", {})
        if extra.get("lr1") and self.lr1_ctrl:
            self.lr1_ctrl.load_state_dict(extra["lr1"])
            self.lr1 = self.lr1_ctrl.lr
        if extra.get("early_stop"):
            self.early_stop.load_state_dict(extra["early_stop"])
        rng = extra.get("rng") or {}
        if "neg" in rng:
            self.neg_generator.set_state(rng["neg"].cpu())
            torch.set_rng_state(rng["cpu"].cpu())
        if "cuda" in rng and self.device.type == "cuda":
            torch.cuda.set_rng_state(rng["cuda"].cpu(), self.device)
        log.info(f"resumed from {path} at epoch {self.epoch}, step {self.global_step}")
