"""The trainer: one device, or one card a process over a mesh of processes.

Port of `Trainer` (mygenerativerecommenders_tpu/train/driver.py:117,
232-301, 400-478, 492-539, 588-716, 717-830, 832-920, 932-961): model and
optimizer set-up, the epoch loop over the prefetching host loader, one or k
steps a call, validation (retrieval: candidate refresh -> filtered top-k ->
ranking metrics; ranking: rating probabilities -> multiclass AUROC, AP,
precision and recall), plateau LR (one controller a learning rate: lr1
for optimizer1, lr2 for the matrix optimizer of `optimizer2.enabled`) and
early stopping keyed on the monitored metric, best/last checkpoints with
resume, `predict` (every test
example's top-k in dataset order), CSV/JSONL metric logging,
and seeded randomness: the weights come from `trainer.seed`, dropout draws from the
device's default generator (seeded with `trainer.seed`) and the negatives
from a generator of their own on the device.

It runs on `trainer.device` (default cuda; a machine without a card raises,
it does not carry on on the CPU). `trainer.steps_per_call` = k > 1 runs an
epoch in calls of k steps (`_train_epoch_multi`, JAX :658-716) and evaluates
k batches a call, with the loss read only when a `log_every_n_steps`
boundary falls inside a call. On cuda every such step and eval batch is one
replay of a CUDA graph of the whole step (train/graphs.py); k = 1 keeps the
eager step, one launch a kernel, as the reference. Batches reach the device
`trainer.prefetch` ahead of the step, from pinned host memory. With
`data.pack_sequences` the train batches come packed from data/packing.py, and
`data.pack_eval` (auto: histories of 512 and longer) packs the eval splits
too, one query per segment; both eval paths are exact. With
`model.encoder.sp_shards` > 1 the model's attention is the ring of
parallel/ring_attention.py, whose shards run in turn on this one device
(under `trainer.distributed`, one a rank of the mesh's sp axis, below);
packed batches raise with it, as in JAX. `model.embedding.lazy_update` trains the item table with
the lazy row update of train/lazy_embedding.py beside the fused AdamW of the
other parameters; its moments and count go into the checkpoints.
`optimizer2.enabled` splits the parameters between two optimizers
(train/optimizers.py: AdamW on the embeddings and vectors, Muon or Scion on
the encoder's matrices; `optimizer2.scion_init` re-initialises those
matrices first, JAX :189-210). A `trainer.monitor` that the eval does not
compute raises in `fit` (the JAX trainer then silently writes no checkpoint
and steps no controller). `model.task=ranking` (train/task_ranking.py) trains
padded or packed, one or k steps a call as retrieval does, and evaluates
padded rows only: its eval splits are never packed.
`trainer.async_checkpoint` writes the checkpoints in a background thread
after a synchronous copy to host memory (checkpoint.py), waited for before
the next save, before a checkpoint is read and at the end of `fit`.
`trainer.profiler` (JAX :599-628) runs the train steps one a call and traces
steps 2-4 of epoch 0 with torch.profiler (CPU and, on the card, CUDA
activity) into a Chrome trace under `<out_dir>/profile/`.
`trainer.mlflow_dir` logs the flattened config as MLflow params (JAX
:332-344) beside every metrics row (train/loggers.py). A scheduler kind that
JAX ignores (`cosine`: JAX steps only a plateau controller) raises. With a
sharded embedding kind (`embedding.kind=sharded_*`) the table's shards run in
turn on this device, and with `index.sharded` on the candidates and the eval
steps, eager and graphed, are built over the index's shard group
(`task_retrieval.index_shards`, the JAX trainer's "model" mesh axis): no mesh
to hold.

`trainer.distributed` trains over processes, one card each, launched by
torchrun (parallel/process_group.py; JAX's "data" mesh axis, :48-93,
:149-152): every rank builds the same weights from `trainer.seed` (checked
once at start) and loads its strided rows of each global batch (the
loaders' process stride, `_loader`, JAX :479-539); the loss divides by the
global batch's weight sum and one all-reduce a step sums the gradients
(inside the step's CUDA graph under NCCL); the lazy table update, the
in-batch pool and the shared negatives are the global batch's. The eval
rows are gathered over the ranks in rank order (`_gather_rows`, JAX
:562-586), so every rank computes the same metrics and takes the same
plateau, checkpoint and early-stop steps. Rank 0 alone writes the metrics
and the checkpoints; the others wait for a checkpoint at a barrier before
they read it. Each rank's own draws (the negatives, dropout) come from
`process_group.rank_seed`; the shared negatives from `trainer.seed` on every
rank, as JAX draws them once. The JAX mesh's "model", "col" and "sp" axes
run too (`mesh_axes`: model = the sharded kind's num_shards or
encoder.tp_shards, col = sharded_2d's col_shards, sp = encoder.sp_shards;
the world is data x model x col x sp ranks in JAX's device order): every
rank builds the whole model, then keeps its blocks of the sharded table and
of TP's matrices and places the HSTU stack on its sp group
(parallel/tensor_parallel.py:place_model: each sp rank runs the blocks on
its rows of the sequence, train and eval alike, and the step sums the
blocks' gradients over the group in its flat all-reduces, inside the CUDA
graph under NCCL); the ranks of a model or sp group load the same rows and
draw alike (keyed by the data index), so their replicated work is one
computation, the eval rows are gathered over the data group alone, and the
checkpoints are written and read in the one-process layout (the blocks
gathered before a save, each rank's cut from a loaded state; nothing is
cut over sp).
"""

from __future__ import annotations

import collections
import os
import time
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from mygenerativerecommenders_tpu_torch.checkpoint import CheckpointManager, load_weights
from mygenerativerecommenders_tpu_torch.configs import Config, resolve, to_dict
from mygenerativerecommenders_tpu_torch.data.dataset import (
    BatchLoader,
    RecoData,
    check_aux_codes,
)
from mygenerativerecommenders_tpu_torch.data.packing import PackedBatchLoader
from mygenerativerecommenders_tpu_torch.models.metrics import (
    MULTICLASS_METRIC_NAMES,
    multiclass_metrics,
    retrieval_metric_names,
    retrieval_metrics,
)
from mygenerativerecommenders_tpu_torch.models.model import build_model
from mygenerativerecommenders_tpu_torch.parallel.process_group import (
    check_num_devices,
    init_data_parallel,
    rank_seed,
    started,
)
from mygenerativerecommenders_tpu_torch.parallel.tensor_parallel import (
    full_optimizer_state,
    full_state_dict,
    local_optimizer_state,
    local_state_dict,
    place_model,
)
from mygenerativerecommenders_tpu_torch.train import task_ranking, task_retrieval
from mygenerativerecommenders_tpu_torch.train.controllers import (
    EarlyStopping,
    PlateauLRController,
)
from mygenerativerecommenders_tpu_torch.train.lazy_embedding import init_lazy_optimizer
from mygenerativerecommenders_tpu_torch.train.loggers import MetricsWriter, get_logger
from mygenerativerecommenders_tpu_torch.train.optimizers import (
    build_optimizer,
    load_optimizer_state,
    scion_init_params,
)

log = get_logger(__name__)

Loader = Union[BatchLoader, PackedBatchLoader]


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """{"a": {"b": 1}} -> {"a.b": 1}."""
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


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


def mesh_axes(cfg: Config) -> Tuple[int, int, int]:
    """(model, col, sp): the sizes of the JAX trainer's "model", "col" and
    "sp" mesh axes (driver.py:124-153): model = max(the sharded kind's
    num_shards, encoder.tp_shards), which must match where both are above 1;
    col = the 2-D kind's col_shards; sp = the HSTU encoder's sp_shards. TP
    beside the ring needs heads that divide by tp_shards, as in JAX (on one
    device TP is the plain block and needs nothing)."""
    m = cfg.model
    emb = m.embedding.num_shards if m.embedding.kind in task_retrieval.SHARDED_KINDS else 1
    tp = m.encoder.tp_shards if m.encoder.kind == "hstu" else 1
    if emb > 1 and tp > 1 and emb != tp:
        raise ValueError(
            "embedding.num_shards and encoder.tp_shards both use the "
            f"'model' mesh axis and must match ({emb} vs {tp})"
        )
    col = m.embedding.col_shards if m.embedding.kind == "sharded_2d" and emb > 1 else 1
    sp = m.encoder.sp_shards if m.encoder.kind == "hstu" else 1
    if tp > 1 and sp > 1 and m.encoder.num_heads % tp:
        # JAX's ring shards its heads over "model" (models/hstu.py:251-256)
        raise ValueError(
            f"model.encoder.num_heads={m.encoder.num_heads} must divide by "
            f"model.encoder.tp_shards={tp} with model.encoder.sp_shards={sp}: the reference's "
            "ring shards the heads over the model axis"
        )
    return max(emb, tp), col, sp


class Trainer:
    def __init__(self, cfg: Config, data: Optional[RecoData] = None,
                 backend: Optional[str] = None):
        """`backend` (trainer.distributed only): the default group's, None
        for NCCL on cuda and gloo on the CPU."""
        self.cfg = cfg
        t = cfg.trainer
        self.dp = None  # the mesh's groups (trainer.distributed)
        if t.distributed:
            # checks num_devices against the world size
            self.dp = init_data_parallel(t, backend, *mesh_axes(cfg))
            self.device = self.dp.device
        else:
            check_num_devices(int(t.num_devices), False, 1)
            if started() is not None:
                # the steps would run over the group, the loaders not stride
                raise ValueError(
                    "this process has started a data-parallel group, so its steps run over "
                    "the ranks: set trainer.distributed=true, or close the group first "
                    "(parallel/process_group.py: shutdown)"
                )
            self.device = resolve_device(t.device)
        rank = self.dp.rank if self.dp else 0  # the data index keys the draws
        writes = self.dp is None or self.dp.world_rank == 0
        for name, sched in (("scheduler1", cfg.scheduler1), ("scheduler2", cfg.scheduler2)):
            if sched.kind not in ("plateau", "none"):
                # JAX builds a controller for plateau alone (driver.py:304-323)
                # and keeps every other kind's rate constant, without a word
                raise ValueError(
                    f"{name}.kind={sched.kind}: the reference ignores this kind (it steps a "
                    "plateau controller only and otherwise keeps the rate constant); set "
                    f"{name}.kind to plateau or none"
                )
        self.data = data or RecoData(cfg.data, seed=t.seed)
        resolve(cfg, self.data.max_item_id)
        if cfg.model.preprocessor.kind == "learnable_positional_aux":
            # once, on the host: a code past its table raises here, naming
            # the column, not at a device assert inside a step
            for split in ("train", "val", "test"):
                check_aux_codes(cfg.model.preprocessor, self.data.dataset(split))
        # dropout: the default generator of every device, a rank's own
        torch.manual_seed(rank_seed(t.seed, rank))
        self.model = build_model(cfg, device=self.device, year_of_item=self.data.year_of_item)
        opt2 = cfg.optimizer2
        if opt2.enabled and opt2.scion_init:
            if opt2.kind.startswith("scion"):
                scion_init_params(self.model.named_parameters(), opt2,
                                  torch.Generator().manual_seed(t.seed))
            else:  # as in JAX, the re-init is Scion's alone
                log.warning(f"optimizer2.scion_init ignored: optimizer2.kind={opt2.kind}")
        self.all_item_ids = np.asarray(self.data.all_item_ids, dtype=np.int32)
        # a rank's own negatives; the shared ones are the same on every rank
        neg_seed = t.seed if cfg.model.loss.shared_negatives else rank_seed(t.seed, rank)
        self.neg_generator = torch.Generator(device=self.device).manual_seed(neg_seed)
        if self.dp is not None:
            self.dp.check_replicas(self.model.named_parameters())
            # the sharded tables' and TP's blocks of this rank, over the mesh
            place_model(self.model, self.dp)

        # the fused kernels on the card, for eager and graphed steps alike;
        # with embedding.lazy_update the item table is updated lazily beside
        # them (train/lazy_embedding.py)
        fused = self.device.type == "cuda"
        if cfg.model.embedding.lazy_update:
            self.optimizer = init_lazy_optimizer(cfg, self.model, fused=fused)
        else:
            self.optimizer = build_optimizer(
                cfg.optimizer1, cfg.optimizer2, self.model.named_parameters(),
                cfg.optimizer1.lr, cfg.optimizer2.lr, fused=fused,
            )
        self._packed = bool(cfg.data.pack_sequences)
        self.steps_per_call = max(int(t.steps_per_call), 1)
        self.task = cfg.model.task
        if self.task == "retrieval":
            self._retrieval_steps(cfg)
        elif self.task == "ranking":
            self._ranking_steps(cfg)
        else:
            raise ValueError(f"Unknown task {self.task}")

        self.lr1_ctrl = PlateauLRController(
            lr=cfg.optimizer1.lr,
            mode=cfg.scheduler1.mode,
            factor=cfg.scheduler1.factor,
            patience=cfg.scheduler1.patience,
            threshold=cfg.scheduler1.threshold,
            min_lr=cfg.scheduler1.min_lr,
        ) if cfg.scheduler1.kind == "plateau" else None
        self.lr2_ctrl = PlateauLRController(
            lr=cfg.optimizer2.lr,
            mode=cfg.scheduler2.mode,
            factor=cfg.scheduler2.factor,
            patience=cfg.scheduler2.patience,
            threshold=cfg.scheduler2.threshold,
            min_lr=cfg.scheduler2.min_lr,
        ) if cfg.scheduler2.kind == "plateau" and cfg.optimizer2.enabled else None
        self.early_stop = EarlyStopping(mode=t.mode, patience=t.early_stop_patience)
        self.out_dir = os.path.join(t.output_dir, cfg.experiment)
        self.writer = MetricsWriter(
            self.out_dir, enable_tensorboard=t.tensorboard, mlflow_dir=t.mlflow_dir,
            experiment=cfg.experiment, enabled=writes,
        )
        if self.writer.mlflow is not None:
            self.writer.mlflow.log_params(_flatten(to_dict(cfg)))
        self.ckpt = CheckpointManager(
            os.path.join(self.out_dir, "checkpoints"), monitor=t.monitor, mode=t.mode,
            async_save=t.async_checkpoint, write=writes,
        )
        self.global_step = 0
        self.epoch = 0
        self.lr1 = cfg.optimizer1.lr
        self.lr2 = cfg.optimizer2.lr
        self.epoch_examples = 0  # examples of the last train epoch
        if t.detect_anomaly:
            torch.autograd.set_detect_anomaly(True)

        counts: Dict[str, int] = {}
        for name, p in self.model.named_parameters():
            family = name.split(".", 1)[0]
            counts[family] = counts.get(family, 0) + p.numel()
        log.info(
            f"model on {self.device}; params: "
            + ", ".join(f"{k}={v:,}" for k, v in sorted(counts.items()))
            + f" | total={sum(counts.values()):,}"
        )

    def _retrieval_steps(self, cfg: Config) -> None:
        """The retrieval task's train, eval and candidate functions."""
        k = self.steps_per_call
        self.train_step = task_retrieval.make_train_step(
            self.model, cfg, self.all_item_ids, self.optimizer,
            packed=self._packed, generator=self.neg_generator,
        )
        self.train_steps = task_retrieval.make_train_step(
            self.model, cfg, self.all_item_ids, self.optimizer, steps=k,
            packed=self._packed, generator=self.neg_generator,
        ) if k > 1 else None
        self.eval_step = task_retrieval.make_eval_step(
            self.model, cfg, self.all_item_ids, self.data.max_item_id
        )
        self.eval_steps = task_retrieval.make_eval_step(
            self.model, cfg, self.all_item_ids, self.data.max_item_id, steps=k
        ) if k > 1 else None
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
        self.packed_eval_steps = task_retrieval.make_packed_eval_step(
            self.model, cfg, self.all_item_ids, self.data.max_item_id, steps=k
        ) if self._eval_packed and k > 1 else None
        self.candidate_fn = task_retrieval.make_candidate_fn(self.model, cfg, self.all_item_ids)

    def _ranking_steps(self, cfg: Config) -> None:
        """The ranking task's train and eval steps. Its eval stays padded (one
        row's last-position class probabilities; packing speeds up training
        only), and it scores against no candidates."""
        k = self.steps_per_call
        self.train_step = task_ranking.make_train_step(
            self.model, cfg, self.optimizer, packed=self._packed
        )
        self.train_steps = task_ranking.make_train_step(
            self.model, cfg, self.optimizer, steps=k, packed=self._packed
        ) if k > 1 else None
        self.eval_step = task_ranking.make_eval_step(self.model, cfg)
        self.eval_steps = task_ranking.make_eval_step(self.model, cfg, steps=k) if k > 1 else None
        self._eval_packed = False
        self.packed_eval_step = self.packed_eval_steps = self.candidate_fn = None

    # ------------------------------------------------------------------
    def _put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The batch on the device. On cuda each array is staged in pinned
        host memory and copied without blocking: `pin_memory()` takes a fresh
        block of torch's pinned-host cache, which hands a block out again only
        once the copy that read it has finished, so no staged batch is
        overwritten while its copy is in flight. A padded batch's "example"
        (its rows' dataset indices, which `predict` orders by) stays on the
        host: the eval graphs read the batches of `fit`, which have none."""
        batch = {k: v for k, v in batch.items() if k != "example"}
        if self.device.type != "cuda":
            return {k: torch.as_tensor(v) for k, v in batch.items()}
        return {
            k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
                self.device, non_blocking=True
            )
            for k, v in batch.items()
        }

    def _loader_sharding(self) -> tuple:
        """(process_index, process_count) of this rank's rows: its data
        coordinate and the data size, so the ranks of a model group load the
        same rows. `trainer.mesh_data_innermost` changes only which ranks
        form a group: a rank loads its data index's strided rows either way
        (JAX :479-490 then loads the full batch on every process, ROADMAP
        queue 3)."""
        return (self.dp.rank, self.dp.size) if self.dp else (0, 1)

    def _loader(self, split: str, packed: bool = False, with_index: bool = False) -> Loader:
        """The split's loader: this rank's rows of it. packed=True gives the
        PackedBatchLoader: train batches carry their targets inline, eval
        splits pack history-only segments with per-segment query, target and
        filter fields; its rows a batch are rounded up to a multiple of the
        data size (JAX :520-521, :531)."""
        index, count = self._loader_sharding()
        if not packed:
            return self.data.loader(split, with_index=with_index, process_index=index,
                                    process_count=count)
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
        rows = -(-rows // count) * count
        return PackedBatchLoader(
            ds,
            rows_per_batch=rows,
            row_capacity=cap,
            shuffle=(split == "train"),
            seed=self.cfg.trainer.seed,
            process_index=index,
            process_count=count,
            capacities=caps,
            row_multiple=count,
            # every class emits batches of about batch_size examples, as the
            # padded recipe's steps hold
            segments_per_batch=(0 if d.pack_rows else d.batch_size),
            include_target=(split == "train"),
        )

    def _batches(self, loader: Loader, limit: int):
        """Yield (host_batch, device_batch) for the first `limit` batches, the
        copies of the next `trainer.prefetch` batches issued before the
        current one is handed out (JAX :400-424)."""
        depth = max(int(self.cfg.trainer.prefetch), 1)
        queue = collections.deque()
        for i, batch in enumerate(loader):
            if i >= limit:
                break
            queue.append((batch, self._put(batch)))
            if len(queue) >= depth:
                yield queue.popleft()
        while queue:
            yield queue.popleft()

    def _stacked_batches(self, loader: Loader, limit: int, k: int):
        """Yield (host_batches, device_batches, n_steps): n_steps == k for a
        run of k batches of one shape, 1 for each batch left over where the
        shape changes (length buckets, packing classes) or the epoch ends
        (JAX :426-460)."""
        chunk = []
        for host, dev in self._batches(loader, limit):
            if chunk and host["ids"].shape != chunk[0][0]["ids"].shape:
                yield from (([h], [d], 1) for h, d in chunk)
                chunk = []
            chunk.append((host, dev))
            if len(chunk) == k:
                yield [h for h, _ in chunk], [d for _, d in chunk], k
                chunk = []
        yield from (([h], [d], 1) for h, d in chunk)

    @staticmethod
    def _examples(batch: Dict[str, np.ndarray]) -> int:
        return int(
            batch["num_segments"].sum() if "num_segments" in batch
            else batch["sample_weight"].sum()
        )

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
        # the profiler's trace needs a step a call (JAX :600-601)
        if self.train_steps is not None and not t_cfg.profiler:
            return self._train_epoch_multi(loader, limit, self.steps_per_call)
        start = time.time()
        examples = 0
        loss = None
        profiler = None
        for i, (batch, dev_batch) in enumerate(self._batches(loader, limit)):
            # steps 2-4 of epoch 0 (the reference's debug=profiler Lightning
            # profile, configs/debug/profiler.yaml)
            if t_cfg.profiler and self.epoch == 0 and i == 2:
                profiler = self._start_profiler()
            loss = self.train_step(dev_batch, self.lr1, self.lr2)
            if profiler is not None and i == 4:
                self._stop_profiler(profiler)
                profiler = None
            self.global_step += 1
            examples += self._examples(batch)
            if self.global_step % t_cfg.log_every_n_steps == 0:
                # reading the loss waits for the device: only at the log cadence
                self.writer.log(
                    {"train/loss": float(loss), **self._rates()},
                    self.global_step,
                    self.epoch,
                )
        if profiler is not None:  # an epoch of fewer than five steps
            self._stop_profiler(profiler)
        final = float(loss)  # one more read per epoch, for the summary
        dt = time.time() - start
        self.epoch_examples = examples
        log.info(
            f"epoch {self.epoch}: train loss {final:.4f} "
            f"({examples / max(dt, 1e-9):.0f} ex/s)"
        )
        return final

    def _start_profiler(self) -> torch.profiler.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler: torch.profiler.profile) -> None:
        """Stop after the traced steps have finished on the device, and
        write the Chrome trace."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        profile_dir = os.path.join(self.out_dir, "profile")
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"trace_epoch{self.epoch}.json")
        profiler.export_chrome_trace(path)
        log.info(f"wrote profiler trace to {path}")

    def _train_epoch_multi(self, loader: Loader, limit: int, k: int) -> float:
        """The epoch in calls of k steps (the shape changes and the epoch's
        remainder in calls of one). The loss is read only when a
        `log_every_n_steps` boundary falls inside a call: a read waits for the
        device."""
        log_n = self.cfg.trainer.log_every_n_steps
        start = time.time()
        examples = 0
        losses = None
        for host_batches, dev_batches, n_steps in self._stacked_batches(loader, limit, k):
            losses = self.train_steps(dev_batches, self.lr1, self.lr2)
            prev = self.global_step
            self.global_step += n_steps
            examples += sum(self._examples(b) for b in host_batches)
            if prev // log_n != self.global_step // log_n:
                self.writer.log(
                    {"train/loss": float(losses[-1]), **self._rates()},
                    self.global_step,
                    self.epoch,
                )
        final = float(losses[-1])
        dt = time.time() - start
        self.epoch_examples = examples
        log.info(
            f"epoch {self.epoch}: train loss {final:.4f} "
            f"({examples / max(dt, 1e-9):.0f} ex/s, {k} steps/call)"
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
        if self.task == "ranking":
            results = self._ranking_metrics(loader, limit)
        else:
            results = self._retrieval_metrics(loader, limit)
        self.writer.log(
            {f"{prefix}/{k}": v for k, v in results.items()}, self.global_step, self.epoch
        )
        return results

    def _ranking_metrics(self, loader: Loader, limit: int) -> Dict[str, float]:
        """Multiclass AUROC, AP, precision and recall of the rows with
        sample_weight > 0, from each row's class probabilities."""
        all_probs, all_targets = [], []

        def collect(probs: np.ndarray, batch: Dict[str, np.ndarray]) -> None:
            valid = batch["sample_weight"] > 0
            all_probs.append(probs[valid])
            all_targets.append(batch["target_rating"][valid])

        if self.eval_steps is not None:
            # k batches a call, one read of their probabilities a call
            for hbs, devs, _ in self._stacked_batches(loader, limit, self.steps_per_call):
                for probs, batch in zip(self.eval_steps(devs)[0].cpu().numpy(), hbs):
                    collect(probs, batch)
        else:
            for batch, dev_batch in self._batches(loader, limit):
                collect(self.eval_step(dev_batch).cpu().numpy(), batch)
        return multiclass_metrics(
            self._gather_rows(np.concatenate(all_probs, axis=0)),
            self._gather_rows(np.concatenate(all_targets, axis=0)),
            num_classes=self.cfg.model.preprocessor.num_ratings,
        )

    def _retrieval_metrics(self, loader: Loader, limit: int) -> Dict[str, float]:
        """NDCG, HR and MRR of the filtered top-k against each query's target."""
        candidates = self.candidate_fn()
        all_topk, all_targets = [], []
        # a packed loader of history-only segments: one query per segment,
        # the padding slots (seg_weight 0) dropped
        packed = self._eval_packed and getattr(loader, "include_target", True) is False
        weight_key, target_key = (
            ("seg_weight", "seg_target") if packed else ("sample_weight", "target_id")
        )
        many = self.packed_eval_steps if packed else self.eval_steps
        if many is not None:
            # k batches a call, one read of their top-k a call
            for hbs, devs, _ in self._stacked_batches(loader, limit, self.steps_per_call):
                top_ids = many(devs, candidates)[0].cpu().numpy()
                for ids, batch in zip(top_ids, hbs):
                    valid = batch[weight_key] > 0
                    all_topk.append(ids[valid])
                    all_targets.append(batch[target_key][valid])
        else:
            step = self.packed_eval_step if packed else self.eval_step
            for batch, dev_batch in self._batches(loader, limit):
                top_ids = step(dev_batch, candidates)[0]
                valid = batch[weight_key] > 0
                all_topk.append(top_ids.cpu().numpy()[valid])
                all_targets.append(batch[target_key][valid])
        return retrieval_metrics(
            self._gather_rows(np.concatenate(all_topk, axis=0)),
            self._gather_rows(np.concatenate(all_targets, axis=0))[:, None],
            self.cfg.model.metrics.at_k_list,
        )

    def _gather_rows(self, rows: np.ndarray) -> np.ndarray:
        """Every rank's eval rows in rank order (JAX `_gather_rows`,
        :562-586); one process: `rows` itself."""
        return rows if self.dp is None else self.dp.gather_rows(rows)

    # ------------------------------------------------------------------
    def fit(self) -> Dict[str, float]:
        t = self.cfg.trainer
        monitor_key = t.monitor.split("/", 1)[1] if "/" in t.monitor else t.monitor
        computed = self.metric_names()
        if monitor_key not in computed:
            raise ValueError(
                f"trainer.monitor={t.monitor!r} names a metric the eval does not compute "
                f"(it computes {', '.join(computed)}): no checkpoint would be written and "
                "no controller stepped"
            )
        train_loader = self._loader("train", packed=self._packed)
        val_loader = self._loader("val", packed=self._eval_packed)
        if t.ckpt_path:
            self.restore(t.ckpt_path)
            # the permutation of the epoch it resumes at (seed + epoch), as an
            # uninterrupted run draws it; the JAX trainer restarts at epoch 0's
            train_loader.epoch = self.epoch
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
                if self.lr2_ctrl is not None:
                    self.lr2 = self.lr2_ctrl.step(metric)
                self.ckpt.save(
                    self.model,
                    self.optimizer,
                    # the one-process layout: the placed blocks gathered, on
                    # every rank (rank 0 writes)
                    model_state=full_state_dict(self.model),
                    optimizer_state=full_optimizer_state(self.optimizer),
                    step=self.global_step,
                    epoch=self.epoch,
                    metric_value=metric,
                    extra=self._controller_state(),
                )
                self._barrier()  # rank 0's save is issued
                if self.epoch + 1 >= t.min_epochs and self.early_stop.step(metric):
                    log.info(f"early stopping at epoch {self.epoch}")
                    break
        self.ckpt.flush()  # the last save has landed when fit returns
        return last_results

    def load_weights(self, path: str) -> None:
        """The model's weights from a checkpoint (`checkpoint.load_checkpoint`:
        a training or state_dict `.pt`, a reference `.ckpt`, an `.npz`)."""
        load_weights(self.model, str(path), self.device)
        log.info(f"loaded checkpoint {path}")

    def _barrier(self) -> None:
        if self.dp is not None:
            self.dp.barrier()

    def test(self, ckpt_path: Optional[str] = None) -> Dict[str, float]:
        self.ckpt.flush()  # best.pt may be in flight
        self._barrier()  # rank 0's write has landed
        path = ckpt_path or self.ckpt.best_path
        if path and os.path.exists(str(path)):
            self.load_weights(path)
        return self.eval_epoch(self._loader("test", packed=self._eval_packed), "test")

    @torch.no_grad()
    def predict(self) -> Dict[str, list]:
        """The top-k ids and scores of every test example, in dataset order
        (JAX :888-920): padded, or packed where the eval is packed (its
        segments regrouped by `seg_example`), k batches a call (graphed on
        the card) where the trainer evaluates so."""
        if self.task != "retrieval":
            raise ValueError("predict() produces top-k lists; retrieval task only")
        self.model.eval()
        candidates = self.candidate_fn()
        if self._eval_packed:
            loader = self._loader("test", packed=True)
            many, one = self.packed_eval_steps, self.packed_eval_step
            weight_key, example_key = "seg_weight", "seg_example"
        else:
            loader = self._loader("test", with_index=True)
            many, one = self.eval_steps, self.eval_step
            weight_key, example_key = "sample_weight", "example"
        examples, ids, scores = [], [], []

        def collect(out_ids, out_scores, batch) -> None:
            valid = batch[weight_key] > 0
            examples.append(batch[example_key][valid])
            ids.append(out_ids.cpu().numpy()[valid])
            scores.append(out_scores.cpu().numpy()[valid])

        if many is not None:
            for hbs, devs, _ in self._stacked_batches(loader, len(loader), self.steps_per_call):
                out = many(devs, candidates)
                for i, batch in enumerate(hbs):
                    collect(out[0][i], out[1][i], batch)
        else:
            for batch, dev_batch in self._batches(loader, len(loader)):
                out = one(dev_batch, candidates)
                collect(out[0], out[1], batch)
        examples, ids, scores = (self._gather_rows(np.concatenate(parts))
                                 for parts in (examples, ids, scores))
        order = np.argsort(examples, kind="stable")
        return {"top_k_ids": ids[order].tolist(), "top_k_scores": scores[order].tolist()}

    def metric_names(self) -> tuple:
        """The names of the metrics `eval_epoch` computes (without the
        split's prefix)."""
        if self.task == "ranking":
            return MULTICLASS_METRIC_NAMES
        return retrieval_metric_names(self.cfg.model.metrics.at_k_list)

    def _rates(self) -> Dict[str, float]:
        """The learning rates a metrics line logs: lr1, and lr2 where there
        is a matrix optimizer."""
        if self.cfg.optimizer2.enabled:
            return {"lr1": self.lr1, "lr2": self.lr2}
        return {"lr1": self.lr1}

    # ------------------------------------------------------------------
    def _controller_state(self) -> Dict[str, Any]:
        rng = {"neg": self.neg_generator.get_state(), "cpu": torch.get_rng_state()}
        if self.device.type == "cuda":
            rng["cuda"] = torch.cuda.get_rng_state(self.device)
        return {
            "lr1": self.lr1_ctrl.state_dict() if self.lr1_ctrl else None,
            "lr2": self.lr2_ctrl.state_dict() if self.lr2_ctrl else None,
            "early_stop": self.early_stop.state_dict(),
            "rng": rng,
        }

    def restore(self, path: str) -> None:
        self.ckpt.flush()
        self._barrier()  # rank 0's write has landed
        state = CheckpointManager.load(path, self.device)
        # the one-process layout, cut to this rank's blocks where it is placed
        self.model.load_state_dict(local_state_dict(self.model, state["model"]))
        # a split optimizer's parts, the lazy table's mv and count: each its own
        load_optimizer_state(self.optimizer,
                             local_optimizer_state(self.optimizer, state["optimizer"]))
        # the optimizer's state tensors are new: the next graphed step
        # captures anew, against them (the weights were copied in place)
        if self.train_steps is not None and self.train_steps.graphs is not None:
            self.train_steps.graphs.reset()
        self.global_step = state["step"]
        self.epoch = state["epoch"] + 1
        extra = state.get("extra", {})
        if extra.get("lr1") and self.lr1_ctrl:
            self.lr1_ctrl.load_state_dict(extra["lr1"])
            self.lr1 = self.lr1_ctrl.lr
        if extra.get("lr2") and self.lr2_ctrl:
            self.lr2_ctrl.load_state_dict(extra["lr2"])
            self.lr2 = self.lr2_ctrl.lr
        if extra.get("early_stop"):
            self.early_stop.load_state_dict(extra["early_stop"])
        rng = extra.get("rng") or {}
        if self.dp is not None and self.dp.rank > 0:
            # the checkpoint holds rank 0's streams: a rank's own go on from
            # its seed and the step (the shared negatives' is every rank's)
            seed = rank_seed(self.cfg.trainer.seed + self.global_step, self.dp.rank)
            torch.manual_seed(seed)
            if self.cfg.model.loss.shared_negatives and "neg" in rng:
                self.neg_generator.set_state(rng["neg"].cpu())
            else:
                self.neg_generator.manual_seed(seed)
            rng = {}
        if "neg" in rng:
            self.neg_generator.set_state(rng["neg"].cpu())
            torch.set_rng_state(rng["cpu"].cpu())
        if "cuda" in rng and self.device.type == "cuda":
            torch.cuda.set_rng_state(rng["cuda"].cpu(), self.device)
        log.info(f"resumed from {path} at epoch {self.epoch}, step {self.global_step}")
