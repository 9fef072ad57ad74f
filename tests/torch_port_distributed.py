"""A rank of the two-process tests of the port's data parallel
(tests/test_torch_port_distributed.py), on the CPU over gloo.

    RANK=r WORLD_SIZE=2 LOCAL_RANK=r MASTER_ADDR=localhost MASTER_PORT=p \\
        python -m tests.torch_port_distributed <job.pt> <out_dir>

`job.pt` (torch.save'd by the test) holds:

- "steps": {name: {"cfg": the Config, "state": the weights, "packed":
  bool, "batches": [one host batch a rank], "drawn": [one drawn input a
  rank] or None, "lr": float}}. For each, the rank takes one step of
  `make_train_step` over the group with its batch and drawn input, and
  keeps the loss, every gradient (summed over the ranks) and the weights
  after the step.
- "fits": {name: CLI overrides}: `Trainer(...)` with `trainer.distributed`
  trains them (`fit`); the rank keeps the val metrics, each epoch's loss,
  whether its train rows are the same under `trainer.mesh_data_innermost`
  on and off, the weights, `predict` and `test`.
- "builds": {name: CLI overrides} with their "build_ports": after the
  above, `Trainer(...)` with `trainer.distributed` is built on a mesh of
  its own (a new port each); the rank keeps the mesh's sizes.

The rank writes `<out_dir>/rank<r>.pt`. No JAX is imported here.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from mygenerativerecommenders_tpu_torch.cli.train import parse_args
from mygenerativerecommenders_tpu_torch.configs import resolve
from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
from mygenerativerecommenders_tpu_torch.models.model import build_model
from mygenerativerecommenders_tpu_torch.parallel.process_group import (
    init_data_parallel,
    shutdown,
    started,
)
from mygenerativerecommenders_tpu_torch.parallel.tensor_parallel import (
    full_state_dict,
    full_tensor,
    mesh_groups,
    place_model,
)
from mygenerativerecommenders_tpu_torch.train import task_ranking, task_retrieval
from mygenerativerecommenders_tpu_torch.train.driver import Trainer
from mygenerativerecommenders_tpu_torch.train.lazy_embedding import init_lazy_optimizer
from mygenerativerecommenders_tpu_torch.train.optimizers import build_optimizer


def take_step(case: dict, rank: int) -> dict:
    """One step on the batch of data index `rank`: over the process's mesh
    where one is started (the model placed on it, the sharded leaves'
    gradients and weights gathered back into the one-process layout), else
    on one process."""
    cfg = case["cfg"]
    data = RecoData(cfg.data, seed=cfg.trainer.seed)
    resolve(cfg, data.max_item_id)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(case["state"])
    place_model(model, started())
    model.train()
    lr = case["lr"]
    if cfg.model.embedding.lazy_update:
        optimizer = init_lazy_optimizer(cfg, model)
    else:
        optimizer = build_optimizer(cfg.optimizer1, cfg.optimizer2, model.named_parameters(),
                                    lr, lr)
    batch = {k: torch.as_tensor(v) for k, v in case["batches"][rank].items()}
    inputs = {}
    if cfg.model.task == "ranking":
        step = task_ranking.make_train_step(model, cfg, optimizer, packed=case["packed"])
    else:
        step = task_retrieval.make_train_step(model, cfg, data.all_item_ids, optimizer,
                                              packed=case["packed"])
        name = "neg_uniforms" if cfg.model.sampler.kind == "in_batch" else "neg_offsets"
        inputs[name] = case["drawn"][rank]
    loss = step(batch, lr, lr, **inputs)
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    placements = getattr(model, "placements", {})
    if placements:
        groups = mesh_groups()
        grads = {k: full_tensor(g, placements[k], groups) if k in placements else g
                 for k, g in grads.items()}
    return {"loss": float(loss), "grads": grads,
            "params": {k: v.clone() for k, v in full_state_dict(model).items()}}


def run_fit(args: list) -> dict:
    trainer = Trainer(parse_args(args))
    losses = []
    train_epoch = trainer.train_epoch
    trainer.train_epoch = lambda loader: losses.append(train_epoch(loader)) or losses[-1]
    val = trainer.fit()
    rows = {}
    for innermost in (False, True):
        trainer.cfg.trainer.mesh_data_innermost = innermost
        rows[innermost] = [b["ids"] for b in trainer._loader("train", packed=trainer._packed)]
    return {"val": val, "losses": losses,
            "same_rows_innermost": len(rows[False]) == len(rows[True]) and all(
                np.array_equal(a, b) for a, b in zip(rows[False], rows[True])),
            "state": {k: v.clone() for k, v in trainer.model.state_dict().items()},
            "predict": trainer.predict() if trainer.task == "retrieval" else None,
            "test": trainer.test()}


def main(job_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    job = torch.load(job_path, weights_only=False)
    results = {"steps": {}, "fits": {}}
    trainer_cfg = parse_args(["trainer.device=cpu", "trainer.distributed=true"]).trainer
    init_data_parallel(trainer_cfg)
    try:
        for name, case in job["steps"].items():
            results["steps"][name] = take_step(case, rank)
        for name, args in job["fits"].items():
            results["fits"][name] = run_fit(args)
        results["builds"] = {}
        for (name, args), port in zip(job.get("builds", {}).items(), job.get("build_ports", ())):
            shutdown()
            os.environ["MASTER_PORT"] = str(port)
            mesh = Trainer(parse_args(args)).dp
            results["builds"][name] = {"data": mesh.size, "model": mesh.model_size,
                                       "col": mesh.col_size, "sp": mesh.sp_size}
    finally:
        shutdown()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(*sys.argv[1:3])
