"""A rank of the tests of the port's "model" axis over processes
(tests/test_torch_port_model_axis.py), on the CPU over gloo.

    RANK=r WORLD_SIZE=n LOCAL_RANK=r MASTER_ADDR=localhost MASTER_PORT=p \\
        python -m tests.torch_port_model_axis <job.pt> <out_dir>

`job.pt` (torch.save'd by the test) holds:

- "steps": {name: a step case of tests/torch_port_distributed.py, "batches"
  and "drawn" one a data index}. The rank starts the mesh of the case's
  config (parallel/process_group.py), takes one step over it with its data
  index's batch (`take_step`: the model placed on the mesh, the gradients
  and weights gathered into the one-process layout) and keeps the result.
  A case with "ns_float32" runs Muon's and Scion's NS-5 in float32
  (`ns_float32`, the iteration tests/test_torch_port_optimizers.py holds
  both packages to), where their bfloat16 products round apart.
- "ports": one free port for each step and fit, in order: each starts a
  mesh of its own (a new TCP store: a rank that reconnected to the last
  one's port could meet its keys).
- "fits": {name: CLI overrides}: `Trainer(...)` with `trainer.distributed`
  trains them (`fit`), then the rank keeps the val metrics, each epoch's
  loss, `predict`, `test`, the weights in the one-process layout, whether
  the replicated leaves are bit-equal across the mesh (`check_replicas`),
  the mesh's sizes (data, model, col; and sp), and where the eval is packed the unpacked eval's val
  metrics.

The rank writes `<out_dir>/rank<r>.pt`. No JAX is imported here.
"""

from __future__ import annotations

import os
import sys

import torch

from mygenerativerecommenders_tpu_torch.cli.train import parse_args
from mygenerativerecommenders_tpu_torch.parallel.process_group import (
    init_data_parallel,
    shutdown,
)
from mygenerativerecommenders_tpu_torch.parallel.tensor_parallel import full_state_dict
from mygenerativerecommenders_tpu_torch.train import optimizers
from mygenerativerecommenders_tpu_torch.train.driver import Trainer, mesh_axes
from tests.torch_port_distributed import take_step


def ns_float32(g, steps, xp):
    """NS-5 in float32 on `xp` (torch or jax.numpy): one iteration for both
    packages."""
    a, b, c = 3.4445, -4.7750, 2.0315
    transpose = g.shape[-2] > g.shape[-1]
    x = g.T if transpose else g
    x = x / (xp.linalg.norm(x) + 1e-7)
    for _ in range(steps):
        xxt = x @ x.T
        x = a * x + (b * xxt + c * (xxt @ xxt)) @ x
    return x.T if transpose else x


def run_fit(args: list) -> dict:
    trainer = Trainer(parse_args(args))
    losses = []
    train_epoch = trainer.train_epoch
    trainer.train_epoch = lambda loader: losses.append(train_epoch(loader)) or losses[-1]
    val = trainer.fit()
    mesh = trainer.dp
    try:
        mesh.check_replicas(trainer.model.named_parameters())
        replicas_equal = True
    except RuntimeError:
        replicas_equal = False
    out = {"val": val, "losses": losses, "replicas_equal": replicas_equal,
           "sizes": (mesh.size, mesh.model_size, mesh.col_size), "sp": mesh.sp_size,
           "state": {k: v.clone() for k, v in full_state_dict(trainer.model).items()},
           "predict": trainer.predict()}
    if trainer._eval_packed:
        out["val_unpacked"] = trainer.eval_epoch(trainer._loader("val"), "val")
    out["test"] = trainer.test()
    return out


def main(job_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    job = torch.load(job_path, weights_only=False)
    results = {"steps": {}, "fits": {}}
    ports = iter(job["ports"])
    try:
        for name, case in job["steps"].items():
            os.environ["MASTER_PORT"] = str(next(ports))
            cfg = case["cfg"]
            trainer_cfg = parse_args(["trainer.device=cpu", "trainer.distributed=true"]).trainer
            trainer_cfg.mesh_data_innermost = cfg.trainer.mesh_data_innermost
            mesh = init_data_parallel(trainer_cfg, None, *mesh_axes(cfg))
            if case.get("ns_float32"):
                optimizers.zeropower_via_newtonschulz5 = \
                    lambda g, steps=5: ns_float32(g.float(), steps, torch)
            results["steps"][name] = take_step(case, mesh.rank)
            shutdown()
        for name, args in job["fits"].items():
            os.environ["MASTER_PORT"] = str(next(ports))
            results["fits"][name] = run_fit(args)
            shutdown()
    finally:
        shutdown()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(*sys.argv[1:3])
