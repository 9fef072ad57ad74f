"""A rank of the tests of the port's ring over a process group
(tests/test_torch_port_ring_axis.py), on the CPU over gloo.

    RANK=r WORLD_SIZE=n LOCAL_RANK=r MASTER_ADDR=localhost MASTER_PORT=p \\
        python -m tests.torch_port_ring_axis <job.pt> <out_dir>

`job.pt` holds the job of tests/torch_port_model_axis.py ("steps", "fits",
"ports"), which its `main` runs first, and "bodies": {"port": a free port,
"inputs": q, k, v, timestamps, pos_w, ts_w, the cotangent "g", "max_len"}.
While the steps run, a forward pre-hook on every `HSTUBlock` and on the
`HSTU` stack and a wrapper on the ring's chunk calls record, a step, the
rows the stack took in, the rows each block ran on and the heads each chunk
call saw ("layout"). On a mesh whose sp axis is the world the rank then
runs the ring's bodies over the sp group (`ring_hstu_attention_group`, on
the rank's rows of the inputs in the ring's layout) and on one device
(`ring_hstu_attention`, every shard in turn), both layouts, and keeps the
rank's rows of each one's output and of the gradients of (out * g).sum()
in q, k and v, the gradients in pos_w and ts_w (the group's: the rank's
part), and the group ring's count of collectives. The rank adds them to
`<out_dir>/rank<r>.pt`. No JAX is imported here.
"""

from __future__ import annotations

import os
import sys

import torch

from mygenerativerecommenders_tpu_torch.cli.train import parse_args
from mygenerativerecommenders_tpu_torch.models.hstu import HSTU, HSTUBlock
from mygenerativerecommenders_tpu_torch.parallel import embedding_sharding, ring_attention
from mygenerativerecommenders_tpu_torch.parallel.process_group import (
    init_data_parallel,
    shutdown,
)
from mygenerativerecommenders_tpu_torch.train import task_retrieval
from tests import torch_port_model_axis


def ring_bodies(job: dict) -> dict:
    """{(layout, "group" | "one device"): [out, dq, dk, dv (the rank's rows
    in the ring's layout), d_pos_w, d_ts_w]}, and {(layout, "collectives"):
    the group ring's collectives, forward and backward}."""
    os.environ["MASTER_PORT"] = str(job["port"])
    trainer_cfg = parse_args(["trainer.device=cpu", "trainer.distributed=true"]).trainer
    mesh = init_data_parallel(trainer_cfg, None, sp=int(os.environ["WORLD_SIZE"]))
    q, k, v, ts, pos_w, ts_w = job["inputs"]
    common = dict(max_len=job["max_len"], num_buckets=ts_w.shape[0] - 1)
    out = {}
    try:
        for zigzag in (False, True):
            rows = ring_attention.StackRows(mesh.sp, q.shape[1], zigzag, q.device)
            for where in ("group", "one device"):
                qkv = (rows.local(x) for x in (q, k, v)) if where == "group" else (q, k, v)
                leaves = [x.clone().requires_grad_() for x in (*qkv, pos_w, ts_w)]
                a, b, c, p, t = leaves
                before = embedding_sharding.collectives
                if where == "group":
                    o = ring_attention.ring_hstu_attention_group(
                        a, b, c, rows.local(ts), p, t, group=mesh.sp, zigzag=zigzag, **common)
                    (o * rows.local(job["g"])).sum().backward()
                    mine = [o.detach()] + [x.grad for x in leaves[:3]]
                else:
                    o = ring_attention.ring_hstu_attention(
                        a, b, c, ts, p, t, num_shards=mesh.sp_size, zigzag=zigzag, **common)
                    (o * job["g"]).sum().backward()
                    mine = [rows.local(x) for x in [o.detach()] + [x.grad for x in leaves[:3]]]
                layout = "zigzag" if zigzag else "contiguous"
                out[layout, where] = mine + [x.grad for x in leaves[3:]]
                if where == "group":
                    out[layout, "collectives"] = embedding_sharding.collectives - before
    finally:
        shutdown()
    return out


def record_layout() -> list:
    """Install the hooks that record each step's layout (one dict a call of
    `take_step`, in the job's order of steps): "stack" the rows the HSTU
    stack took in, "blocks" the rows of each block's input, "heads" the
    heads of each chunk call's q, "collectives" those made over the shard
    groups (the sp and model groups)."""
    steps, active = [], []
    take_step, chunk = torch_port_model_axis.take_step, ring_attention.hstu_chunk_attention

    make_train_step = task_retrieval.make_train_step

    def step(*args, **kwargs):
        steps.append({"stack": [], "blocks": [], "heads": []})
        active.append(steps[-1])
        try:
            return take_step(*args, **kwargs)
        finally:
            active.clear()

    def counted(*args, **kwargs):  # the train step's collectives alone
        train_step = make_train_step(*args, **kwargs)

        def run(*a, **k):
            before = embedding_sharding.collectives
            out = train_step(*a, **k)
            for record in active:
                record["collectives"] = embedding_sharding.collectives - before
            return out

        return run

    def chunk_call(q, *args, **kwargs):
        for record in active:
            record["heads"].append(q.shape[2])
        return chunk(q, *args, **kwargs)

    def pre_hook(module, args):
        for record in active:
            if isinstance(module, HSTUBlock):
                record["blocks"].append(args[0].shape[1])
            elif isinstance(module, HSTU):
                record["stack"].append(args[1].shape[1])

    torch_port_model_axis.take_step = step
    task_retrieval.make_train_step = counted
    ring_attention.hstu_chunk_attention = chunk_call
    torch.nn.modules.module.register_module_forward_pre_hook(pre_hook)
    return steps


def main(job_path: str, out_dir: str) -> None:
    steps = record_layout()
    torch_port_model_axis.main(job_path, out_dir)
    job = torch.load(job_path, weights_only=False)
    path = os.path.join(out_dir, f"rank{os.environ['RANK']}.pt")
    results = torch.load(path, weights_only=False)
    results["layout"] = dict(zip(job["steps"], steps))
    if job.get("bodies"):
        results["bodies"] = ring_bodies(job["bodies"])
    torch.save(results, path)


if __name__ == "__main__":
    main(*sys.argv[1:3])
