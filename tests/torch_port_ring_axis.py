"""A rank of the tests of the port's ring over a process group
(tests/test_torch_port_ring_axis.py), on the CPU over gloo.

    RANK=r WORLD_SIZE=n LOCAL_RANK=r MASTER_ADDR=localhost MASTER_PORT=p \\
        python -m tests.torch_port_ring_axis <job.pt> <out_dir>

`job.pt` holds the job of tests/torch_port_model_axis.py ("steps", "fits",
"ports"), which its `main` runs first, and "bodies": {"port": a free port,
"inputs": q, k, v, timestamps, pos_w, ts_w, the cotangent "g", "max_len"}.
On a mesh whose sp axis is the world the rank then runs the ring's bodies
over the sp group (`ring_hstu_attention_group`) and on one device
(`ring_hstu_attention`, every shard in turn), both layouts, and keeps each
one's output and the gradients of (out * g).sum() in q, k, v, pos_w and
ts_w, and the group ring's count of collectives. The rank adds them to
`<out_dir>/rank<r>.pt`. No JAX is imported here.
"""

from __future__ import annotations

import os
import sys

import torch

from mygenerativerecommenders_tpu_torch.cli.train import parse_args
from mygenerativerecommenders_tpu_torch.parallel import embedding_sharding, ring_attention
from mygenerativerecommenders_tpu_torch.parallel.process_group import (
    init_data_parallel,
    shutdown,
)
from tests import torch_port_model_axis


def ring_bodies(job: dict) -> dict:
    """{(layout, "group" | "one device"): [out, dq, dk, dv, d_pos_w, d_ts_w]},
    and {(layout, "collectives"): the group ring's collectives, forward and
    backward}."""
    os.environ["MASTER_PORT"] = str(job["port"])
    trainer_cfg = parse_args(["trainer.device=cpu", "trainer.distributed=true"]).trainer
    mesh = init_data_parallel(trainer_cfg, None, sp=int(os.environ["WORLD_SIZE"]))
    q, k, v, ts, pos_w, ts_w = job["inputs"]
    common = dict(max_len=job["max_len"], num_buckets=ts_w.shape[0] - 1)
    out = {}
    try:
        for zigzag in (False, True):
            for where in ("group", "one device"):
                leaves = [x.clone().requires_grad_() for x in (q, k, v, pos_w, ts_w)]
                a, b, c, p, t = leaves
                before = embedding_sharding.collectives
                if where == "group":
                    o = ring_attention.ring_hstu_attention_group(
                        a, b, c, ts, p, t, group=mesh.sp, zigzag=zigzag, **common)
                else:
                    o = ring_attention.ring_hstu_attention(
                        a, b, c, ts, p, t, num_shards=mesh.sp_size, zigzag=zigzag, **common)
                (o * job["g"]).sum().backward()
                layout = "zigzag" if zigzag else "contiguous"
                out[layout, where] = [o.detach()] + [x.grad for x in leaves]
                if where == "group":
                    out[layout, "collectives"] = embedding_sharding.collectives - before
    finally:
        shutdown()
    return out


def main(job_path: str, out_dir: str) -> None:
    torch_port_model_axis.main(job_path, out_dir)
    job = torch.load(job_path, weights_only=False)
    if job.get("bodies"):
        path = os.path.join(out_dir, f"rank{os.environ['RANK']}.pt")
        results = torch.load(path, weights_only=False)
        results["bodies"] = ring_bodies(job["bodies"])
        torch.save(results, path)


if __name__ == "__main__":
    main(*sys.argv[1:3])
