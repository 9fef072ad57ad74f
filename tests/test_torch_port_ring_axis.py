"""The port's ring over a process group (`encoder.sp_shards` on the mesh's
"sp" axis, gloo on the CPU) against the JAX package's step on the 8-device
CPU mesh with `sp_shards=2` (`make_mesh(..., sp_axis=2)`; JAX's jnp ring
bodies inside its `shard_map`, as its own ring tests run them).

Module fixtures launch the ranks of `tests/torch_port_ring_axis.py` once a
world size (torchrun's environment, gloo):

- two ranks, one sp group of 2 (data 1 x sp 2): one step each of JAX's
  `ring` recipe (synthetic-smoke, zigzag, `mesh_data_innermost`, batch 16;
  tests/distributed_worker.py:41-45), of its contiguous twin and of the
  recipe with `encoder.remat`, with the JAX draw handed in and dropout off:
  the loss, every gradient and the parameters after the step equal JAX's
  step over the same batch at rtol 2e-4 / atol 2e-5 (the bias tables'
  gradients at 5e-4). `ProcessGroupRing` on a rank's rows of one [B, N,
  H, d] input against `OneDeviceRing` on all of it, both layouts: the
  rank's rows of the output and of the gradients in q, k and v, the two
  ranks' parts of the gradients in pos_w and ts_w summed, and its three
  collectives (the rotation and its inverse among them). Then two epochs
  of `fit` of the `ring` recipe,
  `predict` and `test`: both ranks' metrics, losses and predictions equal
  to the bit, the replicated leaves bit-equal across the ranks, and the
  checkpoint loaded into a one-process run of the port (the ring's shards
  in turn on one device) with equal val metrics;
- four ranks: one step of the `ring` recipe over data 2 x sp 2 (the data
  index innermost, the two indices' batches with different tails), and one
  over model 2 x sp 2 with `tp_shards=2` and two heads (JAX's ring with its
  heads sharded over "model"), without and with `concat_ua`.

For every step the worker records the rows each HSTU block ran on, the
heads each chunk call saw and the step's collectives: each sp rank's blocks
run on the stack's rows / sp, each model rank's chunk calls on H / tp heads,
as JAX's compiled step (its text read here) runs its ring; JAX's block 0
uvqk dot runs the rows / sp in the contiguous layout and all of them in the
zigzag one.

In one process: a world the axes do not divide, and `tp_shards=2` with one
head under the ring, raise `ValueError`s naming the knobs when a
`trainer.distributed` Trainer is built (on one device TP is the plain
block, tests/test_torch_port_ring.py).
"""

import functools
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.models.model import build_model as jax_build_model
from mygenerativerecommenders_tpu.parallel.tensor_parallel import place_tp_params
from mygenerativerecommenders_tpu.train import optimizers as jax_opt
from mygenerativerecommenders_tpu.train import task_retrieval as jax_task
from mygenerativerecommenders_tpu.train.driver import make_mesh
from mygenerativerecommenders_tpu.utils.features import seq_features_from_batch as jax_features
from mygenerativerecommenders_tpu_torch.checkpoint import grads_to_state_dict, params_to_state_dict
from mygenerativerecommenders_tpu_torch.cli import train as cli_train
from mygenerativerecommenders_tpu_torch.configs import resolve as pt_resolve
from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
from mygenerativerecommenders_tpu_torch.train.driver import Trainer
from tests import torch_port_families as fam
from tests.test_torch_port_model_axis import (
    BIAS_RTOL,
    REPO,
    USERS,
    _check_step,
    _collect,
    _free_port,
    _free_ports,
    _halves,
)
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL, ATOL = 2e-4, 2e-5
RING = (("model.encoder.sp_shards", 2), ("model.encoder.sp_zigzag", True))
CONTIGUOUS = (("model.encoder.sp_shards", 2), ("model.encoder.sp_zigzag", False))
REMAT = RING + (("model.encoder.remat", True),)


@functools.lru_cache(maxsize=None)
def _init(heads: int, concat_ua: bool = False) -> dict:
    """The JAX weights of the smoke model with `heads` heads (numpy), made
    once: the ring's layout, remat and TP change no weight."""
    jcfg, pcfg = fam._configs("synthetic-smoke", (("model.encoder.concat_ua", concat_ua),), heads)
    pcfg.data.synthetic_num_users = USERS
    ds = RecoData(pcfg.data, seed=42)
    fam.jax_resolve(jcfg, ds.max_item_id)
    jmodel = jax_build_model(jcfg)
    batch = next(iter(ds.loader("train")))
    with jax.sharding.set_mesh(make_mesh(0)):  # every JAX array made under it
        seq = jax_features(batch, jcfg.model.gr_output_length + 1)[0]
        key0 = jax.random.PRNGKey(0)
        return fam.np_tree(jax.jit(functools.partial(jmodel.init, method=jmodel.init_all))(
            {"params": key0, "dropout": key0}, seq))


def _jax_case(overrides, data=1, model=1, heads=1, batch_size=16):
    """(the ranks' step case, want(): JAX's loss, gradients and parameters
    after one step over the global batch on the 8-device mesh of `model` x
    sp 2 (the data index innermost), its TP leaves placed as JAX's trainer
    places them). Each data index loads `batch_size` rows of the global
    batch, the ranks of its sp (and model) group the same ones."""
    jcfg, pcfg = fam._configs("synthetic-smoke", overrides, heads)
    for cfg in (jcfg, pcfg):
        cfg.data.synthetic_num_users = USERS
        cfg.data.batch_size = batch_size
    pcfg.trainer.mesh_data_innermost = True
    halves = _halves(pcfg, data, False)
    batch = {k: np.concatenate([h[k] for h in halves]) for k in halves[0]}
    ds = RecoData(pcfg.data, seed=42)
    fam.jax_resolve(jcfg, ds.max_item_id)
    pt_resolve(pcfg, ds.max_item_id)
    jmodel = jax_build_model(jcfg)
    params = _init(heads, dict(overrides).get("model.encoder.concat_ua", False))
    mesh = make_mesh(0, model_axis=model, sp_axis=2, data_innermost=True)
    with jax.sharding.set_mesh(mesh):
        key = jax.random.fold_in(jax.random.PRNGKey(5), 0)  # the step's key at step 0
        drawn = fam.jax_draw(key, fam.draw_shape(pcfg, batch), False, len(ds.all_item_ids))
    rows = np.cumsum([0] + [len(h["ids"]) for h in halves])
    lr = jcfg.optimizer1.lr
    case = {"cfg": pcfg, "state": params_to_state_dict(params), "packed": False, "lr": lr,
            "batches": halves, "drawn": [drawn[a:b] for a, b in zip(rows[:-1], rows[1:])],
            "tails": [int(h["sample_weight"].sum()) for h in halves]}

    def want() -> dict:
        with jax.sharding.set_mesh(mesh):  # every JAX array made under it
            placed = jax.tree_util.tree_map(jnp.asarray, params)
            if jcfg.model.encoder.tp_shards > 1:
                placed = place_tp_params(placed, mesh)
            jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
            jloss = jax_task.make_loss_fn(jmodel, jcfg, ds.all_item_ids)
            step = jax.jit(jax.value_and_grad(jloss)).lower(placed, jbatch, key).compile()
            loss, grads = step(placed, jbatch, key)
            # the optimizer step of JAX's train_step_from_loss (:355-360)
            tx = jax_opt.build_optimizer(jcfg.optimizer1, None, placed, lr, lr)
            updates, _ = jax.jit(tx.update)(grads, tx.init(placed), placed)
            after = jax.tree.map(lambda p, u: p + u, placed, updates)
            enc = pcfg.model.encoder
            width = 2 * enc.num_heads * (enc.linear_dim + enc.attention_dim) // model
            return {"loss": float(loss), "grads": grads_to_state_dict(fam.np_tree(grads)),
                    "params": params_to_state_dict(fam.np_tree(after)),
                    "layout": {**_compiled_layout(step.as_text(), width),
                               "heads": enc.num_heads // model, "h": enc.num_heads,
                               "zigzag": enc.sp_zigzag, "remat": enc.remat,
                               "concat_ua": enc.concat_ua}}

    return case, want


def _compiled_layout(text: str, uvqk_width: int) -> dict:
    """From the text of JAX's compiled step: the shape of block 0's uvqk dot
    in the forward, [rows, uvqk_width] ("uvqk"), and the shapes [local
    batch, rows, heads, d] of the K/V blocks its ring rotates ("ring")."""
    uvqk, ring = set(), set()
    for line in text.splitlines():
        dot = re.match(r"\s*%\S+ = f32\[(\d+),(\d+)\]\S* dot\(", line)
        if dot and re.search(r'op_name="[^"]*/block_0/dot_general"', line) \
                and "transpose(" not in line and int(dot.group(2)) == uvqk_width:
            uvqk.add(int(dot.group(1)))
        kv = re.match(r"\s*%\S+ = f32\[(\d+),(\d+),(\d+),(\d+)\]\S* collective-permute\(",
                      line)
        if kv:
            ring.add(tuple(int(x) for x in kv.groups()))
    return {"uvqk": uvqk, "ring": ring}


TWO_RANK_STEPS = {
    "ring": dict(overrides=RING),
    "contiguous": dict(overrides=CONTIGUOUS),
    "ring_remat": dict(overrides=REMAT),
}
FOUR_RANK_STEPS = {
    # the data index innermost: two data indices of 8 rows, each an sp group
    "ring_data2": dict(overrides=RING, data=2, batch_size=8),
    "ring_tp": dict(overrides=RING + (("model.encoder.tp_shards", 2),), model=2, heads=2),
    # the [u, a, u*a] column blocks are not head-aligned: `a` gathered over
    # the model group
    "ring_tp_concat_ua": dict(overrides=RING + (("model.encoder.tp_shards", 2),
                                                ("model.encoder.concat_ua", True)),
                              model=2, heads=2),
}


def _fit_args(out):
    return ["experiment=synthetic-smoke", "trainer.device=cpu", "trainer.distributed=true",
            f"trainer.output_dir={out}", "trainer.max_epochs=2", "trainer.min_epochs=1",
            f"data.synthetic_num_users={USERS}", "data.batch_size=16",
            "model.encoder.sp_shards=2", "model.encoder.sp_zigzag=true",
            "trainer.mesh_data_innermost=true"]


def _bodies() -> dict:
    """One [B, N, H, d] input of the ring's bodies (N divides by 2 x 2)."""
    rng = np.random.default_rng(7)
    b, n, h, d, max_len = 2, 24, 2, 8, 24

    def normal(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))

    ts = torch.from_numpy(np.sort(rng.integers(0, 10**7, size=(b, n)), axis=1).astype(np.int32))
    inputs = (normal(b, n, h, d), normal(b, n, h, d), normal(b, n, h, d), ts,
              normal(2 * max_len - 1, scale=0.1), normal(129, scale=0.1))
    return {"port": _free_port(), "inputs": inputs, "g": normal(b, n, h, d), "max_len": max_len}


def _launch(tmp, world: int, steps: dict, fits: dict, bodies=None) -> list:
    torch.save({"steps": steps, "fits": fits, "bodies": bodies,
                "ports": _free_ports(len(steps) + len(fits))}, tmp / "job.pt")
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", PYTHONPATH=REPO)
        with open(tmp / f"rank{rank}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tests.torch_port_ring_axis", str(tmp / "job.pt"),
                 str(tmp)], cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring2")
    steps, wants = {}, {}
    for name, kwargs in TWO_RANK_STEPS.items():
        steps[name], wants[name] = _jax_case(**kwargs)
    fits = {"ring": _fit_args(tmp / "ring")}
    procs = _launch(tmp, 2, steps, fits, _bodies())
    wants = {name: want() for name, want in wants.items()}  # while the ranks run
    return _collect(tmp, procs), wants, fits


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring4")
    steps, wants = {}, {}
    for name, kwargs in FOUR_RANK_STEPS.items():
        steps[name], wants[name] = _jax_case(**kwargs)
    procs = _launch(tmp, 4, steps, {})
    wants = {name: want() for name, want in wants.items()}
    return _collect(tmp, procs), wants, steps


@pytest.mark.parametrize("name", list(TWO_RANK_STEPS))
def test_a_two_rank_ring_step_gives_jaxs_step(two_ranks, name):
    results, wants, _ = two_ranks
    for rank in (0, 1):
        _check_step(results[rank]["steps"][name], wants[name], f"rank {rank}")


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_the_ring_over_the_group_gives_the_one_device_ring(two_ranks, layout):
    """Each rank's rows of the output and of q's, k's and v's gradients are
    the one-device ring's; the tables' gradients are the ranks' parts, whose
    sum is the one-device ring's."""
    results, _, _ = two_ranks
    got = [results[rank]["bodies"][layout, "group"] for rank in (0, 1)]
    want = [results[rank]["bodies"][layout, "one device"] for rank in (0, 1)]
    for rank in (0, 1):
        for i, name in enumerate(("out", "dq", "dk", "dv")):
            np.testing.assert_allclose(got[rank][i].numpy(), want[rank][i].numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"rank {rank} {layout} {name}")
        # over 2 ranks: forward, the first timestamps' gather and one
        # rotation; backward, one rotation back (the rows come in and go out
        # as the rank's, and the tables' parts are summed by the step)
        assert results[rank]["bodies"][layout, "collectives"] == 2 + 1
    for i, name in ((4, "d_pos_w"), (5, "d_ts_w")):
        np.testing.assert_allclose((got[0][i] + got[1][i]).numpy(), want[0][i].numpy(),
                                   rtol=BIAS_RTOL, atol=ATOL, err_msg=f"{layout} {name}")


def test_both_ranks_of_an_sp_group_fit_alike(two_ranks):
    results, _, _ = two_ranks
    a, b = (results[r]["fits"]["ring"] for r in (0, 1))
    assert a["sizes"] == b["sizes"] == (1, 1, 1) and a["sp"] == b["sp"] == 2
    assert a["val"] and a["val"] == b["val"]
    assert a["test"] == b["test"] and a["predict"] == b["predict"]
    assert len(a["losses"]) == 2 and np.all(np.isfinite(a["losses"]))
    assert a["losses"] == b["losses"]
    assert a["replicas_equal"] and b["replicas_equal"]
    for key, p in a["state"].items():
        assert torch.equal(p, b["state"][key]), key


def test_a_two_rank_ring_checkpoint_loads_into_one_process_with_equal_val_metrics(two_ranks):
    results, _, fits = two_ranks
    args = [a for a in fits["ring"] if not a.startswith("trainer.distributed")]
    out = next(a.split("=", 1)[1] for a in args if a.startswith("trainer.output_dir="))
    last = os.path.join(out, "synthetic-smoke", "checkpoints", "last.pt")
    state = torch.load(last, weights_only=True)["model"]
    for key, p in results[0]["fits"]["ring"]["state"].items():
        assert torch.equal(state[key], p), key
    trainer = Trainer(cli_train.parse_args(args + [f"trainer.output_dir={out}-one"]))
    trainer.load_weights(last)
    got = trainer.eval_epoch(trainer._loader("val"), "val")
    want = results[0]["fits"]["ring"]["val"]
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-6, abs=1e-9), key


@pytest.mark.parametrize("name", list(FOUR_RANK_STEPS))
def test_a_four_rank_ring_step_gives_jaxs_step(four_ranks, name):
    results, wants, steps = four_ranks
    if name == "ring_data2":
        tails = steps[name]["tails"]
        assert tails[0] != tails[1], tails
    for rank in range(4):
        _check_step(results[rank]["steps"][name], wants[name], f"rank {rank}")


def _check_layout(got: dict, want: dict, who: str) -> None:
    """Every block of the rank ran on the stack's rows / sp (N padded to the
    ring's chunks) and every chunk call saw H / tp heads; in JAX's compiled
    step the ring rotates blocks of the same rows and heads, and block 0's
    uvqk dot runs the same rows / sp in the contiguous layout, where GSPMD
    carries the `shard_map`'s sequence sharding back through the block
    (the pad included). In the zigzag layout the permutation before the
    `shard_map` stops it, and JAX's uvqk dot runs all N rows on every
    device, which the port does not follow: its stack splits the rows in
    both layouts."""
    sp, heads = 2, want["heads"]
    n = set(got["stack"])
    assert len(n) == 1 and got["blocks"], (who, got)
    n = n.pop()
    chunks = 2 * sp if want["zigzag"] else sp
    rows = -(-n // chunks) * chunks // sp
    assert set(got["blocks"]) == {rows}, (who, set(got["blocks"]), rows)
    assert got["heads"] and set(got["heads"]) == {heads}, (who, set(got["heads"]))
    (batch, ring_rows, ring_heads, _), = want["ring"]
    assert (ring_rows, ring_heads) == (rows, heads), (who, want["ring"])
    assert want["uvqk"] == {batch * (n if want["zigzag"] else rows)}, (who, want["uvqk"], n)
    # over the sp group: the stack's exit gather and the backward's gather of
    # the entry's cotangent rows; a block's first timestamps' gather and one
    # rotation, its backward one rotation back (with remat the recompute's
    # two again); over the model group a block's projection gather, the
    # LayerNorm's statistics and the output's sum, each summed back in the
    # backward but the last (with concat_ua the gather of `a` and its sum)
    blocks = len(got["blocks"]) // (2 if want["remat"] else 1)
    per_block = 3 + 2 * want["remat"] + (6 + 2 * want["concat_ua"]) * (want["heads"] < want["h"])
    assert got["collectives"] == 2 + per_block * blocks, (who, got["collectives"], blocks)


@pytest.mark.parametrize("name", list(TWO_RANK_STEPS))
def test_each_rank_of_a_two_rank_ring_runs_the_blocks_on_its_rows(two_ranks, name):
    results, wants, _ = two_ranks
    for rank in (0, 1):
        _check_layout(results[rank]["layout"][name], wants[name]["layout"], f"rank {rank}")


@pytest.mark.parametrize("name", list(FOUR_RANK_STEPS))
def test_each_rank_of_a_four_rank_ring_runs_the_blocks_on_its_rows_and_heads(four_ranks, name):
    results, wants, _ = four_ranks
    for rank in range(4):
        _check_layout(results[rank]["layout"][name], wants[name]["layout"], f"rank {rank}")


def test_a_world_the_axes_do_not_divide_raises_naming_the_knobs(tmp_path, monkeypatch):
    for name, value in dict(RANK="0", WORLD_SIZE="3", LOCAL_RANK="0", MASTER_ADDR="localhost",
                            MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(name, value)
    args = ["experiment=synthetic-smoke", "trainer.device=cpu", "trainer.distributed=true",
            f"trainer.output_dir={tmp_path}", "model.encoder.sp_shards=2"]
    with pytest.raises(ValueError, match=r"world size 3 does not divide .* sp axis 2 .*"
                                         r"encoder\.sp_shards"):
        Trainer(cli_train.parse_args(args))


def test_tp_with_heads_it_does_not_divide_raises_under_the_ring(tmp_path, monkeypatch):
    for name, value in dict(RANK="0", WORLD_SIZE="4", LOCAL_RANK="0", MASTER_ADDR="localhost",
                            MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(name, value)
    args = ["experiment=synthetic-smoke", "trainer.device=cpu", "trainer.distributed=true",
            f"trainer.output_dir={tmp_path}", "model.encoder.sp_shards=2",
            "model.encoder.tp_shards=2", "model.encoder.num_heads=1"]
    with pytest.raises(ValueError, match=r"num_heads=1 must divide by "
                                         r"model\.encoder\.tp_shards=2 with "
                                         r"model\.encoder\.sp_shards=2"):
        Trainer(cli_train.parse_args(args))
