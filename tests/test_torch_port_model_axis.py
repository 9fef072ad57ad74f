"""The port's "model" axis over processes (gloo on the CPU) against the JAX
package's one-process step on the 8-device CPU mesh: the sharded tables and
the sharded index over a model group, and tensor parallelism
(`encoder.tp_shards`) over processes and on one device.

Module fixtures launch the ranks of `tests/torch_port_model_axis.py` once a
world size (torchrun's environment, gloo):

- two ranks, a model group of 2: one step each of JAX's `a2a_tp` recipe
  (sharded_a2a over 2 shards, tp_shards 2; tests/distributed_worker.py) and
  its `packed_sharded` recipe (packed rows, sharded_a2a, the sharded
  index), of sharded_local with TP and Muon on the encoder (NS-5 on the
  whole logical matrices, in float32 on both sides as
  tests/test_torch_port_optimizers.py holds Muon) and of sharded_column, with the JAX draw handed
  in and dropout off: the loss, the gradients gathered into the
  one-process layout and the parameters after the step equal JAX's step
  over the same global batch, its leaves placed as JAX's trainer places
  them (`place_tp_params`, the table's sharding), at rtol 2e-4 / atol 2e-5
  (the bias tables' gradients at 5e-4). Then two epochs of `fit` of the
  `a2a_tp` recipe (with the int8 sharded index) and of `packed_sharded`
  (two steps a call), `predict` and `test`: both ranks' metrics, losses
  and predictions equal to the bit, the replicated leaves bit-equal across
  the ranks, the packed eval equal to the unpacked one within 1e-6 (JAX's
  own check, tests/distributed_worker.py:113-120), and the checkpoint
  loaded into a one-process run of the port with equal val metrics;
- four ranks: one step of sharded_2d over model 2 x col 2, and of the
  `a2a_tp` recipe over data 2 x model 2 (the data index innermost, as
  JAX's recipe lays it out), whose two data indices' batches have
  different tails.

In one process: the one-device TP form (`encoder.tp_shards=2`, no group)
takes JAX's `a2a_tp` step, and `ProcessGroupShards` over a world of one
rank gives `OneDeviceShards`' rows and table gradients.
"""

import functools
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mygenerativerecommenders_tpu.models.model import build_model as jax_build_model
from mygenerativerecommenders_tpu.parallel.mesh import make_mesh
from mygenerativerecommenders_tpu.parallel.tensor_parallel import place_tp_params
from mygenerativerecommenders_tpu.train import task_retrieval as jax_task
from mygenerativerecommenders_tpu.train import optimizers as jax_opt
from mygenerativerecommenders_tpu.utils.features import packed_seq_features as jax_packed_features
from mygenerativerecommenders_tpu.utils.features import seq_features_from_batch as jax_features
from mygenerativerecommenders_tpu_torch.checkpoint import grads_to_state_dict, params_to_state_dict
from mygenerativerecommenders_tpu_torch.cli import train as cli_train
from mygenerativerecommenders_tpu_torch.configs import resolve as pt_resolve
from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
from mygenerativerecommenders_tpu_torch.data.packing import PackedBatchLoader
from mygenerativerecommenders_tpu_torch.parallel import embedding_sharding as pes
from mygenerativerecommenders_tpu_torch.parallel import process_group
from mygenerativerecommenders_tpu_torch.train.driver import Trainer
from tests import torch_port_families as fam
from tests.torch_port_distributed import take_step
from tests.torch_port_model_axis import ns_float32 as ns_f32
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL, ATOL, BIAS_RTOL = 2e-4, 2e-5, 5e-4  # the port's kernel tolerances
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
USERS = 61  # odd: two data indices' last batches have different tails
TP = (("model.encoder.tp_shards", 2),)
A2A = (("model.embedding.kind", "sharded_a2a"), ("model.embedding.num_shards", 2))
# JAX's table placement (train/driver.py:163-183)
TABLE_SPEC = {"sharded_local": P("model", None), "sharded_a2a": P("model", None),
              "sharded_column": P(None, "model"), "sharded_2d": P("model", "col")}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _free_ports(n: int) -> list:
    ports = set()
    while len(ports) < n:
        ports.add(_free_port())
    return sorted(ports)


def _halves(pcfg, data: int, packed: bool) -> list:
    """Each data index's share of one global batch: the epoch's last padded
    batch (its tails differ over two indices), or the packed global batch
    whose indices' segment counts differ most."""
    ds = RecoData(pcfg.data, seed=42)
    if not packed:
        return [list(ds.loader("train", process_index=d, process_count=data))[-1]
                for d in range(data)]
    loaders = [PackedBatchLoader(
        ds.dataset("train"), rows_per_batch=data, row_capacity=max(fam.CAPACITIES),
        capacities=fam.CAPACITIES, segments_per_batch=8, shuffle=True, seed=42,
        include_target=True, process_index=d, process_count=data, row_multiple=data)
        for d in range(data)]
    return list(max(zip(*loaders), key=lambda p: (len(p[0]["ids"]), -int(p[0]["num_segments"].sum()))))


def _jax_case(overrides, mesh_shape, data=1, packed=False, heads=1, innermost=False,
              ns_float32=False):
    """(the ranks' step case, want(): JAX's loss, gradients and parameters
    after one step over the global batch on a mesh of `mesh_shape` (data,
    model, col), its leaves placed as the JAX trainer places them)."""
    jcfg, pcfg = fam._configs("synthetic-smoke", overrides, heads)
    for cfg in (jcfg, pcfg):
        cfg.data.synthetic_num_users = USERS
        if packed:
            cfg.data.max_sequence_length = 36
            cfg.data.synthetic_max_seq_len = 45
            cfg.data.pack_sequences = True
            cfg.data.pack_capacities = fam.CAPACITIES
    pcfg.trainer.mesh_data_innermost = innermost
    halves = _halves(pcfg, data, packed)
    batch = {k: np.concatenate([h[k] for h in halves]) for k in halves[0]}
    ds = RecoData(pcfg.data, seed=42)
    fam.jax_resolve(jcfg, ds.max_item_id)
    pt_resolve(pcfg, ds.max_item_id)
    jmodel = jax_build_model(jcfg)
    mesh = make_mesh(*mesh_shape)
    with jax.sharding.set_mesh(mesh):  # every JAX array made under it
        seq = jax_packed_features(batch) if packed else jax_features(
            batch, jcfg.model.gr_output_length + 1)[0]
        key0 = jax.random.PRNGKey(0)
        # jitted, as the JAX trainer inits (one compile, not one an op)
        params = fam.np_tree(jax.jit(functools.partial(jmodel.init, method=jmodel.init_all))(
            {"params": key0, "dropout": key0}, seq))
        rng = jax.random.PRNGKey(5)
        key = jax.random.fold_in(rng, 0)  # the step's key at step 0
        drawn = fam.jax_draw(key, fam.draw_shape(pcfg, batch, packed), False, len(ds.all_item_ids))
    rows = np.cumsum([0] + [len(h["ids"]) for h in halves])
    lr = jcfg.optimizer1.lr
    case = {"cfg": pcfg, "state": params_to_state_dict(params), "packed": packed, "lr": lr,
            "batches": halves, "drawn": [drawn[a:b] for a, b in zip(rows[:-1], rows[1:])],
            "ns_float32": ns_float32}

    def want() -> dict:
        with jax.sharding.set_mesh(mesh), pytest.MonkeyPatch.context() as patch:
            if ns_float32:
                patch.setattr(jax_opt, "zeropower_via_newtonschulz5",
                              lambda g, steps=5: ns_f32(g.astype(jnp.float32), steps, jnp))
            placed = jax.tree_util.tree_map(jnp.asarray, params)
            kind = jcfg.model.embedding.kind
            if kind in TABLE_SPEC and jcfg.model.embedding.num_shards > 1:
                p = dict(placed["params"])
                p["embeddings"] = dict(p["embeddings"], item_emb=jax.device_put(
                    p["embeddings"]["item_emb"], NamedSharding(mesh, TABLE_SPEC[kind])))
                placed = {**placed, "params": p}
            if jcfg.model.encoder.tp_shards > 1:
                placed = place_tp_params(placed, mesh)
            jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
            jloss = jax_task.make_loss_fn(jmodel, jcfg, ds.all_item_ids, packed=packed)
            loss, grads = jax.jit(jax.value_and_grad(jloss))(placed, jbatch, key)
            # the optimizer step of JAX's train_step_from_loss (:355-360),
            # on these gradients: no second compile of the forward
            opt2 = jcfg.optimizer2 if jcfg.optimizer2.enabled else None
            tx = jax_opt.build_optimizer(jcfg.optimizer1, opt2, placed, lr, lr)
            updates, _ = jax.jit(tx.update)(grads, tx.init(placed), placed)
            after = jax.tree.map(lambda p, u: p + u, placed, updates)
            return {"loss": float(loss), "grads": grads_to_state_dict(fam.np_tree(grads)),
                    "params": params_to_state_dict(fam.np_tree(after))}

    return case, want


TWO_RANK_STEPS = {
    "a2a_tp": dict(overrides=A2A + TP, mesh_shape=(4, 2, 1)),
    "packed_sharded": dict(overrides=A2A + (("model.index.sharded", "true"),),
                           mesh_shape=(4, 2, 1), packed=True, heads=2),
    "local_tp_muon": dict(overrides=(("model.embedding.kind", "sharded_local"),
                                     ("model.embedding.num_shards", 2)) + TP + (
        ("optimizer2.enabled", True), ("optimizer2.kind", "muon"), ("optimizer2.lr", 0.005)),
        mesh_shape=(4, 2, 1), ns_float32=True),
    "column": dict(overrides=(("model.embedding.kind", "sharded_column"),
                              ("model.embedding.num_shards", 2)), mesh_shape=(4, 2, 1)),
}
FOUR_RANK_STEPS = {
    "sharded_2d": dict(overrides=(("model.embedding.kind", "sharded_2d"),
                                  ("model.embedding.num_shards", 2),
                                  ("model.embedding.col_shards", 2),
                                  ("model.embedding.a2a_capacity_factor", 0.5)),
                       mesh_shape=(2, 2, 2)),
    "a2a_tp_data2": dict(overrides=A2A + TP, mesh_shape=(4, 2, 1), data=2, innermost=True),
}


def _fit_args(out, *extra):
    return ["experiment=synthetic-smoke", "trainer.device=cpu", "trainer.distributed=true",
            f"trainer.output_dir={out}", "trainer.max_epochs=2", "trainer.min_epochs=1",
            f"data.synthetic_num_users={USERS}", "data.batch_size=8",
            "model.embedding.kind=sharded_a2a", "model.embedding.num_shards=2",
            "trainer.mesh_data_innermost=true", *extra]


FITS = {
    "a2a_tp": ["model.encoder.tp_shards=2", "model.index.quantize=int8"],
    "packed_sharded": ["data.pack_sequences=true", "data.pack_eval=true",
                       "trainer.steps_per_call=2"],
}


def _launch(tmp, world: int, steps: dict, fits: dict) -> list:
    torch.save({"steps": steps, "fits": fits, "ports": _free_ports(len(steps) + len(fits))},
               tmp / "job.pt")
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", PYTHONPATH=REPO)
        with open(tmp / f"rank{rank}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tests.torch_port_model_axis", str(tmp / "job.pt"),
                 str(tmp)], cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def _collect(tmp, procs) -> list:
    try:
        for p in procs:
            p.wait(timeout=400)
    finally:  # a rank left waiting on a collective goes with the test
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, p in enumerate(procs):
        text = (tmp / f"rank{rank}.log").read_text()
        assert p.returncode == 0, f"rank {rank} failed:\n{text[-4000:]}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model2")
    steps, wants = {}, {}
    for name, kwargs in TWO_RANK_STEPS.items():
        steps[name], wants[name] = _jax_case(**kwargs)
    fits = {name: _fit_args(tmp / name, *extra) for name, extra in FITS.items()}
    procs = _launch(tmp, 2, steps, fits)
    wants = {name: want() for name, want in wants.items()}  # while the ranks run
    return _collect(tmp, procs), wants, steps, fits


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model4")
    steps, wants = {}, {}
    for name, kwargs in FOUR_RANK_STEPS.items():
        steps[name], wants[name] = _jax_case(**kwargs)
    procs = _launch(tmp, 4, steps, {})
    wants = {name: want() for name, want in wants.items()}
    return _collect(tmp, procs), wants


def _check_step(got: dict, want: dict, who: str) -> None:
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, err_msg=who)
    assert got["grads"].keys() == want["grads"].keys()
    for key, g in got["grads"].items():
        rtol = BIAS_RTOL if "_rel_attn_bias" in key else RTOL
        np.testing.assert_allclose(g.numpy(), want["grads"][key].numpy(), rtol=rtol, atol=ATOL,
                                   err_msg=f"{who} grad {key}")
    assert got["params"].keys() == want["params"].keys()
    for key, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), want["params"][key].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{who} param {key}")


@pytest.mark.parametrize("name", list(TWO_RANK_STEPS))
def test_a_two_rank_model_group_step_gives_jaxs_step(two_ranks, name):
    results, wants, _, _ = two_ranks
    for rank in (0, 1):
        _check_step(results[rank]["steps"][name], wants[name], f"rank {rank}")


@pytest.mark.parametrize("name", list(FOUR_RANK_STEPS))
def test_a_four_rank_mesh_step_gives_jaxs_step(four_ranks, name):
    results, wants = four_ranks
    for rank in range(4):
        _check_step(results[rank]["steps"][name], wants[name], f"rank {rank}")


@pytest.mark.parametrize("name", list(FITS))
def test_both_ranks_of_a_model_group_fit_alike(two_ranks, name):
    results, _, _, _ = two_ranks
    a, b = (results[r]["fits"][name] for r in (0, 1))
    assert a["sizes"] == b["sizes"] == (1, 2, 1)
    assert a["val"] and a["val"] == b["val"]
    assert a["test"] == b["test"] and a["predict"] == b["predict"]
    assert len(a["losses"]) == 2 and np.all(np.isfinite(a["losses"]))
    assert a["losses"] == b["losses"]
    assert a["replicas_equal"] and b["replicas_equal"]
    assert a["state"].keys() == b["state"].keys()
    for key, p in a["state"].items():
        assert torch.equal(p, b["state"][key]), key
    if name == "packed_sharded":
        for key, value in a["val_unpacked"].items():
            assert abs(a["val"][key] - value) < 1e-6, (key, a["val"][key], value)


@pytest.mark.parametrize("name", list(FITS))
def test_a_two_rank_checkpoint_loads_into_one_process_with_equal_val_metrics(two_ranks, name):
    results, _, _, fits = two_ranks
    args = [a for a in fits[name] if not a.startswith("trainer.distributed")]
    out = next(a.split("=", 1)[1] for a in args if a.startswith("trainer.output_dir="))
    last = os.path.join(out, "synthetic-smoke", "checkpoints", "last.pt")
    state = torch.load(last, weights_only=True)["model"]
    for key, p in results[0]["fits"][name]["state"].items():
        assert torch.equal(state[key], p), key  # the one-process layout, whole
    trainer = Trainer(cli_train.parse_args(args + [f"trainer.output_dir={out}-one"]))
    trainer.load_weights(last)
    got = trainer.eval_epoch(trainer._loader("val", packed=trainer._eval_packed), "val")
    want = results[0]["fits"][name]["val"]
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-6, abs=1e-9), key


def test_one_device_tp_takes_jaxs_step(two_ranks):
    """encoder.tp_shards=2 without a group: the K column blocks of each
    projection are one matmul, and the step is JAX's on the TP mesh."""
    _, wants, steps, _ = two_ranks
    _check_step(take_step(steps["a2a_tp"], 0), wants["a2a_tp"], "one device")


def test_process_group_shards_of_one_rank_give_the_one_device_rows(tmp_path, monkeypatch):
    for name, value in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                            MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(name, value)
    trainer_cfg = cli_train.parse_args(["trainer.device=cpu", "trainer.distributed=true"]).trainer
    mesh = process_group.init_data_parallel(trainer_cfg)
    try:
        group = pes.ProcessGroupShards(mesh.data_pg, 0, 1)
        rng = np.random.default_rng(0)
        table = rng.normal(size=(12, 4)).astype(np.float32)
        ids = torch.from_numpy(rng.integers(-1, 12, size=9))
        for shards in (group, pes.OneDeviceShards(1)):
            t = torch.from_numpy(table.copy()).requires_grad_()
            rows = pes.owner_routed_lookup_sliced(shards, t.view(1, 12, 4), ids.clamp(min=0)[None],
                                                  cap=3)[0]
            psum = shards.gather_psum(t.view(1, 12, 4), ids)
            cols = pes.column_lookup(shards, t, ids.clamp(min=0))
            (rows.sum() + 2 * psum.sum() + 3 * cols.sum()).backward()
            if shards is group:
                got = (rows.detach(), psum.detach(), cols.detach(), t.grad)
        want = (rows.detach(), psum.detach(), cols.detach(), t.grad)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    finally:
        process_group.shutdown()
