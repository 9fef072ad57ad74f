"""The port's data parallel over two processes (gloo on the CPU) against the
JAX package's one-process step and eval, and the raise of what it does not
run yet (the ring over processes).

A module fixture launches two ranks of `tests/torch_port_distributed.py`
once (torchrun's environment, gloo), which take:

- one step each of the padded, packed and in-batch retrieval losses, with
  the JAX draw handed in and dropout off, over a global batch whose two
  halves have different tails (-1 rows, fewer segments): the gradients
  (summed over the ranks) and the parameters after the AdamW step equal
  JAX's one-process step over the same global batch on the 8-device CPU
  mesh at rtol 2e-4 / atol 2e-5, the weights carried over by
  `params_to_state_dict`. An average of the two ranks' means would miss;
  the global weight sum hits;
- one step each of Muon, the lazy table update with shared negatives and
  the ranking loss, equal to the port's own one-process step over the
  global batch (each is held to JAX by its own tests);
- `Trainer.fit` with `trainer.distributed` on the padded, packed and
  length-bucketed (two steps a call) retrieval recipes and on ranking, for
  two epochs, and the padded run resumed from its checkpoint: both
  ranks' gathered val metrics, `predict` and `test` are equal to the bit,
  the losses finite, a rank's rows the same under `mesh_data_innermost`, and
  the padded run's val metrics equal JAX's `eval_epoch` on its weights;
- after those, a Trainer of a sharded kind and one with TP, which raised
  before the model axis was ported, built on a mesh of their own: a model
  group of 2 and a data group of 1.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.cli.convert_ckpt import torch_state_dict_to_params
from mygenerativerecommenders_tpu.configs import apply_overrides as jax_overrides
from mygenerativerecommenders_tpu.configs.presets import get_preset as jax_preset
from mygenerativerecommenders_tpu.train import task_retrieval as jax_task
from mygenerativerecommenders_tpu.train.driver import Trainer as JaxTrainer
from mygenerativerecommenders_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from mygenerativerecommenders_tpu.utils.features import packed_seq_features as jax_packed_features
from mygenerativerecommenders_tpu.utils.features import seq_features_from_batch as jax_features
from mygenerativerecommenders_tpu_torch.checkpoint import grads_to_state_dict, params_to_state_dict
from mygenerativerecommenders_tpu_torch.cli import train as cli_train
from mygenerativerecommenders_tpu_torch.configs import resolve as pt_resolve
from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
from mygenerativerecommenders_tpu_torch.data.packing import PackedBatchLoader
from mygenerativerecommenders_tpu_torch.models.model import build_model as pt_build_model
from mygenerativerecommenders_tpu_torch.train.driver import Trainer
from tests import torch_port_families as fam
from tests.torch_port_distributed import take_step
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL, ATOL = 2e-4, 2e-5  # the port's kernel tolerances
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
USERS = 61  # odd: the ranks' last batches have different tails
DROPOUT_OFF = ["model.preprocessor.dropout_rate=0.0", "model.encoder.linear_dropout_rate=0.0"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _padded_halves(pcfg):
    """The two ranks' last train batches of an epoch (rank 0 with one more
    row than rank 1, both with -1 rows), and their concatenation."""
    data = RecoData(pcfg.data, seed=42)
    halves = [list(data.loader("train", process_index=r, process_count=2))[-1] for r in (0, 1)]
    assert [int(h["sample_weight"].sum()) for h in halves] == [7, 6]
    return halves


def _packed_halves(pcfg):
    """The two ranks' shares of the packed global batch whose segment
    counts differ most."""
    data = RecoData(pcfg.data, seed=42)
    loaders = [PackedBatchLoader(
        data.dataset("train"), rows_per_batch=1, row_capacity=max(fam.CAPACITIES),
        capacities=fam.CAPACITIES, segments_per_batch=8, shuffle=True, seed=42,
        include_target=True, process_index=r, process_count=2) for r in (0, 1)]
    pairs = list(zip(*loaders))
    halves = max(pairs, key=lambda p: abs(int(p[0]["num_segments"].sum())
                                          - int(p[1]["num_segments"].sum())))
    assert halves[0]["num_segments"].sum() != halves[1]["num_segments"].sum()
    return list(halves)


def _join(halves):
    return {k: np.concatenate([h[k] for h in halves]) for k in halves[0]}


def _jax_case(overrides, packed=False, heads=1):
    """(job entry, want(): JAX's loss, gradients and parameters after one
    AdamW step over the global batch, computed while the ranks run)."""
    jcfg, pcfg = fam._configs("synthetic-smoke", overrides, heads)
    if packed:
        for cfg in (jcfg, pcfg):
            cfg.data.max_sequence_length = 36
            cfg.data.synthetic_max_seq_len = 45
            cfg.data.pack_sequences = True
            cfg.data.pack_capacities = fam.CAPACITIES
    for cfg in (jcfg, pcfg):
        cfg.data.synthetic_num_users = USERS
    halves = _packed_halves(pcfg) if packed else _padded_halves(pcfg)
    batch = _join(halves)
    data = RecoData(pcfg.data, seed=42)
    seq = jax_packed_features(batch) if packed else jax_features(
        batch, jcfg.model.gr_output_length + 1)[0]
    jmodel, params, pmodel = fam._both_models(jcfg, pcfg, data, seq)
    in_batch = pcfg.model.sampler.kind == "in_batch"
    rng = jax.random.PRNGKey(5)
    key = jax.random.fold_in(rng, 0)  # the step's key at step 0
    lr = jcfg.optimizer1.lr
    drawn = fam.jax_draw(key, fam.draw_shape(pcfg, batch, packed), in_batch,
                         len(data.all_item_ids))
    rows = len(halves[0]["ids"])
    case = {"cfg": pcfg, "state": pmodel.state_dict(), "packed": packed, "lr": lr,
            "batches": halves, "drawn": [drawn[:rows], drawn[rows:]]}

    def want() -> dict:
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jloss = jax_task.make_loss_fn(jmodel, jcfg, data.all_item_ids, packed=packed)
        loss, grads = jax.jit(jax.value_and_grad(jloss))(params, jbatch, key)
        opt_state = jax_build_optimizer(jcfg.optimizer1, None, params, lr, lr).init(params)
        jstep = jax_task.make_train_step(jmodel, jcfg, data.all_item_ids, packed=packed)
        out = jstep(params, opt_state, jbatch, rng, lr, lr, 0)
        return {"loss": float(loss), "grads": grads_to_state_dict(fam.np_tree(grads)),
                "params": params_to_state_dict(fam.np_tree(out.params))}

    return case, want


def _port_case(overrides, preset="synthetic-smoke"):
    """(job entry, the port's one-process step over the global batch)."""
    pcfg = cli_train.parse_args([f"experiment={preset}", "trainer.device=cpu", *DROPOUT_OFF,
                                 f"data.synthetic_num_users={USERS}", *overrides])
    halves = _padded_halves(pcfg)
    data = RecoData(pcfg.data, seed=42)
    pt_resolve(pcfg, data.max_item_id)
    drawn = None
    if pcfg.model.task == "retrieval":
        gen = torch.Generator().manual_seed(9)
        n, r = len(data.all_item_ids), pcfg.model.loss.num_to_sample
        if pcfg.model.loss.shared_negatives:  # the same R on every rank
            drawn = [torch.randint(0, n, (r,), generator=gen, dtype=torch.int32)] * 2
        else:
            cols = halves[0]["ids"].shape[1] + pcfg.model.gr_output_length
            drawn = [torch.randint(0, n, (len(h["ids"]), cols, r), generator=gen,
                                   dtype=torch.int32) for h in halves]
    case = {"cfg": pcfg, "state": pt_build_model(pcfg, device="cpu", seed=3).state_dict(),
            "packed": False, "lr": pcfg.optimizer1.lr, "batches": halves, "drawn": drawn}
    whole = dict(case, batches=[_join(halves)])
    if drawn is not None:
        whole["drawn"] = [drawn[0] if pcfg.model.loss.shared_negatives else torch.cat(drawn)]
    return case, take_step(whole, 0)


JAX_CASES = {
    "padded": dict(overrides=[]),
    "packed": dict(overrides=[], packed=True, heads=2),
    "in_batch": dict(overrides=[("model.sampler.kind", "in_batch")]),
}
PORT_CASES = {
    "muon": dict(overrides=["optimizer2.enabled=true", "optimizer2.kind=muon",
                            "optimizer2.lr=0.005"]),
    "lazy_shared": dict(overrides=["model.loss.shared_negatives=true",
                                   "model.embedding.lazy_update=true"]),
    "ranking": dict(overrides=[], preset="synthetic-rank-smoke"),
}


def _fit_args(out, preset, *extra):
    return [f"experiment={preset}", "trainer.device=cpu", "trainer.distributed=true",
            f"trainer.output_dir={out}", "trainer.max_epochs=2", "trainer.min_epochs=1",
            f"data.synthetic_num_users={USERS}", "data.batch_size=4", *extra]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results, with what each case is held to."""
    tmp = tmp_path_factory.mktemp("dp")
    steps, wants, jax_wants = {}, {}, {}
    for name, kwargs in JAX_CASES.items():
        steps[name], jax_wants[name] = _jax_case(**kwargs)
    for name, kwargs in PORT_CASES.items():
        steps[name], wants[name] = _port_case(**kwargs)
    fits = {
        "padded": _fit_args(tmp / "padded", "synthetic-smoke"),
        "packed": _fit_args(tmp / "packed", "synthetic-smoke", "data.pack_sequences=true",
                            "data.pack_eval=true", "trainer.steps_per_call=2"),
        "bucketed": _fit_args(tmp / "bucketed", "synthetic-smoke", "data.length_buckets=[8,16,32]",
                              "trainer.steps_per_call=2"),
        "ranking": _fit_args(tmp / "ranking", "synthetic-rank-smoke"),
        # the padded run resumed from its last.pt for a third epoch
        "resumed": _fit_args(tmp / "padded", "synthetic-smoke", "trainer.max_epochs=3",
                             "trainer.ckpt_path=" + str(
                                 tmp / "padded" / "synthetic-smoke" / "checkpoints" / "last.pt")),
    }
    builds = {override: _build_args(tmp / "builds", override) for override in BUILDS}
    build_ports = set()
    while len(build_ports) < len(builds):
        build_ports.add(_free_port())
    torch.save({"steps": steps, "fits": fits, "builds": builds,
                "build_ports": sorted(build_ports)}, tmp / "job.pt")
    port = str(_free_port())
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=port, PYTHONPATH=REPO)
        with open(tmp / f"rank{rank}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tests.torch_port_distributed", str(tmp / "job.pt"),
                 str(tmp)], cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
    wants.update({name: want() for name, want in jax_wants.items()})  # while the ranks run
    for rank, p in enumerate(procs):
        p.wait(timeout=300)
        text = (tmp / f"rank{rank}.log").read_text()
        assert p.returncode == 0, f"rank {rank} failed:\n{text[-4000:]}"
    results = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in (0, 1)]
    return results, wants, fits


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_a_two_rank_step_gives_jaxs_global_batch_step(ranks, name):
    results, wants, _ = ranks
    want = wants[name]
    for rank in (0, 1):
        got = results[rank]["steps"][name]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert got["grads"].keys() == want["grads"].keys()
        for key, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want["grads"][key].numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"rank {rank} grad {key}")
        for key, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), want["params"][key].numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"rank {rank} param {key}")


@pytest.mark.parametrize("name", list(PORT_CASES))
def test_a_two_rank_step_gives_the_one_process_step(ranks, name):
    """Muon's NS-5 on the summed gradients, the lazy update of the global
    batch's touched rows, the ranking loss over the global weight sum."""
    results, wants, _ = ranks
    want = wants[name]
    for rank in (0, 1):
        got = results[rank]["steps"][name]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        for key, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), want["params"][key].numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"rank {rank} param {key}")


@pytest.mark.parametrize("name", ["padded", "packed", "bucketed", "ranking", "resumed"])
def test_both_ranks_gather_the_same_metrics(ranks, name):
    results, _, _ = ranks
    a, b = (results[r]["fits"][name] for r in (0, 1))
    assert a["val"] and a["val"] == b["val"]
    assert a["test"] == b["test"]
    assert a["predict"] == b["predict"]
    epochs = 1 if name == "resumed" else 2  # the resumed run trains epoch 2 alone
    assert len(a["losses"]) == epochs and np.all(np.isfinite(a["losses"]))
    assert a["losses"] == b["losses"]  # the logged loss is the all-reduced one
    assert a["same_rows_innermost"] and b["same_rows_innermost"]
    for key, p in a["state"].items():
        assert torch.equal(p, b["state"][key]), key


def test_the_gathered_val_metrics_equal_jaxs_eval_epoch(ranks, tmp_path):
    results, _, fits = ranks
    args = [a for a in fits["padded"][1:] if not a.startswith(("trainer.device",
                                                               "trainer.distributed"))]
    jcfg = jax_preset("synthetic-smoke")
    # one process's batches of 8 rows over the 8-device CPU mesh: the eval is
    # a row's own, whatever the batch
    jax_overrides(jcfg, [a for a in args if not a.startswith("trainer.output_dir")]
                  + [f"trainer.output_dir={tmp_path}", f"data.data_dir={tmp_path}",
                     "model.encoder.use_pallas=false", "data.batch_size=8"])
    jtrainer = JaxTrainer(jcfg)
    try:
        params = dict(jtrainer.params)
        params["params"] = torch_state_dict_to_params(results[0]["fits"]["padded"]["state"],
                                                      jtrainer.params["params"])
        jtrainer.params = params
        want = jtrainer.eval_epoch(jtrainer._loader("val"), "val")
    finally:
        jtrainer.close()
    got = results[0]["fits"]["padded"]["val"]
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key] == pytest.approx(float(value), rel=1e-6, abs=1e-7), key


@pytest.fixture
def one_rank_env(monkeypatch):
    """torchrun's environment for one rank (no group is started by the raises)."""
    for name, value in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                            MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(name, value)


# the knobs that once raised under trainer.distributed and now build over two
# ranks (the module's launch): a model group of 2, or an sp group of 2
BUILDS = ("model.embedding.kind=sharded_a2a", "model.encoder.tp_shards=2",
          "model.encoder.sp_shards=2")
BUILT = {"model.encoder.sp_shards=2": {"data": 1, "model": 1, "col": 1, "sp": 2}}


def _build_args(out, override):
    return ["experiment=synthetic-smoke", "trainer.device=cpu", "trainer.distributed=true",
            f"trainer.output_dir={out}", "model.embedding.num_shards=2", override]


# the ids the cases had while all four raised
@pytest.mark.parametrize("override,error,words", [
    pytest.param("trainer.num_devices=2", ValueError,
                 "trainer.num_devices=2 but the world size is 1",
                 id="trainer.num_devices=2-ValueError-trainer.num_devices=2 but the world size "
                    "is 1"),
    pytest.param(BUILDS[0], None, None, id="model.embedding.kind=sharded_a2a-NotImplementedError"
                                           "-the sharded table over a process group"),
    pytest.param(BUILDS[1], None, None,
                 id="model.encoder.tp_shards=2-NotImplementedError-part \\(c\\): TP"),
    pytest.param(BUILDS[2], None, None,
                 id="model.encoder.sp_shards=2-NotImplementedError-part \\(d\\): the ring "
                    "over a process group"),
])
def test_what_the_data_axis_does_not_run_raises_naming_the_knob_and_part(
        tmp_path, one_rank_env, override, error, words, request):
    """A sharded kind and TP, which raised before the model axis was ported,
    build over two ranks with a model group of 2 and a data group of 1; the
    ring (sp_shards > 1), which raised before the ring over processes was
    ported, with an sp group of 2."""
    if error is None:
        results = request.getfixturevalue("ranks")[0]
        want = BUILT.get(override, {"data": 1, "model": 2, "col": 1, "sp": 1})
        for rank in (0, 1):
            assert results[rank]["builds"][override] == want
        return
    with pytest.raises(error, match=words):
        Trainer(cli_train.parse_args(_build_args(tmp_path, override)))


def test_more_devices_than_one_without_distributed_raise_naming_torchrun(tmp_path):
    args = ["experiment=synthetic-smoke", "trainer.device=cpu", "trainer.num_devices=2",
            f"trainer.output_dir={tmp_path}"]
    with pytest.raises(ValueError, match="trainer.distributed=true.*torchrun"):
        Trainer(cli_train.parse_args(args))


def test_a_one_process_trainer_where_a_group_is_started_raises(tmp_path, monkeypatch):
    # its steps would run over the group while its loaders do not stride
    from mygenerativerecommenders_tpu_torch.parallel import process_group

    monkeypatch.setattr(process_group, "_GROUP", object())
    args = ["experiment=synthetic-smoke", "trainer.device=cpu", f"trainer.output_dir={tmp_path}"]
    with pytest.raises(ValueError, match="started a data-parallel group.*trainer.distributed=true"):
        Trainer(cli_train.parse_args(args))
