"""The training variants of the PyTorch port on the CPU: per-block remat,
async checkpoints, the profiler and the MLflow and TensorBoard channels.

- Remat against the JAX package's remat model (`encoder.remat=true`, JAX's
  jnp path), dropout off, padded, packed, the zigzag ring (the port at
  sp_shards=4 against JAX at sp_shards=1, as tests/test_torch_port_ring.py
  holds the ring) and softmax_rel_bias: the encoder output and the loss at
  rtol 2e-4 / atol 2e-5 and 1e-5, every gradient at rtol 2e-4 / atol 2e-5
  (the JAX kernel tests' tolerances; remat reruns the same arithmetic).
- Remat against the port without it, dropout at the presets' 0.2, the same
  seed: the loss and every gradient at rtol 1e-5 / atol 1e-6 (JAX
  tests/test_remat.py:52). The recompute must draw the masks of the first
  forward (checkpoint's stashed RNG state); masks drawn anew would move the
  gradients far past that.
- `Trainer` with remat, async checkpoints, the profiler, MLflow and
  TensorBoard on, one epoch (a module fixture), beside a twin with none of
  them but remat: the async `last.pt` equal to the synchronous one tensor
  for tensor, resumed fits from each equal, the profiler's CPU-only trace,
  every metrics row in MLflow's files and TensorBoard's scalars.
- `CheckpointManager(async_save=True)`: a parameter changed after `save`
  returns does not reach the file, and a read waits for the write in flight
  (the writer held by a gate until then).
- `MlflowFileWriter` against JAX's on the same params and rows, and the
  knobs that JAX ignores raise `ValueError`s naming them.
"""

import copy
import json
import os
import struct
import threading

import jax
import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.train.loggers import MlflowFileWriter as JaxMlflowWriter
from mygenerativerecommenders_tpu.utils.features import packed_seq_features as jax_packed
from mygenerativerecommenders_tpu.utils.features import seq_features_from_batch as jax_features
from mygenerativerecommenders_tpu_torch.checkpoint import CheckpointManager
from mygenerativerecommenders_tpu_torch.cli import train as cli_train
from mygenerativerecommenders_tpu_torch.configs import resolve as pt_resolve
from mygenerativerecommenders_tpu_torch.models.model import build_model as pt_build_model
from mygenerativerecommenders_tpu_torch.train import loggers
from mygenerativerecommenders_tpu_torch.train import task_retrieval as pt_task
from mygenerativerecommenders_tpu_torch.train.driver import Trainer
from mygenerativerecommenders_tpu_torch.utils.features import packed_seq_features, seq_features_from_batch
from tests import torch_port_families as fam
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

REMAT = (("model.encoder.remat", True),)
SOFTMAX = (("model.encoder.normalization", "softmax_rel_bias"),)
RTOL, ATOL = 2e-4, 2e-5  # against JAX
REPLAY_RTOL, REPLAY_ATOL = 1e-5, 1e-6  # remat against no remat


def _ring(s: fam.Setup, zigzag: bool) -> fam.Setup:
    """`s` with the port's model at sp_shards=4 (the same weights)."""
    pcfg = copy.deepcopy(s.pcfg)
    pcfg.model.encoder.sp_shards = 4
    pcfg.model.encoder.sp_zigzag = zigzag
    pmodel = pt_build_model(pcfg, device="cpu")
    pmodel.load_state_dict(s.pmodel.state_dict())
    return s._replace(pcfg=pcfg, pmodel=pmodel)


@pytest.mark.parametrize("case", ["padded", "packed", "ring-zigzag", "softmax_rel_bias"])
def test_remat_model_matches_jax_remat_forward_loss_and_every_gradient(case):
    if case == "packed":
        s = fam.packed_setup(REMAT)
    else:
        s = fam.setup(overrides=REMAT + (SOFTMAX if case == "softmax_rel_bias" else ()), heads=2)
    if case == "ring-zigzag":
        s = _ring(s, zigzag=True)
    assert s.jcfg.model.encoder.remat and s.pmodel.sequence_encoder["_hstu"].remat
    batch = s.batches[0]
    if case == "packed":
        jseq, pseq = jax_packed(batch), packed_seq_features(fam.torch_batch(batch))
    else:
        out_len = s.pcfg.model.gr_output_length + 1
        jseq = jax_features(batch, out_len)[0]
        pseq = seq_features_from_batch(fam.torch_batch(batch), out_len)[0]
    want, _ = jax.jit(lambda p, q: s.jmodel.apply(p, q, deterministic=True))(s.params, jseq)
    got, _ = s.pmodel(pseq)  # grad on: the remat path
    assert got.requires_grad
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    fam.compare_loss_and_grads(s, batch, jax.random.PRNGKey(3), packed=case == "packed",
                               grad_rtol=RTOL, grad_atol=ATOL)


def _trainer(tmp_path, *extra) -> Trainer:
    return Trainer(cli_train.parse_args([
        "experiment=synthetic-smoke", "trainer.device=cpu",
        f"trainer.output_dir={tmp_path}", *extra,
    ]))


REPLAY_CASES = {
    "padded": (),
    "packed": ("data.pack_sequences=true", "data.pack_capacities=[16,32,48]",
               "data.max_sequence_length=36", "data.synthetic_max_seq_len=45"),
    "ring-zigzag": ("model.encoder.sp_shards=4", "model.encoder.sp_zigzag=true"),
    "ring-contiguous": ("model.encoder.sp_shards=4",),
    "softmax_rel_bias": ("model.encoder.normalization=softmax_rel_bias",),
}


@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_remat_replays_each_blocks_dropout_masks(tmp_path, case):
    """One loss and its gradients with dropout 0.2, from the same weights,
    batch, negatives and dropout seed, with and without remat."""
    runs = []
    for remat in ("false", "true"):
        trainer = _trainer(tmp_path / remat, f"model.encoder.remat={remat}", *REPLAY_CASES[case])
        assert trainer.cfg.model.encoder.linear_dropout_rate == 0.2
        host = next(iter(trainer._loader("train", packed=trainer._packed)))
        batch = trainer._put(host)
        loss_fn = pt_task.make_loss_fn(trainer.model, trainer.cfg, trainer.all_item_ids,
                                       packed=trainer._packed)
        offsets = torch.randint(0, len(trainer.all_item_ids),
                                fam.draw_shape(trainer.cfg, host, trainer._packed),
                                dtype=torch.int32, generator=torch.Generator().manual_seed(1))
        trainer.model.train()
        torch.manual_seed(5)
        loss = loss_fn(batch, neg_offsets=offsets)
        loss.backward()
        runs.append((loss.item(), {k: p.grad for k, p in trainer.model.named_parameters()}))
        trainer.model.eval()
        with torch.no_grad():  # dropout on: the eval loss differs
            assert loss_fn(batch, neg_offsets=offsets).item() != pytest.approx(loss.item())
    (want_loss, want), (got_loss, got) = runs
    np.testing.assert_allclose(got_loss, want_loss, rtol=REPLAY_RTOL)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=REPLAY_RTOL,
                                   atol=REPLAY_ATOL, err_msg=name)


def test_remat_trains_k_steps_a_call_through_the_trainer(tmp_path):
    trainer = _trainer(tmp_path, "model.encoder.remat=true", "trainer.steps_per_call=2")
    loader = trainer._loader("train")
    batches = [trainer._put(b) for _, b in zip(range(2), loader)]
    before = trainer.model.state_dict()["sequence_encoder._hstu._attention_layers.1._uvqk"].clone()
    trainer.model.train()
    losses = trainer.train_steps(batches, trainer.lr1)
    assert losses.shape == (2,) and torch.isfinite(losses).all()
    after = trainer.model.state_dict()["sequence_encoder._hstu._attention_layers.1._uvqk"]
    assert not torch.equal(before, after)


# ------------------------------------------------------------------ one epoch with the knobs on

KNOBS = ("model.encoder.remat=true", "trainer.max_epochs=1")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One epoch with async checkpoints, the profiler, MLflow and
    TensorBoard on, and its twin with none of them; both with remat."""
    root = tmp_path_factory.mktemp("variants")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        on = _trainer(root / "on", *KNOBS, "trainer.async_checkpoint=true",
                      "trainer.profiler=true", "trainer.tensorboard=true",
                      f"trainer.mlflow_dir={root / 'mlruns'}")
        on.fit()
        on.writer.close()
        off = _trainer(root / "off", *KNOBS)
        off.fit()
    finally:
        torch.set_num_threads(threads)
    return root, on, off


def _equal(a, b, where="") -> None:
    """Two loaded checkpoints equal: every tensor bit for bit, the rest by ==."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def _ckpt(root, which: str, name: str = "last.pt") -> str:
    return str(root / which / "synthetic-smoke" / "checkpoints" / name)


def test_async_checkpoints_equal_the_synchronous_ones(runs):
    root, on, off = runs
    assert on.ckpt.async_save and not off.ckpt.async_save
    for name in ("last.pt", "best.pt"):
        _equal(CheckpointManager.load(_ckpt(root, "on", name)),
               CheckpointManager.load(_ckpt(root, "off", name)), name)
    assert not [f for f in os.listdir(os.path.dirname(_ckpt(root, "on"))) if f.endswith(".tmp")]


def test_fit_resumed_from_an_async_last_pt_equals_one_from_a_sync_one(runs):
    root, _, _ = runs
    states = []
    for which in ("on", "off"):
        trainer = _trainer(root / f"resumed-{which}", "model.encoder.remat=true",
                           "trainer.max_epochs=2", "trainer.async_checkpoint=true",
                           f"trainer.ckpt_path={_ckpt(root, which)}")
        trainer.fit()
        assert trainer.epoch == 1 and trainer.global_step == 16
        states.append(CheckpointManager.load(_ckpt(root, f"resumed-{which}")))
    _equal(*states)


def test_profiler_traces_steps_2_to_4_of_epoch_0_on_the_cpu(runs):
    root, on, _ = runs
    path = root / "on" / "synthetic-smoke" / "profile" / "trace_epoch0.json"
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)  # the CPU's ops
    assert not [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy")]
    # three steps: each zeroes the gradients once
    steps = [e for e in events if e.get("name") == "Optimizer.zero_grad#AdamW.zero_grad"]
    assert len(steps) == 3


def _rows(root, which: str):
    path = root / which / "synthetic-smoke" / "metrics.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_mlflow_holds_the_config_and_every_metrics_row(runs):
    root, on, _ = runs
    (run_id,) = [d for d in os.listdir(root / "mlruns" / "0") if d != "meta.yaml"]
    run = root / "mlruns" / "0" / run_id
    params = {p: (run / "params" / p).read_text() for p in os.listdir(run / "params")}
    assert params["model.encoder.remat"] == "True"
    assert params["trainer.async_checkpoint"] == "True"
    assert params["experiment"] == "synthetic-smoke"
    assert len(params) > 100  # every leaf of the config
    rows = _rows(root, "on")
    for key in ("train/loss", "val/ndcg@10"):
        want = [(r[key], r["step"]) for r in rows if key in r]
        lines = (run / "metrics" / key.replace("/", ".")).read_text().splitlines()
        got = [(float(v), int(step)) for _, v, step in (line.split() for line in lines)]
        assert got == want and want


def _scalars(log_dir) -> dict:
    """tag -> [(step, value)] of the event files under `log_dir` (TFRecords:
    an 8-byte length, its 4-byte CRC, the Event, the Event's CRC)."""
    from tensorboardX.proto import event_pb2

    out: dict = {}
    for name in sorted(os.listdir(log_dir)):
        data = (log_dir / name).read_bytes()
        i = 0
        while i < len(data):
            (n,) = struct.unpack("<Q", data[i:i + 8])
            event = event_pb2.Event.FromString(data[i + 12:i + 12 + n])
            i += 12 + n + 4
            for v in event.summary.value:
                out.setdefault(v.tag, []).append((event.step, v.simple_value))
    return out


def test_tensorboard_scalars_read_back(runs):
    root, _, _ = runs
    got = _scalars(root / "on" / "synthetic-smoke" / "tb")
    rows = _rows(root, "on")
    for key in ("train/loss", "val/ndcg@10", "lr1"):
        want = [(r["step"], r[key]) for r in rows if key in r]
        tag = key.replace("@", "_")  # tensorboardX's tag characters
        assert want and [s for s, _ in got[tag]] == [s for s, _ in want]
        np.testing.assert_allclose([v for _, v in got[tag]], [v for _, v in want], rtol=1e-6)


def test_tensorboard_without_either_package_raises_naming_them(tmp_path, monkeypatch):
    monkeypatch.setitem(os.sys.modules, "tensorboardX", None)
    monkeypatch.setitem(os.sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ValueError, match="tensorboardX .*tensorboard"):
        _trainer(tmp_path, "trainer.tensorboard=true")


# ------------------------------------------------------------------ the async manager alone


@pytest.fixture
def gated_writer(monkeypatch):
    """torch.save held in the checkpoint writer's thread until the gate opens."""
    gate = threading.Event()
    save = torch.save

    def held(obj, f, *args, **kwargs):
        if threading.current_thread().name == "checkpoint-writer":
            assert gate.wait(30)
        save(obj, f, *args, **kwargs)

    monkeypatch.setattr(torch, "save", held)
    yield gate
    gate.set()


def test_async_save_copies_the_state_before_it_returns(tmp_path, gated_writer):
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    model(torch.ones(2, 4)).sum().backward()
    opt.step()
    want = copy.deepcopy({"model": model.state_dict(), "optimizer": opt.state_dict()})
    ckpt = CheckpointManager(str(tmp_path), async_save=True)
    ckpt.save(model, opt, step=1, epoch=0, metric_value=0.5)
    with torch.no_grad():  # the live tensors change while the write waits
        for p in model.parameters():
            p.add_(1.0)
            opt.state[p]["exp_avg"].add_(1.0)
    assert not os.path.exists(ckpt.last_path)
    gated_writer.set()
    ckpt.flush()
    saved = CheckpointManager.load(ckpt.last_path)
    _equal(saved["model"], want["model"], "model")
    _equal(saved["optimizer"], want["optimizer"], "optimizer")
    assert os.path.samefile(ckpt.last_path, ckpt.best_path)


def test_reading_a_checkpoint_waits_for_the_write_in_flight(tmp_path, gated_writer):
    trainer = _trainer(tmp_path, "trainer.async_checkpoint=true")
    trainer.ckpt.save(trainer.model, trainer.optimizer, step=7, epoch=2, metric_value=0.1)
    opener = threading.Timer(0.2, gated_writer.set)
    opener.start()
    trainer.restore(trainer.ckpt.last_path)  # raises if it read before the write
    opener.join()
    assert (trainer.global_step, trainer.epoch) == (7, 3)


def test_mlflow_writer_writes_the_jax_writers_files(tmp_path):
    params = {"model.encoder.remat": True, "optimizer1.lr": 0.001, "data/dir": "x"}
    rows = [({"train/loss": 7.5, "lr1": 0.001, "note": "skipped"}, 8),
            ({"val/ndcg@10": 0.125}, 16)]
    writers = {"jax": JaxMlflowWriter(str(tmp_path / "jax"), "smoke", "run-a"),
               "port": loggers.MlflowFileWriter(str(tmp_path / "port"), "smoke", "run-a")}
    trees = {}
    for name, w in writers.items():
        w.log_params(params)
        for metrics, step in rows:
            w.log_metrics(metrics, step)
        root = str(tmp_path / name)
        files = {}
        for d, _, fs in os.walk(root):
            for f in fs:
                path = os.path.join(d, f)
                text = open(path).read().replace(root, "<dir>").replace(w.run_id, "<run>")
                lines = [" ".join(["<ts>"] + line.split()[1:]) if "metrics" in path
                         else ("start_time: <ts>" if line.startswith("start_time") else line)
                         for line in text.splitlines()]
                files[os.path.relpath(path, root).replace(w.run_id, "<run>")] = lines
        trees[name] = files
    assert trees["port"] == trees["jax"]
    assert "0/<run>/metrics/train.loss" in trees["port"]


@pytest.mark.parametrize("override,match", [
    ("model.encoder.attn_dropout_rate=0.1", "encoder.attn_dropout_rate=0.1: the reference ignores"),
    ("scheduler1.kind=cosine", "scheduler1.kind=cosine: the reference ignores"),
    ("scheduler2.kind=cosine", "scheduler2.kind=cosine: the reference ignores"),
])
def test_knobs_the_reference_ignores_raise_naming_them(tmp_path, override, match):
    with pytest.raises(ValueError, match=match):
        _trainer(tmp_path, override)


def test_remat_with_sasrec_raises_naming_the_knob():
    cfg = cli_train.parse_args(["experiment=ml-1m-sasrec", "model.encoder.remat=true"])
    pt_resolve(cfg, 220)
    with pytest.raises(ValueError, match="encoder.remat=true with encoder.kind=sasrec"):
        pt_build_model(cfg, device="cpu")
