"""The port's trainer and its entry points on the CPU: `Trainer.fit` on
`synthetic-smoke` with `trainer.device=cpu`, checkpoints, resume, `cli.eval`,
and the refusal to train without a card unless the CPU is asked for."""

import json
import logging

import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.models.metrics import retrieval_metrics as jax_metrics
from mygenerativerecommenders_tpu_torch.checkpoint import CheckpointManager, load_checkpoint
from mygenerativerecommenders_tpu_torch.cli import eval as cli_eval
from mygenerativerecommenders_tpu_torch.cli import train as cli_train
from mygenerativerecommenders_tpu_torch.models.metrics import retrieval_metrics
from mygenerativerecommenders_tpu_torch.train.controllers import EarlyStopping, PlateauLRController
from mygenerativerecommenders_tpu_torch.train.driver import Trainer
from mygenerativerecommenders_tpu_torch.train.loggers import MetricsWriter
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOGGER = "mygenerativerecommenders_tpu_torch.train.driver"


def _args(tmp_path, *extra):
    return [
        "experiment=synthetic-smoke", "trainer.device=cpu",
        f"trainer.output_dir={tmp_path / 'out'}", *extra,
    ]


@pytest.fixture
def trainer_log(caplog):
    # the trainer's logger does not propagate to the root: attach the capture
    logger = logging.getLogger(LOGGER)
    logger.addHandler(caplog.handler)
    yield caplog
    logger.removeHandler(caplog.handler)


def _rows(tmp_path):
    path = tmp_path / "out" / "synthetic-smoke" / "metrics.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_fit_two_epochs_loss_falls_metrics_and_checkpoints_written(tmp_path):
    trainer = Trainer(cli_train.parse_args(_args(tmp_path, "trainer.max_epochs=2")))
    results = trainer.fit()
    rows = _rows(tmp_path)
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert len(losses) == 16 and np.isfinite(losses).all()  # 2 epochs x 8 batches of 8
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    val = [r for r in rows if "val/ndcg@10" in r]
    assert [r["epoch"] for r in val] == [0, 1]
    assert set(results) == {"ndcg@5", "ndcg@10", "ndcg@20", "hr@5", "hr@10", "hr@20", "mrr"}
    assert all(0.0 <= v <= 1.0 for v in results.values())
    ckpt_dir = tmp_path / "out" / "synthetic-smoke" / "checkpoints"
    last = CheckpointManager.load(str(ckpt_dir / "last.pt"))
    best = CheckpointManager.load(str(ckpt_dir / "best.pt"))
    assert last["epoch"] == 1 and last["step"] == 16
    assert best["metric_value"] == max(r["val/ndcg@10"] for r in val)
    assert last["model"].keys() == trainer.model.state_dict().keys()
    header = (tmp_path / "out" / "synthetic-smoke" / "metrics.csv").read_text().splitlines()[0]
    assert header.startswith("step,epoch,time,")
    test = trainer.test()
    assert set(test) == set(results)


def test_resume_continues_from_the_saved_epoch_step_and_optimizer(tmp_path, trainer_log):
    Trainer(cli_train.parse_args(_args(tmp_path, "trainer.max_epochs=1"))).fit()
    last = tmp_path / "out" / "synthetic-smoke" / "checkpoints" / "last.pt"
    resumed = Trainer(
        cli_train.parse_args(_args(tmp_path, "trainer.max_epochs=2", f"trainer.ckpt_path={last}"))
    )
    resumed.fit()
    assert f"resumed from {last} at epoch 1, step 8" in trainer_log.text
    assert resumed.global_step == 16 and resumed.epoch == 1
    state = resumed.optimizer.state_dict()["state"]
    assert all(int(s["step"]) == 16 for s in state.values())


def test_cli_train_prints_val_and_test_lines_and_cli_eval_reads_the_checkpoint(tmp_path, trainer_log):
    cli_log = logging.getLogger("mygenerativerecommenders_tpu_torch.cli.train")
    cli_log.addHandler(trainer_log.handler)
    try:
        monitored = cli_train.main(_args(tmp_path, "trainer.max_epochs=2"))
    finally:
        cli_log.removeHandler(trainer_log.handler)
    assert "epoch 1: val/ndcg@5=" in trainer_log.text and "test: {" in trainer_log.text
    assert 0.0 <= monitored <= 1.0
    best = tmp_path / "out" / "synthetic-smoke" / "checkpoints" / "best.pt"
    results = cli_eval.main(_args(tmp_path, f"trainer.ckpt_path={best}"))
    assert all(0.0 <= v <= 1.0 for v in results.values())
    # a training checkpoint also loads as serving weights
    assert load_checkpoint(str(best)).keys() == CheckpointManager.load(str(best))["model"].keys()
    with pytest.raises(ValueError, match="ckpt_path"):
        cli_eval.main(_args(tmp_path))


def test_training_without_a_card_raises_unless_the_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cfg = cli_train.parse_args(["experiment=synthetic-smoke", f"trainer.output_dir={tmp_path}"])
    assert cfg.trainer.device == "cuda"
    with pytest.raises(RuntimeError, match="trainer.device=cpu"):
        Trainer(cfg)


def test_debug_limits_cut_the_epoch(tmp_path):
    trainer = Trainer(cli_train.parse_args(_args(tmp_path, "trainer.fast_dev_run=true")))
    trainer.fit()
    assert trainer.global_step == 1
    trainer = Trainer(cli_train.parse_args(
        _args(tmp_path, "trainer.max_epochs=1", "trainer.limit_train_batches=0.5",
              "trainer.log_every_n_steps=2")
    ))
    trainer.fit()
    assert trainer.global_step == 4
    trainer = Trainer(cli_train.parse_args(
        _args(tmp_path, "trainer.max_epochs=3", "trainer.overfit_batches=2")
    ))
    trainer.fit()
    assert trainer.global_step == 6


@pytest.mark.parametrize(
    "override,item",
    [
        ("trainer.distributed=true", "Distributed"),
        ("trainer.profiler=true", "Training variants"),
        ("trainer.tensorboard=true", "Training variants"),
        ("trainer.mlflow_dir=mlruns", "Training variants"),
        ("scheduler1.kind=cosine", "Training variants"),
    ],
)
def test_unported_trainer_knobs_raise_naming_the_roadmap_item(tmp_path, monkeypatch, override,
                                                             item):
    """`trainer.distributed`, ported since (tests/test_torch_port_distributed.py
    trains with it), needs torchrun's environment and raises a ValueError
    naming it without; the training variants, ported since, build the
    trainer (the profiler, TensorBoard and MLflow;
    tests/test_torch_port_training_variants.py runs them), and the cosine
    scheduler, which the reference ignores, raises a ValueError naming it."""
    monkeypatch.chdir(tmp_path)  # trainer.mlflow_dir=mlruns is relative
    args = cli_train.parse_args(_args(tmp_path, override))
    if override == "trainer.distributed=true":
        for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            monkeypatch.delenv(name, raising=False)
        with pytest.raises(ValueError, match="torchrun"):
            Trainer(args)
    elif item != "Training variants":
        with pytest.raises(NotImplementedError, match=item):
            Trainer(args)
    elif override == "scheduler1.kind=cosine":
        with pytest.raises(ValueError, match="scheduler1.kind=cosine: the reference ignores"):
            Trainer(args)
    else:
        trainer = Trainer(args)
        on = {"trainer.profiler=true": trainer.cfg.trainer.profiler,
              "trainer.tensorboard=true": trainer.writer._tb is not None,
              "trainer.mlflow_dir=mlruns": trainer.writer.mlflow is not None}
        assert on[override]
        trainer.writer.close()


def test_plateau_controller_cuts_the_rate_and_early_stopping_stops():
    ctrl = PlateauLRController(lr=1e-3, factor=0.1, patience=1)
    assert [ctrl.step(v) for v in (0.5, 0.5, 0.5, 0.6)] == [1e-3, 1e-3, 1e-4, 1e-4]
    stop = EarlyStopping(patience=2)
    assert [stop.step(v) for v in (0.5, 0.4, 0.4)] == [False, False, True]
    assert EarlyStopping().step(float("nan"))


@pytest.mark.parametrize("k", [5, 20])
def test_retrieval_metrics_match_jax(k):
    rng = np.random.default_rng(k)
    top = np.stack([rng.permutation(100)[:k] for _ in range(64)])
    targets = rng.integers(0, 100, size=64)
    got = retrieval_metrics(top, targets, (1, 5, k))
    want = jax_metrics(top, targets[:, None], (1, 5, k))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)


def test_metrics_writer_appends_rows(tmp_path):
    writer = MetricsWriter(str(tmp_path))
    writer.log({"train/loss": 1.5}, step=1, epoch=0)
    writer.log({"train/loss": 1.25}, step=2, epoch=0)
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["train/loss"] for r in rows] == [1.5, 1.25]
    assert len((tmp_path / "metrics.csv").read_text().splitlines()) == 3
