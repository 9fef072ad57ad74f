"""The port's trainer on packed batches, on the CPU: `Trainer.fit` on
`synthetic-smoke` with `data.pack_sequences=true data.pack_eval=true`, resume,
`cli.eval`, the `data.pack_eval` policy, and packed against padded eval."""

import json
import logging

import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu_torch.checkpoint import CheckpointManager
from mygenerativerecommenders_tpu_torch.cli import eval as cli_eval
from mygenerativerecommenders_tpu_torch.cli import train as cli_train
from mygenerativerecommenders_tpu_torch.data.packing import PackedBatchLoader
from mygenerativerecommenders_tpu_torch.train.driver import Trainer
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOGGER = "mygenerativerecommenders_tpu_torch.train.driver"


def _args(tmp_path, *extra):
    return [
        "experiment=synthetic-smoke", "trainer.device=cpu", "data.pack_sequences=true",
        "data.pack_eval=true", f"trainer.output_dir={tmp_path / 'out'}", *extra,
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


def test_packed_fit_two_epochs_loss_falls_and_resume_continues(tmp_path, trainer_log):
    trainer = Trainer(cli_train.parse_args(_args(tmp_path, "trainer.max_epochs=2")))
    assert trainer._packed and trainer._eval_packed
    loader = trainer._loader("train", packed=True)
    assert isinstance(loader, PackedBatchLoader) and loader.include_target
    # one capacity: the longest segment (32 + 1) rounded up to 128 tokens
    assert loader.capacities == [128]
    steps = [len(loader._plan(e)) for e in range(2)]
    results = trainer.fit()
    rows = _rows(tmp_path)
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert len(losses) == sum(steps) and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    val = [r for r in rows if "val/ndcg@10" in r]
    assert [r["epoch"] for r in val] == [0, 1]
    assert all(0.0 <= v <= 1.0 for v in results.values())
    assert trainer.global_step == sum(steps)
    test = trainer.test()
    assert set(test) == set(results)

    last = tmp_path / "out" / "synthetic-smoke" / "checkpoints" / "last.pt"
    assert CheckpointManager.load(str(last))["step"] == sum(steps)
    resumed = Trainer(cli_train.parse_args(
        _args(tmp_path, "trainer.max_epochs=3", f"trainer.ckpt_path={last}")
    ))
    resumed.fit()
    assert f"resumed from {last} at epoch 2, step {sum(steps)}" in trainer_log.text
    assert resumed.epoch == 2 and resumed.global_step > sum(steps)
    state = resumed.optimizer.state_dict()["state"]
    assert all(int(s["step"]) == resumed.global_step for s in state.values())


def test_packed_cli_train_and_cli_eval(tmp_path):
    monitored = cli_train.main(_args(tmp_path, "trainer.max_epochs=1"))
    assert 0.0 <= monitored <= 1.0
    best = tmp_path / "out" / "synthetic-smoke" / "checkpoints" / "best.pt"
    results = cli_eval.main(_args(tmp_path, f"trainer.ckpt_path={best}"))
    assert all(0.0 <= v <= 1.0 for v in results.values())
    rows = _rows(tmp_path)
    assert any("test/ndcg@10" in r for r in rows)


@pytest.mark.parametrize(
    "pack_eval,max_len,want",
    [("auto", 32, False), ("auto", 512, True), ("true", 32, True), ("false", 512, False)],
)
def test_pack_eval_policy(tmp_path, pack_eval, max_len, want):
    cfg = cli_train.parse_args(_args(
        tmp_path, f"data.pack_eval={pack_eval}", f"data.max_sequence_length={max_len}"
    ))
    trainer = Trainer(cfg)
    assert trainer._packed and trainer._eval_packed == want
    assert (trainer.packed_eval_step is not None) == want
    val = trainer._loader("val", packed=trainer._eval_packed)
    assert isinstance(val, PackedBatchLoader) == want


def test_pack_eval_is_off_without_packing_and_an_unknown_policy_raises(tmp_path):
    cfg = cli_train.parse_args(_args(tmp_path, "data.pack_sequences=false"))
    assert not Trainer(cfg)._eval_packed
    with pytest.raises(ValueError, match="pack_eval"):
        Trainer(cli_train.parse_args(_args(tmp_path, "data.pack_eval=sometimes")))


def test_packed_eval_epoch_gives_the_padded_eval_epochs_metrics(tmp_path):
    trainer = Trainer(cli_train.parse_args(_args(tmp_path)))
    packed = trainer.eval_epoch(trainer._loader("val", packed=True), "val")
    padded = trainer.eval_epoch(trainer._loader("val", packed=False), "val")
    assert packed.keys() == padded.keys()
    for key in packed:  # a near-tie at rank k may move one of 64 rows
        assert packed[key] == pytest.approx(padded[key], abs=0.02), key


@pytest.mark.parametrize(
    "override,item",
    [
        ("model.encoder.remat=true", "Training variants"),
        ("model.encoder.attn_dropout_rate=0.1", "Training variants"),
    ],
)
def test_knobs_beside_packing_still_raise_naming_the_roadmap_item(tmp_path, override, item):
    """The training variants beside packing, ported since: remat trains a
    packed step (finite, the encoder moved), attention dropout, which the
    reference ignores, raises a ValueError naming it."""
    if override == "model.encoder.attn_dropout_rate=0.1":
        with pytest.raises(ValueError, match="encoder.attn_dropout_rate=0.1: the reference"):
            Trainer(cli_train.parse_args(_args(tmp_path, override)))
        return
    trainer = Trainer(cli_train.parse_args(_args(tmp_path, override)))
    assert trainer.model.sequence_encoder["_hstu"].remat
    batch = next(iter(trainer._loader("train", packed=True)))
    before = trainer.model.state_dict()["sequence_encoder._hstu._attention_layers.0._uvqk"].clone()
    trainer.model.train()
    assert np.isfinite(trainer.train_step(trainer._put(batch), trainer.lr1).item())
    assert not torch.equal(
        trainer.model.state_dict()["sequence_encoder._hstu._attention_layers.0._uvqk"], before)


@pytest.mark.parametrize("override", ["model.sampler.kind=in_batch"])
def test_knobs_beside_packing_that_raised_before_take_a_packed_step(tmp_path, override):
    """The knobs that raised beside packing before they were ported: the
    trainer builds on packed batches and takes a finite step that moves the
    encoder."""
    trainer = Trainer(cli_train.parse_args(_args(tmp_path, override)))
    batch = next(iter(trainer._loader("train", packed=True)))
    assert "seg_ids" in batch
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.model.train()
    loss = trainer.train_step(trainer._put(batch), trainer.lr1)
    assert np.isfinite(loss.item())
    after = trainer.model.state_dict()
    assert not torch.equal(after["sequence_encoder._hstu._attention_layers.0._uvqk"],
                           before["sequence_encoder._hstu._attention_layers.0._uvqk"])
