"""`cli.sweep` of the PyTorch port on the CPU: the grid's arguments split as
the JAX package's `split_sweep_args` splits them (its two errors included),
and a 2-point sweep over `optimizer1.lr` on `synthetic-smoke` that writes
`sweep_results.csv` row by row and returns the best row by `trainer.mode`."""

import csv

import pytest

from mygenerativerecommenders_tpu.cli.sweep import split_sweep_args as jax_split
from mygenerativerecommenders_tpu_torch.cli import sweep
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("argv", [
    ["experiment=synthetic-smoke", "sweep.optimizer1.lr=1e-3,5e-4", "trainer.max_epochs=1"],
    ["sweep.model.encoder.num_blocks=1,2,4", "sweep.optimizer1.lr=1e-3", "a.b=c=d"],
    ["sweep.x.y=1", "sweep.x.y=2,3"],  # a later axis of one key replaces the earlier
])
def test_split_sweep_args_splits_as_jax(argv):
    assert sweep.split_sweep_args(argv) == jax_split(argv)


@pytest.mark.parametrize("argv", [
    ["experiment=synthetic-smoke", "sweep.optimizer1.lr="],
    ["experiment=synthetic-smoke", "sweep.optimizer1.lr"],
    ["experiment=synthetic-smoke", "trainer.max_epochs=1"],
])
def test_split_sweep_args_raises_where_jax_raises(argv):
    with pytest.raises(ValueError) as want:
        jax_split(argv)
    with pytest.raises(ValueError, match=str(want.value).split(":")[0].split(" —")[0]):
        sweep.split_sweep_args(argv)


def test_two_point_sweep_writes_its_csv_and_returns_the_best_run(tmp_path):
    out = tmp_path / "sweep"
    best = sweep.main([
        "experiment=synthetic-smoke", "trainer.device=cpu", "trainer.max_epochs=1",
        "sweep.optimizer1.lr=1e-3,3e-2", f"trainer.output_dir={out}",
    ])
    with open(out / "sweep_results.csv") as f:
        rows = list(csv.DictReader(f))
    assert [(r["run"], r["optimizer1.lr"]) for r in rows] == [("0", "1e-3"), ("1", "3e-2")]
    metrics = [float(r["metric"]) for r in rows]
    assert all(0.0 <= m <= 1.0 for m in metrics)
    # trainer.mode=max on val/ndcg@10
    assert best["run"] == max(range(2), key=lambda i: metrics[i])
    assert best["metric"] == pytest.approx(max(metrics))
    for i in range(2):  # each run in its own directory, with its checkpoints
        assert (out / f"sweep_{i}" / "synthetic-smoke" / "checkpoints" / "best.pt").exists()
