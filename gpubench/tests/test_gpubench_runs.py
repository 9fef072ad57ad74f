"""Runs of the benchmark's cells on the CPU at a tiny size (gpubench/tests/
tiny.py), the card check skipped: the plain reference agrees with the port,
and each fault planted under the timed path turns `correct` false. Also:
run.py refuses to measure without a card, the import guard compares whole
top-level names, and a cell, configuration, traffic mix and metric dropped
in as files alone are found by name."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from gpubench import bench
from gpubench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


def _result(root, cell_name, fault=""):
    from gpubench.drivers import train

    cell = bench.Cell(cell_name, root=root)
    out = train.run(cell, 2**31 + 11, 0.5, False, time.perf_counter(), device="cpu", fault=fault)
    return cell, out


def _correct(cell, out):
    numbers = out["numbers"]
    return bench.passed(numbers, cell.limits) and out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell_name", ["ml20m-long.train-packed", "large-vocab.train-gather"])
def test_train_cell_agrees_and_faults_fail(root, cell_name):
    cell, out = _result(root, cell_name)
    n = out["numbers"]
    assert n["loss_gap"] < 1e-5 and n["grad_gap"] < 1e-4 and n["change_gap"] < 1e-4, n
    assert n["bad_segments"] == 0
    assert _correct(cell, out) and out["e2e"]["train_examples_per_s"] > 0
    for fault in ("frozen", "half_batch", "shifted_timestamps"):
        cell, bad = _result(root, cell_name, fault)
        assert not _correct(cell, bad), (fault, bad["numbers"])


def test_checked_batches_take_each_packing_class():
    """The check runs the first batch of each shape of the epoch (each
    packing class), then the earliest others, three at least, in the
    epoch's order."""
    from gpubench.drivers.train import checked_batches

    def batch(cap, tag):
        return {"ids": np.zeros((2, cap)), "tag": tag}

    epoch = [batch(64, 0), batch(64, 1), batch(64, 2), batch(32, 3), batch(32, 4), batch(16, 5)]
    assert [b["tag"] for b in checked_batches(epoch)] == [0, 3, 5]
    assert [b["tag"] for b in checked_batches(epoch[:5])] == [0, 1, 3]
    assert [b["tag"] for b in checked_batches(epoch[:3])] == [0, 1, 2]


def test_run_refuses_without_a_card():
    proc = subprocess.run([sys.executable, os.path.join(tiny.REPO, "gpubench", "run.py"),
                           "--workload", "ml20m-long.train-packed", "--seed", "1",
                           "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=tiny.REPO, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_fails_with_the_benchmark_alone(tmp_path):
    """A checkout of BENCHMARK.json and gpubench/ alone has no program."""
    tiny.make_root(str(tmp_path))
    proc = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                           "ml20m-long.train-packed", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                          timeout=300, env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_import_guard_compares_whole_names(monkeypatch):
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mygenerativerecommenders_tpu_torch_x", object())
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert bench.forbidden_modules() == ["jax"]
    monkeypatch.setitem(sys.modules, "mygenerativerecommenders_tpu.configs", object())
    assert bench.forbidden_modules() == ["jax", "mygenerativerecommenders_tpu"]


def test_new_cell_found_by_name(root, tmp_path):
    """A new configuration, traffic mix, limits and per-layer metric added as
    files, and their names in BENCHMARK.json: the harness finds each."""
    new = tiny.make_root(str(tmp_path / "new"))
    g = os.path.join(new, "gpubench")
    cfg = json.load(open(os.path.join(g, "configs", "ml-20m-hstu-long.json")))
    cfg["overrides"]["model.encoder.num_blocks"] = 1
    cfg["sizes"]["num_blocks"] = 1
    json.dump(cfg, open(os.path.join(g, "configs", "one-block.json"), "w"))
    mix = json.load(open(os.path.join(g, "traffic", "ml20m-long-train.json")))
    mix["users"] = 16
    json.dump(mix, open(os.path.join(g, "traffic", "few-users.json"), "w"))
    json.dump({"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 1e-1},
              open(os.path.join(g, "limits", "one-block.few-users.json"), "w"))
    # `steps_per_epoch.train` has no file of its own: it is read by the file
    # of its name without the last suffix
    with open(os.path.join(g, "metrics", "steps_per_epoch.py"), "w") as f:
        f.write("def read(ctx):\n    return float(len(ctx.get('window_steps') or [])) or None\n")
    spec = json.load(open(os.path.join(new, "BENCHMARK.json")))
    spec["configs"].append({"name": "one-block", "source": "https://arxiv.org/abs/2402.17152",
                            "file": "gpubench/configs/one-block.json",
                            "reduced": ["model.encoder.num_blocks"], "why": "one block"})
    spec["workloads"].append({"name": "one-block.few-users", "config": "one-block",
                              "traffic": "few-users", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_examples_per_s":
            m["workloads"].append("one-block.few-users")
    spec["per_layer"].append({"name": "steps_per_epoch.train", "unit": "steps",
                              "better": "higher",
                              "source": "program_counter", "layer": "train step",
                              "moves": "train_examples_per_s",
                              "workloads": ["one-block.few-users"]})
    json.dump(spec, open(os.path.join(new, "BENCHMARK.json"), "w"))
    cell = bench.Cell("one-block.few-users", root=new)
    assert cell.config["sizes"]["num_blocks"] == 1 and cell.traffic["users"] == 16
    assert [m["name"] for m in cell.end_to_end] == ["train_examples_per_s", "setup_s"]
    assert "steps_per_epoch.train" in [m["name"] for m in cell.per_layer]
    assert bench.reader("steps_per_epoch.train", new)({"window_steps": [1, 2]}) == 2.0
    _, out = _result(new, "one-block.few-users")
    assert out["numbers"]["loss_gap"] < 1e-5


@pytest.mark.gpu
def test_cell_on_the_card():
    """One short run of the first cell on the card (`-m gpu`)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                           "ml20m-long.train-packed", "--seed", "5", "--seconds", "2",
                           "--trace", "0"], capture_output=True, text=True, cwd=tiny.REPO,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
