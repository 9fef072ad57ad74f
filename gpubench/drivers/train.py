"""The train driver: back-to-back training through the port's
`Trainer.train_epoch`, epoch after epoch over the mix's users.

Set-up builds one Trainer from the configuration, loads the benchmark's
weights into it, runs the checked batches of epoch 0 (`checked_batches`: the
first of each batch shape, so each packing class is checked, then the
earliest others, three at least) through the trainer's own feed
(`_batches`) and k-step call (`train_steps`), one batch a call, reading
after step 1 the gradient as AdamW holds it (exp_avg / (1 - beta1)) and
after the last each leaf's change, then one whole epoch so that every batch
shape is captured. The window then runs whole epochs until
`seconds` have passed, ending at the epoch's last loss read (a sync).
Once the window has closed and the trainer is freed, the reference follows
the same batches from the same weights and draws (gpubench/reference).

Traffic keys: "users", "lengths", "popularity_exponent", "span_days" (see
gpubench/traffic.py) and "trace_epochs", the epochs at the window's start
that a traced run profiles.
"""

from __future__ import annotations

import gc
import math
import shutil
import statistics
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from gpubench import traffic, weights
from gpubench.reference.hstu import AdamW, Dims, follow_training
from gpubench.roofline.attention import describe

# the configuration's sizes -> the port's Config paths, held equal at run time
SIZE_PATHS = {
    "item_embedding_dim": "model.item_embedding_dim",
    "num_heads": "model.encoder.num_heads",
    "attention_dim": "model.encoder.attention_dim",
    "linear_dim": "model.encoder.linear_dim",
    "num_blocks": "model.encoder.num_blocks",
    "max_sequence_length": "data.max_sequence_length",
    "gr_output_length": "model.gr_output_length",
    "num_time_buckets": "model.encoder.num_time_buckets",
    "dropout_rate": "model.preprocessor.dropout_rate",
    "linear_dropout_rate": "model.encoder.linear_dropout_rate",
    "temperature": "model.loss.temperature",
    "num_to_sample": "model.loss.num_to_sample",
    "l2_norm_eps": "model.sampler.l2_norm_eps",
    "num_items": "data.expected_num_unique_items",
    "max_item_id": "data.expected_max_item_id",
    "batch_size": "data.batch_size",
    "pack_sequences": "data.pack_sequences",
    "steps_per_call": "trainer.steps_per_call",
    "lr": "optimizer1.lr",
    "betas": "optimizer1.betas",
    "adam_eps": "optimizer1.eps",
    "weight_decay": "optimizer1.weight_decay",
    "embedding_kind": "model.embedding.kind",
    "index_k": "model.index.k",
    "index_quantize": "model.index.quantize",
    "rescore_over_fetch": "model.index.rescore_over_fetch",
}


def _get(cfg, path: str):
    for part in path.split("."):
        cfg = getattr(cfg, part)
    return cfg


def program_config(config: dict, seed: int, device: str, out_dir: str):
    """The port's Config: the preset, the file's overrides, then the run's
    seed, device and scratch directory; its sizes checked against the file's."""
    from mygenerativerecommenders_tpu_torch.configs import apply_overrides
    from mygenerativerecommenders_tpu_torch.configs.presets import get_preset

    cfg = get_preset(config["preset"])
    apply_overrides(cfg, [f"{k}={v}" for k, v in config["overrides"].items()])
    cfg.trainer.seed = seed
    cfg.trainer.device = device
    cfg.trainer.output_dir = out_dir
    sizes = config["sizes"]
    for key, path in SIZE_PATHS.items():
        have = _get(cfg, path)
        want = sizes[key]
        have = list(have) if isinstance(have, tuple) else have
        if key in ("attention_dim", "linear_dim") and have == 0:
            have = sizes["item_embedding_dim"]
        if have != want:
            raise ValueError(f"{config['preset']}: {path} is {have!r}, the configuration states {want!r}")
    return cfg


def dims_of(config: dict) -> Dims:
    return Dims.from_config(config["sizes"])


def optimizer_of(config: dict) -> AdamW:
    s = config["sizes"]
    return AdamW(lr=s["lr"], beta1=s["betas"][0], beta2=s["betas"][1], eps=s["adam_eps"],
                 weight_decay=s["weight_decay"])


def program_data(cfg, hist: traffic.Histories, seed: int):
    """The port's data module over the benchmark's histories (its synthetic
    draw takes a fixed seed; the benchmark's come from the run's)."""
    from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
    from mygenerativerecommenders_tpu_torch.data.synthetic import SyntheticInteractions

    data = RecoData.__new__(RecoData)
    data.cfg, data._seed, data.processor, data._splits = cfg.data, seed, None, {}
    data.interactions = SyntheticInteractions(
        catalog=hist.catalog, user_ids=np.arange(1, len(hist.item_ids) + 1, dtype=np.int64),
        item_ids=hist.item_ids, ratings=hist.ratings, timestamps=hist.timestamps, users={})
    data.all_item_ids = hist.catalog.astype(np.int32)
    data.max_item_id = int(cfg.data.expected_max_item_id)
    data.year_of_item = None
    return data


def describe_batch(host: Dict[str, np.ndarray], dims: Dims, packed: bool) -> dict:
    """A step's work from its host batch: the attention call of each block,
    valid tokens, supervised positions and drawn rows."""
    if packed:
        ids, pos = host["ids"], host["positions"]
        lengths = (ids != 0).shape[1] - np.argmax((ids != 0)[:, ::-1], axis=1)
        lengths = np.where((ids != 0).any(1), lengths, 0)
        seg = host["seg_ids"]
        sup = int(((ids[:, 1:] != 0) & (seg[:, 1:] == seg[:, :-1]) & (seg[:, :-1] >= 0)).sum())
        attn = describe(lengths, ids.shape[1], pos)
        drawn = ids.shape[0] * (ids.shape[1] - 1)
    else:
        lengths = host["lengths"].astype(np.int64) + 1  # the history and the target
        n = host["ids"].shape[1] + dims.max_out
        attn = describe(lengths, n)
        sup = int(((host["lengths"]) * (host["sample_weight"] > 0)).sum())
        drawn = host["ids"].shape[0] * (n - 1)
    return {"attn": attn, "tokens": attn["rows"], "supervised": sup, "drawn_rows": drawn}


def checked_batches(loader, least: int = 3) -> List[Dict[str, np.ndarray]]:
    """The host batches of the loader's epoch that the check runs, in the
    epoch's order: the first batch of each shape (the packed loader keeps a
    packing class's batches together, so one a class), then the epoch's
    earliest others until there are `least`."""
    first, others, shapes = [], [], set()
    for i, batch in enumerate(loader):
        shape = batch["ids"].shape
        if shape not in shapes:
            shapes.add(shape)
            first.append((i, batch))
        elif len(others) < least:
            others.append((i, batch))
    chosen = first + others[:max(least - len(first), 0)]
    return [batch for _, batch in sorted(chosen, key=lambda t: t[0])]


def bad_segments(hosts: List[Dict[str, np.ndarray]], hist: traffic.Histories, dims: Dims,
                 packed: bool) -> int:
    """The checked batches' sequences that are not a user's training example
    as the harness's histories give it (its items but the last held out, the
    most recent `max_history` of the rest then the target, with their
    timestamps, positions counting from 0): the loader's stage, which the
    reference takes as its input, checked by itself."""
    want = {}
    for items, stamps in zip(hist.item_ids, hist.timestamps):
        ids, ts = items[:-1], stamps[:-1]
        keep = slice(max(len(ids) - 1 - dims.max_history, 0), len(ids))
        want[tuple(ids[keep].tolist())] = tuple(ts[keep].tolist())
    bad = 0
    for host in hosts:
        if packed:
            for r in range(host["ids"].shape[0]):
                seg = host["seg_ids"][r]
                for s in np.unique(seg[seg >= 0]):
                    at = seg == s
                    ids, ts, pos = host["ids"][r][at], host["timestamps"][r][at], host["positions"][r][at]
                    bad += int(want.get(tuple(ids.tolist())) != tuple(ts.tolist())
                               or not np.array_equal(pos, np.arange(len(pos))))
        else:
            for r in np.flatnonzero(host["sample_weight"] > 0):
                n = int(host["lengths"][r])
                ids = host["ids"][r][:n].tolist() + [int(host["target_id"][r])]
                ts = host["timestamps"][r][:n].tolist() + [int(host["target_timestamp"][r])]
                bad += int(want.get(tuple(ids)) != tuple(ts))
    return bad


def _numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """Each step's loss, step 1's gradient norms and the checked steps' change
    norms, by the worst leaf against the reference's norm of that leaf or of
    the median leaf, whichever is larger; leaves whose reference gradient is
    under a thousandth of the median leaf's are left out of the change."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]) or not all(map(math.isfinite, prog["losses"])):
        loss_gap = float("inf")
    g_ref = ref["grad_norms"]
    g_med = statistics.median(g_ref.values())
    grad_gap = max(abs(prog["grad_norms"].get(n, 0.0) - g) / max(g, g_med) for n, g in g_ref.items())
    kept = [n for n, g in g_ref.items() if g >= 1e-3 * g_med]
    c_ref = ref["change_norms"]
    c_med = statistics.median(c_ref[n] for n in kept)
    change_gap = max(abs(prog["change_norms"][n] - c_ref[n]) / max(c_ref[n], c_med) for n in kept)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


class _Shifted:
    """A loader whose batches carry every timestamp a second late."""

    def __init__(self, inner):
        self._inner = inner

    def __len__(self) -> int:
        return len(self._inner)

    def __iter__(self):
        for batch in self._inner:
            yield {**batch, "timestamps": batch["timestamps"] + (batch["timestamps"] > 0)}


def _plant(trainer, fault: str) -> None:
    """A fault under the timed path, for the check's own test: "frozen" (the
    optimizer's step changes nothing), "half_batch" (the second half of each
    batch's rows left out of the loss), "shifted_timestamps" (the loader's
    batches a second late: the reference, which takes the loader's batches,
    agrees, and the batches' own check catches it)."""
    if fault == "frozen":
        trainer.optimizer.step = lambda *a, **k: None
    elif fault == "half_batch":
        put = trainer._put

        def halved(batch):
            batch = dict(batch)
            half = batch["ids"].shape[0] // 2
            if "seg_ids" in batch:
                batch["ids"] = batch["ids"].copy()
                batch["ids"][half:] = 0
            else:
                batch["sample_weight"] = batch["sample_weight"].copy()
                batch["sample_weight"][half:] = 0
            return put(batch)

        trainer._put = halved
    elif fault == "shifted_timestamps":
        make = trainer._loader
        trainer._loader = lambda *a, **k: _Shifted(make(*a, **k))
    elif fault:
        raise ValueError(f"unknown fault {fault!r}")


def run(cell, seed: int, seconds: float, trace: bool, t_start: float, device: str = "cuda",
        fault: str = "") -> dict:
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    config, mix = cell.config, cell.traffic
    sizes = config["sizes"]
    dims = dims_of(config)
    out_dir = tempfile.mkdtemp(prefix="gpubench-")
    try:
        cfg = program_config(config, seed, device, out_dir)
        hist = traffic.histories(mix, sizes["num_items"], sizes["max_item_id"], seed)
        trainer = Trainer(cfg, data=program_data(cfg, hist, seed))
        shapes = weights.shapes_of(trainer.model)
        weights.load(trainer.model, weights.make(shapes, seed, trainer.device))
        _plant(trainer, fault)
        packed = bool(sizes["pack_sequences"])
        params = dict(trainer.model.named_parameters())
        n_params = sum(p.numel() for p in params.values())
        lr1, lr2 = trainer.lr1, trainer.lr2

        def one(dev):
            if trainer.train_steps is not None:
                return trainer.train_steps([dev], lr1, lr2)
            return trainer.train_step(dev, lr1, lr2).reshape(1)

        loader = trainer._loader("train", packed=trainer._packed)
        checked = checked_batches(loader)
        first = list(trainer._batches(checked, len(checked)))
        trainer.model.train()  # as train_epoch sets it
        losses = []
        beta1 = sizes["betas"][0]
        for i, (_, dev) in enumerate(first):
            losses.append(float(one(dev)[0]))
            if i == 0:
                state = trainer.optimizer.state
                grad_norms = {n: float(state[p]["exp_avg"].norm()) / (1 - beta1)
                              for n, p in params.items() if "exp_avg" in state.get(p, {})}
        w0 = weights.make(shapes, seed, trainer.device)  # made again, not kept
        change_norms = {n: float((p.detach() - w0[n]).norm()) for n, p in params.items()}
        prog = {"losses": losses, "grad_norms": grad_norms, "change_norms": change_norms}
        hosts = [h for h, _ in first]
        del w0, first, checked
        trainer.global_step += len(hosts)
        trainer.train_epoch(loader)  # every batch shape captured
        if device == "cuda":
            torch.cuda.synchronize()

        steps: List[dict] = []
        if trace:
            batches = trainer._batches

            def recorded(ld, limit):
                for host, dev in batches(ld, limit):
                    steps.append(describe_batch(host, dims, packed))
                    yield host, dev

            trainer._batches = recorded
        setup_s = time.perf_counter() - t_start
        traced_steps, traced_s, sl = [], 0.0, None
        examples = n_steps = epochs = 0
        t0 = time.perf_counter()
        while True:
            before = trainer.global_step
            if trace and sl is None:
                from gpubench.profiling import Slice

                with Slice() as sl:  # the window's first epochs
                    for _ in range(int(mix.get("trace_epochs", 1))):
                        final = trainer.train_epoch(loader)
                        examples += trainer.epoch_examples
                traced_s = sl.window_s
                traced_steps, steps[:] = list(steps), []
            else:
                final = trainer.train_epoch(loader)
                examples += trainer.epoch_examples
            n_steps += trainer.global_step - before
            epochs += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        summary = sl.summary() if sl is not None else None
        out = {
            "setup_s": setup_s, "window_s": window_s, "examples": examples, "steps": n_steps,
            "attempted": n_steps, "failed": 0 if math.isfinite(final) else n_steps,
            "final_loss": final, "peak_bytes": peak, "summary": summary,
            "e2e": {"train_examples_per_s": examples / window_s, "setup_s": setup_s},
            "ctx": {"summary": summary, "steps": traced_steps,
                    "window_steps": steps, "window_s": window_s - traced_s,
                    "dims": dims, "params": n_params, "catalog_size": len(hist.catalog),
                    "peak_bytes": peak},
            "counters": _counters(),
        }
        del trainer, params, loader
        gc.collect()
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        ref = follow_training(weights.make(shapes, seed, device), dims, hosts, hist.catalog,
                              seed, optimizer_of(config), packed)
        out["numbers"] = {**_numbers(prog, ref),
                          "bad_segments": float(bad_segments(hosts, hist, dims, packed))}
        return out
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _counters() -> dict:
    """The port's own counts: each kernel wrapper's launches and the step
    graphs' captures, warm-up runs and replays."""
    from mygenerativerecommenders_tpu_torch.train import graphs

    out = {f"{m.__name__.rsplit('.', 1)[-1]}.{name}": getattr(m, name) for m, name in graphs._COUNTERS}
    out.update({f"graphs.{k}.{c}": v for k, cs in graphs.counts.items() for c, v in cs.items()})
    return out
