"""Checkpoints of the port, and weights and gradients carried across from the
JAX package.

`params_to_state_dict` maps the JAX model's flax parameter tree (nested
dicts of numpy arrays) onto the port's `state_dict`, whose keys are the
reference checkpoint's (mygenerativerecommenders_tpu/cli/convert_ckpt.py:9-15).
The other way, that package's `torch_state_dict_to_params` (:34) loads the
port's `state_dict` into the JAX model unchanged.

The parameters that the JAX converter maps to no reference key (its
`cli/convert_ckpt.py:63-93` knows the HSTU model's alone) keep their JAX
leaf's path, "/" read as ".", in flax's layout (models/dense.py):

  preprocessor/aux_projection/{kernel,bias} -> preprocessor.aux_projection.{kernel,bias}
  preprocessor/aux_emb_<col>                -> preprocessor.aux_emb_<col>
  encoder/mha_<i>/<proj>/{kernel,bias}      -> sequence_encoder._sasrec.mha_<i>.<proj>.{kernel,bias}
                                               (<proj>: query, key, value, out)
  encoder/ffn_<i>/conv<j>/{kernel,bias}     -> sequence_encoder._sasrec.ffn_<i>.conv<j>.{kernel,bias}
  similarity/<layer>/<leaf>                 -> similarity.<layer>.<leaf>
                                               (MoL: context_proj, item_proj, gate_context,
                                               gate_item, gate_ci, tau_fn; kernel / bias or
                                               a GLU's w / b)

and the aux preprocessor's positional table is `preprocessor._pos_emb.weight`
as the plain one's. So a reference `.ckpt` of such a model, which has no
such keys, raises naming the first missing one, as any missing key does.
The item_year embedding's tables are the reference's
`embeddings._item_emb.weight` and `embeddings._year_emb.weight`.

The fork's own `.ckpt` files hold the year table (its `LocalEmbeddingModule`
always splits D in two), sized by the fork at num_items + 1 rows, and may
hold its item -> year buffer `embeddings.year_lookup_table`.
`fit_reference_state` takes such a file as the JAX converter does
(`cli/convert_ckpt.py:68-82`): the year rows are cut or zero-padded to the
model's 2,201 (rows past either end are never indexed: year ids are year
values), and the buffer, which that converter never reads, is dropped (the
model reads the years from its catalog). A year table given to a `local`
model raises, naming the key.

Gradients have the parameters' tree, so the same mapping puts the JAX
package's gradient tree under the port's `state_dict` keys
(`grads_to_state_dict`): a test compares every parameter's gradient by name.
Of the optimizer state, `train/optimizers.py:load_jax_momentum` carries
Muon's and Scion's momentum across (`jax_tree_to_state_dict`); the rest of
optax's state is not carried (optax and torch lay it out differently).

`load_checkpoint` reads a `.pt` (`torch.save` of that state_dict, or a
training checkpoint whose "model" entry holds it), a reference Lightning
`.ckpt` (its "state_dict" entry, the `model.` / `net.` prefixes stripped, read
with `weights_only=True`) or an `.npz` whose keys are "/"-joined flax paths;
`load_weights` loads one into a model, raising on a missing or unexpected key
or a shape that differs (the JAX package's converter fills a missing key
with its fresh init instead).

`CheckpointManager` is the trainer's: `best` (by the monitored metric) and
`last`, each one torch file `<dir>/<name>.pt` holding the model's and the
optimizer's `state_dict`, step, epoch, the metric and the controllers' state
(under `embedding.lazy_update` the optimizer's holds the table's moments `mv`
and step count beside the AdamW state, train/lazy_embedding.py). A save
writes `last` once; a new `best` is a second link to that file, not a
second write (at a 10M-item catalog one checkpoint is ~7.7 GB).
On the card the optimizer is fused: its state holds the learning rate as a
device tensor and the step counts on the device, which `load` maps to the
trainer's device and `train/optimizers.py:load_optimizer_state` takes into
the optimizer's own tensors. The random states are read after the epoch's
last step, graph replays included: each replay advances the default CUDA
generator (dropout) by the captured step's draws, and the negatives are drawn
outside the graphs. It replaces the JAX package's orbax manager
(train/checkpoint.py).

With `async_save` (`trainer.async_checkpoint`, JAX train/checkpoint.py:22-131)
a save copies the whole state to host memory before it returns (into pinned
buffers kept from one save to the next, a non-blocking copy from the card
and one wait on it), then a background thread writes that copy with
`torch.save`, renames it over `last.pt` and links `best.pt`, as the
synchronous save does. The thread reads only the host copy, never a live
parameter or optimizer tensor (graph replays update those in place), and a
crash before its rename leaves the previous file whole. `flush` waits for
the write in flight (raising what it raised): each save calls it, and the
trainer calls it before it reads a checkpoint (resume, `test`, `cli.eval`)
and at the end of `fit`.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

log = logging.getLogger(__name__)

_ENCODER = "sequence_encoder._hstu._attention_layers"
_BLOCK_KEYS = {
    ("uvqk",): "_uvqk",
    ("o", "kernel"): "_o.weight",  # flax [in, out] -> torch [out, in]
    ("o", "bias"): "_o.bias",
    ("rel_bias_pos_w",): "_rel_attn_bias._pos_w",
    ("rel_bias_ts_w",): "_rel_attn_bias._ts_w",
}


def _flatten(tree: Mapping[str, Any], prefix=(), arrays_only: bool = False
             ) -> Dict[tuple, np.ndarray]:
    flat = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            flat.update(_flatten(val, prefix + (str(key),), arrays_only))
        elif not arrays_only or hasattr(val, "shape"):
            flat[prefix + (str(key),)] = np.asarray(val)
    return flat


def transposed_from_jax(key: str) -> bool:
    """Whether the port stores the parameter under `key` as the transpose of
    its flax leaf (`_o.weight`: torch Linear's [out, in], flax's [in, out])."""
    return key.endswith("." + _BLOCK_KEYS[("o", "kernel")])


def params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax params ({"params": {...}} or the inner dict) -> the port's state_dict."""
    return _to_state_dict(params, arrays_only=False)


def jax_tree_to_state_dict(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A tree shaped as the flax params, some of whose leaves are not arrays
    (optax's placeholders for the parameters another transform of a
    `multi_transform` owns) -> the arrays under the port's keys, transposed
    where the weights are; the other leaves are skipped."""
    return _to_state_dict(tree, arrays_only=True)


def _to_state_dict(params: Mapping[str, Any], arrays_only: bool) -> Dict[str, torch.Tensor]:
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
    for path, arr in _flatten(params, arrays_only=arrays_only).items():
        if path in (("embeddings", "item_emb"), ("embeddings", "year_emb")):
            key = f"embeddings._{path[1]}.weight"
        elif path in (("preprocessor", "pos_emb"), ("preprocessor", "rating_emb")):
            key = f"preprocessor._{path[1]}.weight"
        elif path[0] == "encoder" and path[1].startswith("block_") and path[2:] in _BLOCK_KEYS:
            key = f"{_ENCODER}.{path[1][len('block_'):]}.{_BLOCK_KEYS[path[2:]]}"
            if path[2:] == ("o", "kernel"):
                arr = arr.T
        elif path[0] == "preprocessor" and (
            path[1] == "aux_projection" or path[1].startswith("aux_emb_")
        ):
            key = ".".join(path)
        elif path[0] == "encoder" and path[1].startswith(("mha_", "ffn_")):
            key = f"sequence_encoder._sasrec.{'.'.join(path[1:])}"
        elif path[0] == "similarity":
            key = ".".join(path)
        else:
            raise ValueError(f"parameter {'/'.join(path)} has no counterpart in the port")
        out[key] = torch.tensor(np.asarray(arr, dtype=np.float32))
    return out


def grads_to_state_dict(grads: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's gradient tree (numpy leaves) -> a dict under the
    port's state_dict keys, transposed where the weights are."""
    return params_to_state_dict(grads)


def strip_reference_prefixes(state: Mapping[str, Any]) -> Dict[str, Any]:
    """A Lightning module's state_dict keys without the `model.` and `net.`
    prefixes, stripped in that order as the JAX package strips them
    (cli/convert_ckpt.py:48-52)."""
    def strip(key: str) -> str:
        for prefix in ("model.", "net."):
            if key.startswith(prefix):
                key = key[len(prefix):]
        return key

    return {strip(k): v for k, v in state.items()}


def load_checkpoint(path: str, map_location: Any = "cpu") -> Dict[str, torch.Tensor]:
    """A `.pt` state_dict (or training checkpoint), a reference Lightning
    `.ckpt` (its `state_dict`, prefixes stripped), or an `.npz` of flax paths
    -> the port's state_dict. A `.ckpt` is read with `weights_only=True`: one
    whose pickle holds more than tensors and plain values needs
    `cli/convert_ckpt.py` first."""
    ext = os.path.splitext(path)[1]
    if ext == ".pt":
        state = torch.load(path, map_location=map_location, weights_only=True)
        return dict(state["model"] if "model" in state else state)
    if ext == ".ckpt":
        try:
            ckpt = torch.load(path, map_location=map_location, weights_only=True)
        except Exception as e:  # the unpickler names what it refused
            raise ValueError(
                f"checkpoint {path!r} holds more than tensors ({e}); convert it with "
                "python -m mygenerativerecommenders_tpu_torch.cli.convert_ckpt "
                f"{path} <out.pt> experiment=<preset>"
            ) from e
        return strip_reference_prefixes(ckpt.get("state_dict", ckpt))
    if ext == ".npz":
        tree: Dict[str, Any] = {}
        with np.load(path) as f:
            for name in f.files:
                node = tree
                *parents, leaf = name.split("/")
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = f[name]
        return params_to_state_dict(tree)
    raise ValueError(
        f"checkpoint {path!r}: expected a .pt state_dict, a Lightning .ckpt or an .npz of "
        "flax paths"
    )


YEAR_TABLE, YEAR_BUFFER = "embeddings._year_emb.weight", "embeddings.year_lookup_table"


def fit_reference_state(model: torch.nn.Module, state: Mapping[str, Any]) -> Dict[str, Any]:
    """`state` with the fork's item -> year buffer dropped and its year table
    cut or zero-padded to the model's rows (the JAX converter's rule); the
    log line says what was done. A year table for a model without one
    raises a ValueError naming the key."""
    want = model.state_dict()
    state = dict(state)
    notes = []
    if YEAR_BUFFER in state:
        del state[YEAR_BUFFER]
        notes.append(f"dropped {YEAR_BUFFER} (the years come from the data catalog)")
    if YEAR_TABLE in state:
        if YEAR_TABLE not in want:
            raise ValueError(
                f"checkpoint holds {YEAR_TABLE}, the fork's item/year split table, but the "
                "model has no year table: build it with model.embedding.kind=item_year"
            )
        table = torch.as_tensor(state[YEAR_TABLE])
        rows = want[YEAR_TABLE].shape[0]
        if table.shape[0] != rows:
            notes.append(f"{YEAR_TABLE} rows {table.shape[0]} -> {rows}")
            if table.shape[0] > rows:
                table = table[:rows]
            else:
                table = torch.cat([table, table.new_zeros((rows - table.shape[0],
                                                           *table.shape[1:]))])
        state[YEAR_TABLE] = table
    if notes:
        log.info("reference checkpoint: " + "; ".join(notes))
    return state


def check_state_dict(model: torch.nn.Module, state: Mapping[str, Any]) -> None:
    """Raise unless `state` has exactly the model's keys, each of its shape."""
    want = model.state_dict()
    missing = [k for k in want if k not in state]
    extra = [k for k in state if k not in want]
    if missing or extra:
        raise ValueError(
            f"checkpoint keys do not match the model: missing {missing}, unexpected {extra}"
        )
    for key, t in want.items():
        if tuple(state[key].shape) != tuple(t.shape):
            raise ValueError(
                f"shape mismatch for {key}: checkpoint {tuple(state[key].shape)} vs model "
                f"{tuple(t.shape)}"
            )


def load_weights(model: torch.nn.Module, path: str, map_location: Any = "cpu") -> None:
    """`load_checkpoint(path)` into `model` (a fork's year table fitted by
    `fit_reference_state`; a model placed over a process group takes its
    blocks of it, parallel/tensor_parallel.py), every key and shape checked."""
    from mygenerativerecommenders_tpu_torch.parallel.tensor_parallel import local_state_dict

    state = local_state_dict(model, fit_reference_state(model, load_checkpoint(path, map_location)))
    check_state_dict(model, state)
    model.load_state_dict(state)


class CheckpointManager:
    """Writes `last.pt` at every save and `best.pt` when the monitored metric
    improves; with `async_save` the writing runs in a background thread.
    `write=False` (a data-parallel rank but 0) keeps the best metric and
    path as the writing rank does and writes nothing."""

    def __init__(self, ckpt_dir: str, monitor: str = "val/ndcg@100", mode: str = "max",
                 async_save: bool = False, write: bool = True):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.best_value: Optional[float] = None
        self.best_path: Optional[str] = None
        self.last_path = os.path.join(self.ckpt_dir, "last.pt")
        self.async_save = async_save
        self.write = write
        self._host: List[torch.Tensor] = []  # the host copies' buffers, in walk order
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def _is_better(self, value: float) -> bool:
        if self.best_value is None:
            return True
        return value > self.best_value if self.mode == "max" else value < self.best_value

    def save(
        self,
        model: torch.nn.Module,
        optimizer: torch.optim.Optimizer,
        *,
        step: int,
        epoch: int,
        metric_value: Optional[float] = None,
        extra: Optional[Dict[str, Any]] = None,
        model_state: Optional[Dict[str, Any]] = None,
        optimizer_state: Optional[Dict[str, Any]] = None,
    ) -> None:
        """`model_state` and `optimizer_state`, where given, are written in
        place of the model's and the optimizer's own `state_dict()` (a
        placed model's gathered into the one-process layout,
        parallel/tensor_parallel.py)."""
        self.flush()
        state = {
            "model": model.state_dict() if model_state is None else model_state,
            "optimizer": optimizer.state_dict() if optimizer_state is None else optimizer_state,
            "step": step,
            "epoch": epoch,
            "monitor": self.monitor,
            "metric_value": metric_value,
            "extra": extra or {},
        }
        best = metric_value is not None and self._is_better(metric_value)
        if best:
            self.best_value = metric_value
            self.best_path = os.path.join(self.ckpt_dir, "best.pt")
        if not self.write:
            return
        if not self.async_save:
            self._write(state, best)
            return
        state = self._host_copy(state)
        self._writer = threading.Thread(target=self._write_in_background, args=(state, best),
                                        name="checkpoint-writer")
        self._writer.start()

    def flush(self) -> None:
        """Wait for the save in flight, if any; raise what its write raised."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError(f"the background checkpoint write to {self.last_path} "
                               "failed") from error

    def _host_copy(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """`state` with every tensor copied into a host buffer of its own
        (pinned where the tensor is on the card), waited for before it
        returns. The buffers are reused from save to save: the state's
        structure does not change within a run, and `flush` has ended the
        last write before they are written again."""
        buffers = iter(self._host)
        made: List[torch.Tensor] = []
        copied_from_card = False

        def walk(obj: Any) -> Any:
            nonlocal copied_from_card
            if isinstance(obj, torch.Tensor):
                buf = next(buffers, None)
                if buf is None or buf.shape != obj.shape or buf.dtype != obj.dtype:
                    buf = torch.empty(obj.shape, dtype=obj.dtype,
                                      pin_memory=obj.device.type == "cuda")
                made.append(buf)
                copied_from_card |= obj.device.type == "cuda"
                return buf.copy_(obj.detach(), non_blocking=obj.device.type == "cuda")
            if isinstance(obj, dict):
                return {k: walk(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return type(obj)(walk(v) for v in obj)
            return obj

        state = walk(state)
        self._host = made
        if copied_from_card:
            torch.cuda.synchronize()
        return state

    def _write_in_background(self, state: Dict[str, Any], best: bool) -> None:
        try:
            self._write(state, best)
        except Exception as error:  # handed to the trainer's thread by flush
            self._error = error

    def _write(self, state: Dict[str, Any], best: bool) -> None:
        tmp = self.last_path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self.last_path)  # a reader never sees half a file
        if best:
            try:
                # the next save replaces `last` by another file: this one stays `best`
                os.link(self.last_path, tmp)
            except OSError:  # a file system without hard links
                torch.save(state, tmp)
            os.replace(tmp, self.best_path)

    @staticmethod
    def load(path: str, device: Any = "cpu") -> Dict[str, Any]:
        """The saved dict, tensors mapped to `device`."""
        return torch.load(path, map_location=device, weights_only=True)
