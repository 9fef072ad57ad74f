"""Checkpoints of the port, and weights and gradients carried across from the
JAX package.

`params_to_state_dict` maps the JAX model's flax parameter tree (nested
dicts of numpy arrays) onto the port's `state_dict`, whose keys are the
reference checkpoint's (mygenerativerecommenders_tpu/cli/convert_ckpt.py:9-15).
The other way, that package's `torch_state_dict_to_params` (:34) loads the
port's `state_dict` into the JAX model unchanged.

Gradients have the parameters' tree, so the same mapping puts the JAX
package's gradient tree under the port's `state_dict` keys
(`grads_to_state_dict`): a test compares every parameter's gradient by name.
Optimizer state is not carried across (optax and torch lay it out
differently).

`load_checkpoint` reads a `.pt` (`torch.save` of that state_dict, or a
training checkpoint whose "model" entry holds it) or an `.npz` whose keys are
"/"-joined flax paths.

`CheckpointManager` is the trainer's: `best` (by the monitored metric) and
`last`, each one torch file `<dir>/<name>.pt` holding the model's and the
optimizer's `state_dict`, step, epoch, the metric and the controllers' state.
It replaces the JAX package's orbax manager (train/checkpoint.py).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_ENCODER = "sequence_encoder._hstu._attention_layers"
_BLOCK_KEYS = {
    ("uvqk",): "_uvqk",
    ("o", "kernel"): "_o.weight",  # flax [in, out] -> torch [out, in]
    ("o", "bias"): "_o.bias",
    ("rel_bias_pos_w",): "_rel_attn_bias._pos_w",
    ("rel_bias_ts_w",): "_rel_attn_bias._ts_w",
}


def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[tuple, np.ndarray]:
    flat = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            flat.update(_flatten(val, prefix + (str(key),)))
        else:
            flat[prefix + (str(key),)] = np.asarray(val)
    return flat


def params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax params ({"params": {...}} or the inner dict) -> the port's state_dict."""
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
    for path, arr in _flatten(params).items():
        if path == ("embeddings", "item_emb"):
            key = "embeddings._item_emb.weight"
        elif path == ("preprocessor", "pos_emb"):
            key = "preprocessor._pos_emb.weight"
        elif path[0] == "encoder" and path[1].startswith("block_") and path[2:] in _BLOCK_KEYS:
            key = f"{_ENCODER}.{path[1][len('block_'):]}.{_BLOCK_KEYS[path[2:]]}"
            if path[2:] == ("o", "kernel"):
                arr = arr.T
        else:
            raise ValueError(f"parameter {'/'.join(path)} has no counterpart in the port")
        out[key] = torch.tensor(np.asarray(arr, dtype=np.float32))
    return out


def grads_to_state_dict(grads: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's gradient tree (numpy leaves) -> a dict under the
    port's state_dict keys, transposed where the weights are."""
    return params_to_state_dict(grads)


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A `.pt` state_dict (or training checkpoint) or an `.npz` of flax paths
    -> the port's state_dict."""
    ext = os.path.splitext(path)[1]
    if ext == ".pt":
        state = torch.load(path, map_location="cpu", weights_only=True)
        return dict(state["model"] if "model" in state else state)
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
    raise ValueError(f"checkpoint {path!r}: expected a .pt state_dict or an .npz of flax paths")


class CheckpointManager:
    """Writes `last.pt` at every save and `best.pt` when the monitored metric
    improves."""

    def __init__(self, ckpt_dir: str, monitor: str = "val/ndcg@100", mode: str = "max"):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.best_value: Optional[float] = None
        self.best_path: Optional[str] = None
        self.last_path = os.path.join(self.ckpt_dir, "last.pt")

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
    ) -> None:
        state = {
            "model": model.state_dict(),
            "optimizer": optimizer.state_dict(),
            "step": step,
            "epoch": epoch,
            "monitor": self.monitor,
            "metric_value": metric_value,
            "extra": extra or {},
        }
        tmp = self.last_path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self.last_path)  # a reader never sees half a file
        if metric_value is not None and self._is_better(metric_value):
            self.best_value = metric_value
            self.best_path = os.path.join(self.ckpt_dir, "best.pt")
            torch.save(state, tmp)
            os.replace(tmp, self.best_path)

    @staticmethod
    def load(path: str, device: Any = "cpu") -> Dict[str, Any]:
        """The saved dict, tensors mapped to `device`."""
        return torch.load(path, map_location=device, weights_only=True)
