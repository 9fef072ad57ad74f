"""Carry weights between the JAX package and the port.

`params_to_state_dict` maps the JAX model's flax parameter tree (nested
dicts of numpy arrays) onto the port's `state_dict`, whose keys are the
reference checkpoint's (mygenerativerecommenders_tpu/cli/convert_ckpt.py:9-15).
The other way, that package's `torch_state_dict_to_params` (:34) loads the
port's `state_dict` into the JAX model unchanged.

`load_checkpoint` reads either a `.pt` (`torch.save` of that state_dict) or
an `.npz` whose keys are "/"-joined flax paths.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

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


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A `.pt` state_dict or an `.npz` of flax paths -> the port's state_dict."""
    ext = os.path.splitext(path)[1]
    if ext == ".pt":
        return dict(torch.load(path, map_location="cpu", weights_only=True))
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
