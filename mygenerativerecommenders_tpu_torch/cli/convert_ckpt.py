"""Convert a reference (PyTorch Lightning) checkpoint into a `.pt` of the
port's state_dict.

Port of mygenerativerecommenders_tpu/cli/convert_ckpt.py. Usage:

  python -m mygenerativerecommenders_tpu_torch.cli.convert_ckpt \\
      <reference.ckpt> <out.pt> [experiment=<preset>] [overrides...]

The port's state_dict keys are the reference's, so the map is the identity
once the `state_dict` entry is taken and the `model.` / `net.` prefixes are
stripped (`checkpoint.strip_reference_prefixes`); the fork's year table is
fitted to the item_year model's rows and its item -> year buffer dropped
(`checkpoint.fit_reference_state`). Every key and shape is
checked against the model the preset builds (its catalog from
`data.data_dir`, as `cli.train` builds it); a missing or extra key raises
and names it. The written `.pt` holds tensors only, so `cli.eval`,
`cli.predict` and `cli.serve` read it with `weights_only=True`. This is the
one place that unpickles a checkpoint with `weights_only=False`: a Lightning
file's `hyper_parameters` may hold any Python object, so run it only on a
file you trust.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import torch

from mygenerativerecommenders_tpu_torch.checkpoint import (
    check_state_dict,
    fit_reference_state,
    strip_reference_prefixes,
)
from mygenerativerecommenders_tpu_torch.cli.train import parse_args
from mygenerativerecommenders_tpu_torch.configs import resolve
from mygenerativerecommenders_tpu_torch.data.catalog import item_catalog
from mygenerativerecommenders_tpu_torch.models.model import build_model
from mygenerativerecommenders_tpu_torch.train.loggers import get_logger

log = get_logger(__name__)


def main(argv: Optional[list[str]] = None) -> str:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        raise ValueError("usage: convert_ckpt <reference.ckpt> <out.pt> [experiment=...] ...")
    ckpt_path, out_path, rest = argv[0], argv[1], argv[2:]
    cfg = parse_args(rest)
    _, max_item_id, year_of_item = item_catalog(cfg.data)
    resolve(cfg, max_item_id)
    model = build_model(cfg, device="cpu", year_of_item=year_of_item)
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    state = fit_reference_state(model, strip_reference_prefixes(ckpt.get("state_dict", ckpt)))
    check_state_dict(model, state)
    want = model.state_dict()
    state = {k: torch.as_tensor(state[k]).to(want[k].dtype).contiguous() for k in want}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.save(state, out_path)
    log.info(f"converted {ckpt_path} -> {out_path} ({len(state)} tensors)")
    return out_path


if __name__ == "__main__":
    main()
