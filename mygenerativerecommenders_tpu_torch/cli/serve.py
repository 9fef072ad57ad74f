"""Serving entry point: the HTTP retrieval and generation service from a
checkpoint.

Port of mygenerativerecommenders_tpu/cli/serve.py. Usage:

  python -m mygenerativerecommenders_tpu_torch.cli.serve experiment=<preset> \\
      trainer.ckpt_path=<model.pt | params.npz | reference.ckpt> serve.port=8000 serve.batch_size=32

Dotted options under `serve.`: host, port, batch_size, and device (default
cuda, where every engine program is a CUDA graph replay; serve.device=cpu
runs them eagerly, on the plain PyTorch versions of the kernels).
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

from mygenerativerecommenders_tpu_torch.checkpoint import load_weights
from mygenerativerecommenders_tpu_torch.cli.train import parse_args
from mygenerativerecommenders_tpu_torch.configs import resolve
from mygenerativerecommenders_tpu_torch.data.catalog import item_catalog
from mygenerativerecommenders_tpu_torch.models.model import build_model
from mygenerativerecommenders_tpu_torch.serving.service import (
    RecommenderHTTPServer,
    ServingEngine,
)

log = logging.getLogger(__name__)


def _pop_serve_overrides(argv: list[str]) -> tuple[list[str], dict]:
    opts = {"host": "127.0.0.1", "port": 8000, "batch_size": 32, "device": "cuda"}
    rest = []
    for arg in argv:
        if arg.startswith("serve.") and "=" in arg:
            key, value = arg[len("serve."):].split("=", 1)
            if key not in opts:
                raise ValueError(
                    f"unknown serve option {key!r}; expected one of {sorted(opts)}"
                )
            opts[key] = type(opts[key])(value)
        else:
            rest.append(arg)
    return rest, opts


def build_engine(argv: Optional[list[str]] = None) -> tuple[ServingEngine, dict]:
    argv, opts = _pop_serve_overrides(argv if argv is not None else sys.argv[1:])
    cfg = parse_args(argv)
    if not cfg.trainer.ckpt_path:
        raise ValueError("trainer.ckpt_path=<model.pt | params.npz> is required for serving")
    all_item_ids, max_item_id, year_of_item = item_catalog(cfg.data)
    resolve(cfg, max_item_id)
    model = build_model(cfg, device="cpu", year_of_item=year_of_item)
    load_weights(model, cfg.trainer.ckpt_path)
    engine = ServingEngine(
        model, cfg, all_item_ids, max_item_id,
        batch_size=opts["batch_size"], device=opts["device"],
    )
    return engine, opts


def main(argv: Optional[list[str]] = None):
    logging.basicConfig(level=logging.INFO)
    engine, opts = build_engine(argv)
    server = RecommenderHTTPServer(engine, opts["host"], opts["port"])
    log.info(
        "serving on http://%s:%s (device=%s, batch_size=%d, catalog=%d)",
        server.host, server.port, engine.device, engine.batch_size,
        len(engine.all_item_ids),
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
