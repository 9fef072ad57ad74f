"""Online serving: batch retrieval behind a small stdlib HTTP service.

Port of mygenerativerecommenders_tpu/serving/service.py. The engine pads
every request to a fixed serving batch and the model's max length (keeping
the most recent items), runs the retrieval eval step on its device, and
keeps the candidate matrix resident there. A coalescer groups concurrent
single-row requests into one engine call.

Every engine call runs under one lock and `torch.inference_mode()`:
multi-row requests call the engine straight from handler threads, and the
lock keeps the calls, and so the kernels' launch counts, one at a time.

Endpoints (JSON over HTTP):
  GET  /healthz                      -> {"status": "ok", ...}
  POST /v1/retrieve  {"sequences": [[id,...],...],
                      "timestamps": [[t,...],...]?, "k": int?}
                                     -> {"ids": [[...]], "scores": [[...]]}
  POST /v1/generate                  -> 501 until models/decode.py is ported
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mygenerativerecommenders_tpu_torch import not_ported
from mygenerativerecommenders_tpu_torch.configs import Config
from mygenerativerecommenders_tpu_torch.models.model import GenerativeRecommender
from mygenerativerecommenders_tpu_torch.train.task_retrieval import (
    make_candidate_fn,
    make_eval_step,
)


class ServingEngine:
    """Model + candidate matrix + the eval step, at a static batch shape."""

    def __init__(
        self,
        model: GenerativeRecommender,
        cfg: Config,
        all_item_ids: np.ndarray,
        max_item_id: int,
        batch_size: int = 32,
        device: Union[str, torch.device] = "cuda",
    ):
        if cfg.model.task != "retrieval":
            # the server answers retrieval requests only, as the JAX package's
            raise not_ported(f"serving model.task={cfg.model.task}", "Other model families")
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.batch_size = int(batch_size)
        self.max_len = int(cfg.data.max_sequence_length)
        self.all_item_ids = np.asarray(all_item_ids, dtype=np.int32)
        self.max_item_id = int(max_item_id)
        self.calls = 0  # engine calls so far (each runs the model once)
        self._lock = threading.Lock()
        self._eval_step = make_eval_step(self.model, cfg, self.all_item_ids, max_item_id)
        self._candidate_fn = make_candidate_fn(self.model, cfg, self.all_item_ids)
        self.refresh_candidates()

    def refresh_candidates(self) -> None:
        """Rebuild the device-resident candidate matrix from current weights."""
        with self._lock, torch.inference_mode():
            self.candidates = self._candidate_fn()

    def _pack(
        self,
        sequences: Sequence[Sequence[int]],
        timestamps: Optional[Sequence[Sequence[int]]],
    ) -> Tuple[Dict[str, np.ndarray], int]:
        """Pad/truncate raw id (and timestamp) lists into a loader batch.

        A row whose timestamps are None gets the default 1..len, whatever
        the other rows carry: the JAX engine drops every row's timestamps
        when one row of a coalesced batch has none (ROADMAP.md, queue 3).
        """
        n_real = len(sequences)
        if n_real == 0:
            raise ValueError("empty request: 'sequences' has no rows")
        if n_real > self.batch_size:
            raise ValueError(
                f"request rows {n_real} > serving batch size {self.batch_size}"
            )
        b, l = self.batch_size, self.max_len
        ids = np.zeros((b, l), dtype=np.int32)
        ts = np.zeros((b, l), dtype=np.int32)
        lengths = np.zeros(b, dtype=np.int32)
        for i, row in enumerate(sequences):
            row = list(row)[-l:]  # keep the most recent items
            if not row:
                raise ValueError(f"sequences[{i}] is empty")
            lengths[i] = len(row)
            ids[i, : len(row)] = row
            if timestamps is not None and timestamps[i] is not None:
                trow = list(timestamps[i])[-l:]
                if len(trow) != len(row):
                    raise ValueError(
                        f"timestamps[{i}] length {len(trow)} != sequence "
                        f"length {len(row)}"
                    )
                ts[i, : len(trow)] = trow
            else:
                # monotone defaults so the relative time bias is well-formed
                ts[i, : len(row)] = np.arange(1, len(row) + 1)
        lengths = np.maximum(lengths, 1)  # padding rows need length >= 1
        batch = {
            "lengths": lengths,
            "ids": ids,
            "ratings": np.zeros((b, l), dtype=np.int32),
            "timestamps": ts,
            "target_id": np.zeros(b, dtype=np.int32),
            "target_rating": np.zeros(b, dtype=np.int32),
            # the query position's "next-item" timestamp: last seen + 1
            "target_timestamp": (ts.max(axis=1) + 1).astype(np.int32),
            "sample_weight": (np.arange(b) < n_real).astype(np.float32),
        }
        return batch, n_real

    def retrieve(
        self,
        sequences: Sequence[Sequence[int]],
        timestamps: Optional[Sequence[Sequence[int]]] = None,
        k: Optional[int] = None,
    ) -> Tuple[List[List[int]], List[List[float]]]:
        """Top-k next-item retrieval for raw id sequences."""
        batch, n_real = self._pack(sequences, timestamps)
        tensors = {
            key: torch.from_numpy(val).to(self.device) for key, val in batch.items()
        }
        with self._lock, torch.inference_mode():
            self.calls += 1
            top_ids, top_scores = self._eval_step(tensors, self.candidates)
            top_ids = top_ids[:n_real].cpu().numpy()
            top_scores = top_scores[:n_real].cpu().numpy()
        if k is not None:
            k = max(1, min(int(k), top_ids.shape[1]))
            top_ids, top_scores = top_ids[:, :k], top_scores[:, :k]
        return top_ids.tolist(), [[float(s) for s in row] for row in top_scores.tolist()]

    def generate(self, *args, **kwargs) -> List[List[int]]:
        raise not_ported("autoregressive generation (models/decode.py)", "Generation")


class _Coalescer:
    """Groups concurrent single-row requests into one engine call.

    Handler threads `submit()` rows and block; a dispatcher thread drains
    up to `max_rows` rows every `window_s` and invokes `run_batch` once.
    """

    def __init__(self, run_batch: Callable, max_rows: int, window_s: float = 0.002):
        self._run_batch = run_batch
        self._max_rows = max_rows
        self._window_s = window_s
        self._pending: List[dict] = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, row: dict) -> dict:
        entry = {"row": row, "done": threading.Event(), "result": None, "error": None}
        with self._lock:
            self._pending.append(entry)
        self._wake.set()
        entry["done"].wait()
        if entry["error"] is not None:
            raise entry["error"]
        return entry["result"]

    def _loop(self):
        while not self._stop:
            self._wake.wait(timeout=0.1)
            self._wake.clear()
            if self._stop:
                return
            time.sleep(self._window_s)  # let concurrent requests pile up
            with self._lock:
                batch, self._pending = (
                    self._pending[: self._max_rows],
                    self._pending[self._max_rows:],
                )
                if self._pending:
                    self._wake.set()  # more waiting: run again immediately
            if not batch:
                continue
            try:
                results = self._run_batch([e["row"] for e in batch])
                for entry, result in zip(batch, results):
                    entry["result"] = result
                    entry["done"].set()
            except Exception as exc:  # surface to every waiter
                for entry in batch:
                    entry["error"] = exc
                    entry["done"].set()

    def shutdown(self):
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=5)


class _HTTPServer(ThreadingHTTPServer):
    # listen backlog: the stdlib's 5 resets connections when a burst of
    # concurrent clients arrives at once
    request_queue_size = 128


class RecommenderHTTPServer:
    """stdlib ThreadingHTTPServer wired to a ServingEngine."""

    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1", port: int = 0):
        self.engine = engine
        self._coalescer = _Coalescer(self._run_retrieve_rows, engine.batch_size)
        handler = _make_handler(engine, self._coalescer)
        self.httpd = _HTTPServer((host, port), handler)
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def _run_retrieve_rows(self, rows: List[dict]) -> List[dict]:
        seqs = [r["sequence"] for r in rows]
        tss = [r.get("timestamps") for r in rows]
        ids, scores = self.engine.retrieve(seqs, tss)
        out = []
        for i, row in enumerate(rows):
            k = row.get("k")
            ids_i, sc_i = ids[i], scores[i]
            if k is not None:
                k = max(1, min(int(k), len(ids_i)))
                ids_i, sc_i = ids_i[:k], sc_i[:k]
            out.append({"ids": ids_i, "scores": sc_i})
        return out

    def start(self) -> "RecommenderHTTPServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._coalescer.shutdown()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def serve_forever(self):
        self.httpd.serve_forever()


def _make_handler(engine: ServingEngine, coalescer: _Coalescer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self) -> dict:
            length = int(self.headers.get("Content-Length", 0))
            if length == 0:
                return {}
            return json.loads(self.rfile.read(length))

        def do_GET(self):
            if self.path == "/healthz":
                self._send(
                    200,
                    {
                        "status": "ok",
                        "batch_size": engine.batch_size,
                        "max_sequence_length": engine.max_len,
                        "catalog_size": int(engine.all_item_ids.shape[0]),
                        "device": str(engine.device),
                    },
                )
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                req = self._read_json()
                if self.path == "/v1/retrieve":
                    seqs = req.get("sequences")
                    if isinstance(seqs, list) and len(seqs) == 1:
                        # single-row requests ride the coalescer so many
                        # concurrent clients share one engine call
                        row = {"sequence": seqs[0], "k": req.get("k")}
                        if req.get("timestamps"):
                            row["timestamps"] = req["timestamps"][0]
                        result = coalescer.submit(row)
                        self._send(
                            200,
                            {"ids": [result["ids"]], "scores": [result["scores"]]},
                        )
                        return
                    ids, scores = engine.retrieve(
                        seqs, req.get("timestamps"), k=req.get("k")
                    )
                    self._send(200, {"ids": ids, "scores": scores})
                elif self.path == "/v1/generate":
                    engine.generate()
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})
            except NotImplementedError as exc:
                self._send(501, {"error": str(exc)})
            except (ValueError, TypeError, KeyError) as exc:
                self._send(400, {"error": str(exc)})
            except Exception as exc:  # the server keeps answering
                self._send(500, {"error": f"{type(exc).__name__}: {exc}"})

    return Handler
