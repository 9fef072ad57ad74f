"""Online serving: batch retrieval and generation behind a small stdlib HTTP
service.

Port of mygenerativerecommenders_tpu/serving/service.py. The engine pads
every request to a fixed serving batch and the model's max length (keeping
the most recent items) and keeps the candidate matrix resident on its
device. Its programs are the retrieval eval step and one generation program
per (mode, steps, num_beams) (models/decode.py). With index.quantize=int8
retrieval pre-ranks on the int8 rows and re-scores on the exact ones, and
generation decodes against the exact rows, as the JAX engine does. A
sharded model (`embedding.kind=sharded_*`) is served with the sharded index
(`index.sharded`, train/task_retrieval.py), as the JAX engine serves it when
given a mesh; it generates where the padded catalog is the catalog (X a
multiple of the shards) and raises where the JAX engine cannot decode. On
the card each program is one CUDA graph, captured at its first call and
replayed after
(train/graphs.py, one graph per static shape: the counterpart of the JAX
engine's `jax.jit`); on the CPU, or with `graphs=False`, it runs eagerly. A
coalescer groups concurrent single-row retrieve requests into one engine
call; generation is not coalesced, as in JAX.

Every engine call runs under one lock and `torch.no_grad()`, around the
copies in, the run or replay and the read-back: multi-row requests call the
engine straight from handler threads, and the lock keeps the calls, the
graphs' static buffers and the kernels' launch counts one call at a time.
(Not `torch.inference_mode()`: a graph's buffers outlive the call, and an
inference tensor cannot be written in place outside that mode.)

Endpoints (JSON over HTTP):
  GET  /healthz                      -> {"status": "ok", ...}
  POST /v1/retrieve  {"sequences": [[id,...],...],
                      "timestamps": [[t,...],...]?, "k": int?}
                                     -> {"ids": [[...]], "scores": [[...]]}
  POST /v1/generate  {"sequences": ..., "timestamps": ...?, "steps": int,
                      "mode": "greedy"|"sample"|"beam",
                      "temperature"/"top_k"/"top_p"/"num_beams"?, "seed"?}
                                     -> {"ids": [[...]]}
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mygenerativerecommenders_tpu_torch.configs import Config
from mygenerativerecommenders_tpu_torch.models import decode
from mygenerativerecommenders_tpu_torch.models.model import GenerativeRecommender
from mygenerativerecommenders_tpu_torch.train.graphs import WARMUP_RUNS, StepGraphs
from mygenerativerecommenders_tpu_torch.train.task_retrieval import (
    Candidates,
    candidate_inputs,
    candidates_from,
    make_candidate_fn,
    make_eval_step,
)
from mygenerativerecommenders_tpu_torch.utils.features import seq_features_from_batch

GENERATION_MODES = ("greedy", "sample", "beam")
_CANDIDATES = "candidates"  # the exact rows, candidate_inputs' first entry
# the loader-batch columns of a packed request, as the programs read them
_BATCH_KEYS = (
    "lengths", "ids", "ratings", "timestamps", "target_id", "target_rating", "target_timestamp",
)

Body = Callable[[Dict[str, torch.Tensor]], Tuple[torch.Tensor, ...]]


def _gumbel_(out: torch.Tensor, seed: int) -> torch.Tensor:
    """Fill `out` with standard Gumbel noise from a generator on its device
    seeded with `seed`: -log(-log(u)), u uniform in [tiny, 1) as JAX draws it."""
    gen = torch.Generator(device=out.device).manual_seed(seed)
    out.uniform_(generator=gen).clamp_(min=torch.finfo(out.dtype).tiny)
    return out.log_().neg_().log_().neg_()


class ServingEngine:
    """Model + candidate matrix + the serving programs, at a static batch shape.

    `graphs` (on a cuda device; the CPU is always eager) runs every program
    as a CUDA graph replay; `graphs=False` keeps the eager form on the card,
    the reference the graphed one is held to."""

    def __init__(
        self,
        model: GenerativeRecommender,
        cfg: Config,
        all_item_ids: np.ndarray,
        max_item_id: int,
        batch_size: int = 32,
        device: Union[str, torch.device] = "cuda",
        graphs: bool = True,
    ):
        if cfg.model.task != "retrieval":
            # the JAX engine checks no task: it answers a ranking model's
            # requests with the retrieval eval step's top-k over the item
            # table, which is not what such a model was trained to give
            raise ValueError(
                f"serving takes model.task=retrieval, got model.task={cfg.model.task}: the "
                "server answers retrieval requests (top-k item ids), and a ranking model "
                "scores ratings, which no endpoint serves")
        if cfg.model.preprocessor.kind == "learnable_positional_aux":
            # a request carries ids and timestamps only (as the JAX engine
            # reads them, :104-125), not the user columns the aux token needs
            raise ValueError(
                "serving takes no model.preprocessor.kind=learnable_positional_aux: a "
                "request carries item ids and timestamps, not the user-feature columns "
                f"{list(cfg.model.preprocessor.auxiliary_columns)} its first token encodes"
            )
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.batch_size = int(batch_size)
        self.max_len = int(cfg.data.max_sequence_length)
        self.all_item_ids = np.asarray(all_item_ids, dtype=np.int32)
        self.max_item_id = int(max_item_id)
        self.graphed = bool(graphs) and self.device.type == "cuda"
        self.calls = 0  # engine calls so far (each runs the model once)
        self._lock = threading.Lock()
        self._catalog = torch.as_tensor(self.all_item_ids.astype(np.int64), device=self.device)
        self._eval_step = make_eval_step(self.model, cfg, self.all_item_ids, max_item_id)
        self._candidate_fn = make_candidate_fn(self.model, cfg, self.all_item_ids)
        # program key -> its body, or its StepGraphs when graphed
        self._programs: Dict[Hashable, Union[Body, StepGraphs]] = {}
        self.candidates: Optional[Candidates] = None
        self.refresh_candidates()

    def refresh_candidates(self) -> None:
        """Rebuild the device-resident candidates from current weights, in
        place: every graph reads them as the buffers it captured (the exact
        rows, and with index.quantize=int8 the int8 rows and their scales)."""
        with self._lock, torch.no_grad():
            fresh = self._candidate_fn()
            if self.candidates is None:
                self.candidates = fresh
            else:
                fresh = candidate_inputs(fresh)
                for name, t in candidate_inputs(self.candidates).items():
                    t.copy_(fresh[name])

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
        }
        return batch, n_real

    def _call(
        self, key: Hashable, make_body: Callable[[], Body], arrays: Dict[str, np.ndarray],
        noise: Optional[Tuple[Sequence[int], int]] = None,
    ) -> List[np.ndarray]:
        """One engine call of the program `key` (`make_body()` builds it at
        its first call): eagerly, or as one replay of its CUDA graph. The
        candidates are bound; `noise` = (shape, seed) binds a Gumbel draw too,
        made outside the graph into its buffer. -> the outputs on the host."""
        inputs = {name: torch.from_numpy(a).to(self.device) for name, a in arrays.items()}
        with self._lock, torch.no_grad():
            program = self._programs.get(key)
            if program is None:
                program = make_body()
                if self.graphed:
                    program = StepGraphs(program, "serve")
                self._programs[key] = program
            bound = dict(candidate_inputs(self.candidates))
            if noise is not None:
                shape, seed = noise
                if self.graphed:
                    out = program.buffer("gumbel", shape, torch.float32, self.device)
                else:
                    out = torch.empty(tuple(shape), dtype=torch.float32, device=self.device)
                bound["gumbel"] = _gumbel_(out, seed)
            if self.graphed:
                captured = len(program)
                outs = program(inputs, bound=bound)
                # a capture's warm-up runs are calls too: each launches what one call does
                self.calls += 1 + WARMUP_RUNS * (len(program) - captured)
            else:
                outs = program({**inputs, **bound})
                self.calls += 1
            return [o.cpu().numpy() for o in outs]

    def _retrieve_body(self) -> Body:
        eval_step = self._eval_step

        def body(inputs: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
            return tuple(eval_step({k: inputs[k] for k in _BATCH_KEYS}, candidates_from(inputs)))

        return body

    def retrieve(
        self,
        sequences: Sequence[Sequence[int]],
        timestamps: Optional[Sequence[Sequence[int]]] = None,
        k: Optional[int] = None,
    ) -> Tuple[List[List[int]], List[List[float]]]:
        """Top-k next-item retrieval for raw id sequences."""
        batch, n_real = self._pack(sequences, timestamps)
        top_ids, top_scores = self._call(("retrieve",), self._retrieve_body, batch)
        top_ids, top_scores = top_ids[:n_real], top_scores[:n_real]
        if k is not None:
            k = max(1, min(int(k), top_ids.shape[1]))
            top_ids, top_scores = top_ids[:, :k], top_scores[:, :k]
        return top_ids.tolist(), [[float(s) for s in row] for row in top_scores.tolist()]

    def _generate_body(self, mode: str, steps: int, num_beams: int = 0) -> Body:
        model, catalog, max_id = self.model, self._catalog, self.max_item_id
        max_out = self.cfg.model.gr_output_length + 1

        def body(inputs: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
            seq, _, _ = seq_features_from_batch({k: inputs[k] for k in _BATCH_KEYS}, max_out)
            cands = inputs[_CANDIDATES]
            if mode == "greedy":
                return (decode.greedy_generate(model, seq, cands, catalog, steps, max_id),)
            if mode == "sample":
                return (decode.sample_generate(
                    model, seq, cands, catalog, steps, max_id, inputs["gumbel"],
                    inputs["temperature"], inputs["top_k"], inputs["top_p"],
                ),)
            return (decode.beam_generate(model, seq, cands, catalog, steps, max_id, num_beams)[0],)

        return body

    def generate(
        self,
        sequences: Sequence[Sequence[int]],
        timestamps: Optional[Sequence[Sequence[int]]] = None,
        steps: int = 1,
        mode: str = "greedy",
        seed: int = 0,
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 0.0,
        num_beams: int = 4,
    ) -> List[List[int]]:
        """Autoregressive multi-step generation (greedy, sample or beam).

        One program per (mode, steps) and, for beam, num_beams: the sampling
        knobs are inputs of the sample program, not part of its key. An
        unknown keyword raises a TypeError (JAX's engine ignores it)."""
        steps = int(steps)
        if not 1 <= steps <= self.cfg.model.gr_output_length + 1:
            raise ValueError(
                f"steps {steps} outside [1, {self.cfg.model.gr_output_length + 1}]"
                " (the model's generative output window)"
            )
        if mode not in GENERATION_MODES:
            raise ValueError(
                f"unknown generation mode {mode!r}; expected greedy | sample | beam"
            )
        decode.check_decodable(self.cfg.model)
        rows = candidate_inputs(self.candidates)[_CANDIDATES].shape[0]
        if rows != len(self.all_item_ids):
            # the sharded index pads the catalog to a multiple of the shards;
            # the JAX engine decodes against those rows with the catalog's
            # own ids, whose shapes then disagree (ROADMAP.md queue 3)
            raise ValueError(
                f"generation with model.index.sharded on: the sharded index holds {rows} "
                f"rows for {len(self.all_item_ids)} catalog ids (not a multiple of "
                f"model.embedding.num_shards={self.cfg.model.embedding.num_shards}), which "
                "the reference cannot decode against; set model.index.sharded=false to "
                "generate"
            )
        batch, n_real = self._pack(sequences, timestamps)
        noise = None
        if mode == "sample":
            seed, top_k = int(seed), int(top_k)
            if not 0 <= seed < 2**63:
                raise ValueError(f"seed {seed} outside [0, 2**63)")
            if top_k < 0:
                raise ValueError(f"top_k {top_k} < 0")
            batch["temperature"] = np.asarray(temperature, dtype=np.float32)
            batch["top_k"] = np.asarray(top_k, dtype=np.int64)
            batch["top_p"] = np.asarray(top_p, dtype=np.float32)
            noise = ((steps, self.batch_size, len(self.all_item_ids)), seed)
            key: Tuple = ("sample", steps)
        elif mode == "beam":
            num_beams = int(num_beams)
            if not 1 <= num_beams <= len(self.all_item_ids):
                raise ValueError(f"num_beams {num_beams} outside [1, catalog size]")
            key = ("beam", steps, num_beams)
        else:
            key = ("greedy", steps)
        (ids,) = self._call(key, lambda: self._generate_body(*key), batch, noise)
        return ids[:n_real].tolist()


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
                    # unknown keys pass through as keywords, as in JAX
                    known = {"sequences", "timestamps", "steps", "mode", "seed"}
                    kw = {key: value for key, value in req.items() if key not in known}
                    ids = engine.generate(
                        req.get("sequences"),
                        req.get("timestamps"),
                        steps=req.get("steps", 1),
                        mode=req.get("mode", "greedy"),
                        seed=req.get("seed", 0),
                        **kw,
                    )
                    self._send(200, {"ids": ids})
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})
            except NotImplementedError as exc:
                self._send(501, {"error": str(exc)})
            except (ValueError, TypeError, KeyError) as exc:
                self._send(400, {"error": str(exc)})
            except Exception as exc:  # the server keeps answering
                self._send(500, {"error": f"{type(exc).__name__}: {exc}"})

    return Handler
