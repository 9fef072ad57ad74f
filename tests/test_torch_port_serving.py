"""The PyTorch port's serving path on the CPU: the engine against the JAX
`ServingEngine` with the same weights, the HTTP endpoints and the
coalescer, the CLI's `build_engine`, and the item catalog.

Top-k results are compared with `topk_agree`: scores rank by rank within
atol 1e-5 (L2-normalized fp32 dot products, |score| <= 1), ids wherever the
neighbouring scores are further apart than that.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.configs import Config as JaxConfig
from mygenerativerecommenders_tpu.configs import resolve as jax_resolve
from mygenerativerecommenders_tpu.configs.presets import get_preset as jax_get_preset
from mygenerativerecommenders_tpu.data.dataset import RecoData
from mygenerativerecommenders_tpu.models.model import build_model as jax_build_model
from mygenerativerecommenders_tpu.serving.service import ServingEngine as JaxEngine
from mygenerativerecommenders_tpu.utils.features import (
    seq_features_from_batch as jax_seq_features,
)
from mygenerativerecommenders_tpu_torch.checkpoint import params_to_state_dict
from mygenerativerecommenders_tpu_torch.cli.serve import build_engine
from mygenerativerecommenders_tpu_torch.cli.train import parse_args
from mygenerativerecommenders_tpu_torch.configs import Config as PtConfig
from mygenerativerecommenders_tpu_torch.configs import resolve as pt_resolve
from mygenerativerecommenders_tpu_torch.data.catalog import load_catalog
from mygenerativerecommenders_tpu_torch.models.model import build_model as pt_build_model
from mygenerativerecommenders_tpu_torch.ops.kernels import hstu_attention as pt_kernel
from mygenerativerecommenders_tpu_torch.ops.topk import topk_agree
from mygenerativerecommenders_tpu_torch.serving.service import (
    RecommenderHTTPServer,
    ServingEngine,
)
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

MAX_ID = 60
ATOL = 1e-5
SEQS = [[1, 2, 3], [4, 5, 6, 7], [9], list(range(10, 40)) * 2]


def _jax_engine():
    """Built as tests/test_serving.py builds it."""
    cfg = JaxConfig()
    cfg.data.max_sequence_length = 16
    cfg.model.item_embedding_dim = 16
    cfg.model.encoder.use_pallas = "false"
    cfg.model.index.k = 20
    jax_resolve(cfg, MAX_ID)
    model = jax_build_model(cfg)
    batch = {
        "lengths": np.array([3], dtype=np.int32),
        "ids": np.zeros((1, 16), dtype=np.int32),
        "ratings": np.zeros((1, 16), dtype=np.int32),
        "timestamps": np.zeros((1, 16), dtype=np.int32),
        "target_id": np.zeros(1, dtype=np.int32),
        "target_rating": np.zeros(1, dtype=np.int32),
        "target_timestamp": np.zeros(1, dtype=np.int32),
    }
    seq, _, _ = jax_seq_features(batch, cfg.model.gr_output_length + 1)
    key = jax.random.PRNGKey(0)
    params = model.init({"params": key, "dropout": key}, seq, method=model.init_all)
    all_ids = np.arange(1, MAX_ID + 1, dtype=np.int32)
    return JaxEngine(model, params, cfg, all_ids, MAX_ID, batch_size=4), params


@pytest.fixture(scope="module")
def engines():
    jax_engine, params = _jax_engine()
    cfg = PtConfig()
    cfg.data.max_sequence_length = 16
    cfg.model.item_embedding_dim = 16
    cfg.model.index.k = 20
    pt_resolve(cfg, MAX_ID)
    model = pt_build_model(cfg, device="cpu")
    model.load_state_dict(params_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    engine = ServingEngine(
        model, cfg, np.arange(1, MAX_ID + 1), MAX_ID, batch_size=4, device="cpu"
    )
    return jax_engine, engine


@pytest.fixture(scope="module")
def server(engines):
    srv = RecommenderHTTPServer(engines[1], "127.0.0.1", 0).start()
    yield srv
    srv.stop()


def _url(server, path):
    return f"http://{server.host}:{server.port}{path}"


def _post(server, path, payload):
    req = urllib.request.Request(
        _url(server, path), data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


@pytest.mark.parametrize("with_ts", [False, True])
def test_engine_matches_jax_engine(engines, with_ts):
    jax_engine, engine = engines
    rng = np.random.default_rng(7)
    ts = None
    if with_ts:  # ml-1m-era timestamps, one row per sequence
        ts = [np.sort(978_000_000 + rng.integers(0, 10**8, size=len(s))).tolist() for s in SEQS]
    want_ids, want_scores = jax_engine.retrieve(SEQS, ts)
    calls = engine.calls
    got_ids, got_scores = engine.retrieve(SEQS, ts)
    assert engine.calls == calls + 1
    problem = topk_agree(got_ids, got_scores, want_ids, want_scores, ATOL)
    assert problem is None, problem
    for seq, row in zip(SEQS, got_ids):
        # k = 20 of 60; the 16 most recent items (max_sequence_length) are filtered
        assert len(row) == 20 and not set(seq[-16:]) & set(row)


def test_engine_rejects_bad_requests(engines):
    engine = engines[1]
    with pytest.raises(ValueError):
        engine.retrieve([])
    with pytest.raises(ValueError):
        engine.retrieve([[]])
    with pytest.raises(ValueError):
        engine.retrieve([[1, 2]] * 5)  # > batch_size
    with pytest.raises(ValueError):
        engine.retrieve([[1, 2]], timestamps=[[5]])
    with pytest.raises(ValueError, match="steps"):
        engine.generate([[1, 2]], steps=0)
    with pytest.raises(ValueError, match="mode"):
        engine.generate([[1, 2]], mode="nope")


def test_http_healthz_retrieve_and_errors(server, engines):
    with urllib.request.urlopen(_url(server, "/healthz"), timeout=60) as resp:
        body = json.loads(resp.read())
    assert resp.status == 200 and body["status"] == "ok"
    assert body["catalog_size"] == MAX_ID and body["device"] == "cpu"
    status, body = _post(server, "/v1/retrieve", {"sequences": [[1, 2, 3], [4, 5]], "k": 5})
    assert status == 200
    want_ids, want_scores = engines[1].retrieve([[1, 2, 3], [4, 5]], k=5)
    assert body["ids"] == want_ids
    np.testing.assert_allclose(body["scores"], want_scores, rtol=1e-6)
    status, body = _post(server, "/v1/generate", {"sequences": [[1, 2]], "steps": 2})
    assert status == 200 and body["ids"] == engines[1].generate([[1, 2]], steps=2)
    assert len(body["ids"][0]) == 2 and not {1, 2} & set(body["ids"][0])
    status, body = _post(server, "/v1/retrieve", {"sequences": []})
    assert status == 400 and "error" in body
    status, _ = _post(server, "/v1/nope", {})
    assert status == 404


def test_http_single_row_coalescing(server, engines):
    engine = engines[1]
    want, _ = engine.retrieve([[1, 2, 3]], k=4)
    results = [None] * 6
    calls = engine.calls

    def one(i):
        results[i] = _post(server, "/v1/retrieve", {"sequences": [[1, 2, 3]], "k": 4})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for status, body in results:
        assert status == 200 and body["ids"] == [want[0]]
    assert calls < engine.calls <= calls + 6  # six rows, at most six engine calls


def test_coalesced_row_keeps_its_timestamps(server, engines):
    """A timed row coalesced with an untimed one answers as it does alone."""
    engine = engines[1]
    timed = {"sequence": [1, 2, 3], "timestamps": [978_000_000, 978_086_400, 979_000_000]}
    got = server._run_retrieve_rows([timed, {"sequence": [4, 5]}])
    want_ids, want_scores = engine.retrieve([timed["sequence"]], [timed["timestamps"]])
    assert got[0]["ids"] == want_ids[0]
    np.testing.assert_allclose(got[0]["scores"], want_scores[0], rtol=1e-6)
    untimed_ids, _ = engine.retrieve([timed["sequence"]])
    assert untimed_ids[0] != want_ids[0]  # the timestamps do change the answer


def test_build_engine_from_pt_checkpoint(tmp_path):
    args = ["experiment=synthetic-smoke", f"data.data_dir={tmp_path}"]
    cfg = parse_args(args)
    ids, max_id = load_catalog(cfg.data)
    pt_resolve(cfg, max_id)
    model = pt_build_model(cfg, device="cpu", seed=3)
    torch.save(model.state_dict(), tmp_path / "model.pt")
    engine, opts = build_engine(
        args + [f"trainer.ckpt_path={tmp_path / 'model.pt'}", "serve.device=cpu",
                "serve.batch_size=8"]
    )
    assert opts["device"] == "cpu" and engine.batch_size == 8
    for key, val in model.state_dict().items():
        assert torch.equal(engine.model.state_dict()[key], val)
    launches = pt_kernel.launches
    got_ids, got_scores = engine.retrieve([[int(ids[0]), int(ids[5])], [int(ids[9])]])
    assert pt_kernel.launches == launches  # CPU: the plain version, no launch
    assert set(np.ravel(got_ids)) <= set(ids.tolist())
    assert all(len(row) == cfg.model.index.k for row in got_ids)
    assert np.isfinite(got_scores).all()
    with pytest.raises(ValueError, match="ckpt_path"):
        build_engine(args + ["serve.device=cpu"])
    with pytest.raises(ValueError, match="serve option"):
        build_engine(args + ["serve.nope=1"])


def test_catalog_matches_reco_data(tmp_path):
    jcfg = jax_get_preset("synthetic-smoke")
    jcfg.data.data_dir = str(tmp_path / "jax")
    data = RecoData(jcfg.data)  # writes the synthetic data and its movies.csv
    pcfg = parse_args(["experiment=synthetic-smoke", f"data.data_dir={tmp_path / 'fresh'}"])
    drawn_ids, drawn_max = load_catalog(pcfg.data)  # no files: the draw is redone
    pcfg.data.data_dir = jcfg.data.data_dir
    read_ids, read_max = load_catalog(pcfg.data)  # the processed movies.csv
    for ids, max_id in ((drawn_ids, drawn_max), (read_ids, read_max)):
        assert ids.tolist() == [int(x) for x in data.all_item_ids]
        assert max_id == data.max_item_id
