"""The PyTorch port's generation (models/decode.py and the engine's
`generate`) against the JAX package's models/decode.py on the CPU, with the
JAX weights carried over by `params_to_state_dict`.

The JAX side runs its jnp attention (`encoder.use_pallas=false`), as
tests/test_decode.py runs it; the port's prefill runs the attention
wrapper's plain version. Every case runs at one head and at two heads with
dqk 8 and dv 12 (tests/test_decode.py:50-57). Tolerance rtol 2e-4 / atol
2e-5, the kernel tests': fp32 sums in another order. Ids must be equal
exactly, so each generation test first replays the JAX function step by
step and asserts that every pick wins by more than that tolerance (a near
tie could flip under a last-bit difference and would prove nothing).
"""

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.configs import Config as JaxConfig
from mygenerativerecommenders_tpu.configs import resolve as jax_resolve
from mygenerativerecommenders_tpu.models import decode as jdecode
from mygenerativerecommenders_tpu.models.model import build_model as jax_build_model
from mygenerativerecommenders_tpu.models.postprocessors import l2_normalize as jax_l2
from mygenerativerecommenders_tpu.ops.sequence import get_current_embeddings as jax_current
from mygenerativerecommenders_tpu.ops.sequence import scatter_at_lengths as jax_scatter
from mygenerativerecommenders_tpu.ops.topk import masked_mips_scores as jax_scores
from mygenerativerecommenders_tpu.utils.features import (
    seq_features_from_batch as jax_seq_features,
)
from mygenerativerecommenders_tpu_torch.checkpoint import params_to_state_dict
from mygenerativerecommenders_tpu_torch.configs import Config as PtConfig
from mygenerativerecommenders_tpu_torch.configs import apply_overrides as pt_overrides
from mygenerativerecommenders_tpu_torch.configs import resolve as pt_resolve
from mygenerativerecommenders_tpu_torch.models import decode
from mygenerativerecommenders_tpu_torch.models.model import build_model as pt_build_model
from mygenerativerecommenders_tpu_torch.ops.sequence import scatter_at_lengths
from mygenerativerecommenders_tpu_torch.serving import service
from mygenerativerecommenders_tpu_torch.serving.service import (
    RecommenderHTTPServer,
    ServingEngine,
)
from mygenerativerecommenders_tpu_torch.utils.features import (
    seq_features_from_batch as pt_seq_features,
)
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL, ATOL = 2e-4, 2e-5
MAX_ID = 80  # catalog ids 1..80
L, B = 20, 3  # data.max_sequence_length and rows; N = L + 11
STEPS = 11  # gr_output_length + 1: the whole output window
HEADS = pytest.mark.parametrize(
    "heads,dqk,dv", [(1, 0, 0), (2, 8, 12)], ids=["h1", "h2-dqk8-dv12"]
)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _setup(heads, dqk, dv, seed=0):
    """JAX model + params, the port's model with the same weights, one batch
    as both packages' SequenceBatch, and the normalized catalog."""
    jcfg = JaxConfig()
    jcfg.data.max_sequence_length = L
    jcfg.model.item_embedding_dim = 16
    jcfg.model.encoder.num_heads = heads
    jcfg.model.encoder.attention_dim = dqk
    jcfg.model.encoder.linear_dim = dv
    jcfg.model.encoder.use_pallas = "false"
    jax_resolve(jcfg, MAX_ID)
    pcfg = PtConfig()
    pt_overrides(pcfg, [
        f"data.max_sequence_length={L}", "model.item_embedding_dim=16",
        f"model.encoder.num_heads={heads}", f"model.encoder.attention_dim={dqk}",
        f"model.encoder.linear_dim={dv}",
    ])
    pt_resolve(pcfg, MAX_ID)

    rng = np.random.default_rng(seed)
    lengths = np.array([2, 9, L], dtype=np.int32)
    ids = np.zeros((B, L), dtype=np.int32)
    ts = np.zeros((B, L), dtype=np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.choice(np.arange(1, MAX_ID + 1), size=n, replace=False)
        ts[i, :n] = np.sort(978_000_000 + rng.integers(0, 10**7, size=n))
    batch = {
        "lengths": lengths, "ids": ids, "timestamps": ts,
        "ratings": np.zeros((B, L), dtype=np.int32),
        "target_id": np.zeros(B, dtype=np.int32),
        "target_rating": np.zeros(B, dtype=np.int32),
        "target_timestamp": (ts.max(axis=1) + 1).astype(np.int32),
    }
    max_out = jcfg.model.gr_output_length + 1
    jseq, _, _ = jax_seq_features(batch, max_out)
    jmodel = jax_build_model(jcfg)
    key = jax.random.PRNGKey(seed)
    params = jmodel.init({"params": key, "dropout": key}, jseq, method=jmodel.init_all)
    pmodel = pt_build_model(pcfg, device="cpu")
    pmodel.load_state_dict(params_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    pseq, _, _ = pt_seq_features({k: _t(v) for k, v in batch.items()}, max_out)
    cat_ids = jnp.arange(1, MAX_ID + 1, dtype=jnp.int32)
    cands = _np(jax_l2(jmodel.apply(params, cat_ids, method=jmodel.item_embeddings)))
    return dict(
        jcfg=jcfg, pcfg=pcfg, jmodel=jmodel, params=params, pmodel=pmodel, batch=batch,
        jseq=jseq, pseq=pseq, cands=cands, cat_ids=_np(cat_ids),
    )


def _assert_margin(sorted_desc, ranks, what, rtol=RTOL):
    """Each of the first `ranks` values of every row of a descending array
    is apart from the next by more than the tolerance."""
    s = np.asarray(sorted_desc, np.float64)[:, : ranks + 1]
    gap = s[:, :-1] - s[:, 1:]
    need = ATOL + rtol * np.abs(s[:, :-1])
    assert (gap > need).all(), f"{what}: a near tie, gaps {gap.min()} (need {need.max()})"


def _cache_np(cache):
    return [np.asarray(x) for x in cache]


@HEADS
def test_prefill_matches_jax(heads, dqk, dv):
    s = _setup(heads, dqk, dv)
    want_enc, want = jdecode.prefill(s["jmodel"], s["params"], s["jseq"])
    with torch.no_grad():
        got_enc, got = decode.prefill(s["pmodel"], s["pseq"])
    np.testing.assert_allclose(got_enc.numpy(), _np(want_enc), rtol=RTOL, atol=ATOL)
    for name, g, w in zip(decode.DecodeCache._fields, got, _cache_np(want)):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=name)
    # padded positions hold exactly zero keys and values in both
    pad = ~(np.arange(L + 11)[None, :] < s["batch"]["lengths"][:, None])
    assert not got.k.numpy()[:, pad].any() and not got.v.numpy()[:, pad].any()


@HEADS
def test_decode_step_matches_jax(heads, dqk, dv):
    s = _setup(heads, dqk, dv)
    _, jcache = jdecode.prefill(s["jmodel"], s["params"], s["jseq"])
    rng = np.random.default_rng(5)
    new_ids = rng.integers(1, MAX_ID + 1, size=B).astype(np.int32)
    new_ts = (s["batch"]["timestamps"].max(axis=1) + 600).astype(np.int32)
    want_out, want = jdecode.decode_step(
        s["jmodel"], s["params"], jcache, jnp.asarray(new_ids), jnp.asarray(new_ts)
    )
    # the same cache in: the step alone is compared
    cache = decode.DecodeCache(*(_t(x) for x in _cache_np(jcache)))
    with torch.no_grad():
        got_out, got = decode.decode_step(s["pmodel"], cache, _t(new_ids), _t(new_ts))
    np.testing.assert_allclose(got_out.numpy(), _np(want_out), rtol=RTOL, atol=ATOL)
    for name, g, w in zip(decode.DecodeCache._fields, got, _cache_np(want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=name)


@HEADS
def test_decode_step_matches_own_full_forward(heads, dqk, dv):
    """Appending a token by the cache = the port's forward on the extended
    row (the property of tests/test_decode.py:58-96)."""
    s = _setup(heads, dqk, dv)
    seq, pmodel = s["pseq"], s["pmodel"]
    rng = np.random.default_rng(6)
    new_ids = _t(rng.integers(1, MAX_ID + 1, size=B).astype(np.int32))
    new_ts = _t((s["batch"]["timestamps"].max(axis=1) + 100).astype(np.int32))
    ts = seq.past_payloads["timestamps"]
    ext_ts = scatter_at_lengths(ts, seq.past_lengths, new_ts)
    # the step reads the token's own timestamp as its "next" one: mirror it
    ext_ts = scatter_at_lengths(ext_ts, seq.past_lengths + 1, new_ts)
    ext = seq._replace(
        past_ids=scatter_at_lengths(seq.past_ids, seq.past_lengths, new_ids),
        past_lengths=seq.past_lengths + 1,
        past_payloads={**seq.past_payloads, "timestamps": ext_ts},
    )
    with torch.no_grad():
        full, _ = pmodel(ext)
        _, cache = decode.prefill(pmodel, seq._replace(
            past_payloads={**seq.past_payloads, "timestamps": ext_ts}))
        out, cache2 = decode.decode_step(pmodel, cache, new_ids, new_ts)
    want = full[torch.arange(B), seq.past_lengths.long()]
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(cache2.lengths.numpy(), seq.past_lengths.numpy() + 1)


def _jax_greedy_replay(s, steps):
    """JAX's greedy_generate step by step, asserting each pick's margin."""
    jmodel, params, seq = s["jmodel"], s["params"], s["jseq"]
    encoded, cache = jdecode.prefill(jmodel, params, seq)
    query = jax_current(cache.lengths, encoded)
    invalid, out = seq.past_ids, []
    for step in range(steps):
        scores = _np(jax_scores(query, s["cands"], s["cat_ids"], invalid, MAX_ID))
        _assert_margin(-np.sort(-scores, axis=1), 1, f"greedy step {step}")
        nxt = jnp.asarray(s["cat_ids"][scores.argmax(axis=1)])
        out.append(_np(nxt))
        invalid = jax_scatter(invalid, cache.lengths, nxt)
        query, cache = jdecode.decode_step(
            jmodel, params, cache, nxt, jdecode._last_timestamps(cache)
        )
    return np.stack(out, axis=1)


@HEADS
def test_greedy_generate_matches_jax(heads, dqk, dv):
    s = _setup(heads, dqk, dv)
    want = _np(jdecode.greedy_generate(
        s["jmodel"], s["params"], s["jseq"], s["cands"], s["cat_ids"], STEPS, MAX_ID
    ))
    np.testing.assert_array_equal(_jax_greedy_replay(s, STEPS), want)
    with torch.no_grad():
        got = decode.greedy_generate(
            s["pmodel"], s["pseq"], _t(s["cands"]), _t(s["cat_ids"]), STEPS, MAX_ID
        )
    np.testing.assert_array_equal(got.numpy(), want)
    for i, n in enumerate(s["batch"]["lengths"]):  # no repeats of the history or itself
        row = got[i].tolist()
        assert len(set(row)) == STEPS and not set(row) & set(s["batch"]["ids"][i, :n].tolist())


def _jax_beam_replay(s, steps, w):
    """JAX's beam_generate step by step, asserting that the W best totals of
    every step (and the next one) are apart by more than atol. A total's error
    does not grow with its size (-40 after 11 steps): both packages add the
    same per-step log-probabilities in the same order, and the test holds
    the final totals to within atol / 2 of JAX's."""
    jmodel, params, seq = s["jmodel"], s["params"], s["jseq"]
    x = s["cands"].shape[0]
    encoded, cache = jdecode.prefill(jmodel, params, seq)
    query = jax_current(cache.lengths, encoded)
    logp = jax.nn.log_softmax(jax_scores(query, s["cands"], s["cat_ids"], seq.past_ids, MAX_ID))
    order = -np.sort(-_np(logp), axis=1)
    _assert_margin(order, w, "beam step 0", rtol=0.0)
    beam_logp, first = jax.lax.top_k(logp, w)
    tile = lambda a, axis: jnp.repeat(a, w, axis=axis)  # noqa: E731
    cache = jdecode.DecodeCache(tile(cache.k, 1), tile(cache.v, 1), tile(cache.lengths, 0),
                                tile(cache.timestamps, 0))
    flat = jnp.take(s["cat_ids"], first).reshape(-1)
    invalid = jax_scatter(tile(seq.past_ids, 0), cache.lengths, flat)
    generated = flat[:, None]
    query, cache = jdecode.decode_step(jmodel, params, cache, flat, jdecode._last_timestamps(cache))
    rows = jnp.arange(B)[:, None]
    for step in range(1, steps):
        logp = jax.nn.log_softmax(jax_scores(query, s["cands"], s["cat_ids"], invalid, MAX_ID))
        total = (beam_logp.reshape(-1, 1) + logp).reshape(B, w * x)
        _assert_margin(-np.sort(-_np(total), axis=1), w, f"beam step {step}", rtol=0.0)
        beam_logp, idx = jax.lax.top_k(total, w)
        sel = (rows * w + idx // x).reshape(-1)
        cache = jdecode.DecodeCache(*(jnp.take(a, sel, axis=ax) for a, ax in
                                      zip(cache, (1, 1, 0, 0))))
        invalid, generated = jnp.take(invalid, sel, axis=0), jnp.take(generated, sel, axis=0)
        flat = jnp.take(s["cat_ids"], idx % x).reshape(-1)
        invalid = jax_scatter(invalid, cache.lengths, flat)
        generated = jnp.concatenate([generated, flat[:, None]], axis=1)
        query, cache = jdecode.decode_step(
            jmodel, params, cache, flat, jdecode._last_timestamps(cache)
        )
    return _np(generated.reshape(B, w, -1)[:, 0])


@HEADS
def test_beam_generate_matches_jax(heads, dqk, dv):
    s = _setup(heads, dqk, dv)
    w = 3
    want_ids, want_score = jdecode.beam_generate(
        s["jmodel"], s["params"], s["jseq"], s["cands"], s["cat_ids"], STEPS, MAX_ID, w
    )
    np.testing.assert_array_equal(_jax_beam_replay(s, STEPS, w), _np(want_ids))
    with torch.no_grad():
        got_ids, got_score = decode.beam_generate(
            s["pmodel"], s["pseq"], _t(s["cands"]), _t(s["cat_ids"]), STEPS, MAX_ID, w
        )
    np.testing.assert_array_equal(got_ids.numpy(), _np(want_ids))
    np.testing.assert_allclose(got_score.numpy(), _np(want_score), rtol=RTOL, atol=ATOL)
    assert np.abs(got_score.numpy() - _np(want_score)).max() <= ATOL / 2


def _jax_sample_replay(s, steps, rng, temperature, top_k, top_p):
    """JAX's sample_generate step by step with its own draws (as
    `jax.random.categorical`: argmax(logits + gumbel)), asserting that the
    draw and the k-th logit are clear of near ties (and that the port
    truncates JAX's logits to JAX's nucleus).
    -> (ids [B, steps], the Gumbel draws [steps, B, X])."""
    jmodel, params, seq = s["jmodel"], s["params"], s["jseq"]
    x = s["cands"].shape[0]
    encoded, cache = jdecode.prefill(jmodel, params, seq)
    query = jax_current(cache.lengths, encoded)
    invalid, out, draws = seq.past_ids, [], []
    for step in range(steps):
        logits = _np(jax_scores(query, s["cands"], s["cat_ids"], invalid, MAX_ID))
        logits = logits / max(temperature, 1e-6)
        if top_k and top_k < x:
            _assert_margin(-np.sort(-logits, axis=1)[:, top_k - 1:], 1, f"top-k step {step}")
            kth = np.sort(logits, axis=1)[:, -top_k][:, None]
            logits = np.where(logits < kth, -np.inf, logits)
        if top_p and 0.0 < top_p < 1.0:
            before = logits
            srt = -np.sort(-logits, axis=1)
            cum = np.cumsum(_np(jax.nn.softmax(jnp.asarray(srt), axis=-1)), axis=-1)
            keep = np.concatenate([np.ones_like(cum[:, :1], bool), cum[:, :-1] < top_p], axis=1)
            cutoff = np.min(np.where(keep, srt, np.inf), axis=1, keepdims=True)
            logits = np.where(logits < cutoff, -np.inf, logits)
            # the nucleus' edge may sit within float32 rounding of top_p (a
            # flat softmax: |scores| <= 1): the port's truncation of the same
            # logits must keep exactly JAX's set
            got = decode.truncate_logits(_t(before), top_k, top_p).numpy()
            np.testing.assert_array_equal(np.isinf(got), np.isinf(logits), f"top-p step {step}")
        rng, sub = jax.random.split(rng)
        g = _np(jax.random.gumbel(sub, (B, x)))
        draws.append(g)
        _assert_margin(-np.sort(-(logits + g), axis=1), 1, f"sample step {step}")
        nxt = jnp.asarray(s["cat_ids"][np.argmax(logits + g, axis=1)])
        out.append(_np(nxt))
        invalid = jax_scatter(invalid, cache.lengths, nxt)
        query, cache = jdecode.decode_step(
            jmodel, params, cache, nxt, jdecode._last_timestamps(cache)
        )
    return np.stack(out, axis=1), np.stack(draws)


@HEADS
@pytest.mark.parametrize(
    "temperature,top_k,top_p", [(1.0, 0, 0.0), (0.7, 5, 0.0), (1.0, 0, 0.9)],
    ids=["t1", "t0.7-k5", "p0.9"],
)
def test_sample_generate_with_jax_draws_matches_jax(heads, dqk, dv, temperature, top_k, top_p):
    s = _setup(heads, dqk, dv)
    rng = jax.random.PRNGKey(3)
    want = _np(jdecode.sample_generate(
        s["jmodel"], s["params"], s["jseq"], s["cands"], s["cat_ids"], STEPS, MAX_ID, rng,
        temperature=temperature, top_k=top_k, top_p=top_p,
    ))
    replay, draws = _jax_sample_replay(s, STEPS, rng, temperature, top_k, top_p)
    np.testing.assert_array_equal(replay, want)
    with torch.no_grad():
        got = decode.sample_generate(
            s["pmodel"], s["pseq"], _t(s["cands"]), _t(s["cat_ids"]), STEPS, MAX_ID,
            _t(draws), temperature=temperature, top_k=top_k, top_p=top_p,
        )
    np.testing.assert_array_equal(got.numpy(), want)


def _cpu_engine(s, batch_size=4):
    return ServingEngine(
        s["pmodel"], s["pcfg"], s["cat_ids"], MAX_ID, batch_size=batch_size, device="cpu"
    )


def test_engine_generate_matches_direct_calls():
    s = _setup(1, 0, 0)
    engine = _cpu_engine(s)
    seqs = [s["batch"]["ids"][i, :n].tolist() for i, n in enumerate(s["batch"]["lengths"])]
    stamps = [s["batch"]["timestamps"][i, :n].tolist() for i, n in enumerate(s["batch"]["lengths"])]
    packed, _ = engine._pack(seqs, stamps)
    seq, _, _ = pt_seq_features({k: _t(v) for k, v in packed.items()}, STEPS)
    cands, cat = engine.candidates, _t(s["cat_ids"]).long()
    x = len(s["cat_ids"])
    with torch.no_grad():
        noise = service._gumbel_(torch.empty(4, 4, x), seed=9)
        want = {
            "greedy": decode.greedy_generate(s["pmodel"], seq, cands, cat, 4, MAX_ID),
            "sample": decode.sample_generate(s["pmodel"], seq, cands, cat, 4, MAX_ID, noise,
                                             temperature=0.7, top_k=10, top_p=0.9),
            "beam": decode.beam_generate(s["pmodel"], seq, cands, cat, 4, MAX_ID, 2)[0],
        }
    calls = engine.calls
    kw = {"sample": dict(seed=9, temperature=0.7, top_k=10, top_p=0.9), "beam": dict(num_beams=2)}
    for mode, ids in want.items():
        got = engine.generate(seqs, stamps, steps=4, mode=mode, **kw.get(mode, {}))
        assert got == ids[:B].tolist(), mode
    assert engine.calls == calls + 3
    # the same seed draws the same ids; one program serves every temperature
    again = engine.generate(seqs, stamps, steps=4, mode="sample", **kw["sample"])
    assert again == want["sample"][:B].tolist()
    engine.generate(seqs, stamps, steps=4, mode="sample", seed=9, temperature=0.3)
    assert sorted(k for k in engine._programs if k[0] == "sample") == [("sample", 4)]


def test_engine_generate_rejects_bad_requests():
    engine = _cpu_engine(_setup(1, 0, 0))
    for bad in (dict(steps=0), dict(steps=STEPS + 1), dict(mode="nope"),
                dict(mode="beam", num_beams=0), dict(mode="sample", top_k=-1)):
        with pytest.raises(ValueError):
            engine.generate([[1, 2]], **bad)
    with pytest.raises(TypeError):
        engine.generate([[1, 2]], nope=1)


def _post(server, path, payload):
    req = urllib.request.Request(
        f"http://{server.host}:{server.port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_http_generate():
    engine = _cpu_engine(_setup(1, 0, 0))
    server = RecommenderHTTPServer(engine, "127.0.0.1", 0).start()
    try:
        seqs = [[1, 2, 3], [4, 5, 6, 7, 8]]
        for mode in ("greedy", "sample", "beam"):
            status, body = _post(server, "/v1/generate",
                                 {"sequences": seqs, "steps": 3, "mode": mode, "seed": 1})
            assert status == 200, body
            assert body["ids"] == engine.generate(seqs, steps=3, mode=mode, seed=1)
            assert all(len(row) == 3 and 1 <= min(row) and max(row) <= MAX_ID
                       for row in body["ids"])
        for bad in ({"steps": 0}, {"steps": STEPS + 1}, {"mode": "nope"}, {"nope": 1}):
            status, body = _post(server, "/v1/generate", {"sequences": seqs, **bad})
            assert status == 400 and "error" in body, bad
    finally:
        server.stop()


@pytest.mark.parametrize("override", [
    "model.encoder.concat_ua=true",
    "model.encoder.linear_activation=none",
    "model.encoder.enable_relative_attention_bias=false",
    "model.encoder.relative_bias_type=position",
    "model.encoder.num_time_buckets=64",
    "model.preprocessor.kind=learnable_positional_rated",
])
def test_knobs_the_decode_step_ignores_raise(override):
    cfg = PtConfig()
    pt_overrides(cfg, [f"data.max_sequence_length={L}", "model.item_embedding_dim=16", override])
    if override.startswith("model.preprocessor"):
        cfg.model.preprocessor.rating_embedding_dim = 4
    pt_resolve(cfg, MAX_ID)
    model = pt_build_model(cfg, device="cpu")
    knob = override.split("=")[0]
    with pytest.raises(ValueError, match=knob):
        decode.check_decodable(cfg.model)
    engine = ServingEngine(model, cfg, np.arange(1, MAX_ID + 1), MAX_ID, batch_size=2,
                           device="cpu")
    with pytest.raises(ValueError, match=knob):
        engine.generate([[1, 2]], steps=2)
