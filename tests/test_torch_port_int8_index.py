"""The int8 index (`index.quantize=int8`) of the PyTorch port against the JAX
package's ops/quantized_topk.py, its eval step and its serving engine, on the
CPU.

`quantize_rows` must give JAX's int8 rows and scales bit for bit (both round
half to even). The pre-ranking scores are then the same numbers (the int8
product is exact in both), so the top-k differs only where the exact
re-scoring's float32 sums, made in another order, change the order of two
near-equal scores: ids are held equal wherever the neighbouring scores are
further apart than 1e-5 and scores within 1e-5 (`topk_agree`; L2-normalized
rows, |score| <= 1). The eval step and the engine run the whole model
first, whose outputs agree at rtol 2e-4 / atol 2e-5, so there the same check
runs at the serving tests' atol 1e-5 on the final scores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.configs import Config as JaxConfig
from mygenerativerecommenders_tpu.configs import resolve as jax_resolve
from mygenerativerecommenders_tpu.models.model import build_model as jax_build_model
from mygenerativerecommenders_tpu.ops import quantized_topk as jax_q
from mygenerativerecommenders_tpu.serving.service import ServingEngine as JaxEngine
from mygenerativerecommenders_tpu.train import task_retrieval as jax_task
from mygenerativerecommenders_tpu.utils.features import seq_features_from_batch as jax_features
from mygenerativerecommenders_tpu_torch.checkpoint import params_to_state_dict
from mygenerativerecommenders_tpu_torch.configs import Config as PtConfig
from mygenerativerecommenders_tpu_torch.configs import resolve as pt_resolve
from mygenerativerecommenders_tpu_torch.models.model import build_model as pt_build_model
from mygenerativerecommenders_tpu_torch.ops import quantized_topk as pt_q
from mygenerativerecommenders_tpu_torch.ops.topk import NEG_INF, mips_top_k, topk_agree
from mygenerativerecommenders_tpu_torch.serving.service import ServingEngine
from mygenerativerecommenders_tpu_torch.train import task_retrieval as pt_task
from tests.test_torch_port_train_step import _np_tree, _setup, _torch_batch
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL = 1e-5


def _normed(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_quantize_rows_gives_jax_bits():
    rng = np.random.default_rng(0)
    emb = np.concatenate([
        _normed(rng, 300, 16),
        rng.normal(scale=3.0, size=(100, 16)).astype(np.float32),
        np.zeros((2, 16), dtype=np.float32),  # scale 1
        # e / s exactly k + 0.5 for s = 127 / 127: the ties round to even
        np.tile(np.asarray([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5], np.float32), (1, 2)),
    ])
    q, scales = pt_q.quantize_rows(torch.from_numpy(emb))
    jq, jscales = jax_q.quantize_rows(jnp.asarray(emb))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scales.numpy().view(np.int32), np.asarray(jscales).view(np.int32))
    np.testing.assert_array_equal(q[-1, :8].numpy(), [127, 0, 2, 2, 0, -2, -2, 4])


@pytest.mark.parametrize("keep_exact,filtered", [(True, False), (True, True), (False, True)])
def test_mips_top_k_int8_matches_jax(keep_exact, filtered):
    rng = np.random.default_rng(1)
    x, d, b, k, max_id = 3000, 16, 8, 20, 3500
    ids = np.sort(rng.choice(np.arange(1, max_id + 1), size=x, replace=False)).astype(np.int32)
    items, queries = _normed(rng, x, d), _normed(rng, b, d)
    invalid = rng.choice(ids, size=(b, 30)).astype(np.int32) if filtered else None
    invalid_pt = None if invalid is None else torch.from_numpy(invalid)
    cat = pt_q.quantize_catalog(torch.from_numpy(items), keep_exact=keep_exact)
    got = pt_q.mips_top_k_int8(torch.from_numpy(queries), cat, torch.from_numpy(ids), k,
                               invalid_ids=invalid_pt, max_item_id=max_id)
    jcat = jax_q.quantize_catalog(jnp.asarray(items), keep_exact=keep_exact)
    want = jax_q.mips_top_k_int8(jnp.asarray(queries), jcat, jnp.asarray(ids), k=k,
                                 invalid_ids=None if invalid is None else jnp.asarray(invalid),
                                 max_item_id=max_id)
    problem = topk_agree(got[0].numpy(), got[1].numpy(), np.asarray(want[0]),
                         np.asarray(want[1]), ATOL)
    assert problem is None, problem
    if filtered:
        for row, bad in zip(got[0].numpy(), invalid):
            assert not set(row.tolist()) & set(bad.tolist())
    if keep_exact:  # against the exact scan: recall, and the exact scores where ids agree
        exact_ids, exact_scores = mips_top_k(
            torch.from_numpy(queries), torch.from_numpy(items), torch.from_numpy(ids), k,
            invalid_ids=invalid_pt, max_item_id=max_id)
        recall = np.mean([len(set(a.tolist()) & set(e.tolist())) / k
                          for a, e in zip(got[0], exact_ids)])
        assert recall >= 0.95
        agree = (got[0] == exact_ids).numpy()
        np.testing.assert_allclose(got[1].numpy()[agree], exact_scores.numpy()[agree], rtol=1e-5)


def test_pre_ranked_invalid_candidates_sort_last_as_in_jax():
    """k' = 4 k reaches past the valid items: those masked in the int8 scan
    keep NEG_INF after the exact re-score."""
    rng = np.random.default_rng(2)
    x, d, k = 40, 16, 8
    ids = np.arange(1, x + 1, dtype=np.int32)
    items, queries = _normed(rng, x, d), _normed(rng, 2, d)
    invalid = np.stack([ids[:35], ids[5:]]).astype(np.int32)  # 5 valid items a row
    cat = pt_q.quantize_catalog(torch.from_numpy(items))
    got_ids, got_scores = pt_q.mips_top_k_int8(
        torch.from_numpy(queries), cat, torch.from_numpy(ids), k,
        invalid_ids=torch.from_numpy(invalid), max_item_id=x)
    want_ids, want_scores = jax_q.mips_top_k_int8(
        jnp.asarray(queries), jax_q.quantize_catalog(jnp.asarray(items)), jnp.asarray(ids), k=k,
        invalid_ids=jnp.asarray(invalid), max_item_id=x)
    assert (got_scores[:, 5:] == NEG_INF).all()
    assert (np.asarray(want_scores)[:, 5:] == NEG_INF).all()
    np.testing.assert_array_equal(got_ids[:, :5].numpy(), np.asarray(want_ids)[:, :5])
    assert set(got_ids[0, :5].tolist()) == set(ids[35:].tolist())
    np.testing.assert_allclose(got_scores[:, :5].numpy(), np.asarray(want_scores)[:, :5],
                               rtol=1e-5)


@pytest.mark.parametrize("steps", [1, 2])
def test_eval_step_with_int8_matches_jax(steps):
    jcfg, pcfg, jmodel, params, pmodel, item_ids, batches = _setup()
    for cfg in (jcfg, pcfg):
        cfg.model.index.quantize = "int8"
    max_id = int(pcfg.model.embedding.num_items)
    jcands = jax_task.make_candidate_fn(jmodel, jcfg, item_ids)(params)
    jstep = jax_task.make_eval_step(jmodel, jcfg, item_ids, max_id)
    cands = pt_task.make_candidate_fn(pmodel, pcfg, item_ids)()
    assert isinstance(cands, pt_q.QuantizedCatalog) and cands.q.dtype == torch.int8
    np.testing.assert_array_equal(cands.q.numpy(), np.asarray(jcands.q))
    pstep = pt_task.make_eval_step(pmodel, pcfg, item_ids, max_id, steps=steps)
    with torch.no_grad():
        if steps == 1:
            got = [pstep(_torch_batch(b), cands) for b in batches]
        else:
            many = pstep([_torch_batch(b) for b in batches], cands)
            got = [(many[0][i], many[1][i]) for i in range(len(batches))]
    for (ids, scores), batch in zip(got, batches):
        want = jstep(params, {k: jnp.asarray(v) for k, v in batch.items()}, jcands)
        problem = topk_agree(ids.numpy(), scores.numpy(), np.asarray(want[0]),
                             np.asarray(want[1]), ATOL)
        assert problem is None, problem


MAX_ID = 60
SEQS = [[1, 2, 3], [4, 5, 6, 7], [9], list(range(10, 40)) * 2]


def test_serving_engine_with_int8_matches_jax_engine():
    jcfg, pcfg = JaxConfig(), PtConfig()
    jcfg.model.encoder.use_pallas = "false"
    for cfg in (jcfg, pcfg):
        cfg.data.max_sequence_length = 16
        cfg.model.item_embedding_dim = 16
        cfg.model.index.k = 20
        cfg.model.index.quantize = "int8"
    jax_resolve(jcfg, MAX_ID)
    pt_resolve(pcfg, MAX_ID)
    jmodel = jax_build_model(jcfg)
    batch = {key: np.zeros((1, 16), dtype=np.int32) for key in ("ids", "ratings", "timestamps")}
    batch.update({key: np.zeros(1, dtype=np.int32)
                  for key in ("target_id", "target_rating", "target_timestamp")})
    batch["lengths"] = np.array([3], dtype=np.int32)
    seq, _, _ = jax_features(batch, jcfg.model.gr_output_length + 1)
    key = jax.random.PRNGKey(0)
    params = jmodel.init({"params": key, "dropout": key}, seq, method=jmodel.init_all)
    all_ids = np.arange(1, MAX_ID + 1, dtype=np.int32)
    jax_engine = JaxEngine(jmodel, params, jcfg, all_ids, MAX_ID, batch_size=4)
    pmodel = pt_build_model(pcfg, device="cpu")
    pmodel.load_state_dict(params_to_state_dict(_np_tree(params)))
    engine = ServingEngine(pmodel, pcfg, all_ids, MAX_ID, batch_size=4, device="cpu")
    assert isinstance(engine.candidates, pt_q.QuantizedCatalog)
    got_ids, got_scores = engine.retrieve(SEQS)
    want_ids, want_scores = jax_engine.retrieve(SEQS)
    problem = topk_agree(got_ids, got_scores, want_ids, want_scores, ATOL)
    assert problem is None, problem
    for seq, row in zip(SEQS, got_ids):
        assert len(row) == 20 and not set(seq[-16:]) & set(row)
    # generation decodes against the exact rows, as JAX's engine does
    assert engine.generate(SEQS, steps=3) == jax_engine.generate(SEQS, steps=3)
    # a refresh keeps the buffers the programs read, int8 rows and scales too
    buffers = pt_task.candidate_inputs(engine.candidates)
    with torch.no_grad():
        for p in pmodel.parameters():
            p.mul_(1.5)
    engine.refresh_candidates()
    for name, t in pt_task.candidate_inputs(engine.candidates).items():
        assert t is buffers[name]
