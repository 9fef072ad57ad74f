"""The sharded top-k of the port (parallel/topk_sharded.py), its shards run in
turn on one device, against the JAX package's `sharded_mips_top_k` and
`sharded_mips_top_k_int8` on the 8-device CPU mesh, with pad rows (id 0) in
every shard and each row's invalid ids filtered: ids and scores through
`topk_agree` (near ties may order differently). The exact sharded top-k also
against the port's replicated `mips_top_k` on the unpadded rows.

Every JAX mesh is scoped with `with jax.sharding.set_mesh(...)`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mygenerativerecommenders_tpu.ops.quantized_topk import quantize_rows as jax_quantize_rows
from mygenerativerecommenders_tpu.parallel.mesh import make_mesh
from mygenerativerecommenders_tpu.parallel.topk_sharded import (
    sharded_mips_top_k as jax_sharded_top_k,
    sharded_mips_top_k_int8 as jax_sharded_top_k_int8,
)
from mygenerativerecommenders_tpu_torch.ops.quantized_topk import quantize_rows
from mygenerativerecommenders_tpu_torch.ops.topk import mips_top_k, topk_agree
from mygenerativerecommenders_tpu_torch.parallel.embedding_sharding import OneDeviceShards
from mygenerativerecommenders_tpu_torch.parallel.topk_sharded import (
    sharded_mips_top_k,
    sharded_mips_top_k_int8,
)
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL = 1e-5
B, D, K = 8, 16, 10


def _catalog(seed: int, r: int, x: int):
    """x catalog rows (ids 1..x, shuffled) padded to a multiple of r with
    id-0 rows; queries [B, D]; each row's invalid ids [B, 7] (0 = none)."""
    rng = np.random.default_rng(seed)
    x_pad = -(-x // r) * r
    items = np.zeros((x_pad, D), np.float32)
    items[:x] = rng.normal(size=(x, D))
    ids = np.zeros(x_pad, np.int64)
    ids[:x] = rng.permutation(np.arange(1, x + 1))
    queries = rng.normal(size=(B, D)).astype(np.float32)
    invalid = rng.integers(1, x + 1, size=(B, 7))
    invalid[:, -2:] = 0
    return items, ids, queries, invalid


def _jax_call(fn, r, *args, **kw):
    mesh = make_mesh(data=8 // r, model=r)
    q, rest = args[0], args[1:]
    with jax.sharding.set_mesh(mesh):
        q = jax.device_put(jnp.asarray(q), NamedSharding(mesh, P()))
        rest = [jax.device_put(jnp.asarray(a), NamedSharding(
            mesh, P("model", None) if a.ndim == 2 else P("model"))) for a in rest]
        inv = jnp.asarray(kw.pop("invalid_ids"), jnp.int32)
        ids, scores = fn(mesh, q, *rest, invalid_ids=inv, **kw)
    return np.asarray(ids), np.asarray(scores)


@pytest.mark.parametrize("r,x", [(2, 61), (4, 200), (4, 9)])
def test_sharded_top_k_matches_jax_and_the_replicated_scan(r, x):
    items, ids, queries, invalid = _catalog(r * 100 + x, r, x)
    k = min(K, x)
    want = _jax_call(jax_sharded_top_k, r, queries, items, ids.astype(np.int32), k=k,
                     invalid_ids=invalid)
    got = sharded_mips_top_k(OneDeviceShards(r), torch.from_numpy(queries),
                             torch.from_numpy(items), torch.from_numpy(ids), k=k,
                             invalid_ids=torch.from_numpy(invalid))
    assert topk_agree(got[0].numpy(), got[1].numpy(), *want, ATOL) is None
    if x >= k + invalid.shape[1]:
        # k valid candidates: the replicated scan over the unpadded rows agrees
        order = np.argsort(ids[:x])
        rep = mips_top_k(torch.from_numpy(queries), torch.from_numpy(items[:x][order]),
                         torch.from_numpy(ids[:x][order]), k=k,
                         invalid_ids=torch.from_numpy(invalid), max_item_id=x)
        assert topk_agree(got[0].numpy(), got[1].numpy(), rep[0].numpy(), rep[1].numpy(),
                          ATOL) is None
        assert 0 not in got[0] and not any(set(a) & set(b) for a, b in zip(
            got[0].tolist(), invalid.tolist()))


@pytest.mark.parametrize("r,x,over_fetch", [(2, 61, 4), (4, 200, 2), (8, 120, 1)])
def test_sharded_int8_top_k_matches_jax(r, x, over_fetch):
    items, ids, queries, invalid = _catalog(r * 1000 + x, r, x)
    q8, scales = (np.asarray(a) for a in jax_quantize_rows(jnp.asarray(items)))
    pq, ps = quantize_rows(torch.from_numpy(items))
    np.testing.assert_array_equal(pq.numpy(), q8)
    np.testing.assert_array_equal(ps.numpy(), scales)
    want = _jax_call(jax_sharded_top_k_int8, r, queries, q8, scales, items,
                     ids.astype(np.int32), k=K, invalid_ids=invalid, over_fetch=over_fetch)
    got = sharded_mips_top_k_int8(
        OneDeviceShards(r), torch.from_numpy(queries), pq, ps, torch.from_numpy(items),
        torch.from_numpy(ids), k=K, invalid_ids=torch.from_numpy(invalid),
        over_fetch=over_fetch)
    assert topk_agree(got[0].numpy(), got[1].numpy(), *want, ATOL) is None


def test_without_invalid_ids_and_a_recall_target_above_one():
    items, ids, queries, _ = _catalog(5, 4, 40)
    group = OneDeviceShards(4)
    args = (group, torch.from_numpy(queries), torch.from_numpy(items), torch.from_numpy(ids))
    got = sharded_mips_top_k(*args, k=K)
    mesh = make_mesh(data=2, model=4)
    with jax.sharding.set_mesh(mesh):
        want = jax_sharded_top_k(mesh, jnp.asarray(queries), jnp.asarray(items),
                                 jnp.asarray(ids.astype(np.int32)), k=K)
    assert topk_agree(got[0].numpy(), got[1].numpy(), np.asarray(want[0]),
                      np.asarray(want[1]), ATOL) is None
    # approx_recall takes the exact selection (ops/topk.py), and refuses > 1
    assert torch.equal(sharded_mips_top_k(*args, k=K, approx_recall=0.95)[0], got[0])
    with pytest.raises(ValueError, match="at most 1"):
        sharded_mips_top_k(*args, k=K, approx_recall=1.5)
