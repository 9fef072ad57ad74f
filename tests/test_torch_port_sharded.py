"""The sharded embedding kinds of the port, their shards run in turn on one
device, against the JAX package's on the 8-device CPU mesh.

- The owner-routed bodies (`owner_routed_lookup_body`, `_sliced`) against
  JAX's inside `shard_map` at R = 2, 4 and 8: balanced ids, and a skewed draw
  at capacity_factor 0.5 whose buckets overflow. Rows equal bit for bit.
- `ShardedEmbedding.lookup`, `.lookup_all_to_all` and
  `ColumnShardedEmbedding.lookup` against JAX's: rows bit for bit, the table
  gradient at rtol 1e-6 (only the scatter order differs, as
  tests/test_sharded_a2a_model.py holds JAX's own).
- A model of each kind (`sharded_local`, `sharded_a2a`, `sharded_column`,
  `sharded_2d`) against JAX's `make_loss_fn`: the loss and every gradient at
  the local table's tolerances (tests/torch_port_families.py).
- Refusals as JAX's (`index.sharded=true` on a local kind, `lazy_update` with
  a sharded kind, D not divisible by the column shards, the shard counts),
  and a padded table through `params_to_state_dict` and back.
- The three presets that ship a sharded kind build as shipped and train,
  evaluate and serve on the CPU at a reduced vocabulary (as JAX's tests hold
  `synthetic-large-vocab-100m`).

Every JAX mesh is scoped with `with jax.sharding.set_mesh(...)`, which
restores the ambient mesh on exit, and every JAX array a test hands to a
sharded function is made inside that scope: an array made outside it, while
a mesh that another test left set is ambient (tests/test_tensor_parallel.py
leaves one), is placed on that mesh, and shard_map then refuses it. So the
file passes right after tests/test_tensor_parallel.py in one process.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mygenerativerecommenders_tpu.cli.convert_ckpt import torch_state_dict_to_params
from mygenerativerecommenders_tpu.models.model import build_model as jax_build_model
from mygenerativerecommenders_tpu.parallel import embedding_sharding as jes
from mygenerativerecommenders_tpu.parallel.mesh import make_mesh
from mygenerativerecommenders_tpu.train import lazy_embedding as jax_lazy
from mygenerativerecommenders_tpu.train import task_retrieval as jax_task
from mygenerativerecommenders_tpu.utils.features import seq_features_from_batch as jax_features
from mygenerativerecommenders_tpu_torch.checkpoint import params_to_state_dict
from mygenerativerecommenders_tpu_torch.cli import train as cli_train
from mygenerativerecommenders_tpu_torch.configs import resolve as pt_resolve
from mygenerativerecommenders_tpu_torch.configs.presets import get_preset as pt_preset
from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
from mygenerativerecommenders_tpu_torch.models import embeddings as pt_emb
from mygenerativerecommenders_tpu_torch.models.model import build_model as pt_build_model
from mygenerativerecommenders_tpu_torch.ops.quantized_topk import QuantizedCatalog
from mygenerativerecommenders_tpu_torch.parallel import embedding_sharding as pes
from mygenerativerecommenders_tpu_torch.serving.service import ServingEngine
from mygenerativerecommenders_tpu_torch.train import lazy_embedding as pt_lazy
from mygenerativerecommenders_tpu_torch.train import task_retrieval as pt_task
from mygenerativerecommenders_tpu_torch.train.driver import Trainer
from tests import torch_port_families as fam
from tests.torch_port_real_files import write_amazon_csv
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TABLE_GRAD_RTOL = 1e-6


def _model_mesh(r: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:r]), ("model",))


def _table(seed: int, rows: int, d: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(rows, d)).astype(np.float32)


def _ids(seed: int, n: int, vocab: int, r: int, skewed: bool) -> np.ndarray:
    """n ids below vocab; balanced: the owners in turn (every run of ids
    spread over the shards), skewed: three in four owned by shard 0."""
    rng = np.random.default_rng(seed)
    rps = vocab // r
    ids = np.arange(n) % r * rps + rng.integers(0, rps, size=n)
    if skewed:
        hot = rng.random(n) < 0.75
        ids[hot] = rng.integers(0, rps, size=int(hot.sum()))
    return ids.astype(np.int32)


def _overflows(ids: np.ndarray, rps: int, r: int, cap: int) -> bool:
    return bool((np.bincount(np.clip(ids // rps, 0, r - 1), minlength=r) > cap).any())


@pytest.mark.parametrize("r", [2, 4, 8])
@pytest.mark.parametrize("skewed", [False, True], ids=["balanced", "skewed"])
def test_owner_routed_bodies_equal_jax_shard_map_bit_for_bit(r, skewed):
    rps, d = 6, 5
    table = _table(r, r * rps, d)
    cf = 0.5 if skewed else 2.0
    tables = torch.from_numpy(table).view(r, rps, d)
    group = pes.OneDeviceShards(r)
    mesh = _model_mesh(r)

    # the replicated request list
    ids = _ids(r + 10, 30, r * rps, r, skewed)
    cap = jes.a2a_capacity(len(ids), r, cf)
    assert pes.a2a_capacity(len(ids), r, cf) == cap
    assert _overflows(ids, rps, r, cap) == skewed
    body = functools.partial(jes.owner_routed_lookup_body, axis="model", rows_per_shard=rps,
                             num_shards=r, cap=cap)
    with jax.sharding.set_mesh(mesh):
        want = shard_map(body, mesh=mesh, in_specs=(P("model", None), P()), out_specs=P(),
                         check_vma=False)(jnp.asarray(table), jnp.asarray(ids))
    got = pes.owner_routed_lookup_body(group, tables, torch.from_numpy(ids), cap=cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), table[ids])

    # each shard's own slice of the list
    chunk = 9
    ids = _ids(r + 20, r * chunk, r * rps, r, skewed)
    cap = jes.a2a_capacity(chunk, r, cf)
    assert any(_overflows(ids[s * chunk:(s + 1) * chunk], rps, r, cap)
               for s in range(r)) == skewed
    body = functools.partial(jes.owner_routed_lookup_sliced, axis="model", rows_per_shard=rps,
                             num_shards=r, cap=cap)
    with jax.sharding.set_mesh(mesh):
        want = shard_map(body, mesh=mesh, in_specs=(P("model", None), P("model")),
                         out_specs=P("model", None), check_vma=False)(
            jnp.asarray(table), jnp.asarray(ids))
    got = pes.owner_routed_lookup_sliced(group, tables, torch.from_numpy(ids).view(r, chunk),
                                         cap=cap)
    np.testing.assert_array_equal(got.reshape(-1, d).numpy(), np.asarray(want))


@pytest.mark.parametrize("method", ["lookup", "lookup_all_to_all", "column"])
def test_standalone_tables_equal_jax_rows_and_table_gradients(method):
    r, num_items, d = 4, 37, 8
    mesh = _model_mesh(r)
    group = pes.OneDeviceShards(r)
    if method == "column":
        jtab, ptab = jes.ColumnShardedEmbedding(mesh, num_items, d), \
            pes.ColumnShardedEmbedding(group, num_items, d)
    else:
        jtab, ptab = jes.ShardedEmbedding(mesh, num_items, d), \
            pes.ShardedEmbedding(group, num_items, d)
    assert ptab.vocab == jtab.vocab
    table = _table(3, jtab.vocab, d)
    table[0] = 0.0
    ids = _ids(4, 42, num_items + 1, r, skewed=True).reshape(6, 7)
    g = np.random.default_rng(5).normal(size=(6, 7, d)).astype(np.float32)
    kw = {"capacity_factor": 0.5} if method == "lookup_all_to_all" else {}
    jname = "lookup" if method == "column" else method

    def jloss(t):
        rows = getattr(jtab, jname)(t, jnp.asarray(ids), **kw)
        return (rows * g).sum(), rows

    with jax.sharding.set_mesh(mesh):
        (_, want), want_grad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(table))
    t = torch.from_numpy(table.copy()).requires_grad_()
    rows = getattr(ptab, jname)(t, torch.from_numpy(ids), **kw)
    (rows * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(rows.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grad), rtol=TABLE_GRAD_RTOL,
                               atol=1e-7)
    assert torch.equal(ptab.full_table(t), t)


# kind -> (num_shards, col_shards, capacity factor, mesh (data, model, col))
KINDS = {
    "sharded_local": (4, 1, 2.0, (2, 4, 1)),
    "sharded_a2a": (4, 1, 0.5, (2, 4, 1)),
    "sharded_column": (2, 1, 2.0, (4, 2, 1)),
    "sharded_2d": (2, 2, 0.5, (1, 2, 2)),
}


def _kind_overrides(kind):
    r, c, cf, _ = KINDS[kind]
    return (("model.embedding.kind", kind), ("model.embedding.num_shards", r),
            ("model.embedding.col_shards", c), ("model.embedding.a2a_capacity_factor", cf))


@functools.lru_cache(maxsize=None)
def _kind_setup(kind):
    """synthetic-smoke (1 head, D=16) with the kind in both packages: the JAX
    model's weights, initialised under its mesh, carried into the port's.
    -> (Setup, mesh)."""
    jcfg, pcfg = fam._configs("synthetic-smoke", _kind_overrides(kind), heads=1)
    data = RecoData(pcfg.data, seed=42)
    batches = [b for _, b in zip(range(2), data.loader("train"))]
    fam.jax_resolve(jcfg, data.max_item_id)
    pt_resolve(pcfg, data.max_item_id)
    mesh = make_mesh(*KINDS[kind][3])
    jmodel = jax_build_model(jcfg)
    with jax.sharding.set_mesh(mesh):  # every JAX array of the set-up made under it
        seq, _, _ = jax_features(batches[0], jcfg.model.gr_output_length + 1)
        key = jax.random.PRNGKey(0)
        params = jmodel.init({"params": key, "dropout": key}, seq, method=jmodel.init_all)
    params = fam.np_tree(params)
    pmodel = pt_build_model(pcfg, device="cpu")
    pmodel.load_state_dict(params_to_state_dict(params))
    return fam.Setup(jcfg, pcfg, jmodel, params, pmodel, data.all_item_ids, batches), mesh


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_each_kind_builds_jax_shapes_and_matches_the_jax_loss_and_every_gradient(kind):
    s, mesh = _kind_setup(kind)
    r = KINDS[kind][0]
    table = s.params["params"]["embeddings"]["item_emb"]
    rows = s.pcfg.model.embedding.num_items + 1
    assert table.shape == (rows if kind == "sharded_column" else -(-rows // r) * r, 16)
    weight = s.pmodel.embeddings._item_emb.weight
    assert tuple(weight.shape) == table.shape
    assert [n for n, _ in s.pmodel.named_parameters()][0] == "embeddings._item_emb.weight"
    ids = torch.from_numpy(s.batches[0]["ids"])
    with torch.no_grad():
        assert torch.equal(s.pmodel.item_embeddings(ids), weight[ids.long()])
    with jax.sharding.set_mesh(mesh):
        fam.compare_loss_and_grads(s, s.batches[1], jax.random.PRNGKey(5))


def _jax_eval_metrics(s, mesh, quantize):
    """The JAX trainer's eval on the val split: the sharded candidates and
    eval step under the mesh, its retrieval metrics."""
    from mygenerativerecommenders_tpu.models.metrics import retrieval_metrics

    jcfg = copy.deepcopy(s.jcfg)
    jcfg.model.index.quantize = quantize
    max_id = int(jcfg.model.embedding.num_items)
    data = RecoData(s.pcfg.data, seed=42)
    with jax.sharding.set_mesh(mesh):
        cands = jax_task.make_candidate_fn(s.jmodel, jcfg, s.item_ids, mesh=mesh)(s.params)
        step = jax_task.make_eval_step(s.jmodel, jcfg, s.item_ids, max_id, mesh=mesh)
        tops, targets = [], []
        for batch in data.loader("val"):
            ids, _ = step(s.params, {k: jnp.asarray(v) for k, v in batch.items()}, cands)
            valid = batch["sample_weight"] > 0
            tops.append(np.asarray(ids)[valid])
            targets.append(batch["target_id"][valid])
    return retrieval_metrics(np.concatenate(tops), np.concatenate(targets)[:, None],
                             jcfg.model.metrics.at_k_list)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_trainer_eval_on_the_sharded_index_equals_jax(tmp_path, quantize):
    s, mesh = _kind_setup("sharded_a2a")
    cfg = copy.deepcopy(s.pcfg)
    cfg.model.index.quantize = quantize
    cfg.trainer.device = "cpu"
    cfg.trainer.output_dir = str(tmp_path)
    assert pt_task.index_sharded_on(cfg) and jax_task.index_sharded_on(s.jcfg)
    trainer = Trainer(cfg)
    trainer.model.load_state_dict(s.pmodel.state_dict())
    cands = trainer.candidate_fn()
    rows = cands.exact if quantize == "int8" else cands
    assert isinstance(cands, QuantizedCatalog) == (quantize == "int8")
    assert rows.shape[0] % 4 == 0 and rows.shape[0] >= len(s.item_ids)
    assert not rows[len(s.item_ids):].any()  # pad rows carry id 0 and zeros
    got = trainer.eval_epoch(trainer.data.loader("val"), "val")
    want = _jax_eval_metrics(s, mesh, quantize)
    assert got.keys() == want.keys()
    for name in got:
        assert got[name] == pytest.approx(float(want[name]), abs=1e-9), name


def test_refusals_raise_as_jax_does():
    cfg, jcfg = pt_preset("synthetic-smoke"), fam.jax_preset("synthetic-smoke")
    for c in (cfg, jcfg):
        c.model.index.sharded = "true"
    with pytest.raises(ValueError) as want:
        jax_task.index_sharded_on(jcfg)
    with pytest.raises(ValueError) as got:
        pt_task.make_candidate_fn(pt_build_model(_resolved(cfg), device="cpu"), cfg,
                                  np.arange(1, 201))
    assert str(got.value) == str(want.value)

    for c in (cfg, jcfg):
        c.model.index.sharded = "auto"
        c.model.embedding.kind, c.model.embedding.num_shards = "sharded_a2a", 8
        c.model.embedding.lazy_update = True
        c.model.loss.shared_negatives = True
    with pytest.raises(ValueError) as want:
        jax_lazy.lazy_applicable(jcfg)
    with pytest.raises(ValueError) as got:
        pt_lazy.lazy_applicable(cfg)
    assert str(got.value) == str(want.value) and "embedding.kind=local" in str(got.value)

    for kind, shards, dim in (("sharded_column", 3, 16), ("sharded_2d", 2, 15)):
        jcfg, pcfg = fam._configs("synthetic-smoke", (("model.embedding.kind", kind),), heads=1)
        for c in (jcfg, pcfg):
            c.model.embedding.num_shards = c.model.embedding.col_shards = shards
            c.model.item_embedding_dim = dim
        fam.jax_resolve(jcfg, 220)
        jmodel = jax_build_model(jcfg)
        with pytest.raises(ValueError) as want:
            jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 3), jnp.int32),
                        method=jmodel.item_embeddings)
        with pytest.raises(ValueError) as got:
            pt_build_model(_resolved(pcfg), device="cpu")
        assert str(got.value) == str(want.value)

    cfg = pt_preset("synthetic-smoke")
    cfg.model.embedding.kind, cfg.model.embedding.num_shards = "sharded_local", 4
    cfg.model.encoder.tp_shards = 2
    with pytest.raises(ValueError, match=r"must match \(4 vs 2\)"):
        pt_build_model(_resolved(cfg), device="cpu")


def _resolved(cfg):
    pt_resolve(cfg, 220)
    return cfg


def test_a_padded_table_goes_through_params_to_state_dict_and_back():
    s, _ = _kind_setup("sharded_a2a")
    table = s.params["params"]["embeddings"]["item_emb"]
    assert table.shape[0] > s.pcfg.model.embedding.num_items + 1  # padded
    state = {k: v.numpy() for k, v in s.pmodel.state_dict().items()}
    back = torch_state_dict_to_params(state, s.params)
    flat_a = jax.tree_util.tree_leaves_with_path(s.params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf), str(path))


REDUCED_LARGE = ["trainer.device=cpu", "trainer.max_epochs=1", "trainer.min_epochs=1",
                 "data.synthetic_num_users=64", "data.expected_num_unique_items=250000",
                 "data.expected_max_item_id=250000", "model.encoder.num_blocks=1",
                 "model.loss.num_to_sample=16"]
PRESETS = {
    "synthetic-large-vocab": ("sharded_a2a", 8, 1, REDUCED_LARGE),
    "synthetic-large-vocab-100m": ("sharded_2d", 8, 2, REDUCED_LARGE),
    "amzn-books-sharded": ("sharded_a2a", 8, 1, [
        "trainer.device=cpu", "trainer.max_epochs=1", "trainer.min_epochs=1",
        "model.encoder.num_blocks=1", "model.loss.num_to_sample=16",
        "data.max_sequence_length=32", "data.pack_capacities=[64]",
        "data.length_buckets=[]"]),
}


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_sharded_presets_build_as_shipped_and_train_evaluate_and_serve(tmp_path, preset):
    """Each preset's kind and shard counts as shipped, at a vocabulary the
    CPU holds: one epoch through `Trainer.fit` (its eval on the sharded
    index), then `/v1/retrieve`'s engine call."""
    kind, shards, cols, extra = PRESETS[preset]
    if preset.startswith("amzn"):
        write_amazon_csv(tmp_path / "ratings_Books.csv", num_users=60, num_items=50)
        extra = extra + [f"data.data_dir={tmp_path}"]
    cfg = cli_train.parse_args([f"experiment={preset}", f"trainer.output_dir={tmp_path}"]
                               + extra)
    e = cfg.model.embedding
    assert (e.kind, e.num_shards, e.col_shards, e.lazy_update) == (kind, shards, cols, False)
    trainer = Trainer(cfg)
    assert pt_task.index_sharded_on(cfg)
    assert isinstance(trainer.model.embeddings,
                      pt_emb.Sharded2DEmbedding if cols > 1 else pt_emb.ShardedA2AEmbedding)
    results = trainer.fit()
    assert trainer.global_step >= 1 and all(0.0 <= v <= 1.0 for v in results.values())
    assert torch.isfinite(trainer.model.embeddings._item_emb.weight).all()
    engine = ServingEngine(trainer.model, cfg, trainer.all_item_ids, trainer.data.max_item_id,
                           batch_size=4, device="cpu")
    seq = [int(x) for x in trainer.all_item_ids[:3]]
    ids, scores = engine.retrieve([seq])
    x = len(trainer.all_item_ids)
    assert len(ids[0]) == min(cfg.model.index.k, x)
    # past a small catalog's valid items come the filtered ones and the pad
    # rows (id 0), at NEG_INF, as in JAX
    real = [i for i, sc in zip(ids[0], scores[0]) if sc > -1e29]
    assert len(real) == min(cfg.model.index.k, x - len(seq))
    assert not set(seq) & set(real) and 0 not in real
    assert scores[0] == sorted(scores[0], reverse=True)


def test_generation_of_a_sharded_model_decodes_or_names_the_knob():
    s, _ = _kind_setup("sharded_a2a")
    cfg = s.pcfg
    max_id = int(cfg.model.embedding.num_items)
    ids = s.item_ids
    engine = ServingEngine(s.pmodel, cfg, ids, max_id, batch_size=2, device="cpu")
    if len(ids) % 4:
        with pytest.raises(ValueError, match="model.index.sharded=false"):
            engine.generate([[1, 2, 3]], steps=2)
    cut = ids[: len(ids) // 4 * 4]  # a catalog the shards divide: decodes
    engine = ServingEngine(s.pmodel, cfg, cut, max_id, batch_size=2, device="cpu")
    plain = copy.deepcopy(cfg)
    plain.model.index.sharded = "false"
    ref = ServingEngine(s.pmodel, plain, cut, max_id, batch_size=2, device="cpu")
    assert engine.generate([[1, 2, 3]], steps=2) == ref.generate([[1, 2, 3]], steps=2)
