"""The item_year embedding of the PyTorch port (the fork's item/year split
table, and the fork's own checkpoints) against the JAX package, on the CPU.

The embedding's forward and gradients against JAX's `ItemYearEmbedding`
(ids past the item -> year map read its last entry); the dense-path loss and
every gradient, padded and packed, of synthetic-smoke with
`embedding.kind=item_year` (its catalog's years, 1920 + id % 80) on the JAX
step's own negatives; the eval top-k; a fork-layout `.ckpt` (the year table
sized by the fork at num_items + 1 rows, shorter and longer than the
model's 2,201, and the fork's item -> year buffer) loaded to the same
parameters as JAX's converter gives; `cli.serve`'s `build_engine` and
`cli.convert_ckpt` on such a file; the raises (odd D, no year table, a year
table for a `local` model, `data.item_year_feature`).

Tolerances: outputs at rtol 2e-4 / atol 2e-5 and gradients at rtol 5e-4
(the JAX kernel tests'); the model's loss and gradients at
tests/torch_port_families.py's (loss rtol 1e-5, gradients rtol 2e-4 /
atol 2e-6); top-k by `topk_agree` at atol 1e-5; loaded weights exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.cli.convert_ckpt import torch_state_dict_to_params
from mygenerativerecommenders_tpu.models.embeddings import ItemYearEmbedding as JaxItemYear
from mygenerativerecommenders_tpu_torch.checkpoint import (
    YEAR_BUFFER,
    YEAR_TABLE,
    load_weights,
    params_to_state_dict,
)
from mygenerativerecommenders_tpu_torch.cli import convert_ckpt
from mygenerativerecommenders_tpu_torch.cli.serve import build_engine
from mygenerativerecommenders_tpu_torch.cli.train import parse_args
from mygenerativerecommenders_tpu_torch.configs import resolve as pt_resolve
from mygenerativerecommenders_tpu_torch.configs.presets import get_preset as pt_preset
from mygenerativerecommenders_tpu_torch.data.catalog import item_catalog
from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
from mygenerativerecommenders_tpu_torch.models.embeddings import NUM_YEARS, ItemYearEmbedding
from mygenerativerecommenders_tpu_torch.models.model import build_model as pt_build_model
from tests import torch_port_families as fam
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

ITEM_YEAR = (("model.embedding.kind", "item_year"),)


def test_embedding_forward_and_gradients_match_jax_with_ids_past_the_map():
    num_items, dim = 30, 8
    rng = np.random.default_rng(0)
    # the map covers ids 0..20 only: ids 21..30 read its last entry, as JAX clips
    years = tuple(int(y) for y in rng.integers(1900, 2010, size=21))
    ids = rng.integers(0, num_items + 1, size=(3, 9)).astype(np.int32)
    ids[0, :3] = [0, 25, 30]
    jemb = JaxItemYear(num_items=num_items, item_embedding_dim=dim, year_of_item=years)
    params = jemb.init(jax.random.PRNGKey(1), jnp.asarray(ids))
    w = rng.normal(size=(3, 9, dim)).astype(np.float32)

    def loss(p):
        return (jemb.apply(p, jnp.asarray(ids)) * w).sum()

    want = np.asarray(jemb.apply(params, jnp.asarray(ids)))
    want_grads = jax.grad(loss)(params)["params"]
    emb = ItemYearEmbedding(num_items, dim, years)
    assert set(emb.state_dict()) == {"_item_emb.weight", "_year_emb.weight"}
    assert emb._year_emb.weight.shape == (NUM_YEARS + 1, dim // 2)
    for name in ("item_emb", "year_emb"):
        getattr(emb, f"_{name}").weight.data = torch.tensor(np.asarray(params["params"][name]))
    got = emb(torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(got[0, 1, dim // 2:].detach().numpy(),
                                  np.asarray(params["params"]["year_emb"])[years[-1]])
    (got * torch.from_numpy(w)).sum().backward()
    for name in ("item_emb", "year_emb"):
        np.testing.assert_allclose(getattr(emb, f"_{name}").weight.grad.numpy(),
                                   np.asarray(want_grads[name]), rtol=5e-4, atol=1e-7,
                                   err_msg=name)


def test_padded_dense_step_loss_and_every_gradient_match_jax():
    s = fam.shared(overrides=ITEM_YEAR, heads=2)
    assert tuple(s.pmodel.embeddings.year_of_item[1:4].tolist()) == tuple(
        1920 + i % 80 if i in s.item_ids else 0 for i in (1, 2, 3))
    fam.compare_loss_and_grads(s, s.batches[0], jax.random.fold_in(jax.random.PRNGKey(7), 0),
                               expect="loss_fn_dense")


def test_packed_dense_step_loss_and_every_gradient_match_jax():
    s = fam.packed_setup(overrides=ITEM_YEAR)
    widest = max(s.batches, key=lambda b: b["ids"].shape[1])
    fam.compare_loss_and_grads(s, widest, jax.random.PRNGKey(5), packed=True,
                               expect="loss_fn_dense")


def test_eval_top_k_equals_jax():
    fam.compare_eval_topk(fam.shared(overrides=ITEM_YEAR, heads=2))


def _fork_state(s, rows: int, seed: int) -> dict:
    """The fork's checkpoint of `s`'s model: every weight drawn from `seed`,
    the year table [rows, D/2] (the fork sizes it by num_items + 1), and the
    fork's item -> year buffer."""
    rng = np.random.default_rng(seed)
    state = {k: torch.tensor(rng.normal(size=v.shape).astype(np.float32))
             for k, v in s.pmodel.state_dict().items()}
    half = s.pcfg.model.item_embedding_dim // 2
    state[YEAR_TABLE] = torch.tensor(rng.normal(size=(rows, half)).astype(np.float32))
    state[YEAR_BUFFER] = torch.tensor(rng.integers(0, 2100, size=rows))
    return state


def _lightning_ckpt(path, state) -> None:
    torch.save({"state_dict": {f"model.{k}": v for k, v in state.items()}, "epoch": 3,
                "global_step": 10, "hyper_parameters": {"lr": 1e-3}}, path)


@pytest.mark.parametrize("num_items", [0, 2400], ids=["fewer-rows", "more-rows"])
def test_fork_ckpt_loads_to_the_jax_converters_parameters(tmp_path, num_items):
    """The fork's year table has num_items + 1 rows: 201 (zero-padded to
    2,201) or 2,401 (cut to 2,201), as JAX's `torch_state_dict_to_params`
    cuts or pads it; the buffer is dropped."""
    overrides = ITEM_YEAR + ((("model.embedding.num_items", num_items),) if num_items else ())
    s = fam.shared(overrides=overrides, heads=2)
    rows = s.pcfg.model.embedding.num_items + 1
    assert (rows < NUM_YEARS + 1) == (num_items == 0)
    state = _fork_state(s, rows, seed=rows)
    path = tmp_path / "fork.ckpt"
    _lightning_ckpt(path, state)
    model = pt_build_model(s.pcfg, device="cpu", seed=1,
                           year_of_item=s.pmodel.embeddings.year_of_item.numpy())
    load_weights(model, str(path))
    want = params_to_state_dict(fam.np_tree(
        torch_state_dict_to_params(torch.load(path)["state_dict"], s.params["params"])))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)
    year = got[YEAR_TABLE].numpy()
    kept = min(rows, NUM_YEARS + 1)
    np.testing.assert_array_equal(year[:kept], state[YEAR_TABLE][:kept].numpy())
    assert not year[kept:].any()


def test_cli_serve_and_convert_ckpt_take_an_item_year_checkpoint(tmp_path):
    args = ["experiment=synthetic-smoke", f"data.data_dir={tmp_path}",
            "model.embedding.kind=item_year"]
    cfg = parse_args(args)
    ids, max_id, years = item_catalog(cfg.data)
    pt_resolve(cfg, max_id)
    model = pt_build_model(cfg, device="cpu", seed=3, year_of_item=years)
    state = model.state_dict()
    fork = {**state, YEAR_TABLE: state[YEAR_TABLE][:max_id + 1],
            YEAR_BUFFER: torch.as_tensor(years)}
    _lightning_ckpt(tmp_path / "fork.ckpt", fork)
    out = convert_ckpt.main([str(tmp_path / "fork.ckpt"), str(tmp_path / "model.pt"), *args])
    converted = torch.load(out, weights_only=True)
    assert converted.keys() == state.keys()
    np.testing.assert_array_equal(converted[YEAR_TABLE][:max_id + 1].numpy(),
                                  state[YEAR_TABLE][:max_id + 1].numpy())
    assert not converted[YEAR_TABLE][max_id + 1:].any()
    for ckpt in ("fork.ckpt", "model.pt"):
        engine, _ = build_engine(args + [f"trainer.ckpt_path={tmp_path / ckpt}",
                                         "serve.device=cpu"])
        np.testing.assert_array_equal(engine.model.embeddings.year_of_item.numpy(), years)
        got_ids, got_scores = engine.retrieve([[int(ids[0]), int(ids[5])], [int(ids[9])]])
        assert set(np.ravel(got_ids)) <= set(ids.tolist()) and np.isfinite(got_scores).all()


def test_item_year_raises_where_it_cannot_be_built(tmp_path):
    cfg = pt_preset("synthetic-smoke")
    cfg.model.embedding.kind = "item_year"
    pt_resolve(cfg, 200)
    years = np.zeros(201, dtype=np.int32)
    with pytest.raises(ValueError, match="requires year_of_item"):
        pt_build_model(cfg, device="cpu")
    cfg.model.item_embedding_dim = 15
    with pytest.raises(ValueError, match="odd"):
        pt_build_model(cfg, device="cpu", year_of_item=years)
    # the fork's year table given to a local model names the key and the kind
    local = pt_preset("synthetic-smoke")
    pt_resolve(local, 200)
    state = pt_build_model(local, device="cpu").state_dict()
    _lightning_ckpt(tmp_path / "fork.ckpt", {**state, YEAR_TABLE: torch.zeros(201, 8)})
    with pytest.raises(ValueError, match=r"_year_emb.*embedding.kind=item_year"):
        load_weights(pt_build_model(local, device="cpu"), str(tmp_path / "fork.ckpt"))


def test_item_year_feature_raises_naming_the_field_the_reference_ignores():
    cfg = pt_preset("synthetic-smoke")
    cfg.data.item_year_feature = True
    with pytest.raises(ValueError, match="item_year_feature.*embedding.kind=item_year"):
        RecoData(cfg.data)
