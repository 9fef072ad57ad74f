"""The PyTorch port's HSTU block and full model against the JAX package's,
on the CPU, with the JAX weights carried over by `params_to_state_dict`.

Tolerance: rtol 1e-4 / atol 1e-5. Beyond the attention kernels' fp32
reordering (rtol 2e-4 / atol 2e-5 on the raw attention), flax's LayerNorm
takes the variance as mean(x^2) - mean(x)^2 while torch takes
mean((x - mean)^2); the outputs here are L2-normalized, |x| <= 1.
"""

import jax
import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.cli.convert_ckpt import torch_state_dict_to_params
from mygenerativerecommenders_tpu.configs import Config as JaxConfig
from mygenerativerecommenders_tpu.configs import apply_overrides as jax_overrides
from mygenerativerecommenders_tpu.configs import resolve as jax_resolve
from mygenerativerecommenders_tpu.models.hstu import HSTUBlock as JaxBlock
from mygenerativerecommenders_tpu.models.model import build_model as jax_build_model
from mygenerativerecommenders_tpu.utils.features import (
    seq_features_from_batch as jax_seq_features,
)
from mygenerativerecommenders_tpu_torch.checkpoint import (
    load_checkpoint,
    params_to_state_dict,
)
from mygenerativerecommenders_tpu_torch.configs import Config as PtConfig
from mygenerativerecommenders_tpu_torch.configs import apply_overrides as pt_overrides
from mygenerativerecommenders_tpu_torch.configs import resolve as pt_resolve
from mygenerativerecommenders_tpu_torch.models.hstu import HSTUBlock as PtBlock
from mygenerativerecommenders_tpu_torch.models.model import build_model as pt_build_model
from mygenerativerecommenders_tpu_torch.utils.features import (
    seq_features_from_batch as pt_seq_features,
)
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL, ATOL = 1e-4, 1e-5
MAX_ID = 50
L = 20  # data.max_sequence_length; N = L + 11


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(overrides):
    jcfg, pcfg = JaxConfig(), PtConfig()
    base = [
        f"data.max_sequence_length={L}", "model.item_embedding_dim=16",
        "model.encoder.use_pallas=false",
    ]
    jax_overrides(jcfg, base + overrides)
    pt_overrides(pcfg, base[:2] + overrides)  # the port's "auto": the fused wrapper
    jax_resolve(jcfg, MAX_ID)
    pt_resolve(pcfg, MAX_ID)
    return jcfg, pcfg


def _batch(seed, b=4):
    rng = np.random.default_rng(seed)
    lengths = np.array([1, 7, L, 12][:b], dtype=np.int32)
    ids = np.zeros((b, L), dtype=np.int32)
    ts = np.zeros((b, L), dtype=np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(1, MAX_ID + 1, size=n)
        ts[i, :n] = np.sort(978_000_000 + rng.integers(0, 10**8, size=n))
    return {
        "lengths": lengths, "ids": ids, "timestamps": ts,
        "ratings": np.zeros((b, L), dtype=np.int32),
        "target_id": np.zeros(b, dtype=np.int32),
        "target_rating": np.zeros(b, dtype=np.int32),
        "target_timestamp": (ts.max(axis=1) + 1000).astype(np.int32),
    }


def _jax_model(jcfg, seed=0):
    model = jax_build_model(jcfg)
    seq, _, _ = jax_seq_features(_batch(0), jcfg.model.gr_output_length + 1)
    key = jax.random.PRNGKey(seed)
    params = model.init({"params": key, "dropout": key}, seq, method=model.init_all)
    return model, params


@pytest.mark.parametrize("h,dqk,dv", [(1, 16, 16), (2, 8, 6)])
def test_hstu_block_matches_jax(h, dqk, dv):
    rng = np.random.default_rng(h)
    b, n, d = 3, 31, 16
    lengths = np.array([1, 17, n], dtype=np.int32)
    valid = (np.arange(n)[None, :] < lengths[:, None])[:, :, None]
    x = (rng.normal(size=(b, n, d)) * valid).astype(np.float32)
    ts = np.sort(978_000_000 + rng.integers(0, 10**7, size=(b, n)), axis=1).astype(np.int32)
    jblock = JaxBlock(
        embedding_dim=d, linear_dim=dv, attention_dim=dqk, num_heads=h, max_attn_len=n
    )
    params = jblock.init(jax.random.PRNGKey(h), x, ts, lengths)
    want = np.asarray(jblock.apply(params, x, ts, lengths))

    pblock = PtBlock(d, dv, dqk, h, n)
    prefix = "sequence_encoder._hstu._attention_layers.0."
    state = params_to_state_dict({"encoder": {"block_0": _np_tree(params["params"])}})
    pblock.load_state_dict({k[len(prefix):]: v for k, v in state.items()})
    with torch.inference_mode():
        got = pblock(torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("heads", [1, 2])
def test_full_forward_matches_jax(heads):
    jcfg, pcfg = _configs([f"model.encoder.num_heads={heads}"])
    jmodel, params = _jax_model(jcfg)
    batch = _batch(1)
    seq, _, _ = jax_seq_features(batch, jcfg.model.gr_output_length + 1)
    want, want_len = jmodel.apply(params, seq, deterministic=True)

    pmodel = pt_build_model(pcfg, device="cpu")
    pmodel.load_state_dict(params_to_state_dict(_np_tree(params)))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pseq, _, _ = pt_seq_features(tbatch, pcfg.model.gr_output_length + 1)
    for a, b_ in zip(pseq.past_payloads.values(), seq.past_payloads.values()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
    with torch.inference_mode():
        got, got_len = pmodel(pseq)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_weights_round_trip_port_to_jax_exactly(tmp_path):
    jcfg, pcfg = _configs(["model.encoder.num_heads=2"])
    _, params = _jax_model(jcfg, seed=3)
    pmodel = pt_build_model(pcfg, device="cpu", seed=11)
    # port weights -> the JAX package's own converter -> identical arrays
    back = torch_state_dict_to_params(pmodel.state_dict(), params["params"])
    state = pmodel.state_dict()
    again = params_to_state_dict(_np_tree(back))
    assert again.keys() == state.keys()
    for key, val in state.items():
        np.testing.assert_array_equal(again[key].numpy(), val.numpy())
    # both checkpoint formats load to the same state_dict
    torch.save(state, tmp_path / "model.pt")
    flat = {
        "/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path({"params": back})[0]
    }
    np.savez(tmp_path / "params.npz", **flat)
    for path in ("model.pt", "params.npz"):
        loaded = load_checkpoint(str(tmp_path / path))
        assert loaded.keys() == state.keys()
        for key, val in state.items():
            np.testing.assert_array_equal(loaded[key].numpy(), val.numpy())


def test_model_init_is_seeded_and_padding_row_zero():
    _, pcfg = _configs([])
    a = pt_build_model(pcfg, device="cpu", seed=5).state_dict()
    b = pt_build_model(pcfg, device="cpu", seed=5).state_dict()
    c = pt_build_model(pcfg, device="cpu", seed=6).state_dict()
    for key in a:
        assert torch.equal(a[key], b[key])
    assert not torch.equal(a["embeddings._item_emb.weight"], c["embeddings._item_emb.weight"])
    assert not a["embeddings._item_emb.weight"][0].any()


@pytest.mark.parametrize(
    "override,item",
    [
        ("model.encoder.attn_dropout_rate=0.1", "Training variants"),
        ("model.encoder.tp_shards=2", "Distributed"),
        ("model.encoder.remat=true", "Training variants"),
        ("model.embedding.kind=sharded_a2a", "Distributed"),
        ("model.compute_dtype=bfloat16", "Mixed precision"),
        ("model.embedding.kind=sharded_local", "Distributed"),
        ("model.embedding.kind=sharded_2d", "Distributed"),
    ],
)
def test_unported_kinds_raise_naming_the_roadmap_item(override, item):
    """The knobs that no ported code reads raise, naming the ROADMAP.md item
    that ports them; those ported since build and take a step (remat,
    compute_dtype=bfloat16 with its parameters and output in float32, and
    the sharded embedding kinds, whose table keeps its key and JAX's padded
    shape), build as the plain model (tp_shards on one device) or raise a
    ValueError naming the knob (attention dropout, which the reference
    ignores)."""
    _, pcfg = _configs([override])
    if override.startswith("model.embedding.kind=sharded"):
        pcfg.model.embedding.num_shards = 8
        pcfg.model.embedding.col_shards = 2
        model = pt_build_model(pcfg, device="cpu")
        table = model.embeddings._item_emb.weight
        assert tuple(table.shape) == (-(-(pcfg.model.embedding.num_items + 1) // 8) * 8,
                                      pcfg.model.item_embedding_dim)
        before = table.detach().clone()
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
        batch = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
        seq, _, _ = pt_seq_features(batch, pcfg.model.gr_output_length + 1)
        ids = seq.past_ids.long()
        embedded = model.item_embeddings(ids)
        assert torch.equal(embedded, table[ids])
        encoded, _ = model(seq._replace(past_embeddings=embedded))
        encoded.square().sum().backward()
        opt.step()
        moved = (table.detach() != before).any(-1)
        assert moved[ids.unique()[1:]].all() and not moved[0]
    elif override == "model.compute_dtype=bfloat16":
        model = pt_build_model(pcfg, device="cpu")
        before = {k: v.clone() for k, v in model.named_parameters()}
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
        batch = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
        seq, _, _ = pt_seq_features(batch, pcfg.model.gr_output_length + 1)
        encoded, _ = model(seq._replace(past_embeddings=model.item_embeddings(seq.past_ids)))
        assert encoded.dtype == torch.float32
        encoded.square().sum().backward()
        opt.step()
        for name, p in model.named_parameters():
            assert p.dtype == torch.float32, name
            assert not torch.equal(p, before[name]), name
    elif override == "model.encoder.remat=true":
        model = pt_build_model(pcfg, device="cpu")
        assert model.sequence_encoder["_hstu"].remat
        batch = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
        seq, _, _ = pt_seq_features(batch, pcfg.model.gr_output_length + 1)
        encoded, _ = model(seq._replace(past_embeddings=model.item_embeddings(seq.past_ids)))
        encoded.sum().backward()
        assert all(p.grad is not None for p in model.sequence_encoder.parameters())
    elif override == "model.encoder.attn_dropout_rate=0.1":
        with pytest.raises(ValueError, match="encoder.attn_dropout_rate=0.1: the reference"):
            pt_build_model(pcfg, device="cpu")
    elif override == "model.encoder.tp_shards=2":
        # on one device the block is the plain one (its matmuls hold the K
        # column blocks): the same weights and outputs
        _, plain_cfg = _configs([])
        model, plain = pt_build_model(pcfg, device="cpu"), pt_build_model(plain_cfg, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
        seq, _, _ = pt_seq_features(batch, pcfg.model.gr_output_length + 1)
        outs = []
        for m in (model, plain):
            assert all(block.tp is None for block in m.sequence_encoder["_hstu"]._attention_layers)
            outs.append(m(seq._replace(past_embeddings=m.item_embeddings(seq.past_ids)))[0])
        assert torch.equal(*outs)
    else:
        with pytest.raises(NotImplementedError, match=item):
            pt_build_model(pcfg, device="cpu")


@pytest.mark.parametrize("override", [
    "model.encoder.kind=sasrec",
    "model.encoder.normalization=softmax_rel_bias",
    "model.postprocessor.kind=layer_norm",
    "model.similarity.kind=mol",
])
def test_model_kinds_that_raised_before_build_and_take_a_step(override):
    """The knobs that raised before SASRec, softmax_rel_bias, the layer_norm
    postprocessor and MoL were ported: the model builds, and one AdamW step
    on a loss of its output moves every parameter that has a gradient (MoL's
    are the loss's, not the forward's)."""
    _, pcfg = _configs([override])
    model = pt_build_model(pcfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
    seq, _, _ = pt_seq_features(batch, pcfg.model.gr_output_length + 1)
    before = {k: v.clone() for k, v in model.named_parameters()}
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    encoded, _ = model(seq._replace(past_embeddings=model.item_embeddings(seq.past_ids)))
    (encoded * torch.randn(encoded.shape, generator=torch.Generator().manual_seed(0))
     ).sum().backward()
    opt.step()
    assert torch.isfinite(encoded).all()
    moved = [name for name, p in model.named_parameters() if not torch.equal(p, before[name])]
    assert moved == [name for name, p in model.named_parameters()
                     if p.grad is not None and p.grad.abs().max() > 0]


def test_use_pallas_false_raises_instead_of_a_second_attention_path():
    # the port has one attention path, the fused wrapper; "auto" and true take it
    for value in ("auto", "true"):
        _, pcfg = _configs([f"model.encoder.use_pallas={value}"])
        pt_build_model(pcfg, device="cpu")
    _, pcfg = _configs(["model.encoder.use_pallas=false"])
    with pytest.raises(ValueError, match="use_pallas"):
        pt_build_model(pcfg, device="cpu")
