"""The aux user-feature preprocessor of the PyTorch port and the data's user
columns, against the JAX package, on the CPU.

The preprocessor alone on numpy inputs (onehot, embed and numeric columns:
lengths, the token and the shifted items, the masks and the shifted
payloads); the aux model's forward, loss and every gradient, and three AdamW
steps, on synthetic-aux-smoke's data with the JAX weights carried across
(tests/torch_port_families.py); the synthetic user columns and the loader's
batches against the JAX package's files and loader; the out-of-range raise
beside the JAX package's silent NaN / zero row; the optimizer labels of the
new parameters against JAX's; the serving and generation raises;
`cli.train` on synthetic-aux-smoke.

Tolerances: the preprocessor's embeddings at atol 1e-6, masks, lengths and
payloads exactly; the forward at rtol 2e-4 / atol 2e-5; the loss at rtol
1e-5, every gradient at rtol 2e-4 / atol 2e-6, the parameters after three
steps at atol 2e-5 (tests/test_torch_port_train_step.py's).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mygenerativerecommenders_tpu.configs.presets import get_preset as jax_preset
from mygenerativerecommenders_tpu.data.dataset import BatchLoader as JaxBatchLoader
from mygenerativerecommenders_tpu.data.dataset import RecoData as JaxRecoData
from mygenerativerecommenders_tpu.models import preprocessors as jax_pre
from mygenerativerecommenders_tpu.utils.features import seq_features_from_batch as jax_features
from mygenerativerecommenders_tpu_torch.checkpoint import params_to_state_dict
from mygenerativerecommenders_tpu_torch.cli import train as cli_train
from mygenerativerecommenders_tpu_torch.configs.presets import get_preset as pt_preset
from mygenerativerecommenders_tpu_torch.data.dataset import BatchLoader, RecoData
from mygenerativerecommenders_tpu_torch.data.preprocessor import write_csv
from mygenerativerecommenders_tpu_torch.models import preprocessors as pt_pre
from mygenerativerecommenders_tpu_torch.models.decode import check_decodable
from mygenerativerecommenders_tpu_torch.serving.service import ServingEngine
from mygenerativerecommenders_tpu_torch.train.driver import Trainer
from mygenerativerecommenders_tpu_torch.utils.features import seq_features_from_batch
from tests import torch_port_families as fam
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

COLUMNS = ("sex", "age_group", "occupation", "zip_code")


def _preprocessors(enc, b=3, n=9, d=8, seed=0):
    """Both packages' aux preprocessor over two columns of `enc`, with the
    JAX weights in the port, and one set of numpy inputs."""
    rng = np.random.default_rng(seed)
    cols, dims, emb_dims = ("a", "b"), (3, 5), (4, 6)
    lengths = np.array([4, 1, 7][:b], dtype=np.int32)
    ids = np.zeros((b, n), dtype=np.int32)
    for i, length in enumerate(lengths):
        ids[i, :length + 1] = rng.integers(1, 50, size=length + 1)  # history + target
    payloads = {
        "timestamps": (ids > 0) * rng.integers(1, 10**6, size=(b, n)).astype(np.int32),
        "ratings": (ids > 0) * rng.integers(1, 6, size=(b, n)).astype(np.int32),
        "a": rng.integers(0, 3, size=b).astype(np.int32),
        "b": rng.integers(0, 5, size=b).astype(np.int32),
    }
    emb = rng.normal(size=(b, n, d)).astype(np.float32) * (ids > 0)[..., None]
    kw = dict(auxiliary_columns=cols, encoding_types=(enc, enc), categorical_dims=dims,
              categorical_embedding_dims=emb_dims)
    jpre = jax_pre.LearnablePositionalEmbeddingAuxPreprocessor(
        max_sequence_len=n, embedding_dim=d, dropout_rate=0.0, **kw)
    jargs = (jnp.asarray(lengths), jnp.asarray(ids), jnp.asarray(emb),
             {k: jnp.asarray(v) for k, v in payloads.items()})
    params = jpre.init(jax.random.PRNGKey(seed), *jargs)
    ppre = pt_pre.LearnablePositionalEmbeddingAuxPreprocessor(
        n, d, cols, (enc, enc), dims, emb_dims)
    state = params_to_state_dict({"preprocessor": fam.np_tree(params["params"])})
    ppre.load_state_dict({k[len("preprocessor."):]: v for k, v in state.items()})
    pargs = (torch.from_numpy(lengths), torch.from_numpy(ids), torch.from_numpy(emb),
             {k: torch.from_numpy(v) for k, v in payloads.items()})
    return jpre, params, jargs, ppre, pargs


@pytest.mark.parametrize("enc", ["onehot", "embed", "numeric"])
def test_aux_preprocessor_outputs_match_jax(enc):
    jpre, params, jargs, ppre, pargs = _preprocessors(enc)
    want = jpre.apply(params, *jargs)
    with torch.no_grad():
        got = ppre(*pargs)
    lengths, emb, valid, aux_mask, payloads = got
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(emb.numpy(), np.asarray(want[1]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(aux_mask.numpy(), np.asarray(want[3]))
    assert payloads.keys() == want[4].keys()
    for key in payloads:
        np.testing.assert_array_equal(payloads[key].numpy(), np.asarray(want[4][key]), key)
    # the token at position 0 is unit length before the positional row is added
    with torch.no_grad():
        token = ppre.encode(pargs[3], torch.float32)
    np.testing.assert_allclose(token.norm(dim=-1).numpy(), 1.0, rtol=1e-5)
    assert (payloads["ratings"][:, 0] == -1).all() and (payloads["timestamps"][:, 0] == 0).all()


def test_aux_model_forward_loss_and_every_gradient_match_jax():
    s = fam.shared("synthetic-aux-smoke")
    batch = s.batches[0]
    max_out = s.jcfg.model.gr_output_length + 1
    want, want_lengths = s.jmodel.apply(s.params, jax_features(batch, max_out)[0])
    seq, _, _ = seq_features_from_batch(fam.torch_batch(batch), max_out)
    with torch.no_grad():
        got, lengths = s.pmodel(seq._replace(past_embeddings=s.pmodel.item_embeddings(seq.past_ids)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(want_lengths))
    fam.compare_loss_and_grads(s, batch, jax.random.fold_in(jax.random.PRNGKey(7), 0),
                               expect="loss_fn_dense")


def test_three_adamw_steps_of_the_aux_model_match_jax():
    fam.compare_three_adamw_steps(fam.setup("synthetic-aux-smoke"))


def test_param_labels_of_the_aux_preprocessor_equal_jax():
    got = fam.check_param_labels(fam.shared("synthetic-aux-smoke"))
    assert got["preprocessor.aux_projection.kernel"] == "primary"
    assert got["preprocessor.aux_emb_zip_code"] == "primary"


def test_synthetic_user_columns_equal_the_jax_files(tmp_path):
    """The JAX package writes its synthetic draw, user columns included, to
    sasrec_format.csv; the port's in-memory draw formats to the same bytes,
    and its splits carry the same int32 columns."""
    jcfg, pcfg = jax_preset("synthetic-aux-smoke"), pt_preset("synthetic-aux-smoke")
    jcfg.data.data_dir = str(tmp_path)
    jdata, pdata = JaxRecoData(jcfg.data, seed=42), RecoData(pcfg.data, seed=42)
    header, rows = pdata.sequence_table()
    write_csv(tmp_path / "port.csv", header, rows)
    assert (tmp_path / "port.csv").read_bytes() == open(
        jdata.processor.output_format_csv(), "rb").read()
    frame = pd.read_csv(jdata.processor.output_format_csv())
    for col in COLUMNS:
        np.testing.assert_array_equal(pdata.interactions.users[col], frame[col].to_numpy())
    for split in ("train", "test"):
        want, got = jdata.dataset(split).additional, pdata.dataset(split).additional
        assert sorted(got) == sorted(want) == sorted(COLUMNS)
        for col in COLUMNS:
            assert got[col].dtype == np.int32
            np.testing.assert_array_equal(got[col], want[col], err_msg=col)


@pytest.mark.parametrize("buckets", [None, [8, 16, 32]])
def test_loader_batches_carry_the_user_columns_as_jax_does(tmp_path, buckets):
    jcfg, pcfg = jax_preset("synthetic-aux-smoke"), pt_preset("synthetic-aux-smoke")
    jcfg.data.data_dir = str(tmp_path)
    jds = JaxRecoData(jcfg.data, seed=42).dataset("train")
    pds = RecoData(pcfg.data, seed=42).dataset("train")
    jl = JaxBatchLoader(jds, 24, shuffle=True, seed=3, buckets=buckets)
    pl = BatchLoader(pds, 24, shuffle=True, seed=3, buckets=buckets)
    jl.epoch = pl.epoch = 1
    got, want = list(pl), list(jl)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and set(COLUMNS) <= g.keys()
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_out_of_range_code_raises_naming_the_column_where_jax_gives_nan_and_zero_rows(tmp_path):
    # the port: at set-up, on the host, naming the column, its largest code
    # and the table size (the synthetic zip codes run to 99)
    args = ["experiment=synthetic-aux-smoke", "trainer.device=cpu",
            f"trainer.output_dir={tmp_path}"]
    for enc in ("embed", "onehot"):
        cfg = cli_train.parse_args(args + ["model.preprocessor.categorical_dims=[2,7,21,50]",
                                           f'model.preprocessor.encoding_types=["onehot",'
                                           f'"onehot","onehot","{enc}"]'])
        with pytest.raises(ValueError, match=r"'zip_code' \(" + enc + r"\).*largest 99.*50 rows"):
            Trainer(cfg)
    # the JAX package: no error; `jnp.take` gives the embed column a NaN row,
    # `one_hot` gives the onehot column a zero row
    for enc in ("embed", "onehot"):
        jpre, params, (lengths, ids, emb, payloads), _, _ = _preprocessors(enc)
        out = jpre.apply(params, lengths, ids, emb, {**payloads, "b": payloads["b"].at[0].set(9)})
        token = np.asarray(out[1])[0, 0]
        if enc == "embed":
            assert np.isnan(token).all()
        else:
            assert np.isfinite(token).all()
            assert not np.asarray(jax.nn.one_hot(jnp.asarray([9]), 5)).any()


def test_aux_model_is_not_served_and_not_decoded():
    s = fam.shared("synthetic-aux-smoke")
    with pytest.raises(ValueError, match="learnable_positional_aux"):
        ServingEngine(s.pmodel, s.pcfg, s.item_ids, int(s.item_ids.max()), device="cpu")
    with pytest.raises(ValueError, match="model.preprocessor.kind"):
        check_decodable(s.pcfg.model)


def test_synthetic_aux_smoke_trains_through_cli_for_two_epochs(tmp_path, one_torch_thread):
    out = tmp_path / "out"
    cli_train.main(["experiment=synthetic-aux-smoke", "trainer.device=cpu",
                    "trainer.max_epochs=2", "trainer.min_epochs=2",
                    "trainer.log_every_n_steps=1", f"trainer.output_dir={out}"])
    run = out / "synthetic-aux-smoke"
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert len(losses) > 2 and np.isfinite(losses).all() and losses[-1] < losses[0]
    assert any("test/ndcg@10" in r for r in rows)
    assert (run / "checkpoints" / "best.pt").exists() and (run / "checkpoints" / "last.pt").exists()
