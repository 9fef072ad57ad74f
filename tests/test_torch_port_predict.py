"""`Trainer.predict`, `cli.predict`, reference `.ckpt` loading and
`cli.convert_ckpt` of the port against the JAX package, on the CPU.

predict: both trainers read one processed ml-1m fixture (the port's files,
which the JAX trainer takes as its own) with the same weights (the port's,
through the JAX package's `torch_state_dict_to_params`); padded (the port in
k-batch calls, the JAX package batch by batch), packed (the segments
regrouped into dataset order) and with the int8 index. The scores agree at
rtol 2e-4 / atol 2e-5 and the ids are equal but where two scores within
that tolerance swap (`topk_agree`, as the port's eval tests break ties).

`.ckpt`: a Lightning-style file written here (`state_dict` under `model.`,
`epoch`, `hyper_parameters`) loads into the port with `weights_only=True`;
its forward equals the JAX model's with the params that JAX's
`torch_state_dict_to_params` gives, at rtol 1e-4 / atol 1e-5 (the model
tests' tolerance). A missing, extra or misshapen key raises naming it.
"""

import argparse
import csv

import jax
import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.cli.convert_ckpt import torch_state_dict_to_params
from mygenerativerecommenders_tpu.configs import apply_overrides as jax_overrides
from mygenerativerecommenders_tpu.configs.presets import get_preset as jax_preset
from mygenerativerecommenders_tpu.train.driver import Trainer as JaxTrainer
from mygenerativerecommenders_tpu.utils.features import seq_features_from_batch as jax_features
from mygenerativerecommenders_tpu_torch.checkpoint import load_checkpoint, load_weights
from mygenerativerecommenders_tpu_torch.cli import convert_ckpt, predict
from mygenerativerecommenders_tpu_torch.cli.train import parse_args
from mygenerativerecommenders_tpu_torch.models.model import build_model as pt_build_model
from mygenerativerecommenders_tpu_torch.ops.topk import topk_agree
from mygenerativerecommenders_tpu_torch.train.driver import Trainer
from mygenerativerecommenders_tpu_torch.utils.features import seq_features_from_batch
from tests.test_torch_port_model import _batch, _configs, _jax_model
from tests.torch_port_real_files import write_ml1m_zip
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL, ATOL = 2e-4, 2e-5
SMALL = [
    "data.max_sequence_length=32", "model.item_embedding_dim=16", "data.batch_size=8",
    "model.loss.num_to_sample=16", "model.index.k=20", "model.metrics.at_k_list=[5,10,20]",
]
VARIANTS = {
    "padded": [],
    "packed": ["data.pack_sequences=true", "data.pack_eval=true"],
    "int8": ["model.index.quantize=int8"],
}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("ml1m")
    write_ml1m_zip(root, num_users=44, seed=6)
    return root


def _port_args(data_dir, out, variant):
    return ["experiment=ml-1m-hstu", f"data.data_dir={data_dir}", "trainer.device=cpu",
            f"trainer.output_dir={out}", *SMALL, *VARIANTS[variant]]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_predict_matches_jax(data_dir, tmp_path, variant):
    pcfg = parse_args(_port_args(data_dir, tmp_path / "p", variant))
    trainer = Trainer(pcfg)  # processes the raw files (once for the module)
    assert trainer.steps_per_call == 8  # the k-batch eval form
    assert trainer._eval_packed == (variant == "packed")
    got = trainer.predict()

    jcfg = jax_preset("ml-1m-hstu")
    jax_overrides(jcfg, [f"data.data_dir={data_dir}", f"trainer.output_dir={tmp_path / 'j'}",
                           "model.encoder.use_pallas=false", *SMALL, *VARIANTS[variant]])
    jtrainer = JaxTrainer(jcfg)
    try:
        assert jtrainer.data.max_item_id == trainer.data.max_item_id == 3952
        params = dict(jtrainer.params)
        params["params"] = torch_state_dict_to_params(
            trainer.model.state_dict(), jtrainer.params["params"])
        jtrainer.params = params
        want = jtrainer.predict()
    finally:
        jtrainer.close()
    n = len(trainer.data.dataset("test"))
    assert len(got["top_k_ids"]) == len(want["top_k_ids"]) == n == 44
    np.testing.assert_allclose(np.asarray(got["top_k_scores"]),
                               np.asarray(want["top_k_scores"]), rtol=RTOL, atol=ATOL)
    problem = topk_agree(got["top_k_ids"], got["top_k_scores"], want["top_k_ids"],
                         want["top_k_scores"], atol=RTOL)
    assert problem is None, problem


def test_packed_predict_gives_the_padded_rows_in_dataset_order(data_dir, tmp_path):
    padded = Trainer(parse_args(_port_args(data_dir, tmp_path / "a", "padded"))).predict()
    packed = Trainer(parse_args(_port_args(data_dir, tmp_path / "b", "packed"))).predict()
    np.testing.assert_allclose(np.asarray(packed["top_k_scores"]),
                               np.asarray(padded["top_k_scores"]), rtol=RTOL, atol=ATOL)
    problem = topk_agree(packed["top_k_ids"], packed["top_k_scores"], padded["top_k_ids"],
                         padded["top_k_scores"], atol=RTOL)
    assert problem is None, problem


def test_cli_predict_writes_the_sequence_csv_with_top_k(data_dir, tmp_path):
    args = _port_args(data_dir, tmp_path, "padded") + ["data.length_buckets=[8,16,32]"]
    trainer = Trainer(parse_args(args))
    ckpt = tmp_path / "model.pt"
    torch.save(trainer.model.state_dict(), ckpt)
    out = predict.main(args + [f"trainer.ckpt_path={ckpt}"])
    with open(out, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    seq = data_dir / "processed" / "ml-1m" / "sasrec_format.csv"
    with open(seq, newline="", encoding="utf-8") as f:
        source = list(csv.reader(f))
    assert rows[0] == source[0] + ["top_k_ids", "top_k_scores"]
    assert [r[:-2] for r in rows[1:]] == source[1:]  # every user, in the file's order
    # length buckets reorder the batches; the rows still follow the file
    want = Trainer(parse_args(_port_args(data_dir, tmp_path / "ref", "padded"))).predict()
    catalog = set(trainer.data.all_item_ids.tolist())
    for row, ids in zip(rows[1:], want["top_k_ids"]):
        got = eval(row[-2])  # a Python-list string, as the JAX package writes it
        assert len(got) == 20 and set(got) <= catalog
        assert got[:5] == ids[:5]


def _lightning_ckpt(path, state, hyper_parameters):
    torch.save({"state_dict": {f"model.{k}": v for k, v in state.items()}, "epoch": 7,
                "global_step": 123, "hyper_parameters": hyper_parameters}, path)


def test_reference_ckpt_loads_and_its_forward_matches_jax(tmp_path):
    jcfg, pcfg = _configs(["model.encoder.num_heads=2"])
    jmodel, init = _jax_model(jcfg, seed=5)
    source = pt_build_model(pcfg, device="cpu", seed=9)
    path = tmp_path / "ref.ckpt"
    _lightning_ckpt(path, source.state_dict(), {"lr": 1e-3, "item_embedding_dim": 16})
    pmodel = pt_build_model(pcfg, device="cpu", seed=1)
    load_weights(pmodel, str(path))
    for key, value in source.state_dict().items():
        assert torch.equal(pmodel.state_dict()[key], value), key

    ckpt = torch.load(path, weights_only=True)
    params = {"params": torch_state_dict_to_params(ckpt["state_dict"], init["params"])}
    batch = _batch(2)
    seq, _, _ = jax_features(batch, jcfg.model.gr_output_length + 1)
    want, _ = jmodel.apply(params, seq, deterministic=True)
    pseq, _, _ = seq_features_from_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                                         pcfg.model.gr_output_length + 1)
    with torch.inference_mode():
        got, _ = pmodel(pseq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_convert_ckpt_takes_a_lightning_file_that_holds_objects(tmp_path):
    """`hyper_parameters` holding a Namespace: `weights_only=True` refuses
    it, and the error names cli.convert_ckpt, whose `.pt` cli.eval reads."""
    args = ["experiment=synthetic-smoke", f"data.data_dir={tmp_path}", "trainer.device=cpu",
            f"trainer.output_dir={tmp_path / 'out'}"]
    trainer = Trainer(parse_args(args))
    path = tmp_path / "ref.ckpt"
    _lightning_ckpt(path, trainer.model.state_dict(), argparse.Namespace(lr=1e-3))
    with pytest.raises(ValueError, match="convert_ckpt"):
        load_checkpoint(str(path))
    out = convert_ckpt.main([str(path), str(tmp_path / "model.pt"), *args[:2]])
    state = torch.load(out, weights_only=True)
    assert state.keys() == trainer.model.state_dict().keys()
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(state[key], value), key
    want = trainer.test()
    assert Trainer(parse_args(args)).test(out) == want


def test_missing_extra_or_misshapen_keys_raise_naming_the_key(tmp_path):
    jcfg, pcfg = _configs([])
    _, init = _jax_model(jcfg)
    model = pt_build_model(pcfg, device="cpu")
    good = model.state_dict()
    victim = "sequence_encoder._hstu._attention_layers.1._o.bias"
    cases = {
        "missing": ({k: v for k, v in good.items() if k != victim}, ValueError, victim),
        "extra": ({**good, "loss.scale": torch.ones(1)}, ValueError, "loss.scale"),
        "shape": ({**good, victim: torch.zeros(3)}, ValueError, victim),
        "year table": ({**good, "embeddings._year_emb.weight": torch.zeros(4, 16)},
                       ValueError, "embedding.kind=item_year"),
    }
    for name, (state, error, words) in cases.items():
        path = tmp_path / f"{name.replace(' ', '_')}.ckpt"
        _lightning_ckpt(path, state, {})
        with pytest.raises(error, match=words):
            load_weights(pt_build_model(pcfg, device="cpu"), str(path))
    # the JAX package's converter fills a missing key with its fresh init
    # without a word (ROADMAP.md queue 3)
    state = {k: v for k, v in good.items() if k != victim}
    filled = torch_state_dict_to_params(state, init["params"])
    np.testing.assert_array_equal(np.asarray(filled["encoder"]["block_1"]["o"]["bias"]),
                                  np.asarray(init["params"]["encoder"]["block_1"]["o"]["bias"]))
    assert jax.tree_util.tree_structure(filled) == jax.tree_util.tree_structure(init["params"])
