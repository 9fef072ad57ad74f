"""`data.length_buckets` in the PyTorch port, on the CPU: the bucketed
`BatchLoader` against the JAX package's, batch for batch from the same seed
(JAX data/dataset.py:192-251, 279-318), a bucketed batch's loss and gradients
against the JAX loss at the narrower sequence width, and a bucketed fit in
calls of several steps (the trainer's k-step calls flush at each change of
shape, as the JAX stacker does).

Tolerances are those of tests/test_torch_port_train_step.py: the loss at
rtol 1e-5, every gradient at rtol 2e-4 / atol 2e-6; the batches exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.configs import resolve as jax_resolve
from mygenerativerecommenders_tpu.configs.presets import get_preset as jax_preset
from mygenerativerecommenders_tpu.data.dataset import BatchLoader as JaxBatchLoader
from mygenerativerecommenders_tpu.data.dataset import RecoData as JaxRecoData
from mygenerativerecommenders_tpu.data.dataset import SequenceDataset as JaxSequenceDataset
from mygenerativerecommenders_tpu.models.model import build_model as jax_build_model
from mygenerativerecommenders_tpu.train import task_retrieval as jax_task
from mygenerativerecommenders_tpu.utils.features import seq_features_from_batch as jax_features
from mygenerativerecommenders_tpu_torch.checkpoint import grads_to_state_dict, params_to_state_dict
from mygenerativerecommenders_tpu_torch.cli import train as cli_train
from mygenerativerecommenders_tpu_torch.configs import resolve as pt_resolve
from mygenerativerecommenders_tpu_torch.configs.presets import get_preset as pt_preset
from mygenerativerecommenders_tpu_torch.data.dataset import BatchLoader, RecoData, SequenceDataset
from mygenerativerecommenders_tpu_torch.models.model import build_model as pt_build_model
from mygenerativerecommenders_tpu_torch.train import task_retrieval as pt_task
from mygenerativerecommenders_tpu_torch.train.driver import Trainer
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

BUCKETS = (8, 16, 32)  # synthetic-smoke: histories of up to 32


def _toy_arrays(n=50, max_len=64, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, max_len + 1, size=n).astype(np.int32)
    ids = np.zeros((n, max_len), dtype=np.int32)
    for i, length in enumerate(lengths):
        ids[i, :length] = rng.integers(1, 100, size=length)
    return dict(
        lengths=lengths,
        ids=ids,
        ratings=np.ones_like(ids),
        timestamps=np.cumsum(np.ones_like(ids), axis=1).astype(np.int32) * (ids != 0),
        target_id=rng.integers(1, 100, size=n).astype(np.int32),
        target_rating=np.ones(n, dtype=np.int32),
        target_timestamp=np.full(n, 999, dtype=np.int32),
        user_ids=np.arange(n),
    )


def _assert_same_batches(got_loader, want_loader, epochs=2):
    assert len(got_loader) == len(want_loader)
    for epoch in range(epochs):  # the permutation follows seed + epoch
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) == len(got_loader)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.keys() == w.keys()
            for key in w:
                np.testing.assert_array_equal(g[key], w[key], err_msg=f"epoch {epoch} batch {i} {key}")


@pytest.mark.parametrize("bs,shuffle,buckets", [
    (8, True, [16, 32, 64]), (4, True, [64, 16, 32]), (16, False, [32, 64]), (50, True, [64]),
])
def test_bucketed_loader_yields_the_jax_loaders_batches(bs, shuffle, buckets):
    arrays = _toy_arrays()
    ours = BatchLoader(SequenceDataset(**arrays), bs, shuffle=shuffle, seed=7, buckets=buckets)
    theirs = JaxBatchLoader(
        JaxSequenceDataset(**arrays, additional={}), bs, shuffle=shuffle, seed=7, buckets=buckets
    )
    _assert_same_batches(ours, theirs)


@pytest.mark.parametrize("split", ["train", "val"])
def test_recodata_length_buckets_give_the_jax_batches(tmp_path, split):
    jcfg, pcfg = jax_preset("synthetic-smoke"), pt_preset("synthetic-smoke")
    jcfg.data.data_dir = str(tmp_path)
    for cfg in (jcfg, pcfg):
        cfg.data.length_buckets = BUCKETS
    jdata, pdata = JaxRecoData(jcfg.data, seed=42), RecoData(pcfg.data, seed=42)
    ploader = pdata.loader(split)
    assert ploader.buckets == list(BUCKETS)
    _assert_same_batches(ploader, jdata.loader(split))


def test_bucketed_loader_covers_every_example_once_in_runs_of_one_shape():
    arrays = _toy_arrays(n=37)
    loader = BatchLoader(SequenceDataset(**arrays), 4, shuffle=True, seed=3, buckets=[16, 32, 64])
    seen, caps = [], []
    for batch in loader:
        cap = batch["ids"].shape[1]
        valid = batch["sample_weight"] > 0
        assert cap in (16, 32, 64) and np.all(batch["lengths"][valid] <= cap)
        if cap != 16:  # the history fits this bucket and no smaller one
            assert np.all(batch["lengths"][valid] > cap // 2)
        seen.extend(batch["target_id"][valid].tolist())
        if not caps or caps[-1] != cap:
            caps.append(cap)
    assert sorted(seen) == sorted(arrays["target_id"].tolist())
    assert len(caps) == len(set(caps))  # each capacity in one run


def test_bucketed_loader_rejects_a_largest_bucket_below_the_longest_history():
    with pytest.raises(ValueError, match="length_buckets"):
        BatchLoader(SequenceDataset(**_toy_arrays(max_len=64)), 8, buckets=[16, 32])


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_a_narrow_bucket_batch_gives_the_jax_loss_and_gradients():
    """A batch of the 8-wide bucket (N = 8 + 11 = 19 against the model's 43)
    through both packages, the same weights and negatives, dropout off."""
    jcfg, pcfg = jax_preset("synthetic-smoke"), pt_preset("synthetic-smoke")
    jcfg.model.encoder.use_pallas = "false"
    for cfg in (jcfg, pcfg):
        cfg.model.preprocessor.dropout_rate = cfg.model.encoder.linear_dropout_rate = 0.0
        cfg.data.length_buckets = BUCKETS
    data = RecoData(pcfg.data, seed=42)
    jax_resolve(jcfg, data.max_item_id)
    pt_resolve(pcfg, data.max_item_id)
    batch = next(b for b in data.loader("train") if b["ids"].shape[1] == BUCKETS[0])
    item_ids = data.all_item_ids
    jmodel = jax_build_model(jcfg)
    seq, _, _ = jax_features(batch, jcfg.model.gr_output_length + 1)
    key = jax.random.PRNGKey(0)
    params = jmodel.init({"params": key, "dropout": key}, seq, method=jmodel.init_all)
    rng = jax.random.PRNGKey(7)
    jloss = jax_task.make_loss_fn(jmodel, jcfg, item_ids)
    want, want_grads = jax.value_and_grad(jloss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.fold_in(rng, 0)
    )
    want_grads = grads_to_state_dict(_np_tree(want_grads))
    _, neg_rng = jax.random.split(jax.random.fold_in(rng, 0))
    n = BUCKETS[0] + jcfg.model.gr_output_length + 1
    shape = (batch["ids"].shape[0], n - 1, jcfg.model.loss.num_to_sample)
    offsets = torch.from_numpy(np.array(jax.random.randint(neg_rng, shape, 0, len(item_ids))))

    pmodel = pt_build_model(pcfg, device="cpu")
    pmodel.load_state_dict(params_to_state_dict(_np_tree(params)))
    loss = pt_task.make_loss_fn(pmodel, pcfg, item_ids)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, neg_offsets=offsets
    )
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for name, p in pmodel.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), want_grads[name].numpy(), rtol=2e-4, atol=2e-6, err_msg=name
        )


def test_a_bucketed_fit_trains_in_calls_of_several_steps(tmp_path):
    trainer = Trainer(cli_train.parse_args([
        "experiment=synthetic-smoke", "trainer.device=cpu", "trainer.max_epochs=2",
        "data.length_buckets=[8,16,32]", "trainer.steps_per_call=3",
        f"trainer.output_dir={tmp_path / 'out'}",
    ]))
    loader = trainer.data.loader("train")
    shapes = {b["ids"].shape for b in loader}
    assert len(shapes) > 1
    results = trainer.fit()
    assert trainer.global_step == 2 * len(loader)
    assert all(0.0 <= v <= 1.0 for v in results.values())
    path = tmp_path / "out" / "synthetic-smoke" / "metrics.jsonl"
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert losses and np.isfinite(losses).all()
    assert [r["epoch"] for r in rows if "val/ndcg@10" in r] == [0, 1]
