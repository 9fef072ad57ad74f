"""The port's packed loader, features and data shapes against the JAX
package, on the CPU.

The port's `data/packing.py` is numpy only, so its batches must equal the JAX
loader's array for array on the same dataset and seed: every key, several
epochs, train (targets inline) and eval (history-only segments with the
per-segment fields), with one capacity and with capacity classes.
"""

import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.data import dataset as jax_dataset
from mygenerativerecommenders_tpu.data import packing as jax_packing
from mygenerativerecommenders_tpu.utils.features import packed_seq_features as jax_packed_features
from mygenerativerecommenders_tpu_torch.cli.train import parse_args
from mygenerativerecommenders_tpu_torch.configs import resolve as pt_resolve
from mygenerativerecommenders_tpu_torch.data import packing as pt_packing
from mygenerativerecommenders_tpu_torch.data.dataset import RecoData, SequenceDataset
from mygenerativerecommenders_tpu_torch.train import task_retrieval as pt_task
from mygenerativerecommenders_tpu_torch.train.driver import Trainer
from mygenerativerecommenders_tpu_torch.utils.features import packed_seq_features
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _arrays(seed, users=40, l_max=47, num_items=300):
    """Histories of 1 to l_max items (both ends present), padded with 0."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, l_max + 1, size=users).astype(np.int32)
    lengths[:2] = (1, l_max)
    ids = np.zeros((users, l_max), dtype=np.int32)
    ts = np.zeros((users, l_max), dtype=np.int32)
    ratings = np.zeros((users, l_max), dtype=np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(1, num_items, size=n)
        ts[i, :n] = np.sort(rng.integers(1000, 10**6, size=n))
        ratings[i, :n] = rng.integers(1, 6, size=n)
    return dict(
        lengths=lengths, ids=ids, ratings=ratings, timestamps=ts,
        target_id=rng.integers(1, num_items, size=users).astype(np.int32),
        target_rating=rng.integers(1, 6, size=users).astype(np.int32),
        target_timestamp=(ts.max(axis=1) + 10).astype(np.int32),
        user_ids=np.arange(users, dtype=np.int64),
    )


def _both_datasets(seed):
    arrays = _arrays(seed)
    return jax_dataset.SequenceDataset(**arrays, additional={}), SequenceDataset(**arrays)


@pytest.mark.parametrize("include_target", [True, False])
@pytest.mark.parametrize(
    "kwargs",
    [
        dict(rows_per_batch=4, row_capacity=64),
        dict(rows_per_batch=3, row_capacity=48, capacities=(16, 32, 48), segments_per_batch=8),
        dict(rows_per_batch=5, row_capacity=48, capacities=(24, 48)),  # constant tokens a batch
    ],
)
def test_packed_loader_batches_equal_the_jax_loader(include_target, kwargs):
    jds, pds = _both_datasets(0)
    common = dict(shuffle=include_target, seed=3, include_target=include_target, **kwargs)
    want_loader = jax_packing.PackedBatchLoader(jds, **common)
    got_loader = pt_packing.PackedBatchLoader(pds, **common)
    assert got_loader.rows_of == want_loader.rows_of
    if not include_target:
        assert got_loader.seg_cap == want_loader.seg_cap
    for _ in range(3):  # an epoch's plan follows seed + epoch
        assert len(got_loader) == len(want_loader)
        want, got = list(want_loader), list(got_loader)
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for key in w:
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    keys = {"ids", "ratings", "timestamps", "positions", "seg_ids", "lengths", "num_segments"}
    if not include_target:
        keys |= {"seg_last_flat", "seg_target", "seg_weight", "seg_example", "seg_invalid_ids"}
    assert set(got[0]) == keys


@pytest.mark.parametrize("fn", ["pack_rows", "pack_rows_best_fit"])
def test_row_packers_equal_the_jax_functions(fn):
    seg_lens = np.random.default_rng(1).integers(1, 30, size=200)
    got = getattr(pt_packing, fn)(seg_lens, 64)
    np.testing.assert_array_equal(got, getattr(jax_packing, fn)(seg_lens, 64))
    assert got.dtype == np.int64
    # no row holds more than its capacity
    assert np.bincount(got, weights=seg_lens).max() <= 64


def test_packed_loader_emits_every_example_once_with_its_target_last():
    _, pds = _both_datasets(2)
    loader = pt_packing.PackedBatchLoader(
        pds, rows_per_batch=3, row_capacity=48, capacities=(16, 32, 48), segments_per_batch=8,
        shuffle=True, seed=5,
    )
    seen = []
    for batch in loader:
        for r in range(batch["ids"].shape[0]):
            seg = batch["seg_ids"][r]
            assert int(batch["lengths"][r]) == int((seg >= 0).sum())
            for s in range(int(batch["num_segments"][r])):
                tok = np.where(seg == s)[0]
                assert np.all(np.diff(tok) == 1)
                np.testing.assert_array_equal(batch["positions"][r][tok], np.arange(len(tok)))
                seen.append(tuple(batch["ids"][r][tok]))
    want = [tuple(pds.ids[e, : pds.lengths[e]]) + (pds.target_id[e],) for e in range(len(pds))]
    assert sorted(seen) == sorted(want)


def test_packed_loader_refuses_a_second_process_and_a_segment_longer_than_a_row():
    """A second process, refused before the loaders' process stride was
    ported, now takes its rows of every global batch, JAX's for that process
    (tests/test_torch_port_distributed_loaders.py holds every field); a
    segment longer than the widest row is still refused."""
    jds, pds = _both_datasets(3)
    common = dict(rows_per_batch=4, row_capacity=64, process_index=1, process_count=2)
    got = list(pt_packing.PackedBatchLoader(pds, **common))
    want = list(jax_packing.PackedBatchLoader(jds, **common))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["ids"], w["ids"])
    with pytest.raises(ValueError, match="longest segment"):
        pt_packing.PackedBatchLoader(pds, rows_per_batch=4, row_capacity=40)


@pytest.mark.parametrize("include_target", [True, False])
def test_packed_seq_features_match_jax(include_target):
    _, pds = _both_datasets(4)
    batch = next(iter(pt_packing.PackedBatchLoader(
        pds, rows_per_batch=4, row_capacity=64, include_target=include_target
    )))
    want = jax_packed_features(batch)
    got = packed_seq_features({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_array_equal(got.past_lengths.numpy(), np.asarray(want.past_lengths))
    np.testing.assert_array_equal(got.past_ids.numpy(), np.asarray(want.past_ids))
    assert got.past_embeddings is None and got.past_payloads.keys() == want.past_payloads.keys()
    for key, value in want.past_payloads.items():
        assert got.past_payloads[key].dtype == torch.int32
        np.testing.assert_array_equal(got.past_payloads[key].numpy(), np.asarray(value), err_msg=key)


def _cut(preset, *extra):
    """A preset on synthetic data with its depth cut (few users, one block,
    few examples a batch); the widths stay."""
    return parse_args([
        f"experiment={preset}", "data.dataset_name=synthetic", "trainer.device=cpu",
        "data.synthetic_num_users=24", "data.batch_size=4", "model.encoder.num_blocks=1", *extra,
    ])


def test_ml20m_shape_on_synthetic_data_has_sparse_ids_and_offsets_map_them():
    cfg = _cut("ml-20m-hstu")
    data = RecoData(cfg.data)
    ids = data.all_item_ids
    assert len(ids) == 26744 and data.max_item_id == 131262
    assert ids.min() >= 1 and ids.max() <= 131262 and len(np.unique(ids)) == 26744
    assert ids.max() - ids.min() + 1 > len(ids)  # not contiguous: the table path
    to_offsets = pt_task.make_ids_to_offsets(ids, torch.device("cpu"))
    outside = np.setdiff1d(np.arange(1, 200), ids)[:2]
    probe = torch.tensor([0, int(ids[0]), int(ids[12345]), int(ids[-1]), *outside, 131263])
    np.testing.assert_array_equal(
        to_offsets(probe).numpy(), [-1, 0, 12345, 26743, -1, -1, -1]
    )
    train = data.dataset("train")
    assert train.ids.shape == (24, 200) and np.isin(train.ids[train.ids > 0], ids).all()


@pytest.mark.parametrize(
    "preset,extra,packed,eval_packed,caps,total_len,heads,dim",
    [
        ("ml-20m-hstu", (), False, False, None, 211, 2, 50),
        ("ml-20m-hstu-long", ("data.synthetic_max_seq_len=1200",), True, True,
         {256, 512, 1024, 1152}, 1035, 2, 64),
        ("ml-1m-hstu-packed", (), True, False, {256}, 211, 1, 50),
    ],
)
def test_presets_resolve_and_build_on_the_cpu_at_reduced_depth(
    tmp_path, preset, extra, packed, eval_packed, caps, total_len, heads, dim
):
    cfg = _cut(preset, f"trainer.output_dir={tmp_path}", *extra)
    trainer = Trainer(cfg)
    assert trainer._packed == packed and trainer._eval_packed == eval_packed
    assert (trainer.packed_eval_step is not None) == eval_packed
    model = trainer.model
    block = model.sequence_encoder["_hstu"]._attention_layers[0]
    assert block.max_attn_len == total_len and block.num_heads == heads
    assert model.embeddings._item_emb.weight.shape == (cfg.data.expected_max_item_id + 1, dim)
    assert block._rel_attn_bias._pos_w.shape == (2 * total_len - 1,)
    assert model.preprocessor._pos_emb.weight.shape == (total_len, dim)
    train_loader = trainer._loader("train", packed=packed)
    batches = list(train_loader)
    assert sum(
        int(b["num_segments"].sum() if packed else b["sample_weight"].sum()) for b in batches
    ) == 24
    if packed:
        assert {b["ids"].shape[1] for b in batches} <= caps
        assert all(b["lengths"].max() <= b["ids"].shape[1] for b in batches)
        if preset == "ml-20m-hstu-long":
            # a history cut to the newest 1,024 items needs the widest class
            assert max(b["ids"].shape[1] for b in batches) == 1152 > total_len
    val_loader = trainer._loader("val", packed=eval_packed)
    assert getattr(val_loader, "include_target", None) == (False if eval_packed else None)


def test_packed_loss_needs_the_positional_hstu_retrieval_model():
    cfg = parse_args(["experiment=synthetic-smoke", "trainer.device=cpu"])
    pt_resolve(cfg, 220)
    cfg.model.encoder.sp_shards = 2
    with pytest.raises(ValueError, match="data.pack_sequences requires"):
        pt_task._check_packable(cfg)
