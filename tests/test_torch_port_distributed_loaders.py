"""The loaders' process stride against the JAX package's, on the CPU.

Pure numpy, in one process: at 2 and 3 processes, over an odd number of
examples and a few epochs, every process's batches from the port's padded,
length-bucketed, packed-train and packed-eval loaders equal the JAX loader's
for that process, array for array (the -1 pad rows of the shorter shares,
the global bucket and packing plans, the empty packed tail batch, the eval's
segment slots from the global plan).
"""

import numpy as np
import pytest

from mygenerativerecommenders_tpu.data import dataset as jax_dataset
from mygenerativerecommenders_tpu.data import packing as jax_packing
from mygenerativerecommenders_tpu_torch.data import packing as pt_packing
from mygenerativerecommenders_tpu_torch.data.dataset import BatchLoader, SequenceDataset

EXAMPLES = 41  # odd: the processes' shares differ


def _arrays(users=EXAMPLES, l_max=47, num_items=300, seed=5):
    """Histories of 1 to l_max items, padded with 0."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, l_max + 1, size=users).astype(np.int32)
    lengths[:2] = (1, l_max)
    ids = np.zeros((users, l_max), dtype=np.int32)
    ts = np.zeros((users, l_max), dtype=np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(1, num_items, size=n)
        ts[i, :n] = np.sort(rng.integers(1000, 10**6, size=n))
    return dict(
        lengths=lengths, ids=ids, ratings=(ids % 5 + 1) * (ids > 0), timestamps=ts,
        target_id=rng.integers(1, num_items, size=users).astype(np.int32),
        target_rating=rng.integers(1, 6, size=users).astype(np.int32),
        target_timestamp=(ts.max(axis=1) + 10).astype(np.int32),
        user_ids=np.arange(users, dtype=np.int64),
    )


def _datasets():
    arrays = _arrays()
    return jax_dataset.SequenceDataset(**arrays, additional={}), SequenceDataset(**arrays)


def _assert_same_batches(got_loader, want_loader, epochs, index=0):
    """-> the port loader's batches of every epoch compared. A packed eval
    segment's query index (`seg_last_flat`) addresses the rank's own rows in
    the port, where JAX's addresses the stitched global batch, process
    `index`'s rows at [index * P, (index + 1) * P): it is compared shifted."""
    seen = []
    for epoch in range(epochs):  # the permutation follows seed + epoch
        n = len(got_loader)  # the epoch's, before the iteration moves it on
        assert n == len(want_loader)
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) == n
        for i, (g, w) in enumerate(zip(got, want)):
            if "seg_last_flat" in g:
                g = dict(g, seg_last_flat=g["seg_last_flat"] + (
                    index * g["ids"].size * (g["seg_weight"] > 0)).astype(np.int32))
            assert g.keys() == w.keys()
            for key in w:
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=f"epoch {epoch} batch {i} {key}")
        seen += got
    return seen


@pytest.mark.parametrize("count", [2, 3])
@pytest.mark.parametrize("kind", ["padded", "bucketed"])
def test_each_process_gets_the_jax_loaders_batches(kind, count):
    jds, pds = _datasets()
    kwargs = dict(shuffle=True, seed=7, buckets=[16, 32, 47] if kind == "bucketed" else None)
    pads = 0
    for index in range(count):
        got = BatchLoader(pds, 4, process_index=index, process_count=count, **kwargs)
        want = jax_dataset.BatchLoader(jds, 4, process_index=index, process_count=count,
                                       **kwargs)
        batches = _assert_same_batches(got, want, epochs=3)
        pads += sum(int((b["sample_weight"] == 0).sum()) for b in batches)
    assert pads > 0  # the shares' tails hold -1 rows


@pytest.mark.parametrize("count", [2, 3])
@pytest.mark.parametrize("include_target", [True, False])
def test_each_process_gets_the_jax_packed_loaders_batches(include_target, count):
    jds, pds = _datasets()
    common = dict(rows_per_batch=3, row_capacity=48, capacities=(16, 32, 48),
                  segments_per_batch=2, shuffle=include_target, seed=3,
                  include_target=include_target, row_multiple=count, process_count=count)
    empty = 0
    for index in range(count):
        got = pt_packing.PackedBatchLoader(pds, process_index=index, **common)
        want = jax_packing.PackedBatchLoader(jds, process_index=index, **common)
        assert got.rows_of == want.rows_of
        if not include_target:
            assert got.seg_cap == want.seg_cap
        batches = _assert_same_batches(got, want, epochs=2, index=index)
        empty += sum(int(b["num_segments"].sum() == 0) for b in batches)
    assert empty > 0  # a tail batch that leaves a process no row


def test_the_processes_cover_every_example_once_an_epoch():
    """The union of the processes' rows is the dataset, each example once."""
    _, pds = _datasets()
    seen = []
    for index in range(3):
        loader = BatchLoader(pds, 4, shuffle=True, seed=7, process_index=index, process_count=3,
                             with_index=True)
        seen += [int(e) for b in loader for e in b["example"] if e >= 0]
    assert sorted(seen) == list(range(EXAMPLES))
