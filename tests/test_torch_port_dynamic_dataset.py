"""The port's schema-agnostic CSV front end (csv and numpy) against the JAX
package's (pandas), on the same files: every array, key, dtype and batch
equal.

The inputs are JAX's three test inputs (tests/test_dynamic_dataset.py),
written to CSV, and files with what pandas types on its own: a string user
column, empty cells (a missing feature, a missing sequence cell, a missing
user id), a non-numeric feature cell, float features, quoted list cells with
spaces and a boolean column.
"""

from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from mygenerativerecommenders_tpu.data.dynamic_dataset import (
    DynamicSequenceDataset as JaxDataset,
)
from mygenerativerecommenders_tpu.data.dynamic_dataset import (
    FeatureLookupTable as JaxTable,
)
from mygenerativerecommenders_tpu_torch.data.dynamic_dataset import (
    DynamicSequenceDataset,
    FeatureLookupTable,
)

SEQUENCES = {
    # tests/test_dynamic_dataset.py's make_frame
    "jax": (
        "uid,sequence_item_ids,sequence_timestamps,sequence_clicks\n"
        '101,"[3, 5, 7, 9]","[10, 20, 30, 40]","[1, 0, 1, 1]"\n'
        '202,"[2, 4]","[5, 15]","[0, 1]"\n'
    ),
    # a competition-style table: string users, ratings, an empty sequence
    # cell (no history at all), a one-item row, a long row past L
    "strings": (
        "user_id,sequence_item_ids,sequence_timestamps,sequence_ratings\n"
        'u_a,"[3, 5, 7, 9]","[10, 20, 30, 40]","[4, 5, 3, 1]"\n'
        'u_b,"[2]","[5]","[2]"\n'
        'u_c,,,\n'
        'u_d,"[1,2,3,4,5,6,7,8,9,10,11,12]","[1,2,3,4,5,6,7,8,9,10,11,12]",'
        '"[1,1,2,2,3,3,4,4,5,5,1,1]"\n'
        '"u,e","[ 8 , 6 ]","[ 100, 200 ]","[3, 3]"\n'
    ),
    # integer users with a missing one (pandas: float64 with NaN), no
    # timestamps, float ids in the lists (truncated)
    "missing_user": (
        "sequence_item_ids,customer_user,sequence_clicks\n"
        '"[3.7, 5, 7]",7,"[1, 0, 1]"\n'
        '"[2, 4, 6, 8]",,"[0, 1, 1, 0]"\n'
        '"[9, 1]",9,"[1, 1]"\n'
    ),
}

FEATURES = {
    # tests/test_dynamic_dataset.py's feature frame
    "jax": 'movie_id,year,genre_ids\n1,1990,"[2, 5]"\n3,2001,"[7]"\n',
    # an empty feature cell, a non-numeric one, floats, a boolean column
    "edges": (
        "id,year,score,genre_ids,tag,flag\n"
        '1,1990,0.5,"[2, 5]",abc,True\n'
        '3,,2.75,"[7]",12,False\n'
        '4,2001,-1.5,"[1, 2, 3]",7.9,True\n'
        '2,oops,,"[ ]",,False\n'
    ),
}


def _write(tmp_path: Path, name: str, text: str) -> str:
    path = tmp_path / f"{name}.csv"
    path.write_text(text)
    return str(path)


def _equal(got: np.ndarray, want: np.ndarray, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype == object:
        assert [str(x) for x in got] == [str(x) for x in want], what
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("name", sorted(SEQUENCES))
@pytest.mark.parametrize("max_len,ignore_last_n,shift", [(8, 0, 0), (3, 1, 2)])
def test_sequence_dataset_and_batches_equal_jax(tmp_path, name, max_len, ignore_last_n, shift):
    path = _write(tmp_path, name, SEQUENCES[name])
    want = JaxDataset.from_csv(pd.read_csv(path), max_len, ignore_last_n, shift)
    got = DynamicSequenceDataset.from_csv(path, max_len, ignore_last_n, shift)
    assert got.item_column == want.item_column
    _equal(got.lengths, want.lengths, "lengths")
    _equal(got.user_ids, want.user_ids, "user_ids")
    for part in ("sequences", "targets"):
        g, w = getattr(got, part), getattr(want, part)
        assert list(g) == list(w), part
        for key in w:
            _equal(g[key], w[key], f"{part}[{key}]")
    for shuffle in (False, True):
        gb = list(got.batches(batch_size=2, shuffle=shuffle, seed=3))
        wb = list(want.batches(batch_size=2, shuffle=shuffle, seed=3))
        assert len(gb) == len(wb)
        for g, w in zip(gb, wb):
            assert list(g) == list(w)
            for key in w:
                _equal(g[key], w[key], f"batch[{key}]")


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("name", sorted(FEATURES))
def test_feature_lookup_table_equals_jax(tmp_path, name):
    path = _write(tmp_path, name, FEATURES[name])
    want = JaxTable(pd.read_csv(path))
    got = FeatureLookupTable(path)
    assert (got.id_column, got.max_id) == (want.id_column, want.max_id)
    assert list(got.tables) == list(want.tables)
    ids = np.array([3, 1, 2, 0, 4, 9])
    for key in want.tables:
        _equal(got.tables[key], want.tables[key], key)
        _equal(got.lookup(key, ids), want.lookup(key, ids), f"lookup {key}")


def test_sequence_csv_without_sequence_columns_raises(tmp_path):
    path = _write(tmp_path, "none", "user_id,items\n1,2\n")
    with pytest.raises(ValueError, match="No sequence_"):
        DynamicSequenceDataset.from_csv(path, 4)
