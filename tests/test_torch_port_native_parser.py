"""`SequenceDataset.from_csv` of the port against the JAX package's, on the
CPU: the port's native parser (its own copy of seq_parser.cpp, built by g++
at first use into the package's `_build/`) and its plain parser, every array
exactly equal, dtypes included, to the JAX package's (its native parser
where it takes it, its pandas parser where it does not), over
ignore_last_n in {0, 1} x chronological in {true, false}, positional
subsampling at a fixed seed, an id shift and additional columns. The
sequence CSV is a processed ml-1m fixture (users' feature columns beside the
lists, histories longer than L, ties in time).
"""

import numpy as np
import pandas as pd
import pytest

from mygenerativerecommenders_tpu.data.dataset import SequenceDataset as JaxSequenceDataset
from mygenerativerecommenders_tpu_torch import native
from mygenerativerecommenders_tpu_torch.data import preprocessor as pt_pre
from mygenerativerecommenders_tpu_torch.data.dataset import SequenceDataset
from tests.test_torch_port_real_data import FIELDS
from tests.torch_port_real_files import write_ml1m_zip
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

L = 16  # shorter than most fixture histories (3-30 events)


@pytest.fixture(scope="module")
def seq_csv(tmp_path_factory):
    root = tmp_path_factory.mktemp("native")
    write_ml1m_zip(root, num_users=24, seed=4)
    proc = pt_pre.build_processor("ml-1m", str(root))
    proc.preprocess_rating()
    return proc.output_format_csv()


def _assert_same(got, want):
    for field in FIELDS:
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype, (field, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=field)


@pytest.mark.parametrize("parser", ["native", "python"])
@pytest.mark.parametrize("chronological", [True, False])
@pytest.mark.parametrize("ignore_last_n", [0, 1])
def test_from_csv_matches_jax(seq_csv, parser, chronological, ignore_last_n):
    want = JaxSequenceDataset.from_csv(seq_csv, L, ignore_last_n, chronological=chronological)
    got = SequenceDataset.from_csv(seq_csv, L, ignore_last_n, chronological=chronological,
                                   parser=parser)
    _assert_same(got, want)
    assert (got.lengths == L).any() and (got.lengths < L).any()


@pytest.mark.parametrize("kwargs", [
    {"sample_ratio": 0.5, "seed": 7},
    {"sample_ratio": 0.5, "seed": 7, "chronological": False},
    {"shift_id_by": 3},
])
def test_plain_parser_subsampling_and_shift_match_jax(seq_csv, kwargs):
    """Where the JAX package takes its pandas parser (a subsample drawn from
    `default_rng(seed)`, the target kept; an id shift), "auto" takes the
    plain parser."""
    want = JaxSequenceDataset.from_csv(pd.read_csv(seq_csv), L, 1, **kwargs)
    _assert_same(SequenceDataset.from_csv(seq_csv, L, 1, **kwargs), want)
    full = SequenceDataset.from_csv(seq_csv, L, 1)
    if "sample_ratio" in kwargs:
        np.testing.assert_array_equal(want.target_id, full.target_id)  # never dropped
    with pytest.raises(ValueError, match="native parser"):
        SequenceDataset.from_csv(seq_csv, L, 1, parser="native", **kwargs)


@pytest.mark.parametrize("parser", ["native", "python"])
def test_additional_columns_match_jax(seq_csv, parser):
    cols = ["sex", "age_group", "occupation", "zip_code"]
    want = JaxSequenceDataset.from_csv(seq_csv, L, 0, additional_columns=cols)
    got = SequenceDataset.from_csv(seq_csv, L, 0, additional_columns=cols, parser=parser)
    _assert_same(got, want)
    assert sorted(got.additional) == sorted(want.additional)
    for col in cols:
        assert got.additional[col].dtype == np.int32
        np.testing.assert_array_equal(got.additional[col], want.additional[col], err_msg=col)
    with pytest.raises(ValueError, match="not in the sequence CSV"):
        SequenceDataset.from_csv(seq_csv, L, 0, additional_columns=["nope"], parser=parser)


def test_native_library_is_built_into_the_build_directory(seq_csv):
    native.load()
    built = native._target()
    assert built.exists() and built.parent == native.BUILD_DIR
    assert built.parent.name == "_build"
    assert not list(native._SRC.parent.glob("*.so"))  # nothing beside the source


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    broken = tmp_path / "seq_parser.cpp"
    broken.write_text("this is not C++ {\n")
    monkeypatch.setattr(native, "_SRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="error"):
        native.build()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_the_native_source_is_a_copy_of_the_jax_packages():
    import mygenerativerecommenders_tpu.native as jax_native

    assert native._SRC.parent.parent.name == "mygenerativerecommenders_tpu_torch"
    with open(jax_native._SRC, "rb") as f:
        assert native._SRC.read_bytes() == f.read()
