"""The port's real-data path against the JAX package's, on the CPU: raw files
in the published formats (written here, small), the processors
(data/preprocessor.py) and `RecoData` on the processed files.

The processed files must be byte for byte the JAX package's (pandas 3 there,
the stdlib `csv` in the port): `sasrec_format.csv`, its train and test
splits, `movies.csv` and `users.csv`, for ml-1m (`::`, latin-1; titles with
commas, quotes, latin-1 letters, no year), ml-20m (float ratings, x.5
among them), Amazon (string ASINs, ids of digits only, `min_count` 1, 2 and
5) and the ml-20mx16x32 npz shards. `RecoData` must give the JAX catalog
(`all_item_ids`, `max_item_id`, `year_of_item`) and splits.
"""

import filecmp
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from mygenerativerecommenders_tpu.configs import DataConfig as JaxDataConfig
from mygenerativerecommenders_tpu.data import preprocessor as jax_pre
from mygenerativerecommenders_tpu.data.dataset import RecoData as JaxRecoData
from mygenerativerecommenders_tpu_torch.cli import prepare_data
from mygenerativerecommenders_tpu_torch.configs import DataConfig
from mygenerativerecommenders_tpu_torch.data import preprocessor as pt_pre
from mygenerativerecommenders_tpu_torch.data.catalog import load_catalog
from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
from tests.torch_port_real_files import (
    write_amazon_csv,
    write_ml1m_zip,
    write_ml20m_zip,
    write_npz_shards,
)
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIELDS = (
    "lengths", "ids", "ratings", "timestamps", "target_id", "target_rating",
    "target_timestamp", "user_ids",
)
CASES = {
    "ml-1m": ("ml-1m", write_ml1m_zip, {}),
    "ml-20m": ("ml-20m", write_ml20m_zip, {}),
    "amzn-min1": ("amzn-books", lambda r: write_amazon_csv(r / "ratings_Books.csv"),
                  {"min_count": 1}),
    "amzn-min5": ("amzn-books", lambda r: write_amazon_csv(r / "ratings_Books.csv"),
                  {"min_count": 5}),
    "amzn-digits-min2": (
        "amzn-books", lambda r: write_amazon_csv(r / "ratings_Books.csv", digit_asins=True),
        {"min_count": 2}),
    "npz": ("ml-20mx16x32", write_npz_shards, {"num_shards": 3}),
}


def _processed_both(tmp_path: Path, case: str):
    name, write, kwargs = CASES[case]
    dirs = {}
    for side, module in (("jax", jax_pre), ("port", pt_pre)):
        root = tmp_path / side
        root.mkdir()
        write(root)
        n = module.build_processor(name, str(root), **kwargs).preprocess_rating()
        dirs[side] = (root / "processed" / name, n)
    return dirs


@pytest.mark.parametrize("case", list(CASES))
def test_processed_files_are_byte_for_byte_the_jax_packages(tmp_path, case):
    dirs = _processed_both(tmp_path, case)
    (want_dir, want_n), (got_dir, got_n) = dirs["jax"], dirs["port"]
    assert got_n == want_n
    names = sorted(os.listdir(want_dir))
    assert names == sorted(os.listdir(got_dir))
    expected = {"sasrec_format.csv", "sasrec_format_train.csv", "sasrec_format_test.csv"}
    assert expected <= set(names)
    if case == "ml-1m":
        assert {"movies.csv", "users.csv"} <= set(names)
    for name in names:
        assert filecmp.cmp(want_dir / name, got_dir / name, shallow=False), name


def test_fixtures_hold_the_traps_the_formats_set(tmp_path):
    """What the byte comparison above must have met: a quoted title with
    doubled quotes and a latin-1 letter, year 0 for a title without
    "(YYYY)", x.5 ratings written by repr, one-item lists left unquoted."""
    dirs = _processed_both(tmp_path, "ml-1m")
    movies = (dirs["port"][0] / "movies.csv").read_text(encoding="utf-8")
    assert '"""Great"" Escape, The (1963)"' in movies and "Señor Español" in movies
    assert "Untitled Project,Drama|Comedy,0,Untitled Project" in movies
    shutil.rmtree(tmp_path / "jax")
    shutil.rmtree(tmp_path / "port")
    seqs = (_processed_both(tmp_path, "ml-20m")["port"][0] / "sasrec_format.csv").read_text()
    assert ".5, " in seqs and "4.0" in seqs


def _reco_data_both(tmp_path: Path, name: str):
    """Each package's RecoData on its own copy of the raw files in
    `tmp_path` (each processes them itself)."""
    made = []
    for side, config, module in (("j", JaxDataConfig, JaxRecoData), ("p", DataConfig, RecoData)):
        os.makedirs(tmp_path / side)
        for f in tmp_path.iterdir():
            if f.is_file():
                shutil.copy(f, tmp_path / side)
        cfg = config(dataset_name=name, data_dir=str(tmp_path / side), max_sequence_length=16)
        made.append(module(cfg, seed=42))
    return made


@pytest.mark.parametrize("case", ["ml-1m", "ml-20m", "amzn-min5"])
def test_reco_data_catalog_and_splits_match_jax(tmp_path, case):
    """ml-1m's catalog is movies.csv's listed ids, the never-rated ones
    included, with the pinned max id 3952; Amazon's (RecoData's processor at
    the default min_count 5) the coded ids, max the largest."""
    name, write, _ = CASES[case]
    write(tmp_path)
    jdata, pdata = _reco_data_both(tmp_path, name)
    assert len(pdata.all_item_ids) > 0
    np.testing.assert_array_equal(pdata.all_item_ids, np.asarray(jdata.all_item_ids))
    assert pdata.max_item_id == jdata.max_item_id
    np.testing.assert_array_equal(pdata.year_of_item, jdata.year_of_item)
    for split in ("train", "test"):
        for field in FIELDS:
            np.testing.assert_array_equal(getattr(pdata.dataset(split), field),
                                          getattr(jdata.dataset(split), field), err_msg=field)
    if case == "ml-1m":
        rated = set(pdata.dataset("test").target_id.tolist())
        assert pdata.max_item_id == 3952 and set(pdata.all_item_ids.tolist()) > rated


def test_npz_catalog_is_the_distinct_ids_of_the_sequences(tmp_path):
    """ml-20mx16x32 writes no item file: the port lists the ids the sequences
    hold (the JAX package's catalog is empty there, `range(1, 0 + 1)`)."""
    write_npz_shards(tmp_path)
    cfg = DataConfig(dataset_name="ml-20mx16x32", data_dir=str(tmp_path), max_sequence_length=8)
    pt_pre.build_processor("ml-20mx16x32", str(tmp_path), num_shards=3).preprocess_rating()
    data = RecoData(cfg)
    ds = data.dataset("test")
    seen = np.unique(np.concatenate([ds.ids[ds.ids > 0], ds.target_id]))
    assert set(seen.tolist()) <= set(data.all_item_ids.tolist())
    assert data.max_item_id == int(data.all_item_ids.max()) and data.year_of_item is None
    assert list(data.all_item_ids) == sorted(set(data.all_item_ids.tolist()))


@pytest.mark.parametrize("name,expected", [
    ("ml-1m", "movielens_ml-1m.zip"),
    ("ml-20m", "movielens_ml-20m.zip"),
    ("amzn-books", "ratings_Books.csv"),
    ("ml-20mx16x32", "trainx16x32_0.npz"),
])
def test_a_missing_raw_file_raises_naming_it_and_nothing_downloads(tmp_path, name, expected):
    cfg = DataConfig(dataset_name=name, data_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match=expected) as err:
        RecoData(cfg)
    assert str(tmp_path) in str(err.value)
    if name != "ml-20mx16x32":
        assert "http" in str(err.value)  # the public source, named, not fetched
    assert not (tmp_path / "processed" / name / "sasrec_format.csv").exists()


def test_prepare_data_cli_writes_the_processed_files_and_logs(tmp_path, caplog):
    write_ml1m_zip(tmp_path, num_users=12)
    prepare_data.log.addHandler(caplog.handler)  # the logger does not propagate
    try:
        data = prepare_data.main(["experiment=ml-1m-hstu", f"data.data_dir={tmp_path}"])
    finally:
        prepare_data.log.removeHandler(caplog.handler)
    out = tmp_path / "processed" / "ml-1m" / "sasrec_format.csv"
    assert out.exists() and (tmp_path / "processed" / "ml-1m" / "users.csv").exists()
    assert f"prepared ml-1m: {len(data.all_item_ids)} items (max id 3952) -> {out}" in caplog.text
    ids, max_id = load_catalog(data.cfg)  # what cli.serve and cli.convert_ckpt read
    np.testing.assert_array_equal(ids, data.all_item_ids)
    assert max_id == 3952
