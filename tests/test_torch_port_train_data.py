"""The port's in-memory synthetic data and batch loader against the JAX
package's `RecoData` / `BatchLoader`, which go through pandas and a CSV round
trip: the same sequences, splits and batches, exactly."""

import numpy as np
import pandas as pd
import pytest

from mygenerativerecommenders_tpu.configs.presets import get_preset as jax_preset
from mygenerativerecommenders_tpu.data.dataset import RecoData as JaxRecoData
from mygenerativerecommenders_tpu_torch import configs as pt_configs
from mygenerativerecommenders_tpu_torch.configs.presets import get_preset as pt_preset
from mygenerativerecommenders_tpu_torch.data.dataset import RecoData

FIELDS = (
    "lengths", "ids", "ratings", "timestamps", "target_id", "target_rating",
    "target_timestamp", "user_ids",
)


def _both(tmp_path, overrides=()):
    jcfg, pcfg = jax_preset("synthetic-smoke"), pt_preset("synthetic-smoke")
    jcfg.data.data_dir = str(tmp_path)
    for cfg in (jcfg, pcfg):
        for key, value in overrides:
            setattr(cfg.data, key, value)
    return JaxRecoData(jcfg.data, seed=42), RecoData(pcfg.data, seed=42)


@pytest.mark.parametrize(
    "overrides",
    [
        (),
        # histories longer than max_sequence_length are cut to the most recent
        (("max_sequence_length", 20), ("synthetic_num_users", 37)),
        (("synthetic_rating_quality", True),),
    ],
)
def test_catalog_and_splits_match_jax_recodata(tmp_path, overrides):
    jdata, pdata = _both(tmp_path, overrides)
    np.testing.assert_array_equal(pdata.all_item_ids, np.asarray(jdata.all_item_ids))
    assert pdata.max_item_id == jdata.max_item_id
    for split in ("train", "val", "test"):
        want, got = jdata.dataset(split), pdata.dataset(split)
        assert len(got) == len(want)
        for field in FIELDS:
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert (pdata.dataset("train").lengths < pdata.dataset("val").lengths).any()


def test_first_batches_of_two_epochs_match_jax_loader(tmp_path):
    jdata, pdata = _both(tmp_path)
    for split in ("train", "val"):
        jloader, ploader = jdata.loader(split), pdata.loader(split)
        assert len(ploader) == len(jloader)
        for _ in range(2):  # two epochs: the permutation follows seed + epoch
            for i, (want, got) in enumerate(zip(jloader, ploader)):
                assert got.keys() == want.keys()
                for key in want:
                    np.testing.assert_array_equal(got[key], want[key], err_msg=f"{split} {key}")
                if i == 1:
                    break


def test_last_batch_is_padded_with_weight_zero_rows(tmp_path):
    jdata, pdata = _both(tmp_path, (("synthetic_num_users", 21),))
    want, got = list(jdata.loader("val", batch_size=8)), list(pdata.loader("val", batch_size=8))
    assert len(got) == len(want) == 3
    np.testing.assert_array_equal(got[-1]["sample_weight"], [1, 1, 1, 1, 1, 0, 0, 0])
    for w, g in zip(want, got):
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_user_id_split_threshold_matches_the_jax_split_files(tmp_path):
    jdata, pdata = _both(tmp_path)
    train = pd.read_csv(jdata.processor.train_split_csv())
    test = pd.read_csv(jdata.processor.test_split_csv())
    threshold = pdata.interactions.train_user_threshold()
    assert train["user_id"].max() == threshold
    assert test["user_id"].min() == threshold + 1


@pytest.mark.parametrize(
    "key,value,item",
    [
        ("dataset_name", "ml-1m", "Real data"),
        ("length_buckets", (16, 32), "Long-N and larger catalogs"),
        ("pack_sequences", True, "Packing"),
        ("additional_columns", ("sex",), "Other model families"),
        ("positional_sampling_ratio", 0.5, "Real data"),
    ],
)
def test_unported_data_knobs_raise_naming_the_roadmap_item(key, value, item):
    cfg = pt_preset("synthetic-smoke")
    setattr(cfg.data, key, value)
    with pytest.raises(NotImplementedError, match=item):
        RecoData(cfg.data)


def test_trainer_config_differs_from_jax_only_by_the_device_field():
    from mygenerativerecommenders_tpu import configs as jax_configs

    got = pt_configs.to_dict(pt_preset("synthetic-hstu"))
    want = jax_configs.to_dict(jax_preset("synthetic-hstu"))
    assert got["trainer"].pop("device") == "cuda"
    want["model"]["encoder"]["use_pallas"] = got["model"]["encoder"]["use_pallas"]
    assert got == want
