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
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

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
        # the train split's positional subsample (seeded) and newest-first histories
        (("positional_sampling_ratio", 0.5),),
        (("chronological", False), ("max_sequence_length", 20)),
    ],
)
def test_catalog_and_splits_match_jax_recodata(tmp_path, overrides):
    jdata, pdata = _both(tmp_path, overrides)
    np.testing.assert_array_equal(pdata.all_item_ids, np.asarray(jdata.all_item_ids))
    assert pdata.max_item_id == jdata.max_item_id
    np.testing.assert_array_equal(pdata.year_of_item, jdata.year_of_item)
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
    "key,value,words",
    [
        # the reference declares the field and reads it nowhere
        ("item_year_feature", True, "reference ignores"),
    ],
)
def test_unported_data_knobs_raise_naming_the_roadmap_item(key, value, words):
    cfg = pt_preset("synthetic-smoke")
    setattr(cfg.data, key, value)
    with pytest.raises(ValueError, match=f"{key}.*{words}"):
        RecoData(cfg.data)


def test_trainer_config_differs_from_jax_only_by_the_device_field():
    from mygenerativerecommenders_tpu import configs as jax_configs

    got = pt_configs.to_dict(pt_preset("synthetic-hstu"))
    want = jax_configs.to_dict(jax_preset("synthetic-hstu"))
    assert got["trainer"].pop("device") == "cuda"
    want["model"]["encoder"]["use_pallas"] = got["model"]["encoder"]["use_pallas"]
    assert got == want


@pytest.mark.parametrize("key,value", [("additional_columns", ("sex",))])
def test_data_knobs_that_raised_before_feed_a_training_step(tmp_path, key, value):
    """The data knobs that raised before the aux preprocessor was ported:
    the batches carry the column as the JAX loader's do, and the aux model
    that reads it takes a finite step."""
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    jdata, pdata = _both(tmp_path, [(key, value)])
    want = next(iter(jdata.loader("train")))
    got = next(iter(pdata.loader("train")))
    assert got.keys() == want.keys() and set(value) <= got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    trainer = Trainer(cli_train.parse_args([
        "experiment=synthetic-smoke", "trainer.device=cpu", f"trainer.output_dir={tmp_path}",
        f"data.{key}={list(value)}".replace("'", '"'),
        "model.preprocessor.kind=learnable_positional_aux",
        f"model.preprocessor.auxiliary_columns={list(value)}".replace("'", '"'),
        'model.preprocessor.encoding_types=["onehot"]', "model.preprocessor.categorical_dims=[2]",
        "model.preprocessor.categorical_embedding_dims=[0]",
    ]))
    batch = next(iter(trainer.data.loader("train")))
    loss = trainer.train_step(trainer._put(batch), trainer.lr1)
    assert np.isfinite(loss.item())
