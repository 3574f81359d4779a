"""The port's data layer and config against the JAX package's.

The numpy modules (metadata, windows, loader, synthetic) must give equal
arrays: splits, window indices, synthetic fixtures bit for bit, and the
seeded batch order of ``iter_batches`` over two epochs.  ``bandpass_fft``
agrees with the JAX fft route within 1e-5 (float32 FFTs of O(1) signals,
summed in another order).  The config module reads the repo's YAML into
the same dict as the JAX one.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eyegaze_tpu import config as jax_config
from eyegaze_tpu.data import loader as jax_loader
from eyegaze_tpu.data import metadata as jax_metadata
from eyegaze_tpu.data import synthetic as jax_synthetic
from eyegaze_tpu.data import windows as jax_windows
from eyegaze_tpu.ops.spectral import bandpass_fft as jax_bandpass_fft
from eyegaze_tpu_torch import config
from eyegaze_tpu_torch.data import loader, metadata, synthetic, windows
from eyegaze_tpu_torch.ops.spectral import bandpass_fft

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("labels", [np.arange(30) % 3, np.r_[np.zeros(9), np.ones(6), [2]]],
                         ids=["stratified", "singleton_class"])
@pytest.mark.parametrize("seed", [0, 42])
def test_stratified_split_matches_jax(labels, seed):
    items = [f"trial{i}" for i in range(len(labels))]
    assert metadata.stratified_split(items, labels, 0.2, seed) == \
        jax_metadata.stratified_split(items, labels, 0.2, seed)


def test_pair_split_class_weights_and_split_files(tmp_path):
    meta = jax_synthetic.synthetic_metadata(40, seed=3)
    assert metadata.pair_split(meta, (33, 34, 35)) == jax_metadata.pair_split(meta, (33, 34, 35))
    labels = [metadata.LABEL2ID[m["class"]] for m in meta][:-3]
    np.testing.assert_array_equal(metadata.class_weights(labels), jax_metadata.class_weights(labels))
    assert metadata.CLASS_NAMES == jax_metadata.CLASS_NAMES
    assert metadata.LABEL2ID == jax_metadata.LABEL2ID
    metadata.save_split_indices(tmp_path / "split.json", [3, 1], [2])
    assert jax_metadata.load_split_indices(tmp_path / "split.json") == ([3, 1], [2])
    assert metadata.load_split_indices(tmp_path / "split.json") == ([3, 1], [2])


def test_window_index_and_gather_match_jax():
    lengths = [3250, 1000, 2048, 1024]
    got, want = windows.window_index(lengths, 1024, 512), jax_windows.window_index(lengths, 1024, 512)
    np.testing.assert_array_equal(got.trial_ids, want.trial_ids)
    np.testing.assert_array_equal(got.starts, want.starts)
    assert len(got) == len(want) == 5 + 0 + 3 + 1
    signals = np.random.default_rng(0).normal(size=(4, 3, 3250)).astype(np.float32)[:, :, :2048]
    idx = windows.window_index([2048] * 4, 1024, 512)
    items = [4, 0, 7]
    np.testing.assert_array_equal(
        windows.gather_windows(signals, idx, items),
        jax_windows.gather_windows(signals, jax_windows.window_index([2048] * 4, 1024, 512), items))


def test_synthetic_fixtures_are_bit_identical():
    got = synthetic.synthetic_eeg_pair_dataset(n=7, C=4, T=300, seed=5, noise_std=0.2)
    want = jax_synthetic.synthetic_eeg_pair_dataset(n=7, C=4, T=300, seed=5, noise_std=0.2)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(synthetic.gen_eeg(C=3, T=200, seed=1),
                                  jax_synthetic.gen_eeg(C=3, T=200, seed=1))
    unbalanced = dict(n=5, C=2, T=64, seed=9, balanced=False)
    np.testing.assert_array_equal(synthetic.synthetic_eeg_pair_dataset(**unbalanced)["label"],
                                  jax_synthetic.synthetic_eeg_pair_dataset(**unbalanced)["label"])


def test_iter_batches_order_matches_jax_over_two_epochs():
    data = jax_synthetic.synthetic_eeg_pair_dataset(n=9, C=2, T=768, seed=1)
    args = (data["eeg1"], data["eeg2"], data["label"])
    ds = loader.DualEEGWindowDataset(*args, window_size=256, stride=128, pairs=data["pair"])
    jds = jax_loader.DualEEGWindowDataset(*args, window_size=256, stride=128, pairs=data["pair"])
    assert len(ds) == len(jds) == 9 * 5
    for epoch in (0, 1):
        for kwargs in (dict(shuffle=True, seed=42, drop_remainder=True),
                       dict(shuffle=False, drop_remainder=False)):
            got = list(ds.iter_batches(8, epoch=epoch, **kwargs))
            want = list(jds.iter_batches(8, epoch=epoch, **kwargs))
            assert len(got) == len(want) == (5 if kwargs["drop_remainder"] else 6)
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])
    arrays = {"x": np.arange(10), "y": np.arange(10) * 2}
    for epoch in (0, 1):
        got = list(loader.batch_iterator(arrays, 3, shuffle=True, seed=7, epoch=epoch))
        want = list(jax_loader.batch_iterator(arrays, 3, shuffle=True, seed=7, epoch=epoch))
        assert [b["x"].tolist() for b in got] == [b["x"].tolist() for b in want]
    with pytest.raises(ValueError, match="ragged"):
        loader.ArrayDataset({"x": np.zeros(3), "y": np.zeros(4)})


@pytest.mark.parametrize("n", [256, 1001])
def test_bandpass_fft_matches_jax(n):
    x = np.random.default_rng(n).normal(size=(2, 3, n)).astype(np.float32)
    want = np.asarray(jax_bandpass_fft(jnp.asarray(x), 1.0, 45.0, 256.0))
    got = bandpass_fft(torch.from_numpy(x), 1.0, 45.0, 256.0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_config_reads_the_yaml_as_jax_does():
    path = ROOT / "configs" / "dual_eeg_transformer.yaml"
    assert config.load_yaml_config(path).to_dict() == jax_config.load_yaml_config(path).to_dict()
    got, want = config.ExperimentConfig().to_dict(), jax_config.ExperimentConfig().to_dict()
    assert got["system"].pop("device") == "cuda"
    want["system"].pop("device")
    assert got == want
    for port_cls, jax_cls in ((config.TrainingConfig, jax_config.TrainingConfig),
                              (config.DataConfig, jax_config.DataConfig)):
        assert [f.name for f in dataclasses.fields(port_cls)] == \
            [f.name for f in dataclasses.fields(jax_cls)]


def test_config_round_trips_and_names_pyyaml_when_missing(tmp_path, monkeypatch):
    cfg = config.config_from_dict({"model": {"d_model": 64}, "system": {"device": "cpu"}})
    config.save_yaml_config(cfg, tmp_path / "c.yaml")
    back = config.load_yaml_config(tmp_path / "c.yaml")
    assert back.model.d_model == 64 and back.system.device == "cpu"
    monkeypatch.setitem(sys.modules, "yaml", None)  # 'import yaml' now raises ImportError
    with pytest.raises(RuntimeError, match="PyYAML"):
        config.load_yaml_config(tmp_path / "c.yaml")
    with pytest.raises(RuntimeError, match="PyYAML"):
        config.save_yaml_config(cfg, tmp_path / "d.yaml")
    assert config.config_from_dict({}).system.device == "cuda"  # no YAML needed
