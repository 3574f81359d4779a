"""The port's offline entry points against the JAX package's scripts on the CPU.

``load_csv_batch_f32`` and ``preprocess_eeg_raw`` must give what the JAX
package gives to the bit; ``preprocess_eeg_windows`` within the filtfilt
preprocessing's 1e-3 (``tests/test_torch_ops.py``); ``extract_eeg_features``
at ``tests/test_torch_features.py``'s bounds against the JAX script, and
between chunkings at ``tests/test_scripts.py``'s (0.08 for intra and inter,
1e-3 for the rest).  Its asynchronous writes must equal synchronous ones to
the byte.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from eyegaze_tpu.data import native as jnative
from eyegaze_tpu_torch import (
    extract_eeg_features,
    generate_metadata,
    preprocess_eeg_raw,
    preprocess_eeg_windows,
    verify_metadata,
)
from eyegaze_tpu_torch.data import native
from eyegaze_tpu_torch.data.synthetic import synthetic_metadata
from tests.test_torch_features import assert_metrics_close

ROOT = Path(__file__).resolve().parent.parent
WINDOW_TOL = 1e-3
CHUNK_TOL = {"intra": 0.08, "inter": 0.08}
FEATURE_TOL = 1e-3  # psd and band energy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_csv(path: Path, arr: np.ndarray) -> None:
    np.savetxt(path, arr, delimiter=",", fmt="%.6f")


def trial_dir(path: Path, n: int, c: int, t: int, seed: int = 0) -> Path:
    """``eeg1.npy``, ``eeg2.npy``, ``labels.npy``, ``pairs.npy`` of n seeded
    trials (pairs 12, 13, ... with 33 and up in the default validation set)."""
    r = np.random.default_rng(seed)
    path.mkdir()
    time = np.arange(t) / 250.0
    osc = np.sin(2 * np.pi * 10.0 * time).astype(np.float32)
    for k in (1, 2):
        eeg = r.normal(size=(n, c, t)).astype(np.float32) * 5.0 + 0.5 * osc
        np.save(path / f"eeg{k}.npy", eeg)
    np.save(path / "labels.npy", (np.arange(n) % 3).astype(np.int32))
    np.save(path / "pairs.npy", np.asarray([12, 13, 33, 14, 34, 15, 16, 35][:n], np.int32))
    return path


@pytest.mark.parametrize("fallback", [False, True], ids=["native", "numpy"])
def test_load_csv_batch_matches_jax(tmp_path, monkeypatch, fallback):
    r = np.random.default_rng(1)
    paths = []
    for i, shape in enumerate([(4, 30), (30, 4), (2, 9)]):
        paths.append(tmp_path / f"f{i}.csv")
        write_csv(paths[-1], r.normal(size=shape))
    paths.insert(1, tmp_path / "missing.csv")
    if fallback:
        monkeypatch.setattr(native, "_library", lambda: None)
        monkeypatch.setattr(jnative, "_get_lib", lambda: None)
    else:
        assert native.native_available() and jnative.native_available()
    got = native.load_csv_batch_f32(paths, 16, 40)
    want = jnative.load_csv_batch_f32(paths, 16, 40)
    assert got[0].shape == (4, 16, 40)
    np.testing.assert_array_equal(got[3], [True, False, True, True])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert not got[0][1].any()


def raw_fixture(tmp_path: Path, c: int = 4, t: int = 300):
    """CSVs for 12 synthetic records: channel-major, two time-major (one
    over the batch's row cap), a short one and a missing one."""
    meta = synthetic_metadata(12, seed=3)
    eeg_dir = tmp_path / "csv"
    eeg_dir.mkdir()
    r = np.random.default_rng(2)
    for i, m in enumerate(meta):
        for player in ("player1", "player2"):
            if i == 5 and player == "player2":
                continue  # missing: the trial is dropped
            arr = r.normal(size=(c, t)) * 20.0
            if i == 2:
                arr = arr.T  # time-major, over the row cap: parsed again
            elif i == 7:
                arr = arr[:, :40].T  # time-major, under the cap
            elif i == 9:
                arr = arr[: c - 1, : t // 2]  # short on both axes: padded
            write_csv(eeg_dir / f"{m[player]}.csv", arr)
    path = tmp_path / "meta.json"
    path.write_text(json.dumps(meta))
    return path, eeg_dir


def test_preprocess_eeg_raw_bytes_equal_jax(tmp_path):
    meta, eeg_dir = raw_fixture(tmp_path)
    argv = ["--metadata", str(meta), "--eeg-dir", str(eeg_dir), "--num-channels", "4",
            "--target-length", "300", "--batch", "4", "--val-pairs", "13", "16"]
    assert preprocess_eeg_raw.main([*argv, "--output-dir", str(tmp_path / "port")]) == 0
    assert jax_script("preprocess_eeg_raw").main([*argv, "--output-dir",
                                                  str(tmp_path / "jax")]) == 0
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert "val_metadata.json" in names and "train_eeg1.npy" in names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    train = json.loads((tmp_path / "port" / "train_metadata.json").read_text())
    assert train["skipped"] == 1 and 5 not in train["metadata_indices"]


@pytest.mark.parametrize("split_mode", ["pair", "stratified"])
def test_preprocess_eeg_windows_matches_jax(tmp_path, split_mode):
    src = trial_dir(tmp_path / "in", 8, 4, 600)
    argv = ["--input-dir", str(src), "--window-size", "256", "--stride", "128",
            "--split-mode", split_mode]
    assert preprocess_eeg_windows.main([*argv, "--output-dir", str(tmp_path / "port"),
                                        "--device", "cpu"]) == 0
    assert jax_script("preprocess_eeg_windows").main([*argv, "--output-dir",
                                                      str(tmp_path / "jax")]) == 0
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in names:
        got, want = tmp_path / "port" / name, tmp_path / "jax" / name
        if name.endswith(".json"):
            assert json.loads(got.read_text()) == json.loads(want.read_text())
        elif "eeg" in name:
            g, w = np.load(got), np.load(want)
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_allclose(g, w, rtol=WINDOW_TOL, atol=WINDOW_TOL, err_msg=name)
        else:
            assert got.read_bytes() == want.read_bytes(), name
    assert np.load(tmp_path / "port" / "train_eeg1.npy").shape[1:] == (4, 256)


@pytest.fixture(scope="module")
def feature_input(tmp_path_factory):
    return trial_dir(tmp_path_factory.mktemp("features") / "in", 3, 8, 768, seed=4)


@pytest.fixture(scope="module")
def port_features(feature_input, tmp_path_factory):
    """The port's features of ``feature_input`` at chunks 2 and 3 (the
    chunk of 2 leaves a last chunk of 1)."""
    out = {}
    for chunk in (2, 3):
        d = tmp_path_factory.mktemp(f"port{chunk}")
        assert extract_eeg_features.main(["--input-dir", str(feature_input), "--output-dir",
                                          str(d), "--trial-chunk", str(chunk), "--device",
                                          "cpu"]) == 0
        out[chunk] = d
    return out


def trial_names(d: Path) -> list:
    return sorted(p.name for p in d.glob("trial_*.npz"))


def test_extract_eeg_features_matches_jax(feature_input, port_features, tmp_path):
    assert jax_script("extract_eeg_features").main(["--input-dir", str(feature_input),
                                                    "--output-dir", str(tmp_path),
                                                    "--trial-chunk", "2"]) == 0
    names = trial_names(tmp_path)
    assert names == trial_names(port_features[2]) == [f"trial_{i:05d}.npz" for i in range(3)]
    for name in names:
        got, want = np.load(port_features[2] / name), np.load(tmp_path / name)
        assert got.files == want.files == ["band_energy", "inter", "intra", "psd", "label",
                                           "pair"]
        for k in got.files:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        assert got["intra"].shape == (2, 7, 5, 8, 8) and got["inter"].shape == (7, 5, 8, 8)
        np.testing.assert_allclose(got["psd"], want["psd"], rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(got["band_energy"], want["band_energy"], rtol=1e-3,
                                   atol=1e-5)
        assert_metrics_close(got["intra"], want["intra"], intra=True)
        assert_metrics_close(got["inter"], want["inter"])
        assert got["label"] == want["label"] and got["pair"] == want["pair"]


def test_chunk_one_matches_chunk_three(feature_input, port_features, tmp_path):
    assert extract_eeg_features.main(["--input-dir", str(feature_input), "--output-dir",
                                      str(tmp_path), "--trial-chunk", "1", "--device",
                                      "cpu"]) == 0
    assert trial_names(tmp_path) == trial_names(port_features[3])
    for name in trial_names(tmp_path):
        a, b = np.load(tmp_path / name), np.load(port_features[3] / name)
        for k in a.files:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=CHUNK_TOL.get(k, FEATURE_TOL),
                                       err_msg=f"{name}:{k}")


def test_async_writes_equal_synchronous_writes(feature_input, port_features, tmp_path):
    """Each file of the chunk-3 run equals, to the byte, the same chunk's
    features computed and written in the calling thread."""
    e1, e2 = (torch.from_numpy(np.load(feature_input / f"eeg{k}.npy")) for k in (1, 2))
    labels, pairs = np.load(feature_input / "labels.npy"), np.load(feature_input / "pairs.npy")
    feats = {k: v.numpy() for k, v in extract_eeg_features.chunk_features(e1, e2, 250.0,
                                                                          8).items()}
    for i in range(3):
        extract_eeg_features.write_trial(tmp_path, i, feats, i, labels[i], pairs[i])
    for name in trial_names(port_features[3]):
        assert (port_features[3] / name).read_bytes() == (tmp_path / name).read_bytes(), name


def test_resume_writes_exactly_the_missing_trials(feature_input, tmp_path):
    """Chunk 2 over 5 trials: chunks {0, 1}, {2, 3}, {4}.  Deleting trial 1
    and trial 4 recomputes chunks 0 and 2 and writes only 1 and 4; chunk 1
    is skipped."""
    src = trial_dir(tmp_path / "in", 5, 8, 600, seed=5)
    argv = ["--input-dir", str(src), "--output-dir", str(tmp_path / "out"), "--trial-chunk",
            "2", "--device", "cpu"]
    assert extract_eeg_features.main(argv) == 0
    out = tmp_path / "out"
    before = {p.name: (p.stat().st_mtime_ns, p.read_bytes()) for p in out.glob("trial_*.npz")}
    assert len(before) == 5
    for name in ("trial_00001.npz", "trial_00004.npz"):
        (out / name).unlink()
    os.utime(out / "trial_00000.npz", ns=(1, 1))
    assert extract_eeg_features.main([*argv, "--resume"]) == 0
    after = {p.name: (p.stat().st_mtime_ns, p.read_bytes()) for p in out.glob("trial_*.npz")}
    assert sorted(after) == sorted(before)
    assert after["trial_00000.npz"][0] == 1  # in a recomputed chunk, but not written
    for name in ("trial_00002.npz", "trial_00003.npz"):
        assert after[name] == before[name]
    for name in ("trial_00001.npz", "trial_00004.npz"):
        assert after[name][1] == before[name][1]


def test_writer_failure_fails_the_run(tmp_path, monkeypatch):
    """An error in the writer thread is raised in ``main``, and the entry
    point exits non-zero: a directory stands where trial 1's file goes."""
    src = trial_dir(tmp_path / "in", 3, 8, 600, seed=6)
    out = tmp_path / "out"
    (out / "trial_00001.npz").mkdir(parents=True)
    argv = ["--input-dir", str(src), "--output-dir", str(out), "--trial-chunk", "1",
            "--device", "cpu"]
    with pytest.raises(IsADirectoryError):
        extract_eeg_features.main(argv)
    r = subprocess.run([sys.executable, "-m", "eyegaze_tpu_torch.extract_eeg_features", *argv],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "IsADirectoryError" in r.stderr
    assert "[extract]" not in r.stdout


def test_generate_and_verify_metadata_match_jax(tmp_path, capsys):
    records = synthetic_metadata(20, seed=5)
    records[3]["pair"] = 18  # excluded
    records[4]["class"] = None
    records[4]["player1"] = "p13_a_coop_4"  # class from the file name
    (tmp_path / "a.json").write_text(json.dumps(records[:10]))
    (tmp_path / "b.json").write_text(json.dumps(records[10]))  # a single record
    (tmp_path / "c.json").write_text(json.dumps(records[11:]))
    inputs = [str(tmp_path / f"{k}.json") for k in "abc"]
    outputs = []
    for name, module in (("port", generate_metadata), ("jax", jax_script("generate_metadata"))):
        assert module.main(["--inputs", *inputs, "--output", str(tmp_path / f"{name}.json")]) == 0
        outputs.append(capsys.readouterr().out)
    assert outputs[0] == outputs[1].replace(str(tmp_path / "jax.json"), str(tmp_path / "port.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    generated = json.loads((tmp_path / "port.json").read_text())
    assert len(generated) == 19 and generated[3]["class"] == "Cooperation"

    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([*generated, {**generated[0], "pair": 18}]))
    for path, code in ((tmp_path / "port.json", 0), (bad, 1)):
        reports = []
        for module in (verify_metadata, jax_script("verify_metadata")):
            assert module.main([str(path)]) == code
            reports.append(capsys.readouterr().out)
        assert reports[0] == reports[1]
