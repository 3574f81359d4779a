"""The port's full-scale rehearsal against the JAX package's
``scripts/rehearsal_full_scale.py`` on the CPU: its generators, its split
and its refusals.

- ``build_metadata`` gives the JAX script's records (JSON-equal) at the
  dataset's 4,463 trials and at 448 and 32;
- ``gen_eeg_volume``, ``gen_csv_subset`` and ``gen_jpg_subset`` write the
  JAX script's bytes (the JPGs where PIL is installed), and ``--stages
  gen`` the JAX report's keys and files;
- the 4,463-trial pair split gives 3,187 / 1,276 trials and 28,683 /
  11,484 windows, from the metadata and ``data/windows.window_index``
  alone;
- the flagship's train step with its whole objective (IBS tokens, the
  spectrogram, the IBS-CE term) at a narrow width on 24 windows: the steps
  and eval batches the report counts, a checkpoint that
  ``Predictor.from_checkpoint`` serves, the metrics analysis on it;
- a train step that leaves no checkpoint, and an analysis without one,
  stop the run and name the file; unknown stages are refused; without a
  card the entry point stops before it writes anything.
"""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from eyegaze_tpu_torch import rehearsal_full_scale as port

ROOT = Path(__file__).resolve().parent.parent
NARROW = dict(port.EEG_MODEL, d_model=32, num_layers=1, num_heads=4, d_ff=64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_rehearsal():
    spec = importlib.util.spec_from_file_location("jax_rehearsal_full_scale",
                                                  ROOT / "scripts" / "rehearsal_full_scale.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("n", [4463, 448, 32])
def test_build_metadata_matches_jax(jax_rehearsal, n):
    got = port.build_metadata(n)
    assert json.dumps(got) == json.dumps(jax_rehearsal.build_metadata(n))
    assert len(got) == n


@pytest.mark.parametrize("n, chunk", [(4, 256), (3, 2)], ids=["one_chunk", "two_chunks"])
def test_gen_eeg_volume_matches_jax(jax_rehearsal, tmp_path, n, chunk):
    meta = port.build_metadata(n)
    assert port.gen_eeg_volume(meta, tmp_path / "port", chunk=chunk) == n
    jax_rehearsal.gen_eeg_volume(meta, tmp_path / "jax", chunk=chunk)
    got, want = digests(tmp_path / "port"), digests(tmp_path / "jax")
    assert sorted(got) == ["eeg1.npy", "eeg2.npy", "labels.npy", "pairs.npy"]
    assert got == want
    assert np.load(tmp_path / "port" / "eeg1.npy").shape == (n, port.C, port.T_RAW)


def test_gen_csv_subset_matches_jax(jax_rehearsal, tmp_path):
    meta = port.build_metadata(4)
    port.gen_eeg_volume(meta, tmp_path / "eeg")
    assert port.gen_csv_subset(meta, tmp_path / "port", tmp_path / "eeg", 2) == 4
    jax_rehearsal.gen_csv_subset(meta, tmp_path / "jax", tmp_path / "eeg", 2)
    got = digests(tmp_path / "port")
    assert got == digests(tmp_path / "jax")
    assert sorted(got) == sorted(f"{m[p]}.csv" for m in meta[:2] for p in ("player1", "player2"))


def test_gen_jpg_subset_matches_jax(jax_rehearsal, tmp_path):
    pytest.importorskip("PIL")
    meta = port.build_metadata(32)
    assert port.gen_jpg_subset(meta, tmp_path / "port", 2) == 4
    jax_rehearsal.gen_jpg_subset(meta, tmp_path / "jax", 2)
    got = digests(tmp_path / "port")
    assert got == digests(tmp_path / "jax")
    # One train-pair head and one validation-pair tail.
    assert [m["pair"] in port.VAL_PAIRS for m in port.jpg_subset(meta, 2)] == [False, True]
    assert len(got) == 4


def test_full_scale_split_gives_the_reference_counts():
    meta = port.build_metadata(port.FULL_TRIALS)
    assert port.expected_windows(meta) == (3187, 1276, 28683, 11484)
    assert {m["pair"] for m in meta} == set(port.TRAIN_PAIRS) | set(port.VAL_PAIRS)
    counts = {c: sum(m["class"] == c for m in meta) for c in port.CLASS_COUNTS}
    assert counts == port.CLASS_COUNTS


def test_gen_stage_matches_the_jax_report_and_files(jax_rehearsal, tmp_path):
    """``--stages gen`` through both scripts: the same files to the byte,
    the JAX report's keys per step plus the port's peak RSS and K1 count."""
    pytest.importorskip("PIL")
    flags = ["--trials", "4", "--csv-trials", "2", "--jpg-trials", "2", "--stages", "gen"]
    assert port.main(["--root", str(tmp_path / "port"), *flags, "--device", "cpu"]) == 0
    assert jax_rehearsal.main(["--root", str(tmp_path / "jax"), *flags]) == 0
    got, want = (json.loads((tmp_path / d / "rehearsal_report.json").read_text())
                 for d in ("port", "jax"))
    assert set(got) == set(want) == {"config", *port.STAGES["gen"]}
    for step in port.STAGES["gen"]:
        assert set(got[step]) == set(want[step]) | {"peak_rss_gib", "k1_launches"}, step
        assert {k: v for k, v in got[step].items() if k in want[step] and k != "wall_s"} == \
            {k: v for k, v in want[step].items() if k != "wall_s"}
    assert set(got["config"]) == set(want["config"]) | {"device"}
    files = {k: v for k, v in digests(tmp_path / "port").items() if k != "rehearsal_report.json"}
    assert files == {k: v for k, v in digests(tmp_path / "jax").items()
                     if k != "rehearsal_report.json"}


def write_windows(root: Path, n_train: int, n_val: int) -> None:
    """Seeded (n, 32, 1024) window files of a pair split, as the windows
    step writes them."""
    r = np.random.default_rng(3)
    for split, n in (("train", n_train), ("val", n_val)):
        for k in (1, 2):
            np.save(root / f"{split}_eeg{k}.npy",
                    r.normal(size=(n, port.C, port.WINDOW)).astype(np.float32))
        np.save(root / f"{split}_labels.npy", (np.arange(n) % 3).astype(np.int32))
        np.save(root / f"{split}_pairs.npy", np.full(n, 12 if split == "train" else 33, np.int32))
        (root / f"{split}_metadata.json").write_text(json.dumps({"windows": n}))


def test_train_step_with_the_whole_objective(tmp_path, monkeypatch):
    """The flagship's train step as the JAX script configures it (IBS
    tokens, spectrogram, IBS-CE) at a narrow width: 16 train windows in
    batches of 8 (2 steps) and 8 validation windows (1 eval batch);
    best_model.pt served back; the metrics analysis on it."""
    from eyegaze_tpu_torch.serving import Predictor

    monkeypatch.setattr(port, "EEG_MODEL", NARROW)
    monkeypatch.setattr(port, "EEG_BATCH", 8)
    root = tmp_path / "r"
    (root / "windows").mkdir(parents=True)
    write_windows(root / "windows", 16, 8)
    assert port.main(["--root", str(root), "--stages", "train_eeg_full_windows,analyze_eeg_ckpt",
                      "--device", "cpu"]) == 0
    report = json.loads((root / "rehearsal_report.json").read_text())
    train = report["train_eeg_full_windows"]
    assert (train["train_steps"], train["eval_batches"]) == (2, 1)
    assert np.isfinite(train["train_loss"]).all() and train["steps_per_s"] > 0
    assert report["analyze_eeg_ckpt"]["forwards"] == 1
    assert (root / "eeg_analysis" / "core_metrics" / "predictions.csv").exists()
    pred = Predictor.from_checkpoint(root / "eeg_run" / "checkpoints" / "best_model.pt",
                                     device=torch.device("cpu"), batch_buckets=(8,))
    logits = pred.predict(*(np.load(root / "windows" / f"val_eeg{k}.npy")
                            for k in (1, 2)))["logits"]
    assert logits.shape == (8, 3) and np.isfinite(logits).all()


def test_a_train_step_without_a_checkpoint_stops_the_run(tmp_path, monkeypatch):
    root = tmp_path / "r"
    calls = []
    monkeypatch.setattr(port.train_dual_eeg, "main", lambda argv: calls.append(argv) or {})
    with pytest.raises(RuntimeError, match="train_dual_eeg left no .*eeg_run/checkpoints/"
                                           "best_model.pt"):
        port.main(["--root", str(root), "--stages", "train", "--device", "cpu"])
    assert calls and not (root / "rehearsal_report.json").exists()  # the step is not recorded
    with pytest.raises(RuntimeError, match="train_eeg_full_windows.* left no .*eeg_run/"
                                           "checkpoints/best_model.pt"):
        port.main(["--root", str(root), "--stages", "analyze_eeg_ckpt", "--device", "cpu"])


def test_stage_selection():
    assert port.select_steps("analyze_eeg_ckpt,gen") == [*port.STAGES["gen"], "analyze_eeg_ckpt"]
    assert port.select_steps(",".join(port.STAGES)) == list(port.STEPS)
    with pytest.raises(SystemExit, match="unknown stages \\['bogus'\\]"):
        port.select_steps("gen,bogus")


def test_a_failing_entry_point_stops_the_run(tmp_path, monkeypatch):
    monkeypatch.setattr(port.preprocess_eeg_windows, "main", lambda argv: 1)
    with pytest.raises(RuntimeError, match="stage failed: eyegaze_tpu_torch."
                                           "preprocess_eeg_windows \\(rc=1\\)"):
        port.main(["--root", str(tmp_path), "--trials", "3", "--stages",
                   "gen_metadata,windows", "--device", "cpu"])


@pytest.mark.parametrize("package, step, before", [
    ("PIL", "gen_jpg_subset", "gen_metadata"),
    ("matplotlib", "analyze_entropy_real_files", "gen_metadata,gen_eeg_volume,gen_csv_subset"),
], ids=["PIL", "matplotlib"])
def test_a_missing_package_is_named(tmp_path, monkeypatch, package, step, before):
    """A host without the package (the card's lacks matplotlib): the step
    that needs it stops the run naming it."""
    flags = ["--root", str(tmp_path), "--trials", "3", "--csv-trials", "2", "--jpg-trials", "2",
             "--device", "cpu"]
    assert port.main([*flags, "--stages", before]) == 0  # the step's inputs
    (tmp_path / "gaze_jpg").mkdir(exist_ok=True)  # no JPGs: the EEG entropies alone
    monkeypatch.setitem(sys.modules, package, None)
    with pytest.raises(ImportError, match=f"stage {step} needs {package}, which is not "
                                          "installed here"):
        port.main([*flags, "--stages", step])


def test_rehearsal_fails_without_cuda_unless_asked_for_the_cpu(tmp_path):
    root = tmp_path / "r"
    r = subprocess.run([sys.executable, "-m", "eyegaze_tpu_torch.rehearsal_full_scale",
                        "--root", str(root), "--trials", "3"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "needs a CUDA device" in r.stderr and "--device cpu" in r.stderr
    assert "[stage]" not in r.stdout
    assert not root.exists()
