"""The port's rehearsal end to end on the CPU at 32 trials, against the JAX
package's ``scripts/rehearsal_full_scale.py``.

Every stage runs through ``main([... "--trials", "32", "--device",
"cpu"])``, with the train steps narrowed through the module's values (the
flagship at d_model 32, one layer, without its IBS and spectrogram
branches, which ``tests/test_torch_rehearsal.py`` trains; the gaze ViT
``--tiny`` on 64-pixel conversions).  The JAX script then runs over a copy
of the same tree with its subprocesses recorded instead of run: the port
must call the same entry points in the same order with the same flags and
values (plus ``--device``, convert's ``--size`` and the narrowing), write
the same flagship YAML at the module's default widths, and report the JAX
report's keys for every step plus its own measurements.  Nothing is written
outside ``--root``.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from eyegaze_tpu_torch import rehearsal_full_scale as port
from tests.test_torch_rehearsal import jax_rehearsal  # noqa: F401  (a fixture)

FLAGS = ["--trials", "32", "--csv-trials", "2", "--jpg-trials", "2", "--features-trials", "2"]
# What the port's report holds beyond the JAX report's keys.
PORT_KEYS = {
    "extract_features": {"extract_s", "trials_per_s"},
    "train_eeg_full_windows": {"train_steps", "eval_batches", "steps_per_s", "train_loss",
                               "best_metric"},
    "train_gaze_converted": {"train_steps", "steps_per_s", "best_metric"},
    "analyze_eeg_ckpt": {"forwards"},
}
PORT_FLAGS = {"--device", "--size", "--tiny"}  # flags the port adds to the JAX calls


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The rehearsal at 32 trials, every stage; (cwd, root, report, the
    entry points called with their argv)."""
    pytest.importorskip("PIL")
    cwd = tmp_path_factory.mktemp("cwd")
    root = cwd / "r"
    calls = []
    call = port.call
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(cwd)
        mp.setattr(port, "EEG_MODEL", dict(port.EEG_MODEL, d_model=32, num_layers=1,
                                           num_heads=4, d_ff=64))
        mp.setattr(port, "EEG_ABLATION", {"use_ibs": False, "use_spectrogram": False})
        mp.setattr(port, "GAZE_FLAGS", ("--tiny",))
        mp.setattr(port, "GAZE_SIZE", 64)
        mp.setattr(port, "call", lambda module, argv, entry=None: (
            calls.append((module.__name__, [str(a) for a in argv])) or call(module, argv, entry)))
        try:
            assert port.main(["--root", str(root), *FLAGS, "--device", "cpu"]) == 0
        finally:
            torch.set_num_threads(threads)
    report = json.loads((root / "rehearsal_report.json").read_text())
    return cwd, root, report, calls


def test_every_stage_runs_at_32_trials(run):
    cwd, root, report, _ = run
    assert [p.name for p in cwd.iterdir()] == ["r"]  # nothing outside --root
    assert set(report) == {"config", *port.STEPS}
    assert report["gen_metadata"]["train_trials"] == 23
    assert report["gen_metadata"]["val_trials"] == 9
    windows = report["windows_full"]
    assert windows["expected"] == [23 * 9, 9 * 9]
    assert [windows["train_windows"], windows["val_windows"]] == windows["expected"]
    assert report["convert_eeg_csv"]["roundtrip_max_err"] < 1e-3
    for split, n in (("train", 207), ("val", 81)):
        w = np.load(root / "windows" / f"{split}_eeg1.npy", mmap_mode="r")
        assert w.shape == (n, port.C, port.WINDOW)
    assert len(list((root / "features" / "out").glob("trial_*.npz"))) == 2
    assert np.load(root / "gaze_converted" / "img1.npy").shape == (2, 3, 64, 64)
    train = report["train_eeg_full_windows"]
    assert (train["train_steps"], train["eval_batches"]) == (207 // 128, 1)
    assert np.isfinite(train["train_loss"]).all()
    for path in ("eeg_run/checkpoints/best_model.pt", "gaze_run/checkpoints/best_model.pt",
                 "entropy_out/eeg_entropy_raw.csv", "entropy_out/gaze_entropy_raw.csv",
                 "eeg_analysis/core_metrics/predictions.csv"):
        assert (root / path).exists(), path
    assert report["analyze_eeg_ckpt"]["forwards"] == 1
    assert all(report[s]["k1_launches"] == 0 for s in port.STEPS)  # the CPU runs K1's twin
    assert all(report[s]["peak_rss_gib"] > 0 for s in port.STEPS)


def argv_dict(argv) -> dict:
    out, key = {}, None
    for a in argv:
        if a.startswith("--"):
            key = a
            out[key] = True
        else:
            out[key] = a if out[key] is True else f"{out[key]} {a}"
    return out


def test_the_jax_script_calls_the_same_entry_points_and_reports_the_same_keys(
        run, jax_rehearsal, tmp_path, monkeypatch):
    _, root, report, calls = run
    jroot = tmp_path / "r"
    shutil.copytree(root, jroot)
    (jroot / "rehearsal_report.json").unlink()
    jax_calls = []

    def run_cli(args, timeout=7200, env=None):
        args = [str(a) for a in args]
        jax_calls.append(args)
        if args[0] == "scripts/train_dual_eeg.py":  # the JAX checkpoint the analysis looks for
            (jroot / "eeg_run" / "checkpoints" / "best_model").mkdir(parents=True)

    monkeypatch.setattr(jax_rehearsal, "run_cli", run_cli)
    assert jax_rehearsal.main(["--root", str(jroot), *FLAGS, "--stages",
                               "convert,windows,features,train,analyze"]) == 0
    want = json.loads((jroot / "rehearsal_report.json").read_text())

    # The same entry points in the same order, with the same flags and values.
    assert [f"scripts/{m.split('.')[-1]}.py" for m, _ in calls] == [a[0] for a in jax_calls]
    for (module, argv), jax_argv in zip(calls, jax_calls):
        got, exp = argv_dict(argv), argv_dict(jax_argv[1:])
        assert set(got) - PORT_FLAGS == set(exp), module
        assert got.get("--device", "cpu") == "cpu"
        for flag, value in exp.items():
            if flag == "--checkpoint":  # the JAX package's is a directory, the port's a file
                value += ".pt"
            if flag != "--config":
                assert got[flag] == value.replace(str(jroot), str(root)), (module, flag)
    # The flagship's YAML is the JAX script's at the module's default widths.
    assert (jroot / "eeg_train_cfg.yaml").read_text() == port.eeg_train_yaml(
        jroot / "windows", jroot / "eeg_run", 1)

    # The JAX report's keys for every step, and the same counts.
    assert set(report) == set(want) | set(port.STAGES["gen"])
    for step in want:
        if step == "config":
            assert set(report[step]) == set(want[step]) | {"device"}
            continue
        extra = PORT_KEYS.get(step, set()) | {"peak_rss_gib", "k1_launches"}
        assert set(report[step]) == set(want[step]) | extra, step
    for step, key in (("windows_full", "train_windows"), ("windows_full", "val_windows"),
                      ("extract_features", "trials"), ("convert_eeg_csv", "roundtrip_max_err")):
        assert report[step][key] == want[step][key], (step, key)
    # The JAX report's "expected" is the full-scale pair always; the port's is
    # the pair split's at the run's trial count, the same at 4,463 trials.
    assert want["windows_full"]["expected"] == list(port.FULL_WINDOWS)
