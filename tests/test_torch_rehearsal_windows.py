"""The rehearsal's windows step against the JAX package's
``scripts/preprocess_eeg_windows.py`` on the same 32-trial volume, on the
CPU: the windows within the filtfilt preprocessing's 1e-3
(``tests/test_torch_offline_cli.py``), labels, pairs and split metadata
equal, the counts the pair split's."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import torch

from eyegaze_tpu_torch import rehearsal_full_scale as port

ROOT = Path(__file__).resolve().parent.parent
WINDOW_TOL = 1e-3


def test_windows_step_matches_the_jax_script(tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert port.main(["--root", str(tmp_path), "--trials", "32", "--stages",
                          "gen_metadata,gen_eeg_volume,windows", "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(threads)
    spec = importlib.util.spec_from_file_location("jax_preprocess_eeg_windows",
                                                  ROOT / "scripts" / "preprocess_eeg_windows.py")
    jax_windows = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_windows)
    # The JAX rehearsal's call (scripts/rehearsal_full_scale.py:267-280).
    jax_windows.main(["--input-dir", str(tmp_path / "eeg_npy"), "--output-dir",
                      str(tmp_path / "jax"), "--sampling-rate", "256", "--window-size", "1024",
                      "--stride", "256", "--split-mode", "pair"])
    got, want = tmp_path / "windows", tmp_path / "jax"
    report = json.loads((tmp_path / "rehearsal_report.json").read_text())
    assert report["windows_full"]["expected"] == [23 * 9, 9 * 9]
    for split, n in (("train", 23 * 9), ("val", 9 * 9)):
        for k in (1, 2):
            a, b = (np.load(d / f"{split}_eeg{k}.npy") for d in (got, want))
            assert a.shape == b.shape == (n, port.C, port.WINDOW)
            assert np.isfinite(a).all()
            assert np.abs(a - b).max() <= WINDOW_TOL, (split, k)
        for name in ("labels", "pairs"):
            a, b = (np.load(d / f"{split}_{name}.npy") for d in (got, want))
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert json.loads((got / f"{split}_metadata.json").read_text()) == \
            json.loads((want / f"{split}_metadata.json").read_text())
