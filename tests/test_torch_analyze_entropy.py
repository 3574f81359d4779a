"""``python -m eyegaze_tpu_torch.analyze_entropy`` against the JAX package's
``scripts/analyze_entropy.py``.

- ``--mock``: no device work; every file of the two trees is equal to the
  byte, the PNGs included.
- The numeric functions run without pandas, matplotlib and PIL (the card's
  host has none of them), and the writers then stop with an ImportError
  naming pandas; without a CUDA device and without ``--device cpu`` it
  stops before it writes anything.

The real-file and synthetic paths are in
tests/test_torch_analyze_entropy_paths.py.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from eyegaze_tpu_torch import analyze_entropy

ROOT = Path(__file__).resolve().parent.parent


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tree(root: Path) -> list:
    return sorted(str(p.relative_to(root)) + ("/" if p.is_dir() else "")
                  for p in root.rglob("*"))


def test_mock_trees_are_equal_to_the_byte(tmp_path):
    want, got = tmp_path / "jax", tmp_path / "port"
    assert _script("analyze_entropy").main(["--mock", "--output-dir", str(want)]) == 0
    assert analyze_entropy.main(["--mock", "--output-dir", str(got), "--device", "cpu"]) == 0
    assert tree(got) == tree(want)
    assert {"gaze_entropy_raw.csv", "eeg_entropy_by_pair.csv", "eeg_entropy_tests.csv",
            "eeg_entropy_topomap_coop_minus_comp.png", "figures/fig_correlation.png"} <= \
        set(tree(got))
    for name in tree(want):
        if not name.endswith("/"):
            assert (got / name).read_bytes() == (want / name).read_bytes(), name


def test_numbers_need_no_pandas_matplotlib_or_pil(tmp_path, monkeypatch):
    for name in ("pandas", "matplotlib", "PIL"):
        monkeypatch.setitem(sys.modules, name, None)
    args = analyze_entropy.parse_args(["--trials", "6", "--device", "cpu",
                                       "--output-dir", str(tmp_path)])
    gaze, eeg, stats = analyze_entropy.compute(args, torch.device("cpu"))
    assert len(gaze["spatial_entropy"]) == len(eeg["Fp1"]) == 6
    assert set(stats) == {"gaze", "eeg"}
    summary, tests = stats["eeg"]
    assert [r["Condition"] for r in summary] == ["Single", "Competition", "Cooperation"]
    assert [(t["A"], t["B"]) for t in tests] == [("Single", "Competition"),
                                                 ("Single", "Cooperation"),
                                                 ("Competition", "Cooperation")]
    with pytest.raises(ImportError, match="pandas"):
        analyze_entropy.write(tmp_path, gaze, eeg, stats)


def test_fails_without_cuda_unless_asked_for_the_cpu(tmp_path):
    r = subprocess.run([sys.executable, "-m", "eyegaze_tpu_torch.analyze_entropy", "--mock",
                        "--output-dir", str(tmp_path / "out")], cwd=ROOT, capture_output=True,
                       text=True, timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "needs a CUDA device" in r.stderr and "--device cpu" in r.stderr
    assert not (tmp_path / "out").exists()
