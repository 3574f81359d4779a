"""Hygiene of the PyTorch port: it imports without jax, pandas, matplotlib,
scikit-learn and PIL (the functions that write tables, draw figures, embed
or decode images import them when called), and its GPU smoke
script and entry points refuse to run (and report no result) where there
is no CUDA device, unless asked for the CPU."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import eyegaze_tpu_torch

ROOT = Path(__file__).resolve().parent.parent


def test_port_imports_without_jax():
    modules = sorted(m.name for m in pkgutil.walk_packages(eyegaze_tpu_torch.__path__,
                                                           "eyegaze_tpu_torch."))
    assert {"eyegaze_tpu_torch.kernels.phase_metrics",
            "eyegaze_tpu_torch.compare_phase_metrics", "eyegaze_tpu_torch.serve",
            "eyegaze_tpu_torch.config", "eyegaze_tpu_torch.data.metadata",
            "eyegaze_tpu_torch.data.windows", "eyegaze_tpu_torch.data.loader",
            "eyegaze_tpu_torch.data.synthetic", "eyegaze_tpu_torch.train.losses",
            "eyegaze_tpu_torch.train.optim", "eyegaze_tpu_torch.train.metrics",
            "eyegaze_tpu_torch.train.checkpoint", "eyegaze_tpu_torch.train.trainer",
            "eyegaze_tpu_torch.utils.logging", "eyegaze_tpu_torch.train_dual_eeg",
            "eyegaze_tpu_torch.run_experiments", "eyegaze_tpu_torch.train_art",
            "eyegaze_tpu_torch.data.art_data", "eyegaze_tpu_torch.data.native",
            "eyegaze_tpu_torch.data.image_fusion", "eyegaze_tpu_torch.models.vit",
            "eyegaze_tpu_torch.data.images", "eyegaze_tpu_torch.data.gaze_augment",
            "eyegaze_tpu_torch.convert_gaze_images", "eyegaze_tpu_torch.train_gaze",
            "eyegaze_tpu_torch.models.fuzzy_fusion",
            "eyegaze_tpu_torch.models.multimodal", "eyegaze_tpu_torch.train_multimodal",
            "eyegaze_tpu_torch.models.hypereeg", "eyegaze_tpu_torch.data.augment",
            "eyegaze_tpu_torch.train_hypereeg", "eyegaze_tpu_torch.ops.features",
            "eyegaze_tpu_torch.ops.entropy", "eyegaze_tpu_torch.preprocess_eeg_raw",
            "eyegaze_tpu_torch.preprocess_eeg_windows", "eyegaze_tpu_torch.extract_eeg_features",
            "eyegaze_tpu_torch.generate_metadata",
            "eyegaze_tpu_torch.verify_metadata", "eyegaze_tpu_torch.import_torch_checkpoint",
            "eyegaze_tpu_torch.analysis", "eyegaze_tpu_torch.analysis.eeg_introspect",
            "eyegaze_tpu_torch.analysis.gaze_introspect", "eyegaze_tpu_torch.analysis.embedding",
            "eyegaze_tpu_torch.utils.io_csv", "eyegaze_tpu_torch.analyze_eeg",
            "eyegaze_tpu_torch.utils.lazy", "eyegaze_tpu_torch.utils.visualizers",
            "eyegaze_tpu_torch.analysis.error_analysis", "eyegaze_tpu_torch.analysis.comparison",
            "eyegaze_tpu_torch.analysis.learning_curves",
            "eyegaze_tpu_torch.analysis.matlab_parity", "eyegaze_tpu_torch.analyze_gaze",
            "eyegaze_tpu_torch.analyze_entropy", "eyegaze_tpu_torch.render_matlab_figures",
            "eyegaze_tpu_torch.run_analysis",
            "eyegaze_tpu_torch.rehearsal_full_scale", "eyegaze_tpu_torch.parallel",
            "eyegaze_tpu_torch.parallel.mesh", "eyegaze_tpu_torch.parallel.sharding",
            "eyegaze_tpu_torch.parallel.multihost"} <= set(modules)
    code = (
        "import importlib, sys\n"
        "for banned in ('jax', 'flax', 'optax', 'orbax', 'eyegaze_tpu', 'pandas', 'matplotlib',\n"
        "               'sklearn'):\n"
        "    sys.modules[banned] = None  # any import of it now raises ImportError\n"
        "sys.modules['PIL'] = None\n"
        "import eyegaze_tpu_torch\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', 'eyegaze_tpu',\n"
        "                                   'pandas', 'matplotlib', 'sklearn')\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "ok"


def test_chip_smoke_fails_without_cuda():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a CUDA device" in r.stderr


def test_compare_attention_fails_without_cuda():
    r = subprocess.run([sys.executable, "-m", "eyegaze_tpu_torch.compare_attention", "old.cu"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "needs a CUDA device" in r.stderr


def test_compare_phase_metrics_fails_without_cuda():
    r = subprocess.run([sys.executable, "-m", "eyegaze_tpu_torch.compare_phase_metrics", "old.cu"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "needs a CUDA device" in r.stderr
    assert '"shapes"' not in r.stdout


def test_serve_fails_without_cuda_unless_asked_for_the_cpu():
    """The HTTP entry point serves on the card by default; without one it
    stops before it loads anything, rather than serve on the CPU."""
    r = subprocess.run([sys.executable, "-m", "eyegaze_tpu_torch.serve", "--checkpoint",
                        "model.pt", "--port", "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "needs a CUDA device" in r.stderr and "--device cpu" in r.stderr
    assert "listening" not in r.stdout


def test_train_fails_without_cuda_unless_asked_for_the_cpu():
    """The training entry point trains on the card by default (the YAML's
    "tpu" included); without one it stops before it builds anything."""
    r = subprocess.run([sys.executable, "-m", "eyegaze_tpu_torch.train_dual_eeg", "--config",
                        "configs/dual_eeg_transformer.yaml"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "needs a CUDA device" in r.stderr and "--device cpu" in r.stderr
    assert "[model]" not in r.stdout


def test_train_art_fails_without_cuda_unless_asked_for_the_cpu():
    """The ART training entry point trains on the card by default; without
    one it stops before it builds anything."""
    r = subprocess.run([sys.executable, "-m", "eyegaze_tpu_torch.train_art", "--tiny"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "needs a CUDA device" in r.stderr and "--device cpu" in r.stderr
    assert "[model]" not in r.stdout


def test_train_gaze_fails_without_cuda_unless_asked_for_the_cpu():
    """The gaze training entry point trains on the card by default (the
    YAML's "tpu" included); without one it stops before it builds anything."""
    r = subprocess.run([sys.executable, "-m", "eyegaze_tpu_torch.train_gaze", "--config",
                        "configs/gaze_earlyfusion.yaml", "--tiny"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "needs a CUDA device" in r.stderr and "--device cpu" in r.stderr
    assert "[model]" not in r.stdout


@pytest.mark.parametrize("argv", [
    ["eyegaze_tpu_torch.train_multimodal", "--config", "configs/multimodal_fuzzy_fusion.yaml",
     "--tiny"],
    ["eyegaze_tpu_torch.train_hypereeg", "--tiny"],
], ids=["train_multimodal", "train_hypereeg"])
def test_multimodal_and_hypereeg_training_fail_without_cuda_unless_asked_for_the_cpu(argv):
    """The multimodal and HyperEEG training entry points train on the card
    by default (the YAML's "tpu" included); without one they stop before
    they build anything."""
    r = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "needs a CUDA device" in r.stderr and "--device cpu" in r.stderr
    assert "[model]" not in r.stdout


@pytest.mark.parametrize("argv", [
    ["eyegaze_tpu_torch.preprocess_eeg_windows", "--synthetic-trials", "3"],
    ["eyegaze_tpu_torch.extract_eeg_features", "--synthetic-trials", "1"],
], ids=["preprocess_eeg_windows", "extract_eeg_features"])
def test_offline_eeg_entry_points_fail_without_cuda_unless_asked_for_the_cpu(argv, tmp_path):
    """The offline EEG entry points that compute run on the card by
    default; without one they stop before they read or write anything."""
    r = subprocess.run([sys.executable, "-m", *argv, "--output-dir", str(tmp_path / "out")],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "needs a CUDA device" in r.stderr and "--device cpu" in r.stderr
    assert "synthetic mode" not in r.stdout
    assert not (tmp_path / "out").exists()
