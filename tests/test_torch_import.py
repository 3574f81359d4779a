"""Hygiene of the PyTorch port: it imports without jax, and its GPU smoke
script refuses to run (and reports no result) where there is no CUDA device."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import eyegaze_tpu_torch

ROOT = Path(__file__).resolve().parent.parent


def test_port_imports_without_jax():
    modules = sorted(m.name for m in pkgutil.walk_packages(eyegaze_tpu_torch.__path__,
                                                           "eyegaze_tpu_torch."))
    assert {"eyegaze_tpu_torch.kernels.phase_metrics",
            "eyegaze_tpu_torch.compare_phase_metrics"} <= set(modules)
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None  # any 'import jax' now raises ImportError\n"
        "import eyegaze_tpu_torch\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'eyegaze_tpu.'))\n"
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
