"""Nothing the benchmark runs loads JAX or the JAX package.

The names are compared by their whole top-level part: ``eyegaze_tpu_torch``
begins with ``eyegaze_tpu`` and is the program, not the JAX package.  The
check runs in a fresh process, since a test session may hold JAX already.
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "eyegaze_tpu", "bench", "chip_smoke"}

PROBE = r"""
import argparse, importlib, json, sys
import torch
torch.set_num_threads(1)
from portbench import calibrate, run
from portbench.tests.conftest import small_setup
bench = json.load(open("BENCHMARK.json"))
for cell in bench["workloads"]:
    setup = run.resolve(cell["name"])
    for m in setup["per_layer"]:
        run.metric_reader(m["name"])
for family in ("dual_eeg", "art"):
    for kind in ("serve", "train"):
        run.run_cell(small_setup(family, kind),
                     argparse.Namespace(seed=2 ** 31 + 5, seconds=0.2, trace=0),
                     torch.device("cpu"))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_forbidden_module_is_loaded():
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "eyegaze_tpu_torch" in loaded  # the program was driven
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_no_source_imports_them():
    for path in (ROOT / "portbench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_the_run_refuses_a_forbidden_module():
    from portbench import run

    sys.modules["flaxen_stand_in"] = None  # only whole top-level names count
    try:
        assert "flaxen_stand_in" not in run.forbidden_modules()
    finally:
        del sys.modules["flaxen_stand_in"]
    had = "flax" in sys.modules
    saved = sys.modules.setdefault("flax", None)  # a name present in sys.modules counts
    try:
        assert "flax" in run.forbidden_modules()
    finally:
        if not had:
            del sys.modules["flax"]
        else:
            sys.modules["flax"] = saved
