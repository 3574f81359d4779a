"""``python -m eyegaze_tpu_torch.analyze_gaze`` against the JAX package's
``scripts/analyze_gaze.py`` on one checkpoint: a tiny early-fusion ViT
('concat', the ``--tiny`` geometry: 64 px, embed 64, 2 blocks, 4 heads)
saved by the JAX ``CheckpointManager`` with its image size in the meta, and
its export by ``scripts/export_torch_checkpoint.py`` with the meta copied
beside it, which the port reads.  Both CLIs run with the same flags on the
same synthetic pairs (12 trials, one batch); the ``--compare`` run is in
tests/test_torch_analyze_gaze_compare.py.

- the two output trees are equal;
- the discrete tables (confusion matrix, classification report, overall
  metrics, per-pair accuracy, mechanism statistics) are equal to the byte
  where every trial's top-two logit margin clears the cross-framework
  tolerance: the port's logits stand within ``TOL`` of JAX's, so a port
  margin above ``3 * TOL`` implies a JAX margin above ``TOL``.  A table with
  a trial inside the margin is compared as floats, and the test reports it;
- the probabilities, the ROC AUCs and the saliency map as floats: the
  probabilities and AUCs at ``TOL``, the saliency (a gradient through the
  network) at ``TOL`` of the map's largest entry plus the file's ``%.6f``
  resolution.

``TOL`` is 1e-4: the float32 logits of this ViT on the two frameworks stand
about 1e-6 apart (tests/test_torch_vit.py holds them at 1e-6 of the largest
logit), and 1e-4 leaves room for the softmax and the CSV round trip.
"""

import csv
import importlib.util
import io
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyegaze_tpu.models.vit import EarlyFusionViT as JaxEarly
from eyegaze_tpu.models.vit import LateFusionViT as JaxLate
from eyegaze_tpu.train.checkpoint import CheckpointManager
from eyegaze_tpu.train.metrics import roc_curves as jax_roc_curves
from eyegaze_tpu.train.optim import make_optimizer
from eyegaze_tpu.train.state import create_train_state
from eyegaze_tpu_torch import analyze_gaze

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-4
TINY = dict(img_size=64, embed_dim=64, depth=2, num_heads=4)
FLAGS = ["--tiny", "--trials", "12"]
DISCRETE = ("confusion_matrix.csv", "classification_report.csv", "overall_metrics.csv",
            "per_pair_accuracy.csv", "mechanism_stats.csv")
_RUNS: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def checkpoint(tmp: Path, kind: str, mode: str, seed: int) -> tuple[Path, Path]:
    """(orbax checkpoint dir, the port's .pt with its meta beside it) of a
    tiny ViT drawn from ``seed``."""
    key = ("checkpoint", kind, mode)
    if key in _RUNS:
        return _RUNS[key]
    model = (JaxEarly if kind == "early" else JaxLate)(num_classes=3, fusion_mode=mode, **TINY)
    z = jnp.zeros((1, 3, 64, 64), jnp.float32)
    state = create_train_state(model, jax.jit(model.init)(jax.random.PRNGKey(seed), z, z),
                               make_optimizer(1e-3))
    config = {"model": {"kind": kind, "fusion_mode": mode, "img_size": 64, "num_labels": 3}}
    CheckpointManager(tmp / f"ckpt_{kind}_{mode}").save_if_best(0.5, state, config=config)
    ckpt = tmp / f"ckpt_{kind}_{mode}" / "best_model"
    out = tmp / f"{kind}_{mode}.pt"
    assert _script("export_torch_checkpoint").main([str(ckpt), "--out", str(out)]) == 0
    shutil.copy(ckpt.parent / "best_model.meta.json", out.with_suffix(".meta.json"))
    _RUNS[key] = ckpt, out
    return _RUNS[key]


def run_both(name: str, tmp: Path, jax_flags: list, port_flags: list) -> tuple[Path, Path, dict]:
    """Both CLIs: (JAX's output dir, the port's, the port's run result)."""
    if name in _RUNS:
        return _RUNS[name]
    want, got = tmp / f"jax_{name}", tmp / f"port_{name}"
    assert _script("analyze_gaze").main(FLAGS + jax_flags + ["--output-dir", str(want)]) == 0
    result = analyze_gaze.run(analyze_gaze.parse_args(
        FLAGS + port_flags + ["--output-dir", str(got), "--device", "cpu"]))
    _RUNS[name] = want, got, result
    return _RUNS[name]


def tree(root: Path) -> list:
    return sorted(str(p.relative_to(root)) + ("/" if p.is_dir() else "")
                  for p in root.rglob("*"))


def rows(path: Path) -> list:
    return list(csv.reader(io.StringIO(path.read_text())))


def margins(numbers: dict) -> np.ndarray:
    top2 = np.sort(numbers["logits"], axis=-1)
    return top2[:, -1] - top2[:, -2]


def assert_rows_close(got: list, want: list, what: str, tol: float = TOL) -> None:
    """Equal headers and text cells; numeric cells within ``tol``."""
    assert len(got) == len(want) and got[0] == want[0], what
    for g, w in zip(got[1:], want[1:]):
        assert len(g) == len(w), what
        for a, b in zip(g, w):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                assert a == b, what
                continue
            assert abs(fa - fb) <= tol or (np.isnan(fa) and np.isnan(fb)), (what, g, w)


def check_model_dir(want: Path, got: Path, numbers: dict) -> int:
    """Holds one model's files as the module docstring says; returns the
    trials inside the margin."""
    m = margins(numbers)
    inside = int((m <= 3 * TOL).sum())
    for name in DISCRETE:
        if inside == 0:
            assert (got / name).read_bytes() == (want / name).read_bytes(), name
        else:
            assert_rows_close(rows(got / name), rows(want / name), name)
    g, w = rows(got / "predictions.csv"), rows(want / "predictions.csv")
    assert g[0] == w[0] and len(g) == len(w) == len(m) + 1
    for margin, gr, wr in zip(m, g[1:], w[1:]):
        if margin > 3 * TOL:
            assert gr[:6] == wr[:6]
        np.testing.assert_allclose(np.float32(gr[6:]), np.float32(wr[6:]), rtol=0, atol=TOL)
    # The AUCs: JAX's roc_curves on JAX's probabilities against the port's.
    labels = np.asarray([int(r[3]) for r in w[1:]])
    want_roc = jax_roc_curves(labels, np.float32([r[6:] for r in w[1:]]))
    assert abs(numbers["roc"]["macro_auc"] - want_roc["macro_auc"]) <= TOL
    assert abs(numbers["roc"]["micro"]["auc"] - want_roc["micro"]["auc"]) <= TOL
    for c, d in want_roc["per_class"].items():
        assert abs(numbers["roc"]["per_class"][c]["auc"] - d["auc"]) <= TOL
    g, w = rows(got / "tsne_features.csv"), rows(want / "tsne_features.csv")
    assert g[0] == w[0] == ["Sample_ID", "True_Label", "Pred_Label", "Dim_1", "Dim_2"]
    assert [r[:2] for r in g] == [r[:2] for r in w]
    if (want / "saliency_sample.csv").exists():
        gs = np.loadtxt(got / "saliency_sample.csv", delimiter=",")
        ws = np.loadtxt(want / "saliency_sample.csv", delimiter=",")
        assert gs.shape == ws.shape == (64, 64)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=TOL * np.abs(ws).max() + 1e-6)
    return inside


@pytest.fixture(scope="module")
def single_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("analyze_gaze")
    ckpt, pt = checkpoint(tmp, "early", "concat", 3)
    return run_both("single", tmp, ["--checkpoint", str(ckpt)], ["--checkpoint", str(pt)])


def test_trees_are_equal(single_run):
    want, got, result = single_run
    assert tree(got) == tree(want)
    assert {"predictions.csv", "saliency_sample.csv", "mechanism_stats.csv",
            "per_pair_accuracy.png", "tsne_features.png"} <= set(tree(got))
    assert len(result["numbers"]) == 1 and result["results"][0].name == "early_concat"


def test_tables_match_under_the_margin_rule(single_run):
    want, got, result = single_run
    inside = check_model_dir(want, got, result["numbers"][0])
    print(f"trials inside the margin: {inside} of 12")


def test_numbers_come_before_any_writer(tmp_path, monkeypatch):
    """``analyze`` needs neither pandas nor matplotlib nor scikit-learn: it
    runs with all three blocked, as on the card's host; ``write`` then stops
    with an ImportError that names pandas."""
    for name in ("pandas", "matplotlib", "sklearn"):
        monkeypatch.setitem(sys.modules, name, None)
    args = analyze_gaze.parse_args(FLAGS + ["--trials", "6", "--device", "cpu"])
    val = analyze_gaze.validation_set(args.trials, args.tiny)
    numbers = analyze_gaze.analyze(analyze_gaze.load_model("early", "concat", True), "early",
                                   val, torch.device("cpu"))
    assert numbers["probs"].shape == (6, 3) and numbers["saliency"].shape == (2, 64, 64)
    assert set(numbers["mechanism"]) == {"com_distance_vs_correct", "iou_vs_correct",
                                         "com_per_class_tests"}
    with pytest.raises(ImportError, match="pandas"):
        analyze_gaze.write(numbers, tmp_path / "out")


def test_fails_without_cuda_unless_asked_for_the_cpu(tmp_path):
    """The card by default; without one it stops before it writes anything."""
    r = subprocess.run([sys.executable, "-m", "eyegaze_tpu_torch.analyze_gaze", "--tiny",
                        "--output-dir", str(tmp_path / "out")], cwd=ROOT, capture_output=True,
                       text=True, timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "needs a CUDA device" in r.stderr and "--device cpu" in r.stderr
    assert not (tmp_path / "out").exists()
