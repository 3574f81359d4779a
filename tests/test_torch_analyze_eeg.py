"""``python -m eyegaze_tpu_torch.analyze_eeg`` against the JAX package's
``scripts/analyze_eeg.py`` on one checkpoint: an orbax checkpoint saved by
the JAX ``CheckpointManager`` (C = 8, d_model 32, one layer), and its export
by ``scripts/export_torch_checkpoint.py`` with the meta copied beside it,
which the port reads.  Both CLIs run with the same flags on the same
synthetic validation split (3 trials, 21 windows of 256 samples, in one
batch: every JAX stage compiles once; tests/test_torch_introspect*.py hold
the functions over several batches).

Here the metrics, frequency and embedding stages (the ibs, attention and
Grad-CAM stages are in tests/test_torch_analyze_eeg_maps.py, which spreads
the JAX compiles over the lane's workers):

- the two output trees are equal;
- the discrete tables are equal to the byte: predictions.csv's label
  columns, confusion_matrix.csv, classification_report.csv,
  overall_metrics.csv and band_sensitivity.csv.  They come from argmaxes, so
  they are held to the byte only where every row's top-two logit margin
  clears the cross-framework tolerance on the JAX side; the port's logits
  stand within ``TOL`` of JAX's, so a port margin above ``3 * TOL`` implies
  a JAX margin above ``TOL``.  A table with a row inside the margin is
  compared as floats, and the test reports it;
- the probabilities, the AUCs and the t-SNE files' label columns as floats
  at ``TOL`` (the coordinates of two t-SNE runs on features 2e-3 apart are
  not compared);
- both runs render their figures (``--render-figures``): the same figure
  files, here the grouped frequency-sensitivity bar (the suites: in
  tests/test_torch_analyze_eeg_maps.py).
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

from eyegaze_tpu.models.dual_eeg import DualEEGTransformer as JaxDualEEG
from eyegaze_tpu.train.checkpoint import CheckpointManager
from eyegaze_tpu.train.optim import make_optimizer
from eyegaze_tpu.train.state import create_train_state
from eyegaze_tpu_torch import analyze_eeg
from eyegaze_tpu_torch.analysis import BAND_NAMES, run_inference

ROOT = Path(__file__).resolve().parent.parent
TOL = 2e-3
C, WINDOW = 8, 256
MODEL = {"in_channels": C, "num_labels": 3, "d_model": 32, "num_layers": 1, "num_heads": 4,
         "d_ff": 64}
CONFIG = {"model": MODEL,
          "ablation": {"use_spectrogram": True, "use_ibs": True, "ibs_mode": "robust",
                       "use_cross_attention": True, "ibs_instance_norm": True,
                       "ibs_feature_type": "all"},
          "data": {"sampling_rate": 256.0}}
FLAGS = ["--trials", "12", "--channels", str(C), "--window", str(WINDOW), "--batch-size", "32"]
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


def checkpoint(tmp: Path) -> tuple[Path, Path]:
    """(orbax checkpoint dir, the port's .pt with its meta beside it)."""
    if "checkpoint" in _RUNS:
        return _RUNS["checkpoint"]
    model = JaxDualEEG(**{k: v for k, v in MODEL.items() if k != "num_labels"})
    e = jnp.zeros((1, C, WINDOW), jnp.float32)
    state = create_train_state(model, jax.jit(model.init)(jax.random.PRNGKey(2), e, e),
                               make_optimizer(1e-3))
    CheckpointManager(tmp / "ckpt").save_if_best(0.5, state, config=CONFIG)
    ckpt = tmp / "ckpt" / "best_model"
    out = tmp / "model.pt"
    assert _script("export_torch_checkpoint").main([str(ckpt), "--out", str(out)]) == 0
    shutil.copy(ckpt.parent / "best_model.meta.json", out.with_suffix(".meta.json"))
    _RUNS["checkpoint"] = ckpt, out
    return ckpt, out


def run_both(analyses: str, tmp: Path) -> tuple[Path, Path, dict]:
    """Both CLIs with ``--analyses analyses --render-figures`` on the one
    checkpoint: (JAX's output dir, the port's, the port's run summary)."""
    if analyses in _RUNS:
        return _RUNS[analyses]
    ckpt, pt = checkpoint(tmp)
    want, got = tmp / f"jax_{analyses}", tmp / f"port_{analyses}"
    assert _script("analyze_eeg").main(FLAGS + ["--checkpoint", str(ckpt), "--analyses", analyses,
                                                "--render-figures", "--output-dir", str(want)]) == 0
    summary = analyze_eeg.run(analyze_eeg.parse_args(
        FLAGS + ["--checkpoint", str(pt), "--analyses", analyses, "--render-figures",
                 "--output-dir", str(got), "--device", "cpu"]))
    _RUNS[analyses] = want, got, summary
    return _RUNS[analyses]


def tree(root: Path) -> list:
    return sorted(str(p.relative_to(root)) + ("/" if p.is_dir() else "")
                  for p in root.rglob("*"))


def rows(path: Path) -> list:
    return list(csv.reader(io.StringIO(path.read_text())))


def port_margins(args_flags: list, pt: Path, band: int = -1) -> np.ndarray:
    """The port's top-two logit margin of every analysed window, with
    ``band`` masked where >= 0."""
    args = analyze_eeg.parse_args(args_flags + ["--checkpoint", str(pt), "--device", "cpu"])
    model, _ = analyze_eeg.load_model(args, torch.device("cpu"))
    if band >= 0:
        model = model.with_mask_band(band)
    top2 = np.sort(run_inference(model, analyze_eeg.make_batches(args)())["logits"], axis=-1)
    return top2[:, -1] - top2[:, -2]


def assert_rows_close(got: list, want: list, what: str) -> None:
    """Equal headers and text cells; numeric cells within ``TOL``."""
    assert len(got) == len(want) and got[0] == want[0], what
    for g, w in zip(got[1:], want[1:]):
        assert len(g) == len(w), what
        for a, b in zip(g, w):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                assert a == b, what
                continue
            assert abs(fa - fb) <= TOL, (what, g, w)


@pytest.fixture(scope="module")
def stage_runs(tmp_path_factory):
    return run_both("metrics,frequency,embedding", tmp_path_factory.mktemp("analyze"))


def test_trees_are_equal(stage_runs):
    want, got, summary = stage_runs
    assert tree(got) == tree(want)
    assert {"core_metrics/predictions.csv", "frequency_sensitivity/band_sensitivity.csv",
            "feature_embeddings/tsne_z_fuse.csv"} <= set(tree(got))
    # 21 windows in one batch: one inference pass and six masked ones.
    assert summary["batches"] == 1
    assert summary["planned"] == {"inference": 1, "frequency": 6}


def test_discrete_tables_are_equal_to_the_byte(stage_runs):
    want, got, _ = stage_runs
    _, pt = _RUNS["checkpoint"]
    clear = bool((port_margins(FLAGS, pt) > 3 * TOL).all())
    tables = ["confusion_matrix.csv", "classification_report.csv", "overall_metrics.csv"]
    if clear:
        for name in tables:
            assert (got / "core_metrics" / name).read_bytes() == \
                (want / "core_metrics" / name).read_bytes(), name
    else:
        print("a window lies inside the margin: core metrics compared as floats")
        for name in tables:
            assert_rows_close(rows(got / "core_metrics" / name),
                              rows(want / "core_metrics" / name), name)
    g, w = rows(got / "core_metrics" / "predictions.csv"), rows(want / "core_metrics" / "predictions.csv")
    assert g[0] == w[0] and len(g) == len(w) == 22
    margins = port_margins(FLAGS, pt)
    for m, gr, wr in zip(margins, g[1:], w[1:]):
        if m > 3 * TOL:
            assert gr[:6] == wr[:6]
        np.testing.assert_allclose(np.float32(gr[6:]), np.float32(wr[6:]), rtol=0, atol=TOL)
    print(f"windows inside the margin: {int((margins <= 3 * TOL).sum())} of {len(margins)}")


def test_band_sensitivity_is_equal_to_the_byte(stage_runs):
    want, got, _ = stage_runs
    _, pt = _RUNS["checkpoint"]
    name = "frequency_sensitivity/band_sensitivity.csv"
    unclear = {band: int((port_margins(FLAGS, pt, b) <= 3 * TOL).sum()) + int(
        (port_margins(FLAGS, pt) <= 3 * TOL).sum()) for b, band in enumerate(BAND_NAMES)}
    if not any(unclear.values()):
        assert (got / name).read_bytes() == (want / name).read_bytes()
    else:
        print(f"windows inside the margin, per band: {unclear}: compared as floats")
        assert_rows_close(rows(got / name), rows(want / name), name)


def test_probabilities_aucs_and_embedding_labels(stage_runs):
    want, got, _ = stage_runs
    assert_rows_close(rows(got / "core_metrics" / "roc_auc.csv"),
                      rows(want / "core_metrics" / "roc_auc.csv"), "roc_auc")
    for name in ("tsne_z_fuse.csv", "tsne_ibs_token.csv"):
        g, w = rows(got / "feature_embeddings" / name), rows(want / "feature_embeddings" / name)
        assert g[0] == w[0] == ["Sample_ID", "True_Label", "Pred_Label", "Dim_1", "Dim_2"]
        assert [r[:2] for r in g] == [r[:2] for r in w]
        assert all(np.isfinite(np.float64(r[3:])).all() for r in g[1:])


def test_figures_are_the_jax_scripts(stage_runs):
    want, got, summary = stage_runs
    figures = [p for p in tree(got) if p.startswith("figures")]
    assert figures == [p for p in tree(want) if p.startswith("figures")]
    assert "figures/freq_sensitivity_grouped_bar.png" in figures
    # The tree holds no stage a suite reads: every suite comes back empty.
    assert not [p for p in figures if p.endswith("_native/")]
    assert list(summary["stages"]) == ["inference", "metrics", "frequency", "embedding",
                                       "figures"]


def test_render_figures_is_refused(tmp_path):
    """``--render-figures`` renders the figure suites (against the JAX
    script's in tests/test_torch_analyze_eeg_figures*.py); where pandas and
    matplotlib are missing, as on the card's host, it is refused with an
    ImportError that names pandas, after every number has been computed and
    its CSV written."""
    _, pt = checkpoint(tmp_path)
    out = tmp_path / "out"
    argv = FLAGS + ["--checkpoint", str(pt), "--analyses", "frequency,ibs", "--render-figures",
                    "--device", "cpu", "--output-dir", str(out)]
    code = ("import sys\n"
            "sys.modules['pandas'] = sys.modules['matplotlib'] = None\n"
            "from eyegaze_tpu_torch import analyze_eeg\n"
            f"analyze_eeg.main({argv!r})\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode != 0
    assert "ImportError" in r.stderr and "needs pandas" in r.stderr
    assert (out / "frequency_sensitivity" / "band_sensitivity.csv").exists()
    assert (out / "ibs_connectivity" / "channel_names.csv").exists()
    assert not list(out.rglob("*.png"))


def test_fails_without_cuda_unless_asked_for_the_cpu(tmp_path):
    """Like the port's other entry points: the card by default; without one
    it stops before it writes anything."""
    r = subprocess.run([sys.executable, "-m", "eyegaze_tpu_torch.analyze_eeg", "--output-dir",
                        str(tmp_path / "out")], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "needs a CUDA device" in r.stderr and "--device cpu" in r.stderr
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("fn", ["tsne_embed", "pca_embed"])
def test_embedding_without_sklearn_raises_naming_it(monkeypatch, fn):
    """The card's host has no scikit-learn: the embedding stage stops there
    with an ImportError that names the package, and skips nothing."""
    from eyegaze_tpu_torch.analysis import embedding

    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(ImportError, match=r"scikit-learn \(sklearn\)"):
        getattr(embedding, fn)(np.zeros((5, 3), np.float32))
