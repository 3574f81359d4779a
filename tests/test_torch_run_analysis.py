"""``python -m eyegaze_tpu_torch.run_analysis --tiny --only early:concat
late:full --device cpu``: one ``analyze_gaze`` run per spec, a PASS line
each, exit code 0, and each run's tree as ``analyze_gaze`` writes it; a
failing run is reported and makes the exit code 1."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FILES = {"classification_report.csv", "confusion_matrix.csv", "confusion_matrix.png",
         "mechanism_stats.csv", "overall_metrics.csv", "per_pair_accuracy.csv",
         "per_pair_accuracy.png", "predictions.csv", "roc_curves.png", "tsne_features.csv",
         "tsne_features.png"}


def _run(*argv):
    return subprocess.run([sys.executable, "-m", "eyegaze_tpu_torch.run_analysis", *argv],
                          cwd=ROOT, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})


def test_runs_each_spec_on_the_cpu(tmp_path):
    r = _run("--tiny", "--trials", "9", "--only", "early:concat", "late:full", "--device", "cpu",
             "--output-dir", str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "  PASS  early:concat" in r.stdout and "  PASS  late:full" in r.stdout
    assert "FAIL" not in r.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == ["early_concat", "late_full"]
    assert {p.name for p in (tmp_path / "early_concat").iterdir()} == \
        FILES | {"saliency_sample.csv"}
    assert {p.name for p in (tmp_path / "late_full").iterdir()} == FILES


def test_a_failed_run_sets_the_exit_code(tmp_path):
    """Without a CUDA device and without ``--device cpu`` every run fails,
    and the runner goes on to the next."""
    r = subprocess.run([sys.executable, "-m", "eyegaze_tpu_torch.run_analysis", "--tiny",
                        "--only", "early:add", "late:add", "--output-dir", str(tmp_path)],
                       cwd=ROOT, capture_output=True, text=True, timeout=600,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 1
    assert "  FAIL  early:add" in r.stdout and "  FAIL  late:add" in r.stdout
    assert r.stderr.count("needs a CUDA device") == 2
