"""The port's error analysis, model comparison and learning curves
(``analysis/{error_analysis,comparison,learning_curves}.py``) against the
JAX package's, on the inputs of tests/test_analysis.py: equal outputs,
equal tables to the byte, the comparison figures pixel-equal.  Then the
histories the port's own ``RunLogger`` writes (``train_dual_eeg`` with
``--watch``), read back.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from eyegaze_tpu.analysis import comparison as jax_comparison
from eyegaze_tpu.analysis import error_analysis as jax_error
from eyegaze_tpu.analysis import learning_curves as jax_curves
from eyegaze_tpu_torch import train_dual_eeg
from eyegaze_tpu_torch.analysis import comparison, error_analysis, learning_curves
from eyegaze_tpu_torch.config import config_from_dict
from eyegaze_tpu_torch.train_dual_eeg import BENCH_LOSSES


def test_error_analyzer_matches():
    labels = np.asarray([0, 1, 2, 0, 1, 2, 1, 0])
    preds = np.asarray([0, 1, 1, 0, 2, 2, 0, 2])
    pairs = np.asarray([12, 12, 13, 13, 14, 14, 15, 15])
    got = error_analysis.ErrorAnalyzer(labels, preds, pairs)
    want = jax_error.ErrorAnalyzer(labels, preds, pairs)
    assert got.per_pair_accuracy() == want.per_pair_accuracy()
    assert got.hard_pairs(threshold=0.75) == want.hard_pairs(threshold=0.75) == [13, 14, 15]
    assert got.error_distribution() == want.error_distribution()
    assert got.confusion_patterns() == want.confusion_patterns()


def test_mechanism_analyzer_matches():
    got, want = error_analysis.MechanismAnalyzer, jax_error.MechanismAnalyzer
    r = np.random.default_rng(4)
    a, b = r.random((2, 3, 16, 16)).astype(np.float32)
    np.testing.assert_array_equal(got.center_of_mass(a), want.center_of_mass(a))
    assert got.com_distance(a, b) == want.com_distance(a, b)
    assert got.iou_overlap(a, b) == want.iou_overlap(a, b)
    assert got.iou_overlap(a[0], a[0]) == 1.0
    cls1, cls2 = r.normal(size=(2, 6, 8))
    np.testing.assert_array_equal(got.cls_cosine_correlation(cls1, cls2),
                                  want.cls_cosine_correlation(cls1, cls2))
    values, labels = r.normal(size=30), np.arange(30) % 3
    correct = r.random(30) > 0.4
    assert got.sensitivity_vs_correctness(values, correct) == \
        want.sensitivity_vs_correctness(values, correct)
    assert got.sensitivity_vs_correctness(values[:3], correct[:3] | True) == \
        want.sensitivity_vs_correctness(values[:3], correct[:3] | True)
    assert got.per_class_tests(values, labels) == want.per_class_tests(values, labels)


def _results(module, with_probs: bool):
    """tests/test_analysis.py's good and bad models (test_model_comparison,
    test_comparison_figure_suite), plus a third tied with the second."""
    r = np.random.default_rng(5 if with_probs else 3)
    n = 80 if with_probs else 60
    labels = r.integers(0, 3, n)
    noisy = labels.copy()
    noisy[:25 if with_probs else 20] = (noisy[:25 if with_probs else 20] + 1) % 3
    probs_a = np.eye(3)[labels] * 0.8 + 0.1 if with_probs else None
    probs_b = np.eye(3)[noisy] * 0.6 + 0.15 if with_probs else None
    return [module.ModelResults("good", labels, labels.copy(), probs=probs_a),
            module.ModelResults("bad", labels, noisy, probs=probs_b),
            module.ModelResults("bad_too", labels, noisy.copy(), probs=probs_b)]


@pytest.mark.parametrize("with_probs", [False, True], ids=["labels", "probs"])
def test_comparator_tables_match(tmp_path, with_probs):
    got = comparison.MultiModelComparator(_results(comparison, with_probs))
    want = jax_comparison.MultiModelComparator(_results(jax_comparison, with_probs))
    assert got.metric_table().equals(want.metric_table())
    for metric in ("f1_macro", "accuracy", "precision_weighted"):
        assert got.ranking(metric) == want.ranking(metric)
    assert got.ranking()[0] == "good"
    assert got.pairwise_significance().equals(want.pairwise_significance())
    assert got.pairwise_rows() == want.pairwise_significance().to_dict("records")
    for fn, name in (("to_csv", "cmp.csv"), ("to_latex", "cmp.tex")):
        getattr(got, fn)(tmp_path / f"port_{name}")
        getattr(want, fn)(tmp_path / f"jax_{name}")
        assert (tmp_path / f"port_{name}").read_bytes() == (tmp_path / f"jax_{name}").read_bytes()


def test_comparison_figure_suite_matches(tmp_path):
    import matplotlib.image as mpimg

    got = comparison.MultiModelComparator(_results(comparison, True)[:2]).plot_all(
        tmp_path / "port")
    want = jax_comparison.MultiModelComparator(_results(jax_comparison, True)[:2]).plot_all(
        tmp_path / "jax")
    assert [Path(p).name for p in got] == [Path(p).name for p in want]
    assert {Path(p).name for p in got} == {"metrics_comparison.png", "confusion_matrix_grid.png",
                                           "per_class_f1.png", "radar_chart.png",
                                           "roc_overlay.png"}
    for g, w in zip(got, want):
        np.testing.assert_array_equal(mpimg.imread(g), mpimg.imread(w), err_msg=g)


def _same(got, want):
    assert got.history == want.history
    for key in ("val/f1_macro", "val_f1", "train/loss"):
        g, w = got.series(key), want.series(key)
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert got.best_epoch(key) == want.best_epoch(key)
        assert got.best_epoch(key, greater_is_better=False) == \
            want.best_epoch(key, greater_is_better=False)
    assert got.summary() == want.summary()


def test_learning_curve_sources_match(tmp_path, capsys):
    (tmp_path / "log.csv").write_text(
        "epoch,train_loss,val_f1\n0,1.0,0.3\n1,0.5,0.7\n2,0.6,0.5\n")
    (tmp_path / "log.tsv").write_text("epoch\tval_f1\tnote\n0\t0.2\tx\n1\t0.4\ty\n")
    (tmp_path / "run.log").write_text(
        "[log] epoch=0 train/loss=1.00 val/f1_macro=0.30\n"
        "some unrelated line\n"
        "[log] epoch=1 train/loss=0.50 val/f1_macro=0.80\n")
    hist = [{"epoch": 0, "train/loss": 1.0, "val/f1_macro": 0.3, "time": 1.0},
            {"epoch": 1, "train/loss": 0.5, "val/f1_macro": 0.6, "time": 2.0},
            {"epoch": 2, "train/loss": 0.4, "val/f1_macro": 0.5, "time": 3.0}]
    (tmp_path / "run.jsonl").write_text("".join(json.dumps(h) + "\n" for h in hist))
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    for name, meta in (("best_model", {"epoch": 1, "val/f1_macro": 0.6}),
                       ("checkpoint_epoch_0", {"epoch": 0})):
        (ckpt / f"{name}.meta.json").write_text(json.dumps({"config": {}, **meta}))
    cls_got, cls_want = learning_curves.LearningCurveAnalyzer, jax_curves.LearningCurveAnalyzer
    for source in (lambda cls: cls.from_csv_log(tmp_path / "log.csv"),
                   lambda cls: cls.from_csv_log(tmp_path / "log.tsv", delimiter="\t"),
                   lambda cls: cls.from_text_log(tmp_path / "run.log"),
                   lambda cls: cls.from_jsonl(tmp_path / "run.jsonl"),
                   lambda cls: cls.from_checkpoint_meta(ckpt),
                   lambda cls: cls(hist)):
        _same(source(cls_got), source(cls_want))
    assert cls_got.from_csv_log(tmp_path / "log.csv").best_epoch("val_f1")["epoch"] == 1
    capsys.readouterr()
    assert cls_got.from_wandb("proj", "run") is None
    got_msg = capsys.readouterr().out
    assert cls_want.from_wandb("proj", "run") is None
    assert got_msg == capsys.readouterr().out
    runs = {"a": learning_curves.LearningCurveAnalyzer(hist),
            "b": learning_curves.LearningCurveAnalyzer.from_text_log(tmp_path / "run.log")}
    want = {"a": jax_curves.LearningCurveAnalyzer(hist),
            "b": jax_curves.LearningCurveAnalyzer.from_text_log(tmp_path / "run.log")}
    assert learning_curves.compare_training_histories(runs) == \
        jax_curves.compare_training_histories(want) == \
        {"a": {"epoch": 1, "val/f1_macro": 0.6}, "b": {"epoch": 1, "val/f1_macro": 0.8}}


def _watch_records():
    r = np.random.default_rng(9)
    recs = []
    for epoch in range(3):
        rec = {"epoch": epoch}
        for kind in ("param", "grad"):
            for layer, scale in (("head.weight", 1.0), ("hid.weight", 1e-9 if kind == "grad"
                                                        and epoch == 2 else 1.0)):
                v = r.normal(size=40) * scale
                counts, edges = np.histogram(v, bins=20)
                rec[f"{kind}/{layer}"] = {"counts": counts.tolist(),
                                          "edges": [float(edges[0]), float(edges[-1])],
                                          "l2": float(np.linalg.norm(v)), "mean": float(v.mean()),
                                          "std": float(v.std())}
        recs.append(rec)
    return recs


def test_watch_analyzer_matches(tmp_path):
    (tmp_path / "run_watch.jsonl").write_text(
        "".join(json.dumps(rec) + "\n" for rec in _watch_records()))
    got = learning_curves.WatchAnalyzer.for_run(tmp_path / "run.jsonl")
    want = jax_curves.WatchAnalyzer.for_run(tmp_path / "run.jsonl")
    assert got.records == want.records
    for kind in ("grad", "param"):
        assert got.layers(kind) == want.layers(kind) == ["head.weight", "hid.weight"]
        g, w = got.norm_table(kind), want.norm_table(kind)
        assert list(g) == list(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
        for stat in ("l2", "mean", "std"):
            for layer in got.layers(kind):
                for a, b in zip(got.series(layer, kind, stat), want.series(layer, kind, stat)):
                    np.testing.assert_array_equal(a, b)
    assert got.vanishing_or_exploding() == want.vanishing_or_exploding() == \
        {"hid.weight": "vanishing"}
    assert learning_curves.WatchAnalyzer.for_run(tmp_path / "nosuchrun.jsonl") is None


def test_reads_the_ports_own_run_logger(tmp_path):
    """``train_dual_eeg`` with ``watch=1`` (the ``--watch 1`` flag) at a
    small geometry for two epochs: its RunLogger JSONL and the watch
    sidecar, read back.  The best epoch's metric is the trainer's
    ``best_metric``; every watched layer has finite norms, one record per
    epoch; both frameworks' analyzers read the files alike."""
    cfg = config_from_dict({
        "model": {"in_channels": 8, "num_labels": 3, "d_model": 32, "num_layers": 1,
                  "num_heads": 4, "d_ff": 64},
        "data": {"window_size": 256, "stride": 256, "synthetic": True, "synthetic_trials": 9},
        "training": {"output_dir": str(tmp_path / "run"), "num_train_epochs": 2,
                     "per_device_train_batch_size": 8, "per_device_eval_batch_size": 8,
                     "learning_rate": 1e-3, "bf16": False, **BENCH_LOSSES},
        "system": {"seed": 0, "device": "cpu"}})
    result = train_dual_eeg.run(cfg, device=torch.device("cpu"), watch=1)
    jsonl = tmp_path / "run" / f"{cfg.wandb.run_name}.jsonl"
    lca = learning_curves.LearningCurveAnalyzer.from_jsonl(jsonl)
    assert [h["epoch"] for h in lca.history] == [0, 1]
    best = lca.best_epoch("val/f1_macro")
    assert best["val/f1_macro"] == result["best_metric"]
    assert jax_curves.LearningCurveAnalyzer.from_jsonl(jsonl).best_epoch("val/f1_macro") == best
    assert lca.summary() == jax_curves.LearningCurveAnalyzer.from_jsonl(jsonl).summary()

    wa = learning_curves.WatchAnalyzer.for_run(jsonl)
    assert wa is not None and len(wa.records) == 2
    names = [n for n, _ in result["trainer"].model.named_parameters()]
    assert wa.layers("param") == sorted(names)
    assert set(wa.layers("grad")) <= set(names) and wa.layers("grad")
    for kind in ("param", "grad"):
        for layer, l2 in wa.norm_table(kind).items():
            assert len(l2) == 2 and np.isfinite(l2).all(), (kind, layer)
    assert wa.records == jax_curves.WatchAnalyzer.for_run(jsonl).records
