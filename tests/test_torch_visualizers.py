"""Every ``plot_*`` function of the port's ``utils/visualizers.py`` against
the JAX package's on seeded inputs: the same PNG, pixel for pixel, read
back with ``matplotlib.image.imread``.  A function added to either module
without a case here fails ``test_every_plot_function_has_a_case``."""

import numpy as np
import pytest

from eyegaze_tpu.train.metrics import roc_curves
from eyegaze_tpu.utils import visualizers as jax_viz
from eyegaze_tpu_torch.utils import visualizers as viz

CONDS = ("Single", "Competition", "Cooperation")


def _table(r):
    import pandas as pd

    return pd.DataFrame({"Model": ["early_concat", "late_full", "late_add"],
                         **{m: r.uniform(0.3, 0.9, 3) for m in
                            ("accuracy", "precision_macro", "recall_macro", "f1_macro")}})


def _roc(r):
    labels = np.arange(30) % 3
    probs = r.dirichlet(np.ones(3), 30) + np.eye(3)[labels] * r.uniform(0, 0.5, (30, 1))
    return roc_curves(labels, probs / probs.sum(1, keepdims=True))


def _by_cond(r, n=40):
    return {c: r.normal(4 + i * 0.5, 0.4, n) for i, c in enumerate(CONDS)}


def _watch(r):
    recs = []
    for epoch in range(3):
        counts, edges = np.histogram(r.normal(size=50), bins=20)
        recs.append({"epoch": epoch, "grad/head.weight": {
            "counts": counts.tolist(), "edges": [float(edges[0]), float(edges[-1])]}})
    return recs


def _positions(n):
    theta = np.linspace(0, 2 * np.pi, n, endpoint=False)
    radius = np.linspace(0.2, 0.9, n)
    return {f"ch{i}": (radius[i] * np.cos(t), radius[i] * np.sin(t)) for i, t in enumerate(theta)}


# name -> (args, kwargs) from a seeded generator; the output path follows
# the args.
CASES = {
    "plot_confusion_matrix": lambda r: ((r.integers(0, 20, (3, 3)),), {}),
    "plot_confusion_matrix_normalized": lambda r: ((r.integers(0, 20, (3, 3)),),
                                                   {"normalize": True}),
    "plot_roc_curves": lambda r: ((_roc(r),), {}),
    "plot_embedding_scatter": lambda r: ((r.normal(size=(30, 2)), np.arange(30) % 3), {}),
    "plot_learning_curves": lambda r: (([{"epoch": e, "train/loss": 1 / (e + 1),
                                          "val/f1_macro": 0.3 + 0.1 * e} for e in range(5)],),
                                       {}),
    "plot_metrics_comparison": lambda r: ((_table(r),), {}),
    "plot_confusion_matrix_grid": lambda r: (({m: r.integers(0, 20, (3, 3))
                                               for m in ("a", "b")},), {}),
    "plot_roc_overlay": lambda r: (({"a": _roc(r), "b": _roc(r)},), {}),
    "plot_per_class_comparison": lambda r: (({"a": r.random(3), "b": r.random(3)},), {}),
    "plot_radar_chart": lambda r: ((_table(r),), {}),
    "plot_raincloud": lambda r: ((_by_cond(r),), {}),
    "plot_per_pair_accuracy": lambda r: (({p: float(a) for p, a in
                                           zip(range(12, 20), r.random(8))},), {}),
    "plot_entropy_boxplot": lambda r: ((_by_cond(r),), {}),
    "plot_entropy_kde": lambda r: ((_by_cond(r),), {}),
    "plot_entropy_violin": lambda r: ((_by_cond(r),), {}),
    "plot_topomap": lambda r: ((r.normal(size=12), _positions(12),
                                [f"ch{i}" for i in range(12)]), {}),
    "plot_connectivity_heatmap": lambda r: ((r.random((8, 8)),),
                                            {"channel_names": [f"c{i}" for i in range(8)]}),
    "plot_attention_map": lambda r: ((r.random((20, 20)),),
                                     {"token_boundaries": {"ibs": 5, "spec": 12}}),
    "plot_gradcam": lambda r: ((r.random((16, 24)),), {}),
    "plot_entropy_correlation": lambda r: ((r.normal(size=30), r.normal(size=30)), {}),
    "plot_mechanism_analysis": lambda r: ((_by_cond(r, 20),), {}),
    "plot_saliency_overlay": lambda r: ((r.random((3, 32, 32)), r.random((8, 8))), {}),
    "plot_saliency_grid": lambda r: ((r.random((5, 3, 16, 16)), r.random((5, 16, 16))),
                                     {"labels": np.arange(5) % 3, "preds": np.arange(5)[::-1] % 3}),
    "plot_watch_norms": lambda r: (({"a.weight": r.random(4) + 0.1,
                                     "b.weight": r.random(4) * 1e-3 + 1e-4},), {}),
    "plot_watch_histogram_ridge": lambda r: ((_watch(r), "head.weight"), {}),
}


def _function(module, case: str):
    return getattr(module, case.replace("_normalized", ""))


def test_every_plot_function_has_a_case():
    names = {n for n in dir(viz) if n.startswith("plot_")}
    assert names == {n for n in dir(jax_viz) if n.startswith("plot_")}
    assert names == {c.replace("_normalized", "") for c in CASES}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plot_is_pixel_equal(tmp_path, case):
    import matplotlib.image as mpimg

    paths = []
    for module in (jax_viz, viz):
        args, kwargs = CASES[case](np.random.default_rng(sorted(CASES).index(case)))
        path = tmp_path / f"{module.__name__.split('.')[0]}.png"
        _function(module, case)(*args, path, **kwargs)
        paths.append(path)
    want, got = (mpimg.imread(p) for p in paths)
    assert want.shape == got.shape and want.size > 0
    np.testing.assert_array_equal(got, want)
