"""``python -m eyegaze_tpu_torch.analyze_eeg`` against the JAX script: the
ibs, attention and Grad-CAM stages, on the checkpoint and flags of
tests/test_torch_analyze_eeg.py.

- the two output trees are equal;
- channel_names.csv and gradcam_metadata.csv are equal to the byte;
- the headerless ``%.6f`` matrices are parsed: the IBS class means and
  differences and the attention maps are held at 2e-3 (the cross-framework
  tolerance of this model), each Grad-CAM map at ``CAM_SHARE`` of its
  largest entry (a gradient through the whole network,
  tests/test_torch_introspect.py) plus the file's resolution, 1e-6 (two
  values closer than that can print one last digit apart); the
  attention_summary.csv as floats at 2e-3;
- both runs render the three MATLAB figure suites (``--render-figures``):
  the same artifact names, and the derived CSVs held at 2e-3, as the CSVs
  they are read from are (each derived value a mean of those values or an
  index into them); the Grad-CAM suite's at the maps' own bound.
"""

import numpy as np
import pytest

from eyegaze_tpu_torch.analysis import BAND_NAMES, FEATURE_NAMES
from tests.test_torch_analyze_eeg import (  # noqa: F401
    TOL,
    _one_thread,
    assert_rows_close,
    rows,
    run_both,
    tree,
)
from tests.test_torch_introspect import CAM_SHARE

CLASSES = ("Single", "Competition", "Cooperation")


@pytest.fixture(scope="module")
def stage_runs(tmp_path_factory):
    return run_both("ibs,attention,gradcam", tmp_path_factory.mktemp("analyze_maps"))


def _matrix(path):
    return np.loadtxt(path, delimiter=",", ndmin=2)


def test_trees_are_equal(stage_runs):
    want, got, summary = stage_runs
    assert tree(got) == tree(want)
    files = [p for p in tree(got) if p.startswith("ibs_connectivity/ibs_mean_by_class/")
             and not p.endswith("/")]
    assert len(files) == len(CLASSES) * len(BAND_NAMES) * len(FEATURE_NAMES)
    assert summary["planned"] == {"ibs": 1, "attention": 1, "gradcam": 1}


@pytest.mark.parametrize("name", ["ibs_connectivity/channel_names.csv",
                                  "gradcam/gradcam_metadata.csv"])
def test_index_tables_are_equal_to_the_byte(stage_runs, name):
    want, got, _ = stage_runs
    assert (got / name).read_bytes() == (want / name).read_bytes()


def test_ibs_matrices_match(stage_runs):
    want, got, _ = stage_runs
    paths = [p for p in tree(want) if p.endswith(".csv") and p.startswith("ibs_connectivity/ibs_")]
    assert len(paths) == 4 * len(BAND_NAMES) * len(FEATURE_NAMES)
    for p in paths:
        g, w = _matrix(got / p), _matrix(want / p)
        assert g.shape == w.shape == (8, 8), p
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=p)


def test_attention_maps_match(stage_runs):
    want, got, _ = stage_runs
    for p in ["attention_weights/mean_attention.csv"] + [
            f"attention_weights/attention_mean_by_class/attention_{c}.csv" for c in CLASSES]:
        g, w = _matrix(got / p), _matrix(want / p)
        assert g.shape == w.shape and g.shape[0] == g.shape[1], p
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=p)
    name = "attention_weights/attention_summary.csv"
    assert_rows_close(rows(got / name), rows(want / name), name)


def test_gradcam_maps_match(stage_runs):
    want, got, _ = stage_runs
    for c in CLASSES:
        p = f"gradcam/gradcam_mean_by_class/gradcam_{c}.csv"
        g, w = _matrix(got / p), _matrix(want / p)
        assert g.shape == w.shape == (64, 64), p
        scale = float(np.abs(w).max())
        assert scale > 0, p
        np.testing.assert_allclose(g, w, rtol=0, atol=CAM_SHARE * scale + 1e-6, err_msg=p)


def test_figure_suites_match(stage_runs):
    want, got, summary = stage_runs
    figures = [p for p in tree(got) if p.startswith("figures")]
    assert figures == [p for p in tree(want) if p.startswith("figures")]
    for suite in ("ibs_connectivity_native/ibs_summary.png",
                  "attention_weights_native/attention_summary.png",
                  "gradcam_native/gradcam_summary.png"):
        assert f"figures/{suite}" in figures
    assert "figures" in summary["stages"]
    for p in ("ibs_connectivity_native/ibs_roi_stats.csv",
              "ibs_connectivity_native/ibs_band_stats.csv",
              "attention_weights_native/attention_statistics.csv",
              "attention_weights_native/attention_lag_profile.csv"):
        assert_rows_close(rows(got / "figures" / p), rows(want / "figures" / p), p)
    scale = max(float(np.abs(_matrix(want / f"gradcam/gradcam_mean_by_class/gradcam_{c}.csv"))
                      .max()) for c in CLASSES)
    for p in ("gradcam_native/gradcam_band_stats.csv",
              "gradcam_native/gradcam_frequency_profile.csv",
              "gradcam_native/gradcam_temporal_profile.csv"):
        g, w = rows(got / "figures" / p), rows(want / "figures" / p)
        assert g[0] == w[0] and [r[0] for r in g] == [r[0] for r in w], p
        np.testing.assert_allclose(np.float64([r[1:] for r in g[1:]]),
                                   np.float64([r[1:] for r in w[1:]]), rtol=0,
                                   atol=CAM_SHARE * scale + 1e-6, err_msg=p)
