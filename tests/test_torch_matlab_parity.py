"""The port's MATLAB figure suites (``analysis/matlab_parity.py``) against
the JAX package's: the IBS suite and ``render_all_suites`` here, the
attention, Grad-CAM and entropy suites in
tests/test_torch_matlab_parity_{attention,gradcam,entropy}.py (each suite
takes seconds to render, so the lane's workers share them).

The input trees are tests/test_matlab_parity.py's ``result_tree`` and
``entropy_tree``, written by the JAX package's ``io_csv`` and pandas.  Both packages render the same tree; they must give the
same artifact names, byte-equal derived CSVs and pixel-equal PNGs (read
back with ``matplotlib.image.imread``).
"""

from pathlib import Path

import numpy as np

from eyegaze_tpu.analysis import matlab_parity as jax_mp
from eyegaze_tpu.utils import io_csv as jax_io_csv
from eyegaze_tpu_torch.analysis import matlab_parity as mp
from tests.test_matlab_parity import (
    CHANNELS,
    GRADCAM_ARTIFACTS,
    IBS_ARTIFACTS,
    N_CH,
    SEQ,
)

CLASSES = mp.CLASSES


def build_result_tree(root: Path) -> Path:
    """tests/test_matlab_parity.py's ``result_tree``: an analyze_eeg output
    tree from seed 7."""
    rng = np.random.default_rng(7)
    dirs = jax_io_csv.ensure_output_dirs(root)
    jax_io_csv.save_channel_names(CHANNELS, dirs["ibs_connectivity"] / "channel_names.csv")
    mats = {}
    for cname in CLASSES:
        for band in mp.BANDS_6:
            m = rng.uniform(0.2, 0.9, size=(N_CH, N_CH))
            mats[(cname, band)] = m
            jax_io_csv.save_ibs_matrix(m, dirs["ibs_mean_by_class"] / f"{cname}_{band}_PLV.csv")
    for band in mp.BANDS_6:
        diff = mats[("Cooperation", band)] - mats[("Competition", band)]
        jax_io_csv.save_ibs_matrix(diff, dirs["ibs_difference"] / f"diff_{band}_PLV.csv")

    attn = rng.uniform(0, 0.01, size=(SEQ, SEQ))
    attn[np.diag_indices(SEQ)] += 0.02  # diagonal dominance, like sync attn
    jax_io_csv.save_attention_matrix(attn, dirs["attention_weights"] / "mean_attention.csv")
    jax_io_csv.save_attention_summary(
        [{"Class": c, "Mean_Diagonal": 0.02 + 0.001 * i,
          "Std_Diagonal": 0.001, "Mean_OffDiag": 0.005, "Std_OffDiag": 0.001}
         for i, c in enumerate(CLASSES)],
        dirs["attention_weights"] / "attention_summary.csv")

    for cname in CLASSES:
        cam = rng.uniform(0, 1, size=(64, 64))
        jax_io_csv.save_gradcam_results(cam, dirs["gradcam_mean_by_class"] / f"gradcam_{cname}.csv")
    jax_io_csv.save_gradcam_metadata(np.linspace(0, 128, 64), np.linspace(0, 4, 64),
                                     dirs["gradcam"] / "gradcam_metadata.csv")
    return root


def build_entropy_tree(root: Path) -> tuple[Path, dict]:
    """tests/test_matlab_parity.py's ``entropy_tree``: analyze_entropy's raw
    gaze and EEG CSVs from seed 3, and 2D positions of its 8 channels."""
    import pandas as pd

    rng = np.random.default_rng(3)
    rows_g, rows_e = [], []
    chans = CHANNELS[:8]
    for pair in (12, 13, 14):
        for cond in CLASSES:
            for trial in range(4):
                for player in ("A", "B"):
                    key = dict(pair_id=pair, player=player, trial_idx=trial + 1, condition=cond)
                    rows_g.append({**key, "spatial_entropy": rng.uniform(4, 7)})
                    row = {**key, "mean_entropy": rng.uniform(0.5, 0.9)}
                    row.update({c: rng.uniform(0.4, 1.0) for c in chans})
                    rows_e.append(row)
    root.mkdir(parents=True, exist_ok=True)
    pd.DataFrame(rows_g).to_csv(root / "gaze_entropy_raw.csv", index=False)
    pd.DataFrame(rows_e).to_csv(root / "eeg_entropy_raw.csv", index=False)
    positions = {c: (np.cos(i), np.sin(i)) for i, c in enumerate(chans)}
    return root, positions


def assert_same_artifacts(got: dict, want: dict, names=None) -> None:
    """Equal artifact names (``names`` where given); CSVs equal to the
    byte, PNGs pixel for pixel."""
    import matplotlib.image as mpimg

    assert set(got) == set(want)
    if names is not None:
        assert set(got) == set(names)
    for name in sorted(got):
        g, w = Path(got[name]), Path(want[name])
        assert g.name == w.name == name
        if name.endswith(".csv"):
            assert g.read_bytes() == w.read_bytes(), name
        else:
            a, b = mpimg.imread(g), mpimg.imread(w)
            assert a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_movmean_and_find_peaks_match():
    x = np.random.default_rng(1).random(50) ** 2
    for w in (1, 4, 5, 12):
        np.testing.assert_array_equal(mp._movmean(x, w), jax_mp._movmean(x, w))
    np.testing.assert_array_equal(mp._find_peaks(x, 0.05), jax_mp._find_peaks(x, 0.05))


def test_ibs_suite_matches(tmp_path):
    result_tree = build_result_tree(tmp_path / "tree")
    got = mp.render_ibs_suite(result_tree, tmp_path / "port", key_band="theta",
                              key_feature="PLV")
    want = jax_mp.render_ibs_suite(result_tree, tmp_path / "jax", key_band="theta",
                                   key_feature="PLV")
    assert_same_artifacts(got, want, IBS_ARTIFACTS)


def test_render_all_suites_skips_missing(tmp_path):
    """tests/test_matlab_parity.py's partial tree, only Grad-CAM inputs:
    that suite renders, the others come back empty."""
    dirs = jax_io_csv.ensure_output_dirs(tmp_path / "partial")
    rng = np.random.default_rng(0)
    for cname in CLASSES:
        jax_io_csv.save_gradcam_results(rng.uniform(size=(64, 64)),
                                        dirs["gradcam_mean_by_class"] / f"gradcam_{cname}.csv")
    got = mp.render_all_suites(tmp_path / "partial", tmp_path / "port")
    want = jax_mp.render_all_suites(tmp_path / "partial", tmp_path / "jax")
    assert list(got) == list(want) == ["ibs_connectivity", "attention_weights", "gradcam"]
    assert got["ibs_connectivity"] == got["attention_weights"] == {}
    assert want["ibs_connectivity"] == want["attention_weights"] == {}
    assert_same_artifacts(got["gradcam"], want["gradcam"], GRADCAM_ARTIFACTS)
