"""The port's entropy suite and grouped frequency-sensitivity bar against
the JAX package's, on tests/test_matlab_parity.py's ``entropy_tree`` (built
once here) and its band table: equal artifact names, pixel-equal PNGs; with
the EEG table absent, only the gaze figures."""

import pandas as pd
import pytest

from eyegaze_tpu.analysis import matlab_parity as jax_mp
from eyegaze_tpu_torch.analysis import matlab_parity as mp
from tests.test_matlab_parity import ENTROPY_ARTIFACTS
from tests.test_torch_matlab_parity import assert_same_artifacts, build_entropy_tree


@pytest.fixture(scope="module")
def entropy_tree(tmp_path_factory):
    return build_entropy_tree(tmp_path_factory.mktemp("entropy_tree"))


def test_entropy_suite_matches(entropy_tree, tmp_path):
    root, positions = entropy_tree
    got = mp.render_entropy_suite(root, tmp_path / "port", positions=positions)
    want = jax_mp.render_entropy_suite(root, tmp_path / "jax", positions=positions)
    assert_same_artifacts(got, want, ENTROPY_ARTIFACTS)


def test_entropy_suite_gaze_only_matches(entropy_tree, tmp_path):
    root, _ = entropy_tree
    gaze_only = tmp_path / "gaze_only"
    gaze_only.mkdir()
    (gaze_only / "gaze_entropy_raw.csv").write_bytes((root / "gaze_entropy_raw.csv").read_bytes())
    got = mp.render_entropy_suite(gaze_only, tmp_path / "port")
    want = jax_mp.render_entropy_suite(gaze_only, tmp_path / "jax")
    assert_same_artifacts(got, want, {"fig_gaze_raincloud.png",
                                      "fig_gaze_entropy_by_pair_sorted_horizontal.png"})


def test_frequency_sensitivity_bar_matches(tmp_path):
    csv = tmp_path / "band_sensitivity.csv"
    pd.DataFrame({
        "Band": ["delta", "theta", "alpha"],
        "Masked_Accuracy": [0.8, 0.7, 0.9],
        "Masked_F1": [0.78, 0.66, 0.9],
        "Accuracy_Drop": [0.1, 0.2, 0.0],
        "F1_Drop": [0.12, 0.24, 0.0],
    }).to_csv(csv, index=False)
    name = "freq_sensitivity_grouped_bar.png"
    got = mp.render_frequency_sensitivity_bar(csv, tmp_path / "port" / name)
    want = jax_mp.render_frequency_sensitivity_bar(csv, tmp_path / "jax" / name)
    assert_same_artifacts({name: got}, {name: want})
