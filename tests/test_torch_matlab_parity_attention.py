"""The port's attention suite against the JAX package's on the tree of
tests/test_torch_matlab_parity.py, and on the same tree under the MATLAB
script's file names (``mean_attention_map.csv``,
``attention_diagonal_summary.csv``): equal artifact names, byte-equal
CSVs, pixel-equal PNGs."""

import pandas as pd

from eyegaze_tpu.analysis import matlab_parity as jax_mp
from eyegaze_tpu_torch.analysis import matlab_parity as mp
from tests.test_matlab_parity import ATTN_ARTIFACTS
from tests.test_torch_matlab_parity import assert_same_artifacts, build_result_tree


def test_attention_suite_matches(tmp_path):
    result_tree = build_result_tree(tmp_path / "tree")
    got = mp.render_attention_suite(result_tree, tmp_path / "port")
    want = jax_mp.render_attention_suite(result_tree, tmp_path / "jax")
    assert_same_artifacts(got, want, ATTN_ARTIFACTS)


def test_attention_suite_matches_on_matlab_filenames(tmp_path):
    result_tree = build_result_tree(tmp_path / "tree")
    d = result_tree / "attention_weights"
    (d / "mean_attention.csv").rename(d / "mean_attention_map.csv")
    pd.DataFrame({
        "Class": list(mp.CLASSES),
        "Mean_Diagonal_Value": [0.021, 0.022, 0.023],
        "Sample_Count": [10, 10, 10],
    }).to_csv(d / "attention_diagonal_summary.csv", index=False)
    (d / "attention_summary.csv").unlink()
    got = mp.render_attention_suite(result_tree, tmp_path / "port")
    want = jax_mp.render_attention_suite(result_tree, tmp_path / "jax")
    assert_same_artifacts(got, want, ATTN_ARTIFACTS)
