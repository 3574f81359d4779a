"""The port's Grad-CAM suite against the JAX package's on the tree of
tests/test_torch_matlab_parity.py: equal artifact names, byte-equal CSVs
(band statistics, frequency and temporal profiles), pixel-equal PNGs."""

from eyegaze_tpu.analysis import matlab_parity as jax_mp
from eyegaze_tpu_torch.analysis import matlab_parity as mp
from tests.test_matlab_parity import GRADCAM_ARTIFACTS
from tests.test_torch_matlab_parity import assert_same_artifacts, build_result_tree


def test_gradcam_suite_matches(tmp_path):
    root = build_result_tree(tmp_path / "tree")
    got = mp.render_gradcam_suite(root, tmp_path / "port")
    want = jax_mp.render_gradcam_suite(root, tmp_path / "jax")
    assert_same_artifacts(got, want, GRADCAM_ARTIFACTS)
