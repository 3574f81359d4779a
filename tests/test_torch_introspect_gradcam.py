"""The port's ``gradcam_spectrogram`` (autograd at the captured conv2
activation) against the JAX package's (``jax.grad`` at a ``perturb``
point), on the fixtures of tests/test_torch_introspect.py."""

import numpy as np
import torch

from eyegaze_tpu.analysis import eeg_introspect as jax_introspect
from eyegaze_tpu.models.dual_eeg import DualEEGTransformer as JaxDualEEG
from eyegaze_tpu_torch.analysis import eeg_introspect
from eyegaze_tpu_torch.kernels import phase_metrics
from tests.test_torch_introspect import CAM_SHARE, GEOMETRY, _one_thread, batches, pair  # noqa: F401


def test_gradcam_matches_jax(pair, batches):
    """Per-class mean CAMs at ``CAM_SHARE`` of each map's largest entry.
    The forward runs with autograd on, once a batch."""
    jm, params, tm = pair
    want = jax_introspect.gradcam_spectrogram(JaxDualEEG(**GEOMETRY, enable_perturb=True),
                                              params, iter(batches), out_size=64)
    before = dict(phase_metrics.launch_count)
    got = eeg_introspect.gradcam_spectrogram(tm, iter(batches), out_size=64)
    assert phase_metrics.launch_count == before  # the CPU runs K1's plain version
    assert got.shape == want.shape == (3, 64, 64) and got.dtype == np.float32
    for c in range(3):
        scale = float(np.abs(want[c]).max())
        assert scale > 0, c
        np.testing.assert_allclose(got[c], want[c], rtol=0, atol=CAM_SHARE * scale,
                                   err_msg=f"class {c}")
