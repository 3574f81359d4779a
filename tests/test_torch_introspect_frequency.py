"""The port's ``frequency_sensitivity`` against the JAX package's, on the
fixtures of tests/test_torch_introspect.py: one loaded model serves all six
bands (``DualEEGTransformer.with_mask_band``)."""

import numpy as np
import torch

from eyegaze_tpu.analysis import eeg_introspect as jax_introspect
from eyegaze_tpu.models.dual_eeg import DualEEGTransformer as JaxDualEEG
from eyegaze_tpu_torch.analysis import eeg_introspect
from tests.test_torch_introspect import GEOMETRY, TOL, _one_thread, batches, pair  # noqa: F401


def test_frequency_sensitivity_matches_jax(pair, batches):
    """Accuracy and F1 per masked band.  They come from argmaxes: a row whose
    top-two margin (the port's logits) is inside twice the tolerance may
    flip, so each such row may move the accuracy by 1 / N; without one the
    numbers are equal."""
    jm, params, tm = pair
    want = jax_introspect.frequency_sensitivity(
        lambda band: JaxDualEEG(**GEOMETRY, mask_band=band), params, lambda: iter(batches))
    got = eeg_introspect.frequency_sensitivity(tm.with_mask_band, lambda: iter(batches))
    assert list(got) == list(want) == list(eeg_introspect.BAND_NAMES)
    n = sum(len(b["label"]) for b in batches)
    unclear = {}
    for band_idx, band in enumerate(want):
        with torch.inference_mode():
            logits = np.concatenate([
                tm.with_mask_band(band_idx)(torch.from_numpy(b["eeg1"]),
                                            torch.from_numpy(b["eeg2"]))["logits"].numpy()
                for b in batches])
        top2 = np.sort(logits, axis=-1)
        unclear[band] = int((top2[:, -1] - top2[:, -2] <= 2 * TOL).sum())
        if unclear[band] == 0:
            assert got[band] == want[band], band
        else:
            assert abs(got[band]["accuracy"] - want[band]["accuracy"]) <= unclear[band] / n
    print(f"rows inside the margin, per band: {unclear}")
