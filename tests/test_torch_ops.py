"""Signal ops of the PyTorch port against the JAX package on the CPU.

Same numpy inputs through both; tolerances from docs/PARITY.md: 1e-3 for
the filtfilt preprocessing, 1e-4 for the fft-route spectral ops, 5e-4 for
PLV / correlations / coherence, and for every scalar IBS feature.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eyegaze_tpu.ops import connectivity as jconn
from eyegaze_tpu.ops import preprocess as jprep
from eyegaze_tpu.ops import spectral as jspec
from eyegaze_tpu_torch.kernels import phase_metrics
from eyegaze_tpu_torch.ops import connectivity, preprocess, spectral


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_preprocess_eeg_matches_jax():
    x = _normal((2, 8, 1300), 0) * 20.0 + 5.0
    want = np.asarray(jprep.preprocess_eeg(jnp.asarray(x), sampling_rate=256.0))
    got = preprocess.preprocess_eeg(torch.from_numpy(x), sampling_rate=256.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_bandpass_matches_scipy_filtfilt():
    from scipy import signal as sps

    x = _normal((3, 700), 1)
    sos, _ = preprocess._butter_sos(4, 0.5, 50.0, 256.0)
    want = sps.sosfiltfilt(sos, x.astype(np.float64), padtype="odd", padlen=27)
    got = preprocess.bandpass_filtfilt_blocked(torch.from_numpy(x), 0.5, 50.0, 256.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_sliding_windows_and_car_match_jax():
    x = _normal((2, 4, 1300), 2)
    want = np.asarray(jprep.sliding_windows(jnp.asarray(x), 512, 256))
    got = preprocess.sliding_windows(torch.from_numpy(x), 512, 256)
    assert got.shape == want.shape == (2, 4, 4, 512)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(
        preprocess.common_average_reference(torch.from_numpy(x)).numpy(),
        np.asarray(jprep.common_average_reference(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_analytic_band_parts_match_jax_fft():
    x = _normal((2, 8, 256), 3)
    jb, jq = jspec.analytic_band_parts(jnp.asarray(x), 256.0, jspec.BAND_DEFS_6)
    tb, tq = spectral.analytic_band_parts(torch.from_numpy(x), 256.0, spectral.BAND_DEFS_6)
    assert tb.shape == (6, 2, 8, 256)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(spectral.band_masks_np(256, 256.0, spectral.BAND_DEFS_6),
                                  np.asarray(jspec.band_masks(256, 256.0, jspec.BAND_DEFS_6)))


def test_power_spectrum_matches_jax_fft():
    x = _normal((2, 8, 256), 4)
    jre, jim = jspec.power_spectrum(jnp.asarray(x))
    tre, tim = spectral.power_spectrum(torch.from_numpy(x))
    np.testing.assert_allclose(tre.numpy(), np.asarray(jre), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tim.numpy(), np.asarray(jim), rtol=1e-4, atol=1e-4)


def test_stft_log_magnitude_matches_jax_fft():
    x = _normal((3, 512), 5)
    want = np.asarray(jspec.stft_log_magnitude(jnp.asarray(x), 128, 64, 64))
    got = spectral.stft_log_magnitude(torch.from_numpy(x), 128, 64, 64)
    assert got.shape == want.shape == (3, 64, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("feature_type", ["all", "phase"])
def test_connectivity_matrices_match_jax(feature_type):
    e1 = _normal((2, 8, 256), 6)
    e2 = _normal((2, 8, 256), 7)
    e2[:, :2] += e1[:, :2]  # shared components: nonzero synchrony
    want = np.asarray(jconn.connectivity_matrices(jnp.asarray(e1), jnp.asarray(e2), 256.0,
                                                  feature_type=feature_type))
    before = dict(phase_metrics.launch_count)
    got = connectivity.connectivity_matrices(torch.from_numpy(e1), torch.from_numpy(e2), 256.0,
                                             feature_type=feature_type).numpy()
    assert got.shape == want.shape
    assert phase_metrics.launch_count == before  # the CPU path never launches the kernel
    names = [connectivity.FEATURE_NAMES[i] for i in connectivity.feature_indices_for(feature_type)]
    for k, name in enumerate(names):
        # PLI too: docs/PARITY.md allows it 0.1, but the phases agree here
        # closely enough that no sign flips.
        np.testing.assert_allclose(got[:, :, k], want[:, :, k], rtol=5e-4, atol=5e-4,
                                   err_msg=name)


def test_band_masks_match_jax():
    for bands in (spectral.BAND_DEFS_4, spectral.BAND_DEFS_6):
        got = spectral.band_masks(512, 256.0, bands, torch.device("cpu"))
        assert got.dtype == torch.float32 and got.shape == (len(bands), 257)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jspec.band_masks(512, 256.0, bands)))
    assert spectral.BAND_DEFS_4 == jspec.BAND_DEFS_4


def test_coherence_matrix_matches_jax():
    """The single-band per-pair coherence, on masked power spectra of
    (2, 8, 512) signals, one band at a time as the six-pass route runs it."""
    e1, e2 = _normal((2, 8, 512), 8), _normal((2, 8, 512), 9)
    p1, p2 = (np.abs(np.fft.rfft(e, axis=-1)).astype(np.float32) ** 2 for e in (e1, e2))
    for m in jspec.band_masks_np(512, 256.0, jspec.BAND_DEFS_6):
        want = np.asarray(jconn._coherence_matrix(jnp.asarray(p1 * m), jnp.asarray(p2 * m), 1e-8))
        got = connectivity._coherence_matrix(torch.from_numpy(p1 * m), torch.from_numpy(p2 * m),
                                             1e-8)
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)


def test_coherence_passes_match_fused_contraction():
    """Six single-band passes give what the one masked contraction gives."""
    r = np.random.default_rng(10)
    pxx, pyy = (torch.from_numpy(r.uniform(0.1, 10.0, (2, 8, 257)).astype(np.float32))
                for _ in range(2))
    masks = spectral.band_masks(512, 256.0, spectral.BAND_DEFS_6, torch.device("cpu"))
    six = torch.stack([connectivity._coherence_matrix(pxx * m, pyy * m, 1e-8) for m in masks], 1)
    fused = connectivity._coherence_all_bands(
        pxx, pyy, spectral.band_masks_np(512, 256.0, spectral.BAND_DEFS_6), 1e-8)
    torch.testing.assert_close(six, fused, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("coupled", [False, True], ids=["independent", "coupled"])
def test_connectivity_scalars_match_jax(coupled):
    e1 = _normal((2, 8, 512), 11)
    e2 = _normal((2, 8, 512), 12)
    if coupled:
        e2[:, :3] += 0.8 * e1[:, :3]  # shared components: nonzero synchrony
    want = np.asarray(jconn.connectivity_scalars(jnp.asarray(e1), jnp.asarray(e2), 256.0))
    got = connectivity.connectivity_scalars(torch.from_numpy(e1), torch.from_numpy(e2), 256.0)
    assert got.shape == want.shape == (2, 4 * 7)
    for k, name in enumerate(connectivity.FEATURE_NAMES):
        np.testing.assert_allclose(got.numpy()[:, k::7], want[:, k::7], rtol=5e-4, atol=5e-4,
                                   err_msg=name)
