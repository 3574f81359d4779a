"""The port's offline feature ops against the JAX package and the float64 golden port.

Same numpy inputs through ``eyegaze_tpu.ops.features`` / ``spectral.welch_psd``
and the port.  Bounds: ``welch_psd`` 1e-3 relative, 1e-5 absolute (also
against ``scipy.signal.welch``); pearson, power_corr, PLV and coherence
1e-3 absolute; phase_diff 1e-2 rad as a wrapped angle, where PLV >= 1e-2
(elsewhere the mean angle is undefined); PLI and wPLI, means of signs and
so discontinuous, 0.1 at most and 1e-2 on average.  On the diagonal of an
intra block sin dphi is exactly 0, so PLI is 0 there (as in the float64
golden port); the JAX package's value there is the sign of its rounding
noise, so intra PLI is compared with it off the diagonal.  Against the float64
golden port (``tests/golden/feature_port.py``) the JAX package's own
bounds hold: 0.1 for PLI, 2e-3 for the rest (``tests/test_features.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eyegaze_tpu.ops import features as jfeat
from eyegaze_tpu.ops import spectral as jspec
from eyegaze_tpu_torch.ops import features, spectral
from tests.golden import feature_port as golden

T, FS = 768, 250.0
SMOOTH = ("pearson", "power_corr", "plv", "coherence")
SIGNED = ("pli", "wpli")
SMOOTH_TOL = 1e-3
PHASE_TOL = 1e-2
PHASE_MIN_PLV = 1e-2
SIGNED_MAX, SIGNED_MEAN = 0.1, 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def eeg_pair(c: int, t: int = T, seed: int = 9, batch: tuple = ()):
    """Noise plus shared oscillations at 5, 10, 20 and 35 Hz, the second
    stream's 5 samples late (``tests/test_features.py``'s fixture)."""
    r = np.random.default_rng(seed)
    e1 = r.normal(size=batch + (c, t)).astype(np.float32)
    e2 = r.normal(size=batch + (c, t)).astype(np.float32)
    time = np.arange(t) / FS
    for f in (5.0, 10.0, 20.0, 35.0):
        osc = np.sin(2 * np.pi * f * time).astype(np.float32)
        e1 += 0.4 * osc
        e2 += 0.4 * np.roll(osc, 5)
    return e1, e2


def assert_metrics_close(got: np.ndarray, want: np.ndarray, intra: bool = False) -> None:
    """(..., 7, bands, C, C) blocks at this file's bounds; ``intra``: PLI
    is 0 on the diagonal and compared off it."""
    assert got.shape == want.shape
    names = features.METRIC_NAMES
    for name in SMOOTH:
        m = names.index(name)
        np.testing.assert_allclose(got[..., m, :, :, :], want[..., m, :, :, :], rtol=0,
                                   atol=SMOOTH_TOL, err_msg=name)
    off = ~np.eye(got.shape[-1], dtype=bool)
    for name in SIGNED:
        g, w = got[..., names.index(name), :, :, :], want[..., names.index(name), :, :, :]
        if intra and name == "pli":
            assert (g[..., ~off] == 0).all()
            g, w = g[..., off], w[..., off]
        gap = np.abs(g - w)
        assert gap.max() <= SIGNED_MAX and gap.mean() <= SIGNED_MEAN, (name, gap.max(), gap.mean())
    m = names.index("phase_diff")
    defined = want[..., names.index("plv"), :, :, :] >= PHASE_MIN_PLV
    wrapped = np.angle(np.exp(1j * (got[..., m, :, :, :] - want[..., m, :, :, :])))
    assert defined.any()
    assert np.abs(wrapped[defined]).max() <= PHASE_TOL


@pytest.mark.parametrize("nperseg,t", [(256, 768), (255, 768), (256, 200)],
                         ids=["even", "odd", "clamped"])
def test_welch_psd_matches_jax_and_scipy(nperseg, t):
    from scipy import signal as sps

    x, _ = eeg_pair(4, t, seed=1, batch=(2,))
    freqs, psd = spectral.welch_psd(torch.from_numpy(x), FS, nperseg=nperseg)
    jf, jp = jspec.welch_psd(jnp.asarray(x), FS, nperseg=nperseg)
    sf, sp = sps.welch(x.astype(np.float64), FS, nperseg=min(nperseg, t), axis=-1)
    assert freqs.dtype == psd.dtype == torch.float32
    np.testing.assert_array_equal(freqs.numpy(), np.asarray(jf))
    np.testing.assert_allclose(freqs.numpy(), sf, rtol=1e-6)
    np.testing.assert_allclose(psd.numpy(), np.asarray(jp), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(psd.numpy(), sp, rtol=1e-3, atol=1e-5)


def test_unfold_matches_jax_frame():
    x = np.arange(2 * 1000, dtype=np.float32).reshape(2, 1000)
    np.testing.assert_array_equal(spectral.unfold(torch.from_numpy(x), 256, 128).numpy(),
                                  np.asarray(jspec._frame(jnp.asarray(x), 256, 128)))


@pytest.mark.parametrize("c,row_chunk", [(4, 4), (8, 4), (8, 8)])
def test_inter_connectivity_matches_jax(c, row_chunk):
    e1, e2 = eeg_pair(c)
    want = np.asarray(jfeat.inter_connectivity(jnp.asarray(e1), jnp.asarray(e2), FS,
                                               row_chunk=row_chunk))
    got = features.inter_connectivity(torch.from_numpy(e1), torch.from_numpy(e2), FS,
                                      row_chunk=row_chunk).numpy()
    assert got.shape == (7, 5, c, c)
    assert_metrics_close(got, want)


@pytest.mark.parametrize("c,row_chunk", [(4, 4), (8, 8)])
def test_intra_connectivity_matches_jax(c, row_chunk):
    e1, _ = eeg_pair(c, seed=3)
    want = np.asarray(jfeat.intra_connectivity(jnp.asarray(e1), FS, row_chunk=row_chunk))
    got = features.intra_connectivity(torch.from_numpy(e1), FS, row_chunk=row_chunk).numpy()
    assert got.shape == (7, 5, c, c)
    assert_metrics_close(got, want, intra=True)


def test_band_energy_matches_jax():
    e1, _ = eeg_pair(8, seed=4, batch=(2,))
    got = features.band_energy(torch.from_numpy(e1), FS).numpy()
    want = np.asarray(jfeat.band_energy(jnp.asarray(e1), FS))
    assert got.shape == (2, 8, 5)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


def test_band_without_a_bin_gives_zeros():
    """0.1-0.2 Hz holds no bin of a 256-point rfft at 250 Hz (0, 0.98, ...)."""
    bands = (("none", 0.1, 0.2), ("alpha", 8.0, 12.0))
    e1, _ = eeg_pair(4, seed=5)
    got = features.band_energy(torch.from_numpy(e1), FS, bands=bands).numpy()
    want = np.asarray(jfeat.band_energy(jnp.asarray(e1), FS, bands=bands))
    assert (got[:, 0] == 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


def test_short_trial_clamps_the_coherence_segment():
    """T = 200 < nperseg = 256: one segment of 200 samples, not an empty
    (NaN) coherence plane."""
    e1, e2 = eeg_pair(4, t=200, seed=6)
    got = features.inter_connectivity(torch.from_numpy(e1), torch.from_numpy(e2), FS,
                                      row_chunk=4).numpy()
    want = np.asarray(jfeat.inter_connectivity(jnp.asarray(e1), jnp.asarray(e2), FS,
                                               row_chunk=4))
    coherence = got[features.METRIC_NAMES.index("coherence")]
    assert np.isfinite(coherence).all()
    assert_metrics_close(got, want)
    np.testing.assert_allclose(
        features._coherence(torch.from_numpy(e1), torch.from_numpy(e2), 256).numpy(),
        np.asarray(jfeat._coherence(jnp.asarray(e1), jnp.asarray(e2), 256)), atol=SMOOTH_TOL)


def test_inter_and_intra_match_float64_golden():
    """The JAX package's own bounds against the float64 scipy port."""
    e1, e2 = eeg_pair(4)
    inter = features.inter_connectivity(torch.from_numpy(e1), torch.from_numpy(e2), FS,
                                        row_chunk=4).numpy()
    intra = features.intra_connectivity(torch.from_numpy(e1), FS, row_chunk=4).numpy()
    for got, want in ((inter, golden.inter_connectivity(e1.astype(np.float64),
                                                        e2.astype(np.float64), FS)),
                      (intra, golden.intra_connectivity(e1.astype(np.float64), FS))):
        for m, name in enumerate(features.METRIC_NAMES):
            tol = 1e-1 if name == "pli" else 2e-3
            np.testing.assert_allclose(got[m], want[m], rtol=tol, atol=tol, err_msg=name)
    # Self-connectivity: pearson and PLV are 1 on the diagonal.
    np.testing.assert_allclose(np.diagonal(intra[0], axis1=-2, axis2=-1), 1.0, atol=1e-3)
    np.testing.assert_allclose(np.diagonal(intra[2], axis1=-2, axis2=-1), 1.0, atol=1e-3)


def test_batched_call_equals_a_loop_over_trials():
    """Broadcasting over trials computes what a loop over them computes, to
    float32 rounding (1e-6: the batched atan2 may round phase_diff otherwise)."""
    e1, e2 = eeg_pair(4, seed=7, batch=(3,))
    t1, t2 = torch.from_numpy(e1), torch.from_numpy(e2)
    batched = (features.inter_connectivity(t1, t2, FS, row_chunk=4),
               features.intra_connectivity(t1, FS, row_chunk=4), features.band_energy(t1, FS))
    for i in range(3):
        looped = (features.inter_connectivity(t1[i], t2[i], FS, row_chunk=4),
                  features.intra_connectivity(t1[i], FS, row_chunk=4),
                  features.band_energy(t1[i], FS))
        for got, want in zip(batched, looped):
            np.testing.assert_allclose(got[i].numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_connectivity_block_is_intra_and_inter():
    e1, e2 = eeg_pair(8, seed=8, batch=(2,))
    t1, t2 = torch.from_numpy(e1), torch.from_numpy(e2)
    intra, inter = features.connectivity_block(t1, t2, FS, row_chunk=4)
    assert intra.shape == (2, 2, 7, 5, 8, 8) and inter.shape == (2, 7, 5, 8, 8)
    assert_metrics_close(inter.numpy(), features.inter_connectivity(t1, t2, FS,
                                                                    row_chunk=4).numpy())
    for p, t in enumerate((t1, t2)):
        assert_metrics_close(intra[:, p].numpy(),
                             features.intra_connectivity(t, FS, row_chunk=4).numpy(), intra=True)


def test_row_chunk_must_divide_channels():
    e1, e2 = eeg_pair(8)
    with pytest.raises(ValueError, match="row_chunk"):
        features.inter_connectivity(torch.from_numpy(e1), torch.from_numpy(e2), FS, row_chunk=3)


def test_band_stack_filter_matches_one_band_at_a_time_and_scipy():
    """The five bands' filtfilts in one blocked recurrence equal the filter
    of one band at a time to float32 rounding, and scipy's sosfiltfilt
    within the filtfilt bound of tests/test_torch_ops.py (1e-3)."""
    from scipy import signal as sps

    from eyegaze_tpu_torch.ops import preprocess

    x, _ = eeg_pair(4, seed=10, batch=(2,))
    got = preprocess.bandpass_filtfilt_bands(torch.from_numpy(x), features.FEATURE_BANDS_5, FS)
    assert got.shape == (5, 2, 4, T)
    for b, (_, lo, hi) in enumerate(features.FEATURE_BANDS_5):
        one = preprocess.bandpass_filtfilt_blocked(torch.from_numpy(x), lo, hi, FS).numpy()
        np.testing.assert_allclose(got[b].numpy(), one, rtol=0, atol=1e-6)
        sos, _ = preprocess._butter_sos(4, lo, hi, FS)
        want = sps.sosfiltfilt(sos, x.astype(np.float64), padtype="odd", padlen=27)
        np.testing.assert_allclose(got[b].numpy(), want, rtol=1e-3, atol=1e-3)
