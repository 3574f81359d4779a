"""Offline feature extraction: the 7 metrics x 5 bands intra- and inter-brain block.

Port of ``eyegaze_tpu/ops/features.py``, a different metric family from the
model-side ``ops.connectivity`` (``docs/PARITY.md``):

- bands: delta (0.5-4), theta (4-7), alpha (8-12), beta (12-28), gamma
  (28-50) Hz, each a Butterworth order-4 filtfilt (``bandpass_filtfilt_bands``);
- analytic signal: the FFT Hilbert quadrature of the filtered signal;
- metrics, in this order: pearson, power_corr (of the amplitude envelope),
  PLV, PLI = |mean sign(sin dphi)|, wPLI = |mean sin dphi| / (mean |sin
  dphi| + eps), coherence averaged over non-overlapping segments of
  ``nperseg`` under a symmetric Hann window, and phase_diff, the circular
  mean angle atan2(mean sin dphi, mean cos dphi).

Every function broadcasts over leading dimensions, where the JAX package
``vmap``s over trials, and the bands of one call run as one batch, their
filters too (one blocked recurrence with a filter axis).  PLV, wPLI's numerator and the phase mean are matrix
products of the phases' cosines and sines; PLI and wPLI's denominator take
sign and abs of sin dphi per sample, ``row_chunk`` rows at a time, which
bounds that (..., row_chunk, C, T) transient.  These are stock ops, not the
phase-metrics kernel: K1 takes the sign of the raw phase difference, these
metrics of its sine.

Output layout: (..., 7 metrics, 5 bands, C, C).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from eyegaze_tpu_torch.ops.preprocess import bandpass_filtfilt_bands
from eyegaze_tpu_torch.ops.spectral import _quad_gain_np, welch_psd

FEATURE_BANDS_5 = (
    ("delta", 0.5, 4.0),
    ("theta", 4.0, 7.0),
    ("alpha", 8.0, 12.0),
    ("beta", 12.0, 28.0),
    ("gamma", 28.0, 50.0),
)
METRIC_NAMES = ("pearson", "power_corr", "plv", "pli", "wpli", "coherence", "phase_diff")


@functools.lru_cache(maxsize=16)
def _quad_gain(n: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_quad_gain_np(n), device=device)


@functools.lru_cache(maxsize=16)
def _hanning_sym(n: int, device: torch.device) -> torch.Tensor:
    # np.hanning is the symmetric window, not welch_psd's periodic one.
    return torch.as_tensor(np.hanning(n).astype(np.float32), device=device)


def _hilbert_quadrature(x: torch.Tensor) -> torch.Tensor:
    """Hilbert transform of a real signal along the last axis (the imaginary
    part of scipy.signal.hilbert): gain 0 at DC and at even-n Nyquist."""
    n = x.shape[-1]
    spec = torch.fft.rfft(x, dim=-1)
    return torch.fft.irfft(spec * _quad_gain(n, x.device) * (-1j), n=n, dim=-1)


def _zscore_biased(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    std = torch.sqrt(((x - mean) ** 2).mean(dim=-1, keepdim=True))
    return (x - mean) / (std + eps)


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(..., C, T) x (..., C, T) -> (..., C, C), sum over T."""
    return x @ y.transpose(-1, -2)


def _pearson(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., C, T) x (..., C, T) -> (..., C, C) Pearson with the biased std."""
    return _dot(_zscore_biased(a), _zscore_biased(b)) / a.shape[-1]


def _phase_trig(band: torch.Tensor, quad: torch.Tensor):
    """cos and sin of the instantaneous phase as amplitude ratios (1 and 0
    where the amplitude is 0)."""
    r = torch.sqrt(band ** 2 + quad ** 2)
    safe = r > 0
    div = torch.where(safe, r, torch.ones_like(r))
    c = torch.where(safe, band / div, torch.ones_like(r))
    s = torch.where(safe, quad / div, torch.zeros_like(r))
    return c, s


def _segment_spectra(x: torch.Tensor, nperseg: int):
    """Non-overlapping windowed segment DFTs: (..., C, T) -> re, im (..., C, S, F)."""
    n_seg = x.shape[-1] // nperseg
    seg = x[..., : n_seg * nperseg].reshape(x.shape[:-1] + (n_seg, nperseg))
    spec = torch.fft.rfft(seg * _hanning_sym(nperseg, x.device), dim=-1)
    return spec.real, spec.imag


def _cross(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(..., C, S, F) x (..., C, S, F) -> (..., C, C, F), sum over S."""
    return (x.movedim(-1, -3) @ y.movedim(-1, -3).transpose(-1, -2)).movedim(-3, -1)


def _coherence_of_spectra(re_a, im_a, re_b, im_b, eps: float = 1e-8) -> torch.Tensor:
    """Magnitude-squared coherence averaged over frequency, from segment
    spectra (..., C, S, F) of each side -> (..., C, C)."""
    n_seg = re_a.shape[-2]
    paa = torch.mean(re_a ** 2 + im_a ** 2, dim=-2)  # (..., C, F)
    pbb = torch.mean(re_b ** 2 + im_b ** 2, dim=-2)
    # Pab = mean_s X_a conj(X_b), real and imaginary parts.
    pab_re = (_cross(re_a, re_b) + _cross(im_a, im_b)) / n_seg
    pab_im = (_cross(im_a, re_b) - _cross(re_a, im_b)) / n_seg
    coh = (pab_re ** 2 + pab_im ** 2) / (paa[..., :, None, :] * pbb[..., None, :, :] + eps)
    return torch.mean(coh, dim=-1)


def _coherence(a: torch.Tensor, b: torch.Tensor, nperseg: int, eps: float = 1e-8) -> torch.Tensor:
    """Segment-averaged magnitude-squared coherence, (..., C, T) x (..., C, T)
    -> (..., C, C).  ``nperseg`` is clamped to T, as scipy's welch and
    ``band_energy`` clamp it: a shorter trial would have no segment."""
    nperseg = min(nperseg, a.shape[-1])
    return _coherence_of_spectra(*_segment_spectra(a, nperseg), *_segment_spectra(b, nperseg),
                                 eps)


class _Parts(NamedTuple):
    """What the metrics need of one band signal (..., C, T)."""

    band: torch.Tensor
    amp: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor
    seg_re: torch.Tensor
    seg_im: torch.Tensor


def _parts(band: torch.Tensor, nperseg: int) -> _Parts:
    quad = _hilbert_quadrature(band)
    c, s = _phase_trig(band, quad)
    re, im = _segment_spectra(band, min(nperseg, band.shape[-1]))
    return _Parts(band, torch.sqrt(band ** 2 + quad ** 2), c, s, re, im)


def _pair_metrics(p1: _Parts, p2: _Parts, row_chunk: int, eps: float = 1e-8) -> torch.Tensor:
    """All 7 metrics between two band signals' parts -> (..., 7, C, C)."""
    c, t = p1.band.shape[-2:]
    pearson = _pearson(p1.band, p2.band)
    power_corr = _pearson(p1.amp, p2.amp)
    c1, s1, c2, s2 = p1.cos, p1.sin, p2.cos, p2.sin
    mean_cos = (_dot(c1, c2) + _dot(s1, s2)) / t  # mean_t cos(dphi_ij)
    mean_sin = (_dot(s1, c2) - _dot(c1, s2)) / t  # mean_t sin(dphi_ij)
    plv = torch.sqrt(mean_cos ** 2 + mean_sin ** 2)
    phase_diff = torch.atan2(mean_sin, mean_cos)
    # |x| sign(x) == x, so wPLI's numerator is |mean sin(dphi)|.
    wpli_num = torch.abs(mean_sin)

    if c % row_chunk:
        raise ValueError(f"row_chunk {row_chunk} must divide C ({c})")
    pli_rows, abs_rows = [], []
    for r in range(0, c, row_chunk):
        s1c = s1[..., r:r + row_chunk, None, :]  # (..., row_chunk, 1, T)
        c1c = c1[..., r:r + row_chunk, None, :]
        sin_d = s1c * c2[..., None, :, :] - c1c * s2[..., None, :, :]  # (..., row_chunk, C, T)
        pli_rows.append(torch.abs(torch.mean(torch.sign(sin_d), dim=-1)))
        abs_rows.append(torch.mean(torch.abs(sin_d), dim=-1))
    pli = torch.cat(pli_rows, dim=-2)
    wpli = wpli_num / (torch.cat(abs_rows, dim=-2) + eps)

    coherence = _coherence_of_spectra(p1.seg_re, p1.seg_im, p2.seg_re, p2.seg_im, eps)
    return torch.stack([pearson, power_corr, plv, pli, wpli, coherence, phase_diff], dim=-3)


def _band_metrics(band1: torch.Tensor, band2: torch.Tensor, fs: float, nperseg: int,
                  row_chunk: int, eps: float = 1e-8) -> torch.Tensor:
    """All 7 metrics between two (..., C, T) band signals -> (..., 7, C, C);
    with ``band1 is band2`` the intra variant, its parts computed once."""
    p1 = _parts(band1, nperseg)
    p2 = p1 if band2 is band1 else _parts(band2, nperseg)
    return _pair_metrics(p1, p2, row_chunk, eps)


def _filter_bands(eeg: torch.Tensor, sampling_rate: float, bands: Sequence) -> torch.Tensor:
    """(..., C, T) -> (..., num_bands, C, T), the bands' filtfilts in one
    blocked recurrence."""
    return bandpass_filtfilt_bands(eeg, bands, sampling_rate).movedim(0, -3)


def inter_connectivity(eeg1: torch.Tensor, eeg2: torch.Tensor, sampling_rate: float = 250.0,
                       bands: Sequence = FEATURE_BANDS_5, nperseg: int = 256,
                       row_chunk: int = 8) -> torch.Tensor:
    """Inter-brain connectivity: (..., C, T) x2 -> (..., 7, num_bands, C, C)."""
    b1 = _filter_bands(eeg1, sampling_rate, bands)
    b2 = _filter_bands(eeg2, sampling_rate, bands)
    return _band_metrics(b1, b2, sampling_rate, nperseg, row_chunk).transpose(-4, -3)


def intra_connectivity(eeg: torch.Tensor, sampling_rate: float = 250.0,
                       bands: Sequence = FEATURE_BANDS_5, nperseg: int = 256,
                       row_chunk: int = 8) -> torch.Tensor:
    """Intra-brain connectivity of one player: (..., C, T) -> (..., 7, num_bands, C, C)."""
    b = _filter_bands(eeg, sampling_rate, bands)
    return _band_metrics(b, b, sampling_rate, nperseg, row_chunk).transpose(-4, -3)


def connectivity_block(eeg1: torch.Tensor, eeg2: torch.Tensor, sampling_rate: float = 250.0,
                       bands: Sequence = FEATURE_BANDS_5, nperseg: int = 256,
                       row_chunk: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """``(stack([intra(eeg1), intra(eeg2)], -5), inter(eeg1, eeg2))`` of
    (..., C, T) pairs, each player filtered and analysed once per band and
    the three metric sets taken in one batch: (..., 2, 7, num_bands, C, C)
    and (..., 7, num_bands, C, C)."""
    p = _parts(_filter_bands(torch.stack([eeg1, eeg2]), sampling_rate, bands), nperseg)
    # Players 1, 2, 1 on the left and 1, 2, 2 on the right: intra 1, intra 2, inter.
    left = _Parts(*(torch.cat([x, x[:1]]) for x in p))
    right = _Parts(*(torch.cat([x, x[1:]]) for x in p))
    m = _pair_metrics(left, right, row_chunk).transpose(-4, -3)  # (3, ..., 7, num_bands, C, C)
    return m[:2].movedim(0, -5), m[2]


def band_energy_from_psd(psd: torch.Tensor, sampling_rate: float = 250.0,
                         bands: Sequence = FEATURE_BANDS_5, nperseg: int = 256) -> torch.Tensor:
    """Mean of a Welch PSD (..., nperseg // 2 + 1) over each band's bins
    (inclusive edges) -> (..., num_bands); 0 for a band with no bin."""
    freqs = np.fft.rfftfreq(nperseg, d=1.0 / sampling_rate)
    outs = []
    for (_, lo, hi) in bands:
        idx = np.flatnonzero((freqs >= lo) & (freqs <= hi))  # a contiguous run
        if idx.size:
            outs.append(torch.mean(psd[..., idx[0]:idx[-1] + 1], dim=-1))
        else:
            outs.append(psd.new_zeros(psd.shape[:-1]))
    return torch.stack(outs, dim=-1)


def band_energy(eeg: torch.Tensor, sampling_rate: float = 250.0,
                bands: Sequence = FEATURE_BANDS_5, nperseg: int = 256) -> torch.Tensor:
    """Mean Welch PSD per band: (..., C, T) -> (..., C, num_bands)."""
    nperseg = min(nperseg, eeg.shape[-1])
    _, psd = welch_psd(eeg, sampling_rate, nperseg=nperseg)
    return band_energy_from_psd(psd, sampling_rate, bands, nperseg)
