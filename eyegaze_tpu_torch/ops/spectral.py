"""Spectral ops with ``torch.fft``: band masks, analytic-signal parts, STFT.

Port of the fft route of ``eyegaze_tpu/ops/spectral.py``.  The JAX package
also has a matmul-DFT route, which exists only because its TPU had no FFT
kernels; the port does not need it.

- ``bandpass_fft`` is the rfft-mask-irfft bandpass of one band, which the
  trainer applies when ``data.enable_preprocessing`` is set.
- ``analytic_band_parts`` is the rfft-mask-irfft bandpass with inclusive
  band edges on rfftfreq bins, plus its FFT-Hilbert quadrature, so phase is
  ``atan2(quad, band)`` and power ``band ** 2``.
- ``stft`` is ``torch.stft(center=True, pad_mode='reflect', periodic Hann,
  onesided=True)``.
- ``welch_psd`` is ``scipy.signal.welch``'s default estimate: periodic Hann
  segments of ``nperseg`` (clamped to T) with half overlap, a constant
  detrend per segment, density scaling, the one-sided doubling and the mean
  over segments.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Band definitions (Hz): four for the scalar IBS token, six for the
# connectivity matrices.
BAND_DEFS_4 = (
    ("theta", 4.0, 8.0),
    ("alpha", 8.0, 13.0),
    ("beta", 13.0, 30.0),
    ("gamma", 30.0, 45.0),
)
BAND_DEFS_6 = (
    ("broadband", 0.5, 45.0),
    ("delta", 0.5, 4.0),
    ("theta", 4.0, 8.0),
    ("alpha", 8.0, 13.0),
    ("beta", 13.0, 30.0),
    ("gamma", 30.0, 45.0),
)


@functools.lru_cache(maxsize=64)
def _rfft_band_mask_np(n: int, sampling_rate: float, low: float, high: float) -> np.ndarray:
    freqs = np.fft.rfftfreq(n, d=1.0 / sampling_rate)
    return ((freqs >= low) & (freqs <= high)).astype(np.float32)


def band_masks_np(n: int, sampling_rate: float, bands) -> np.ndarray:
    """Inclusive rfft-bin masks, (num_bands, n//2 + 1), on the host."""
    return np.stack([_rfft_band_mask_np(n, float(sampling_rate), float(lo), float(hi))
                     for (_, lo, hi) in bands], axis=0)


@functools.lru_cache(maxsize=16)
def _quad_gain_np(n: int) -> np.ndarray:
    """Interior-bin indicator (0 at DC and Nyquist) for the quadrature part."""
    g = np.ones(n // 2 + 1, dtype=np.float32)
    g[0] = 0.0
    if n % 2 == 0:
        g[-1] = 0.0
    return g


@functools.lru_cache(maxsize=64)
def _band_consts(n: int, sampling_rate: float, bands: tuple, device: torch.device):
    """(band masks, quadrature masks), each (num_bands, n//2 + 1), on ``device``."""
    masks = band_masks_np(n, sampling_rate, bands)
    return (torch.as_tensor(masks, device=device),
            torch.as_tensor(masks * _quad_gain_np(n), device=device))


def band_masks(n: int, sampling_rate: float, bands, device: torch.device) -> torch.Tensor:
    """Inclusive rfft-bin masks, (num_bands, n//2 + 1) float32, on ``device``
    (made once per argument set and shared: do not write to it)."""
    return _band_consts(n, float(sampling_rate), tuple(bands), device)[0]


def bandpass_fft(x: torch.Tensor, low: float, high: float, sampling_rate: float) -> torch.Tensor:
    """FFT-mask bandpass of a real signal along the last axis, in ``x``'s
    dtype: rfft, zero the bins outside [low, high] (inclusive), irfft."""
    n = x.shape[-1]
    mask = band_masks(n, sampling_rate, (("band", low, high),), x.device)[0]
    spec = torch.fft.rfft(x.to(torch.float32), dim=-1)
    return torch.fft.irfft(spec * mask, n=n, dim=-1).to(x.dtype)


def analytic_band_parts(x: torch.Tensor, sampling_rate: float, bands):
    """(band, quad), each (num_bands, ..., T) float32, for real x of (..., T)."""
    n = x.shape[-1]
    masks, qmasks = _band_consts(n, float(sampling_rate), tuple(bands), x.device)
    spec = torch.fft.rfft(x.to(torch.float32), dim=-1)[None]  # (1, ..., F)
    shape = (len(bands),) + (1,) * (x.dim() - 1) + (-1,)
    band = torch.fft.irfft(spec * masks.reshape(shape), n=n, dim=-1)
    quad = torch.fft.irfft(spec * qmasks.reshape(shape) * (-1j), n=n, dim=-1)
    return band, quad


def power_spectrum(x: torch.Tensor):
    """(re, im) of the one-sided DFT of x along the last axis (no window)."""
    spec = torch.fft.rfft(x, dim=-1)
    return spec.real, spec.imag


def hann_window(n: int, device: torch.device) -> torch.Tensor:
    """Periodic Hann window, torch.hann_window's default, computed on the CPU
    and copied to ``device``: the card's cosine differs in the last bit, so
    a model built on the card and one built on the CPU and moved there
    would take other spectrograms."""
    return torch.hann_window(n, periodic=True, dtype=torch.float32).to(device)


@functools.lru_cache(maxsize=16)
def _welch_consts(nperseg: int, sampling_rate: float, device: torch.device):
    """(periodic Hann window, one-sided correction, rfft frequencies), each
    float32 on ``device``, made once: the correction is 2 except at DC and,
    for even ``nperseg``, at Nyquist, where it is 1."""
    corr = np.full(nperseg // 2 + 1, 2.0, np.float32)
    corr[0] = 1.0
    if nperseg % 2 == 0:
        corr[-1] = 1.0
    freqs = np.fft.rfftfreq(nperseg, d=1.0 / sampling_rate).astype(np.float32)
    return (hann_window(nperseg, device), torch.as_tensor(corr, device=device),
            torch.as_tensor(freqs, device=device))


def unfold(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Frames of the last axis, (..., T) -> (..., 1 + (T - frame_length) // hop,
    frame_length), a strided view."""
    return x.unfold(-1, frame_length, hop)


def welch_psd(x: torch.Tensor, sampling_rate: float, nperseg: int = 256,
              noverlap: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Welch PSD of (..., T) along the last axis: (freqs (F,), psd (..., F)),
    float32 on ``x``'s device, F = nperseg // 2 + 1 after the clamp (the
    frequencies are shared between calls: do not write to them)."""
    nperseg = min(nperseg, x.shape[-1])
    if noverlap is None:
        noverlap = nperseg // 2
    win, corr, freqs = _welch_consts(nperseg, float(sampling_rate), x.device)
    frames = unfold(x.to(torch.float32), nperseg, nperseg - noverlap)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    power = torch.abs(torch.fft.rfft(frames * win, dim=-1)) ** 2
    scale = 1.0 / (sampling_rate * torch.sum(win ** 2))
    return freqs, torch.mean(power * scale * corr, dim=-2)


def stft(x: torch.Tensor, n_fft: int = 128, hop_length: int = 64,
         window: torch.Tensor | None = None) -> torch.Tensor:
    """Complex STFT of (..., T): (..., n_fft//2 + 1, n_frames)."""
    if window is None:
        window = hann_window(n_fft, x.device)
    spec = torch.stft(x.reshape(-1, x.shape[-1]), n_fft, hop_length, window=window,
                      center=True, pad_mode="reflect", onesided=True, return_complex=True)
    return spec.reshape(x.shape[:-1] + spec.shape[-2:])


def stft_log_magnitude(x: torch.Tensor, n_fft: int = 128, hop_length: int = 64,
                       freq_bins: int = 64, eps: float = 1e-8,
                       window: torch.Tensor | None = None) -> torch.Tensor:
    """log(|STFT| + eps) of the first ``freq_bins`` bins: (..., freq_bins, n_frames)."""
    mag = stft(x, n_fft, hop_length, window).abs()[..., :freq_bins, :]
    return torch.log(mag + eps)
