"""Spatial and spectral entropy on tensors.

Port of ``eyegaze_tpu/ops/entropy.py``:

- ``spatial_entropy``: the Shannon entropy (bits) of a gaze heatmap taken as
  a spatial probability distribution: luminosity grayscale, min-max
  normalisation, abs + eps, normalised to sum 1, ``-sum(p log2 p)``;
- ``spectral_entropy``: Butterworth filtfilt bandpass, Welch PSD, then the
  Shannon entropy of each channel's PSD, batched over (..., C, T).

Both compute in float32, whatever the input's dtype, as the JAX package does.
"""

from __future__ import annotations

import math

import torch

from eyegaze_tpu_torch.ops.preprocess import bandpass_filtfilt_blocked
from eyegaze_tpu_torch.ops.spectral import welch_psd


def shannon_entropy_from_probs(p: torch.Tensor, axis: int = -1, base: float = 2.0) -> torch.Tensor:
    """H = -sum(p log p) / log(base); ``p`` sums to 1 along ``axis``."""
    return -torch.sum(p * torch.log(p), dim=axis) / math.log(base)


def _normalize_to_probability(x: torch.Tensor, axis: int = -1, eps: float = 1e-10) -> torch.Tensor:
    x = torch.abs(x) + eps
    return x / torch.sum(x, dim=axis, keepdim=True)


def _to_grayscale(image: torch.Tensor) -> torch.Tensor:
    """(..., H, W), (..., H, W, 3) or (..., 3, H, W) -> (..., H, W)
    luminosity; a trailing axis of 3 is taken for channels first."""
    if image.dim() >= 3 and image.shape[-1] == 3:
        return 0.299 * image[..., 0] + 0.587 * image[..., 1] + 0.114 * image[..., 2]
    if image.dim() >= 3 and image.shape[-3] == 3:
        return (0.299 * image[..., 0, :, :] + 0.587 * image[..., 1, :, :]
                + 0.114 * image[..., 2, :, :])
    return image


def spatial_entropy(image: torch.Tensor, normalize_input: bool = True) -> torch.Tensor:
    """Spatial Shannon entropy (bits) of heatmaps (H, W), (H, W, 3),
    (3, H, W) or any batch of them: one value per image."""
    gray = _to_grayscale(image.to(torch.float32))
    flat = gray.reshape(gray.shape[:-2] + (-1,))
    if normalize_input:
        lo = flat.amin(dim=-1, keepdim=True)
        hi = flat.amax(dim=-1, keepdim=True)
        flat = (flat - lo) / (hi - lo + 1e-10)
    return shannon_entropy_from_probs(_normalize_to_probability(flat))


def spectral_entropy(eeg: torch.Tensor, sampling_rate: float = 250.0, filter_low: float = 0.5,
                     filter_high: float = 50.0, filter_order: int = 4, nperseg: int = 256,
                     apply_filter: bool = True) -> torch.Tensor:
    """Spectral Shannon entropy (bits) per channel: (..., C, T) -> (..., C)."""
    eeg = eeg.to(torch.float32)
    if apply_filter:
        eeg = bandpass_filtfilt_blocked(eeg, filter_low, filter_high, sampling_rate, filter_order)
    _, psd = welch_psd(eeg, sampling_rate, nperseg=nperseg)
    return shannon_entropy_from_probs(_normalize_to_probability(psd))
