"""EEG augmentations for HyperEEG training.

The port of ``eyegaze_tpu/data/augment.py`` (the HyperEEG spec,
``4_Experiments/experiments_list.md:316-320``): time masking (spans of at
most 50 samples, two per sample), channel dropout (probability 0.2) and
Gaussian noise (std 0.05), batched, with masks rather than slices.  Every
draw comes from a ``torch.Generator`` on the tensor's device, so the draws
cannot match the JAX package's PRNG keys; the distributions do.
"""

from __future__ import annotations

import torch


def time_masking(generator: torch.Generator, x: torch.Tensor, max_length: int = 50,
                 num_masks: int = 2) -> torch.Tensor:
    """Zero ``num_masks`` random time spans of 1 to ``max_length`` samples
    per sample of (B, C, T) ``x``.  Starts are uniform on the inclusive
    range [0, T - max_length], as in JAX, so the last span can start at the
    final ``max_length`` stretch."""
    b, _, t = x.shape
    dev = x.device
    pos = torch.arange(t, device=dev)[None, :]
    mask = torch.ones((b, t), dtype=x.dtype, device=dev)
    for _ in range(num_masks):
        starts = torch.randint(0, max(t - max_length + 1, 1), (b, 1), generator=generator,
                               device=dev)
        lengths = torch.randint(1, max_length + 1, (b, 1), generator=generator, device=dev)
        span = (pos >= starts) & (pos < starts + lengths)
        mask = mask * (1.0 - span.to(x.dtype))
    return x * mask[:, None, :]


def channel_dropout(generator: torch.Generator, x: torch.Tensor,
                    prob: float = 0.2) -> torch.Tensor:
    """Zero whole channels of (B, C, T) ``x``, each with probability ``prob``."""
    b, c, _ = x.shape
    keep = torch.rand((b, c, 1), generator=generator, device=x.device) < 1.0 - prob
    return x * keep.to(x.dtype)


def gaussian_noise(generator: torch.Generator, x: torch.Tensor,
                   std: float = 0.05) -> torch.Tensor:
    return x + std * torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)


def augment_eeg(generator: torch.Generator, x: torch.Tensor, time_mask_length: int = 50,
                num_time_masks: int = 2, channel_drop_prob: float = 0.2,
                noise_std: float = 0.05) -> torch.Tensor:
    """Time masking, then channel dropout, then Gaussian noise (the
    HyperEEG training recipe)."""
    x = time_masking(generator, x, time_mask_length, num_time_masks)
    x = channel_dropout(generator, x, channel_drop_prob)
    return gaussian_noise(generator, x, noise_std)
