"""Gaze-image augmentations, one random transform shared by both images of
a pair.

The port of ``eyegaze_tpu/data/gaze_augment.py``: a random horizontal flip
and a colour jitter (brightness, contrast, saturation), the training-mode
augmentations of the reference's gaze datasets (multimodal_dataset.py:
19-275), applied with the same decision to both players' images
(AugmentedDualImageDataset, dual_image_dataset_v2.py:19-208).

Each is split in two: a draw (``draw_flip``, ``draw_jitter``), which takes
a ``torch.Generator`` on the images' device, and an apply
(``random_horizontal_flip``, ``color_jitter``), deterministic given the
draw and written op for op as the JAX functions compute.  The JAX package
draws from its PRNG keys, so the draws cannot match it; the applies do.
"""

from __future__ import annotations

from typing import Tuple

import torch


def draw_flip(b: int, generator: torch.Generator, prob: float = 0.5) -> torch.Tensor:
    """(B,) bool: which samples flip, each with probability ``prob``, on
    ``generator``'s device."""
    return torch.rand((b,), generator=generator, device=generator.device) < prob


def draw_jitter(b: int, generator: torch.Generator, brightness: float = 0.2,
                contrast: float = 0.2, saturation: float = 0.2) -> torch.Tensor:
    """(3, B) float32: the brightness, contrast and saturation factors, each
    uniform on [1 - x, 1 + x] (torchvision's ColorJitter), on
    ``generator``'s device."""
    u = torch.rand((3, b), generator=generator, device=generator.device)
    x = torch.tensor((brightness, contrast, saturation), device=generator.device)[:, None]
    return (1 - x) + 2 * x * u


def random_horizontal_flip(img: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) with the samples where ``flip`` holds mirrored along W."""
    return torch.where(flip[:, None, None, None], img.flip(-1), img)


def color_jitter(img: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) in [0, 1] jittered by ``factors`` (``draw_jitter``'s):
    brightness multiplies, contrast blends with each image's grayscale mean,
    saturation with its grayscale image (both taken after the brightness),
    then a clip to [0, 1]."""
    bf, cf, sf = (f[:, None, None, None] for f in factors)
    out = img * bf
    gray = (0.299 * out[:, 0] + 0.587 * out[:, 1] + 0.114 * out[:, 2])[:, None]
    mean = gray.mean(dim=(2, 3), keepdim=True)
    out = cf * out + (1 - cf) * mean
    out = sf * out + (1 - sf) * gray
    return torch.clip(out, 0.0, 1.0)


def augment_gaze_pair(generator: torch.Generator, img1: torch.Tensor, img2: torch.Tensor,
                      flip_prob: float = 0.5,
                      jitter: float = 0.2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same random flip and jitter on both (B, 3, H, W) images in [0, 1]:
    the pair's spatial relation is kept."""
    b = img1.shape[0]
    flip = draw_flip(b, generator, flip_prob)
    factors = draw_jitter(b, generator, jitter, jitter, jitter)
    return tuple(color_jitter(random_horizontal_flip(x, flip), factors) for x in (img1, img2))
