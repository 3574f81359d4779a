"""Image preprocessing and data-level fusion of gaze image pairs, as tensor ops.

The port's copy of ``eyegaze_tpu/data/image_fusion.py``: the ToTensor step
(uint8 -> [0, 1]), ImageNet or HF ViT-processor normalization, the five
data-fusion modes (side-by-side pastes and pixel operations) and a bilinear
resize.  They run on whatever device the tensors are on, so a served request
ships uint8 and is converted on the card.

``jax.image.resize(..., "bilinear")`` antialiases when it shrinks an axis
(its triangle kernel widens by the scale), and the horizontal and vertical
pastes are shrunk back to the model's size, so ``resize_bilinear`` is
``F.interpolate(mode="bilinear", antialias=True, align_corners=False)``,
which filters the same way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

DATA_FUSION_MODES = ("horizontal", "vertical", "add", "multiply", "subtract")


def to_unit_float(img: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1]; a float input passes through."""
    if img.dtype == torch.uint8:
        return img.float() / 255.0
    return img


def imagenet_normalize(img: torch.Tensor) -> torch.Tensor:
    """(..., 3, H, W) in [0, 1] -> ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img.device).reshape(3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img.device).reshape(3, 1, 1)
    return (img - mean) / std


def vit_processor_normalize(img: torch.Tensor) -> torch.Tensor:
    """(..., 3, H, W) in [0, 1] -> [-1, 1], the HF ``ViTImageProcessor``
    defaults (mean = std = 0.5)."""
    return (img - 0.5) / 0.5


def resize_bilinear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of (N, C, H, W) to (N, C, h, w), antialiased where
    an axis shrinks (module docstring)."""
    return F.interpolate(img, size=(h, w), mode="bilinear", antialias=True, align_corners=False)


def fuse_image_pair(img_a: torch.Tensor, img_b: torch.Tensor, mode: str) -> torch.Tensor:
    """Data-level fusion of two (..., 3, H, W) images in [0, 1]:
    'horizontal' / 'vertical' paste them side by side (the caller resizes
    back to the model's size), the pixel modes combine them and clip to
    [0, 1]."""
    if mode == "horizontal":
        return torch.cat([img_a, img_b], dim=-1)
    if mode == "vertical":
        return torch.cat([img_a, img_b], dim=-2)
    if mode == "add":
        return torch.clip((img_a + img_b) / 2.0, 0.0, 1.0)
    if mode == "multiply":
        return torch.clip(img_a * img_b, 0.0, 1.0)
    if mode == "subtract":
        return torch.clip(torch.abs(img_a - img_b), 0.0, 1.0)
    raise ValueError(f"mode must be one of {DATA_FUSION_MODES}, got {mode!r}")
