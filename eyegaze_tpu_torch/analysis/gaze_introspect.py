"""Gaze-model introspection: saliency, ViT Grad-CAM, CLS features.

The port of ``eyegaze_tpu/analysis/gaze_introspect.py`` (the reference's
``6_Utils/attention_utils.py``: input-gradient saliency :107-164, Grad-CAM
on the last block's patch tokens :166-255; and the CLS features of
``5_Metrics/feature_extractors.py:36-397``), with autograd where JAX takes
``jax.grad`` at its inputs and ``perturb`` points.  Models are in
``eval()`` mode on their device; images are (B, C, H, W) float arrays,
already normalized, and go where the model's parameters are.  The ViT's
attention is the plain ``models/vit.py::dot_product_attention``: no kernel
of the port runs here.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from eyegaze_tpu_torch.data.image_fusion import resize_bilinear
from eyegaze_tpu_torch.analysis.eeg_introspect import model_device

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32).reshape(3, 1, 1)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32).reshape(3, 1, 1)


def denormalize_image(img: np.ndarray) -> np.ndarray:
    """Undo the ImageNet normalization -> [0, 1] (attention_utils.py:36-72)."""
    return np.clip(np.asarray(img) * IMAGENET_STD + IMAGENET_MEAN, 0.0, 1.0)


def _class_score(logits: torch.Tensor, class_idx: Optional[int]) -> torch.Tensor:
    """The summed logit of ``class_idx``, or of each row's argmax."""
    if class_idx is None:
        idx = logits.argmax(dim=-1)
    else:
        idx = torch.full((logits.shape[0],), class_idx, dtype=torch.long, device=logits.device)
    return logits.gather(1, idx[:, None]).sum()


def _inputs(model, *images) -> list:
    device = model_device(model)
    return [torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
            for x in images]


def input_saliency(model, img1, img2, class_idx: Optional[int] = None):
    """|d logit_c / d input| per pixel, the max over channels
    (attention_utils.py:107-164).  Returns (saliency1, saliency2), each (B,
    H, W)."""
    x1, x2 = (x.requires_grad_() for x in _inputs(model, img1, img2))
    with torch.enable_grad():
        g1, g2 = torch.autograd.grad(_class_score(model(x1, x2), class_idx), (x1, x2))
    return (g1.abs().amax(dim=1).cpu().numpy(), g2.abs().amax(dim=1).cpu().numpy())


def vit_gradcam(model, img1, img2, class_idx: Optional[int] = None,
                upsample_to: Optional[int] = None) -> np.ndarray:
    """Grad-CAM over an early-fusion ViT's last-block patch tokens
    (``model(..., return_tokens=True)``): CLS stripped, the channel weights
    the gradient's token mean, the CAM the ReLU of the weighted sum on the
    patch grid (14 x 14 for ViT-B/16 at 224), optionally resized bilinearly
    to ``upsample_to``, each map divided by its max + 1e-8.  Returns (B, P,
    P) or (B, up, up)."""
    x1, x2 = _inputs(model, img1, img2)
    with torch.enable_grad():
        logits, tokens = model(x1, x2, return_tokens=True)
        (g,) = torch.autograd.grad(_class_score(logits, class_idx), tokens)
    with torch.no_grad():
        g, a = g[:, 1:, :], tokens[:, 1:, :]
        w = g.mean(dim=1, keepdim=True)  # token-averaged channel weights
        cam = torch.relu((w * a).sum(dim=-1))  # (B, P^2)
        p = int(np.sqrt(cam.shape[1]))
        cam = cam.reshape(-1, p, p)
        if upsample_to:
            cam = resize_bilinear(cam[:, None], upsample_to, upsample_to)[:, 0]
        cam = cam.float().cpu().numpy()
    denom = cam.reshape(cam.shape[0], -1).max(axis=1)[:, None, None] + 1e-8
    return cam / denom


@torch.inference_mode()
def extract_cls_features(model, batches: Iterator[Dict]) -> Dict[str, np.ndarray]:
    """CLS features and labels for the early (one stream) or late (two
    streams: ``fused`` plus ``cls1`` and ``cls2``) models."""
    feats: List[np.ndarray] = []
    labels: List[np.ndarray] = []
    extra: Dict[str, List[np.ndarray]] = {}
    for batch in batches:
        out = model(*_inputs(model, batch["img1"], batch["img2"]), return_features=True)
        if isinstance(out, dict):  # LateFusionViT
            feats.append(out["fused"].cpu().numpy())
            for k in ("cls1", "cls2"):
                extra.setdefault(k, []).append(out[k].cpu().numpy())
        else:
            feats.append(out.cpu().numpy())
        labels.append(np.asarray(batch["label"]))
    result = {"features": np.concatenate(feats), "labels": np.concatenate(labels)}
    for k, v in extra.items():
        result[k] = np.concatenate(v)
    return result
