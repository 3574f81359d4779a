"""EEG model introspection: the flagship's intermediates, and autograd for
Grad-CAM.

The port of ``eyegaze_tpu/analysis/eeg_introspect.py`` (the reference's
``5_Metrics/eeg_metrics.py``).  Each function takes a ``DualEEGTransformer``
in ``eval()`` mode on its device (the inputs go where its parameters are)
and batches, dicts of numpy arrays ``eeg1``, ``eeg2`` (B, C, T) and
``label`` (B,); each returns numpy arrays with the JAX function's keys and
shapes.  Where JAX ``sow``s, the model's ``forward(..., capture=True)``
returns the same tensors under ``intermediates``; where JAX takes the
gradient at a ``perturb`` point, ``torch.autograd.grad`` takes it at the
captured activation.  On a CUDA device every forward launches the
phase-metrics kernel K1 once (in ``connectivity_matrices``), the Grad-CAM
forward too: K1's inputs need no gradient.

- ``run_inference``: logits, probs, preds, labels and the cls1 / cls2 /
  ibs_token embeddings;
- ``extract_ibs_matrices``: per-class mean connectivity matrices and the
  Cooperation - Competition difference;
- ``frequency_sensitivity``: accuracy and F1 with each band's connectivity
  zeroed (``mask_band``);
- ``extract_attention_maps``: head-averaged cross-attention maps, overall
  and per class, and their diagonals;
- ``extract_embeddings``: the z_fuse proxy [cls1, cls2, |cls1 - cls2|];
- ``gradcam_spectrogram``: the per-class mean Grad-CAM of the spectrogram
  CNN's conv2, resized to ``out_size`` x ``out_size``.

The channel montage and its 2D positions are the JAX module's (eeg_metrics.py
:960-995 and entropy_calculators.py:468-485).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List

import numpy as np
import torch

from eyegaze_tpu_torch.data.image_fusion import resize_bilinear
from eyegaze_tpu_torch.ops.connectivity import FEATURE_NAMES  # noqa: F401  (exported, as in JAX)
from eyegaze_tpu_torch.ops.spectral import BAND_DEFS_6
from eyegaze_tpu_torch.train.metrics import classification_metrics

BAND_NAMES = tuple(b[0] for b in BAND_DEFS_6)

STANDARD_32_CHANNELS = [
    "Fp1", "Fz", "F3", "F7", "FT9", "FC5", "FC1", "C3",
    "T7", "TP9", "CP5", "CP1", "Pz", "P3", "P7", "O1",
    "Oz", "O2", "P4", "P8", "TP10", "CP6", "CP2", "Cz",
    "C4", "T8", "FT10", "FC6", "FC2", "F4", "F8", "Fp2",
]

CHANNEL_POSITIONS_2D = {
    "Fp1": (-0.3, 0.9), "Fp2": (0.3, 0.9),
    "F7": (-0.7, 0.5), "F3": (-0.35, 0.5), "Fz": (0.0, 0.5), "F4": (0.35, 0.5), "F8": (0.7, 0.5),
    "FT9": (-0.9, 0.3), "FC5": (-0.55, 0.3), "FC1": (-0.2, 0.3), "FC2": (0.2, 0.3),
    "FC6": (0.55, 0.3), "FT10": (0.9, 0.3),
    "T7": (-0.9, 0.0), "C3": (-0.45, 0.0), "Cz": (0.0, 0.0), "C4": (0.45, 0.0), "T8": (0.9, 0.0),
    "TP9": (-0.9, -0.3), "CP5": (-0.55, -0.3), "CP1": (-0.2, -0.3), "CP2": (0.2, -0.3),
    "CP6": (0.55, -0.3), "TP10": (0.9, -0.3),
    "P7": (-0.7, -0.5), "P3": (-0.35, -0.5), "Pz": (0.0, -0.5), "P4": (0.35, -0.5),
    "P8": (0.7, -0.5),
    "O1": (-0.3, -0.8), "Oz": (0.0, -0.8), "O2": (0.3, -0.8),
}


def model_device(model) -> torch.device:
    return next(model.parameters()).device


def _forward(model, batch: Dict, **kw) -> dict:
    device = model_device(model)
    return model(torch.as_tensor(batch["eeg1"], device=device),
                 torch.as_tensor(batch["eeg2"], device=device), **kw)


@torch.inference_mode()
def run_inference(model, batches: Iterator[Dict]) -> Dict[str, np.ndarray]:
    """logits / probs / preds / labels (+ cls1, cls2, ibs_token)."""
    out: Dict[str, List[np.ndarray]] = {}
    labels = []
    for batch in batches:
        res = _forward(model, batch)
        labels.append(np.asarray(batch["label"]))
        for k in ("logits", "cls1", "cls2", "ibs_token"):
            if k in res:
                out.setdefault(k, []).append(res[k].cpu().numpy())
    result = {k: np.concatenate(v) for k, v in out.items()}
    result["labels"] = np.concatenate(labels)
    result["probs"] = torch.softmax(torch.from_numpy(result["logits"]), dim=-1).numpy()
    result["preds"] = result["logits"].argmax(axis=-1)
    return result


@torch.inference_mode()
def extract_ibs_matrices(model, batches: Iterator[Dict], num_classes: int = 3) -> Dict:
    """Per-class mean connectivity matrices + Cooperation - Competition.

    Returns {'class_means': (num_classes, 6, F, C, C), 'diff_coop_vs_comp':
    (6, F, C, C), 'counts': (num_classes,)}.
    """
    sums = None
    counts = np.zeros(num_classes, np.int64)
    for batch in batches:
        mats = _forward(model, batch, capture=True)["intermediates"]["ibs_matrices"]
        mats = mats.cpu().numpy()  # (B, 6, F, C, C)
        labels = np.asarray(batch["label"])
        if sums is None:
            sums = np.zeros((num_classes,) + mats.shape[1:], np.float64)
        for c in range(num_classes):
            sel = labels == c
            if sel.any():
                sums[c] += mats[sel].sum(axis=0)
                counts[c] += int(sel.sum())
    means = sums / np.maximum(counts, 1)[:, None, None, None, None]
    return {
        "class_means": means.astype(np.float32),
        "diff_coop_vs_comp": (means[2] - means[1]).astype(np.float32),
        "counts": counts,
    }


@torch.inference_mode()
def frequency_sensitivity(model_factory: Callable[[int], object],
                          batches_fn: Callable[[], Iterator[Dict]],
                          band_names: List[str] = list(BAND_NAMES),
                          num_classes: int = 3) -> Dict[str, Dict[str, float]]:
    """Accuracy / F1 with each band's connectivity zeroed.

    ``model_factory(band_idx)`` returns the model with ``mask_band=band_idx``
    and the same weights (``DualEEGTransformer.with_mask_band``).
    """
    results = {}
    for band_idx, band in enumerate(band_names):
        model = model_factory(band_idx)
        preds, labels = [], []
        for batch in batches_fn():
            preds.append(_forward(model, batch)["logits"].argmax(dim=-1).cpu().numpy())
            labels.append(np.asarray(batch["label"]))
        m = classification_metrics(np.concatenate(labels), np.concatenate(preds), num_classes)
        results[band] = {"accuracy": float(m["accuracy"]), "f1": float(m["f1_macro"])}
    return results


@torch.inference_mode()
def extract_attention_maps(model, batches: Iterator[Dict], num_classes: int = 3) -> Dict:
    """Mean cross-attention maps (1 -> 2, head-averaged) overall and per
    class, plus the per-class diagonal profiles."""
    total = None
    class_sums = None
    counts = np.zeros(num_classes, np.int64)
    n = 0
    for batch in batches:
        inter = _forward(model, batch, capture=True)["intermediates"]
        w = inter["attn_weights_1to2"].mean(dim=1).cpu().numpy()  # (B, T, T)
        labels = np.asarray(batch["label"])
        if total is None:
            total = np.zeros(w.shape[1:], np.float64)
            class_sums = np.zeros((num_classes,) + w.shape[1:], np.float64)
        total += w.sum(axis=0)
        for c in range(num_classes):
            sel = labels == c
            if sel.any():
                class_sums[c] += w[sel].sum(axis=0)
                counts[c] += int(sel.sum())
        n += w.shape[0]
    mean_map = (total / max(n, 1)).astype(np.float32)
    class_means = (class_sums / np.maximum(counts, 1)[:, None, None]).astype(np.float32)
    return {
        "mean_map": mean_map,
        "class_means": class_means,
        "diagonals": {c: np.diagonal(class_means[c]) for c in range(num_classes)},
        "counts": counts,
    }


def extract_embeddings(inference: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """z_fuse proxy [cls1, cls2, |cls1 - cls2|] (+ ibs_token passed through)."""
    cls1, cls2 = inference["cls1"], inference["cls2"]
    out = {"z_fuse": np.concatenate([cls1, cls2, np.abs(cls1 - cls2)], axis=1)}
    if "ibs_token" in inference:
        out["ibs_token"] = inference["ibs_token"]
    return out


def gradcam_spectrogram(model, batches: Iterator[Dict], num_classes: int = 3,
                        out_size: int = 64, stream: str = "spec1") -> np.ndarray:
    """Per-class mean Grad-CAM over the spectrogram's conv2 activation.

    One forward a batch with autograd on; for each class present in the
    batch, the gradient of the summed class logit at the captured (B*C, F',
    T', 64) activation; channel weights the gradient's spatial mean, the CAM
    the ReLU of the weighted channel sum, resized bilinearly (antialiased
    where it shrinks, as ``jax.image.resize``), averaged over the EEG
    channels, then over the class's samples.  Returns (num_classes,
    out_size, out_size).
    """
    sums = np.zeros((num_classes, out_size, out_size), np.float64)
    counts = np.zeros(num_classes, np.int64)
    key = f"{stream}_conv2_act"
    for batch in batches:
        labels = np.asarray(batch["label"])
        b, c = batch["eeg1"].shape[:2]
        present = [cls for cls in range(num_classes) if (labels == cls).any()]
        if not present:
            continue
        with torch.enable_grad():
            out = _forward(model, batch, capture=True)
            act = out["intermediates"][key]
            for i, cls in enumerate(present):
                (g,) = torch.autograd.grad(out["logits"][:, cls].sum(), act,
                                           retain_graph=i + 1 < len(present))
                with torch.no_grad():
                    w = g.mean(dim=(1, 2), keepdim=True)  # (N, 1, 1, 64)
                    cam = torch.relu((w * act).sum(dim=-1))  # (N, F', T')
                    cam = resize_bilinear(cam[:, None], out_size, out_size)[:, 0]
                    cam = cam.reshape(b, c, out_size, out_size).mean(dim=1).cpu().numpy()
                sel = labels == cls
                sums[cls] += cam[sel].sum(axis=0)
                counts[cls] += int(sel.sum())
    return (sums / np.maximum(counts, 1)[:, None, None]).astype(np.float32)
