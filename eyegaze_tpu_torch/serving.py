"""Serving: the DualEEGTransformer and the ART denoiser on one device behind
bucketed batching.

Port of ``eyegaze_tpu/serving.py::Predictor`` and ``ArtDenoiser``.  Request
batches are zero-padded up to the next bucket size, so the device sees a
fixed set of batch shapes; above the largest bucket a request is chunked,
and padding rows are stripped from the outputs.  The model runs in
``eval()`` under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from eyegaze_tpu_torch.ops.preprocess import common_average_reference, zscore

CLASS_NAMES = ("Single", "Competition", "Cooperation")


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _predict_batched(forward, buckets: Sequence[int], *arrays, device: torch.device):
    """Run ``forward(*batches)`` over zero-padded bucket batches.

    ``arrays`` are numpy arrays or tensors with the batch on the leading
    axis; each chunk goes to ``device`` once.  ``forward`` returns a tensor
    whose padding rows are stripped; the chunks' results are concatenated
    as one numpy array.
    """
    n = len(arrays[0])
    max_b = buckets[-1]
    outs = []
    for start in range(0, n, max_b):
        parts = [torch.as_tensor(a[start:start + max_b], device=device) for a in arrays]
        keep = len(parts[0])
        pad = _bucket(keep, buckets) - keep
        if pad:
            parts = [torch.cat([p, p.new_zeros((pad,) + p.shape[1:])]) for p in parts]
        outs.append(forward(*parts)[:keep].cpu().numpy())
    return np.concatenate(outs)


class Predictor:
    """Bucketed predictor for the DualEEGTransformer family on one device."""

    def __init__(self, model: torch.nn.Module, *, device: torch.device,
                 batch_buckets: Sequence[int] = (1, 8, 32, 128), preprocess: bool = True):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.buckets = tuple(sorted(batch_buckets))
        self.preprocess = preprocess

    @torch.inference_mode()
    def _forward(self, eeg1: torch.Tensor, eeg2: torch.Tensor) -> torch.Tensor:
        # float32 whatever the request's type, as the JAX Predictor places it.
        eeg1, eeg2 = eeg1.float(), eeg2.float()
        if self.preprocess:
            eeg1 = zscore(common_average_reference(eeg1))
            eeg2 = zscore(common_average_reference(eeg2))
        return self.model(eeg1, eeg2)["logits"]

    def warmup(self, c: int = 32, t: int = 1024) -> None:
        """Run every bucket once on zeros before serving."""
        for b in self.buckets:
            z = torch.zeros((b, c, t), dtype=torch.float32, device=self.device)
            self._forward(z, z)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict(self, eeg1, eeg2) -> Dict[str, np.ndarray]:
        """(N, C, T) pairs, numpy or tensors of any float type, served as
        float32 -> {'logits', 'probs', 'preds', 'labels'} for any N (padded to
        the next bucket, chunked above the largest)."""
        logits = _predict_batched(self._forward, self.buckets, eeg1, eeg2,
                                  device=self.device)
        return _logits_to_output(logits)


class ArtDenoiser:
    """Bucketed denoiser for the ART seq2seq model on one device.

    Serving is label-free: the decoder is fed the noisy signal itself (the
    model's ``tgt = src`` default).  A model whose Reconstructor z-scores over
    the batch (``recon_zscore='batch'``) would give every sample an output
    that depends on the request's other rows and on the zero padding, so it
    is always served one sample at a time: its buckets are ``(1,)`` whatever
    the caller passes.  The model may compute in float32 or bf16
    (``ArtifactRemovalTransformer(dtype=...)``; the JAX ``from_checkpoint``
    serves bf16): requests come in and go out as float32 either way.
    """

    def __init__(self, model: torch.nn.Module, *, device: torch.device,
                 batch_buckets: Sequence[int] = (1, 8, 32)):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        if model.config.recon_zscore == "batch":
            batch_buckets = (1,)
        self.buckets = tuple(sorted(batch_buckets))

    @torch.inference_mode()
    def _forward(self, noisy: torch.Tensor) -> torch.Tensor:
        return self.model(noisy.float())

    def warmup(self, c: int | None = None, t: int | None = None) -> None:
        """Run every bucket once on zeros; ``t`` defaults to the 1024-sample
        window, capped at the positional table's ``max_len``."""
        cfg = self.model.config
        c = c or cfg.in_channels
        t = t or min(1024, cfg.max_len)
        for b in self.buckets:
            self._forward(torch.zeros((b, c, t), dtype=torch.float32, device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict(self, noisy) -> Dict[str, np.ndarray]:
        """(N, C, T) noisy EEG, numpy or a tensor -> {'denoised': (N, C_out, T) f32}."""
        return {"denoised": _predict_batched(self._forward, self.buckets, noisy,
                                             device=self.device)}


def _logits_to_output(logits: np.ndarray) -> Dict[str, np.ndarray]:
    probs = torch.softmax(torch.from_numpy(logits), dim=-1).numpy()
    preds = logits.argmax(axis=-1)
    # The canonical 3 classes get their reference names; other class counts
    # get generic names rather than an out-of-range index.
    names = (CLASS_NAMES if logits.shape[-1] == len(CLASS_NAMES)
             else tuple(f"class_{i}" for i in range(logits.shape[-1])))
    return {
        "logits": logits,
        "probs": probs,
        "preds": preds,
        "labels": [names[int(p)] for p in preds],
    }
