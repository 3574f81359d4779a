"""Seeded synthetic EEG fixtures (numpy only).

The port's copy of the EEG generators of ``eyegaze_tpu/data/synthetic.py``:
the same numpy calls in the same order, so a seed gives bit-identical
arrays in both packages.

- ``gen_eeg`` — multi-sine + Gaussian-noise EEG
  (``1_Data/processed/two_EEG_fusion.py:31-49``);
- ``synthetic_eeg_pair_dataset`` — class-structured pairs: cooperative
  pairs share phase-locked oscillations, competitive pairs share frequency
  with phase jitter, singles are independent, so the connectivity features
  carry real class signal;
- ``synthetic_gaze_heatmap`` and ``synthetic_gaze_pair_dataset`` —
  class-conditioned Gaussian-blob gaze heatmaps standing in for the private
  gaze JPGs;
- ``synthetic_metadata`` — mock ``complete_metadata.json`` records.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from eyegaze_tpu_torch.data.metadata import CLASS_NAMES


def gen_eeg(
    C: int = 32,
    T: int = 1024,
    sample_rate: float = 256.0,
    mode: str = "mixed",
    noise_std: float = 0.1,
    num_components: int = 3,
    seed: Optional[int] = None,
) -> np.ndarray:
    """Multi-sine + noise EEG (two_EEG_fusion.py:31-49 parity)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T, dtype=np.float32) / float(sample_rate)
    x = np.zeros((C, T), dtype=np.float32)
    if mode in {"sine", "mixed"}:
        for c in range(C):
            freqs = rng.uniform(1.0, 40.0, size=(num_components,)).astype(np.float32)
            amps = rng.uniform(0.1, 1.0, size=(num_components,)).astype(np.float32)
            phases = rng.uniform(0.0, 2.0 * np.pi, size=(num_components,)).astype(np.float32)
            s = np.zeros_like(t)
            for f, a, p in zip(freqs, amps, phases):
                s += a * np.sin(2.0 * np.pi * f * t + p)
            x[c] += s.astype(np.float32)
    if mode in {"noise", "mixed"}:
        x += rng.normal(0.0, noise_std, size=(C, T)).astype(np.float32)
    return x


def _class_coupled_eeg_pair(
    label: int, C: int, T: int, fs: float, rng: np.random.Generator,
    noise_std: float = 0.3,
) -> Tuple[np.ndarray, np.ndarray]:
    """An EEG pair whose inter-brain synchrony depends on the class.

    Single (0): independent signals.  Competition (1): shared 20 Hz component
    with per-channel phase jitter.  Cooperation (2): strongly phase-locked
    10 Hz component.  ``noise_std`` scales the broadband Gaussian noise floor.
    """
    t = np.arange(T, dtype=np.float32) / fs
    base1 = rng.normal(0.0, noise_std, size=(C, T)).astype(np.float32)
    base2 = rng.normal(0.0, noise_std, size=(C, T)).astype(np.float32)
    for c in range(C):
        f = rng.uniform(2.0, 40.0)
        base1[c] += np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi)).astype(np.float32)
        f = rng.uniform(2.0, 40.0)
        base2[c] += np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi)).astype(np.float32)
    if label == 1:  # Competition: shared rhythm, loose coupling
        phase0 = rng.uniform(0, 2 * np.pi)
        for c in range(C):
            jitter = rng.uniform(0, np.pi)
            base1[c] += 0.8 * np.sin(2 * np.pi * 20.0 * t + phase0).astype(np.float32)
            base2[c] += 0.8 * np.sin(2 * np.pi * 20.0 * t + phase0 + jitter).astype(np.float32)
    elif label == 2:  # Cooperation: tight phase locking
        phase0 = rng.uniform(0, 2 * np.pi)
        lock = 0.2 * rng.normal()
        for c in range(C):
            base1[c] += 1.0 * np.sin(2 * np.pi * 10.0 * t + phase0).astype(np.float32)
            base2[c] += 1.0 * np.sin(2 * np.pi * 10.0 * t + phase0 + lock).astype(np.float32)
    return base1, base2


def synthetic_eeg_pair_dataset(
    n: int = 64,
    C: int = 32,
    T: int = 1024,
    fs: float = 256.0,
    seed: int = 42,
    balanced: bool = True,
    noise_std: float = 0.3,
) -> Dict[str, np.ndarray]:
    """Class-structured dual-EEG dataset: {'eeg1','eeg2','label','pair'}."""
    rng = np.random.default_rng(seed)
    labels = (
        np.arange(n) % 3 if balanced else rng.integers(0, 3, size=n)
    ).astype(np.int32)
    e1 = np.zeros((n, C, T), np.float32)
    e2 = np.zeros((n, C, T), np.float32)
    for i in range(n):
        e1[i], e2[i] = _class_coupled_eeg_pair(int(labels[i]), C, T, fs, rng,
                                               noise_std=noise_std)
    pairs = (12 + (np.arange(n) % 28)).astype(np.int32)
    pairs[pairs >= 18] += 1  # skip excluded pair 18
    return {"eeg1": e1, "eeg2": e2, "label": labels, "pair": pairs}


def synthetic_gaze_heatmap(
    label: int,
    H: int = 224,
    W: int = 224,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Class-conditioned RGB gaze heatmap (3, H, W) in [0, 1].

    Single: one focused blob; Competition: two separated blobs;
    Cooperation: overlapping central blobs.
    """
    rng = rng or np.random.default_rng()
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)

    def blob(cy, cx, s):
        return np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s**2)))

    heat = np.zeros((H, W), np.float32)
    if label == 0:
        heat += blob(rng.uniform(0.3, 0.7) * H, rng.uniform(0.3, 0.7) * W, 0.08 * H)
    elif label == 1:
        heat += blob(rng.uniform(0.1, 0.35) * H, rng.uniform(0.1, 0.35) * W, 0.1 * H)
        heat += blob(rng.uniform(0.65, 0.9) * H, rng.uniform(0.65, 0.9) * W, 0.1 * H)
    else:
        heat += blob(0.5 * H + rng.normal(0, 5), 0.5 * W + rng.normal(0, 5), 0.15 * H)
        heat += blob(0.5 * H + rng.normal(0, 5), 0.5 * W + rng.normal(0, 5), 0.15 * H)
    heat += 0.05 * rng.random((H, W), dtype=np.float32)
    heat /= heat.max() + 1e-8
    # Intensity to a jet-like RGB (the reference's heatmap JPGs are RGB).
    r = np.clip(1.5 * heat - 0.25, 0, 1)
    g = np.clip(1.5 - np.abs(2.5 * heat - 1.25), 0, 1)
    b = np.clip(1.25 - 1.5 * heat, 0, 1)
    return np.stack([r, g, b], axis=0).astype(np.float32)


def synthetic_gaze_pair_dataset(
    n: int = 32, H: int = 224, W: int = 224, seed: int = 42
) -> Dict[str, np.ndarray]:
    """Class-structured gaze-pair dataset: {'img1','img2','label','pair'}."""
    rng = np.random.default_rng(seed)
    labels = (np.arange(n) % 3).astype(np.int32)
    img1 = np.zeros((n, 3, H, W), np.float32)
    img2 = np.zeros((n, 3, H, W), np.float32)
    for i in range(n):
        img1[i] = synthetic_gaze_heatmap(int(labels[i]), H, W, rng)
        img2[i] = synthetic_gaze_heatmap(int(labels[i]), H, W, rng)
    pairs = (12 + (np.arange(n) % 28)).astype(np.int32)
    pairs[pairs >= 18] += 1
    return {"img1": img1, "img2": img2, "label": labels, "pair": pairs}


def synthetic_metadata(n: int = 60, seed: int = 42) -> List[Dict]:
    """Mock ``complete_metadata.json`` records (the reference's schema)."""
    rng = np.random.default_rng(seed)
    out = []
    pair_ids = [p for p in range(12, 41) if p != 18]
    for i in range(n):
        pair = pair_ids[i % len(pair_ids)]
        cls = CLASS_NAMES[i % 3]
        out.append(
            {
                "pair": pair,
                "player1": f"p{pair}_a_{cls.lower()}_{i}",
                "player2": f"p{pair}_b_{cls.lower()}_{i}",
                "class": cls,
                "formal_sen": float(rng.uniform(1, 7)),
                "lively_sen": float(rng.uniform(1, 7)),
            }
        )
    return out
