"""Seeded synthetic EEG fixtures (numpy only).

The port's copy of the EEG generators of ``eyegaze_tpu/data/synthetic.py``:
the same numpy calls in the same order, so a seed gives bit-identical
arrays in both packages.

- ``gen_eeg`` — multi-sine + Gaussian-noise EEG
  (``1_Data/processed/two_EEG_fusion.py:31-49``);
- ``synthetic_eeg_pair_dataset`` — class-structured pairs: cooperative
  pairs share phase-locked oscillations, competitive pairs share frequency
  with phase jitter, singles are independent, so the connectivity features
  carry real class signal.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


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
