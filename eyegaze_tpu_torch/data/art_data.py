"""ART data: the real directory layout and the seeded synthetic fallback
(numpy only).

The port's copy of ``eyegaze_tpu/data/art_data.py``, with the same seeds, so
a split is equal to the bit in both packages.  Real data lives at
``root/{train,val,test}/{Brain,ChannelNoise,Eye,Heart,LineNoise,Muscle,
Other}/<file>``: clean targets in Brain/, inputs from a noise category drawn
by ``random.Random(seed)`` with the same file name (the clean copy where that
variant is missing).  The synthetic split draws inputs from ``gen_eeg`` with
seeds ``seed * 100003 + i`` and targets with ``seed * 100019 + i``.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from eyegaze_tpu_torch.data.loader import ArrayDataset
from eyegaze_tpu_torch.data.native import load_csv_f32
from eyegaze_tpu_torch.data.synthetic import gen_eeg

NOISE_CATEGORIES = ("Brain", "ChannelNoise", "Eye", "Heart", "LineNoise",
                    "Muscle", "Other")


def read_eeg(path: str | Path) -> np.ndarray:
    """A .csv or .npy EEG file as float32 (C, T) with C < T (transposed
    where it was stored (T, C))."""
    path = Path(path)
    if path.suffix.lower() == ".csv":
        arr, rows, cols = load_csv_f32(path, max_rows=4096, max_cols=65536)
        arr = arr[:rows, :cols]
    elif path.suffix.lower() == ".npy":
        arr = np.load(path)
    else:
        raise ValueError(f"Unsupported EEG extension: {path.suffix}")
    if arr.ndim != 2:
        raise ValueError(f"EEG must be 2D, got {arr.shape}")
    c, t = arr.shape
    if c > t:
        arr = arr.T
        c, t = arr.shape
    if c >= t:
        raise ValueError(f"Cannot determine (C, T) with C < T: {arr.shape}")
    return arr.astype(np.float32)


def real_art_split(root: str | Path, split: str, seed: Optional[int] = 42,
                   max_files: Optional[int] = None) -> ArrayDataset:
    """A real split: clean labels from Brain/, inputs from a random noise
    category's file of the same name."""
    base = Path(root) / split
    brain = base / "Brain"
    rng = random.Random(seed)
    files = sorted(p.name for p in brain.iterdir() if p.is_file())
    if max_files:
        files = files[:max_files]
    inputs, labels = [], []
    for fname in files:
        category = rng.choice(list(NOISE_CATEGORIES))
        clean = read_eeg(brain / fname)
        noise_path = base / category / fname
        inputs.append(read_eeg(noise_path) if noise_path.is_file() else clean.copy())
        labels.append(clean)
    return ArrayDataset({"input_values": np.stack(inputs), "labels": np.stack(labels)})


def synthetic_art_split(length: int, C: int = 32, T: int = 1024,
                        sample_rate: float = 256.0, seed: Optional[int] = 42,
                        attr: Optional[Dict] = None,
                        target: Optional[Dict] = None) -> ArrayDataset:
    """A seeded synthetic split; ``attr`` and ``target`` are ``gen_eeg``
    keywords for the inputs and the labels."""
    attr = attr or {}
    target = target or {}
    inputs = np.stack([
        gen_eeg(C, T, sample_rate=sample_rate,
                seed=None if seed is None else seed * 100003 + i, **attr)
        for i in range(length)
    ])
    labels = np.stack([
        gen_eeg(C, T, sample_rate=sample_rate,
                seed=None if seed is None else seed * 100019 + i, **target)
        for i in range(length)
    ])
    return ArrayDataset({"input_values": inputs, "labels": labels})


def build_art_datasets(config: Dict, seed: Optional[int] = 42) -> Dict[str, ArrayDataset]:
    """{'train', 'val', 'test'}: real where ``data.root``/train/Brain is a
    directory, else synthetic with each split's ``data.splits`` settings."""
    data_cfg = config.get("data", {})
    root = data_cfg.get("root")
    use_real = isinstance(root, str) and (Path(root) / "train" / "Brain").is_dir()
    out = {}
    for split in ("train", "val", "test"):
        if use_real:
            out[split] = real_art_split(root, split, seed=seed)
        else:
            params = data_cfg.get("splits", {}).get(split, {})
            out[split] = synthetic_art_split(
                params.get("length", 1000 if split == "train" else 100),
                C=int(params.get("C", data_cfg.get("C", 32))),
                T=int(params.get("T", data_cfg.get("T", 1024))),
                sample_rate=float(params.get("sample_rate", 256.0)),
                seed=seed,
                attr=params.get("attr", {}),
                target=params.get("target", {}),
            )
    return out
