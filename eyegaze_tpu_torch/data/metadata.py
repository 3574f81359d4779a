"""Trial metadata: class names, splits, class weights (numpy only).

The port's copy of the parts of ``eyegaze_tpu/data/metadata.py`` that
training needs.  Splits:

- ``pair_split`` — held-out pair IDs for validation (gaze trainers use
  val pairs 33-40, gaze_pair_dataset.py:139-229);
- ``stratified_split`` — seeded stratified random split (EEG trainer,
  train_art.py:99-139); deterministic given (seed, test_size), from numpy's
  generator alone, so both packages draw the same split.
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

CLASS_NAMES = ("Single", "Competition", "Cooperation")
LABEL2ID = {"Single": 0, "Competition": 1, "Cooperation": 2}


def pair_split(
    metadata: Sequence[Dict], val_pairs: Sequence[int]
) -> Tuple[List[Dict], List[Dict]]:
    """Held-out-pair split (gaze_pair_dataset.py:164-171)."""
    val_pairs = set(val_pairs)
    train = [m for m in metadata if m["pair"] not in val_pairs]
    val = [m for m in metadata if m["pair"] in val_pairs]
    return train, val


def stratified_split(
    items: Sequence, labels: Sequence[int], test_size: float = 0.2, seed: int = 42
) -> Tuple[list, list]:
    """Deterministic per-class shuffle split (train_art.py:99-139 semantics).

    Returns (train_items, test_items).  Falls back to an unstratified split if
    any class has fewer than 2 members, like the reference.
    """
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    counts = Counter(labels.tolist())
    if min(counts.values()) < 2:
        idx = rng.permutation(len(items))
        n_test = int(round(len(items) * test_size))
        test_idx = set(idx[:n_test].tolist())
        return (
            [items[i] for i in range(len(items)) if i not in test_idx],
            [items[i] for i in sorted(test_idx)],
        )
    train_idx: List[int] = []
    test_idx_l: List[int] = []
    for cls in sorted(counts):
        cls_idx = np.flatnonzero(labels == cls)
        cls_idx = cls_idx[rng.permutation(len(cls_idx))]
        n_test = max(1, int(round(len(cls_idx) * test_size)))
        test_idx_l.extend(cls_idx[:n_test].tolist())
        train_idx.extend(cls_idx[n_test:].tolist())
    train_idx.sort()
    test_idx_l.sort()
    return [items[i] for i in train_idx], [items[i] for i in test_idx_l]


def class_weights(labels: Sequence[int], num_classes: int = 3) -> np.ndarray:
    """Inverse-frequency weights normalized as in gaze_pair_dataset.py:110-131:
    w_c = N / (num_classes * count_c)."""
    counts = Counter(labels)
    n = len(labels)
    w = np.zeros(num_classes, np.float32)
    for c, cnt in counts.items():
        w[c] = n / (num_classes * cnt)
    return w


def save_split_indices(path: str | Path, train_idx: Sequence[int], val_idx: Sequence[int]):
    """Materialize a split for exact reproduction across runs/frameworks."""
    with open(path, "w") as f:
        json.dump({"train": list(map(int, train_idx)), "val": list(map(int, val_idx))}, f)


def load_split_indices(path: str | Path) -> Tuple[List[int], List[int]]:
    with open(path) as f:
        d = json.load(f)
    return d["train"], d["val"]
