"""Trial metadata: class names, generation, verification, splits, class
weights (numpy only).

The port's copy of ``eyegaze_tpu/data/metadata.py``.  Record schema
(``complete_metadata.json``): ``{pair, player1, player2, class, formal_sen,
lively_sen}`` with classes Single / Competition / Cooperation, pairs 12-40
and pair 18 excluded (generate_json.py:52-157, verify_metadata.py:1-83).

Splits:

- ``pair_split`` — held-out pair IDs for validation (gaze trainers use
  val pairs 33-40, gaze_pair_dataset.py:139-229);
- ``stratified_split`` — seeded stratified random split (EEG trainer,
  train_art.py:99-139); deterministic given (seed, test_size), from numpy's
  generator alone, so both packages draw the same split.
"""

from __future__ import annotations

import json
import re
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

CLASS_NAMES = ("Single", "Competition", "Cooperation")
LABEL2ID = {"Single": 0, "Competition": 1, "Cooperation": 2}
EXCLUDED_PAIRS = (18,)
PAIR_RANGE = (12, 40)

# The class of a player file from its stem (generate_json.py:52-89), e.g.
# "..._single_...", "..._comp...", "..._coop...".
_CLASS_PATTERNS = (
    (re.compile(r"single", re.I), "Single"),
    (re.compile(r"comp", re.I), "Competition"),
    (re.compile(r"coop", re.I), "Cooperation"),
)


def get_class_from_filename(name: str) -> Optional[str]:
    for pat, cls in _CLASS_PATTERNS:
        if pat.search(name):
            return cls
    return None


def generate_metadata(records: Sequence[Dict]) -> List[Dict]:
    """Raw records filtered and normalized into the metadata schema: pair 18
    and pairs outside 12-40 dropped, the class from the record or else from
    player1's file name, records of no known class dropped."""
    out = []
    for rec in records:
        pair = int(rec["pair"])
        if pair in EXCLUDED_PAIRS or not (PAIR_RANGE[0] <= pair <= PAIR_RANGE[1]):
            continue
        cls = rec.get("class") or get_class_from_filename(str(rec.get("player1", "")))
        if cls not in LABEL2ID:
            continue
        out.append(
            {
                "pair": pair,
                "player1": rec["player1"],
                "player2": rec["player2"],
                "class": cls,
                "formal_sen": rec.get("formal_sen"),
                "lively_sen": rec.get("lively_sen"),
            }
        )
    return out


def load_metadata(path: str | Path) -> List[Dict]:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def verify_metadata(metadata: Sequence[Dict]) -> Dict:
    """Validation report: pair-18 exclusion, pair range, class counts, null
    required fields, unknown classes; ``ok`` when there is no problem."""
    pairs = sorted({m["pair"] for m in metadata})
    class_counts = Counter(m["class"] for m in metadata)
    problems = []
    if any(p in EXCLUDED_PAIRS for p in pairs):
        problems.append("excluded pair present")
    if any(not (PAIR_RANGE[0] <= p <= PAIR_RANGE[1]) for p in pairs):
        problems.append("pair out of range")
    null_fields = sum(
        1 for m in metadata for k in ("pair", "player1", "player2", "class") if m.get(k) is None
    )
    if null_fields:
        problems.append(f"{null_fields} null required fields")
    unknown = set(class_counts) - set(CLASS_NAMES)
    if unknown:
        problems.append(f"unknown classes: {unknown}")
    return {
        "num_records": len(metadata),
        "pairs": pairs,
        "class_counts": dict(class_counts),
        "problems": problems,
        "ok": not problems,
    }


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
