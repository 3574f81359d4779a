"""Sliding-window index math for trial-level EEG -> window-level samples
(numpy only).

The port's copy of ``eyegaze_tpu/data/windows.py``, a rebuild of
DualEEGDataset._prepare_windows (``dual_eeg_dataset.py:62-113``): the window
index is pure arithmetic over trial lengths, and a batch gathers its
windows from the trial arrays.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class WindowIndex:
    """Flat index of (trial, start) pairs for all sliding windows."""

    trial_ids: np.ndarray  # (num_windows,) int32
    starts: np.ndarray  # (num_windows,) int32
    window_size: int
    stride: int

    def __len__(self) -> int:
        return len(self.trial_ids)


def window_index(
    trial_lengths: Sequence[int], window_size: int = 1024, stride: int = 512
) -> WindowIndex:
    """num_windows per trial = (T - window) // stride + 1 (0 if T < window)."""
    trial_ids: List[int] = []
    starts: List[int] = []
    for tid, t in enumerate(trial_lengths):
        if t < window_size:
            continue
        n = (t - window_size) // stride + 1
        trial_ids.extend([tid] * n)
        starts.extend(range(0, n * stride, stride))
    return WindowIndex(
        np.asarray(trial_ids, np.int32),
        np.asarray(starts, np.int32),
        window_size,
        stride,
    )


def gather_windows(
    signals: np.ndarray, index: WindowIndex, items: Sequence[int]
) -> np.ndarray:
    """Gather windows [items] from (N, C, T) trial array -> (len(items), C, W)."""
    w = index.window_size
    out = np.empty((len(items), signals.shape[1], w), signals.dtype)
    for i, item in enumerate(items):
        tid = index.trial_ids[item]
        s = index.starts[item]
        out[i] = signals[tid, :, s : s + w]
    return out
