"""Host-side batch loaders (numpy only).

The port's copy of ``ArrayDataset``, ``batch_iterator``,
``DualEEGWindowDataset``, ``GazePairArrays`` and ``MultimodalArrays`` from
``eyegaze_tpu/data/loader.py``.  Trials live
in numpy arrays, windowing is index math, and a batch is a dict of numpy
arrays; the trainer moves it to the device.  The seeded shuffle draws from
numpy's generator alone, so for the same (seed, epoch) both packages give
the same batches in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from eyegaze_tpu_torch.data.windows import WindowIndex, gather_windows, window_index


@dataclasses.dataclass
class ArrayDataset:
    """A dict of equally sized numpy arrays with batch iteration."""

    arrays: Dict[str, np.ndarray]

    def __post_init__(self):
        sizes = {k: len(v) for k, v in self.arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"ragged arrays: {sizes}")

    def __len__(self) -> int:
        return len(next(iter(self.arrays.values())))

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self.arrays.items()}


def _batch_indices(
    n: int, batch_size: int, shuffle: bool, seed: int,
    drop_remainder: bool, epoch: int,
) -> Iterator[np.ndarray]:
    """Shared index plan for every loader: deterministic per (seed, epoch)
    shuffle, optional tail drop."""
    idx = np.arange(n)
    if shuffle:
        rng = np.random.default_rng(seed + epoch * 100003)
        rng.shuffle(idx)
    end = n - (n % batch_size) if drop_remainder else n
    for start in range(0, end, batch_size):
        yield idx[start : start + batch_size]


def batch_iterator(
    dataset: "ArrayDataset | Dict[str, np.ndarray]",
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_remainder: bool = False,
    epoch: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield dict batches; deterministic per (seed, epoch).  With
    ``drop_remainder=True`` every batch has the same shape."""
    if isinstance(dataset, dict):
        dataset = ArrayDataset(dataset)
    for sel in _batch_indices(len(dataset), batch_size, shuffle, seed,
                              drop_remainder, epoch):
        yield dataset[sel]


class DualEEGWindowDataset:
    """Window-level view over trial-level dual-EEG arrays.

    Stores (N_trials, C, T) per player + labels; samples are sliding windows
    (window_size/stride parity with dual_eeg_dataset.py:28-29 defaults).
    """

    def __init__(
        self,
        eeg1: np.ndarray,
        eeg2: np.ndarray,
        labels: np.ndarray,
        window_size: int = 1024,
        stride: int = 512,
        pairs: Optional[np.ndarray] = None,
    ):
        if eeg1.shape != eeg2.shape:
            raise ValueError(f"player arrays differ in shape: {eeg1.shape} vs {eeg2.shape}")
        self.eeg1 = eeg1
        self.eeg2 = eeg2
        self.labels = labels
        self.pairs = pairs
        self.index: WindowIndex = window_index(
            [eeg1.shape[-1]] * len(eeg1), window_size, stride
        )

    def __len__(self) -> int:
        return len(self.index)

    def batch(self, items: Sequence[int]) -> Dict[str, np.ndarray]:
        out = {
            "eeg1": gather_windows(self.eeg1, self.index, items),
            "eeg2": gather_windows(self.eeg2, self.index, items),
            "label": self.labels[self.index.trial_ids[items]],
        }
        if self.pairs is not None:
            out["pair"] = self.pairs[self.index.trial_ids[items]]
        return out

    def iter_batches(
        self, batch_size: int, shuffle: bool = False, seed: int = 0,
        drop_remainder: bool = False, epoch: int = 0,
    ) -> Iterator[Dict[str, np.ndarray]]:
        for sel in _batch_indices(len(self), batch_size, shuffle, seed,
                                  drop_remainder, epoch):
            yield self.batch(sel)


@dataclasses.dataclass
class GazePairArrays:
    """Gaze-pair samples as arrays: (N, 3, H, W) x2 + labels (+ pair ids)."""

    img1: np.ndarray
    img2: np.ndarray
    labels: np.ndarray
    pairs: Optional[np.ndarray] = None

    def __len__(self):
        return len(self.labels)

    def as_dataset(self) -> ArrayDataset:
        arrays = {"img1": self.img1, "img2": self.img2, "label": self.labels}
        if self.pairs is not None:
            arrays["pair"] = self.pairs
        return ArrayDataset(arrays)


class MultimodalArrays(DualEEGWindowDataset):
    """Gaze-image pairs joined to dual-EEG windows: one sample is one
    sliding EEG window of a trial with that trial's two images, which
    repeat across the trial's windows (MultimodalDataset,
    multimodal_dataset.py:19-275).  Images may be uint8 (converted arrays,
    ``data/images.py``); the trainer makes them unit-float on the device."""

    def __init__(
        self,
        img1: np.ndarray,
        img2: np.ndarray,
        eeg1: np.ndarray,
        eeg2: np.ndarray,
        labels: np.ndarray,
        window_size: int = 1024,
        stride: int = 512,
        pairs: Optional[np.ndarray] = None,
    ):
        if not len(img1) == len(img2) == len(eeg1) == len(labels):
            raise ValueError(f"trial counts differ: images {len(img1)}/{len(img2)}, EEG "
                             f"{len(eeg1)}, labels {len(labels)}")
        super().__init__(eeg1, eeg2, labels, window_size, stride, pairs)
        self.img1 = img1
        self.img2 = img2

    def batch(self, items: Sequence[int]) -> Dict[str, np.ndarray]:
        trial = self.index.trial_ids[items]
        return {"img1": np.asarray(self.img1[trial]), "img2": np.asarray(self.img2[trial]),
                **super().batch(items)}
