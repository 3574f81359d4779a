"""Offline EEG preprocessing: bandpass -> CAR -> z-score -> sliding windows.

The counterpart of ``scripts/preprocess_eeg_windows.py``:

    python -m eyegaze_tpu_torch.preprocess_eeg_windows [--input-dir DIR] \
        [--output-dir data/EEGseg_preprocessed] [--sampling-rate 250] \
        [--filter-low 0.5] [--filter-high 50] [--window-size 1024] [--stride 256] \
        [--split-mode pair|stratified] [--val-pairs 33 ... 40] [--seed 42] \
        [--synthetic-trials N] [--device cpu]

Reads the trials ``eeg1.npy``, ``eeg2.npy``, ``labels.npy`` and
``pairs.npy`` from ``--input-dir`` (or makes seeded synthetic ones), splits
them by pair (``--val-pairs`` held out) or by a seeded stratified split,
and writes per split the windows ``{split}_eeg1.npy`` / ``{split}_eeg2.npy``
(N, C, window), their ``{split}_labels.npy`` / ``{split}_pairs.npy`` and
``{split}_metadata.json``.  The zero-phase Butterworth bandpass, CAR,
z-score and windowing (``ops/preprocess.py``) run 16 trials at a time on the
CUDA card, or on the CPU when ``--device cpu`` asks for it; without a card
it stops with a message.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from eyegaze_tpu_torch.data.metadata import stratified_split
from eyegaze_tpu_torch.data.synthetic import synthetic_eeg_pair_dataset
from eyegaze_tpu_torch.ops.preprocess import preprocess_eeg, sliding_windows
from eyegaze_tpu_torch.train_dual_eeg import resolve_device


def preprocess_and_window(eeg: np.ndarray, fs: float, low: float, high: float, window: int,
                          stride: int, *, device: torch.device, batch: int = 16) -> np.ndarray:
    """(N, C, T) trials -> (N, n_windows, C, window) float32, ``batch``
    trials at a time on ``device``."""
    outs = []
    for start in range(0, len(eeg), batch):
        x = torch.from_numpy(np.ascontiguousarray(eeg[start:start + batch])).to(device)
        outs.append(sliding_windows(preprocess_eeg(x, fs, low, high), window, stride).cpu().numpy())
    return np.concatenate(outs)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--input-dir", default=None,
                    help="dir with eeg1.npy/eeg2.npy/labels.npy/pairs.npy trials")
    ap.add_argument("--output-dir", default="data/EEGseg_preprocessed")
    ap.add_argument("--sampling-rate", type=float, default=250.0)
    ap.add_argument("--filter-low", type=float, default=0.5)
    ap.add_argument("--filter-high", type=float, default=50.0)
    ap.add_argument("--window-size", type=int, default=1024)
    ap.add_argument("--stride", type=int, default=256)
    ap.add_argument("--split-mode", choices=["pair", "stratified"], default="pair")
    ap.add_argument("--val-pairs", type=int, nargs="*", default=[33, 34, 35, 36, 37, 38, 39, 40])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--synthetic-trials", type=int, default=None,
                    help="generate synthetic trials instead of reading input")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the CUDA card; 'cpu' must be asked for)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device, "eyegaze_tpu_torch.preprocess_eeg_windows")
    t0 = time.time()
    if args.input_dir:
        d = Path(args.input_dir)
        eeg1 = np.load(d / "eeg1.npy")
        eeg2 = np.load(d / "eeg2.npy")
        labels = np.load(d / "labels.npy")
        pairs = np.load(d / "pairs.npy")
    else:
        n = args.synthetic_trials or 24
        data = synthetic_eeg_pair_dataset(n=n, C=32, T=max(args.window_size, 2048),
                                          fs=args.sampling_rate, seed=args.seed)
        eeg1, eeg2, labels, pairs = data["eeg1"], data["eeg2"], data["label"], data["pair"]
        print(f"[preprocess] synthetic mode: {n} trials")

    if args.split_mode == "pair":
        val_mask = np.isin(pairs, np.asarray(args.val_pairs))
        train_idx = np.flatnonzero(~val_mask)
        val_idx = np.flatnonzero(val_mask)
    else:
        tr, va = stratified_split(list(range(len(labels))), labels, test_size=0.2,
                                  seed=args.seed)
        train_idx, val_idx = np.asarray(tr), np.asarray(va)

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    for split, idxs in (("train", train_idx), ("val", val_idx)):
        if len(idxs) == 0:
            print(f"[preprocess] {split}: empty split, skipping")
            continue
        w1, w2 = (preprocess_and_window(eeg[idxs], args.sampling_rate, args.filter_low,
                                        args.filter_high, args.window_size, args.stride,
                                        device=device)
                  for eeg in (eeg1, eeg2))
        n_trials, n_win = w1.shape[:2]
        win_labels = np.repeat(labels[idxs], n_win)
        win_pairs = np.repeat(pairs[idxs], n_win)
        np.save(out / f"{split}_eeg1.npy", w1.reshape(-1, *w1.shape[2:]))
        np.save(out / f"{split}_eeg2.npy", w2.reshape(-1, *w2.shape[2:]))
        np.save(out / f"{split}_labels.npy", win_labels)
        np.save(out / f"{split}_pairs.npy", win_pairs)
        meta = {
            "split": split, "trials": int(n_trials),
            "windows": int(n_trials * n_win), "window_size": args.window_size,
            "stride": args.stride, "sampling_rate": args.sampling_rate,
            "filter": [args.filter_low, args.filter_high],
            "split_mode": args.split_mode,
            "class_counts": {int(c): int((win_labels == c).sum())
                             for c in np.unique(win_labels)},
        }
        (out / f"{split}_metadata.json").write_text(json.dumps(meta, indent=2))
        print(f"[preprocess] {split}: {meta['windows']} windows from {n_trials} trials")
    print(f"[preprocess] done in {time.time() - t0:.1f}s -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
