"""Offline EEG feature extraction: PSD, band energy, intra- and inter-brain connectivity.

The counterpart of ``scripts/extract_eeg_features.py``:

    python -m eyegaze_tpu_torch.extract_eeg_features [--input-dir DIR] \
        [--output-dir data/features] [--sampling-rate 250] [--resume] \
        [--synthetic-trials N] [--row-chunk 8] [--trial-chunk 8] [--device cpu]

Reads the trials ``eeg1.npy``, ``eeg2.npy``, ``labels.npy`` and
``pairs.npy`` from ``--input-dir`` (or makes seeded synthetic ones, 32 x
2048) and writes ``trial_{i:05d}.npz`` per trial with the keys ``psd`` (2,
C, F), ``band_energy`` (2, C, 5), ``intra`` (2, 7, 5, C, C), ``inter`` (7,
5, C, C), ``label`` and ``pair``: the JAX script's keys, shapes and dtypes.

``--trial-chunk`` trials go through the feature ops (``ops/features.py``,
Welch PSD) together on the CUDA card, or on the CPU when ``--device cpu``
asks for it; without a card it stops with a message.  The last chunk may be
shorter.  The writes are asynchronous: each chunk's features are copied to
pinned host memory on a side stream, ordered after the chunk by an event,
and written by one writer thread while the next chunk computes; the
writer's first error is raised in ``main``.  ``--resume`` skips a chunk
whose trials are all on disk, and writes only the missing trials of one
that is partly there.
"""

from __future__ import annotations

import argparse
import collections
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from eyegaze_tpu_torch.data.synthetic import synthetic_eeg_pair_dataset
from eyegaze_tpu_torch.ops.features import band_energy_from_psd, connectivity_block
from eyegaze_tpu_torch.ops.spectral import welch_psd
from eyegaze_tpu_torch.train_dual_eeg import resolve_device

NPERSEG = 256
MAX_PENDING = 2  # chunks copied or being written while the next one computes


def get_completed_trials(out_dir: Path) -> set:
    return {int(p.stem.split("_")[1]) for p in out_dir.glob("trial_*.npz")}


def chunk_features(e1: torch.Tensor, e2: torch.Tensor, fs: float, row_chunk: int) -> dict:
    """The features of a chunk of (n, C, T) pairs, each (n, ...) float32:
    psd (n, 2, C, F), band_energy (n, 2, C, 5), intra (n, 2, 7, 5, C, C),
    inter (n, 7, 5, C, C)."""
    _, psd = welch_psd(torch.stack([e1, e2], dim=1), fs, nperseg=NPERSEG)
    intra, inter = connectivity_block(e1, e2, fs, row_chunk=row_chunk)
    return {"psd": psd,
            "band_energy": band_energy_from_psd(psd, fs, nperseg=min(NPERSEG, e1.shape[-1])),
            "intra": intra, "inter": inter}


def write_trial(out: Path, i: int, feats: dict, j: int, label, pair) -> None:
    """``trial_{i:05d}.npz`` from row ``j`` of a chunk's host features, the
    arrays in the JAX script's order (its features' keys sorted, then label
    and pair)."""
    np.savez(out / f"trial_{i:05d}.npz", **{k: feats[k][j] for k in sorted(feats)},
             label=label, pair=pair)


class ChunkWriter:
    """Writes chunks of features on one thread, at most ``MAX_PENDING``
    chunks behind the caller.  On a CUDA device each chunk is copied to
    pinned host memory on a side stream that waits for the chunk's event;
    the writer waits for the copy's event before it reads."""

    def __init__(self, out: Path, labels: np.ndarray, pairs: np.ndarray, device: torch.device):
        self.out, self.labels, self.pairs = out, labels, pairs
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.pool = ThreadPoolExecutor(1, thread_name_prefix="feature-writer")
        self.pending = collections.deque()

    def submit(self, rows: list, feats: dict) -> None:
        """Writes ``rows`` ((j, i) pairs: chunk row j as trial i) of ``feats``."""
        done = None
        if self.stream is not None:
            ready = torch.cuda.Event()
            ready.record()
            self.stream.wait_event(ready)
            host = {}
            with torch.cuda.stream(self.stream):
                for k, v in feats.items():
                    host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    host[k].copy_(v, non_blocking=True)
                    v.record_stream(self.stream)  # not reused before the copy ends
            done = torch.cuda.Event()
            done.record(self.stream)
            feats = host
        self.pending.append(self.pool.submit(self._write, rows, feats, done))
        while len(self.pending) > MAX_PENDING:
            self.pending.popleft().result()

    def _write(self, rows: list, feats: dict, done) -> None:
        if done is not None:
            done.synchronize()
        arrays = {k: v.numpy() for k, v in feats.items()}
        for j, i in rows:
            write_trial(self.out, i, arrays, j, self.labels[i], self.pairs[i])

    def close(self) -> None:
        """Waits for every write; raises the first error of the writer."""
        try:
            while self.pending:
                self.pending.popleft().result()
        finally:
            self.pool.shutdown(wait=True, cancel_futures=True)


def upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host chunk on ``device``, through pinned memory on a card, so that
    the copy does not wait for the work already queued."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--input-dir", default=None)
    ap.add_argument("--output-dir", default="data/features")
    ap.add_argument("--sampling-rate", type=float, default=250.0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--synthetic-trials", type=int, default=None)
    ap.add_argument("--row-chunk", type=int, default=8)
    ap.add_argument("--trial-chunk", type=int, default=8,
                    help="trials computed together; each chunk is written while the next "
                         "one computes")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the CUDA card; 'cpu' must be asked for)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device, "eyegaze_tpu_torch.extract_eeg_features")
    if args.input_dir:
        d = Path(args.input_dir)
        eeg1 = np.load(d / "eeg1.npy")
        eeg2 = np.load(d / "eeg2.npy")
        labels = np.load(d / "labels.npy")
        pairs = np.load(d / "pairs.npy")
    else:
        n = args.synthetic_trials or 8
        data = synthetic_eeg_pair_dataset(n=n, C=32, T=2048, fs=args.sampling_rate, seed=42)
        eeg1, eeg2, labels, pairs = data["eeg1"], data["eeg2"], data["label"], data["pair"]
        print(f"[extract] synthetic mode: {n} trials")

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    done = get_completed_trials(out) if args.resume else set()
    n_trials = len(labels)
    tc = max(1, min(args.trial_chunk, n_trials))

    t0 = time.time()
    n_done = 0
    writer = ChunkWriter(out, labels, pairs, device)
    try:
        for lo in range(0, n_trials, tc):
            hi = min(lo + tc, n_trials)
            rows = [(j, i) for j, i in enumerate(range(lo, hi)) if i not in done]
            if not rows:
                continue
            feats = chunk_features(upload(eeg1[lo:hi], device), upload(eeg2[lo:hi], device),
                                   args.sampling_rate, args.row_chunk)
            writer.submit(rows, feats)
            n_done += len(rows)
    finally:
        writer.close()
    dt = time.time() - t0
    print(f"[extract] {n_done} trials in {dt:.1f}s "
          f"({n_done / max(dt, 1e-9):.2f} trials/s, chunk={tc}) -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
