"""Raw EEG CSVs -> trial arrays.

The counterpart of ``scripts/preprocess_eeg_raw.py``:

    python -m eyegaze_tpu_torch.preprocess_eeg_raw --metadata complete_metadata.json \
        --eeg-dir /data/eeg_csv [--output-dir data/EEGraw_npy] [--num-channels 32] \
        [--target-length 3250] [--val-pairs 33 ... 40] [--batch 64]

Each player's CSV (``<eeg-dir>/<stem>.csv``, the stems from the metadata
records' player1 / player2) becomes a (num_channels, target_length) float32
trial, padded or cut on both axes; a time-major file (more rows than
columns) is transposed.  The records split by pair (``--val-pairs`` held
out) into ``{split}_eeg1.npy``, ``{split}_eeg2.npy``, ``{split}_labels.npy``,
``{split}_pairs.npy`` and ``{split}_metadata.json``, whose
``metadata_indices`` give each kept trial's index in the metadata file.  A
file that cannot be read drops its trial, and the split's metadata counts
it.  The CSVs are parsed by the native loader (``data/native.py``), many
per call; the module runs on the host alone.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from eyegaze_tpu_torch.data.metadata import LABEL2ID, load_metadata, pair_split
from eyegaze_tpu_torch.data.native import load_csv_batch_f32, load_csv_f32


def fix_orientation(arr: np.ndarray, rows: int, cols: int, num_channels: int,
                    target_length: int) -> np.ndarray:
    """The parsed (rows, cols) block as (num_channels, target_length), padded
    or cut on both axes; a time-major block (rows > cols) is transposed."""
    data = arr[:rows, :cols]
    if rows > cols:
        data = data.T
    c, t = data.shape
    out = np.zeros((num_channels, target_length), np.float32)
    cc = min(c, num_channels)
    tt = min(t, target_length)
    out[:cc, :tt] = data[:cc, :tt]
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--metadata", required=True)
    ap.add_argument("--eeg-dir", required=True)
    ap.add_argument("--output-dir", default="data/EEGraw_npy")
    ap.add_argument("--num-channels", type=int, default=32)
    ap.add_argument("--target-length", type=int, default=3250)
    ap.add_argument("--val-pairs", type=int, nargs="*", default=[33, 34, 35, 36, 37, 38, 39, 40])
    ap.add_argument("--batch", type=int, default=64)
    return ap.parse_args(argv)


def load_split(meta: list, eeg_dir: Path, args: argparse.Namespace):
    """(eeg1, eeg2, keep) of one split's records: (n, num_channels,
    target_length) float32 each and the trials whose two files both parsed."""
    n = len(meta)
    eeg1 = np.zeros((n, args.num_channels, args.target_length), np.float32)
    eeg2 = np.zeros_like(eeg1)
    keep = np.ones(n, bool)
    max_rows = max(args.num_channels * 2, 64)
    max_cols = args.target_length + 256
    for start in range(0, n, args.batch):
        chunk = meta[start:start + args.batch]
        for player, dest in (("player1", eeg1), ("player2", eeg2)):
            paths = [eeg_dir / f"{m[player]}.csv" for m in chunk]
            block, rows, cols, ok = load_csv_batch_f32(paths, max_rows, max_cols)
            for j in range(len(chunk)):
                i = start + j
                if not ok[j] or rows[j] == 0:
                    keep[i] = False
                elif rows[j] >= max_rows:
                    # The row cap was hit: a time-major file (one row per
                    # sample), of which the block kept only the first
                    # max_rows samples.  Parse it again with the caps swapped.
                    arr, r, c = load_csv_f32(paths[j], max_rows=args.target_length + 256,
                                             max_cols=max_rows)
                    dest[i] = fix_orientation(arr, int(r), int(c), args.num_channels,
                                              args.target_length)
                else:
                    dest[i] = fix_orientation(block[j], int(rows[j]), int(cols[j]),
                                              args.num_channels, args.target_length)
    return eeg1, eeg2, keep


def main(argv=None) -> int:
    args = parse_args(argv)
    metadata = load_metadata(args.metadata)
    eeg_dir = Path(args.eeg_dir)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)

    # Each record's index in the metadata file, so that other modalities
    # converted in that order line up trial by trial.
    val_set = set(args.val_pairs)
    train_idx = [i for i, m in enumerate(metadata) if m["pair"] not in val_set]
    val_idx = [i for i, m in enumerate(metadata) if m["pair"] in val_set]
    train_meta, val_meta = pair_split(metadata, args.val_pairs)
    t0 = time.time()
    for split, meta, gidx in (("train", train_meta, train_idx), ("val", val_meta, val_idx)):
        n = len(meta)
        if n == 0:
            continue
        eeg1, eeg2, keep = load_split(meta, eeg_dir, args)
        labels = np.asarray([LABEL2ID[m["class"]] for m in meta], np.int32)
        pairs = np.asarray([m["pair"] for m in meta], np.int32)
        kept = int(keep.sum())
        np.save(out / f"{split}_eeg1.npy", eeg1[keep])
        np.save(out / f"{split}_eeg2.npy", eeg2[keep])
        np.save(out / f"{split}_labels.npy", labels[keep])
        np.save(out / f"{split}_pairs.npy", pairs[keep])
        (out / f"{split}_metadata.json").write_text(json.dumps({
            "split": split, "requested": n, "converted": kept,
            "skipped": n - kept, "num_channels": args.num_channels,
            "target_length": args.target_length,
            "metadata_indices": [int(g) for g, k in zip(gidx, keep) if k],
            "class_counts": {int(c): int((labels[keep] == c).sum())
                             for c in np.unique(labels[keep])},
        }, indent=2))
        print(f"[raw] {split}: {kept}/{n} trials converted")
    print(f"[raw] done in {time.time() - t0:.1f}s -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
