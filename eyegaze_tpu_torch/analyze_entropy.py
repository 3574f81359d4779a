"""Entropy analysis: gaze spatial entropy and EEG spectral entropy by
condition.

    python -m eyegaze_tpu_torch.analyze_entropy [--mock] [--gaze-dir DIR] [--eeg-dir DIR] \\
        [--trials 30] [--fs 256] [--filter-low 0.5] [--filter-high 50] [--device cpu]

The counterpart of the JAX package's ``scripts/analyze_entropy.py`` (the
reference's ``7_Analysis/python_scripts/analyze_entropy.py``): the same
flags, plus ``--device``, and the same files.  The condition parsers, the
batched entropies (``ops/entropy``, each shape group in chunks on the
device), the mock generator with its per-condition distributions, the
condition statistics, then the CSVs and the figures.

It runs on the CUDA card unless ``--device cpu`` asks for the CPU.  Every
number (the entropies and the condition statistics) is computed before any
table or figure is written; the numeric functions return records or
columns, not DataFrames, so they run where pandas is not installed.  The
writers then run in the JAX script's order: pandas builds and writes the
tables (the per-pair summaries are its group-by), matplotlib draws the
figures; a missing one stops the run with an ``ImportError`` naming it.
PIL decodes the gaze images (``--gaze-dir``).  The EEG CSVs are parsed by
``data/native.py``'s C++ loader (its numpy parser where that does not
build).
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path
from typing import Dict, List, Mapping, Sequence, Union

import numpy as np
import torch

from eyegaze_tpu_torch.analysis.eeg_introspect import CHANNEL_POSITIONS_2D, STANDARD_32_CHANNELS
from eyegaze_tpu_torch.data.native import load_csv_f32
from eyegaze_tpu_torch.data.synthetic import synthetic_eeg_pair_dataset, synthetic_gaze_pair_dataset
from eyegaze_tpu_torch.ops.entropy import spatial_entropy, spectral_entropy
from eyegaze_tpu_torch.train_dual_eeg import resolve_device

CONDITIONS = ("Single", "Competition", "Cooperation")

# A table: row records (a DataFrame's ``to_dict("records")``) or columns
# (name -> array), each as the JAX script hands it to ``pd.DataFrame``.
Table = Union[List[Dict], Mapping[str, Sequence]]

# Filename convention parsers — the reference's three patterns
# (7_Analysis/python_scripts/analyze_entropy.py:110-179):
#   Single:      Pair-{id}-{A|B}-Single-EYE_trial{n}_{player|observer}.csv
#   Competition: Pair-{id}-Comp-EYE_trial{n}_{playerA|playerB}.csv
#   Cooperation: Pair-{id}-Coop-EYE_trial{n}_{playerA|playerB}.csv
_SINGLE_RE = re.compile(r"Pair-(\d+)-([AB])-Single-EYE_trial(\d+)_(player|observer)\.csv")
_COMP_RE = re.compile(r"Pair-(\d+)-Comp-EYE_trial(\d+)_(playerA|playerB)\.csv")
_COOP_RE = re.compile(r"Pair-(\d+)-Coop-EYE_trial(\d+)_(playerA|playerB)\.csv")


def parse_eeg_filename(filename: str):
    """pair_id/condition/trial_idx/player from an EEG CSV filename, or None."""
    m = _SINGLE_RE.match(filename)
    if m:
        pair_id, ab, trial_idx, role = m.groups()
        return {"pair_id": int(pair_id), "condition": "Single",
                "trial_idx": int(trial_idx), "player": f"{ab}_{role}"}
    for pat, cond in ((_COMP_RE, "Competition"), (_COOP_RE, "Cooperation")):
        m = pat.match(filename)
        if m:
            pair_id, trial_idx, player = m.groups()
            return {"pair_id": int(pair_id), "condition": cond,
                    "trial_idx": int(trial_idx), "player": player}
    return None


def parse_gaze_filename(filename: str):
    """Same conventions with .jpg/.png extension (analyze_entropy.py:164-179)."""
    base = filename.replace(".jpg", ".csv").replace(".png", ".csv")
    return parse_eeg_filename(base)


def scan_eeg_files(eeg_dir):
    """Scan *.csv under ``eeg_dir`` for reference-convention filenames
    (analyze_entropy.py:224-257)."""
    eeg_path = Path(eeg_dir)
    if not eeg_path.exists():
        raise FileNotFoundError(f"EEG directory not found: {eeg_dir}")
    files = []
    for f in sorted(eeg_path.glob("*.csv")):
        meta = parse_eeg_filename(f.name)
        if meta is not None:
            meta["filepath"] = str(f)
            meta["filename"] = f.name
            files.append(meta)
    print(f"[scan] {len(files)} EEG CSV files in {eeg_dir}")
    return files


def scan_gaze_files(gaze_dir):
    """Scan *.jpg / *.png under ``gaze_dir`` (analyze_entropy.py:259-294)."""
    gaze_path = Path(gaze_dir)
    if not gaze_path.exists():
        raise FileNotFoundError(f"Gaze directory not found: {gaze_dir}")
    files = []
    for pattern in ("*.jpg", "*.png"):
        for f in sorted(gaze_path.glob(pattern)):
            meta = parse_gaze_filename(f.name)
            if meta is not None:
                meta["filepath"] = str(f)
                meta["filename"] = f.name
                files.append(meta)
    print(f"[scan] {len(files)} gaze image files in {gaze_dir}")
    return files


def _chunk_size(per_item_elems: int, budget_elems: int = 80_000_000) -> int:
    """Items per device call: ``budget_elems`` input elements, so the
    float32 intermediates of one call stay a bounded multiple of 320 MB
    (a whole directory of full-resolution 3000 x 1583 heatmaps, ~4.75 M
    pixels each, in one call would not fit).  Chunking costs nothing
    measurable: each chunk is one batched call of the same ops.  At the
    recorded EEG trial shape (32, 3250) one chunk holds 769 trials; a chunk
    of 64 of them takes 337.5 MiB of device memory at its peak in
    ``analyze_eeg_entropy_files`` on an NVIDIA H100 (``chip_smoke.py``
    phase 34)."""
    return max(1, budget_elems // max(1, per_item_elems))


def analyze_gaze_entropy_files(file_list, *, device: torch.device) -> List[Dict]:
    """Spatial entropy over actual image files (analyze_entropy.py:409-461),
    one record per image.

    The reference loops one image at a time through a NumPy calculator; here
    images are grouped by shape and each group runs as memory-bounded
    batched device calls.  Decoding is streamed: a shape group is flushed to
    the device as soon as it holds one chunk, so host RAM stays ~one chunk
    of decoded pixels per shape (a full 4,463-trial tree of 3000x1583 JPGs
    is ~127 GB decoded, but one 16-image chunk is ~230 MB)."""
    from PIL import Image

    rows = []
    pending: dict = {}  # shape -> [(info, decoded array), ...], <= 1 chunk
    n_shapes: set = set()

    def flush(shape):
        items = pending.pop(shape, [])
        if not items:
            return
        batch = torch.from_numpy(np.stack([a for _, a in items])).to(device)
        ents = spatial_entropy(batch).cpu().numpy()
        for (info, _), ent in zip(items, ents):
            rows.append({"pair_id": info["pair_id"], "player": info["player"],
                         "trial_idx": info["trial_idx"],
                         "condition": info["condition"],
                         "spatial_entropy": float(ent)})

    for info in file_list:
        try:
            with Image.open(info["filepath"]) as im:
                arr = np.asarray(im)
        except Exception as e:  # noqa: BLE001 — an unreadable file is skipped, as in the JAX script
            print(f"[warn] skipping {info['filename']}: {e}")
            continue
        n_shapes.add(arr.shape)
        pending.setdefault(arr.shape, []).append((info, arr))
        if len(pending[arr.shape]) >= _chunk_size(int(np.prod(arr.shape[:2]))):
            flush(arr.shape)
    for shape in list(pending):
        flush(shape)
    print(f"[gaze] spatial entropy for {len(rows)} images "
          f"({len(n_shapes)} shape group(s))")
    return rows


def analyze_eeg_entropy_files(
    file_list, fs: float, filter_low=0.5, filter_high=50.0,
    n_channels: int = 32, *, device: torch.device,
) -> List[Dict]:
    """Spectral entropy over actual EEG CSV trees (analyze_entropy.py:464-535),
    one record per trial.

    CSVs are parsed by the native C++ loader (numpy fallback), grouped by
    (rows, cols) so each uniform-shape group is ONE batched device call (per
    chunk): filtfilt bandpass + Welch PSD + Shannon entropy over trials.
    Files without exactly ``n_channels`` rows are skipped with a warning,
    matching the reference's channel check.
    """
    rows = []
    pending: dict = {}  # (r, c) -> [(info, array), ...], at most one chunk
    n_shapes: set = set()

    def flush(shape):
        items = pending.pop(shape, [])
        if not items:
            return
        ents = spectral_entropy(
            torch.from_numpy(np.stack([a for _, a in items])).to(device),
            fs, filter_low=filter_low, filter_high=filter_high).cpu().numpy()
        for (info, _), ent in zip(items, ents):
            row = {"pair_id": info["pair_id"], "player": info["player"],
                   "trial_idx": info["trial_idx"],
                   "condition": info["condition"],
                   "mean_entropy": float(ent.mean())}
            row.update({name: float(v) for name, v in
                        zip(STANDARD_32_CHANNELS, ent)})
            rows.append(row)

    for info in file_list:
        try:
            arr, r, c = load_csv_f32(info["filepath"], max_rows=n_channels + 8,
                                     max_cols=65536)
        except Exception as e:  # noqa: BLE001 — an unreadable file is skipped, as in the JAX script
            print(f"[warn] skipping {info['filename']}: {e}")
            continue
        if r != n_channels:
            print(f"[warn] {info['filename']} has {r} channels, "
                  f"expected {n_channels} — skipped")
            continue
        n_shapes.add((r, c))
        pending.setdefault((r, c), []).append((info, arr[:r, :c].copy()))
        if len(pending[(r, c)]) >= _chunk_size(r * c):
            flush((r, c))
    for shape in list(pending):
        flush(shape)
    print(f"[eeg] spectral entropy for {len(rows)} trials "
          f"({len(n_shapes)} shape group(s))")
    return rows


def generate_mock_data(n_subjects=5, trials_per_condition=None, seed=42):
    """Per-condition entropy distributions (analyze_entropy.py:296-402 parity):
    Single low, Competition high, Cooperation medium.  Returns the gaze and
    EEG records."""
    if trials_per_condition is None:
        trials_per_condition = {"Single": 40, "Competition": 20, "Cooperation": 20}
    rng = np.random.default_rng(seed)
    gaze_params = {"Single": (4.5, 0.4), "Competition": (5.2, 0.5),
                   "Cooperation": (4.8, 0.3)}
    eeg_params = {"Single": (3.8, 0.3), "Competition": (4.5, 0.4),
                  "Cooperation": (4.1, 0.35)}
    gaze_rows, eeg_rows = [], []
    for s in range(n_subjects):
        pair_id = 12 + s
        for player in ("playerA", "playerB"):
            for cond, n in trials_per_condition.items():
                gm, gs = gaze_params[cond]
                em, es = eeg_params[cond]
                for trial in range(n):
                    gaze_rows.append({
                        "pair_id": pair_id, "player": player, "trial_idx": trial + 1,
                        "condition": cond,
                        "spatial_entropy": float(rng.normal(gm, gs)),
                    })
                    ch = rng.normal(em, es, 32)
                    row = {"pair_id": pair_id, "player": player,
                           "trial_idx": trial + 1, "condition": cond,
                           "mean_entropy": float(ch.mean())}
                    row.update({name: float(v) for name, v in
                                zip(STANDARD_32_CHANNELS, ch)})
                    eeg_rows.append(row)
    return gaze_rows, eeg_rows


def compute_real_entropy(n_trials: int, fs: float, seed: int = 42, *, device: torch.device):
    """Compute entropies from the synthetic signal generators on the device:
    the batched entropy path.  Returns the gaze and EEG columns."""
    gaze = synthetic_gaze_pair_dataset(n=n_trials, H=112, W=112, seed=seed)
    eeg = synthetic_eeg_pair_dataset(n=n_trials, C=32, T=1024, fs=fs, seed=seed)
    g_ent = spatial_entropy(torch.from_numpy(gaze["img1"]).to(device)).cpu().numpy()
    e_ent = spectral_entropy(torch.from_numpy(eeg["eeg1"]).to(device), fs).cpu().numpy()  # (N, C)
    gaze_cols = {
        "pair_id": gaze["pair"], "condition": [CONDITIONS[l] for l in gaze["label"]],
        "spatial_entropy": g_ent,
    }
    eeg_cols = {
        "pair_id": eeg["pair"], "condition": [CONDITIONS[l] for l in eeg["label"]],
        "mean_entropy": e_ent.mean(axis=1),
        **{name: e_ent[:, i] for i, name in enumerate(STANDARD_32_CHANNELS)},
    }
    return gaze_cols, eeg_cols


def n_rows(table: Table) -> int:
    if isinstance(table, Mapping):
        return len(next(iter(table.values()))) if table else 0
    return len(table)


def column(table: Table, name: str) -> np.ndarray:
    """A column of ``table`` as numpy holds it, with the dtype pandas gives
    it: a list of Python floats is float64, a float32 array stays float32."""
    if isinstance(table, Mapping):
        return np.asarray(table[name])
    return np.asarray([row[name] for row in table])


def condition_groups(table: Table, col: str) -> Dict[str, np.ndarray]:
    """``col``'s values per condition present, in CONDITIONS' order."""
    cond, values = column(table, "condition"), column(table, col)
    return {c: values[cond == c] for c in CONDITIONS if (cond == c).any()}


def condition_comparison(table: Table, col: str):
    """Per-condition mean, std and count, and the Welch t-test of each
    pair of conditions: (summary records, test records)."""
    from scipy import stats as sstats

    rows = []
    groups = condition_groups(table, col)
    for c, v in groups.items():
        rows.append({"Condition": c, "Mean": v.mean(), "Std": v.std(),
                     "N": len(v)})
    tests = []
    names = list(groups)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            t, p = sstats.ttest_ind(groups[a], groups[b], equal_var=False)
            tests.append({"A": a, "B": b, "t": t, "p": p})
    return rows, tests


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--output-dir", default="runs/analysis_entropy")
    ap.add_argument("--mock", action="store_true",
                    help="use the mock per-condition distributions")
    ap.add_argument("--gaze-dir", default=None,
                    help="directory of reference-convention gaze JPG/PNGs")
    ap.add_argument("--eeg-dir", default=None,
                    help="directory of reference-convention EEG CSVs")
    ap.add_argument("--trials", type=int, default=30)
    ap.add_argument("--fs", type=float, default=256.0)
    ap.add_argument("--filter-low", type=float, default=0.5)
    ap.add_argument("--filter-high", type=float, default=50.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the CUDA card; 'cpu' must be asked for)")
    return ap.parse_args(argv)


def compute(args, device: torch.device):
    """The numbers: (gaze table, EEG table, {tag: condition_comparison}),
    or None where the directories hold no parseable file."""
    if args.gaze_dir or args.eeg_dir:
        # Real-file path: scan directory trees with the reference's filename
        # conventions and compute entropy from disk, batched on the device.
        gaze = (analyze_gaze_entropy_files(scan_gaze_files(args.gaze_dir), device=device)
                if args.gaze_dir else [])
        eeg = (analyze_eeg_entropy_files(scan_eeg_files(args.eeg_dir), args.fs,
                                         args.filter_low, args.filter_high, device=device)
               if args.eeg_dir else [])
        if not gaze and not eeg:
            return None
    elif args.mock:
        gaze, eeg = generate_mock_data()
    else:
        gaze, eeg = compute_real_entropy(args.trials, args.fs, device=device)
    stats = {tag: condition_comparison(table, col)
             for table, col, tag in ((gaze, "spatial_entropy", "gaze"),
                                     (eeg, "mean_entropy", "eeg")) if n_rows(table)}
    return gaze, eeg, stats


def write(out: Path, gaze: Table, eeg: Table, stats: dict) -> None:
    """The tables and figures, in the JAX script's order."""
    import pandas as pd

    from eyegaze_tpu_torch.analysis.matlab_parity import render_entropy_suite
    from eyegaze_tpu_torch.utils.visualizers import (
        plot_entropy_boxplot,
        plot_entropy_kde,
        plot_entropy_violin,
        plot_topomap,
        setup_academic_style,
    )

    setup_academic_style()
    gaze_df, eeg_df = pd.DataFrame(gaze), pd.DataFrame(eeg)
    gaze_df.to_csv(out / "gaze_entropy_raw.csv", index=False)
    eeg_df.to_csv(out / "eeg_entropy_raw.csv", index=False)

    # Per-pair / per-player summaries (compute_summary_statistics role,
    # analyze_entropy.py:537-585) — only meaningful when those columns exist.
    for df, col, tag in ((gaze_df, "spatial_entropy", "gaze"),
                         (eeg_df, "mean_entropy", "eeg")):
        if not df.empty and {"pair_id", "condition"} <= set(df.columns):
            keys = [k for k in ("pair_id", "player", "condition") if k in df.columns]
            df.groupby(keys)[col].agg(["mean", "std", "count"]).reset_index().to_csv(
                out / f"{tag}_entropy_by_pair.csv", index=False)

    for df, col, tag in ((gaze_df, "spatial_entropy", "gaze"),
                         (eeg_df, "mean_entropy", "eeg")):
        if df.empty:
            continue
        summary, tests = stats[tag]
        pd.DataFrame(summary).to_csv(out / f"{tag}_entropy_summary.csv", index=False)
        pd.DataFrame(tests).to_csv(out / f"{tag}_entropy_tests.csv", index=False)
        by_cond = {c: df.loc[df.condition == c, col].to_numpy()
                   for c in CONDITIONS if (df.condition == c).any()}
        plot_entropy_boxplot(by_cond, out / f"{tag}_entropy_boxplot.png",
                             title=f"{tag} entropy by condition")
        plot_entropy_kde(by_cond, out / f"{tag}_entropy_kde.png",
                         title=f"{tag} entropy distribution")
        plot_entropy_violin(by_cond, out / f"{tag}_entropy_violin.png",
                            title=f"{tag} entropy by condition")

    # EEG per-channel topomap of condition differences.
    ch_cols = [c for c in STANDARD_32_CHANNELS if c in eeg_df.columns]
    if ch_cols:
        coop = eeg_df.loc[eeg_df.condition == "Cooperation", ch_cols].mean()
        comp = eeg_df.loc[eeg_df.condition == "Competition", ch_cols].mean()
        if coop.notna().all() and comp.notna().all():
            plot_topomap((coop - comp).to_numpy(), CHANNEL_POSITIONS_2D, ch_cols,
                         out / "eeg_entropy_topomap_coop_minus_comp.png",
                         title="Spectral entropy: Coop - Comp")

    # MATLAB-suite figures from the raw CSVs (analyze_gaze.m fig_* set +
    # analyze_eeg.m's entropy trio) — native, analysis/matlab_parity.py.
    rendered = render_entropy_suite(out, out / "figures",
                                    positions=CHANNEL_POSITIONS_2D)
    for name in rendered:
        print(f"[analyze_entropy] figure: {name}")


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device, "eyegaze_tpu_torch.analyze_entropy")
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        numbers = compute(args, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    if numbers is None:
        print("[analyze_entropy] no parseable files found")
        return 1
    write(out, *numbers)
    print(f"[analyze_entropy] done -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
