"""Native renderings of the reference MATLAB figure suites.

The port's copy of ``eyegaze_tpu/analysis/matlab_parity.py``.  The
reference ships three MATLAB analyzers that consume the CSV tree the Python
analysis pipeline writes (``python -m eyegaze_tpu_torch.analyze_eeg`` here,
``6_Utils/io_utils.py`` there) and render publication figures:

- ``7_Analysis/matlab_scripts/analyze_ibs_connectivity.m`` (639 lines):
  3-class connectivity heatmaps, coop-comp difference map, circular
  connectivity graph, ROI statistics, multi-band comparison, summary panel.
- ``7_Analysis/matlab_scripts/analyze_attention_weights.m`` (674 lines):
  cross-attention heatmap with token-region boundaries, diagonal (time-sync)
  profile, class comparison, time-lag analysis, value distribution, summary.
- ``7_Analysis/matlab_scripts/analyze_gradcam.m`` (655 lines): 3-class
  time-frequency heatmaps, pairwise difference maps, frequency/temporal
  profiles, per-band statistics, 3D surface, summary.

This module renders the SAME figures (same output filenames, same derived
CSV exports, same statistical content) natively in matplotlib from the SAME
input CSV tree, so the repo needs no MATLAB license to complete the analysis
story.  The arithmetic and the plotting bodies are the JAX package's, so the
same inputs give the same CSV bytes and the same pixels.

Host-side NumPy/pandas/matplotlib, no device work.  pandas and matplotlib
are imported at the first call that reaches them (``utils/lazy``), so the
module imports where they are not installed; ``_movmean`` and
``_find_peaks`` need neither.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from eyegaze_tpu_torch.utils.lazy import LazyImport, use_agg

plt = LazyImport("matplotlib.pyplot", setup=use_agg)
pd = LazyImport("pandas")
LinearSegmentedColormap = LazyImport("matplotlib.colors", "LinearSegmentedColormap",
                                     setup=use_agg)

PathLike = str

CLASSES = ("Single", "Competition", "Cooperation")
# The MATLAB suite's project palette (analyze_ibs_connectivity.m:48-50) —
# kept exactly so native and MATLAB renders are visually comparable.
CLASS_COLORS = np.array([
    [0.55, 0.63, 0.80],   # Single - blue
    [0.99, 0.55, 0.38],   # Competition - orange
    [0.40, 0.76, 0.65],   # Cooperation - green
])

BANDS_6 = ("broadband", "delta", "theta", "alpha", "beta", "gamma")
FEATURES_7 = ("PLV", "PLI", "wPLI", "Coherence", "Power_Corr", "Phase_Diff",
              "Time_Corr")

# 10-20 ROI groupings (analyze_ibs_connectivity.m:72-80).
ROI_NAMES = ("Frontal", "Central", "Parietal", "Occipital", "Temporal")
ROI_CHANNELS = {
    "Frontal": ("Fp1", "FP2", "Fz", "F3", "F4", "F7", "F8",
                "FC1", "FC2", "FC5", "FC6"),
    "Central": ("C3", "C4", "CZ", "CP1", "CP2", "CP5", "CP6"),
    "Parietal": ("PZ", "P3", "P4", "P7", "P8"),
    "Occipital": ("O1", "O2", "OZ"),
    "Temporal": ("T7", "T8", "TP9", "TP10", "FT9", "FT10"),
}

# Grad-CAM band definitions in Hz (analyze_gradcam.m:63-75).
GRADCAM_BANDS = (
    ("Delta", 0.5, 4.0, (0.6, 0.2, 0.8)),
    ("Theta", 4.0, 8.0, (0.2, 0.6, 0.8)),
    ("Alpha", 8.0, 13.0, (0.2, 0.8, 0.2)),
    ("Beta", 13.0, 30.0, (0.8, 0.8, 0.2)),
    ("Gamma", 30.0, 45.0, (0.8, 0.4, 0.2)),
)

# DualEEG 139-token sequence structure (analyze_attention_weights.m:46-70;
# 0-indexed here): CLS | 42 IBS | 32 spectrogram | 64 temporal.
SEQ_IBS_END = 43      # first index AFTER the IBS block (CLS + 42)
SEQ_SPEC_END = 75     # first index AFTER the spectrogram block
TEMPORAL_MS_PER_TOKEN = 16 / 256 * 1000  # 2x stride-4 conv: 16 samples/token


def _diverging_cmap() -> LinearSegmentedColormap:
    """Blue-white-red map built exactly like the MATLAB suite's
    (analyze_ibs_connectivity.m:158-162)."""
    half = 128
    blue_to_white = np.stack([np.linspace(0.2, 1, half),
                              np.linspace(0.4, 1, half),
                              np.linspace(0.8, 1, half)], axis=1)
    white_to_red = np.stack([np.linspace(1, 0.9, half),
                             np.linspace(1, 0.3, half),
                             np.linspace(1, 0.3, half)], axis=1)
    return LinearSegmentedColormap.from_list(
        "matlab_diverging", np.concatenate([blue_to_white, white_to_red]))


def _movmean(x: np.ndarray, w: int) -> np.ndarray:
    """MATLAB ``movmean``: centered moving average with shrinking windows at
    the edges (not zero-padded)."""
    x = np.asarray(x, dtype=np.float64)
    csum = np.cumsum(np.concatenate([[0.0], x]))
    n = len(x)
    half_lo, half_hi = (w - 1) // 2, w // 2
    lo = np.clip(np.arange(n) - half_lo, 0, n)
    hi = np.clip(np.arange(n) + half_hi + 1, 0, n)
    return (csum[hi] - csum[lo]) / (hi - lo)


def _find_peaks(x: np.ndarray, min_prominence: float) -> np.ndarray:
    """Indices of local maxima with at least ``min_prominence`` (MATLAB
    ``findpeaks(...,'MinPeakProminence',p)`` role, via scipy)."""
    from scipy.signal import find_peaks

    idx, _ = find_peaks(np.asarray(x, np.float64), prominence=min_prominence)
    return idx


def _read_matrix(path: Path) -> Optional[np.ndarray]:
    if not path.exists():
        return None
    return np.loadtxt(path, delimiter=",", dtype=np.float64)


def _headless_fig(size: Tuple[float, float]):
    return plt.figure(figsize=size, facecolor="white")


def _save(fig, path: Path) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, bbox_inches="tight", dpi=150)
    plt.close(fig)
    return path


# ---------------------------------------------------------------------------
# IBS connectivity suite (analyze_ibs_connectivity.m)
# ---------------------------------------------------------------------------

def _load_channel_names(data_dir: Path) -> List[str]:
    f = data_dir / "channel_names.csv"
    if f.exists():
        return list(pd.read_csv(f)["Channel_Name"].astype(str))
    # Default 32-channel montage (analyze_ibs_connectivity.m:61-66).
    return ["Fp1", "Fz", "F3", "F7", "FT9", "FC5", "FC1", "C3",
            "T7", "TP9", "CP5", "CP1", "PZ", "P3", "P7", "O1",
            "OZ", "O2", "P4", "P8", "TP10", "CP6", "CP2", "CZ",
            "C4", "T8", "FT10", "FC6", "FC2", "F4", "F8", "FP2"]


def _circular_layout(n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    theta = np.linspace(0, 2 * np.pi, n + 1)[:-1]
    return np.cos(theta), np.sin(theta), theta


def _draw_circular_graph(ax, mat: np.ndarray, color: np.ndarray,
                         channel_names: Sequence[str],
                         threshold_pct: float, labels: bool = True) -> None:
    """One circular connectivity panel (analyze_ibs_connectivity.m:207-263):
    nodes on a unit circle, edges for entries above the given percentile,
    width/alpha scaled by how far above threshold the weight sits."""
    n = mat.shape[0]
    x, y, theta = _circular_layout(n)
    thr = np.percentile(mat, threshold_pct)
    span = mat.max() - thr
    rows, cols = np.where(mat > thr)
    for i, j in zip(rows, cols):
        if i == j:
            continue
        w = (mat[i, j] - thr) / span if span > 0 else 1.0
        ax.plot([x[i], x[j]], [y[i], y[j]],
                color=tuple(color), alpha=0.3 + 0.5 * w,
                linewidth=0.5 + 2.0 * w, zorder=1)
    ax.scatter(x, y, s=60, c=[tuple(color)], edgecolors="k",
               linewidths=0.8, zorder=2)
    if labels:
        for i, ch in enumerate(channel_names[:n]):
            ax.text(1.15 * x[i], 1.15 * y[i], ch, ha="center", va="center",
                    fontsize=6, rotation=np.degrees(theta[i]) - 90)
    ax.set_xlim(-1.5, 1.5)
    ax.set_ylim(-1.5, 1.5)
    ax.set_aspect("equal")
    ax.axis("off")


def render_ibs_suite(result_dir: PathLike, output_dir: PathLike,
                     key_band: str = "theta", key_feature: str = "PLV",
                     classes: Sequence[str] = CLASSES,
                     bands: Sequence[str] = BANDS_6) -> Dict[str, Path]:
    """Render the full ``analyze_ibs_connectivity.m`` figure suite from an
    ``analyze_eeg.py`` output tree.  Returns {artifact_name: path}."""
    data_dir = Path(result_dir) / "ibs_connectivity"
    mean_dir = data_dir / "ibs_mean_by_class"
    diff_dir = data_dir / "ibs_difference_coop_vs_comp"
    out = Path(output_dir)
    produced: Dict[str, Path] = {}

    channel_names = _load_channel_names(data_dir)
    matrices = []
    for cname in classes:
        m = _read_matrix(mean_dir / f"{cname}_{key_band}_{key_feature}.csv")
        if m is None:
            raise FileNotFoundError(
                f"missing IBS matrix {cname}_{key_band}_{key_feature}.csv "
                f"under {mean_dir}")
        matrices.append(m)
    n_ch = matrices[0].shape[0]
    all_vals = np.concatenate([m.ravel() for m in matrices])
    clim = (np.percentile(all_vals, 5), np.percentile(all_vals, 95))
    diff_matrix = _read_matrix(diff_dir / f"diff_{key_band}_{key_feature}.csv")
    div_cmap = _diverging_cmap()

    # --- 1. three-class heatmaps (m:91-146) ---
    fig, axes = plt.subplots(1, 3, figsize=(14, 4.2), facecolor="white")
    for i, (ax, cname) in enumerate(zip(axes, classes)):
        im = ax.imshow(matrices[i], cmap="viridis", vmin=clim[0], vmax=clim[1])
        ax.set_title(cname, color=CLASS_COLORS[i], fontweight="bold")
        ax.set_xlabel("Brain 2 Channels")
        ax.set_ylabel("Brain 1 Channels")
        ticks = np.arange(0, n_ch, 4)
        ax.set_xticks(ticks, [channel_names[t] for t in ticks],
                      rotation=45, fontsize=6)
        ax.set_yticks(ticks, [channel_names[t] for t in ticks], fontsize=6)
        fig.colorbar(im, ax=ax, fraction=0.046)
    fig.suptitle(f"Inter-Brain {key_feature} Connectivity ({key_band} band)",
                 fontsize=14, fontweight="bold")
    produced["ibs_heatmap_3classes.png"] = _save(
        fig, out / "ibs_heatmap_3classes.png")

    # --- 2. difference heatmap, symmetric diverging clim (m:148-196) ---
    if diff_matrix is not None:
        fig = _headless_fig((7, 6))
        ax = fig.add_subplot(111)
        max_abs = np.abs(diff_matrix).max()
        im = ax.imshow(diff_matrix, cmap=div_cmap, vmin=-max_abs, vmax=max_abs)
        fig.colorbar(im, ax=ax)
        ax.set_title(f"Cooperation - Competition ({key_band} {key_feature})",
                     fontsize=13, fontweight="bold")
        ax.set_xlabel("Brain 2 Channels")
        ax.set_ylabel("Brain 1 Channels")
        ax.set_xticks(range(n_ch), channel_names[:n_ch], rotation=90, fontsize=5)
        ax.set_yticks(range(n_ch), channel_names[:n_ch], fontsize=5)
        ax.text(0.02, 0.98, "Red: Coop > Comp\nBlue: Comp > Coop",
                transform=ax.transAxes, va="top", fontsize=9,
                bbox=dict(facecolor="w", edgecolor="0.7"))
        produced["ibs_diff_heatmap.png"] = _save(fig, out / "ibs_diff_heatmap.png")

    # --- 3. circular connectivity graph, top 5% edges (m:198-272) ---
    fig, axes = plt.subplots(1, 3, figsize=(15, 5), facecolor="white")
    for i, (ax, cname) in enumerate(zip(axes, classes)):
        _draw_circular_graph(ax, matrices[i], CLASS_COLORS[i], channel_names,
                             threshold_pct=95.0)
        ax.set_title(cname, color=CLASS_COLORS[i], fontsize=13,
                     fontweight="bold")
    fig.suptitle(f"Inter-Brain Connectivity Graph ({key_band} {key_feature}, "
                 "top 5%)", fontsize=15, fontweight="bold")
    produced["ibs_circular_graph.png"] = _save(fig, out / "ibs_circular_graph.png")

    # --- 4. ROI analysis (m:274-368) ---
    roi_idx = {
        roi: [i for i, ch in enumerate(channel_names[:n_ch])
              if any(ch.lower() == r.lower() for r in ROI_CHANNELS[roi])]
        for roi in ROI_NAMES
    }
    n_roi = len(ROI_NAMES)
    roi_conn = np.zeros((n_roi, n_roi, 3))
    for ci, mat in enumerate(matrices):
        for a, ra in enumerate(ROI_NAMES):
            for b, rb in enumerate(ROI_NAMES):
                ia, ib = roi_idx[ra], roi_idx[rb]
                if ia and ib:
                    roi_conn[a, b, ci] = mat[np.ix_(ia, ib)].mean()
    same_region = np.stack([np.diag(roi_conn[:, :, ci]) for ci in range(3)])

    fig = _headless_fig((12, 8))
    for ci, cname in enumerate(classes):
        ax = fig.add_subplot(2, 3, ci + 1)
        im = ax.imshow(roi_conn[:, :, ci], cmap="viridis")
        fig.colorbar(im, ax=ax, fraction=0.046)
        ax.set_title(cname, color=CLASS_COLORS[ci], fontweight="bold")
        ax.set_xticks(range(n_roi), ROI_NAMES, rotation=45, fontsize=7)
        ax.set_yticks(range(n_roi), ROI_NAMES, fontsize=7)
        ax.set_xlabel("Brain 2 ROI")
        ax.set_ylabel("Brain 1 ROI")
    ax = fig.add_subplot(2, 1, 2)
    width = 0.25
    xs = np.arange(n_roi)
    for ci, cname in enumerate(classes):
        ax.bar(xs + (ci - 1) * width, same_region[ci], width,
               color=CLASS_COLORS[ci], label=cname)
    ax.set_xticks(xs, ROI_NAMES)
    ax.set_xlabel("Brain Region")
    ax.set_ylabel(f"Mean {key_feature}")
    ax.set_title("Same-Region Inter-Brain Connectivity by Class",
                 fontsize=13, fontweight="bold")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.suptitle(f"ROI-based Inter-Brain Synchrony Analysis "
                 f"({key_band} {key_feature})", fontsize=15, fontweight="bold")
    produced["ibs_roi_analysis.png"] = _save(fig, out / "ibs_roi_analysis.png")
    roi_df = pd.DataFrame(same_region, index=list(classes), columns=ROI_NAMES)
    roi_df.index.name = "Row"
    roi_df.to_csv(out / "ibs_roi_stats.csv")
    produced["ibs_roi_stats.csv"] = out / "ibs_roi_stats.csv"

    # --- 5. multi-band comparison (m:370-487) ---
    n_bands = len(bands)
    band_means = np.zeros((n_bands, 3))
    for bi, band in enumerate(bands):
        for ci, cname in enumerate(classes):
            m = _read_matrix(mean_dir / f"{cname}_{band}_{key_feature}.csv")
            if m is not None:
                band_means[bi, ci] = m.mean()
    diff_by_band = band_means[:, 2] - band_means[:, 1]  # Coop - Comp

    fig = _headless_fig((13, 9))
    ax = fig.add_subplot(2, 2, 1)
    width = 0.25
    xs = np.arange(n_bands)
    for ci, cname in enumerate(classes):
        ax.bar(xs + (ci - 1) * width, band_means[:, ci], width,
               color=CLASS_COLORS[ci], label=cname)
    ax.set_xticks(xs, bands, rotation=45)
    ax.set_xlabel("Frequency Band")
    ax.set_ylabel(f"Mean {key_feature}")
    ax.set_title("Mean Inter-Brain Connectivity by Frequency Band",
                 fontweight="bold")
    ax.legend()
    ax.grid(alpha=0.3)

    ax = fig.add_subplot(2, 2, 2)
    for ci, cname in enumerate(classes):
        ax.plot(xs, band_means[:, ci], "-o", color=CLASS_COLORS[ci],
                linewidth=2, markersize=7, label=cname)
    ax.set_xticks(xs, bands, rotation=45)
    ax.set_xlabel("Frequency Band")
    ax.set_ylabel(f"Mean {key_feature}")
    ax.set_title("Frequency Band Profile by Class", fontweight="bold")
    ax.legend()
    ax.grid(alpha=0.3)

    ax = fig.add_subplot(2, 2, 3)
    colors = [CLASS_COLORS[2] if d > 0 else CLASS_COLORS[1]
              for d in diff_by_band]
    ax.bar(xs, diff_by_band, color=colors)
    ax.axhline(0.0, linestyle="--", color="k", linewidth=1)
    ax.set_xticks(xs, bands, rotation=45)
    ax.set_xlabel("Frequency Band")
    ax.set_ylabel(f"Δ {key_feature} (Coop - Comp)")
    ax.set_title("Cooperation vs Competition Difference by Band",
                 fontweight="bold")
    ax.grid(alpha=0.3)

    ax = fig.add_subplot(2, 2, 4)
    im = ax.imshow(band_means, cmap="viridis", aspect="auto")
    fig.colorbar(im, ax=ax)
    ax.set_xticks(range(3), classes)
    ax.set_yticks(range(n_bands), bands)
    ax.set_xlabel("Class")
    ax.set_ylabel("Frequency Band")
    ax.set_title(f"Mean {key_feature} Heatmap (Band x Class)",
                 fontweight="bold")
    for bi in range(n_bands):
        for ci in range(3):
            ax.text(ci, bi, f"{band_means[bi, ci]:.3f}", ha="center",
                    va="center", color="w", fontsize=8, fontweight="bold")
    fig.suptitle(f"Multi-band Inter-Brain Synchrony Comparison "
                 f"({key_feature})", fontsize=15, fontweight="bold")
    produced["ibs_multiband_comparison.png"] = _save(
        fig, out / "ibs_multiband_comparison.png")
    band_df = pd.DataFrame(band_means, index=list(bands),
                           columns=list(classes))
    band_df.index.name = "Row"
    band_df.to_csv(out / "ibs_band_stats.csv")
    produced["ibs_band_stats.csv"] = out / "ibs_band_stats.csv"

    # --- 6. summary panel (m:489-621) ---
    fig = _headless_fig((16, 10))
    for ci, cname in enumerate(classes):
        ax = fig.add_subplot(3, 4, ci + 1)
        im = ax.imshow(matrices[ci], cmap="viridis",
                       vmin=clim[0], vmax=clim[1])
        ax.set_title(cname, color=CLASS_COLORS[ci], fontsize=10,
                     fontweight="bold")
        ax.set_xticks([])
        ax.set_yticks([])
        if ci == 2:
            fig.colorbar(im, ax=ax, fraction=0.046, label=key_feature)
    if diff_matrix is not None:
        ax = fig.add_subplot(3, 4, 4)
        max_abs = np.abs(diff_matrix).max()
        im = ax.imshow(diff_matrix, cmap=div_cmap, vmin=-max_abs, vmax=max_abs)
        ax.set_title("Coop - Comp", fontsize=10, fontweight="bold")
        ax.set_xticks([])
        ax.set_yticks([])
        fig.colorbar(im, ax=ax, fraction=0.046)
    ax = fig.add_subplot(3, 4, (5, 6))
    xs = np.arange(n_roi)
    for ci, cname in enumerate(classes):
        ax.bar(xs + (ci - 1) * 0.25, same_region[ci], 0.25,
               color=CLASS_COLORS[ci], label=cname)
    ax.set_xticks(xs, ROI_NAMES, rotation=30, fontsize=8)
    ax.set_ylabel(f"Mean {key_feature}")
    ax.set_title("ROI-based Connectivity", fontweight="bold")
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)
    ax = fig.add_subplot(3, 4, (7, 8))
    bx = np.arange(n_bands)
    for ci, cname in enumerate(classes):
        ax.plot(bx, band_means[:, ci], "-o", color=CLASS_COLORS[ci],
                linewidth=2, markersize=5, label=cname)
    ax.set_xticks(bx, bands, rotation=30, fontsize=8)
    ax.set_ylabel(f"Mean {key_feature}")
    ax.set_title("Frequency Band Profile", fontweight="bold")
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)
    for ci, cname in enumerate(classes):
        ax = fig.add_subplot(3, 4, 9 + ci)
        _draw_circular_graph(ax, matrices[ci], CLASS_COLORS[ci],
                             channel_names, threshold_pct=97.0, labels=False)
        ax.set_title(cname, color=CLASS_COLORS[ci], fontsize=9)
    ax = fig.add_subplot(3, 4, 12)
    ax.axis("off")
    max_roi = int(np.argmax(np.abs(same_region[2] - same_region[1])))
    max_band = int(np.argmax(np.abs(diff_by_band)))
    lines = [
        "=== Key Findings ===", "",
        f"Band: {key_band}", f"Feature: {key_feature}", "",
        "--- Global Mean ---",
        *(f"  {c}: {m.mean():.4f}" for c, m in zip(classes, matrices)), "",
        "--- Largest ROI Diff ---",
        f"  {ROI_NAMES[max_roi]}: "
        f"{same_region[2, max_roi] - same_region[1, max_roi]:.4f}", "",
        "--- Largest Band Diff ---",
        f"  {bands[max_band]}: {diff_by_band[max_band]:.4f}",
    ]
    ax.text(0.05, 0.95, "\n".join(lines), transform=ax.transAxes, va="top",
            fontsize=9, family="monospace")
    fig.suptitle(f"Inter-Brain Synchrony Analysis Summary "
                 f"({key_band} {key_feature})", fontsize=15, fontweight="bold")
    produced["ibs_summary.png"] = _save(fig, out / "ibs_summary.png")
    return produced


# ---------------------------------------------------------------------------
# Cross-attention suite (analyze_attention_weights.m)
# ---------------------------------------------------------------------------

def _load_attention_inputs(result_dir: Path):
    """Mean attention matrix + per-class diagonal summary.

    Accepts both this repo's export names (``mean_attention.csv`` /
    ``attention_summary.csv`` with a ``Mean_Diagonal`` column — the schema
    the reference's own ``io_utils.py:237`` writes) and the names the
    MATLAB script reads (``mean_attention_map.csv`` /
    ``attention_diagonal_summary.csv`` with ``Mean_Diagonal_Value``); the
    reference's two sides disagree, so its summary branch degrades
    gracefully — ours does too (summary=None)."""
    d = result_dir / "attention_weights"
    mat = None
    for name in ("mean_attention.csv", "mean_attention_map.csv"):
        mat = _read_matrix(d / name)
        if mat is not None:
            break
    if mat is None:
        raise FileNotFoundError(f"no mean attention matrix under {d}")
    summary = None
    for name, col in (("attention_summary.csv", "Mean_Diagonal"),
                      ("attention_diagonal_summary.csv",
                       "Mean_Diagonal_Value")):
        f = d / name
        if f.exists():
            df = pd.read_csv(f)
            if col in df.columns and "Class" in df.columns:
                summary = df.set_index("Class")[col]
                break
    return mat, summary


def render_attention_suite(result_dir: PathLike, output_dir: PathLike,
                           classes: Sequence[str] = CLASSES
                           ) -> Dict[str, Path]:
    """Render the full ``analyze_attention_weights.m`` figure suite."""
    res = Path(result_dir)
    out = Path(output_dir)
    produced: Dict[str, Path] = {}
    attn, summary = _load_attention_inputs(res)
    seq_len = attn.shape[0]
    diag = np.diag(attn)
    diag_smooth = _movmean(diag, 5)
    off_mask = ~np.eye(seq_len, dtype=bool)
    off_vals = attn[off_mask]
    region_bounds = (min(SEQ_IBS_END, seq_len), min(SEQ_SPEC_END, seq_len))

    # --- 1. heatmap with diagonal + token-boundary guides (m:116-163) ---
    fig = _headless_fig((7.5, 6.5))
    ax = fig.add_subplot(111)
    im = ax.imshow(attn, cmap="hot")
    fig.colorbar(im, ax=ax)
    ax.plot([0, seq_len - 1], [0, seq_len - 1], "c--", linewidth=2)
    for b in region_bounds:
        ax.axvline(b - 0.5, linestyle="--", color=(0.3, 0.8, 0.3),
                   linewidth=1.5)
        ax.axhline(b - 0.5, linestyle="--", color=(0.3, 0.8, 0.3),
                   linewidth=1.5)
    ax.set_title("Cross-Attention Map (Brain 1 → Brain 2)",
                 fontsize=13, fontweight="bold")
    ax.set_xlabel("Brain 2 Sequence Position (Key)")
    ax.set_ylabel("Brain 1 Sequence Position (Query)")
    ax.text(0.02, 0.98, "Cyan = Diagonal (time-sync)\n"
            "Green = Token boundaries", transform=ax.transAxes, va="top",
            fontsize=8, color="c")
    for label, lo, hi in (("IBS", 0, region_bounds[0]),
                          ("Spec", *region_bounds),
                          ("Temporal", region_bounds[1], seq_len)):
        ax.text((lo + hi) / 2, -4, label, ha="center", fontsize=9)
    produced["attention_heatmap.png"] = _save(fig, out / "attention_heatmap.png")

    # --- 2. diagonal profile, region-shaded + peak panel (m:165-283) ---
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 7), facecolor="white")
    t = np.arange(seq_len)
    y_lo, y_hi = diag.min() * 0.9, diag.max() * 1.1
    for (lo, hi), col in zip(
            ((0, region_bounds[0]), region_bounds,
             (region_bounds[1], seq_len)),
            ((0.8, 0.9, 1.0), (0.8, 1.0, 0.8), (1.0, 0.9, 0.8))):
        ax1.axvspan(lo, hi, color=col, alpha=0.5)
    ax1.plot(t, diag, color="0.5", linewidth=0.6, label="Raw")
    ax1.plot(t, diag_smooth, color=(0.2, 0.4, 0.8), linewidth=2,
             label="Smoothed")
    for label, lo, hi in (("IBS", 0, region_bounds[0]),
                          ("Spec", *region_bounds),
                          ("Temporal", region_bounds[1], seq_len)):
        ax1.text((lo + hi) / 2, y_hi * 0.98, label, ha="center",
                 fontweight="bold", fontsize=10)
    ax1.set_xlim(0, seq_len - 1)
    ax1.set_ylim(y_lo, y_hi)
    ax1.set_xlabel("Sequence Position")
    ax1.set_ylabel("Attention Weight")
    ax1.set_title("Diagonal Attention Profile by Token Type",
                  fontweight="bold")
    ax1.legend(fontsize=8)
    ax1.grid(alpha=0.3)

    peaks = _find_peaks(diag_smooth, 0.0005)
    for b in region_bounds:
        ax2.axvline(b, linestyle="--", color="0.6")
    ax2.plot(t, diag_smooth, color=(0.2, 0.4, 0.8), linewidth=2)
    if len(peaks):
        ax2.plot(peaks, diag_smooth[peaks], "rv", markersize=8)
        for p in peaks:
            if p >= region_bounds[1]:
                tok = p - region_bounds[1]
                ax2.annotate(f"T{tok}\n({tok * TEMPORAL_MS_PER_TOKEN:.0f}ms)",
                             (p, diag_smooth[p]), textcoords="offset points",
                             xytext=(0, 6), ha="center", fontsize=7)
    ax2.axhline(diag.mean(), linestyle="--", color="k",
                label=f"Mean = {diag.mean():.4f}")
    ax2.set_xlim(0, seq_len - 1)
    ax2.set_xlabel("Sequence Position")
    ax2.set_ylabel("Attention Weight")
    ax2.set_title("Diagonal Profile with Peaks "
                  "(Temporal region = original time)", fontweight="bold")
    ax2.legend(fontsize=8)
    ax2.grid(alpha=0.3)
    fig.tight_layout()
    produced["attention_diagonal_profile.png"] = _save(
        fig, out / "attention_diagonal_profile.png")

    # --- 3. class comparison from the diagonal summary (m:285-348) ---
    fig = _headless_fig((6.5, 5))
    ax = fig.add_subplot(111)
    if summary is not None:
        vals = [float(summary.get(c, np.nan)) for c in classes]
        ax.bar(range(3), vals, color=[tuple(c) for c in CLASS_COLORS])
        for i, v in enumerate(vals):
            ax.text(i, v, f"{v:.4f}", ha="center", va="bottom", fontsize=9)
        ax.set_xticks(range(3), classes)
        ax.set_xlabel("Condition")
        ax.set_ylabel("Mean Diagonal Attention")
        ax.set_title("Time-Synchronized Attention by Class",
                     fontsize=13, fontweight="bold")
        ax.grid(alpha=0.3)
        order = np.argsort(vals)
        ax.text(0.02, 0.95, f"Highest: {classes[order[-1]]}\n"
                f"Lowest: {classes[order[0]]}", transform=ax.transAxes,
                va="top", fontsize=9,
                bbox=dict(facecolor="w", edgecolor="0.7"))
    else:
        ax.text(0.5, 0.5, "Summary data not available", ha="center")
        ax.axis("off")
    produced["attention_class_comparison.png"] = _save(
        fig, out / "attention_class_comparison.png")

    # --- 4. time-lag analysis (m:350-449) ---
    max_lag = min(50, seq_len // 2)
    lags = np.arange(-max_lag, max_lag + 1)
    lag_means = np.array([np.diag(attn, k).mean() for k in lags])
    zero_idx = max_lag
    pos_mean = lag_means[lags > 0].mean()
    neg_mean = lag_means[lags < 0].mean()
    zero_mean = lag_means[zero_idx]

    fig = _headless_fig((11, 8))
    ax = fig.add_subplot(2, 1, 1)
    ax.bar(lags, lag_means, color=(0.55, 0.63, 0.80))
    ax.bar([0], [zero_mean], color=(0.99, 0.55, 0.38))
    ax.axvline(0, linestyle="--", color="r", linewidth=1.5)
    ax.set_xlabel("Time Lag (Brain 2 - Brain 1)")
    ax.set_ylabel("Mean Attention Weight")
    ax.set_title("Cross-Attention by Time Lag", fontweight="bold")
    ax.text(-max_lag * 0.9, lag_means.max() * 0.95,
            "Negative lag: B1 attends to B2's future", fontsize=8,
            color="0.3")
    ax.text(max_lag * 0.3, lag_means.max() * 0.95,
            "Positive lag: B1 attends to B2's past", fontsize=8, color="0.3")
    ax.grid(alpha=0.3)
    ax = fig.add_subplot(2, 2, 3)
    asym = [neg_mean, zero_mean, pos_mean]
    ax.bar(range(3), asym,
           color=[(0.4, 0.76, 0.65), (0.99, 0.55, 0.38), (0.55, 0.63, 0.80)])
    ax.set_xticks(range(3), ["Past (lag<0)", "Sync (lag=0)", "Future (lag>0)"])
    for i, v in enumerate(asym):
        ax.text(i, v, f"{v:.4f}", ha="center", va="bottom", fontsize=8)
    ax.set_ylabel("Mean Attention")
    ax.set_title("Temporal Asymmetry", fontweight="bold")
    ax.grid(alpha=0.3)
    ax = fig.add_subplot(2, 2, 4)
    c0 = seq_len // 2
    zoom = slice(max(0, c0 - 30), min(seq_len, c0 + 31))
    im = ax.imshow(attn[zoom, zoom], cmap="hot")
    fig.colorbar(im, ax=ax, fraction=0.046)
    n_zoom = attn[zoom, zoom].shape[0]
    ax.plot([0, n_zoom - 1], [0, n_zoom - 1], "c--", linewidth=1.5)
    ax.set_title("Zoomed Center Region", fontweight="bold")
    ax.set_xlabel("Brain 2 Time")
    ax.set_ylabel("Brain 1 Time")
    fig.suptitle("Time-Lag Analysis of Cross-Attention", fontsize=14,
                 fontweight="bold")
    produced["attention_timelag_analysis.png"] = _save(
        fig, out / "attention_timelag_analysis.png")

    # --- 5. distribution histogram + box (m:451-511) ---
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 5), facecolor="white")
    ax1.hist(attn.ravel(), bins=50, color="0.7", alpha=0.5, density=False,
             weights=np.full(attn.size, 1.0 / attn.size),
             label="All values")
    ax1.hist(diag, bins=30, color=(0.99, 0.55, 0.38), alpha=0.7,
             weights=np.full(diag.size, 1.0 / diag.size),
             label="Diagonal (sync)")
    ax1.set_xlabel("Attention Weight")
    ax1.set_ylabel("Probability")
    ax1.set_title("Attention Value Distribution", fontweight="bold")
    ax1.legend(fontsize=8)
    ax1.grid(alpha=0.3)
    ax2.boxplot([diag, off_vals[:1000]], tick_labels=["Diagonal",
                                                      "Off-diagonal"])
    ax2.set_ylabel("Attention Weight")
    ax2.set_title("Diagonal vs Off-diagonal Comparison", fontweight="bold")
    ax2.grid(alpha=0.3)
    stats = (f"All: mean={attn.mean():.4f}, std={attn.std():.4f}\n"
             f"Diag: mean={diag.mean():.4f}, std={diag.std():.4f}\n"
             f"Off-diag: mean={off_vals.mean():.4f}, "
             f"std={off_vals.std():.4f}")
    ax2.text(0.05, 0.02, stats, transform=ax2.transAxes, fontsize=8,
             bbox=dict(facecolor="w", edgecolor="0.7"))
    fig.tight_layout()
    produced["attention_distribution.png"] = _save(
        fig, out / "attention_distribution.png")

    # --- 6. publication summary panel (m:513-626) ---
    fig = _headless_fig((14, 9))
    ax = fig.add_subplot(2, 3, 1)
    im = ax.imshow(attn, cmap="hot")
    fig.colorbar(im, ax=ax, fraction=0.046)
    ax.plot([0, seq_len - 1], [0, seq_len - 1], "c--", linewidth=1.5)
    ax.set_title("(A) Attention Matrix", fontweight="bold")
    ax.set_xlabel("Brain 2 Time")
    ax.set_ylabel("Brain 1 Time")
    ax = fig.add_subplot(2, 3, 2)
    ax.plot(t, diag_smooth, color=(0.2, 0.4, 0.8), linewidth=1.5)
    ax.axhline(diag.mean(), linestyle="--", color="k")
    ax.set_xlim(0, seq_len - 1)
    ax.set_xlabel("Time Step")
    ax.set_ylabel("Attention")
    ax.set_title("(B) Diagonal Profile", fontweight="bold")
    ax.grid(alpha=0.3)
    ax = fig.add_subplot(2, 3, 3)
    if summary is not None:
        vals = [float(summary.get(c, np.nan)) for c in classes]
        ax.bar(range(3), vals, color=[tuple(c) for c in CLASS_COLORS])
        ax.set_xticks(range(3), classes, fontsize=8)
        ax.set_ylabel("Mean Diagonal Attn")
        ax.grid(alpha=0.3)
    ax.set_title("(C) Class Comparison", fontweight="bold")
    ax = fig.add_subplot(2, 3, 4)
    ax.bar(lags, lag_means, color=(0.55, 0.63, 0.80))
    ax.bar([0], [zero_mean], color=(0.99, 0.55, 0.38))
    ax.axvline(0, linestyle="--", color="r")
    ax.set_xlabel("Time Lag")
    ax.set_ylabel("Mean Attention")
    ax.set_title("(D) Time-Lag Analysis", fontweight="bold")
    ax.grid(alpha=0.3)
    ax = fig.add_subplot(2, 3, 5)
    ax.hist(attn.ravel(), bins=40, color="0.7", alpha=0.5,
            weights=np.full(attn.size, 1.0 / attn.size), label="All")
    ax.hist(diag, bins=25, color=(0.99, 0.55, 0.38), alpha=0.7,
            weights=np.full(diag.size, 1.0 / diag.size), label="Diagonal")
    ax.set_xlabel("Attention Weight")
    ax.set_ylabel("Probability")
    ax.set_title("(E) Distribution", fontweight="bold")
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)
    ax = fig.add_subplot(2, 3, 6)
    ax.axis("off")
    ratio = diag.mean() / off_vals.mean()
    peak_time = int(np.argmax(diag_smooth))
    lines = [
        "=== Key Statistics ===", "",
        f"Matrix Size: {seq_len} x {seq_len}", "",
        "--- Attention Values ---",
        f"  Global Mean: {attn.mean():.5f}",
        f"  Diagonal Mean: {diag.mean():.5f}",
        f"  Off-diag Mean: {off_vals.mean():.5f}",
        f"  Diag/Off-diag Ratio: {ratio:.3f}", "",
        "--- Temporal ---",
        f"  Peak Time Step: {peak_time}",
        f"  Sync > Past: {zero_mean > pos_mean}",
        f"  Sync > Future: {zero_mean > neg_mean}",
    ]
    ax.text(0.05, 0.95, "\n".join(lines), transform=ax.transAxes, va="top",
            fontsize=9, family="monospace")
    ax.set_title("(F) Summary", fontweight="bold")
    fig.suptitle("Cross-Attention Analysis Summary", fontsize=15,
                 fontweight="bold")
    produced["attention_summary.png"] = _save(fig, out / "attention_summary.png")

    # --- CSV exports (m:628-658) ---
    stats_rows = [
        ("Matrix_Size", f"{seq_len}x{seq_len}"),
        ("Global_Mean", f"{attn.mean():.6f}"),
        ("Global_Std", f"{attn.std():.6f}"),
        ("Diagonal_Mean", f"{diag.mean():.6f}"),
        ("Diagonal_Std", f"{diag.std():.6f}"),
        ("OffDiag_Mean", f"{off_vals.mean():.6f}"),
        ("OffDiag_Std", f"{off_vals.std():.6f}"),
        ("Diag_OffDiag_Ratio", f"{ratio:.4f}"),
        ("Peak_TimeStep", str(peak_time)),
        ("Neg_Lag_Mean", f"{neg_mean:.6f}"),
        ("Zero_Lag_Mean", f"{zero_mean:.6f}"),
        ("Pos_Lag_Mean", f"{pos_mean:.6f}"),
    ]
    out.mkdir(parents=True, exist_ok=True)
    pd.DataFrame(stats_rows, columns=["Metric", "Value"]).to_csv(
        out / "attention_statistics.csv", index=False)
    produced["attention_statistics.csv"] = out / "attention_statistics.csv"
    pd.DataFrame({"Lag": lags, "Mean_Attention": lag_means}).to_csv(
        out / "attention_lag_profile.csv", index=False)
    produced["attention_lag_profile.csv"] = out / "attention_lag_profile.csv"
    return produced


# ---------------------------------------------------------------------------
# Grad-CAM suite (analyze_gradcam.m)
# ---------------------------------------------------------------------------

def _gradcam_axes(result_dir: Path, freq_bins: int, time_steps: int,
                  fs: float = 256.0, n_fft: int = 128, hop: int = 64
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Frequency (Hz) and time (ms) axes — from ``gradcam_metadata.csv`` when
    present, else from the model STFT parameters (analyze_gradcam.m:44-57)."""
    meta = result_dir / "gradcam" / "gradcam_metadata.csv"
    if meta.exists():
        df = pd.read_csv(meta)
        f = df[df.Axis == "Frequency_Hz"].Value.to_numpy(float)
        t = df[df.Axis == "Time_Sec"].Value.to_numpy(float) * 1000.0
        if len(f) == freq_bins and len(t) == time_steps:
            return f, t
    freq_res = fs / n_fft
    return (np.arange(freq_bins) * freq_res,
            np.arange(time_steps) * hop / fs * 1000.0)


def render_gradcam_suite(result_dir: PathLike, output_dir: PathLike,
                         classes: Sequence[str] = CLASSES,
                         fs: float = 256.0) -> Dict[str, Path]:
    """Render the full ``analyze_gradcam.m`` figure suite."""
    res = Path(result_dir)
    out = Path(output_dir)
    produced: Dict[str, Path] = {}
    cam_dir = res / "gradcam" / "gradcam_mean_by_class"
    cams = []
    for cname in classes:
        m = _read_matrix(cam_dir / f"gradcam_{cname}.csv")
        if m is None:
            raise FileNotFoundError(f"missing gradcam_{cname}.csv in {cam_dir}")
        cams.append(m)
    freq_bins, time_steps = cams[0].shape
    freq_axis, time_axis = _gradcam_axes(res, freq_bins, time_steps, fs)
    div_cmap = _diverging_cmap()
    vmin = min(c.min() for c in cams)
    vmax = max(c.max() for c in cams)
    extent = (time_axis[0], time_axis[-1], freq_axis[0], freq_axis[-1])
    band_edges_hz = [b[2] for b in GRADCAM_BANDS]

    # Band bin ranges (analyze_gradcam.m:77-83).
    freq_res = freq_axis[1] - freq_axis[0] if freq_bins > 1 else fs / 128
    bin_ranges = []
    for _, lo, hi, _ in GRADCAM_BANDS:
        lo_bin = max(0, int(np.floor(lo / freq_res)))
        hi_bin = min(freq_bins - 1, int(np.ceil(hi / freq_res)) - 1)
        bin_ranges.append((lo_bin, hi_bin))

    # --- 1. three-class heatmaps, shared clim (m:114-155) ---
    fig, axes = plt.subplots(1, 3, figsize=(14, 4.2), facecolor="white")
    for i, (ax, cname) in enumerate(zip(axes, classes)):
        im = ax.imshow(cams[i], cmap="jet", origin="lower", aspect="auto",
                       extent=extent, vmin=vmin, vmax=vmax)
        for hz in band_edges_hz:
            ax.axhline(hz, linestyle="--", color="w", linewidth=1, alpha=0.7)
        ax.set_ylim(0, 50)
        ax.set_title(cname, color=CLASS_COLORS[i], fontweight="bold",
                     fontsize=13)
        ax.set_xlabel("Time (ms)")
        ax.set_ylabel("Frequency (Hz)")
        fig.colorbar(im, ax=ax, fraction=0.046)
    fig.suptitle("Grad-CAM: Time-Frequency Importance by Class",
                 fontsize=15, fontweight="bold")
    produced["gradcam_heatmap_comparison.png"] = _save(
        fig, out / "gradcam_heatmap_comparison.png")

    # --- 2. pairwise difference maps (m:158-215) ---
    pairs = ((1, 0, "Competition - Single"), (2, 0, "Cooperation - Single"),
             (2, 1, "Cooperation - Competition"))
    fig, axes = plt.subplots(1, 3, figsize=(14, 4.2), facecolor="white")
    for ax, (a, b, title) in zip(axes, pairs):
        d = cams[a] - cams[b]
        m = np.abs(d).max()
        im = ax.imshow(d, cmap=div_cmap, origin="lower", aspect="auto",
                       extent=extent, vmin=-m, vmax=m)
        for hz in band_edges_hz:
            ax.axhline(hz, linestyle="--", color="k", linewidth=1, alpha=0.5)
        ax.set_ylim(0, 50)
        ax.set_title(title, fontweight="bold")
        ax.set_xlabel("Time (ms)")
        ax.set_ylabel("Frequency (Hz)")
        fig.colorbar(im, ax=ax, fraction=0.046)
    fig.suptitle("Grad-CAM Difference Maps (Red=Higher, Blue=Lower)",
                 fontsize=15, fontweight="bold")
    produced["gradcam_difference_maps.png"] = _save(
        fig, out / "gradcam_difference_maps.png")

    # --- 3. frequency profile (m:218-285) ---
    freq_profiles = np.stack([c.mean(axis=1) for c in cams], axis=1)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 5), facecolor="white")
    y_max = freq_profiles.max() * 1.1
    for name, lo, hi, col in GRADCAM_BANDS:
        ax1.axvspan(lo, hi, color=col, alpha=0.15)
    for i, cname in enumerate(classes):
        for ax in (ax1, ax2):
            ax.plot(freq_axis, freq_profiles[:, i], color=CLASS_COLORS[i],
                    linewidth=2, label=cname)
    for ax, title in ((ax1, "Frequency Profile (averaged over time)"),
                      (ax2, "Frequency Profile with Band Labels")):
        ax.set_xlim(0, 50)
        ax.set_xlabel("Frequency (Hz)")
        ax.set_ylabel("Mean Grad-CAM Importance")
        ax.set_title(title, fontweight="bold")
        ax.grid(alpha=0.3)
    ax1.legend(fontsize=8)
    for name, lo, hi, col in GRADCAM_BANDS:
        ax2.text((lo + hi) / 2, freq_profiles.max() * 1.05, name,
                 ha="center", fontsize=8, fontweight="bold", color=col)
    ax2.set_ylim(0, y_max * 1.05)
    fig.suptitle("Grad-CAM: Frequency Importance Analysis", fontsize=15,
                 fontweight="bold")
    produced["gradcam_frequency_profile.png"] = _save(
        fig, out / "gradcam_frequency_profile.png")

    # --- 4. temporal profile + smoothed/peaks (m:288-348) ---
    temp_profiles = np.stack([c.mean(axis=0) for c in cams], axis=1)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 5), facecolor="white")
    for i, cname in enumerate(classes):
        ax1.plot(time_axis, temp_profiles[:, i], color=CLASS_COLORS[i],
                 linewidth=2, label=cname)
        smooth = _movmean(temp_profiles[:, i], 5)
        ax2.plot(time_axis, smooth, color=CLASS_COLORS[i], linewidth=2,
                 label=cname)
        pk = _find_peaks(smooth, smooth.max() * 0.1)
        if len(pk):
            ax2.plot(time_axis[pk], smooth[pk], "v", color=CLASS_COLORS[i],
                     markersize=8)
    for ax, title in ((ax1, "Temporal Profile (averaged over frequency)"),
                      (ax2, "Temporal Profile (smoothed, peaks marked)")):
        ax.set_xlabel("Time (ms)")
        ax.set_ylabel("Mean Grad-CAM Importance")
        ax.set_title(title, fontweight="bold")
        ax.legend(fontsize=8)
        ax.grid(alpha=0.3)
    fig.suptitle("Grad-CAM: Temporal Importance Analysis", fontsize=15,
                 fontweight="bold")
    produced["gradcam_temporal_profile.png"] = _save(
        fig, out / "gradcam_temporal_profile.png")

    # --- 5. band statistics 4-panel (m:351-443) ---
    band_stats = np.zeros((5, 3))
    for bi, (lo_bin, hi_bin) in enumerate(bin_ranges):
        for ci in range(3):
            band_stats[bi, ci] = cams[ci][lo_bin:hi_bin + 1, :].mean()
    band_names = [b[0] for b in GRADCAM_BANDS]
    band_colors = [b[3] for b in GRADCAM_BANDS]

    fig = _headless_fig((11, 7))
    ax = fig.add_subplot(2, 2, 1)
    xs = np.arange(5)
    for ci, cname in enumerate(classes):
        ax.bar(xs + (ci - 1) * 0.25, band_stats[:, ci], 0.25,
               color=CLASS_COLORS[ci], label=cname)
    ax.set_xticks(xs, band_names)
    ax.set_xlabel("Frequency Band")
    ax.set_ylabel("Mean Grad-CAM Importance")
    ax.set_title("Band Importance by Class", fontweight="bold")
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)
    ax = fig.add_subplot(2, 2, 2)
    norm = band_stats / band_stats.sum(axis=0, keepdims=True)
    for ci, cname in enumerate(classes):
        ax.bar(xs + (ci - 1) * 0.25, norm[:, ci], 0.25,
               color=CLASS_COLORS[ci], label=cname)
    ax.set_xticks(xs, band_names)
    ax.set_xlabel("Frequency Band")
    ax.set_ylabel("Proportion of Total Importance")
    ax.set_title("Relative Band Importance (normalized)", fontweight="bold")
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)
    ax = fig.add_subplot(2, 2, 3)
    cxs = np.arange(3)
    for bi in range(5):
        ax.bar(cxs + (bi - 2) * 0.15, band_stats[bi], 0.15,
               color=band_colors[bi], label=band_names[bi])
    ax.set_xticks(cxs, classes)
    ax.set_xlabel("Class")
    ax.set_ylabel("Mean Grad-CAM Importance")
    ax.set_title("Class Importance by Band", fontweight="bold")
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)
    ax = fig.add_subplot(2, 2, 4)
    im = ax.imshow(band_stats, cmap="viridis", aspect="auto")
    fig.colorbar(im, ax=ax)
    ax.set_xticks(range(3), classes)
    ax.set_yticks(range(5), band_names)
    ax.set_xlabel("Class")
    ax.set_ylabel("Frequency Band")
    ax.set_title("Band × Class Importance Heatmap", fontweight="bold")
    for bi in range(5):
        for ci in range(3):
            ax.text(ci, bi, f"{band_stats[bi, ci]:.2e}", ha="center",
                    va="center", color="w", fontsize=7, fontweight="bold")
    fig.suptitle("Grad-CAM: Frequency Band Analysis", fontsize=15,
                 fontweight="bold")
    produced["gradcam_band_statistics.png"] = _save(
        fig, out / "gradcam_band_statistics.png")
    band_df = pd.DataFrame(band_stats, index=band_names,
                           columns=list(classes))
    band_df.index.name = "Row"
    band_df.to_csv(out / "gradcam_band_stats.csv")
    produced["gradcam_band_stats.csv"] = out / "gradcam_band_stats.csv"

    # --- 6. 3D surface (m:446-482) ---
    fig = _headless_fig((15, 5))
    freq_limit = int(np.searchsorted(freq_axis, 50.0, side="right"))
    T, F = np.meshgrid(time_axis, freq_axis[:freq_limit])
    for i, cname in enumerate(classes):
        ax = fig.add_subplot(1, 3, i + 1, projection="3d")
        ax.plot_surface(T, F, cams[i][:freq_limit, :], cmap="jet",
                        edgecolor="none", alpha=0.9)
        ax.view_init(elev=30, azim=45)
        ax.set_xlabel("Time (ms)", fontsize=8)
        ax.set_ylabel("Frequency (Hz)", fontsize=8)
        ax.set_zlabel("Importance", fontsize=8)
        ax.set_title(cname, color=CLASS_COLORS[i], fontsize=12,
                     fontweight="bold")
    fig.suptitle("Grad-CAM: 3D Time-Frequency Importance Surface",
                 fontsize=15, fontweight="bold")
    produced["gradcam_3d_surface.png"] = _save(
        fig, out / "gradcam_3d_surface.png")

    # --- 7. summary panel (m:485-617) ---
    fig = _headless_fig((15, 10))
    for i, cname in enumerate(classes):
        ax = fig.add_subplot(3, 4, i + 1)
        im = ax.imshow(cams[i], cmap="jet", origin="lower", aspect="auto",
                       extent=extent, vmin=vmin, vmax=vmax)
        ax.set_ylim(0, 50)
        ax.set_title(cname, color=CLASS_COLORS[i], fontsize=10,
                     fontweight="bold")
        ax.set_xlabel("Time (ms)", fontsize=8)
        ax.set_ylabel("Freq (Hz)", fontsize=8)
        if i == 2:
            fig.colorbar(im, ax=ax, fraction=0.046)
    ax = fig.add_subplot(3, 4, 4)
    d = cams[2] - cams[1]
    m = np.abs(d).max()
    im = ax.imshow(d, cmap=div_cmap, origin="lower", aspect="auto",
                   extent=extent, vmin=-m, vmax=m)
    ax.set_ylim(0, 50)
    ax.set_title("Coop - Comp", fontsize=10, fontweight="bold")
    ax.set_xlabel("Time (ms)", fontsize=8)
    ax.set_ylabel("Freq (Hz)", fontsize=8)
    fig.colorbar(im, ax=ax, fraction=0.046)
    ax = fig.add_subplot(3, 4, (5, 6))
    for i, cname in enumerate(classes):
        ax.plot(freq_axis, freq_profiles[:, i], color=CLASS_COLORS[i],
                linewidth=2, label=cname)
    ax.set_xlim(0, 50)
    ax.set_xlabel("Frequency (Hz)")
    ax.set_ylabel("Importance")
    ax.set_title("Frequency Profile", fontweight="bold")
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)
    ax = fig.add_subplot(3, 4, (7, 8))
    for i, cname in enumerate(classes):
        ax.plot(time_axis, temp_profiles[:, i], color=CLASS_COLORS[i],
                linewidth=2, label=cname)
    ax.set_xlabel("Time (ms)")
    ax.set_ylabel("Importance")
    ax.set_title("Temporal Profile", fontweight="bold")
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)
    ax = fig.add_subplot(3, 4, (9, 10))
    for ci, cname in enumerate(classes):
        ax.bar(xs + (ci - 1) * 0.25, band_stats[:, ci], 0.25,
               color=CLASS_COLORS[ci], label=cname)
    ax.set_xticks(xs, band_names)
    ax.set_ylabel("Importance")
    ax.set_title("Band Importance", fontweight="bold")
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)
    ax = fig.add_subplot(3, 4, (11, 12))
    ax.axis("off")
    top_band = [band_names[int(np.argmax(band_stats[:, ci]))]
                for ci in range(3)]
    peak_ms = [time_axis[int(np.argmax(temp_profiles[:, ci]))]
               for ci in range(3)]
    lines = [
        "=== Key Findings ===", "",
        "--- Most Important Band per Class ---",
        *(f"  {c}: {b}" for c, b in zip(classes, top_band)), "",
        "--- Peak Importance Time ---",
        *(f"  {c}: {p:.0f} ms" for c, p in zip(classes, peak_ms)), "",
        "--- Coop vs Comp Differences ---",
        f"  Theta: {band_stats[1, 2] - band_stats[1, 1]:+.2e}",
        f"  Alpha: {band_stats[2, 2] - band_stats[2, 1]:+.2e}",
    ]
    ax.text(0.05, 0.95, "\n".join(lines), transform=ax.transAxes, va="top",
            fontsize=9, family="monospace")
    ax.set_title("Key Findings", fontweight="bold")
    fig.suptitle("Grad-CAM Analysis Summary", fontsize=15, fontweight="bold")
    produced["gradcam_summary.png"] = _save(fig, out / "gradcam_summary.png")

    # --- CSV exports (m:620-637) ---
    pd.DataFrame(
        np.column_stack([freq_axis, freq_profiles]),
        columns=["Frequency_Hz", *classes]).to_csv(
        out / "gradcam_frequency_profile.csv", index=False)
    produced["gradcam_frequency_profile.csv"] = (
        out / "gradcam_frequency_profile.csv")
    pd.DataFrame(
        np.column_stack([time_axis, temp_profiles]),
        columns=["Time_ms", *classes]).to_csv(
        out / "gradcam_temporal_profile.csv", index=False)
    produced["gradcam_temporal_profile.csv"] = (
        out / "gradcam_temporal_profile.csv")
    return produced


# ---------------------------------------------------------------------------
# Entropy / gaze suites (analyze_gaze.m + analyze_eeg.m entropy sections)
# ---------------------------------------------------------------------------

def _rm_raincloud(ax, groups: Sequence[np.ndarray],
                  colors: Sequence, labels: Sequence[str],
                  rng_seed: int = 0) -> None:
    """Horizontal repeated-measures raincloud
    (``raincloudplots/rm_raincloud.m`` role): one row per condition, each a
    KDE "cloud" above a jittered scatter "rain", with per-row mean markers
    joined by a line."""
    from scipy.stats import gaussian_kde

    rng = np.random.default_rng(rng_seed)
    n = len(groups)
    row_h = 1.0
    means = []
    for i, (vals, color) in enumerate(zip(groups, colors)):
        vals = np.asarray(vals, np.float64)
        y0 = (n - 1 - i) * row_h  # first condition on top, like rm_raincloud
        if len(vals) == 0:
            means.append((np.nan, y0))
            continue
        if len(vals) > 1 and np.ptp(vals) > 0:
            kde = gaussian_kde(vals)
            xs = np.linspace(vals.min(), vals.max(), 200)
            dens = kde(xs)
            dens = dens / dens.max() * (0.42 * row_h)
            ax.fill_between(xs, y0, y0 + dens, color=tuple(color), alpha=0.6,
                            linewidth=0)
        jitter = rng.uniform(-0.32 * row_h, -0.08 * row_h, size=len(vals))
        ax.scatter(vals, y0 + jitter, s=10, color=tuple(color), alpha=0.5,
                   edgecolors="none")
        means.append((float(vals.mean()), y0))
    mx, my = zip(*means)
    ax.plot(mx, my, "-", color="0.2", linewidth=1.2, zorder=3)
    for (m, y), color in zip(means, colors):
        ax.plot([m], [y], "o", markersize=9, markerfacecolor=tuple(color),
                markeredgecolor="k", zorder=4)
    ax.set_yticks([(n - 1 - i) * row_h for i in range(n)], labels)
    ax.grid(alpha=0.3)


def _entropy_raincloud(df: pd.DataFrame, value_col: str, path: Path,
                       title: str, xlabel: str,
                       classes: Sequence[str] = CLASSES) -> Path:
    fig = _headless_fig((8, 6))
    ax = fig.add_subplot(111)
    groups = [df.loc[df.condition == c, value_col].to_numpy()
              for c in classes]
    _rm_raincloud(ax, groups, CLASS_COLORS, list(classes))
    ax.set_title(title, fontweight="bold")
    ax.set_xlabel(xlabel)
    ax.set_ylabel("Condition")
    return _save(fig, path)


def _entropy_by_pair_sorted(df: pd.DataFrame, value_col: str, path: Path,
                            title: str, xlabel: str,
                            classes: Sequence[str] = CLASSES) -> Path:
    """Horizontal per-pair boxes grouped by condition, pairs sorted by the
    mean of their per-condition means, with the overall means joined by a
    diamond line (analyze_gaze.m:134-164 / analyze_eeg.m:70-127)."""
    per_pair_cond = df.groupby(["pair_id", "condition"], observed=True)[
        value_col].mean()
    overall = per_pair_cond.groupby("pair_id").mean().sort_values()
    pairs = list(overall.index)
    fig = _headless_fig((8, max(4.0, 0.45 * len(pairs) + 2)))
    ax = fig.add_subplot(111)
    n_cond = len(classes)
    box_h = 0.8 / n_cond
    for ci, cond in enumerate(classes):
        data, positions = [], []
        for pi, pair in enumerate(pairs):
            vals = df.loc[(df.pair_id == pair) & (df.condition == cond),
                          value_col].to_numpy()
            if len(vals):
                data.append(vals)
                positions.append(pi + (ci - (n_cond - 1) / 2) * box_h)
        if data:
            bp = ax.boxplot(data, positions=positions,
                            orientation="horizontal",
                            widths=box_h * 0.85, patch_artist=True,
                            showfliers=False, manage_ticks=False)
            for box in bp["boxes"]:
                box.set_facecolor(tuple(CLASS_COLORS[ci]))
                box.set_alpha(0.8)
            for med in bp["medians"]:
                med.set_color("k")
    ax.plot(overall.to_numpy(), np.arange(len(pairs)), "-d", color="k",
            linewidth=1.5, markerfacecolor="w", markersize=6,
            label="Mean (Avg of Conditions)")
    handles = [plt.Rectangle((0, 0), 1, 1, facecolor=tuple(CLASS_COLORS[i]))
               for i in range(n_cond)]
    ax.legend(handles + [ax.lines[-1]], list(classes) +
              ["Mean (Avg of Conditions)"], loc="center left",
              bbox_to_anchor=(1.0, 0.5), fontsize=8)
    ax.set_yticks(range(len(pairs)), [str(p) for p in pairs])
    ax.set_ylabel("Pair ID")
    ax.set_xlabel(xlabel)
    ax.set_title(title, fontweight="bold")
    ax.grid(alpha=0.3)
    return _save(fig, path)


def _entropy_topoplot(df: pd.DataFrame, channel_cols: Sequence[str],
                      positions: Dict[str, tuple], path: Path,
                      classes: Sequence[str] = CLASSES) -> Path:
    """Per-condition scalp maps with shared color limits and the suite's
    blue-white-orange interpolated map (analyze_eeg.m:167-250)."""
    from scipy.interpolate import griddata

    cmap = LinearSegmentedColormap.from_list(
        "single_coop_comp",
        [(0.55, 0.63, 0.80), (1.0, 1.0, 1.0), (0.99, 0.55, 0.38)])
    maps = np.stack([
        df.loc[df.condition == c, channel_cols].mean().to_numpy(float)
        for c in classes])
    vmin, vmax = maps.min(), maps.max()
    pts = np.asarray([positions[ch] for ch in channel_cols], np.float64)
    gx, gy = np.meshgrid(np.linspace(-1.1, 1.1, 120),
                         np.linspace(-1.1, 1.1, 120))
    fig, axes = plt.subplots(1, 3, figsize=(12, 4), facecolor="white")
    for i, (ax, cname) in enumerate(zip(axes, classes)):
        gz = griddata(pts, maps[i], (gx, gy), method="cubic")
        gz[gx ** 2 + gy ** 2 > 1.0] = np.nan  # head rim
        im = ax.imshow(gz, extent=(-1.1, 1.1, -1.1, 1.1), origin="lower",
                       cmap=cmap, vmin=vmin, vmax=vmax)
        ax.add_patch(plt.Circle((0, 0), 1.0, fill=False, color="k",
                                linewidth=1.5))
        ax.scatter(pts[:, 0], pts[:, 1], s=8, c="k")
        ax.set_title(cname, color=CLASS_COLORS[i], fontweight="bold")
        ax.set_xlim(-1.2, 1.2)
        ax.set_ylim(-1.2, 1.2)
        ax.set_aspect("equal")
        ax.axis("off")
    fig.colorbar(im, ax=axes, fraction=0.02)
    return _save(fig, path)


def render_frequency_sensitivity_bar(band_csv: PathLike, path: PathLike
                                     ) -> Path:
    """Grouped accuracy/F1 drop bars in percent
    (analyze_eeg.m:269-341, ``freq_sensitivity_grouped_bar.png``)."""
    df = pd.read_csv(band_csv)
    acc_drop = df["Accuracy_Drop"].to_numpy(float) * 100
    f1_drop = df["F1_Drop"].to_numpy(float) * 100
    fig = _headless_fig((9, 5))
    ax = fig.add_subplot(111)
    xs = np.arange(len(df))
    b1 = ax.bar(xs - 0.2, acc_drop, 0.4, color=(0.55, 0.63, 0.80),
                label="Accuracy Drop")
    b2 = ax.bar(xs + 0.2, f1_drop, 0.4, color=(0.99, 0.55, 0.38),
                label="F1 Drop")
    for bars, vals in ((b1, acc_drop), (b2, f1_drop)):
        for bar, v in zip(bars, vals):
            ax.text(bar.get_x() + bar.get_width() / 2,
                    bar.get_height(), f"{v:.2f}", ha="center", va="bottom",
                    fontsize=8)
    ax.axhline(0.0, linestyle="--", color="k", linewidth=1.2)
    ax.set_xticks(xs, df["Band"])
    ax.set_xlabel("Frequency Band", fontweight="bold")
    ax.set_ylabel("Performance Drop (%)", fontweight="bold")
    ax.set_title("Frequency Sensitivity: Performance Drop when Band Masked",
                 fontsize=13, fontweight="bold")
    ax.legend()
    ax.grid(alpha=0.3)
    return _save(fig, Path(path))


def render_entropy_suite(entropy_dir: PathLike, output_dir: PathLike,
                         positions: Optional[Dict[str, tuple]] = None,
                         classes: Sequence[str] = CLASSES
                         ) -> Dict[str, Path]:
    """Render the entropy figures of ``analyze_gaze.m`` (fig_gaze_raincloud,
    fig_gaze_entropy_by_pair_sorted_horizontal, fig_eeg_raincloud,
    fig_eeg_channel_heatmap, fig_correlation) plus ``analyze_eeg.m``'s
    entropy trio (eeg_entropy_boxplot_sorted, eeg_entropy_raincloud,
    eeg_entropy_topoplot) from an ``analyze_entropy.py`` output directory.
    Figures whose inputs are missing are skipped, like the ``.m`` scripts'
    per-section existence guards."""
    src = Path(entropy_dir)
    out = Path(output_dir)
    produced: Dict[str, Path] = {}
    gaze_f, eeg_f = src / "gaze_entropy_raw.csv", src / "eeg_entropy_raw.csv"
    gaze_df = pd.read_csv(gaze_f) if gaze_f.exists() else None
    eeg_df = pd.read_csv(eeg_f) if eeg_f.exists() else None

    if gaze_df is not None and not gaze_df.empty:
        produced["fig_gaze_raincloud.png"] = _entropy_raincloud(
            gaze_df, "spatial_entropy", out / "fig_gaze_raincloud.png",
            "Gaze Spatial Entropy Distribution", "Spatial Entropy (bits)",
            classes)
        if "pair_id" in gaze_df.columns:
            produced["fig_gaze_entropy_by_pair_sorted_horizontal.png"] = (
                _entropy_by_pair_sorted(
                    gaze_df, "spatial_entropy",
                    out / "fig_gaze_entropy_by_pair_sorted_horizontal.png",
                    "Gaze Spatial Entropy Distribution by Pair ID (Sorted)",
                    "Spatial Entropy (bits)", classes))

    if eeg_df is not None and not eeg_df.empty:
        produced["fig_eeg_raincloud.png"] = _entropy_raincloud(
            eeg_df, "mean_entropy", out / "fig_eeg_raincloud.png",
            "EEG Spectral Entropy Distribution",
            "Mean Spectral Entropy (bits)", classes)
        produced["eeg_entropy_raincloud.png"] = _entropy_raincloud(
            eeg_df, "mean_entropy", out / "eeg_entropy_raincloud.png",
            "EEG Mean Entropy Distribution", "Mean Entropy", classes)
        if "pair_id" in eeg_df.columns:
            produced["eeg_entropy_boxplot_sorted.png"] = (
                _entropy_by_pair_sorted(
                    eeg_df, "mean_entropy",
                    out / "eeg_entropy_boxplot_sorted.png",
                    "EEG Mean Entropy Distribution by Pair ID (Sorted)",
                    "Mean Entropy", classes))

        chan_cols = [c for c in eeg_df.columns
                     if c not in ("pair_id", "player", "trial_idx",
                                  "condition", "mean_entropy", "n_windows")
                     and eeg_df[c].dtype.kind == "f"]
        if chan_cols:
            # 3 x C channel heatmap (analyze_gaze.m:350-354).
            hm = np.stack([
                eeg_df.loc[eeg_df.condition == c, chan_cols]
                .mean().to_numpy(float) for c in classes])
            fig = _headless_fig((10, 3.2))
            ax = fig.add_subplot(111)
            im = ax.imshow(hm, cmap="viridis", aspect="auto")
            fig.colorbar(im, ax=ax, fraction=0.02)
            ax.set_xticks(range(len(chan_cols)), chan_cols, rotation=90,
                          fontsize=6)
            ax.set_yticks(range(len(classes)), classes)
            ax.set_title("Mean Spectral Entropy per Channel",
                         fontweight="bold")
            produced["fig_eeg_channel_heatmap.png"] = _save(
                fig, out / "fig_eeg_channel_heatmap.png")
            if positions and all(ch in positions for ch in chan_cols):
                produced["eeg_entropy_topoplot.png"] = _entropy_topoplot(
                    eeg_df, chan_cols, positions,
                    out / "eeg_entropy_topoplot.png", classes)

    # Cross-modality correlation scatter (analyze_gaze.m:358-369).
    if gaze_df is not None and eeg_df is not None \
            and not gaze_df.empty and not eeg_df.empty:
        keys = [k for k in ("pair_id", "player", "trial_idx", "condition")
                if k in gaze_df.columns and k in eeg_df.columns]
        merged = gaze_df.merge(
            eeg_df[keys + ["mean_entropy"]], on=keys, how="inner")
        if len(merged) > 2:
            from scipy.stats import pearsonr

            r, p = pearsonr(merged["spatial_entropy"],
                            merged["mean_entropy"])
            fig = _headless_fig((8, 6))
            ax = fig.add_subplot(111)
            for i, cname in enumerate(classes):
                sel = merged.condition == cname
                if sel.any():
                    ax.scatter(merged.loc[sel, "spatial_entropy"],
                               merged.loc[sel, "mean_entropy"], s=45,
                               color=tuple(CLASS_COLORS[i]), label=cname)
            ax.set_title(f"Gaze vs EEG Entropy (R = {r:.3f}, p = {p:.3f})",
                         fontweight="bold")
            ax.set_xlabel("Gaze Entropy")
            ax.set_ylabel("EEG Entropy")
            ax.legend()
            ax.grid(alpha=0.3)
            produced["fig_correlation.png"] = _save(
                fig, out / "fig_correlation.png")
    return produced


def render_all_suites(result_dir: PathLike, output_root: PathLike,
                      key_band: str = "theta", key_feature: str = "PLV"
                      ) -> Dict[str, Dict[str, Path]]:
    """Render every MATLAB figure suite whose inputs exist under
    ``result_dir``; suites with missing inputs are skipped (reported as {})
    the way the ``.m`` scripts error out individually."""
    root = Path(output_root)
    produced: Dict[str, Dict[str, Path]] = {}
    for name, fn, sub in (
            ("ibs_connectivity",
             lambda: render_ibs_suite(result_dir,
                                      root / "ibs_connectivity_native",
                                      key_band, key_feature),
             "ibs_connectivity"),
            ("attention_weights",
             lambda: render_attention_suite(
                 result_dir, root / "attention_weights_native"),
             "attention_weights"),
            ("gradcam",
             lambda: render_gradcam_suite(result_dir, root / "gradcam_native"),
             "gradcam")):
        if not (Path(result_dir) / sub).exists():
            produced[name] = {}
            continue
        try:
            produced[name] = fn()
        except FileNotFoundError:
            produced[name] = {}
    return produced
