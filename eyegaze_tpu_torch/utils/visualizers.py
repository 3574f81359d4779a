"""Academic matplotlib visualization suite.

The port's copy of ``eyegaze_tpu/utils/visualizers.py`` (the reference's
``6_Utils/visualizers.py``): academic style, colorblind-safe condition
palette, entropy boxplot/KDE/topomap/violin, confusion matrix, ROC, t-SNE
scatter, learning curves, metric comparison, per-pair accuracy,
connectivity heatmaps, attention maps, Grad-CAM, saliency, watch panels.
The plotting bodies are the JAX package's (``plot_entropy_boxplot`` names
its ticks by matplotlib's current keyword), so the same inputs give the
same pixels.

All functions take data + an output path and save a figure; headless-safe
(Agg backend).  matplotlib is imported, and Agg selected, at the first call
(``utils/lazy``): the module imports where matplotlib is not installed.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from eyegaze_tpu_torch.utils.lazy import LazyImport, use_agg

plt = LazyImport("matplotlib.pyplot", setup=use_agg)

# Colorblind-safe palette for the three conditions (visualizers.py:33-40 role).
CONDITION_COLORS = {
    "Single": "#0173B2",
    "Competition": "#DE8F05",
    "Cooperation": "#029E73",
}
CLASS_NAMES = ("Single", "Competition", "Cooperation")


def setup_academic_style():
    """Publication-style rcParams (visualizers.py:43-91 role)."""
    plt.rcParams.update({
        "figure.dpi": 120,
        "savefig.dpi": 200,
        "font.size": 10,
        "axes.titlesize": 11,
        "axes.labelsize": 10,
        "axes.spines.top": False,
        "axes.spines.right": False,
        "axes.grid": True,
        "grid.alpha": 0.3,
        "legend.frameon": False,
    })


def _save(fig, path):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def plot_confusion_matrix(cm: np.ndarray, path, class_names=CLASS_NAMES,
                          normalize: bool = False, title="Confusion Matrix"):
    cm = np.asarray(cm, dtype=np.float64)
    if normalize:
        cm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)
    fig, ax = plt.subplots(figsize=(4.5, 4))
    im = ax.imshow(cm, cmap="Blues")
    ax.set_xticks(range(len(class_names)), class_names, rotation=45, ha="right")
    ax.set_yticks(range(len(class_names)), class_names)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ax.set_title(title)
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            v = cm[i, j]
            ax.text(j, i, f"{v:.2f}" if normalize else f"{int(v)}",
                    ha="center", va="center",
                    color="white" if v > cm.max() / 2 else "black")
    fig.colorbar(im, ax=ax, fraction=0.046)
    _save(fig, path)


def plot_roc_curves(roc: Dict, path, class_names=CLASS_NAMES, title="ROC (one-vs-rest)"):
    fig, ax = plt.subplots(figsize=(5, 4.5))
    for k, d in roc["per_class"].items():
        name = class_names[k] if isinstance(k, int) else str(k)
        ax.plot(d["fpr"], d["tpr"],
                color=CONDITION_COLORS.get(name),
                label=f"{name} (AUC={d['auc']:.3f})")
    if "micro" in roc:
        ax.plot(roc["micro"]["fpr"], roc["micro"]["tpr"], "k--", alpha=0.6,
                label=f"micro (AUC={roc['micro']['auc']:.3f})")
    ax.plot([0, 1], [0, 1], color="gray", lw=0.8, ls=":")
    ax.set_xlabel("False positive rate")
    ax.set_ylabel("True positive rate")
    ax.set_title(title)
    ax.legend(loc="lower right", fontsize=8)
    _save(fig, path)


def plot_embedding_scatter(emb: np.ndarray, labels: np.ndarray, path,
                           class_names=CLASS_NAMES, title="t-SNE embedding"):
    fig, ax = plt.subplots(figsize=(5, 4.5))
    for c, name in enumerate(class_names):
        sel = labels == c
        ax.scatter(emb[sel, 0], emb[sel, 1], s=12, alpha=0.7,
                   color=CONDITION_COLORS.get(name), label=name)
    ax.set_title(title)
    ax.legend(fontsize=8)
    _save(fig, path)


def plot_learning_curves(history: List[Dict], path, keys=("train/loss", "val/f1_macro")):
    fig, axes = plt.subplots(1, len(keys), figsize=(4.5 * len(keys), 3.5))
    axes = np.atleast_1d(axes)
    for ax, key in zip(axes, keys):
        xs = [h.get("epoch", i) for i, h in enumerate(history) if key in h]
        ys = [h[key] for h in history if key in h]
        ax.plot(xs, ys, marker="o", ms=3)
        ax.set_xlabel("epoch")
        ax.set_title(key)
    _save(fig, path)


def plot_metrics_comparison(table, path, metric_cols=("accuracy", "f1_macro"),
                            title="Model comparison"):
    """Grouped bar chart from a DataFrame with a Model column."""
    models = table["Model"].tolist()
    x = np.arange(len(models))
    width = 0.8 / len(metric_cols)
    fig, ax = plt.subplots(figsize=(1.2 * len(models) + 2, 3.5))
    for i, m in enumerate(metric_cols):
        ax.bar(x + i * width, table[m], width, label=m)
    ax.set_xticks(x + width * (len(metric_cols) - 1) / 2, models,
                  rotation=30, ha="right")
    ax.set_ylim(0, 1)
    ax.set_title(title)
    ax.legend(fontsize=8)
    _save(fig, path)


def plot_confusion_matrix_grid(cms: Dict[str, np.ndarray], path,
                               class_names=CLASS_NAMES, normalize: bool = True,
                               title="Confusion matrices"):
    """One normalized CM per model, side by side (model_comparison.py:315-356 role)."""
    n = len(cms)
    fig, axes = plt.subplots(1, n, figsize=(3.2 * n, 3.2))
    axes = np.atleast_1d(axes)
    for ax, (name, cm) in zip(axes, cms.items()):
        cm = np.asarray(cm, np.float64)
        if normalize:
            cm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)
        ax.imshow(cm, cmap="Blues", vmin=0, vmax=cm.max() or 1)
        ax.set_xticks(range(len(class_names)), class_names, rotation=45,
                      ha="right", fontsize=7)
        ax.set_yticks(range(len(class_names)), class_names, fontsize=7)
        ax.set_title(name, fontsize=9)
        for i in range(cm.shape[0]):
            for j in range(cm.shape[1]):
                ax.text(j, i, f"{cm[i, j]:.2f}", ha="center", va="center",
                        fontsize=7,
                        color="white" if cm[i, j] > cm.max() / 2 else "black")
    fig.suptitle(title)
    _save(fig, path)


def plot_roc_overlay(rocs: Dict[str, Dict], path, which: str = "micro",
                     title="ROC comparison"):
    """Overlay one ROC curve per model (model_comparison.py:360-405 role).

    ``rocs`` maps model name -> roc_curves() output; ``which`` selects the
    'micro' curve or an integer class index.
    """
    fig, ax = plt.subplots(figsize=(5, 4.5))
    for name, roc in rocs.items():
        d = roc["micro"] if which == "micro" else roc["per_class"][which]
        ax.plot(d["fpr"], d["tpr"], label=f"{name} (AUC={d['auc']:.3f})")
    ax.plot([0, 1], [0, 1], color="gray", lw=0.8, ls=":")
    ax.set_xlabel("False positive rate")
    ax.set_ylabel("True positive rate")
    ax.set_title(title)
    ax.legend(loc="lower right", fontsize=8)
    _save(fig, path)


def plot_per_class_comparison(per_class: Dict[str, np.ndarray], path,
                              class_names=CLASS_NAMES, metric: str = "f1",
                              title=None):
    """Per-class metric bars per model (model_comparison.py:409-456 role).

    ``per_class`` maps model name -> (num_classes,) metric values.
    """
    models = list(per_class)
    x = np.arange(len(class_names))
    width = 0.8 / max(len(models), 1)
    fig, ax = plt.subplots(figsize=(1.5 * len(class_names) + 2, 3.5))
    for i, m in enumerate(models):
        ax.bar(x + i * width, np.asarray(per_class[m]), width, label=m)
    ax.set_xticks(x + width * (len(models) - 1) / 2, class_names)
    ax.set_ylim(0, 1)
    ax.set_ylabel(metric)
    ax.set_title(title or f"Per-class {metric}")
    ax.legend(fontsize=8)
    _save(fig, path)


def plot_radar_chart(table, path, metric_cols=("accuracy", "precision_macro",
                                               "recall_macro", "f1_macro"),
                     title="Model comparison (radar)"):
    """Polar radar chart over >=3 metrics (model_comparison.py:460-513 role).

    ``table``: DataFrame with a Model column + metric columns.
    """
    if len(metric_cols) < 3:
        raise ValueError("radar chart needs at least 3 metrics")
    angles = np.linspace(0, 2 * np.pi, len(metric_cols), endpoint=False)
    angles_closed = np.r_[angles, angles[:1]]
    fig, ax = plt.subplots(figsize=(5.5, 5.5), subplot_kw=dict(polar=True))
    for _, row in table.iterrows():
        vals = np.asarray([row[m] for m in metric_cols], np.float64)
        vals = np.r_[vals, vals[:1]]
        ax.plot(angles_closed, vals, lw=1.5, label=row["Model"])
        ax.fill(angles_closed, vals, alpha=0.08)
    ax.set_xticks(angles, metric_cols, fontsize=8)
    ax.set_ylim(0, 1)
    ax.set_title(title)
    ax.legend(loc="upper right", bbox_to_anchor=(1.35, 1.1), fontsize=8)
    _save(fig, path)


def plot_raincloud(values_by_condition: Dict[str, np.ndarray], path,
                   title="Distribution", ylabel="value"):
    """Raincloud: half-violin + jittered points + box, per condition.

    Python fallback for the MATLAB raincloudplots role
    (7_Analysis/matlab_scripts/raincloudplots/).
    """
    fig, ax = plt.subplots(figsize=(1.8 * len(values_by_condition) + 2, 4))
    rng = np.random.default_rng(0)
    for i, (name, vals) in enumerate(values_by_condition.items()):
        vals = np.asarray(vals, np.float64)
        color = CONDITION_COLORS.get(name, f"C{i}")
        parts = ax.violinplot([vals], positions=[i], showextrema=False,
                              widths=0.7)
        for body in parts["bodies"]:
            # keep only the right half of the violin (the "cloud")
            verts = body.get_paths()[0].vertices
            verts[:, 0] = np.clip(verts[:, 0], i, i + 0.4)
            body.set_facecolor(color)
            body.set_alpha(0.5)
        jitter = rng.uniform(-0.25, -0.08, size=len(vals))
        ax.scatter(i + jitter, vals, s=6, alpha=0.5, color=color)  # the "rain"
        ax.boxplot([vals], positions=[i], widths=0.1, orientation="vertical",
                   showfliers=False,
                   medianprops={"color": "black"},
                   boxprops={"color": "black"})
    ax.set_xticks(range(len(values_by_condition)), list(values_by_condition))
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    _save(fig, path)


def plot_per_pair_accuracy(per_pair: Dict[int, float], path, title="Per-pair accuracy"):
    pairs = sorted(per_pair)
    fig, ax = plt.subplots(figsize=(max(4, 0.3 * len(pairs) + 2), 3))
    ax.bar([str(p) for p in pairs], [per_pair[p] for p in pairs], color="#0173B2")
    ax.axhline(np.mean(list(per_pair.values())), color="red", ls="--", lw=1,
               label="mean")
    ax.set_xlabel("Pair ID")
    ax.set_ylabel("Accuracy")
    ax.set_ylim(0, 1)
    ax.set_title(title)
    ax.legend(fontsize=8)
    _save(fig, path)


def plot_entropy_boxplot(values_by_condition: Dict[str, np.ndarray], path,
                         ylabel="Entropy (bits)", title="Entropy by condition"):
    names = list(values_by_condition)
    fig, ax = plt.subplots(figsize=(4, 3.5))
    # tick_labels: the JAX module's ``labels=`` is deprecated since
    # matplotlib 3.9 and goes in 3.11; both draw the same figure.
    bp = ax.boxplot([values_by_condition[n] for n in names], tick_labels=names,
                    patch_artist=True)
    for patch, name in zip(bp["boxes"], names):
        patch.set_facecolor(CONDITION_COLORS.get(name, "#999999"))
        patch.set_alpha(0.6)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    _save(fig, path)


def plot_entropy_kde(values_by_condition: Dict[str, np.ndarray], path,
                     xlabel="Entropy (bits)", title="Entropy distribution"):
    from scipy import stats as sstats

    fig, ax = plt.subplots(figsize=(4.5, 3.5))
    for name, vals in values_by_condition.items():
        vals = np.asarray(vals)
        if len(vals) < 2 or np.std(vals) == 0:
            continue
        kde = sstats.gaussian_kde(vals)
        xs = np.linspace(vals.min(), vals.max(), 200)
        ax.plot(xs, kde(xs), color=CONDITION_COLORS.get(name), label=name)
        ax.fill_between(xs, kde(xs), alpha=0.2, color=CONDITION_COLORS.get(name))
    ax.set_xlabel(xlabel)
    ax.set_ylabel("Density")
    ax.set_title(title)
    ax.legend(fontsize=8)
    _save(fig, path)


def plot_entropy_violin(values_by_condition: Dict[str, np.ndarray], path,
                        ylabel="Entropy (bits)", title="Entropy by condition"):
    names = list(values_by_condition)
    fig, ax = plt.subplots(figsize=(4, 3.5))
    parts = ax.violinplot([values_by_condition[n] for n in names],
                          showmedians=True)
    for body, name in zip(parts["bodies"], names):
        body.set_facecolor(CONDITION_COLORS.get(name, "#999999"))
        body.set_alpha(0.6)
    ax.set_xticks(range(1, len(names) + 1), names)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    _save(fig, path)


def plot_topomap(values: np.ndarray, positions: Dict[str, tuple],
                 channel_names: Sequence[str], path, title="Topomap",
                 cmap="RdBu_r"):
    """Scalp topomap via grid interpolation (visualizers.py griddata role)."""
    from scipy.interpolate import griddata

    pts = np.asarray([positions[ch] for ch in channel_names])
    xi = np.linspace(-1, 1, 100)
    yi = np.linspace(-1, 1, 100)
    grid = griddata(pts, values, (xi[None, :], yi[:, None]), method="cubic")
    mask = (xi[None, :] ** 2 + yi[:, None] ** 2) > 1
    grid = np.where(mask, np.nan, grid)
    fig, ax = plt.subplots(figsize=(4, 4))
    im = ax.imshow(grid, extent=[-1, 1, -1, 1], origin="lower", cmap=cmap)
    circle = plt.Circle((0, 0), 1.0, fill=False, color="black", lw=1.5)
    ax.add_patch(circle)
    ax.scatter(pts[:, 0], pts[:, 1], s=8, c="black")
    ax.set_xlim(-1.1, 1.1)
    ax.set_ylim(-1.1, 1.1)
    ax.axis("off")
    ax.set_title(title)
    fig.colorbar(im, ax=ax, fraction=0.046)
    _save(fig, path)


def plot_connectivity_heatmap(matrix: np.ndarray, path,
                              channel_names: Optional[Sequence[str]] = None,
                              title="IBS connectivity", cmap="viridis"):
    fig, ax = plt.subplots(figsize=(5, 4.5))
    im = ax.imshow(matrix, cmap=cmap)
    if channel_names is not None and len(channel_names) <= 32:
        ax.set_xticks(range(len(channel_names)), channel_names, rotation=90, fontsize=5)
        ax.set_yticks(range(len(channel_names)), channel_names, fontsize=5)
    ax.set_xlabel("Player 2 channel")
    ax.set_ylabel("Player 1 channel")
    ax.set_title(title)
    fig.colorbar(im, ax=ax, fraction=0.046)
    _save(fig, path)


def plot_attention_map(attn: np.ndarray, path, title="Cross-attention map",
                       token_boundaries: Optional[Dict[str, int]] = None):
    fig, ax = plt.subplots(figsize=(5, 4.5))
    im = ax.imshow(attn, cmap="magma")
    if token_boundaries:
        for name, idx in token_boundaries.items():
            ax.axvline(idx, color="white", lw=0.5, alpha=0.5)
            ax.axhline(idx, color="white", lw=0.5, alpha=0.5)
    ax.set_title(title)
    fig.colorbar(im, ax=ax, fraction=0.046)
    _save(fig, path)


def plot_gradcam(cam: np.ndarray, path, title="Grad-CAM (spectrogram)",
                 sampling_rate: float = 256.0, n_fft: int = 128):
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(cam, aspect="auto", origin="lower", cmap="jet")
    ax.set_xlabel("Time bin")
    ax.set_ylabel("Frequency bin")
    ax.set_title(title)
    fig.colorbar(im, ax=ax, fraction=0.046)
    _save(fig, path)


def plot_entropy_correlation(x: np.ndarray, y: np.ndarray, path,
                             xlabel="Gaze spatial entropy",
                             ylabel="EEG spectral entropy",
                             title="Entropy correlation"):
    from scipy import stats as sstats

    r, p = sstats.pearsonr(x, y)
    fig, ax = plt.subplots(figsize=(4, 3.5))
    ax.scatter(x, y, s=10, alpha=0.6, color="#0173B2")
    coef = np.polyfit(x, y, 1)
    xs = np.linspace(x.min(), x.max(), 50)
    ax.plot(xs, np.polyval(coef, xs), color="red", lw=1,
            label=f"r={r:.3f}, p={p:.3g}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.legend(fontsize=8)
    _save(fig, path)


def plot_mechanism_analysis(values_by_class: Dict[str, np.ndarray], path,
                            ylabel="Statistic", title="Mechanism analysis"):
    plot_entropy_boxplot(values_by_class, path, ylabel=ylabel, title=title)


def plot_saliency_overlay(image: np.ndarray, saliency: np.ndarray, path,
                          title="Saliency", alpha: float = 0.5):
    """Overlay a saliency/Grad-CAM map on a (3, H, W) or (H, W) image
    (the overlays of the reference's attention_utils.py:293-517)."""
    if image.ndim == 3:
        img = np.transpose(image, (1, 2, 0))
    else:
        img = image
    img = (img - img.min()) / (img.max() - img.min() + 1e-8)
    sal = (saliency - saliency.min()) / (saliency.max() - saliency.min() + 1e-8)
    if sal.shape != img.shape[:2]:
        from scipy.ndimage import zoom

        sal = zoom(sal, (img.shape[0] / sal.shape[0], img.shape[1] / sal.shape[1]),
                   order=1)
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.imshow(img if img.ndim == 3 else img, cmap=None if img.ndim == 3 else "gray")
    ax.imshow(sal, cmap="jet", alpha=alpha)
    ax.axis("off")
    ax.set_title(title)
    _save(fig, path)


def plot_saliency_grid(images: np.ndarray, saliencies: np.ndarray, path,
                       labels=None, preds=None, class_names=CLASS_NAMES,
                       max_cols: int = 4, title="Saliency grid"):
    """Grid of image+saliency overlays for a batch (the grids of the
    reference's attention_utils.py)."""
    n = min(len(images), max_cols * 2)
    cols = min(n, max_cols)
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(2.2 * cols, 2.4 * rows))
    axes = np.atleast_1d(axes).ravel()
    for i in range(n):
        img = np.transpose(images[i], (1, 2, 0)) if images[i].ndim == 3 else images[i]
        img = (img - img.min()) / (img.max() - img.min() + 1e-8)
        sal = saliencies[i]
        sal = (sal - sal.min()) / (sal.max() - sal.min() + 1e-8)
        axes[i].imshow(img)
        axes[i].imshow(sal, cmap="jet", alpha=0.45)
        axes[i].axis("off")
        if labels is not None:
            t = class_names[int(labels[i])]
            p = class_names[int(preds[i])] if preds is not None else "?"
            axes[i].set_title(f"T:{t} P:{p}", fontsize=7)
    for ax in axes[n:]:
        ax.axis("off")
    fig.suptitle(title)
    _save(fig, path)


def plot_watch_norms(norm_table: Dict[str, np.ndarray], path,
                     title="Per-layer gradient l2 over epochs",
                     log_scale: bool = True, max_layers: int = 40):
    """wandb.watch panel equivalent: one line per layer of the l2 (or any
    stat) trajectory from WatchAnalyzer.norm_table(). Layers are ranked by
    dynamic range so the most-moving ones stay visible when capped."""
    setup_academic_style()
    items = list(norm_table.items())
    if len(items) > max_layers:
        def span(v):
            v = np.asarray(v, dtype=np.float64)
            lo = max(float(v.min()), 1e-12)
            return float(v.max()) / lo
        items = sorted(items, key=lambda kv: -span(kv[1]))[:max_layers]
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for name, vals in sorted(items):
        ax.plot(np.arange(len(vals)), np.asarray(vals, dtype=np.float64),
                lw=1.0, alpha=0.8, label=name)
    if log_scale:
        ax.set_yscale("log")
    ax.set_xlabel("watch record")
    ax.set_ylabel("l2 norm")
    ax.set_title(title)
    if len(items) <= 12:
        ax.legend(fontsize=6, ncol=2)
    _save(fig, path)


def plot_watch_histogram_ridge(records: List[Dict], layer: str, path,
                               kind: str = "grad",
                               title: Optional[str] = None):
    """Histogram evolution of one layer across watched epochs (the wandb
    histogram-ridge panel): each record's fixed-bin counts drawn as a
    filled profile offset by epoch."""
    setup_academic_style()
    key = f"{kind}/{layer}"
    rows = [(rec.get("epoch", i), rec[key]) for i, rec in enumerate(records)
            if key in rec]
    fig, ax = plt.subplots(figsize=(7, 0.6 * max(len(rows), 2) + 1.5))
    for j, (epoch, entry) in enumerate(rows):
        counts = np.asarray(entry["counts"], dtype=np.float64)
        lo, hi = entry["edges"]
        centers = np.linspace(lo, hi, len(counts))
        peak = counts.max() if counts.max() > 0 else 1.0
        ax.fill_between(centers, j, j + 0.85 * counts / peak,
                        color="#0173B2", alpha=0.6, lw=0.5)
        ax.text(hi, j + 0.1, f"ep {int(epoch)}", fontsize=7, va="bottom")
    ax.set_yticks([])
    ax.set_xlabel("value")
    ax.set_title(title or f"{key} distribution over epochs")
    _save(fig, path)
