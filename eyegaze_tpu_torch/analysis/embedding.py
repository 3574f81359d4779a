"""Embedding projections: t-SNE, PCA, UMAP (host-side, scikit-learn).

The port's copy of ``eyegaze_tpu/analysis/embedding.py`` (the reference's
``5_Metrics/eeg_metrics.py:676-735`` and ``feature_extractors.py:404-521``):
perplexity clamped to N - 1, PCA init, UMAP optional.  scikit-learn is
imported inside ``pca_embed`` and ``tsne_embed``; where it is not installed
they raise an ``ImportError`` that names it.  ``umap_embed`` returns None
where umap-learn is not installed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _require_sklearn(what: str) -> None:
    try:
        import sklearn  # noqa: F401
    except ImportError as e:
        raise ImportError(f"{what} needs scikit-learn (sklearn), which is not installed here; "
                          "run the embedding stage where it is") from e


def pca_embed(features: np.ndarray, n_components: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """PCA projection; returns (embedded (N, k), explained_variance_ratio)."""
    _require_sklearn("pca_embed")
    from sklearn.decomposition import PCA

    pca = PCA(n_components=n_components)
    emb = pca.fit_transform(features)
    return emb, pca.explained_variance_ratio_


def tsne_embed(features: np.ndarray, n_components: int = 2, perplexity: float = 30.0,
               seed: int = 42) -> np.ndarray:
    """t-SNE with perplexity clamped to N - 1 and PCA init.  Degenerate
    inputs (N <= 2, where t-SNE is undefined and sklearn raises) give a zero
    embedding."""
    _require_sklearn("tsne_embed")
    from sklearn.manifold import TSNE

    n = len(features)
    if n <= 2:
        return np.zeros((n, n_components), dtype=np.float32)
    tsne = TSNE(n_components=n_components, perplexity=min(perplexity, n - 1), init="pca",
                random_state=seed)
    return tsne.fit_transform(features)


def umap_embed(features: np.ndarray, n_components: int = 2, n_neighbors: int = 15,
               seed: int = 42) -> Optional[np.ndarray]:
    """UMAP projection; None when umap-learn is not installed."""
    try:
        import umap  # type: ignore
    except ImportError:
        return None
    reducer = umap.UMAP(n_components=n_components,
                        n_neighbors=min(n_neighbors, max(len(features) - 1, 2)),
                        random_state=seed)
    return reducer.fit_transform(features)


def per_class_feature_stats(features: np.ndarray, labels: np.ndarray) -> dict:
    """Per-class mean / std / centroid distances (feature_extractors.py:404-521)."""
    classes = np.unique(labels)
    centroids = {int(c): features[labels == c].mean(axis=0) for c in classes}
    stats = {}
    for c in classes:
        f = features[labels == c]
        stats[int(c)] = {
            "count": len(f),
            "mean_norm": float(np.linalg.norm(f, axis=1).mean()),
            "intra_class_variance": float(((f - centroids[int(c)]) ** 2).sum(axis=1).mean()),
        }
    dists = {}
    for i in classes:
        for j in classes:
            if i < j:
                a, b = centroids[int(i)], centroids[int(j)]
                cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
                dists[f"{int(i)}-{int(j)}"] = {
                    "euclidean": float(np.linalg.norm(a - b)),
                    "cosine_similarity": cos,
                }
    return {"per_class": stats, "centroid_distances": dists}
