"""Agglomerative speaker clustering with speaker-count constraints (host).

Copied from ``modular_audio_pipeline_tpu/models/diarization/clustering.py``:
a raw-cosine homogeneity check (one speaker when the 90th percentile of
pairwise distances is under ``single_cutoff``), then average-linkage AHC
over per-recording standardised embeddings, cut at ``threshold`` and held
within ``[min_speakers, max_speakers]``; labels in order of first
appearance.
"""

from __future__ import annotations

import numpy as np
from scipy.cluster.hierarchy import fcluster, linkage

__all__ = ["cluster_embeddings"]


def _cosine_pdist(x: np.ndarray) -> np.ndarray:
    """Condensed cosine distances through one f32 Gram product."""
    xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    g = xn.astype(np.float32) @ xn.astype(np.float32).T
    n = len(x)
    out = np.empty(n * (n - 1) // 2, np.float64)
    pos = 0
    for i in range(n - 1):
        m = n - 1 - i
        out[pos : pos + m] = g[i, i + 1 :]
        pos += m
    np.subtract(1.0, out, out=out)
    return np.clip(out, 0.0, 2.0, out=out)


def cluster_embeddings(
    embeddings: np.ndarray,  # [N, D], unit-norm
    min_speakers: int = 1,
    max_speakers: int = 5,
    threshold: float = 1.0,
    single_cutoff: float = 0.10,
) -> np.ndarray:
    """Integer labels [N] in 0..n_clusters-1, by first appearance."""
    n = embeddings.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    if n == 1 or max_speakers <= 1:
        return np.zeros(n, dtype=np.int32)

    if min_speakers <= 1:
        # the p90 statistic is stable on a subsample of 1536
        if n > 1536:
            sub = embeddings[np.random.default_rng(0).choice(n, 1536, False)]
        else:
            sub = embeddings
        raw_dists = _cosine_pdist(sub.astype(np.float64))
        if np.percentile(raw_dists, 90) < single_cutoff:
            return np.zeros(n, dtype=np.int32)

    x = embeddings.astype(np.float64)
    x = (x - x.mean(axis=0)) / (x.std(axis=0) + 1e-8)
    x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-8)

    z = linkage(_cosine_pdist(x), method="average")
    labels = fcluster(z, t=threshold, criterion="distance")
    n_found = len(np.unique(labels))

    lo = max(1, min_speakers)
    hi = max(lo, max_speakers)
    if n_found < lo:
        labels = fcluster(z, t=min(lo, n), criterion="maxclust")
    elif n_found > hi:
        labels = fcluster(z, t=hi, criterion="maxclust")

    order: dict = {}
    out = np.empty(n, dtype=np.int32)
    for i, lab in enumerate(labels):
        if lab not in order:
            order[lab] = len(order)
        out[i] = order[lab]
    return out
