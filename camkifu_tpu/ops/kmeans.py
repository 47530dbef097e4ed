"""Fixed-iteration Lloyd k-means — replaces ``cv2.kmeans`` (SURVEY §2.3).

Device-first: no data-dependent convergence loop; a fixed number of Lloyd
iterations under ``lax.fori_loop`` with deterministic quantile init. For the
stone-classification use (k=3 over ≤361 samples of ≤5 features) this is a few
elementwise work and trivially vmaps over frames.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _init_by_luminance(x: jnp.ndarray, k: int, luma: jnp.ndarray) -> jnp.ndarray:
    """Deterministic init: centroids at evenly-spaced luminance quantiles."""
    order = jnp.argsort(luma)
    n = x.shape[0]
    qs = (jnp.arange(k, dtype=jnp.float32) + 0.5) / k
    idx = jnp.clip((qs * n).astype(jnp.int32), 0, n - 1)
    return x[order[idx]]


def kmeans(x: jnp.ndarray, k: int = 3, iters: int = 10,
           weights: jnp.ndarray | None = None,
           init: jnp.ndarray | None = None,
           luma: jnp.ndarray | None = None):
    """Lloyd k-means on x (N, F).

    weights: optional (N,) sample weights (0 excludes a sample — used to
    ignore agitated or off-board zones without dynamic shapes).
    init: optional (k, F) initial centroids; else luminance-quantile init
    (luma defaults to the first feature column).

    Returns (centroids (k, F), labels (N,) int32, compactness scalar).
    """
    x = x.astype(jnp.float32)
    n = x.shape[0]
    w = jnp.ones((n,), jnp.float32) if weights is None else weights.astype(jnp.float32)
    if init is None:
        lum = x[:, 0] if luma is None else luma
        init = _init_by_luminance(x, k, lum)

    def dists(c):
        # (N, k) squared distances.
        return jnp.sum((x[:, None, :] - c[None, :, :]) ** 2, axis=-1)

    def step(_, c):
        d = dists(c)
        assign = jax.nn.one_hot(jnp.argmin(d, axis=1), k, dtype=jnp.float32)
        assign = assign * w[:, None]
        counts = assign.sum(axis=0)                     # (k,)
        sums = jnp.matmul(assign.T, x, precision="highest")     # (k, F)
        new = sums / jnp.maximum(counts[:, None], 1e-6)
        # Keep empty clusters where they were.
        return jnp.where(counts[:, None] > 0.5, new, c)

    centroids = jax.lax.fori_loop(0, iters, step, init)
    d = dists(centroids)
    labels = jnp.argmin(d, axis=1).astype(jnp.int32)
    compactness = jnp.sum(jnp.min(d, axis=1) * w)
    return centroids, labels, compactness


def luminance_ordered_labels(centroids: jnp.ndarray, labels: jnp.ndarray,
                             luma_weights: jnp.ndarray) -> jnp.ndarray:
    """Relabel clusters so 0 = darkest (black), 1 = middle (board), 2 = brightest
    (white) — the reference's luminance ordering (SURVEY §2.1 sf_clustering).

    luma_weights: (F,) projection of a centroid onto luminance.
    """
    k = centroids.shape[0]
    luma = jnp.matmul(centroids, luma_weights, precision="highest")
    rank = jnp.argsort(jnp.argsort(luma))               # rank of each cluster
    return rank[labels].astype(jnp.int32)
