"""Background model + agitation estimation (frame differencing).

Replaces the reference's ``absdiff`` / background-subtraction uses (SURVEY
§2.3): an exponential-moving-average luma background at reduced resolution,
and an "agitation" score = fraction of pixels changing — the gate that stops
stone reading while hands move over the board (SURVEY §3.3).
"""

from __future__ import annotations

import jax.numpy as jnp

from camkifu_tpu.config import cvconf


def downsample_luma(canonical_luma: jnp.ndarray, factor: int = 4) -> jnp.ndarray:
    """(S, S) luma → (S/f, S/f) by average pooling (exact reshape mean)."""
    s = canonical_luma.shape[0]
    d = s // factor
    return canonical_luma[:d * factor, :d * factor] \
        .reshape(d, factor, d, factor).mean(axis=(1, 3))


def robust_gain(x: jnp.ndarray, ref: jnp.ndarray, lo: float = 0.7,
                hi: float = 1.4, nbins: int = 128,
                floor: float = 0.05) -> jnp.ndarray:
    """Global exposure gain between two luma images: the histogram median
    of the per-pixel ratio x/ref.

    Auto-exposure steps — 10–20% of frame luma when a hand enters the
    scene, i.e. exactly when moves are played — are a multiplicative gain
    on the WHOLE frame; motion and stones are local. The median ratio
    recovers the gain as long as the changed pixels are a minority (<50%:
    hands, new stones, even a half-covered board), so consumers can remove
    it and see only local change.

    Device-shaped: a dense comparison histogram + cumsum — no sort, no
    scatter (jnp.median's sort over ~23k elements inside the per-frame
    vote scan would dominate it; see the radix-median precedent in
    ops.zones).
    """
    r = jnp.clip(x / jnp.maximum(ref, floor), lo, hi).reshape(-1)
    edges = jnp.linspace(lo, hi, nbins + 1, dtype=jnp.float32)
    hist = ((r[None, :] >= edges[:-1, None])
            & (r[None, :] < edges[1:, None])).sum(axis=1)
    # Clipping piles exact-lo/hi values on the boundary bins; the < test
    # drops exact-hi pixels, so count them into the last bin.
    hist = hist.at[-1].add((r >= hi).sum())
    half = 0.5 * r.shape[0]
    med_bin = jnp.argmax(jnp.cumsum(hist) >= half)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers[med_bin]


def agitation_score(luma_small: jnp.ndarray, bg: jnp.ndarray,
                    pixel_thresh: float = 0.08) -> jnp.ndarray:
    """Fraction of pixels whose |luma − background| exceeds pixel_thresh."""
    return (jnp.abs(luma_small - bg) > pixel_thresh).mean()


def update_background(bg: jnp.ndarray, luma_small: jnp.ndarray,
                      agitation: jnp.ndarray,
                      ema: float = cvconf.background_ema) -> jnp.ndarray:
    """EMA background update, slowed 10× while the scene is agitated.

    Slowed, not frozen: a full freeze deadlocks when the model initializes
    on an occluded scene (everything reads agitated forever, and a frozen
    background can never converge to open the gate); the slow leak lets any
    *persistent* scene become background within a few seconds while a hand
    sweeping for a moment still barely imprints."""
    rate = jnp.where(agitation > cvconf.agitation_threshold, 0.1 * ema, ema)
    return bg * (1.0 - rate) + luma_small * rate
