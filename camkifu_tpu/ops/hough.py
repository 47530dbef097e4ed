"""Hough line transform: top-K edge votes → (θ, ρ) accumulator → line peaks.

Replaces ``cv2.HoughLines`` (SURVEY §2.3). Device-first formulation:

- Static shapes: the K strongest edge pixels vote (jax.lax.top_k), not a
  data-dependent edge list (SURVEY §7 hard-part a).
- The scatter-accumulate becomes a batched one-hot matmul:
  votes[θ, ρ] = Σ_k w_k · splat(ρ_k(θ)), with the one-hot built in chunks so
  nothing big materializes. A scatter-add (atomics) accumulator may suit
  the GPU better if this stage ever shows in a trace (ROADMAP).
- Peak extraction: 2D NMS on the accumulator + top-N, returning (θ, ρ,
  vote) triples — fixed count, weak peaks padded with vote=0.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from camkifu_tpu.config import cvconf


def topk_edge_points(mag: jnp.ndarray, k: int = cvconf.hough_topk):
    """The K strongest edge pixels → (xy (K, 2) float32, weights (K,)).

    Zero-magnitude padding points get weight 0 (they vote nowhere).
    """
    h, w = mag.shape
    flat = mag.reshape(-1)
    vals, idx = jax.lax.top_k(flat, k)
    ys = (idx // w).astype(jnp.float32)
    xs = (idx % w).astype(jnp.float32)
    weights = (vals > 0).astype(jnp.float32) * jnp.sqrt(jnp.maximum(vals, 0.0))
    return jnp.stack([xs, ys], axis=-1), weights


@functools.partial(jax.jit, static_argnames=("n_theta", "n_rho", "chunk"))
def hough_accumulate(points: jnp.ndarray, weights: jnp.ndarray,
                     rho_max: float, n_theta: int = cvconf.hough_thetas,
                     n_rho: int = cvconf.hough_rhos, chunk: int = 16):
    """Vote K weighted points into an (n_theta, n_rho) accumulator.

    ρ(θ) = x·cosθ + y·sinθ ∈ [-rho_max, rho_max], bilinearly splatted into
    ρ bins. θ spans [0, π).
    """
    thetas = (jnp.arange(n_theta, dtype=jnp.float32) + 0.5) * (np.pi / n_theta)
    cos, sin = jnp.cos(thetas), jnp.sin(thetas)            # (T,)
    x, y = points[:, 0], points[:, 1]                       # (K,)

    rho_scale = (n_rho - 1) / (2.0 * rho_max)

    def one_chunk(t0):
        c = jax.lax.dynamic_slice(cos, (t0,), (chunk,))
        s = jax.lax.dynamic_slice(sin, (t0,), (chunk,))
        rho = x[None, :] * c[:, None] + y[None, :] * s[:, None]   # (chunk, K)
        pos = (rho + rho_max) * rho_scale                          # bin coords
        pos = jnp.clip(pos, 0.0, n_rho - 1.001)
        lo = jnp.floor(pos)
        frac = pos - lo
        # Bilinear splat as two one-hot matmuls:
        # acc[t, r] = Σ_k w_k [(1-frac) δ(r, lo) + frac δ(r, lo+1)]
        bins = jnp.arange(n_rho, dtype=jnp.float32)                # (R,)
        onehot_lo = (bins[None, None, :] == lo[..., None])
        onehot_hi = (bins[None, None, :] == (lo[..., None] + 1.0))
        wk = weights[None, :, None]
        contrib = onehot_lo * (1.0 - frac[..., None]) * wk \
            + onehot_hi * frac[..., None] * wk
        return contrib.sum(axis=1)                                 # (chunk, R)

    starts = jnp.arange(0, n_theta, chunk)
    acc = jax.lax.map(one_chunk, starts)                           # (T/c, c, R)
    return acc.reshape(n_theta, n_rho)


def peak_lines(acc: jnp.ndarray, rho_max: float, n_peaks: int = 32,
               nms_size: int = 5, min_frac: float = 0.15):
    """NMS peaks of the accumulator → (theta (N,), rho (N,), votes (N,)).

    θ in radians [0, π), ρ in pixels. Sub-bin refinement by parabolic fit in
    ρ. Peaks under min_frac·max get votes=0 (padding).
    """
    n_theta, n_rho = acc.shape
    # Smooth lightly in rho to merge adjacent-bin splat mass.
    sm = 0.25 * jnp.roll(acc, 1, axis=1) + 0.5 * acc \
        + 0.25 * jnp.roll(acc, -1, axis=1)

    # θ wraps (θ=π-ε is adjacent to θ=0 with ρ→-ρ); pad with the wrapped,
    # ρ-flipped copies so border peaks are NMS'd correctly.
    r = nms_size // 2
    top_pad = jnp.flip(sm[-r:], axis=1)
    bot_pad = jnp.flip(sm[:r], axis=1)
    padded = jnp.concatenate([top_pad, sm, bot_pad], axis=0)
    win = jax.lax.reduce_window(
        padded, -jnp.inf, jax.lax.max,
        (nms_size, nms_size), (1, 1), "SAME")[r:r + n_theta]
    is_peak = (sm >= win) & (sm >= min_frac * sm.max())
    peak_vals = jnp.where(is_peak, sm, 0.0).reshape(-1)

    vals, idx = jax.lax.top_k(peak_vals, n_peaks)
    ti = idx // n_rho
    ri = idx % n_rho

    # Parabolic sub-bin ρ refinement.
    rm1 = sm[ti, jnp.clip(ri - 1, 0, n_rho - 1)]
    rp1 = sm[ti, jnp.clip(ri + 1, 0, n_rho - 1)]
    r0 = sm[ti, ri]
    denom = rm1 - 2 * r0 + rp1
    delta = jnp.where(jnp.abs(denom) > 1e-6,
                      0.5 * (rm1 - rp1) / denom, 0.0)
    delta = jnp.clip(delta, -0.5, 0.5)

    theta = (ti.astype(jnp.float32) + 0.5) * (np.pi / n_theta)
    rho_bin = ri.astype(jnp.float32) + delta
    rho = rho_bin * (2.0 * rho_max) / (n_rho - 1) - rho_max
    return theta, rho, vals


def hough_lines(mag: jnp.ndarray, k: int = cvconf.hough_topk,
                n_theta: int = cvconf.hough_thetas,
                n_rho: int = cvconf.hough_rhos, n_peaks: int = 32):
    """Edge-magnitude map → top line peaks (theta, rho, votes)."""
    h, w = mag.shape
    rho_max = float(np.hypot(h, w))
    pts, wts = topk_edge_points(mag, k)
    acc = hough_accumulate(pts, wts, rho_max, n_theta, n_rho)
    return peak_lines(acc, rho_max, n_peaks)
