"""Edge detection: Sobel magnitude + non-maximum suppression + thresholding.

The Canny equivalent (SURVEY §2.3): cv2.Canny's data-dependent hysteresis
loop is replaced by NMS + double threshold + a fixed number of dilation
propagation steps (SURVEY §7 hard-part a) — static shapes, no sequential
region growing, same observable output for the Hough stage downstream.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from camkifu_tpu.ops.filters import gaussian_blur, sobel


def _shift2(img, dy, dx):
    return jnp.roll(jnp.roll(img, dy, axis=0), dx, axis=1)


def nms_magnitude(gx: jnp.ndarray, gy: jnp.ndarray) -> jnp.ndarray:
    """Gradient magnitude with non-maximum suppression along the gradient
    direction (quantized to 4 directions, as Canny does).

    The sector comes from |gy|/|gx| ratio comparisons against tan(22.5°)/
    tan(67.5°) and the sign of gx·gy — NOT arctan2: an accelerator's
    approximate transcendentals can flip the sector near a boundary and
    keep the wrong neighbors, while the ratio tests are exact in f32 on
    every backend.
    """
    import numpy as np

    mag = jnp.sqrt(gx * gx + gy * gy)
    t1, t2 = np.tan(np.pi / 8), np.tan(3 * np.pi / 8)
    ax, ay = jnp.abs(gx), jnp.abs(gy)
    sector = jnp.where(
        ay < t1 * ax, 0,
        jnp.where(ay > t2 * ax, 2,
                  jnp.where(gx * gy >= 0, 1, 3))).astype(jnp.int32)
    # Neighbor offsets for each sector: 0→E/W, 1→NE/SW, 2→N/S, 3→NW/SE.
    n1 = jnp.stack([_shift2(mag, 0, 1), _shift2(mag, 1, 1),
                    _shift2(mag, 1, 0), _shift2(mag, 1, -1)])
    n2 = jnp.stack([_shift2(mag, 0, -1), _shift2(mag, -1, -1),
                    _shift2(mag, -1, 0), _shift2(mag, -1, 1)])
    sel1 = jnp.take_along_axis(n1, sector[None], axis=0)[0]
    sel2 = jnp.take_along_axis(n2, sector[None], axis=0)[0]
    keep = (mag >= sel1) & (mag >= sel2)
    return jnp.where(keep, mag, 0.0)


def hysteresis(mag: jnp.ndarray, low: float, high: float,
               iters: int = 8) -> jnp.ndarray:
    """Double threshold + fixed-iteration strong-edge propagation: weak
    pixels survive if connected (8-neighborhood) to strong ones within
    ``iters`` dilation steps."""
    strong = mag >= high
    weak = mag >= low
    reach = strong
    for _ in range(iters):
        dil = reach
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    dil = dil | _shift2(reach, dy, dx)
        reach = dil & weak
    return jnp.where(reach | strong, mag, 0.0)


def _magnitude(gray: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Blur → Sobel → NMS magnitude of one 2D image. XLA fuses the
    shift-accumulate stencils into a few kernels on the GPU."""
    gx, gy = sobel(gaussian_blur(gray, sigma))
    return nms_magnitude(gx, gy)


def edge_map(gray: jnp.ndarray, sigma: float = 1.4,
             low_frac: float = 0.15, high_frac: float = 0.4,
             hysteresis_iters: int = 4) -> jnp.ndarray:
    """Full edge stack on a 2D gray image in [0, 1] → NMS edge magnitudes.

    Thresholds are fractions of the 99.5th-percentile magnitude (adaptive —
    cv2.Canny's absolute thresholds would be brittle across exposures).
    The ops carry the ``edge_map`` name scope (with ``magnitude``,
    ``percentile`` and ``hysteresis`` inside it in the batched path), which
    a profiler trace reduction matches.
    """
    with jax.named_scope("edge_map"):
        mag = _magnitude(gray, sigma)
        # Threshold percentile on a 2×-strided view, which quarters the
        # sort. The saving and the threshold shift it causes (the NMS field
        # is sparse, so the shift need not be small) are both unmeasured on
        # the GPU: ROADMAP C4.
        ref = jnp.percentile(mag[::2, ::2], 99.5)
        return hysteresis(mag, low_frac * ref, high_frac * ref,
                          hysteresis_iters)


def edge_map_batch(grays: jnp.ndarray, sigma: float = 1.4,
                   low_frac: float = 0.15, high_frac: float = 0.4,
                   hysteresis_iters: int = 4) -> jnp.ndarray:
    """``edge_map`` over a batch: (B, H, W) gray in [0, 1] → (B, H, W).

    Per-frame semantics are identical to the single-frame path (the
    percentile threshold adapts per frame, not over the batch).
    """
    with jax.named_scope("edge_map"):
        with jax.named_scope("magnitude"):
            mags = jax.vmap(lambda g: _magnitude(g, sigma))(grays)
        with jax.named_scope("percentile"):
            # Strided percentile — same rationale as edge_map's path.
            ref = jnp.percentile(mags[:, ::2, ::2], 99.5, axis=(1, 2))
        with jax.named_scope("hysteresis"):
            return jax.vmap(
                lambda m, r: hysteresis(m, low_frac * r, high_frac * r,
                                        hysteresis_iters))(mags, ref)
