"""SfContours — shape/contrast-based stone detection, works from move 1.

Parity: ``camkifu/stone/sf_contours.py`` (SURVEY §2.1) — the reference
thresholds an edge map, extracts contours near intersections, filters by
area/shape against the expected stone radius, and colors by mean intensity
vs board background. Strong early game (no cluster calibration needed),
weaker in clutter.

Device-first replacement with the same observable output (per-intersection
stone/no-stone + color): ``findContours``'s data-dependent tracing becomes a
dense per-zone *disc test* — threshold each zone's pixels against the local
annulus background, then require the active pixels to fill the stone disc
but not the surrounding ring (area + shape in one shot, no contour walk).
SURVEY §7 hard-part (a): parity is judged on moves, not intermediate bitmaps.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

import functools

from camkifu_tpu.config import cvconf, guiconf
from camkifu_tpu.ops.zones import disc_mask

EMPTY, BLACK, WHITE = 0, 1, 2


#: |luma − background| for a pixel to count as "stone-like".
PIXEL_CONTRAST = 0.13

#: Fraction of disc pixels that must be active to call a stone.
MIN_DISC_FILL = 0.60

#: Maximum fraction of ring (outside-disc) pixels active. A real stone plus
#: its blurred edge and neighbor-stone spill legitimately activates up to
#: ~2/3 of the ring; a full-zone occluder (hand, shadow blob) activates ~all
#: of it — that is what this rejects.
MAX_RING_FILL = 0.85

#: Ring fill below this carries no confidence penalty (the legitimate-spill
#: regime above); confidence then falls linearly to 0 at MAX_RING_FILL.
RING_OK_FILL = 0.66


def classify_canonical(canonical: jnp.ndarray, gsize: int = guiconf.gsize,
                       zone: int = cvconf.zone_size):
    """Canonical image (S, S, 3) in [0, 1] → (labels (g,g) int8, conf (g,g))."""
    from camkifu_tpu.ops.zones import zone_stats

    return classify_stats(zone_stats(canonical, gsize, zone), zone)


def classify_stats(stats: dict, zone: int = cvconf.zone_size):
    """Classify from shared zone statistics (ops.zones.zone_stats).

    Background = the median of the zone's *corner* pixels — the points
    farthest from the own stone and from all four neighbors, bare wood at
    any stone density (ring pixels are contaminated by the stone's blurred
    edge and neighbor-stone spill; grid lines cross edge midpoints, never
    corners). Measured on the adversarial sweep this beats
    3×3-neighborhood ring medians 0 vs 85 misreads.
    """
    disc = disc_mask(zone)                                 # (z,z)
    ring = 1.0 - disc
    ring_n = jnp.maximum(ring.sum(), 1.0)
    disc_n = jnp.maximum(disc.sum(), 1.0)
    # Max-channel contrast, not luma: a white stone on pale bamboo wood is
    # nearly luma-neutral (Δ≈0.12) but strongly blue-shifted (Δblue≈0.37);
    # a dark stone on dark walnut is the mirror case. Luma keeps only the
    # color *sign* (darker = black).
    med_diff = stats["disc_med_luma"] - stats["bg_luma"]   # (g, g), signed
    med_mag = jnp.abs(stats["disc_med_rgb"]
                      - stats["bg_rgb"]).max(axis=-1)      # (g, g)

    diff = stats["zones"] - stats["bg_rgb"][:, :, None, None, :]
    active = jnp.abs(diff).max(axis=-1) > PIXEL_CONTRAST   # (g,g,z,z)

    disc_fill = jnp.einsum("ghyx,yx->gh", active.astype(jnp.float32), disc,
                           precision="highest") / disc_n
    ring_fill = jnp.einsum("ghyx,yx->gh", active.astype(jnp.float32), ring,
                           precision="highest") / ring_n

    # Area + shape + contrast: the disc must be filled, the ring mostly not
    # (grid lines are a minority), and the disc *median* must genuinely
    # contrast with the background (kills line-crossing false positives).
    is_stone = (disc_fill > MIN_DISC_FILL) & (ring_fill < MAX_RING_FILL) \
        & (med_mag > PIXEL_CONTRAST)
    color = jnp.where(med_diff < 0, BLACK, WHITE).astype(jnp.int8)
    labels = jnp.where(is_stone, color, EMPTY).astype(jnp.int8)

    # Confidence: stones — how decisively the disc is filled and the ring is
    # not; empties — how inactive the disc is.
    conf_stone = jnp.clip((disc_fill - MIN_DISC_FILL) / (1 - MIN_DISC_FILL),
                          0, 1) * jnp.clip((MAX_RING_FILL - ring_fill)
                                           / (MAX_RING_FILL - RING_OK_FILL),
                                           0, 1)
    conf_empty = jnp.clip(1.0 - disc_fill / MIN_DISC_FILL, 0, 1)
    conf = jnp.where(is_stone, conf_stone, conf_empty)
    return labels, conf


classify_batch = jax.vmap(classify_canonical)


# ---------------------------------------------------------------------------
# Host finder class (cvconf-registered; SURVEY §2.1 sf_contours).
# ---------------------------------------------------------------------------

from camkifu_tpu.ops.warp import warp_batch_chunked, warp_batch_fixed  # noqa: E402
from camkifu_tpu.stone.stonesfinder import StonesFinder as _SF  # noqa: E402



@functools.partial(jax.jit, static_argnames=("gsize",))
def _read_batch_contours(fb, cs, gsize=guiconf.gsize, lens=None):
    with jax.default_matmul_precision("float32"):
        scale = 1.0 / 255.0 if fb.dtype == jnp.uint8 else 1.0
        if cs.ndim == 3:                      # per-frame corners (tracking)
            canon = warp_batch_chunked(fb, cs, gsize, lens=lens) * scale
        else:
            canon = warp_batch_fixed(fb, cs, gsize, lens=lens) * scale
        return jax.vmap(lambda c: classify_canonical(c, gsize))(canon)


class SfContours(_SF):
    """Contour-equivalent finder host: per-frame disc-test classification."""

    label = "contours"

    def _find(self, frames, corners):
        return _read_batch_contours(jnp.asarray(frames),
                                    jnp.asarray(corners, jnp.float32),
                                    gsize=self.gsize,
                                    lens=self._bf_lens())
