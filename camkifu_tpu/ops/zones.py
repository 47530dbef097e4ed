"""Intersection zone extraction + per-zone features.

Replaces the reference's per-intersection ``_getzone`` patch gather (SURVEY
§2.1 stonesfinder). Because the canonical warp places intersection (r, c) at
the center of cell (r, c), extracting all gsize² zones is a reshape/transpose
— zero gathers, fully fused by XLA.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from camkifu_tpu.config import cvconf, guiconf
from camkifu_tpu.ops.color import rgb_to_gray


def extract_zones(canonical: jnp.ndarray, gsize: int = guiconf.gsize,
                  zone: int = cvconf.zone_size) -> jnp.ndarray:
    """(S, S, C) canonical image → (gsize, gsize, zone, zone, C) patches."""
    c = canonical.shape[-1]
    z = canonical.reshape(gsize, zone, gsize, zone, c)
    return z.transpose(0, 2, 1, 3, 4)


def disc_mask(zone: int = cvconf.zone_size, radius_frac: float = 0.42
              ) -> np.ndarray:
    """(zone, zone) float mask ≈ the stone disc centered on the intersection.

    Returns numpy (a compile-time constant — jnp here would leak tracers
    when first evaluated inside a jit/scan trace).
    """
    r = np.arange(zone, dtype=np.float32) - (zone - 1) / 2.0
    yy, xx = np.meshgrid(r, r, indexing="ij")
    dist = np.sqrt(yy**2 + xx**2)
    return (dist <= radius_frac * zone).astype(np.float32)


def corner_indices(zone: int, frac: float = 0.36) -> np.ndarray:
    """Flat indices of the four corner patches of a zone (pixels with both
    |dx| and |dy| beyond frac·zone from the center) — bare wood at any stone
    density (stone discs and grid lines never reach them)."""
    r = np.arange(zone, dtype=np.float32) - (zone - 1) / 2.0
    far = np.abs(r) > frac * zone
    sel = far[:, None] & far[None, :]
    return np.nonzero(sel.reshape(-1))[0]


def bg_indices(gsize: int, zone: int, frac: float = 0.36) -> np.ndarray:
    """(g, g, n) flat zone-pixel indices for the background median.

    Interior zones use all four corner patches (see corner_indices); border
    zones swap each *outward-facing* patch for its inward mirror. With
    imperfect (auto-detected) corners, an edge zone's outward patch can fall
    past the board slab onto the table — the background median then flips to
    the table color and the whole border row reads as phantom stones. The
    indices are compile-time constants (numpy), so the take_along_axis they
    feed is a constant gather, not a per-frame-varying one.
    """
    r = np.arange(zone, dtype=np.float32) - (zone - 1) / 2.0
    far_lo = far_hi = np.abs(r) > frac * zone
    lo, hi = far_lo & (r < 0), far_hi & (r > 0)
    patch = {(sy, sx): np.nonzero((my[:, None] & mx[None, :]).reshape(-1))[0]
             for sy, my in ((0, lo), (1, hi)) for sx, mx in ((0, lo), (1, hi))}
    n = 4 * len(patch[0, 0])
    out = np.empty((gsize, gsize, n), np.int32)
    for i in range(gsize):
        for j in range(gsize):
            picks = []
            for sy in (0, 1):
                for sx in (0, 1):
                    y = 1 if (sy == 0 and i == 0) else \
                        0 if (sy == 1 and i == gsize - 1) else sy
                    x = 1 if (sx == 0 and j == 0) else \
                        0 if (sx == 1 and j == gsize - 1) else sx
                    picks.append(patch[y, x])
            out[i, j] = np.concatenate(picks)
    return out


def median_u8(x: jnp.ndarray) -> jnp.ndarray:
    """Last-axis median of float values in [0, 1], via radix select at
    uint8 resolution.

    jnp.median sorts, and sorts of many tiny rows were the most expensive
    op of the classify stage on the first accelerator this ran on; the
    premise is unmeasured on the GPU (ROADMAP C4). The values here come
    from uint8 frames, so an 8-bit binary search over the VALUE domain —
    eight compare+sum passes of plain elementwise work — selects the
    (lower) median exactly at 1/255 resolution. Ties/quantization shift the result by at
    most one 8-bit step, far below the ≳0.1 contrast thresholds the
    classifiers apply.
    """
    n = x.shape[-1]
    k = n // 2                                 # 0-indexed middle rank
    q = jnp.clip(x * 255.0, 0.0, 255.0).astype(jnp.int32)
    v = jnp.zeros(x.shape[:-1], jnp.int32)
    for bit in range(7, -1, -1):
        t = v + (1 << bit)
        cnt = jnp.sum(q < t[..., None], axis=-1)
        v = jnp.where(cnt <= k, t, v)
    return v.astype(jnp.float32) / 255.0


def _grid_median3(x: jnp.ndarray) -> jnp.ndarray:
    """3×3 neighborhood median over the leading (g, g) grid dims.

    The background field (wood tone × lighting) varies ~1–2% per cell, so a
    neighbor's background is a valid stand-in — while any single zone's
    corner-patch sample can be contaminated (a jittered corner stone's blur
    spill, an outward patch clipping the table under warp misalignment).
    The neighborhood median drops those point failures.
    """
    g0, g1 = x.shape[0], x.shape[1]
    pads = [(1, 1), (1, 1)] + [(0, 0)] * (x.ndim - 2)
    xp = jnp.pad(x, pads, mode="edge")
    stack = jnp.stack([xp[di:di + g0, dj:dj + g1]
                       for di in range(3) for dj in range(3)])
    return jnp.median(stack, axis=0)


def zone_stats(canonical: jnp.ndarray, gsize: int = guiconf.gsize,
               zone: int = cvconf.zone_size) -> dict:
    """Shared per-intersection statistics consumed by the stone classifiers.

    Computing these once per frame (instead of once per classifier) halves
    SfMeta's zone work: both SfClustering and SfContours need the zone
    extraction, the luma planes, and the corner-median backgrounds.

    Keys: luma (g,g,z,z); disc_mean_rgb, disc_med_rgb, bg_rgb (g,g,3);
    bg_luma, disc_med_luma (g,g).
    """
    zones = extract_zones(canonical, gsize, zone)            # (g,g,z,z,C)
    mask = disc_mask(zone)
    inv = 1.0 / jnp.maximum(mask.sum(), 1.0)
    c = zones.shape[-1]
    flat = zones.reshape(gsize, gsize, zone * zone, c)
    bg_idx = bg_indices(gsize, zone)                         # (g,g,n) const
    disc_idx = np.nonzero(np.asarray(mask).reshape(-1) > 0.5)[0]
    luma = rgb_to_gray(zones)                                # (g,g,z,z)
    luma_flat = luma.reshape(gsize, gsize, zone * zone)
    bg_px = jnp.take_along_axis(flat, bg_idx[..., None], axis=2)
    # All per-zone medians use the radix select (median_u8): jnp.median's
    # sorts dominated the whole classify stage (see median_u8 docstring).
    return {
        "zones": zones,
        "luma": luma,
        "disc_mean_rgb": jnp.einsum("ghyxc,yx->ghc", zones, mask,
                                    precision="highest") * inv,
        "bg_rgb": _grid_median3(median_u8(bg_px.transpose(0, 1, 3, 2))),
        "bg_luma": _grid_median3(median_u8(
            jnp.take_along_axis(luma_flat, bg_idx, axis=-1))),
        "disc_med_luma": median_u8(luma_flat[..., disc_idx]),
        "disc_med_rgb": median_u8(
            flat[:, :, disc_idx, :].transpose(0, 1, 3, 2)),
    }


def zone_features(canonical: jnp.ndarray, gsize: int = guiconf.gsize,
                  zone: int = cvconf.zone_size) -> jnp.ndarray:
    """Per-intersection feature vector for stone classification.

    Returns (gsize, gsize, 7) float32:
      0..2  disc-weighted mean R, G, B (where a stone would sit)
      3..5  annulus (outside-disc) mean R, G, B — local board background
      6     disc-weighted luma standard deviation (texture)

    disc − annulus is a per-channel local *contrast*, robust to lighting
    gradients across the board — the quantity the classifiers cluster on.
    (The reference samples a rectangular zone per intersection; the disc
    restriction is an implementation detail, not an API change.)
    """
    zones = extract_zones(canonical, gsize, zone)            # (g,g,z,z,C)
    mask = disc_mask(zone)                                   # (z,z)
    inv = 1.0 / jnp.maximum(mask.sum(), 1.0)
    mean_rgb = jnp.einsum("ghyxc,yx->ghc", zones, mask,
                          precision="highest") * inv
    # Background per channel: the median of the zone's *corner* pixels.
    # Ring means are contaminated by the stone's blurred edge; and on dense
    # boards even ring medians fail (most ring pixels are neighbor-stone
    # spill). Zone corners are the points farthest from the own stone AND
    # from all four neighbors, so they stay bare wood at any density, and
    # grid lines cross edge midpoints, not corners.
    c = zones.shape[-1]
    flat = zones.reshape(gsize, gsize, zone * zone, c)
    bg_idx = bg_indices(gsize, zone)
    bg_rgb = _grid_median3(jnp.median(
        jnp.take_along_axis(flat, bg_idx[..., None], axis=2), axis=2))
    luma = rgb_to_gray(zones)                                # (g,g,z,z)
    mean_luma = jnp.einsum("ghyx,yx->gh", luma, mask,
                           precision="highest") * inv
    var_luma = jnp.einsum("ghyx,yx->gh", luma**2, mask,
                          precision="highest") * inv - mean_luma**2
    std_luma = jnp.sqrt(jnp.maximum(var_luma, 0.0))
    return jnp.concatenate([mean_rgb, bg_rgb, std_luma[..., None]], axis=-1)
