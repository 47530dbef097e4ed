"""Camera frames of a Go board, drawn with numpy and scipy only.

Test and benchmark input that shares no code with the pipeline it feeds:
no cv2 (so it runs wherever JAX does) and no ``ops.warp`` (so a fault in the
device warp cannot hide behind the same fault in its input). The board is
drawn once per position on a canonical square — wood, anti-aliased grid
lines, star points and stones — and projected into each frame through the
homography of that frame's corners with ``scipy.ndimage.map_coordinates``,
over a table, with per-frame sensor noise.

Conventions match the pipeline's: (x, y) pixel coordinates with integer
coordinate i at the centre of pixel i; corners are the four corner
*intersections*, ordered top-left, top-right, bottom-right, bottom-left;
labels are 0 empty, 1 black, 2 white.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

# The camera view of the cv2 renderer (synth imports cv2 only inside the
# functions that draw).
from camkifu_tpu.utils.synth import default_corners  # noqa: F401

TABLE = (70.0, 75.0, 60.0)
WOOD = (214.0, 172.0, 108.0)
LINE = (40.0, 30.0, 20.0)
STONE = {1: (24.0, 24.0, 28.0), 2: (236.0, 236.0, 228.0)}

#: Stone radius and line half-width, in cells.
STONE_RADIUS = 0.47
LINE_HALF_WIDTH = 0.025


def zone_for(frame_hw, gsize: int = 19) -> int:
    """Canonical pixels per cell that roughly match the board's scale in a
    frame of this size (so the projection neither blurs nor aliases)."""
    return max(8, int(round(0.84 * min(frame_hw) / (gsize - 1))))


def homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """3×3 H with dst ~ H·src for four (x, y) point pairs (f64 DLT)."""
    a, b = [], []
    for (x, y), (u, v) in zip(np.asarray(src, np.float64),
                              np.asarray(dst, np.float64)):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b += [u, v]
    h = np.linalg.solve(np.array(a), np.array(b))
    return np.append(h, 1.0).reshape(3, 3)


def _coverage(dist: np.ndarray, half: float) -> np.ndarray:
    """Anti-aliased coverage of a shape whose edge lies ``half`` px from
    its centre line, given each pixel's distance to that line."""
    return np.clip(half + 0.5 - dist, 0.0, 1.0)


def canonical_board(labels: np.ndarray, zone: int) -> np.ndarray:
    """(g·zone, g·zone, 3) float32 image of the board with ``labels``.

    Intersection (r, c) sits at pixel ((c + 0.5)·zone − 0.5,
    (r + 0.5)·zone − 0.5); the wood reaches half a cell past the outer
    lines, like a real goban's margin.
    """
    g = labels.shape[0]
    s = g * zone
    p = np.arange(s, dtype=np.float32)
    lo, hi = zone / 2.0 - 0.5, s - zone / 2.0 - 0.5
    cell = (p + 0.5) / zone - 0.5                   # position in cells
    d_line = np.abs(cell - np.clip(np.round(cell), 0, g - 1)) * zone
    half = max(LINE_HALF_WIDTH * zone, 0.5)
    on = _coverage(d_line, half)                    # (s,) across the lines
    span = _coverage(np.maximum(lo - p, p - hi).clip(0.0), half)
    lines = np.maximum(on[None, :] * span[:, None], on[:, None] * span[None, :])

    img = np.empty((s, s, 3), np.float32)
    img[:] = WOOD
    img += lines[..., None] * (np.array(LINE, np.float32) - img)

    stars = [(r, c) for r in (3, g // 2, g - 4) for c in (3, g // 2, g - 4)] \
        if g == 19 else []
    yy, xx = np.mgrid[-zone:zone + 1, -zone:zone + 1].astype(np.float32)
    dist = np.sqrt(xx * xx + yy * yy)
    star = _coverage(dist, 0.12 * zone)
    stone = _coverage(dist, STONE_RADIUS * zone)
    for r in range(g):
        for c in range(g):
            cx = int(round((c + 0.5) * zone - 0.5))
            cy = int(round((r + 0.5) * zone - 0.5))
            y0, x0 = cy - zone, cx - zone
            ys = slice(max(y0, 0), min(cy + zone + 1, s))
            xs = slice(max(x0, 0), min(cx + zone + 1, s))
            py = slice(ys.start - y0, ys.stop - y0)
            px = slice(xs.start - x0, xs.stop - x0)
            lab = int(labels[r, c])
            if lab:
                color, alpha = np.array(STONE[lab], np.float32), stone[py, px]
            elif (r, c) in stars:
                color, alpha = np.array(LINE, np.float32), star[py, px]
            else:
                continue
            patch = img[ys, xs]
            patch += alpha[..., None] * (color - patch)
    return img


def render_frame(canon: np.ndarray, corners: np.ndarray, frame_hw,
                 gsize: int = 19, seed: int = 0,
                 noise: float = 3.0) -> np.ndarray:
    """Project the canonical board into an (H, W, 3) uint8 frame so that
    its corner intersections land on ``corners``; add gaussian sensor noise
    of std ``noise`` (grey levels) drawn from ``seed``."""
    h, w = frame_hw
    s = canon.shape[0]
    zone = s / gsize
    lo, hi = zone / 2.0 - 0.5, s - zone / 2.0 - 0.5
    src = np.array([[lo, lo], [hi, lo], [hi, hi], [lo, hi]], np.float64)
    hinv = np.linalg.inv(homography(src, corners))

    frame = np.empty((h, w, 3), np.float32)
    frame[:] = TABLE
    # Only the board's bounding box needs sampling: half a cell of margin
    # past the corner intersections, plus a pixel for the soft edge.
    margin = 0.5 * np.abs(np.diff(corners, axis=0)).max() / (gsize - 1) + 2
    x0, y0 = np.floor(corners.min(axis=0) - margin).astype(int)
    x1, y1 = np.ceil(corners.max(axis=0) + margin).astype(int)
    x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, w - 1), min(y1, h - 1)
    if x1 > x0 and y1 > y0:
        yy, xx = np.mgrid[y0:y1 + 1, x0:x1 + 1].astype(np.float64)
        q = hinv @ np.stack([xx.ravel(), yy.ravel(), np.ones(xx.size)])
        u = (q[0] / q[2]).reshape(xx.shape)
        v = (q[1] / q[2]).reshape(xx.shape)
        # Distance inside the slab edge, in canonical pixels (≈ frame px).
        inside = np.minimum.reduce([u + 0.5, s - 0.5 - u, v + 0.5,
                                    s - 0.5 - v])
        alpha = np.clip(inside + 0.5, 0.0, 1.0).astype(np.float32)
        box = frame[y0:y1 + 1, x0:x1 + 1]
        for ch in range(3):
            board = ndimage.map_coordinates(canon[..., ch], [v, u], order=1,
                                            mode="nearest")
            box[..., ch] += alpha * (board.astype(np.float32) - box[..., ch])
    rng = np.random.default_rng(seed)
    frame += rng.standard_normal((h, w, 3), np.float32) * np.float32(noise)
    return np.clip(np.rint(frame), 0, 255).astype(np.uint8)


def drifting_corners(base: np.ndarray, t: int, frame_hw) -> np.ndarray:
    """``base`` corners moved by a slow handheld drift at frame ``t``:
    a translation of up to ~1% of the frame height and a rotation of up to
    0.4° about the board's centre, smooth from frame to frame."""
    h = frame_hw[0]
    shift = np.array([0.008 * h * np.sin(t / 9.0),
                      0.006 * h * np.cos(t / 13.0)])
    th = np.deg2rad(0.4) * np.sin(t / 17.0)
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    c0 = base.mean(axis=0)
    return ((base - c0) @ rot.T + c0 + shift).astype(np.float32)
