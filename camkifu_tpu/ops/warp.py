"""Perspective rectification: DLT homography + batched bilinear inverse warp.

Replaces ``cv2.getPerspectiveTransform`` + ``cv2.warpPerspective`` (SURVEY
§2.3). Device-first design: one 8×8 linear solve per frame (tiny, batched with
vmap), then a dense inverse-warp bilinear gather producing the canonical
board image — static shapes, fully fused under jit.

Coordinate convention: **OpenCV's** — integer coordinate i is the center of
pixel i (so array index == coordinate). All corners flowing through the
system (manual clicks, auto-detected, synthetic ground truth) use it.

Canonical geometry (see cvconf): the four *corner intersections* of the
goban map to the centers of the four corner cells, so intersection (r, c)
sits at canonical coordinate (x, y) = ((c + 0.5) z - 0.5, (r + 0.5) z - 0.5)
— the exact center of the z-wide index block [rz, rz+z) — and zone
extraction is a pure reshape downstream.

Corners are (4, 2) float arrays of (x, y) image coordinates ordered
top-left, top-right, bottom-right, bottom-left (the reference's GobanCorners
convex-hull ordering — SURVEY §2.1 boardfinder).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from camkifu_tpu.config import cvconf, guiconf
from camkifu_tpu.ops.lens import Lens, distort_pts, undistort_pts

#: Full-f32 products for the geometry: a reduced default (TF32 on the GPU)
#: would put pixel-scale error into every homography.
_EXACT = jax.lax.Precision.HIGHEST


def canonical_corners(gsize: int = guiconf.gsize,
                      zone: int = cvconf.zone_size) -> jnp.ndarray:
    """Canonical (x, y) targets of the 4 corner intersections, tl/tr/br/bl."""
    lo = zone / 2.0 - 0.5
    hi = gsize * zone - zone / 2.0 - 0.5
    return jnp.array([[lo, lo], [hi, lo], [hi, hi], [lo, hi]],
                     dtype=jnp.float32)


def _normalizer(pts: jnp.ndarray) -> jnp.ndarray:
    """Hartley normalization transform: centroid → origin, RMS radius → √2.

    Keeps the 8×8 DLT system well-conditioned in float32 (the pipeline runs
    without f64); without it, pixel-scale coordinates lose ~1 px of accuracy.
    """
    mean = pts.mean(axis=0)
    rms = jnp.sqrt(jnp.mean(jnp.sum((pts - mean) ** 2, axis=-1)))
    s = jnp.sqrt(2.0) / jnp.maximum(rms, 1e-6)
    zero = jnp.zeros((), jnp.float32)
    one = jnp.ones((), jnp.float32)
    return jnp.stack([
        jnp.stack([s, zero, -s * mean[0]]),
        jnp.stack([zero, s, -s * mean[1]]),
        jnp.stack([zero, zero, one]),
    ])


def _solve8(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Unrolled 8×8 Gauss–Jordan solve with partial pivoting.

    jnp.linalg.solve lowers to LU with sequential dynamic slicing, which
    dominated per-frame homography solves on the first accelerator this ran
    on; eight unrolled elimination steps of pure vector ops vmap cleanly.
    Whether the hand-unrolled solve still pays on the GPU is unmeasured
    (ROADMAP C4).
    """
    M = jnp.concatenate([A, b[:, None]], axis=1)        # (8, 9)
    for k in range(8):
        col = jnp.abs(M[:, k])
        mask = jnp.arange(8) >= k
        p = jnp.argmax(jnp.where(mask, col, -1.0))
        # Swap rows k and p (gather-free: blend two one-hot selections).
        rk = M[k]
        rp = M[p]
        idx = jnp.arange(8)[:, None]
        M = jnp.where(idx == k, rp[None, :],
                      jnp.where(idx == p, rk[None, :], M))
        pivot = M[k, k]
        Mk = M[k] / pivot
        factors = jnp.where(jnp.arange(8) == k, 0.0, M[:, k])
        M = M - factors[:, None] * Mk[None, :]
        M = M.at[k].set(Mk)
    return M[:, 8]


def _inv3(M: jnp.ndarray) -> jnp.ndarray:
    """Closed-form 3×3 inverse (adjugate) — no LU call for a tiny system."""
    a, b, c = M[0, 0], M[0, 1], M[0, 2]
    d, e, f = M[1, 0], M[1, 1], M[1, 2]
    g, h, i = M[2, 0], M[2, 1], M[2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    return jnp.stack([jnp.stack([A, B, C]),
                      jnp.stack([D, E, F]),
                      jnp.stack([G, H, I])]) / det


def homography_dlt(src: jnp.ndarray, dst: jnp.ndarray) -> jnp.ndarray:
    """3×3 homography H with dst ~ H @ src for 4 point pairs (DLT, exact).

    src, dst: (4, 2) float (x, y). Hartley-normalizes both point sets, solves
    the 8×8 system with h33=1, then denormalizes.
    """
    src = src.astype(jnp.float32)
    dst = dst.astype(jnp.float32)
    t_src = _normalizer(src)
    t_dst = _normalizer(dst)
    src = apply_homography(t_src, src)
    dst = apply_homography(t_dst, dst)
    x, y = src[:, 0], src[:, 1]
    u, v = dst[:, 0], dst[:, 1]
    zeros = jnp.zeros_like(x)
    ones = jnp.ones_like(x)
    # Rows for u: [x y 1 0 0 0 -ux -uy], rows for v: [0 0 0 x y 1 -vx -vy]
    a_u = jnp.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], axis=1)
    a_v = jnp.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], axis=1)
    A = jnp.concatenate([a_u, a_v], axis=0)          # (8, 8)
    b = jnp.concatenate([u, v], axis=0)              # (8,)
    h = _solve8(A, b)
    Hn = jnp.concatenate([h, jnp.ones((1,), h.dtype)]).reshape(3, 3)
    H = jnp.matmul(jnp.matmul(_inv3(t_dst), Hn, precision=_EXACT), t_src,
                   precision=_EXACT)
    return H / H[2, 2]


def apply_homography(H: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply 3×3 H to (..., 2) points (x, y)."""
    xy1 = jnp.concatenate([pts, jnp.ones(pts.shape[:-1] + (1,), pts.dtype)],
                          axis=-1)
    out = jnp.matmul(xy1, H.T, precision=_EXACT)
    return out[..., :2] / out[..., 2:3]


def bilinear_sample(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray,
                    ) -> jnp.ndarray:
    """Sample img (H, W, C) at float coords; out-of-bounds clamps to edge.

    x, y: any matching shape. Returns shape x.shape + (C,), float32.
    """
    h, w = img.shape[0], img.shape[1]
    x = jnp.clip(x, 0.0, w - 1.0)
    y = jnp.clip(y, 0.0, h - 1.0)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)
    # Gather in the source dtype and convert only the taps: converting the
    # whole frame first would materialize a 4× f32 copy of every frame in
    # device memory (24 MB at 1080p) just to read ~4 taps per canonical pixel.
    p00 = img[y0, x0].astype(jnp.float32)
    p01 = img[y0, x1].astype(jnp.float32)
    p10 = img[y1, x0].astype(jnp.float32)
    p11 = img[y1, x1].astype(jnp.float32)
    fx = fx[..., None]
    fy = fy[..., None]
    top = p00 * (1 - fx) + p01 * fx
    bot = p10 * (1 - fx) + p11 * fx
    return top * (1 - fy) + bot * fy


def warp_to_canonical(frame: jnp.ndarray, corners: jnp.ndarray,
                      gsize: int = guiconf.gsize,
                      zone: int = cvconf.zone_size,
                      lens: Lens | None = None) -> jnp.ndarray:
    """Rectify one frame (H, W, C) to the canonical (gsize*zone)² board image.

    ``corners``: (4, 2) image (x, y) of the goban's corner intersections,
    ordered tl/tr/br/bl. Inverse warp: for each canonical pixel, map through
    the canonical→image homography and bilinear-sample the source frame —
    the gather-friendly direction (no scatter).

    ``lens``: optional radial model (ops/lens.py). Corners stay RAW frame
    coordinates; the homography is built against their pinhole positions
    and the sample grid is distorted back before the gather — same gather,
    lens-corrected geometry, zero extra device-memory traffic.
    """
    size = gsize * zone
    pin = undistort_pts(lens, corners.astype(jnp.float32))
    H = homography_dlt(canonical_corners(gsize, zone), pin)
    # Every canonical pixel center (cv2 convention: index == coordinate).
    us = jnp.arange(size, dtype=jnp.float32)
    uu, vv = jnp.meshgrid(us, us, indexing="xy")        # (size, size)
    src = apply_homography(H, jnp.stack([uu, vv], axis=-1))
    src = distort_pts(lens, src)
    return bilinear_sample(frame, src[..., 0], src[..., 1])


def warp_batch(frames: jnp.ndarray, corners: jnp.ndarray,
               gsize: int = guiconf.gsize,
               zone: int = cvconf.zone_size,
               lens: Lens | None = None) -> jnp.ndarray:
    """(B, H, W, C) frames + (B, 4, 2) per-frame corners → (B, S, S, C)."""
    return jax.vmap(lambda f, c: warp_to_canonical(f, c, gsize, zone, lens))(
        frames, corners)


def warp_batch_fixed(frames: jnp.ndarray, corners: jnp.ndarray,
                     gsize: int = guiconf.gsize,
                     zone: int = cvconf.zone_size,
                     lens: Lens | None = None) -> jnp.ndarray:
    """(B, H, W, C) frames + one fixed (4, 2) corner set → (B, S, S, C)."""
    return jax.vmap(
        lambda f: warp_to_canonical(f, corners, gsize, zone, lens))(frames)


def _subpixel_shift(img: jnp.ndarray, offset: jnp.ndarray) -> jnp.ndarray:
    """Translate (S, S, C) content by −offset (offset = (dx, dy) float,
    clamped to ±2 px).

    Implemented as a blend of the 16 *static* integer shifts with per-frame
    bilinear hat weights (at most 4 are nonzero). Static slices vectorize
    across a vmapped batch; per-frame `dynamic_slice` starts would lower to
    a batched gather with per-frame indices, the shape the chunked warp
    exists to avoid.
    """
    s = img.shape[0]
    pad = jnp.pad(img, ((2, 2), (2, 2), (0, 0)), mode="edge")
    dx = jnp.clip(offset[0], -2.0, 1.999)
    dy = jnp.clip(offset[1], -2.0, 1.999)
    out = jnp.zeros_like(img)
    for iy in range(4):
        wy = jnp.maximum(0.0, 1.0 - jnp.abs((2.0 + dy) - iy))
        for ix in range(4):
            wx = jnp.maximum(0.0, 1.0 - jnp.abs((2.0 + dx) - ix))
            out = out + (wy * wx) * pad[iy:iy + s, ix:ix + s, :]
    return out


def warp_batch_chunked(frames: jnp.ndarray, corners: jnp.ndarray,
                       gsize: int = guiconf.gsize,
                       zone: int = cvconf.zone_size,
                       chunk: int = 8,
                       lens: Lens | None = None) -> jnp.ndarray:
    """Per-frame corners with batch-shared gathers: share the (median)
    corners within small frame chunks so the gather keeps batch-shared
    indices, then correct each frame's residual camera motion with a
    subpixel *translation*.

    On the first accelerator this ran on, XLA gathers vectorized across the
    batch only when every batch element used the *same* indices, and
    per-frame indices fell off a cliff. Whether a vmapped per-frame gather
    is slower on the GPU is unmeasured (ROADMAP C3). The within-chunk
    camera motion is removed per frame by shifting the canonical image by
    the mean corner displacement. Residual non-translational error is a
    small fraction of a pixel for handheld footage.
    """
    b = frames.shape[0]
    pad = (-b) % chunk
    if pad:
        frames = jnp.concatenate([frames, frames[-1:].repeat(pad, axis=0)])
        corners = jnp.concatenate([corners, corners[-1:].repeat(pad, axis=0)])
    k = frames.shape[0] // chunk
    fc = frames.reshape((k, chunk) + frames.shape[1:])
    cb = corners.reshape(k, chunk, 4, 2)
    cc = jnp.median(cb, axis=1)                          # (k, 4, 2)
    ideal = canonical_corners(gsize, zone)               # (4, 2)

    def body(_, x):
        fr, true_corners, co = x
        canon = jax.vmap(
            lambda z: warp_to_canonical(z, co, gsize, zone, lens))(fr)
        # Where each frame's true corners land in the chunk's canonical
        # view; their mean displacement from the ideal anchors is the
        # residual camera translation. Both corner sets are raw frame
        # coords — undistort before applying the pinhole homography.
        h_inv = _inv3(homography_dlt(ideal, undistort_pts(lens, co)))
        landed = jax.vmap(
            lambda c: apply_homography(h_inv, undistort_pts(lens, c)))(
                true_corners)
        offsets = (landed - ideal[None]).mean(axis=1)    # (chunk, 2) = (dx,dy)
        canon = jax.vmap(_subpixel_shift)(canon, offsets)
        return None, canon

    _, out = jax.lax.scan(body, None, (fc, cb, cc))
    out = out.reshape((k * chunk,) + out.shape[2:])
    return out[:b]
