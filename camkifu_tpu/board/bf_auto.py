"""BoardFinderAuto — automatic goban localization.

Parity: ``camkifu/board/bf_auto.py`` (SURVEY §2.1/§3.2) — grayscale → blur →
Canny → contour/Hough analysis → corner candidates, accumulated over rounds
and committed when stable. Device-first: the contour walk is replaced by Hough
line families (SURVEY §2.3: "quad fitting from Hough peaks … same observable
output: 4 corners"):

1. downscale gray frame to a square detection resolution;
2. edge map (ops.edges) → top-K votes → (θ, ρ) accumulator (ops.hough);
3. find the two dominant, roughly-perpendicular θ families; within each, the
   *extreme* strong lines (min/max center-signed ρ) bound the board slab —
   their 4 intersections are a coarse board quadrilateral;
4. **grid refinement**: rectify the frame by the coarse quad, project edge
   energy onto each axis, and fit a 19-tooth comb (offset + spacing search)
   to the 1D profiles — grid lines are axis-aligned after rectification, so
   this pins the *outer grid line* positions to sub-pixel without any
   data-dependent contour walk; map the 4 outer-grid intersections back
   through the rectifying homography. Iterated twice.
5. temporal stabilization: median over a batch (fixed camera) or EMA + crude
   outlier rejection across frames (handheld, BASELINE config 4).

Output corners are ordered tl/tr/br/bl in full-frame pixel coordinates and
are the goban's corner *intersections* (the canonical warp's anchors).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from camkifu_tpu.config import cvconf
from camkifu_tpu.ops.color import rgb_to_gray, rgb_to_gray_u8, to_float
from camkifu_tpu.ops.edges import edge_map, edge_map_batch
from camkifu_tpu.ops.filters import sobel
from camkifu_tpu.ops.hough import hough_accumulate, topk_edge_points
from camkifu_tpu.ops.lens import (Lens, distort_pts, make_lens,
                                  undistort_frame, undistort_pts)
from camkifu_tpu.ops.warp import (_EXACT, apply_homography,
                                  bilinear_sample, homography_dlt,
                                  _subpixel_shift)

#: Angular half-window (radians) around a family's dominant θ.
FAMILY_WINDOW = np.pi / 8

#: A line must carry at least this fraction of its family's best vote to be
#: eligible as a board edge. Low on purpose: on dense boards the stone rows
#: vote far harder than the slab edges, and perspective weakens the far
#: edge — the tight FAMILY_WINDOW + peak NMS do the noise rejection.
MIN_LINE_STRENGTH = 0.12

#: Rectification resolution for the grid-comb refinement.
REFINE_RES = 320


def _angdiff(a, b):
    """Angular distance on the line-orientation circle (period π)."""
    d = jnp.abs(a - b) % np.pi
    return jnp.minimum(d, np.pi - d)


def _line_intersection(t1, r1, t2, r2):
    """Intersection of x·cosθ + y·sinθ = ρ pairs → (x, y)."""
    det = jnp.cos(t1) * jnp.sin(t2) - jnp.sin(t1) * jnp.cos(t2)
    det = jnp.where(jnp.abs(det) < 1e-9, 1e-9, det)
    x = (r1 * jnp.sin(t2) - r2 * jnp.sin(t1)) / det
    y = (r2 * jnp.cos(t1) - r1 * jnp.cos(t2)) / det
    return x, y


def _order_quad(pts_xy: jnp.ndarray) -> jnp.ndarray:
    """Order 4 points tl/tr/br/bl (image y grows downward)."""
    ctr = pts_xy.mean(axis=0)
    ang = jnp.arctan2(pts_xy[:, 1] - ctr[1], pts_xy[:, 0] - ctr[0])
    ordered = pts_xy[jnp.argsort(ang)]
    roll = jnp.argmin(ordered.sum(axis=1))
    ordered = jnp.roll(ordered, -roll, axis=0)
    flipped = ordered[jnp.array([0, 3, 2, 1])]
    return jnp.where(ordered[1, 0] >= ordered[3, 0], ordered, flipped)


def _box_blur(img: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Separable box filter via cumulative sums (O(n), any radius)."""
    def along(a, axis):
        c = jnp.cumsum(a, axis=axis)
        n = a.shape[axis]
        pad = [(0, 0), (0, 0)]
        pad[axis] = (radius + 1, radius)
        cp = jnp.pad(c, pad, mode="edge")
        # window sum = c[i+r] - c[i-r-1]
        hi = jax.lax.slice_in_dim(cp, 2 * radius + 1, 2 * radius + 1 + n,
                                  axis=axis)
        lo = jax.lax.slice_in_dim(cp, 0, n, axis=axis)
        return (hi - lo) / (2 * radius + 1)
    return along(along(img, 0), 1)


#: Clutter-defense component merge: keep connected dense components at
#: least this fraction of the largest one's size. 1.0 would reproduce the
#: r4 largest-only rule (drops crack-fragments of the board itself);
#: near-0 disables the defense. Calibration (r5): board crack-fragments
#: measure ≥0.63 of their sibling, clutter (capture bowls, mug) ≤0.13 of
#: the smallest board fragment.
CLUTTER_COMP_KEEP = 0.30


def _coarse_quad(gray_small: jnp.ndarray,
                 chroma_small: jnp.ndarray | None = None):
    """Edge-density board-region quadrilateral on the detection-res gray.

    The board is the region dense in edges (grid lines and/or stones) against
    a quiet table; its four extreme points along the ±45° projections are the
    slab corners. This replaces the reference's findContours board-outline
    walk with dense ops (SURVEY §2.3) and is stone-density-agnostic — Hough
    line extremes fail on full boards where stone rows out-vote slab edges.

    ``chroma_small`` (same res, an R−B opponent channel) contributes a second
    edge map, union-merged after per-channel normalization: dark woods
    (walnut) can have near-zero *luma* contrast against the table and heavily
    attenuated far-corner grid lines, yet stay strongly separated in chroma —
    wood is the reddest surface in the scene. cv2.Canny-on-gray (the
    reference, SURVEY §2.3) misses these boards entirely.

    Returns (quad (4, 2) in detection-res coords, score); score < ~0.1 means
    "no board found".
    """
    mag = edge_map(gray_small)
    mag_c = edge_map(chroma_small) if chroma_small is not None else None
    return _coarse_from_mag(mag, mag_c)


def _coarse_from_mag(mag: jnp.ndarray, mag_c: jnp.ndarray | None):
    """The dense post-edge half of ``_coarse_quad``: edge maps → (quad,
    score). Pure jnp on fixed shapes — vmappable, so the batched detection
    stage 1 reuses it verbatim (``_detect_prepare_batch``)."""
    res = mag.shape[0]
    if mag_c is not None:
        # Union in per-channel-normalized units: luma and chroma gradient
        # amplitudes are not comparable (different dynamic ranges), but each
        # edge_map is already thresholded relative to its own 99.5th pctl.
        # Strided percentiles quarter the sort; the union only needs
        # per-channel scale factors. Whether the saving matters on the GPU
        # is unmeasured (ROADMAP C4).
        mag = jnp.maximum(
            mag / jnp.maximum(jnp.percentile(mag[::2, ::2], 99.5), 1e-6),
            mag_c / jnp.maximum(jnp.percentile(mag_c[::2, ::2], 99.5),
                                1e-6))
    density = _box_blur((mag > 0).astype(jnp.float32), radius=7)
    mask = density > 0.06

    # Clutter defense (tier-3 hazard, r4): the extreme-point hull below is
    # inflatable by ANY dense off-board object (capture bowls full of
    # stone-like discs, a bright mug — measured: coarse corner dragged
    # 300+ px to a bowl at the frame edge). Keep only the dominant
    # connected dense region: seed at the densest point of the heavily
    # eroded mask (erosion kills bowl-sized blobs, so the seed provably
    # lands on the board — calibrated over clutter/clean/defocused-empty/
    # walnut-hard scenes), then flood-fill through the mask by iterated
    # masked dilation. Falls back to the full mask when the flood covers
    # too little of it (a fragmented sparse board) — the exact pre-r4
    # behavior.
    # Select the LARGEST connected dense component, with no seed heuristic:
    # a seeded flood was tried and failed twice — seeding at the densest
    # eroded point lands on a capture bowl FULL of stones (denser than a
    # crowded walnut board), and a radius-3 flood bridges the ≤3 px gap
    # between the board's halo and adjacent clutter. Instead: iterated
    # max-pool label propagation (each component converges to its max
    # linear index) on a 2-px-ERODED core — erosion widens every
    # inter-object gap past the 5×5 propagation window while the board's
    # own halo band (≥14 px thick, the radius-7 blur) survives — then a
    # scatter-add sizes the components and the biggest one wins. The
    # propagation count covers the longest in-core path, which on sparse
    # boards runs around the slab rim (the interior can be disconnected
    # islands; 96 steps once left the far corner unreached).
    # Labels propagate at HALF resolution: min-pool 2×2 of the core (gaps
    # can only widen — no false bridging; the board's ≥10 px core band
    # survives), which quarters the per-step cost and halves the path
    # length, so 256 5×5 steps (reach 512) cover the longest rim path
    # (≤ ~420 at 128² — a full-res budget of 768 was measured SHORT of a
    # rotated board's ~840 px rim and returned a fragment of the board).
    core = _box_blur(mask.astype(jnp.float32), 2) > 0.999
    h2 = res // 2
    core2 = core[:h2 * 2, :h2 * 2].reshape(h2, 2, h2, 2).all(axis=(1, 3))
    idx0 = jnp.arange(1, h2 * h2 + 1, dtype=jnp.int32).reshape(h2, h2)
    ids0 = jnp.where(core2, idx0, 0)

    def _prop(_, ids):
        m = jax.lax.reduce_window(ids, jnp.int32(0), jax.lax.max,
                                  (5, 5), (1, 1), "SAME")
        return jnp.where(core2, m, 0)

    # Step budget scales with the half-res grid: each 5×5 step advances
    # labels ≤2 px, and the longest in-core path (a sparse board's rim)
    # measures ~3.3·h2 (≈420 at h2=128). A FIXED 256 was correct at the
    # runtime res (256→h2=128) but non-convergent at the k1-calibration
    # res (512→h2=256, rim ~840): one connected board left as several
    # same-component label islands, which the r4 largest-only rule then
    # silently cropped (masked at 256 by the islands' overlap, measurable
    # at 512 as a k1-grid misstep — r5 lens_e2e regression).
    ids = jax.lax.fori_loop(0, 2 * h2, _prop, ids0)
    sizes = jnp.zeros((h2 * h2 + 1,), jnp.int32) \
        .at[ids.reshape(-1)].add(core2.reshape(-1).astype(jnp.int32)) \
        .at[0].set(0)
    best = jnp.argmax(sizes)
    # Keep every component within CLUTTER_COMP_KEEP of the largest, not
    # just the winner: the eroded core of ONE board can crack in two
    # (measured r5, gauntlet-13 post-bump: rotation ~9° + glare over the
    # stone-free half split the board into 1386 + 871 px² fragments; the
    # largest-only rule returned the left fragment and the coarse corner
    # collapsed 8.9 cells with a CONFIDENT score). Board fragments are the
    # same order of size as each other, while clutter is an order smaller
    # (bowls/mug measured ≤13% of the smallest board fragment across the
    # clutter calibration scenes), so a size-ratio gate separates
    # crack-fragments from genuinely foreign objects.
    keep2 = (ids > 0) & (sizes[ids] >= CLUTTER_COMP_KEEP * sizes[best])
    comp = jnp.repeat(jnp.repeat(keep2, 2, axis=0), 2, axis=1)
    comp = jnp.pad(comp, ((0, res - h2 * 2), (0, res - h2 * 2)))
    # Restore the guard ring lost to erosion + min-pool (dilate by their
    # sum, back inside the original mask — too small a step to annex the
    # clutter mass across the inter-object gap).
    comp = (_box_blur(comp.astype(jnp.float32), 3) > 1e-6) & mask
    flood_ok = 4 * keep2.sum() > 0.25 * jnp.maximum(mask.sum(), 1)
    mask = jnp.where(flood_ok, comp, mask)

    ys = jax.lax.broadcasted_iota(jnp.float32, (res, res), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (res, res), 1)

    def corner(proj, k=49):
        p = jnp.where(mask, proj, -jnp.inf).reshape(-1)
        _, idx = jax.lax.top_k(p, k)
        cx = jnp.median(xs.reshape(-1)[idx])
        cy = jnp.median(ys.reshape(-1)[idx])
        return jnp.stack([cx, cy])

    quad = _order_quad(jnp.stack([
        corner(-(xs + ys)),        # tl
        corner(xs - ys),           # tr
        corner(xs + ys),           # br
        corner(ys - xs),           # bl
    ]))

    # Score: edge density must be *concentrated in* the quad — a board is a
    # dense region on a quiet table; uniform texture (no board) scores ~0.
    inside = jnp.ones((res, res), bool)
    for i in range(4):
        p0, p1 = quad[i], quad[(i + 1) % 4]
        e = p1 - p0
        inside &= ((xs - p0[0]) * e[1] - (ys - p0[1]) * e[0]) <= 0
    in_mean = jnp.where(inside, density, 0.0).sum() \
        / jnp.maximum(inside.sum(), 1)
    out_count = (~inside).sum()
    out_mean = jnp.where(~inside, density, 0.0).sum() \
        / jnp.maximum(out_count, 1)
    # Concentration *ratio*, not absolute density difference: a defocused
    # empty pale board has very few edges (thin blurred grid lines only),
    # but whatever edges exist are still entirely inside the quad. Absolute
    # in−out scaling made the score collapse with edge abundance.
    diff = jnp.where(out_count > 0.05 * res * res,
                     in_mean - out_mean, in_mean)
    contrast = diff / jnp.maximum(in_mean, 1e-3)
    # A board also has *line structure*: the Hough accumulator of its edges
    # is sharply peaked (grid lines / stone rows), while texture or noise —
    # which can fool the percentile-adaptive edge threshold into a dense
    # mask — votes diffusely. Measured peak/mean: noise ≈ 6, boards 10–25.
    pts, wts = topk_edge_points(mag)
    acc = hough_accumulate(pts, wts, float(np.hypot(res, res)))
    peakedness = acc.max() / jnp.maximum(acc.mean(), 1e-6)
    structure = jnp.clip((peakedness - 7.0) / 6.0, 0.0, 1.0)

    e1 = quad[1] - quad[0]
    e2 = quad[3] - quad[0]
    quad_area = jnp.abs(e1[0] * e2[1] - e1[1] * e2[0])
    score = jnp.clip(contrast, 0.0, 1.0) * structure \
        * (quad_area > (0.15 * res) ** 2)
    return quad, score


def _interp1d_hat(profile: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """Linear interpolation of a 1D profile at data-dependent positions,
    gather-free: interp(p) = Σ_b max(0, 1−|b−p|)·profile[b] — a dense hat-
    weight contraction instead of many tiny gathers, which scalarized on
    the first accelerator this ran on; unmeasured on the GPU (ROADMAP C3)."""
    n = profile.shape[0]
    p = jnp.clip(pos, 0.0, n - 1.001)
    bins = jnp.arange(n, dtype=jnp.float32)
    w = jnp.maximum(0.0, 1.0 - jnp.abs(bins - p[..., None]))    # (..., n)
    return jnp.matmul(w, profile, precision=_EXACT)


@functools.lru_cache(maxsize=8)
def _comb_matrices(n: int, gsize: int, n_offsets: int, n_spacings: int):
    """Precomputed comb-scoring operators: the comb-grid positions depend
    only on static shapes, so scoring every (offset, spacing) comb reduces
    to two constant (O·S, n) matrices applied to the profile — one matvec
    instead of ~230k scalarized gathers."""
    spacings = np.linspace(0.70 * n / gsize, 1.02 * n / (gsize - 1),
                           n_spacings, dtype=np.float32)
    offsets = np.linspace(0.0, 0.30 * n, n_offsets, dtype=np.float32)
    idx = np.arange(gsize, dtype=np.float32)                # teeth
    mid = np.arange(gsize - 1, dtype=np.float32) + 0.5      # between-line gaps
    pos = offsets[:, None, None] + spacings[None, :, None] * idx   # (O,S,g)
    gaps = offsets[:, None, None] + spacings[None, :, None] * mid
    valid = pos[..., -1] <= n - 1.0

    def interp_matrix(positions, teeth):
        flat = np.clip(positions.reshape(-1, teeth), 0.0, n - 1.001)
        bins = np.arange(n, dtype=np.float32)
        w = np.maximum(0.0, 1.0 - np.abs(bins - flat[..., None]))
        return w.mean(axis=1).astype(np.float32)            # (O·S, n)

    return (offsets, spacings, interp_matrix(pos, gsize),
            interp_matrix(gaps, gsize - 1), valid.astype(np.float32))


def _comb_scores(profile: jnp.ndarray, gsize: int, n_offsets: int = 64,
                 n_spacings: int = 48):
    """The (offset, spacing) comb-score grids on a 1D edge-energy profile.

    Returns (offsets (O,), spacings (S,), teeth_score (O, S), gap_score
    (O, S), valid (O, S)) — computed once and shared by every gap-weight
    scoring raced on this profile.

    Two signals: teeth on high profile; mid-gaps on low(er) profile. The
    gap penalty breaks the basin where the comb stretches one tooth onto
    the board-slab edge — but on near-full boards stone bodies span almost
    the whole cell and the penalty misleads, hence gap_weight is raced by
    the caller (racing is ~free: only these grids carry real work).
    """
    n = profile.shape[0]
    offsets, spacings, a_teeth, a_gaps, valid = _comb_matrices(
        n, gsize, n_offsets, n_spacings)
    teeth_score = jnp.matmul(jnp.asarray(a_teeth), profile,
                             precision=_EXACT).reshape(
        n_offsets, n_spacings)
    gap_score = jnp.matmul(jnp.asarray(a_gaps), profile,
                           precision=_EXACT).reshape(n_offsets, n_spacings)
    return (jnp.asarray(offsets), jnp.asarray(spacings), teeth_score,
            gap_score, jnp.asarray(valid) > 0)


def _comb_fit(profile: jnp.ndarray, gsize: int, n_offsets: int = 64,
              n_spacings: int = 48, gap_weight: float = 0.0):
    """Fit a gsize-tooth even comb to a 1D edge-energy profile under one
    gap-weight scoring → (offset, spacing, gap-penalized quality)."""
    offsets, spacings, teeth_score, gap_score, valid = _comb_scores(
        profile, gsize, n_offsets, n_spacings)
    scores = jnp.where(valid, teeth_score - gap_weight * gap_score, -jnp.inf)
    flat = jnp.argmax(scores)
    oi, si = flat // n_spacings, flat % n_spacings
    # Quality under the *common* metric (gap-penalized) for cross-candidate
    # comparison, regardless of which metric selected this comb.
    quality = (teeth_score - gap_score).reshape(-1)[flat]
    return offsets[oi], spacings[si], quality


def _snap_to_peaks(profile: jnp.ndarray, teeth: jnp.ndarray, pitch,
                   n_off: int):
    """Shared snap core: move each expected tooth position to its sub-pixel
    profile peak within ±pitch/3 — windowed argmax over n_off offsets +
    parabolic sub-step around the discrete winner.

    Stone edges sit ±0.47·pitch off the lines — outside the snap window —
    so the snap can only lock onto the line (or stone-center) ridge itself.
    Returns (snapped positions (g,), peak strengths (g,) — the usual LS
    weights downstream).
    """
    offs = jnp.linspace(-1.0, 1.0, n_off) * (pitch / 3.0)  # (n_off,)
    win = _interp1d_hat(profile, teeth[:, None] + offs[None, :])  # (g, n_off)
    best = jnp.argmax(win, axis=1)
    gi = jnp.arange(teeth.shape[0])
    bm1 = win[gi, jnp.clip(best - 1, 0, n_off - 1)]
    bp1 = win[gi, jnp.clip(best + 1, 0, n_off - 1)]
    b0 = win[gi, best]
    den = bm1 - 2 * b0 + bp1
    delta = jnp.where(jnp.abs(den) > 1e-9, 0.5 * (bm1 - bp1) / den, 0.0)
    step = offs[1] - offs[0]
    snapped = teeth + offs[best] + jnp.clip(delta, -1.0, 1.0) * step
    return snapped, b0


def _snap_teeth(profile: jnp.ndarray, o, s, gsize: int):
    """Sub-pixel comb polish: snap each tooth to the parabolic peak of the
    profile within ±s/3 (_snap_to_peaks), then weighted-least-squares refit
    (o, s)."""
    idx = jnp.arange(gsize, dtype=jnp.float32)
    snapped, b0 = _snap_to_peaks(profile, o + s * idx, s, n_off=21)
    # Weighted LS fit snapped ≈ o' + i·s' (weights = peak strength).
    w = jnp.maximum(b0, 1e-6)
    sw = w.sum()
    mi = (w * idx).sum() / sw
    mp = (w * snapped).sum() / sw
    var = (w * (idx - mi) ** 2).sum()
    s2 = (w * (idx - mi) * (snapped - mp)).sum() / jnp.maximum(var, 1e-9)
    o2 = mp - s2 * mi
    # Sanity: keep the comb fit if the refit drifted implausibly.
    ok = (jnp.abs(s2 - s) < 0.2 * s) & (jnp.abs(o2 - o) < 0.5 * s)
    return jnp.where(ok, o2, o), jnp.where(ok, s2, s)


def _snap_quadratic(profile: jnp.ndarray, o, s, gsize: int):
    """Snap each tooth to its sub-pixel profile peak (as _snap_teeth), then
    weighted-LS fit snapped ≈ a + b·i + c·i² and return the fitted OUTER
    line positions (i = 0 and i = gsize−1).

    The even-spacing comb — and _snap_teeth's straight-line refit — cannot
    represent the residual projective pitch drift left after rectifying on
    a slightly-off quad; averaging that drift into (o, s) is the source of
    the detector's 3–8 px coarse-seed corner bias (NEXT r2 item 2; the cv2
    oracle's adaptive-pitch lattice walk wins for exactly this reason). One
    quadratic term captures the drift to first order and pins the outer
    lines where the measured peaks put them.
    """
    idx = jnp.arange(gsize, dtype=jnp.float32)
    snapped, b0 = _snap_to_peaks(profile, o + s * idx, s, n_off=21)

    w = jnp.maximum(b0, 1e-6)
    ic = idx - (gsize - 1) / 2.0                # centered → conditioned 3×3
    X = jnp.stack([jnp.ones_like(ic), ic, ic * ic], axis=-1)   # (g, 3)

    def wls(weights):
        A = jnp.matmul((X * weights[:, None]).T, X, precision=_EXACT)
        rhs = jnp.matmul((X * weights[:, None]).T, snapped,
                         precision=_EXACT)
        return jnp.linalg.solve(A, rhs)

    beta = wls(w)
    # One IRLS pass: teeth that locked onto an off-line ridge (overhanging
    # stone edges sit ±0.47·s from the line on dense boards) land far from
    # the smooth fit — downweight them and refit, so a minority of
    # edge-locked teeth cannot drag the outer-line estimate.
    resid = snapped - jnp.matmul(X, beta, precision=_EXACT)
    w2 = w / (1.0 + (resid / (0.12 * s)) ** 2)
    beta = wls(w2)
    # Post-fit agreement: on clean lattices the surviving teeth hug the
    # smooth fit (weighted rms ≪ 0.1·s); on stone-saturated boards the
    # snap targets are ridge noise and the spread stays large — there the
    # comb (which pooled all teeth) is the safer estimate.
    r2 = snapped - jnp.matmul(X, beta, precision=_EXACT)
    rms = jnp.sqrt((w2 * r2 * r2).sum() / jnp.maximum(w2.sum(), 1e-6))
    fit_ok = rms < 0.15 * s
    e = (gsize - 1) / 2.0
    lo = beta[0] - beta[1] * e + beta[2] * e * e
    hi = beta[0] + beta[1] * e + beta[2] * e * e
    # Guards: the quadratic bow must stay a small correction (residual
    # perspective is gentle at these margins), and the pinned outer lines
    # must stay near the comb's — otherwise keep the comb (a wrong basin or
    # an occluded edge is not something the pin should chase).
    bow_ok = jnp.abs(beta[2]) * e * e < 0.35 * s
    lo_ok = jnp.abs(lo - o) < 0.5 * s
    hi_ok = jnp.abs(hi - (o + s * (gsize - 1))) < 0.5 * s
    ok = bow_ok & lo_ok & hi_ok & fit_ok
    return (jnp.where(ok, lo, o),
            jnp.where(ok, hi, o + s * (gsize - 1)))


def _pin_corners(gray: jnp.ndarray, quad: jnp.ndarray, gsize: int,
                 res: int = REFINE_RES):
    """Final sub-pixel corner pin: re-rectify on the detected quad, snap
    both axes' teeth to their measured peaks with a quadratic pitch-drift
    fit (_snap_quadratic), and rebuild the corners from the pinned outer
    lines. Runs on the winning candidate at the end of detect_corners.

    The pin is measured PER HALF (the _split_profiles trick): when the
    rectifying quad is off, the true lattice is a slanted quad in rect
    space — measured up to ~11 px of x-slant between the top and bottom
    of the canvas at perspective 0.3 — which full-extent profiles average
    away (their 1-D positions come out right while every corner is wrong).
    Snapping each axis over the two orthogonal halves and linearly
    extrapolating to the outer-line heights recovers each corner's own
    coordinates, i.e. the full projective correction to first order.
    """
    H = _rect_H(quad, 0.10, res)
    rect = _sample_rect(gray, H, res)
    return _pin_corners_on_rect(rect, H, quad, gsize)


def _pin_corners_on_rect(rect: jnp.ndarray, H: jnp.ndarray,
                         quad: jnp.ndarray, gsize: int):
    """_pin_corners measured on an ALREADY-rectified canvas.

    ``rect`` was sampled through ``H`` (rect → frame); ``quad`` is the
    winning candidate in frame coordinates. The pin's snap/fit tolerates a
    canvas rectified by a *nearby* quad instead of the winner itself (the
    per-half quadratic fit absorbs the residual offset/slant), which is
    what lets the batched redetect path reuse ONE shared-canvas gather per
    frame instead of paying a second per-frame rectification gather.
    """
    from camkifu_tpu.ops.warp import _inv3

    res = rect.shape[0]
    _, _, ct, cb, rl, rr = _split_profiles(rect, gsize)
    rc = apply_homography(_inv3(H), quad)
    ox = 0.5 * (rc[0, 0] + rc[3, 0])
    xh = 0.5 * (rc[1, 0] + rc[2, 0])
    oy = 0.5 * (rc[0, 1] + rc[1, 1])
    yh = 0.5 * (rc[2, 1] + rc[3, 1])
    sx = (xh - ox) / (gsize - 1)
    sy = (yh - oy) / (gsize - 1)
    x0t, x1t = _snap_quadratic(ct, ox, sx, gsize)     # top-half rows
    x0b, x1b = _snap_quadratic(cb, ox, sx, gsize)     # bottom-half rows
    y0l, y1l = _snap_quadratic(rl, oy, sy, gsize)     # left-half cols
    y0r, y1r = _snap_quadratic(rr, oy, sy, gsize)     # right-half cols

    # Interior-half measurement heights (uniform row weighting over
    # [res/8, res/2) and [res/2, 7res/8)).
    h1, h2 = 0.3125 * res, 0.6875 * res
    span = h2 - h1
    y_top = 0.5 * (y0l + y0r)
    y_bot = 0.5 * (y1l + y1r)
    x_left = 0.5 * (x0t + x0b)
    x_right = 0.5 * (x1t + x1b)

    def at(v1, v2, pos):                  # linear extrapolation in h
        return v1 + (pos - h1) * (v2 - v1) / span

    # Shear sanity: halves that disagree beyond half a cell are measuring
    # something other than the same line (occlusion artifacts) — drop the
    # shear term rather than extrapolate it.
    def guard(v1, v2, pitch):
        bad = jnp.abs(v2 - v1) > 0.5 * pitch
        m = 0.5 * (v1 + v2)
        return jnp.where(bad, m, v1), jnp.where(bad, m, v2)

    x0t, x0b = guard(x0t, x0b, sx)
    x1t, x1b = guard(x1t, x1b, sx)
    y0l, y0r = guard(y0l, y0r, sy)
    y1l, y1r = guard(y1l, y1r, sy)

    rc2 = jnp.array([
        [at(x0t, x0b, y_top), at(y0l, y0r, x_left)],     # tl
        [at(x1t, x1b, y_top), at(y0l, y0r, x_right)],    # tr
        [at(x1t, x1b, y_bot), at(y1l, y1r, x_right)],    # br
        [at(x0t, x0b, y_bot), at(y1l, y1r, x_left)],     # bl
    ])
    return apply_homography(H, rc2)


def _comb_quality(profile: jnp.ndarray, o, s, gsize: int):
    """Gap-penalized comb score at exactly (o, s), for cross-basin ranking.

    Combs whose teeth run off the profile window cannot be the true grid
    (the rectified window always covers the seed quad plus margin) — they
    get a disqualifying penalty rather than a clipped-interpolation score.
    """
    n = profile.shape[0]
    idx = jnp.arange(gsize, dtype=jnp.float32)
    mid = jnp.arange(gsize - 1, dtype=jnp.float32) + 0.5

    q = _interp1d_hat(profile, o + s * idx).mean() \
        - _interp1d_hat(profile, o + s * mid).mean()
    out = (o < 0.0) | (o + s * (gsize - 1) > n - 1.0)
    return q - 10.0 * out


def _rect_profiles(gray: jnp.ndarray, quad: jnp.ndarray, gsize: int,
                   margin: float = 0.08, res: int = REFINE_RES):
    """Rectify by `quad` (+outward margin) → (H, col_profile, row_profile).

    Split from the comb fit so callers racing several comb scorings on the
    SAME seed pay the rectification warp (the expensive part, a res² gather
    + Sobel) once.
    """
    H, col_profile, row_profile, _ = _rect_profiles_rect(gray, quad, gsize,
                                                         margin, res)
    return H, col_profile, row_profile


def _rect_profiles_rect(gray: jnp.ndarray, quad: jnp.ndarray, gsize: int,
                        margin: float = 0.08, res: int = REFINE_RES):
    """_rect_profiles that also returns the rectified image itself, for
    callers that score 2D lattice evidence on the same rectification."""
    H = _rect_H(quad, margin, res)
    rect = _sample_rect(gray, H, res)
    col_profile, row_profile = _profiles_of(rect, gsize)
    return H, col_profile, row_profile, rect


def _rect_H(quad: jnp.ndarray, margin: float, res: int) -> jnp.ndarray:
    """Homography rect → frame for the quad expanded outward by `margin`
    (the gather-friendly direction)."""
    ctr = quad.mean(axis=0)
    equad = ctr + (quad - ctr) * (1.0 + margin)
    unit = jnp.array([[0.0, 0.0], [res - 1.0, 0.0],
                      [res - 1.0, res - 1.0], [0.0, res - 1.0]], jnp.float32)
    return homography_dlt(unit, equad)


def _sample_rect(gray: jnp.ndarray, H: jnp.ndarray, res: int,
                 lens: Lens | None = None) -> jnp.ndarray:
    """Rectify `gray` through H → (res, res) float32.

    The gather dominates detection; uint8 gray reads 4× fewer bytes per
    tap (bilinear_sample converts only the taps), and every downstream
    profile statistic is percentile/max-normalized → scale-free.

    With `lens`, H must map rect → PINHOLE frame coords (i.e. be built
    from undistorted corners); the sample grid is bent back through the
    lens before the gather (ops/lens.py convention).
    """
    us = jnp.arange(res, dtype=jnp.float32)
    uu, vv = jnp.meshgrid(us, us, indexing="xy")
    src = apply_homography(H, jnp.stack([uu, vv], axis=-1))
    src = distort_pts(lens, src)
    rect = bilinear_sample(gray[..., None], src[..., 0], src[..., 1])[..., 0]
    if gray.dtype == jnp.uint8:
        rect = rect * (1.0 / 255.0)
    return rect


def _prep_profile(profile: jnp.ndarray, gsize: int) -> jnp.ndarray:
    """Condition a raw 1D energy profile into a normalized lattice signal.

    Clip spikes: the board/table slab edge is far stronger than grid
    lines and would otherwise buy a one-tooth-shifted comb; after
    clipping, 19 aligned medium peaks always beat one saturated edge.
    Then high-pass at the cell scale: wide bands (table margins, shading
    gradients) carry no lattice information but would bias the comb;
    only the ~cell-periodic structure should score.
    """
    p = jnp.minimum(profile, jnp.percentile(profile, 90))
    n = p.shape[0]
    r = max(2, n // (2 * gsize))
    c = jnp.cumsum(jnp.pad(p, (r + 1, r), mode="edge"))
    local_mean = (c[2 * r + 1:] - c[:n]) / (2 * r + 1)
    p = jnp.maximum(p - local_mean, 0.0)
    return p / jnp.maximum(p.max(), 1e-6)


def _profiles_of(rect: jnp.ndarray, gsize: int):
    """Rectified board image → (col_profile, row_profile) lattice signals."""
    res = rect.shape[0]
    gx, gy = sobel(rect)
    interior = slice(res // 8, res - res // 8)
    prep = functools.partial(_prep_profile, gsize=gsize)

    # Two lattice signals, both peaking ON the grid lines: gradient energy
    # (grid lines, sparse boards) and luma deviation from the wood level
    # (stones sit centered on intersections — on near-full boards stone
    # *edges* peak half a cell off-line in the gradient profile, but stone
    # *bodies* peak on it in the deviation profile).
    # Wood level: radix-select median of a 4×-subsampled view — runs per
    # frame in the tracking path, where jnp.median's sort was a hotspot
    # on the first accelerator this ran on (see ops.zones.median_u8;
    # unmeasured on the GPU, ROADMAP C4).
    from camkifu_tpu.ops.zones import median_u8
    wood = median_u8(rect[::4, ::4].reshape(1, -1))[0]
    dev = jnp.abs(rect - wood)
    col_profile = prep(jnp.abs(gx)[interior, :].mean(axis=0)) \
        + prep(dev[interior, :].mean(axis=0))
    row_profile = prep(jnp.abs(gy)[:, interior].mean(axis=1)) \
        + prep(dev[:, interior].mean(axis=1))
    return col_profile, row_profile


def _split_profiles(rect: jnp.ndarray, gsize: int):
    """Rectified board image → full + half-split lattice profiles for the
    4-DoF tracker: (col_full, row_full, col_top, col_bot, row_left,
    row_right).

    Same signals as _profiles_of (gradient energy + luma deviation). The
    FULL profiles are prepped over the whole interior average (identical
    to _profiles_of — prepping halves separately and averaging is NOT
    equivalent: prep is nonlinear and the per-half normalization roughly
    halves the correlation sharpness, measured). The column (x-axis)
    profile is additionally measured over the TOP and BOTTOM halves of the
    interior rows, and the row (y-axis) profile over the LEFT and RIGHT
    halves of the interior columns: a rigid in-plane rotation shifts the
    two orthogonal halves of an axis in OPPOSITE directions (dx_top −
    dx_bot = θ·Δy), which a full-extent profile cannot see — the
    differential shifts feed _track_measure's similarity solve.
    """
    res = rect.shape[0]
    gx, gy = sobel(rect)
    i0, i1, mid = res // 8, res - res // 8, res // 2
    prep = functools.partial(_prep_profile, gsize=gsize)

    from camkifu_tpu.ops.zones import median_u8
    wood = median_u8(rect[::4, ::4].reshape(1, -1))[0]
    dev = jnp.abs(rect - wood)
    agx, agy = jnp.abs(gx), jnp.abs(gy)

    def colp(rows):
        return prep(agx[rows, :].mean(axis=0)) + prep(dev[rows, :].mean(axis=0))

    def rowp(cols):
        return prep(agy[:, cols].mean(axis=1)) + prep(dev[:, cols].mean(axis=1))

    return (colp(slice(i0, i1)), rowp(slice(i0, i1)),
            colp(slice(i0, mid)), colp(slice(mid, i1)),
            rowp(slice(i0, mid)), rowp(slice(mid, i1)))


def _fit_combs(H: jnp.ndarray, col_profile: jnp.ndarray,
               row_profile: jnp.ndarray, gsize: int, gap_weight: float):
    """Comb-fit both axes on precomputed profiles.

    Returns (corners (4, 2) in frame coordinates, comb quality scalar,
    variant corners (9, 4, 2), variant qualities (9,)): the variants are the
    comb translated by {-1, 0, +1} teeth along each axis — the comb's basins
    are one tooth apart, and no in-basin scoring can tell "19 teeth on the
    grid" from "18 on the grid + 1 on the slab edge" in every scene; the
    caller races all basins under the slab-containment prior instead.
    """
    ox, sx, qx = _comb_fit(col_profile, gsize, gap_weight=gap_weight)
    oy, sy, qy = _comb_fit(row_profile, gsize, gap_weight=gap_weight)
    ox, sx = _snap_teeth(col_profile, ox, sx, gsize)
    oy, sy = _snap_teeth(row_profile, oy, sy, gsize)

    span = gsize - 1.0
    shifts = (-1.0, 0.0, 1.0)
    qxs = [_comb_quality(col_profile, ox + d * sx, sx, gsize) for d in shifts]
    qys = [_comb_quality(row_profile, oy + d * sy, sy, gsize) for d in shifts]
    var_corners, var_q = [], []
    for i, dx in enumerate(shifts):
        for j, dy in enumerate(shifts):
            x0, y0 = ox + dx * sx, oy + dy * sy
            rc = jnp.array([[x0, y0], [x0 + span * sx, y0],
                            [x0 + span * sx, y0 + span * sy],
                            [x0, y0 + span * sy]])
            var_corners.append(apply_homography(H, rc))
            var_q.append(qxs[i] + qys[j])
    corners = var_corners[4]                       # the (0, 0) central comb
    return corners, qx + qy, jnp.stack(var_corners), jnp.stack(var_q)


def _refine_grid(gray: jnp.ndarray, quad: jnp.ndarray, gsize: int,
                 margin: float = 0.08, res: int = REFINE_RES,
                 gap_weight: float = 1.0):
    """Rectify by `quad` (+outward margin) and comb-fit the grid lines
    (_rect_profiles + _fit_combs; see those for the split rationale)."""
    H, col_profile, row_profile = _rect_profiles(gray, quad, gsize, margin,
                                                 res)
    return _fit_combs(H, col_profile, row_profile, gsize, gap_weight)


def _fit_combs_multi(H: jnp.ndarray, col_profile: jnp.ndarray,
                     row_profile: jnp.ndarray, gsize: int,
                     gap_weights=(1.0, 0.0)):
    """Comb-fit both axes under several gap-weight scorings in ONE pass.

    The (offset, spacing) interpolation grids — the expensive part of a comb
    fit — do not depend on the gap weight, so racing G scorings costs one
    grid per axis plus G cheap argmax/snap passes (VERDICT r1 item 3a: the
    two scorings used to recompute the grids).

    Returns (seeds (G, 4, 2) — each scoring's central comb in frame coords,
    variant corners (G*9, 4, 2), variant qualities (G*9,)); the 9 variants
    per scoring are the ±1-tooth-shifted basins (see _fit_combs).
    """
    grid_x = _comb_scores(col_profile, gsize)
    grid_y = _comb_scores(row_profile, gsize)
    span = gsize - 1.0
    shifts = (-1.0, 0.0, 1.0)
    seeds, var_corners, var_q = [], [], []
    for gw in gap_weights:
        def pick(grid):
            offsets, spacings, teeth, gap, valid = grid
            scores = jnp.where(valid, teeth - gw * gap, -jnp.inf)
            flat = jnp.argmax(scores)
            n_sp = spacings.shape[0]
            return offsets[flat // n_sp], spacings[flat % n_sp]
        ox, sx = pick(grid_x)
        oy, sy = pick(grid_y)
        ox, sx = _snap_teeth(col_profile, ox, sx, gsize)
        oy, sy = _snap_teeth(row_profile, oy, sy, gsize)
        qxs = [_comb_quality(col_profile, ox + d * sx, sx, gsize)
               for d in shifts]
        qys = [_comb_quality(row_profile, oy + d * sy, sy, gsize)
               for d in shifts]
        for i, dx in enumerate(shifts):
            for j, dy in enumerate(shifts):
                x0, y0 = ox + dx * sx, oy + dy * sy
                rc = jnp.array([[x0, y0], [x0 + span * sx, y0],
                                [x0 + span * sx, y0 + span * sy],
                                [x0, y0 + span * sy]])
                var_corners.append(apply_homography(H, rc))
                var_q.append(qxs[i] + qys[j])
        seeds.append(var_corners[-5])          # this scoring's (0, 0) comb
    return jnp.stack(seeds), jnp.stack(var_corners), jnp.stack(var_q)


def _slab_inset(corners: jnp.ndarray, slab: jnp.ndarray) -> jnp.ndarray:
    """Smallest inward distance (px) from any candidate corner to the slab
    boundary. Negative = a corner lies outside the slab."""
    dists = []
    for i in range(4):
        p0 = slab[i]
        p1 = slab[(i + 1) % 4]
        e = p1 - p0
        # Inward normal for a tl/tr/br/bl (clockwise on screen) quad.
        n = jnp.stack([-e[1], e[0]])
        n = n / jnp.maximum(jnp.linalg.norm(n), 1e-6)
        d = jnp.matmul(corners - p0[None, :], n, precision=_EXACT)
        dists.append(d.min())
    return jnp.stack(dists).min()


def _evidence_map(rect: jnp.ndarray, gsize: int) -> jnp.ndarray:
    """2D lattice-evidence map on a rectified board image.

    Center-surround (blob-scale minus cell-scale box means) of two signals
    that both peak ON grid intersections: luma deviation from the wood
    level (stone bodies sit centered on intersections) and gradient energy
    (line crossings). Each is rectified and max-normalized so sparse and
    dense boards score on the same scale.

    Why it exists: the 1D comb profiles that rank refinement candidates go
    flat on stone-saturated boards (a shrunk/shifted comb matches a smeared
    profile about as well as the true one — measured collapse to >120 px at
    220 stones), but a wrong lattice's *interior* points land
    incommensurately off the true stone centers, so joint 2D evidence at
    all gsize² intersections still separates the basins.
    """
    res = rect.shape[0]
    from camkifu_tpu.ops.zones import median_u8
    wood = median_u8(rect[::4, ::4].reshape(1, -1))[0]
    dev = jnp.abs(rect - wood)
    gx, gy = sobel(rect)
    edge = jnp.abs(gx) + jnp.abs(gy)
    s_cell = res / (gsize + 1.0)
    r_in = max(1, int(s_cell * 0.18))
    r_out = max(r_in + 2, int(s_cell * 0.6))
    cs_dev = _box_blur(dev, r_in) - _box_blur(dev, r_out)
    cs_edge = _box_blur(edge, r_in) - _box_blur(edge, r_out)
    return (jnp.maximum(cs_dev, 0.0)
            / jnp.maximum(jnp.abs(cs_dev).max(), 1e-9)
            + jnp.maximum(cs_edge, 0.0)
            / jnp.maximum(jnp.abs(cs_edge).max(), 1e-9))


def _lattice_evidence(E: jnp.ndarray, Hinv: jnp.ndarray,
                      cands: jnp.ndarray, gsize: int) -> jnp.ndarray:
    """Mean evidence at each candidate's gsize² intersections, all measured
    in the SEED rect (one consistent measurement across candidates from
    different refinement iterations — per-iteration rects are not
    comparable and re-ranking on them is unstable, measured).

    cands: (N, 4, 2) corner quads in frame px; Hinv maps frame → seed rect.
    """
    rc = apply_homography(Hinv, cands)                       # (N, 4, 2)
    return _lattice_evidence_rc(E, rc, gsize)


def _lattice_evidence_rc(E: jnp.ndarray, rc: jnp.ndarray,
                         gsize: int) -> jnp.ndarray:
    """_lattice_evidence for quads already in seed-rect coords (N, 4, 2).

    Interior points are PROJECTIVE (per-candidate DLT from the unit square),
    not bilinear: at strong keystone the true lattice's interior deviates
    from bilinear interpolation of its own corners, so under a bilinear
    model displaced corners scored BETTER than truth (measured at 220
    stones / perspective 0.30: evidence 0.46 at 23 px off vs 0.37 at truth,
    and evidence-ascent from truth drifted 13 px). The projective model
    puts the corner-space optimum back on the true corners.
    """
    iu = jnp.arange(gsize, dtype=jnp.float32) / (gsize - 1.0)
    gu, gv = jnp.meshgrid(iu, iu, indexing="xy")
    grid = jnp.stack([gu, gv], axis=-1).reshape(-1, 2)       # (G², 2)
    return _grid_evidence_rc(E, rc, grid)


def _grid_evidence_rc(E: jnp.ndarray, rc: jnp.ndarray,
                      grid: jnp.ndarray) -> jnp.ndarray:
    """Mean evidence at arbitrary unit-square points projected through each
    candidate quad's DLT (the generalization behind _lattice_evidence_rc;
    infer_gsize also scores the between-teeth midpoint grid with it)."""
    res = E.shape[0]
    unit = jnp.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]],
                     jnp.float32)
    P = jax.vmap(
        lambda c: apply_homography(homography_dlt(unit, c), grid))(rc)
    px = jnp.clip(P[..., 0], 0.0, res - 1.001)               # (N, M)
    py = jnp.clip(P[..., 1], 0.0, res - 1.001)
    x0 = jnp.floor(px).astype(jnp.int32)
    y0 = jnp.floor(py).astype(jnp.int32)
    fx, fy = px - x0, py - y0
    val = (E[y0, x0] * (1 - fx) * (1 - fy)
           + E[y0, x0 + 1] * fx * (1 - fy)
           + E[y0 + 1, x0] * (1 - fx) * fy
           + E[y0 + 1, x0 + 1] * fx * fy)
    ev = val.mean(axis=1)
    # A degenerate perturbed quad makes its DLT singular — score it out
    # rather than letting a NaN win an argmax.
    return jnp.where(jnp.isfinite(ev), ev, -1.0)


def _evidence_polish(E: jnp.ndarray, H: jnp.ndarray, Hinv: jnp.ndarray,
                     w: jnp.ndarray, gsize: int,
                     spans=(0.45, 0.30, 0.15, 0.06), k: int = 5):
    """Corner-wise coordinate descent directly on the 2D evidence map.

    The saturated-branch candidate pool is comb-generated, i.e. every
    candidate is an even (offset, spacing) lattice in its rect frame — but
    at strong perspective the coarse seed leaves a residual keystone the
    comb family cannot express, so the pool's best member is itself ~1 cell
    off (PERF.md: 39 px at 220 stones / perspective 0.30, candidate-set-
    limited). This polish escapes the comb family: each corner moves
    independently over a shrinking k×k search grid (coarse-to-fine spans,
    in cells of the seed rect), scored by the same joint lattice evidence
    used for ranking. Single-corner steps cannot reach the one-cell-shifted
    lattice impostor (that needs all four corners to move together), and
    the result re-enters the pool under the full prior-carrying
    _rank_evidence, so a polish that wandered is discarded, not trusted.
    """
    rc = apply_homography(Hinv, w)                          # (4, 2) rect px
    cell = jnp.linalg.norm(rc[1] - rc[0]) / (gsize - 1.0)
    for span in spans:
        offs = jnp.linspace(-span, span, k).astype(jnp.float32) * cell
        dxy = jnp.stack(jnp.meshgrid(offs, offs, indexing="ij"),
                        axis=-1).reshape(-1, 2)             # (k*k, 2)
        for i in range(4):
            cands = jnp.broadcast_to(rc, (k * k, 4, 2))
            cands = cands.at[:, i].add(dxy)
            ev = _lattice_evidence_rc(E, cands, gsize)
            rc = cands[jnp.argmax(ev)]
    return apply_homography(H, rc)


def _side_insets(corners: jnp.ndarray, slab: jnp.ndarray) -> jnp.ndarray:
    """Inward distance from the candidate to each slab side (4,), in the
    coordinate frame both are given in. Side order follows the slab's
    tl→tr→br→bl corner order: top, right, bottom, left."""
    dists = []
    for i in range(4):
        p0 = slab[i]
        p1 = slab[(i + 1) % 4]
        e = p1 - p0
        n = jnp.stack([-e[1], e[0]])
        n = n / jnp.maximum(jnp.linalg.norm(n), 1e-6)
        dists.append(jnp.matmul(corners - p0[None, :], n,
                                precision=_EXACT).min())
    return jnp.stack(dists)


def _rank_evidence(cands: jnp.ndarray, E: jnp.ndarray, Hinv: jnp.ndarray,
                   quad: jnp.ndarray, cell, gsize: int) -> jnp.ndarray:
    """Cross-basin candidate ranking: 2D lattice evidence plus two SOFT
    geometric priors against the lattice's periodic impostors.

    - slab inset (the true outer grid lines sit ≥ ~0.3 cell inside the
      slab; a hard feasibility gate fails when the coarse quad itself is
      off and nothing is 'feasible' — measured on keystoned dense boards);
    - margin symmetry, measured in the seed RECT frame (perspective-free):
      physical gobans have near-equal margins on opposite sides, while a
      one-cell-shifted lattice — which keeps 18/19 of its teeth on true
      lines and parks the ghost row on the strong slab edge, so pure
      evidence barely separates it — is asymmetric by a full cell
      (measured: rotated boards misranked 1 cell inward without this).

    The symmetry penalty is QUADRATIC above a 0.6-cell dead zone, not
    linear above 0.4: the measured impostor classes sit at asym ≈ 1.0
    (one-cell-inward shrunk lattice) and ≈ 2.2 (one-cell shift — both
    sides of one axis move oppositely, so the sum reads TWO cells), while
    the TRUE pose reads up to ~0.8 when the coarse slab itself is biased
    (220 stones / persp 0.30: truth asym 0.75, and the old linear penalty
    −0.21 overturned truth's genuine +0.026 evidence gap — the prior was
    adjudicating between two NON-impostor candidates, which is not its
    job; local-pitch normalization was measured and does NOT explain the
    0.75, the slab is simply off). Quadratic keeps ≤0.03 penalty through
    the true-pose range, −0.13 at the shrunk impostor, −2 at the shifted
    one."""
    ev = _lattice_evidence(E, Hinv, cands, gsize)
    insets = jax.vmap(lambda c: _slab_inset(c, quad))(cands)
    rc = apply_homography(Hinv, cands)                        # (N, 4, 2)
    rslab = apply_homography(Hinv, quad)                      # (4, 2)
    side = jax.vmap(lambda c: _side_insets(c, rslab))(rc)     # (N, 4)
    rcell = jnp.linalg.norm(rc[:, 1] - rc[:, 0], axis=1) / (gsize - 1.0)
    asym = (jnp.abs(side[:, 0] - side[:, 2])
            + jnp.abs(side[:, 1] - side[:, 3])) \
        / jnp.maximum(rcell, 1e-3)                            # in cells
    return ev + jnp.minimum(insets / cell - 0.25, 0.0) \
        - 0.8 * jnp.square(jnp.maximum(asym - 0.6, 0.0))


def _detect_prepare(frame: jnp.ndarray, res: int):
    """Detection stage 1 (dense, batchable): gray + coarse board quad.

    Returns (gray u8 (H, W), quad (4, 2) frame px, score). Everything here
    is resize/filter/top-k work that vectorizes cleanly across a batch —
    unlike stage 2's rectification gathers (varying indices per frame).
    """
    h, w = frame.shape[0], frame.shape[1]
    # uint8 gray for the rectification gathers (see _rect_profiles); the
    # coarse stage works on small resized floats. Converting the whole
    # frame to f32 first would materialize a 24 MB copy at 1080p.
    gray = rgb_to_gray_u8(frame)
    fscale = 1.0 / 255.0 if frame.dtype == jnp.uint8 else 1.0
    small = jax.image.resize(gray.astype(jnp.float32) / 255.0,
                             (res, res), method="bilinear")
    chroma = jax.image.resize(
        (frame[..., 0].astype(jnp.float32)
         - frame[..., 2].astype(jnp.float32)) * fscale,
        (res, res), method="bilinear")
    quad_small, score = _coarse_quad(small, chroma)
    scale = jnp.array([(w - 1) / (res - 1), (h - 1) / (res - 1)],
                      jnp.float32)
    return gray, quad_small * scale[None, :], score


@functools.partial(jax.jit, static_argnames=("res",))
def _detect_prepare_batch(frames: jnp.ndarray, res: int):
    """Batched detection stage 1: (B, H, W, 3) → (grays u8 (B, H, W),
    quads (B, 4, 2) frame px, scores (B,)).

    Per-frame outputs match ``_detect_prepare`` (same ops, same per-frame
    adaptive thresholds). Luma and chroma edge maps for the whole batch run
    as one vmapped edge stack (2B frames stacked) and the post-edge
    geometry vmaps over ``_coarse_from_mag`` — the stage is resize/filter/
    top-k work that batches cleanly, unlike stage 2's rectification gathers.
    """
    b, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
    with jax.default_matmul_precision("float32"):
        return _detect_prepare_batch_impl(frames, b, h, w, res)


def _detect_prepare_batch_impl(frames, b, h, w, res):
    grays = rgb_to_gray_u8(frames)
    fscale = 1.0 / 255.0 if frames.dtype == jnp.uint8 else 1.0
    smalls = jax.image.resize(grays.astype(jnp.float32) / 255.0,
                              (b, res, res), method="bilinear")
    chromas = jax.image.resize(
        (frames[..., 0].astype(jnp.float32)
         - frames[..., 2].astype(jnp.float32)) * fscale,
        (b, res, res), method="bilinear")
    mags = edge_map_batch(jnp.concatenate([smalls, chromas]))
    quads, scores = jax.vmap(_coarse_from_mag)(mags[:b], mags[b:])
    scale = jnp.array([(w - 1) / (res - 1), (h - 1) / (res - 1)],
                      jnp.float32)
    return grays, quads * scale[None, None, :], scores


@functools.partial(jax.jit, static_argnames=("gsize", "refine_iters"))
def _refine_one(gray: jnp.ndarray, quad: jnp.ndarray, score,
                gsize: int = 19, refine_iters: int = 1):
    """Jitted per-frame stages 2–3 for callers that ran stage 1 batched."""
    return _detect_refine(gray, quad, score, gsize, refine_iters)


@functools.partial(jax.jit, static_argnames=("gsize",))
def _refine_shared_batch(grays: jnp.ndarray, shared_quad: jnp.ndarray,
                         quads: jnp.ndarray, gsize: int = 19):
    """Batched line-dominated refine on ONE shared rectification canvas.

    The per-frame refine is two rectification gathers (refine + pin). On
    the first accelerator this ran on, a single frame's gather had no
    batchable minor dimension and scalarized, and vmapping per-frame quads
    hit a varying-index gather cliff; both premises are unmeasured on the
    GPU (ROADMAP C3). The fix is the tracking engine's idiom applied
    to detection: rectify ALL frames of the batch through the homography of
    the batch-median stage-1 quad — indices shared across the batch, the
    fast gather shape — then measure each frame's OWN lattice on its own
    canvas: per-frame comb race, 2D evidence ranking, and the per-half
    sub-pixel pin, all on the shared canvas (no second gather). Each
    frame's corners still come exclusively from its own pixels; the shared
    quad only chooses the sampling grid.

    Valid when every frame is line-dominated (score > 0.55) and the
    stage-1 quads agree to a fraction of a cell (a video batch; the router
    in detect_batch enforces both and falls back per-frame otherwise).
    Returns (corners (B, 4, 2), derotate deltas (B,), concentrations (B,))
    — the caller re-runs frames whose derotate trip would have fired, since
    the de-rotation pass needs a per-frame re-rectification.
    """
    with jax.default_matmul_precision("float32"):
        res = REFINE_RES
        H = _rect_H(shared_quad, 0.10, res)
        rects = jax.vmap(lambda g: _sample_rect(g, H, res))(grays)
        Hinv = jnp.linalg.inv(H)

        def per_frame(rect, quad):
            colp, rowp = _profiles_of(rect, gsize)
            _, vc1, _ = _fit_combs_multi(H, colp, rowp, gsize, (1.0, 0.0))
            E = _evidence_map(rect, gsize)
            cell = jnp.linalg.norm(quad[1] - quad[0]) / (gsize + 0.0)
            rank1 = _rank_evidence(vc1, E, Hinv, quad, cell, gsize)
            w1 = vc1[jnp.argmax(rank1)]
            pin = _pin_corners_on_rect(rect, H, w1, gsize)
            delta, conc = _resid_rotation(rect)
            return pin.astype(jnp.float32), delta, conc

        return jax.vmap(per_frame)(rects, quads)


@functools.partial(jax.jit, static_argnames=("res", "gsize", "refine_iters"))
def detect_corners(frame: jnp.ndarray, res: int = cvconf.bf_resolution,
                   gsize: int = 19, refine_iters: int = 1):
    """One frame (H, W, 3) uint8/float → (corners (4, 2) float32, score).

    Corners are the outer grid intersections, tl/tr/br/bl, in frame pixels.
    score < ~0.1 means "no board found" (callers keep the previous estimate).

    refine_iters counts the extra seeded comb races run on the
    stone-saturated branch only (score ≤ 0.55; see _detect_refine) — on
    line-dominated boards the sub-pixel outer-line pin subsumes iteration
    (densities × perspectives × palettes × hard/real, 720p + 1080p: one
    race + pin matches or beats two races everywhere, at less work).
    """
    with jax.default_matmul_precision("float32"):
        gray, quad, score = _detect_prepare(frame, res)
        corners = _detect_refine(gray, quad, score, gsize, refine_iters)
        return corners, score


# ---------------------------------------------------------------------------
# Lens (radial distortion) calibration — anchor-time only.
# ---------------------------------------------------------------------------

#: Coarse calibration grid (barrel-skewed: webcams are barrel far more
#: often than pincushion, and strong pincushion folds at the frame edge —
#: see ops/lens.py). Bounds chosen from the measured failure envelope:
#: detection is fine below |k1| ≈ 0.015 and unrecoverable past ~0.15.
K1_CAL_GRID = (-0.09, -0.06, -0.035, -0.015, 0.0,
               0.015, 0.035, 0.06, 0.09, 0.13)

#: Minimum lattice-evidence gain over the pinhole (k1 = 0) run before a
#: nonzero k1 is adopted: on genuinely pinhole footage the argmax over the
#: grid is sampling noise, and a phantom lens would bend every warp in the
#: system. Measured on straight synth footage the spurious best-over-grid
#: gain is ≤7%; a real lens gains 17% at k1 = 0.02 and 35%+ from 0.04 up.
K1_CAL_MARGIN = 1.10


@functools.partial(jax.jit, static_argnames=("res", "gsize"))
def _detect_k1_probe(frame: jnp.ndarray, k1,
                     res: int = 512, gsize: int = 19):
    """Full detection on the k1-undistorted frame, plus a lattice-evidence
    quality score for the result.

    k1 is TRACED, so ONE compilation serves the entire calibration grid.
    The frame is resampled to pinhole geometry first (undistort_frame —
    the one place in the system that pays a full-frame gather, affordable
    because calibration runs once per session at anchor time) and the
    ordinary straight-line detector runs unchanged; the returned corners
    are bent back to RAW frame coordinates. Quality = mean LINE-SCALE
    lattice evidence at the detected quad's gsize² intersections: with
    the WRONG k1 the interior lines stay bowed after rectification and
    edge energy at the predicted intersections drops. The line-scale
    center-surround (radii 1/5 px) is used, NOT the blob-scale
    _evidence_map — grid lines are 1–2 px and residual bow at Δk1 = 0.015
    displaces mid-edge lines by only ~3 rect px, inside the blob map's
    plateau (measured: blob evidence carries a systematic ≈−0.015 k1 bias;
    line evidence peaks on the true k1 at 0.015 grid spacing). Coarse
    `score` does not discriminate at all — it kept reading 0.9 while 2
    cells off on distorted footage.

    res = 512, not the runtime's bf_resolution (256): at 256 the coarse
    quad's own noise moves the objective by more than a 0.015 k1 step
    (measured: the coarse grid argmax landed one step off for true
    k1 = 0.04/0.08 at 256, dead-on at 512). Calibration runs once per
    session — precision is worth the 4× coarse-stage pixels here.
    """
    lens = make_lens(k1, (frame.shape[0], frame.shape[1]))
    pin = undistort_frame(frame, lens)
    with jax.default_matmul_precision("float32"):
        gray, quad, score = _detect_prepare(pin, res)
        corners = _detect_refine(gray, quad, score, gsize, 1)
        from camkifu_tpu.ops.warp import _inv3
        H, _, _, rect = _rect_profiles_rect(gray, corners, gsize)
        gx, gy = sobel(rect)
        edge = jnp.abs(gx) + jnp.abs(gy)
        cs = _box_blur(edge, 1) - _box_blur(edge, 5)
        E = jnp.maximum(cs, 0.0) / jnp.maximum(jnp.abs(cs).max(), 1e-9)
        q = _lattice_evidence(E, _inv3(H), corners[None], gsize)[0]
    return distort_pts(lens, corners), score, q


@jax.jit
def _undistort_batch(frames: jnp.ndarray, lens: Lens) -> jnp.ndarray:
    """Pinhole-resample a small frame batch (anchor-path detection only —
    hot paths compose the lens into sample coordinates instead)."""
    return jax.vmap(lambda f: undistort_frame(f, lens))(frames)


def estimate_lens_k1(frame, gsize: int = 19,
                     grid=K1_CAL_GRID) -> tuple[float, float]:
    """Estimate the radial distortion coefficient from one frame.

    Coarse grid over k1 (one jit specialization, k1 traced), then a fine
    sweep between the winner's neighbors, then a bow refinement against
    the corners detected at the adopted k1 (the bow differential cancels
    any constant/affine residual a ~2 px corner error leaves, so detection
    noise does not poison it — measured: refinement tightens the detection
    path from ±0.012 to ±0.005). Returns (k1, gain) where gain is the
    winner's lattice-evidence ratio over the pinhole run; k1 is 0.0 unless
    the gain clears K1_CAL_MARGIN (phantom-lens hysteresis).
    """
    frame = jnp.asarray(frame)

    def q_at(k1: float) -> float:
        _, _, q = _detect_k1_probe(frame, jnp.float32(k1), gsize=gsize)
        q = float(q)
        return q if np.isfinite(q) else -1.0

    k1, gain = _k1_sweep(q_at, grid)
    if k1 != 0.0:
        corners, score, _ = _detect_k1_probe(frame, jnp.float32(k1),
                                             gsize=gsize)
        if float(score) >= 0.1 and bool(np.isfinite(
                np.asarray(corners)).all()):
            zone = max(16, int(round(512 / gsize)))

            def bow_at(k: float) -> float:
                b = float(_corners_bow_probe(frame, corners,
                                             jnp.float32(k),
                                             gsize=gsize, zone=zone))
                return b if np.isfinite(b) else np.inf

            k1 = _k1_bow_refine(bow_at, k1)
    return k1, gain


@functools.partial(jax.jit, static_argnames=("res", "gsize"))
def _gsize_probe(frame: jnp.ndarray, res: int = cvconf.bf_resolution,
                 gsize: int = 19):
    """Full detection at a candidate gsize, scored by a PITCH-SENSITIVE
    quality: the winner's per-axis lattice-profile energy at its gsize
    tooth positions MINUS the energy at its between-teeth midpoints.

    2D intersection evidence cannot rank board sizes — both measured
    impostor families defeat it (720p synth):
    - DENSE overlays: a g19 probe on a true 9×9 board locks a pitch/3
      comb (spacing window floor 0.70·n/19 ≈ true_pitch/3.4); ~29% of its
      361 points ride true LINES and score 0.32 vs the true g9's 0.20
      (line-scale center-surround responds more mid-line than at
      crossings), while its cell midpoints hide in wood — so even an
      intersection-minus-midpoint differential keeps the impostor ahead.
    - SPARSE overlays: a g9 probe on a true 19×19 board locks the
      every-other-line comb (2·pitch = 0.111·n, inside the 9-window) with
      ALL teeth on true lines.
    The 1D profile differential kills both at once: the dense impostor's
    teeth fall mostly between profile peaks (tooth mean ≈ peak/3), and
    the sparse impostor's MIDPOINTS land exactly on the skipped lines
    (differential ≈ 0), while the true pitch scores peak-minus-wood.
    Profiles are per-axis max-normalized (_prep_profile), so sizes are
    directly comparable.
    """
    with jax.default_matmul_precision("float32"):
        gray, quad, score = _detect_prepare(frame, res)
        corners = _detect_refine(gray, quad, score, gsize, 1)
        from camkifu_tpu.ops.warp import _inv3
        H, col_profile, row_profile, _ = _rect_profiles_rect(
            gray, corners, gsize)
        n = col_profile.shape[0]
        # Tooth positions from the corners' ACTUAL rect coordinates (the
        # 0.08 margin expansion happens in frame space, so the inset is
        # only approximately static under perspective — at strong keystone
        # the static approximation drifts teeth off the 1–2 px profile
        # peaks).
        rc = apply_homography(_inv3(H), corners)             # (4, 2)
        idx = jnp.arange(gsize, dtype=jnp.float32) / (gsize - 1.0)
        midx = (jnp.arange(gsize - 1, dtype=jnp.float32) + 0.5) \
            / (gsize - 1.0)

        def taps(profile, pos):
            pos = jnp.clip(pos, 0.0, n - 1.001)
            i0 = jnp.floor(pos).astype(jnp.int32)
            w = pos - i0
            return profile[i0] * (1 - w) + profile[i0 + 1] * w

        q = jnp.float32(0.0)
        for profile, a0, a1 in ((col_profile, (rc[0, 0] + rc[3, 0]) * 0.5,
                                 (rc[1, 0] + rc[2, 0]) * 0.5),
                                (row_profile, (rc[0, 1] + rc[1, 1]) * 0.5,
                                 (rc[3, 1] + rc[2, 1]) * 0.5)):
            teeth = a0 + (a1 - a0) * idx
            mids = a0 + (a1 - a0) * midx
            # ±2 px tolerance on teeth: the pinned lattice is sub-pixel
            # but profile peaks are 1–2 px wide; midpoints get a plain
            # tap (a sparse impostor's midpoints sit exactly ON lines —
            # widening them would only help it).
            tooth_e = jnp.stack(
                [taps(profile, teeth + d) for d in (-2.0, -1.0, 0.0,
                                                    1.0, 2.0)]).max(axis=0)
            q = q + tooth_e.mean() - taps(profile, mids).mean()
    return corners, score, 0.5 * q


def infer_gsize(frame, candidates: tuple[int, ...] = (9, 13, 19),
                res: int = cvconf.bf_resolution) -> tuple[int, dict]:
    """Infer the board size from one frame. Beyond parity: the reference
    hardcodes gsize = 19 (SURVEY §2.2 guiconf — "rebuild should
    parameterize but default to 19"); this makes ``--gsize auto`` work.

    Runs the full detector once per candidate size and compares each
    winner's pitch-sensitive lattice quality (_gsize_probe: intersection
    evidence minus cell-midpoint evidence, per-point normalized so sizes
    are directly comparable). Wrong sizes are doubly handicapped: the comb
    family's spacing window (0.70·n/g … 1.02·n/(g−1), _comb_matrices)
    cannot express a same-pitch subgrid of a denser board (a centered 9×9
    window of a 19×19 lattice needs spacing n/18 ≈ 0.056·n, below the
    9-comb's 0.078·n floor; polish moves corners ≤2 cells, so no probe can
    shrink onto a commensurate sub-lattice), and whatever wrong-pitch
    lattice the probe does lock onto loses the tooth-minus-midpoint
    differential. Measured (720p synth, clean empty-ish boards at 9/13/19
    + a hard-mode 40-stone midgame): the true size wins every config with
    ≥1.9× margin over the best wrong size.

    Returns (gsize, qualities) where qualities maps each candidate to its
    quality (−1.0 when detection failed outright); gsize is 0 when no
    candidate found a board at all — callers choose their own default.
    """
    frame = jnp.asarray(frame)
    quals: dict[int, float] = {}
    for g in candidates:
        _, score, q = _gsize_probe(frame, res=res, gsize=int(g))
        ok = float(score) >= 0.1 and np.isfinite(float(q))
        quals[int(g)] = float(q) if ok else -1.0
    best = max(quals, key=lambda g: quals[g])
    return (best if quals[best] > 0.0 else 0), quals


def _k1_sweep(q_at, grid) -> tuple[float, float]:
    """Coarse-grid + fine-neighborhood maximization of a k1 quality probe,
    with the phantom-lens hysteresis shared by both calibrators."""
    qs = [q_at(k) for k in grid]
    q0 = qs[list(grid).index(0.0)]
    i = int(np.argmax(qs))
    best_k, best_q = grid[i], qs[i]
    if best_k != 0.0:
        lo = grid[i - 1] if i > 0 else best_k - 0.02
        hi = grid[i + 1] if i + 1 < len(grid) else best_k + 0.02
        for k in np.linspace(lo, hi, 7)[1:-1]:
            q = q_at(float(k))
            if q > best_q:
                best_k, best_q = float(k), q
    gain = best_q / max(q0, 1e-9)
    if gain < K1_CAL_MARGIN or abs(best_k) < 0.01:
        return 0.0, gain
    return round(best_k, 4), gain


@functools.partial(jax.jit, static_argnames=("gsize", "zone"))
def _corners_k1_probe(frame: jnp.ndarray, corners: jnp.ndarray, k1,
                      gsize: int = 19, zone: int = 27) -> jnp.ndarray:
    """Lattice-evidence quality of KNOWN corners under a candidate k1.

    The manual-mode calibration probe: the user's clicked corners are
    ground truth, so no detection runs — the frame is rectified straight
    through the candidate lens (the homography built against the corners'
    pinhole positions, the sample grid bent back through the lens — the
    exact sampler every reader uses, ops/lens.py convention) and scored by
    LINE-SCALE lattice evidence at the canonical intersections. With the
    TRUE k1 the grid lines land on the canonical lattice; with a wrong k1
    the interior lines stay bowed and mid-edge evidence drops. One warp +
    sobel + two box blurs per evaluation — no Hough, no comb race, ~30×
    cheaper than _detect_k1_probe. k1 is TRACED: one compile per
    (frame shape, gsize) serves the whole calibration grid.

    zone: canonical px per cell. The default 27 puts the rect at 513² for
    gsize 19 — the same ≥512 working resolution _detect_k1_probe needs for
    0.015-step k1 discrimination (callers scale it for other gsizes).
    """
    from camkifu_tpu.ops.warp import canonical_corners
    lens = make_lens(k1, (frame.shape[0], frame.shape[1]))
    gray = rgb_to_gray_u8(frame) if frame.dtype == jnp.uint8 \
        else rgb_to_gray(to_float(frame))
    pin = undistort_pts(lens, corners.astype(jnp.float32))
    cc = canonical_corners(gsize, zone)
    H = homography_dlt(cc, pin)
    rect = _sample_rect(gray, H, gsize * zone, lens)
    gx, gy = sobel(rect)
    edge = jnp.abs(gx) + jnp.abs(gy)
    cs = _box_blur(edge, 1) - _box_blur(edge, 5)
    E = jnp.maximum(cs, 0.0) / jnp.maximum(jnp.abs(cs).max(), 1e-9)
    return _lattice_evidence_rc(E, cc[None], gsize)[0]


def estimate_lens_k1_corners(frame, corners, gsize: int = 19,
                             grid=K1_CAL_GRID) -> tuple[float, float]:
    """Estimate k1 from one frame whose board corners are KNOWN.

    The BoardFinderManual calibrator (clicked corners = ground truth);
    same sweep + hysteresis contract as estimate_lens_k1: returns
    (k1, gain), with k1 = 0.0 unless the evidence gain over the pinhole
    run clears K1_CAL_MARGIN.
    """
    frame = jnp.asarray(frame)
    corners = jnp.asarray(np.asarray(corners, np.float32).reshape(4, 2))
    zone = max(16, int(round(512 / gsize)))

    def q_at(k1: float) -> float:
        q = float(_corners_k1_probe(frame, corners, jnp.float32(k1),
                                    gsize=gsize, zone=zone))
        return q if np.isfinite(q) else -1.0

    k1, gain = _k1_sweep(q_at, grid)
    if k1 != 0.0:
        def bow_at(k: float) -> float:
            b = float(_corners_bow_probe(frame, corners, jnp.float32(k),
                                         gsize=gsize, zone=zone))
            return b if np.isfinite(b) else np.inf

        k1 = _k1_bow_refine(bow_at, k1)
    return k1, gain


@functools.partial(jax.jit, static_argnames=("gsize", "zone"))
def _corners_bow_probe(frame: jnp.ndarray, corners: jnp.ndarray, k1,
                       gsize: int = 19, zone: int = 27) -> jnp.ndarray:
    """Mean |line bow| of the candidate-k1 rectified canvas — the k1
    REFINEMENT objective (pairs with _corners_k1_probe, the ADOPTION
    objective).

    Lattice evidence ranks k1 well at coarse scale but its point samples
    alias with the resampling phase near the optimum (measured: ±0.03
    quality jitter at 0.005 k1 steps leaves the sweep up to 0.02 off at
    k1 = 0.08–0.12). Residual distortion, however, is directly VISIBLE in
    the rectified canvas: grid lines stay bowed, and a line's mid-span
    center-of-mass shifts against its end spans. Measured per grid line
    via sub-pixel edge-energy centroids in three bands along the line:
    bow_i = offset(mid band) − mean(offset(outer bands)); the objective is
    mean |bow_i| over the interior lines of both axes. On synth footage
    the argmin sits exactly on the true k1 at 0.005 granularity for every
    k1 in ±0.12 (V-shaped, near-linear flanks), where the evidence curve
    is plateau-noisy. Window-limited by construction (centroid windows are
    ±(zone/2−3) px), so it only refines — the evidence sweep must land
    within ~half a cell first. k1 TRACED: one compile serves the scan.
    """
    from camkifu_tpu.ops.warp import canonical_corners
    lens = make_lens(k1, (frame.shape[0], frame.shape[1]))
    gray = rgb_to_gray_u8(frame) if frame.dtype == jnp.uint8 \
        else rgb_to_gray(to_float(frame))
    pin = undistort_pts(lens, corners.astype(jnp.float32))
    cc = canonical_corners(gsize, zone)
    H = homography_dlt(cc, pin)
    res = gsize * zone
    rect = _sample_rect(gray, H, res, lens)
    gx = jnp.abs(jnp.diff(rect, axis=1, prepend=rect[:, :1]))
    gy = jnp.abs(jnp.diff(rect, axis=0, prepend=rect[:1]))
    # Canonical line positions are STATIC → static centroid windows.
    centers = zone / 2.0 - 0.5 + zone * np.arange(gsize)
    w = zone // 2 - 3
    idx = np.round(centers).astype(np.int32)[:, None] \
        + np.arange(-w, w + 1)[None, :]                  # (G, 2w+1)
    taps = jnp.asarray(idx.astype(np.float32))
    ctr = jnp.asarray(centers.astype(np.float32))

    def offsets(prof: jnp.ndarray) -> jnp.ndarray:
        seg = prof[idx]                                   # (G, 2w+1)
        seg = seg - seg.min(axis=1, keepdims=True)
        m = jnp.maximum(seg.sum(axis=1), 1e-9)
        return (seg * taps).sum(axis=1) / m - ctr         # (G,)

    b = res // 3
    total = jnp.float32(0.0)
    for energy, mean_axis in ((gx, 0), (gy, 1)):
        if mean_axis == 0:      # vertical lines: row bands
            bands = (energy[:b].mean(0), energy[b:2 * b].mean(0),
                     energy[2 * b:].mean(0))
        else:                   # horizontal lines: column bands
            bands = (energy[:, :b].mean(1), energy[:, b:2 * b].mean(1),
                     energy[:, 2 * b:].mean(1))
        o0, o1, o2 = (offsets(p) for p in bands)
        bow = o1 - 0.5 * (o0 + o2)
        # The outermost lines sit against the board edge / stone rows —
        # their centroids are contaminated; interior lines carry the bow.
        total = total + jnp.abs(bow[2:-2]).mean()
    return 0.5 * total


def _k1_bow_refine(bow_at, k0: float) -> float:
    """Two-stage scan of the |bow| objective around the evidence winner:
    ±0.02 at 0.005 steps, then ±0.005 at ~0.0017 steps around that argmin.
    ~16 evaluations of one (jit-cached) warp + band centroids each."""
    best_k, best_b = k0, bow_at(k0)
    for span, n in ((0.02, 9), (0.005, 7)):
        for k in np.linspace(best_k - span, best_k + span, n):
            bv = bow_at(float(k))
            if bv < best_b:
                best_k, best_b = float(k), bv
    return round(best_k, 4)


#: Residual-rotation re-rectification threshold (radians). Below ~0.6° the
#: comb race absorbs the tilt (≤3 px profile smear across the canvas);
#: above ~1.5° the 1D profiles smear by a full tooth and the offset+spacing
#: comb — which cannot express rotation — locks a whole cell off WITH a
#: high confidence score (measured: the coarse quad under-rotates by ≈θ/6,
#: so boards rotated ≥10° silently failed by 1+ cells).
DEROTATE_TRIP = float(np.deg2rad(0.7))

#: Minimum folded-orientation concentration (circular resultant length,
#: 0..1) for the rotation estimate to be TRUSTED. On stone-saturated
#: boards the gradient energy is circular stone rims, the folded
#: distribution goes near-uniform, and the circular mean degenerates to
#: noise pinned at the ±45° fold boundary (measured: R ≤ 0.084 at
#: 180–250 stones reading ±44.6°, vs R ≥ 0.17 on line-dominated boards
#: incl. rotated 120-stone midgames — derotating on the garbage reading
#: threw detection 10 cells off). Saturated boards therefore skip
#: de-rotation; their rotation envelope stays the comb's native <10°
#: (measured: ≤0.5 cell at 6°, ~1 cell at 10°, 3–8 cells at ≥14° — PERF.md
#: pose-veto section). Beyond the envelope the defense is systems-level:
#: SfMeta._pose_vetoed rejects any fresh anchor whose readings contradict
#: the committed game (reject_anchor below).
DEROTATE_MIN_CONC = 0.12


def _resid_rotation(rect: jnp.ndarray):
    """In-plane rotation of the rectified lattice vs the canvas axes.

    Energy-weighted circular mean of the gradient orientation folded mod
    90° (angle-quadrupling): both line families vote at the same folded
    angle, stone rims vote uniformly and cancel, and perspective is already
    removed by the rectification — unlike a Hough-θ estimate on the raw
    frame, where the receding line family fans out and drags the peak.
    Unambiguous for |rotation| < 22.5°; accuracy ~0.1–0.3° measured.

    Returns ``(angle_rad, concentration)``: the circular resultant length
    (0 = uniform orientations = no lattice signal, the angle is noise;
    see DEROTATE_MIN_CONC) qualifies the estimate.
    """
    gx = (rect[:, 2:] - rect[:, :-2])[1:-1, :]
    gy = (rect[2:, :] - rect[:-2, :])[:, 1:-1]
    m2 = gx * gx + gy * gy
    # Specular-spike cap from a 2×-strided percentile, which sorts a 4×
    # smaller view of the 318² gradient field; a robustness cap tolerates
    # the small shift subsampling introduces. Whether the saving matters on
    # the GPU is unmeasured (ROADMAP C4).
    w = jnp.minimum(m2, jnp.percentile(m2[::2, ::2], 99.0))
    phi4 = 4.0 * jnp.arctan2(gy, gx)
    s = (w * jnp.sin(phi4)).sum()
    c = (w * jnp.cos(phi4)).sum()
    conc = jnp.sqrt(s * s + c * c) / jnp.maximum(w.sum(), 1e-9)
    return jnp.arctan2(s, c) / 4.0, conc


def _detect_refine(gray: jnp.ndarray, quad: jnp.ndarray, score,
                   gsize: int, refine_iters: int = 1):
    """Detection stages 2–3 (gather-bound, per frame): comb refinement race
    + 2D-evidence disambiguation + the sub-pixel outer-line pin.

    Multi-hypothesis refinement: the comb fit has discrete shifted basins
    (one tooth on the slab edge instead of a grid line), and no single 1D
    scoring beats all stone densities — on saturated boards every profile
    metric goes flat and the old `teeth − gap` ranking promoted
    shrunk/shifted combs (measured >120 px collapse at 220 stones). All
    candidates are therefore ranked by joint 2D lattice evidence on the
    SEED rectification (_rank_evidence), with a soft slab-inset prior.

    Two runtime branches on the coarse score (lax.cond — one executes):
    - line-dominated boards (score > 0.55): the iteration-1 evidence winner
      plus the sub-pixel outer-line pin (per-half quadratic fit of the
      outer lines — kills the coarse-seed comb bias; ≤3 px measured). The
      pin runs once: it does not contract under iteration (measured — a
      second pass re-biases through its own fresh rectification).
    - stone-saturated boards (score ≤ 0.55): `refine_iters` extra comb
      races seeded on the running evidence winner (a clean re-
      rectification removes the keystone smear a coarse seed leaves in
      the profiles), then both pins join the pool; everything is ranked
      on the one seed-rect evidence map. Measured (stones×perspective
      stress grid): max error 120→39 px worst case, ≤17 px elsewhere,
      never worse than the old rule.
    """
    with jax.default_matmul_precision("float32"):
        gap_weights = (1.0, 0.0)
        # Iteration 1: ONE rectification (same seed quad → identical
        # profiles), one comb-grid pass shared by both scorings; the
        # rectified image doubles as the evidence measurement frame.
        H, colp, rowp, rect = _rect_profiles_rect(gray, quad, gsize,
                                                  margin=0.10)

        # De-rotation pass: if the seed rectification left the lattice
        # visibly rotated (the one error mode the comb race cannot model —
        # see DEROTATE_TRIP), rotate the rect canvas frame by the measured
        # angle THROUGH the homography (exact under perspective) and
        # re-rectify once. lax.cond: the extra gather only runs when needed.
        # Gain 2/3: the estimator over-reads the needed correction by a
        # stable 1.5× (measured ratio −0.5 oscillation at gain 1 across
        # 6–25° boards); at 2/3 one pass lands ≤0.2° residual everywhere
        # in the ±25° working envelope (the mod-90° fold is ambiguous past
        # ±22.5°, and a 45°-rotated lattice has no preferred orientation).
        # The concentration gate keeps saturated boards (no orientation
        # signal — see DEROTATE_MIN_CONC) off this path entirely.
        raw_delta, conc = _resid_rotation(rect)
        delta = raw_delta * (2.0 / 3.0)

        def _derotate(_):
            rres = rect.shape[0]
            unit = jnp.array([[0.0, 0.0], [rres - 1.0, 0.0],
                              [rres - 1.0, rres - 1.0], [0.0, rres - 1.0]],
                             jnp.float32)
            cc = (rres - 1.0) / 2.0
            cd, sd = jnp.cos(delta), jnp.sin(delta)
            rotm = jnp.stack([jnp.stack([cd, -sd]), jnp.stack([sd, cd])])
            runit = cc + jnp.matmul(unit - cc, rotm.T, precision=_EXACT)
            equad2 = apply_homography(H, runit)
            ctr2 = equad2.mean(axis=0)
            q2 = (ctr2 + (equad2 - ctr2) / 1.10).astype(jnp.float32)
            return (q2,) + _rect_profiles_rect(gray, q2, gsize, margin=0.10)

        def _keep(_):
            return quad, H, colp, rowp, rect

        quad, H, colp, rowp, rect = jax.lax.cond(
            (jnp.abs(delta) > DEROTATE_TRIP) & (conc > DEROTATE_MIN_CONC),
            _derotate, _keep, None)
        cell = jnp.linalg.norm(quad[1] - quad[0]) / (gsize + 0.0)
        _, vc1, _ = _fit_combs_multi(H, colp, rowp, gsize, gap_weights)
        E = _evidence_map(rect, gsize)
        Hinv = jnp.linalg.inv(H)
        rank1 = _rank_evidence(vc1, E, Hinv, quad, cell, gsize)
        w1 = vc1[jnp.argmax(rank1)]
        pin1 = _pin_corners(gray, w1, gsize)

        def line_dominated(_):
            return pin1

        def stone_saturated(_):
            cands, ranks, w = vc1, rank1, w1
            for _ in range(max(refine_iters, 1)):
                H2, c2, r2 = _rect_profiles(gray, w, gsize, margin=0.10)
                _, vc2, _ = _fit_combs_multi(H2, c2, r2, gsize, gap_weights)
                cands = jnp.concatenate([cands, vc2])
                ranks = jnp.concatenate(
                    [ranks, _rank_evidence(vc2, E, Hinv, quad, cell, gsize)])
                w = cands[jnp.argmax(ranks)]
            pins = jnp.stack([pin1, _pin_corners(gray, w, gsize)])
            cands = jnp.concatenate([cands, pins])
            ranks = jnp.concatenate(
                [ranks, _rank_evidence(pins, E, Hinv, quad, cell, gsize)])
            # Escape the comb family entirely: evidence-ascent polish of
            # the running winner (the residual keystone no comb candidate
            # can express — see _evidence_polish), re-ranked with the rest.
            # TWO polish→re-rank rounds: the coarse-to-fine spans shrink
            # faster than the descent can travel when the seed is ~0.5 cell
            # off (measured at 220 stones / persp 0.30: round 1 lands
            # 18 px off and WINS the rank; a second round seeded on that
            # winner restarts at span 0.45 and reaches 2.8 px, ev 0.481 →
            # 0.507, outranking round 1 — tools/evprobe.py). Each round's
            # output re-enters the prior-carrying pool, so a polish that
            # wandered is discarded, not trusted.
            for _ in range(2):
                w3 = cands[jnp.argmax(ranks)]
                pol = _evidence_polish(E, H, Hinv, w3, gsize)[None]
                cands = jnp.concatenate([cands, pol])
                ranks = jnp.concatenate(
                    [ranks, _rank_evidence(pol, E, Hinv, quad, cell, gsize)])
            return cands[jnp.argmax(ranks)]

        corners = jax.lax.cond(score > 0.55, line_dominated,
                               stone_saturated, None)
        return corners.astype(jnp.float32)


def detect_batch(frames: jnp.ndarray, res: int = cvconf.bf_resolution,
                 gsize: int = 19):
    """Per-frame detection over a batch → (corners (B, 4, 2), scores (B,)).

    Fast path (one fused dispatch, _detect_batch_fused): stage 1
    (gray/resize/edges/coarse quad, batched) + the per-chunk shared-canvas
    refine (_chunked_route: chunk-median rectification keeps the gather
    indices chunk-shared). The host fetches one (k,)-bool chunk verdict;
    chunks that fail validity fall back per frame.

    Fallback (per-frame refine): a host loop over the jitted per-frame
    path, deliberately not lax.map, whose scan body re-staged detection's
    gather/top-k work far slower than the standalone jit on the first
    accelerator this ran on; unmeasured on the GPU (ROADMAP C3). Every
    call site is host-level, so nothing needs this inside a jit.
    """
    b = frames.shape[0]
    if SHARED_REFINE_ENABLED and b >= 2:
        # One fused dispatch: stage 1 + per-chunk shared refine.
        chunk = SHARED_CHUNK if b % SHARED_CHUNK == 0 else b
        grays, quads, scores, corners, oks = _detect_batch_fused(
            frames, res, gsize, chunk)
        merged = _merge_routed(grays, quads, scores, corners,
                               np.asarray(oks), chunk, gsize)
        if merged is not None:
            return merged, scores
    else:
        grays, quads, scores = _detect_prepare_batch(frames, res)
    corners = [_refine_one(grays[i], quads[i], scores[i], gsize)
               for i in range(b)]
    return jnp.stack(corners), scores


#: Max stage-1 quad deviation from the chunk median (in cells) for the
#: shared-canvas refine: beyond this the shared sampling grid would crop or
#: smear a frame's lattice (independent stills, a camera bump inside the
#: batch) and the per-frame path is the honest route. 0.55, raised from
#: 0.35 in r5: stage-1 coarse-quad NOISE alone measures 0.32–0.40 cells on
#: handheld scenes (per-frame sensor noise jitters the density mask), so
#: the old gate bounced legitimate video chunks; the canvas tolerates far
#: more by construction (0.10 outward margin ≈ 1.8 cells before cropping,
#: and the refine re-measures each frame's own lattice — comb race over a
#: 0–0.30·n offset window, sub-pixel pin with 0.5-cell snap guards).
#: Parity tests (test_detect_shared, test_bf_auto) hold at the new gate.
SHARED_REFINE_SPREAD = 0.55

#: Ablation switch for the shared-canvas batched refine (tests/debugging).
SHARED_REFINE_ENABLED = True

#: Frames per shared-canvas chunk. The whole-batch median canvas stops
#: validating as the batch grows — at B=32 a handheld camera's quads spread
#: past SHARED_REFINE_SPREAD of the one median (0.361 cells on a handheld
#: scene), and the router falls back to the per-frame path. Chunking is the
#: tracking engine's warp_batch_chunked idiom applied to detection:
#: per-chunk median quads keep ~4× less spread while the gather indices
#: stay chunk-shared. Whether shared indices still pay on the GPU is
#: unmeasured (ROADMAP C3).
SHARED_CHUNK = 8


def _shared_route_body(grays, quads, scores, gsize: int):
    """Shared-canvas refine + validity verdict for ONE chunk (traced).

    Everything the routing decision needs (median quad, spread, scores,
    derotate trips) is computed ON DEVICE and folded into a single boolean,
    so the host pays exactly one tiny fetch per batch instead of a
    device→host round trip before routing and another after it."""
    med = jnp.median(quads, axis=0)
    cell = jnp.linalg.norm(med[1] - med[0]) / max(gsize - 1, 1)
    ok = jnp.isfinite(quads).all() & (scores > 0.55).all() \
        & (cell > 1e-6) \
        & (jnp.abs(quads - med).max() <= SHARED_REFINE_SPREAD * cell)
    corners, deltas, concs = _refine_shared_batch(grays, med, quads, gsize)
    trip = ((jnp.abs(deltas * (2.0 / 3.0)) > DEROTATE_TRIP)
            & (concs > DEROTATE_MIN_CONC)).any()
    ok = ok & ~trip & jnp.isfinite(corners).all()
    return corners, ok


@functools.partial(jax.jit, static_argnames=("gsize",))
def _route_and_refine_shared(grays, quads, scores, gsize: int):
    """Whole-batch shared-canvas refine + validity (one chunk = the batch)."""
    return _shared_route_body(grays, quads, scores, gsize)


def _chunked_route(grays, quads, scores, gsize: int, chunk: int):
    """Scan the batch through per-chunk shared-canvas refines (traced).

    lax.scan, not vmap: each chunk's gather keeps chunk-shared indices
    (vmapping per-chunk homographies would batch varying gather indices,
    the shape the shared canvas exists to avoid — same premise as
    ops.warp.warp_batch_chunked, unmeasured on the GPU: ROADMAP C3)."""
    b = grays.shape[0]
    k = b // chunk
    gq = grays.reshape((k, chunk) + grays.shape[1:])
    qq = quads.reshape(k, chunk, 4, 2)
    sq = scores.reshape(k, chunk)

    def body(_, x):
        g, q, s = x
        return None, _shared_route_body(g, q, s, gsize)

    _, (corners, oks) = jax.lax.scan(body, None, (gq, qq, sq))
    return corners.reshape(b, 4, 2), oks


@functools.partial(jax.jit, static_argnames=("gsize", "chunk"))
def _route_and_refine_chunked(grays, quads, scores, gsize: int, chunk: int):
    """Jitted per-chunk routing for callers that ran stage 1 separately."""
    return _chunked_route(grays, quads, scores, gsize, chunk)


@functools.partial(jax.jit, static_argnames=("res", "gsize", "chunk"))
def _detect_batch_fused(frames, res: int, gsize: int, chunk: int):
    """Stage 1 + per-chunk routed shared refine in ONE dispatch.

    Fusing the two stages halves the dispatches and host syncs per batch.
    The host fetches one (k,)-bool verdict; stage-1 outputs are returned on
    device for the per-chunk fallback path."""
    b, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
    with jax.default_matmul_precision("float32"):
        grays, quads, scores = _detect_prepare_batch_impl(
            frames, b, h, w, res)
        corners, oks = _chunked_route(grays, quads, scores, gsize, chunk)
    return grays, quads, scores, corners, oks


def _detect_batch_routed(grays, quads, scores, gsize: int):
    """Route a batch through per-chunk shared-canvas refines; None if every
    chunk fell back.

    Per-chunk validity (see _shared_route_body): every frame of the chunk
    line-dominated, stage-1 quads within SHARED_REFINE_SPREAD of the CHUNK
    median, and no derotate trip firing — failed chunks take the per-frame
    path (bit-identical to detect_corners' refine) while valid chunks keep
    the shared result. One host sync: the (k,) validity fetch."""
    if not SHARED_REFINE_ENABLED or grays.shape[0] < 2:
        return None
    b = grays.shape[0]
    chunk = SHARED_CHUNK if b % SHARED_CHUNK == 0 else b
    corners, oks = _route_and_refine_chunked(grays, quads, scores,
                                             gsize, chunk)
    return _merge_routed(grays, quads, scores, corners,
                         np.asarray(oks), chunk, gsize)


def _merge_routed(grays, quads, scores, corners, oks_host, chunk: int,
                  gsize: int):
    """Combine shared-canvas chunks with per-frame refines for failed
    chunks. Returns None when no chunk validated (pure per-frame batch)."""
    if not oks_host.any():
        return None
    if oks_host.all():
        return corners
    out = []
    for c in range(len(oks_host)):
        lo, hi = c * chunk, (c + 1) * chunk
        if oks_host[c]:
            out.append(corners[lo:hi])
        else:
            out.append(jnp.stack([
                _refine_one(grays[i], quads[i], scores[i], gsize)
                for i in range(lo, hi)]))
    return jnp.concatenate(out)


def detect_batch_stable(frames: jnp.ndarray,
                        res: int = cvconf.bf_resolution,
                        gsize: int = 19,
                        max_frames: int = 8) -> jnp.ndarray:
    """Fixed-camera estimate: per-frame detection, then the median corner
    positions over the confident frames (the reference's accumulate-until-
    stable, batch-shaped). Full detection is far costlier per frame than
    classification, so at most ``max_frames`` evenly-spaced frames of the
    batch are detected."""
    b = frames.shape[0]
    if b > max_frames:
        frames = frames[::max(1, b // max_frames)][:max_frames]
    corners, scores = detect_batch(frames, res, gsize)
    ok = (scores >= 0.05)[:, None, None]
    w = ok.astype(jnp.float32)
    # Median over confident frames; fall back to plain median if none pass.
    big = jnp.where(ok, corners, jnp.nan)
    med = jnp.nanmedian(big, axis=0)
    return jnp.where(jnp.isnan(med), jnp.median(corners, axis=0), med)


# ---------------------------------------------------------------------------
# Per-frame corner tracking (BASELINE config 4: honest per-frame detection).
# ---------------------------------------------------------------------------

#: Outward margin of the tracking rectification; also bounds how far the
#: board may move within ~2 chunks before tracking must re-seed.
TRACK_MARGIN = 0.18

#: Correlation search half-window, in cells: how far the board may move
#: between consecutive tracked frames (and per chunk re-seed).
TRACK_WIN_OFFSET = 0.75

#: Correlation-peak sharpness (peak/mean) below which a frame's measurement
#: is rejected (occlusion/motion blur) and the previous offset is kept.
TRACK_MIN_SHARPNESS = 1.5

#: Reference-profile adaptation rate (EMA toward the latest aligned frame,
#: so slow scene changes — new stones — don't decorrelate the reference).
TRACK_REF_EMA = 0.15

#: Lattice-alignment trip-wire: force re-detection when a batch's comb
#: alignment falls below this fraction of the baseline pinned at the last
#: re-anchor (slow drift the sharpness gate cannot see). Calibration on the
#: synthetic keystone ramp: clean batches stay ≥0.86 of baseline; ~0.5 cell
#: of unmodeled perspective drift decays alignment below ~0.55.
TRACK_ALIGN_TRIP = 0.6

#: Discontinuity trip-wire: the max credible per-frame tracked-corner step,
#: in cells. A camera BUMP can land the correlation on a whole-cell-shifted
#: lattice that is both sharp AND well-aligned (the lattice is periodic —
#: measured: a 40 px knock read as a clean lock 1 cell off, silently
#: relocating every stone). Any step beyond this is a discontinuity:
#: re-detect, and tell the stones finder its evidence for the batch is
#: suspect. 0.5 cells = the natural alias boundary: the impostor locks are
#: whole-cell (≥1.0) while per-frame tracker noise on the worst measured
#: footage (the gauntlet: walnut + grain + flicker + encode artifacts)
#: reaches 0.26 cells — clean handheld motion is ≤~0.1. (0.25 false-
#: tripped the gauntlet mid-game.)
TRACK_JUMP_TRIP = 0.5


def _profile_shift(profile: jnp.ndarray, delta) -> jnp.ndarray:
    """Translate a 1D profile by `delta` (sub-pixel, edge-clamped)."""
    n = profile.shape[0]
    return _interp1d_hat(profile,
                         jnp.arange(n, dtype=jnp.float32) + delta)


def _corr_shift(profiles: jnp.ndarray, ref: jnp.ndarray, S: int):
    """(B, n) profiles × (n,) reference → per-frame sub-pixel translation +
    correlation-peak sharpness, via one (B, n)×(n, 2S+1) matmul.

    corr[s] pairs p[i] with ref[i + s − S]: a peak at s means the profile
    is the reference translated RIGHT by d = S − s.
    """
    n = profiles.shape[-1]
    n_sh = 2 * S + 1
    refp = jnp.pad(ref, (S, S))
    shifted = jnp.stack([jax.lax.dynamic_slice(refp, (s,), (n,))
                         for s in range(n_sh)])             # (2S+1, n)
    corr = jnp.matmul(profiles, shifted.T, precision=_EXACT)    # (B, 2S+1)
    best = jnp.argmax(corr, axis=1)
    c0 = jnp.take_along_axis(corr, best[:, None], 1)[:, 0]
    cm = jnp.take_along_axis(
        corr, jnp.clip(best - 1, 0, n_sh - 1)[:, None], 1)[:, 0]
    cp = jnp.take_along_axis(
        corr, jnp.clip(best + 1, 0, n_sh - 1)[:, None], 1)[:, 0]
    den = cm - 2 * c0 + cp
    sub = jnp.where(jnp.abs(den) > 1e-9,
                    jnp.clip(0.5 * (cm - cp) / den, -1, 1), 0.0)
    d = S - (best.astype(jnp.float32) + sub)
    sharp = c0 / jnp.maximum(corr.mean(axis=1), 1e-6)
    return d, sharp


def _hold_bad(d: jnp.ndarray, ok: jnp.ndarray) -> jnp.ndarray:
    """Replace rejected per-frame measurements with the last good one."""
    def hold(carry, x):
        v, good = x
        v = jnp.where(good, v, carry)
        return v, v
    _, out = jax.lax.scan(hold, jnp.float32(0), (d, ok))
    return out


#: Per-chunk caps on the measured rotation/scale update: beyond these the
#: scene changed faster than tracking can model (a bump) — the sharpness /
#: alignment trip-wires force re-detection rather than extrapolating.
TRACK_MAX_THETA = 0.12          # rad (~7°)
TRACK_MAX_SIGMA = 0.08

#: Max disagreement between the two independent θ (or σ) estimates before
#: the whole frame is distrusted (the conflict veto): occluders corrupt the
#: x- and y-derived estimates differently; real rotation/zoom moves both
#: together.
TRACK_DIFF_AGREE = 0.015

#: Deadband (in cells) for the ABSOLUTE corrections (teeth-fit center
#: deviations, lattice lock): below it a correction is indistinguishable
#: from the lattice signal's own content bias (~0.05–0.1 cell of standing
#: peak-vs-geometry offset, measured by ablation); above it, it is a real
#: seed/reference error and applies whole.
TRACK_ABS_DEADBAND = 0.12


def _lattice_offset(profile: jnp.ndarray, first: jnp.ndarray, pitch,
                    gsize: int, S: int):
    """ABSOLUTE lattice lock: sub-pixel offset of a profile's lattice from
    the positions the seed quad implies (teeth at first + k·pitch).

    Content-reference correlation (the rest of the tracker) measures only
    RELATIVE motion — any seed error (e.g. the host's detection median
    taken over frames at different drift phases) persists as a constant
    corner offset that high sharpness then hides. Correlating against a
    synthetic comb TEMPLATE of the expected lattice measures the absolute
    residual once per chunk; adding it to every frame's translation pins
    the output corners to the measured lattice, not the seed.

    Returns (offset, sharpness) — gate on sharpness like any correlation.
    """
    n = profile.shape[0]
    bins = jnp.arange(n, dtype=jnp.float32)
    pos = first + pitch * jnp.arange(gsize, dtype=jnp.float32)
    template = jnp.maximum(
        0.0, 1.0 - jnp.abs(bins[None, :] - pos[:, None])).sum(axis=0)
    d, sh = _corr_shift(profile[None, :], template, S)
    return d[0], sh[0]


def _abs_lock_update(cols0, rows0, first_x, first_y, px, py,
                     dx0, dy0, ok0, e_lock, S: int, gsize: int):
    """One chunk's absolute-lattice-lock update, shared by both tracking
    engines (track_corners_batch and rectify_track_batch — per-axis vs
    shared pitch is the only call-site difference).

    Template-correlate the chunk's first frame against the seed-implied
    comb (_lattice_offset), then gate the residual three ways before
    merging it into the running ``e_lock``:

    - correlation sharpness + frame ok — unmeasurable frames say nothing;
    - comb-quality referee — the template can mislock onto an off-lattice
      ridge (stone edges on hard palettes, measured ~0.9 cells of
      self-consistent error): accept only where the ABSOLUTE comb score of
      the locked position beats the currently-held one;
    - deadband (TRACK_ABS_DEADBAND·pitch) — the lattice signal's peaks sit
      ~1–2 rect px off geometric truth (content bias, measured); smaller
      corrections are bias, not seed error.
    """
    ex_m, sex = _lattice_offset(cols0, first_x, px, gsize, S)
    ey_m, sey = _lattice_offset(rows0, first_y, py, gsize, S)
    qx_with = _comb_quality(cols0, first_x + ex_m, px, gsize)
    qx_without = _comb_quality(cols0, first_x + dx0 + e_lock[0], px, gsize)
    qy_with = _comb_quality(rows0, first_y + ey_m, py, gsize)
    qy_without = _comb_quality(rows0, first_y + dy0 + e_lock[1], py, gsize)
    exc = ex_m - dx0
    eyc = ey_m - dy0
    return jnp.stack([
        jnp.where((sex >= TRACK_MIN_SHARPNESS) & ok0
                  & (qx_with > qx_without)
                  & (jnp.abs(exc) >= TRACK_ABS_DEADBAND * px),
                  exc, e_lock[0]),
        jnp.where((sey >= TRACK_MIN_SHARPNESS) & ok0
                  & (qy_with > qy_without)
                  & (jnp.abs(eyc) >= TRACK_ABS_DEADBAND * py),
                  eyc, e_lock[1])])


def _teeth_fit(profile: jnp.ndarray, first, pitch, gsize: int):
    """Robust per-tooth lattice fit: snap each of the gsize teeth (expected
    at first + k·pitch) to its sub-pixel profile peak within ±pitch/3, then
    IRLS-weighted linear fit position_k ≈ A + B·(k − center).

    Unlike a half-window cross-correlation — whose peak a SINGLE new scene
    element (a just-played stone adds one big profile peak) can drag by
    several px, which a differential then amplifies into a spurious
    θ/σ (measured: σ jumped to the 0.05–0.08 clip when moves were played
    on hard palettes) — the line fit treats each tooth as one observation
    and the IRLS pass strips the polluted minority.

    Returns (da, b, ok): deviation of the lattice CENTER from expected
    (A − (first + pitch·(gsize−1)/2)), fitted pitch B, and a validity flag
    (teeth agree on a line: weighted rms residual < 0.15·pitch).
    """
    idx = jnp.arange(gsize, dtype=jnp.float32)
    snapped, b0 = _snap_to_peaks(profile, first + pitch * idx, pitch,
                                 n_off=15)

    w = jnp.maximum(b0, 1e-6)
    ic = idx - (gsize - 1) / 2.0

    def wls(weights):
        sw = weights.sum()
        sx = (weights * ic).sum()
        sy = (weights * snapped).sum()
        sxx = (weights * ic * ic).sum()
        sxy = (weights * ic * snapped).sum()
        d = jnp.maximum(sw * sxx - sx * sx, 1e-6)
        B = (sw * sxy - sx * sy) / d
        A = (sy - B * sx) / sw
        return A, B

    A, B = wls(w)
    resid = snapped - (A + B * ic)
    w2 = w / (1.0 + (resid / (0.12 * pitch)) ** 2)
    A, B = wls(w2)
    r2 = snapped - (A + B * ic)
    rms = jnp.sqrt((w2 * r2 * r2).sum() / jnp.maximum(w2.sum(), 1e-6))
    ok = (rms < 0.15 * pitch) & (B > 0.5 * pitch)
    da = A - (first + pitch * (gsize - 1) / 2.0)
    return da, B, ok


def _half_geometry(rc: jnp.ndarray, n: int, gsize: int):
    """Expected per-half lattice (first tooth, pitch) from the seed quad's
    ACTUAL rect-space corners.

    The margin-expanded rectification is projective, so even a perfect
    seed's lattice is a slightly slanted quad in rect coordinates (several
    px between the top and bottom halves) — measured against a single
    axis-aligned expectation that residual reads as a constant spurious
    θ/σ (~1.4° on the unfused path). Interpolating the quad's edge lines
    at each half's measurement height gives every half its own exact
    expectation, cancelling the model error absolutely (no differencing —
    and hence no per-chunk rotation lag — needed).

    Returns (fx_t, fx_b, sx_t, sx_b, fy_l, fy_r, sy_l, sy_r).
    """
    h1, h2 = 0.3125 * n, 0.6875 * n     # interior half measurement centers

    def xl(y):
        return rc[0, 0] + (y - rc[0, 1]) * (rc[3, 0] - rc[0, 0]) \
            / (rc[3, 1] - rc[0, 1])

    def xr(y):
        return rc[1, 0] + (y - rc[1, 1]) * (rc[2, 0] - rc[1, 0]) \
            / (rc[2, 1] - rc[1, 1])

    def yt(x):
        return rc[0, 1] + (x - rc[0, 0]) * (rc[1, 1] - rc[0, 1]) \
            / (rc[1, 0] - rc[0, 0])

    def yb(x):
        return rc[3, 1] + (x - rc[3, 0]) * (rc[2, 1] - rc[3, 1]) \
            / (rc[2, 0] - rc[3, 0])

    g1 = gsize - 1
    return (xl(h1), xl(h2), (xr(h1) - xl(h1)) / g1, (xr(h2) - xl(h2)) / g1,
            yt(h1), yt(h2), (yb(h1) - yt(h1)) / g1, (yb(h2) - yt(h2)) / g1)


def _track_measure(cf, rf, ct, cb, rl, rr, ref_col, ref_row, S: int,
                   geom, gsize: int):
    """Full + half-split profiles → per-frame 4-DoF similarity measurement.

    Inputs: (chunk, n) profiles from _split_profiles and the (n,) full-axis
    references. Model: the board moved by a similarity about the rect
    center, p' = c + (1+σ)·R(θ)·(p−c) + t, so a point at offset v from the
    center displaces by dx = tx − θ·vy + σ·vx, dy = ty + θ·vx + σ·vy.

    Coarse translation and the frame gate use the FULL-extent content
    correlations — the r2-proven signal: an occluder mixed into the full
    profile collapses its peak sharpness, so corrupted frames reject and
    hold (this gate carried every r2 occlusion scenario). The half-split
    profiles then get a robust per-tooth lattice fit each (_teeth_fit),
    seeded at the frame's coarse translation, giving per half an absolute
    center offset `a` and pitch `b`:

    - rotation: the x-offsets of the top vs bottom halves (and y-offsets
      of left vs right) differ by θ·lever — invisible to any full-extent
      measurement. Lever: interior halves, uniform row weighting → 0.375·n.
    - scale: the fitted pitch vs the seed-implied pitch, σ = b̄/s − 1.
    - absolute translation: the mean center offset over both halves
      corrects reference-EMA drift and seed error per frame.

    Each differential is accepted only when the frame's gate passed, BOTH
    its half-fits converged, and — when the x- and y-derived estimates of
    the same physical quantity both exist — they AGREE (real rotation or
    zoom moves both together; a corruption moves them differently).

    Returns (tx, ty, theta, sigma, sharp, ok, rot_ok, scl_ok), all (chunk,).
    """
    n = ct.shape[-1]
    fx_t, fx_b, sx_t, sx_b, fy_l, fy_r, sy_l, sy_r = geom
    tx, shxf = _corr_shift(cf, ref_col, S)
    ty, shyf = _corr_shift(rf, ref_row, S)
    sharp = jnp.minimum(shxf, shyf)
    ok = sharp >= TRACK_MIN_SHARPNESS

    # Robust per-half lattice fits, seeded at each frame's coarse
    # translation (the snap window is ±pitch/3 — the stone-edge ridges at
    # ±0.47·pitch stay outside it). Each half measures against ITS OWN
    # expected lattice (_half_geometry), so the fits are absolute.
    a_t, b_t, k_t = jax.vmap(
        lambda p, d: _teeth_fit(p, fx_t + d, sx_t, gsize))(ct, tx)
    a_b, b_b, k_b = jax.vmap(
        lambda p, d: _teeth_fit(p, fx_b + d, sx_b, gsize))(cb, tx)
    a_l, b_l, k_l = jax.vmap(
        lambda p, d: _teeth_fit(p, fy_l + d, sy_l, gsize))(rl, ty)
    a_r, b_r, k_r = jax.vmap(
        lambda p, d: _teeth_fit(p, fy_r + d, sy_r, gsize))(rr, ty)

    lo = 0.375 * n                        # orthogonal-split lever

    th1 = (a_t - a_b) / lo
    th2 = (a_r - a_l) / lo
    v1 = k_t & k_b & ok
    v2 = k_l & k_r & ok
    both_t = v1 & v2
    agree_t = jnp.abs(th1 - th2) < TRACK_DIFF_AGREE
    theta = jnp.where(both_t, 0.5 * (th1 + th2), jnp.where(v1, th1, th2))
    rot_ok = jnp.where(both_t, agree_t, v1 | v2)

    sg1 = 0.5 * (b_t / sx_t + b_b / sx_b) - 1.0
    sg2 = 0.5 * (b_l / sy_l + b_r / sy_r) - 1.0
    both_s = both_t
    agree_s = jnp.abs(sg1 - sg2) < TRACK_DIFF_AGREE
    sigma = jnp.where(both_s, 0.5 * (sg1 + sg2), jnp.where(v1, sg1, sg2))
    scl_ok = jnp.where(both_s, agree_s, v1 | v2)

    # Per-frame ABSOLUTE translation refinement: the mean lattice-center
    # deviation over both halves corrects reference-EMA drift and residual
    # seed error — when both halves fit (a single half would alias θ into
    # translation). DEADBAND: the measured lattice signal's peaks sit a
    # couple px off the geometric truth (renderer/AA/prep asymmetries —
    # ablation measured ~1–2 rect px of standing bias per absolute
    # estimator), so corrections smaller than ~0.12 cell are noise-level
    # content bias, not seed error — suppress them; real seed errors are
    # several px and pass through whole.
    dbx = TRACK_ABS_DEADBAND * 0.5 * (sx_t + sx_b)
    dby = TRACK_ABS_DEADBAND * 0.5 * (sy_l + sy_r)
    cx = 0.5 * (a_t + a_b)
    cy = 0.5 * (a_l + a_r)
    tx = jnp.where(v1 & (jnp.abs(cx) >= dbx), tx + cx, tx)
    ty = jnp.where(v2 & (jnp.abs(cy) >= dby), ty + cy, ty)

    theta = jnp.clip(theta, -TRACK_MAX_THETA, TRACK_MAX_THETA)
    sigma = jnp.clip(sigma, -TRACK_MAX_SIGMA, TRACK_MAX_SIGMA)
    return tx, ty, theta, sigma, sharp, ok, rot_ok, scl_ok


def _apply_similarity(rc_pts: jnp.ndarray, dx, dy, theta, sigma):
    """Apply per-frame similarity updates to rect-space points.

    rc_pts: (k, 2); dx/dy/theta/sigma: (chunk,). → (chunk, k, 2)."""
    c = rc_pts.mean(axis=0)
    v = rc_pts - c                                       # (k, 2)
    cosT, sinT = jnp.cos(theta), jnp.sin(theta)          # (chunk,)
    rot = jnp.stack([jnp.stack([cosT, -sinT], -1),
                     jnp.stack([sinT, cosT], -1)], -2)   # (chunk, 2, 2)
    vv = jnp.einsum("cij,kj->cki", rot, v, precision=_EXACT) \
        * (1.0 + sigma)[:, None, None]
    return c[None, None, :] + vv + jnp.stack([dx, dy], -1)[:, None, :]


def _align_quality(cols, rows, rc_seed, dx, dy, sigma, gsize: int):
    """Lattice-alignment trip-wire signal: the gap-penalized comb score of
    each frame's OWN profiles at the comb position the tracked transform
    predicts. Sharpness (a correlation-peak ratio) provably fails to trip
    under slow model-mismatch drift — the r2 rotation probe measured 1.4
    cells of corner error with sharpness still above threshold — because
    the reference EMA adapts to the drifted content. The comb score is
    ABSOLUTE: teeth off the true lattice score low no matter how self-
    consistent the correlation is. The host compares it to its own EMA.
    """
    c = rc_seed.mean(axis=0)
    ox = c[0] + (rc_seed[0, 0] - c[0]) * (1.0 + sigma) + dx   # (chunk,)
    oy = c[1] + (rc_seed[0, 1] - c[1]) * (1.0 + sigma) + dy
    sx = (rc_seed[1, 0] - rc_seed[0, 0]) * (1.0 + sigma) / (gsize - 1)
    sy = (rc_seed[3, 1] - rc_seed[0, 1]) * (1.0 + sigma) / (gsize - 1)
    qx = jax.vmap(lambda p, o, s: _comb_quality(p, o, s, gsize))(cols, ox, sx)
    qy = jax.vmap(lambda p, o, s: _comb_quality(p, o, s, gsize))(rows, oy, sy)
    return qx + qy


@functools.partial(jax.jit, static_argnames=("gsize", "chunk", "res"))
def track_corners_batch(frames: jnp.ndarray, seed_corners: jnp.ndarray,
                        gsize: int = 19, chunk: int = 8,
                        res: int = REFINE_RES, lens: Lens | None = None):
    """Per-frame board corners across a batch, tracked from a seed detection.

    Full detection (detect_corners) on every frame would cost far more than
    the classification it feeds. Tracking measures each frame's *board
    motion* instead, and keeps the gathers batch-shaped: the
    rectification indices are SHARED across each ``chunk``
    consecutive frames (computed from the running seed, a lax.scan carry),
    so the warp vectorizes across the batch — the same shared-index trick
    as ops.warp.warp_batch_chunked. Each frame's lattice profiles are then
    cross-correlated (one batched matmul) against a slowly-adapting
    reference, giving a coarse (dx, dy) to sub-pixel: all ~19 lattice
    peaks vote coherently, which is far more robust frame-to-frame than
    re-fitting a comb on a profile perturbed by newly placed stones.

    On top of that coarse shift, each frame's measurement is a full 4-DoF
    similarity (translation + in-plane rotation + scale) solved from
    half-split profile lattice fits (_track_measure) — the r2 probe showed
    pure-translation tracking drifts silently to >1 cell under a slowly
    rotating camera while the sharpness gate never trips. Out-of-plane
    (perspective/keystone) drift remains unmodeled; the per-frame
    lattice-alignment score (`align`) is the trip-wire for it — the host
    forces re-detection when it decays below TRACK_ALIGN_TRIP × the
    baseline recorded since the last re-anchor (a running max, never
    EMA-adapted — see report_tracking).

    frames: (B, H, W, 3) uint8/float; seed_corners: (4, 2) from
    detect_corners (or the previous batch's new_seed).
    Returns (corners (B, 4, 2) float32, sharpness (B,), align (B,),
    new_seed (4, 2)).
    """
    with jax.default_matmul_precision("float32"):
        b = frames.shape[0]
        gray = jax.vmap(rgb_to_gray_u8)(frames)
        pad = (-b) % chunk
        if pad:
            gray = jnp.concatenate([gray, gray[-1:].repeat(pad, axis=0)])
        k = gray.shape[0] // chunk
        gc = gray.reshape((k, chunk) + gray.shape[1:])

        # Correlation search window, in rect px (static).
        m = TRACK_MARGIN
        s0 = (res - 1.0) / ((1.0 + m) * (gsize - 1))
        S = max(2, int(round(TRACK_WIN_OFFSET * s0)))

        from camkifu_tpu.ops.warp import _inv3

        def body(carry, frames_chunk):
            seed, ref_col, ref_row, ref_ok = carry
            # Lock residual is chunk-local: the handoff re-anchors on
            # measured corners, so no correction carries across chunks.
            e_lock = jnp.zeros((2,), jnp.float32)
            # Corners are raw frame coords; the rect frame is built in
            # PINHOLE geometry (lens composed into the sampling below), so
            # the canvas lattice stays straight under a distorting lens.
            seed_pin = undistort_pts(lens, seed)
            H = _rect_H(seed_pin, TRACK_MARGIN, res)
            # Where the seed corners ACTUALLY land in rect coords — not the
            # analytic (o0, s0): the frame-space margin expansion is not
            # affine, so the projective residual is several px.
            rc_seed = apply_homography(_inv3(H), seed_pin)    # (4, 2)
            rects = jax.vmap(
                lambda g: _sample_rect(g, H, res, lens))(frames_chunk)
            cf, rf, ct, cb, rl, rr = jax.vmap(
                lambda r: _split_profiles(r, gsize))(rects)
            cols, rows = cf, rf
            # First chunk bootstraps the reference from its first frame (the
            # seed detection ran on/near it, so its lattice sits at rc_seed).
            ref_col = jnp.where(ref_ok, ref_col, cols[0])
            ref_row = jnp.where(ref_ok, ref_row, rows[0])
            sx = (rc_seed[1, 0] - rc_seed[0, 0]) / (gsize - 1)
            sy = (rc_seed[3, 1] - rc_seed[0, 1]) / (gsize - 1)
            first_x = 0.5 * (rc_seed[0, 0] + rc_seed[3, 0])
            first_y = 0.5 * (rc_seed[0, 1] + rc_seed[1, 1])
            (tx, ty, theta, sigma, sharp, ok, rot_ok,
             scl_ok) = _track_measure(cf, rf, ct, cb, rl, rr,
                                      ref_col, ref_row, S,
                                      _half_geometry(rc_seed, res, gsize),
                                      gsize)
            # Reject unmeasurable frames: hold the last good value per DoF.
            dx = _hold_bad(tx, ok)
            dy = _hold_bad(ty, ok)
            theta = _hold_bad(theta, rot_ok & ok)
            sigma = _hold_bad(sigma, scl_ok & ok)

            # Absolute lattice lock (see _abs_lock_update): pin the chunk's
            # first frame to the seed-implied comb; the residual corrects
            # every frame's translation, so seed error cannot persist as a
            # hidden constant offset.
            e_lock = _abs_lock_update(cols[0], rows[0], first_x, first_y,
                                      sx, sy, dx[0], dy[0], ok[0],
                                      e_lock, S, gsize)
            dx = dx + e_lock[0]
            dy = dy + e_lock[1]

            rcs = _apply_similarity(rc_seed, dx, dy, theta, sigma)
            cs = jax.vmap(
                lambda rc: distort_pts(lens, apply_homography(H, rc)))(rcs)
            align = _align_quality(cols, rows, rc_seed, dx, dy, sigma, gsize)
            # Hand off to the next chunk: it re-rectifies at the last
            # frame's corners, so in ITS rect coords the lattice sits at
            # rc_seed2 (exact). Old-rect positions map to new-rect positions
            # by ≈ translation T = rc_seed2 − (rc_seed + d_last); realign
            # both reference parts onto the new anchor (profile_shift moves
            # content left by its argument, i.e. a peak at p → p − arg).
            new_seed = cs[-1]
            ns_pin = undistort_pts(lens, new_seed)
            H2 = _rect_H(ns_pin, TRACK_MARGIN, res)
            rc_seed2 = apply_homography(_inv3(H2), ns_pin)
            anchor = rc_seed.mean(axis=0)                     # (2,)
            anchor2 = rc_seed2.mean(axis=0)
            # old ref: lattice at anchor → want anchor2: shift by anchor−anchor2
            # last profile: lattice at anchor + d_last → shift by a+d−a2.
            new_ref_col = (1 - TRACK_REF_EMA) * _profile_shift(
                ref_col, anchor[0] - anchor2[0]) \
                + TRACK_REF_EMA * _profile_shift(
                    cols[-1], anchor[0] + dx[-1] - anchor2[0])
            new_ref_row = (1 - TRACK_REF_EMA) * _profile_shift(
                ref_row, anchor[1] - anchor2[1]) \
                + TRACK_REF_EMA * _profile_shift(
                    rows[-1], anchor[1] + dy[-1] - anchor2[1])
            return ((new_seed, new_ref_col, new_ref_row, jnp.bool_(True)),
                    (cs, sharp, align))

        carry0 = (seed_corners.astype(jnp.float32),
                  jnp.zeros((res,), jnp.float32),
                  jnp.zeros((res,), jnp.float32), jnp.bool_(False))
        _, (cs, sharp, align) = jax.lax.scan(body, carry0, gc)
        new_seed = cs[-1, -1]
        cs = cs.reshape(k * chunk, 4, 2)[:b]
        sharp = sharp.reshape(k * chunk)[:b]
        align = align.reshape(k * chunk)[:b]
        return cs, sharp, align, new_seed


@functools.partial(jax.jit,
                   static_argnames=("gsize", "zone", "chunk", "pad_cells"))
def rectify_track_batch(frames: jnp.ndarray, seed_corners: jnp.ndarray,
                        gsize: int = 19, zone: int = 16, chunk: int = 16,
                        pad_cells: int = 1, lens: Lens | None = None):
    """FUSED canonical rectification + per-frame board tracking.

    One chunk-shared gather per frame (the warp_batch_chunked trick) warps
    each frame to an EXPANDED canonical canvas whose anchors put the seed's
    corner intersections at STATIC positions; lattice-profile correlation
    against a drift-realigned reference then measures each frame's (dx, dy)
    from its own pixels, and the canonical image is cropped at the measured
    integer offset + sub-pixel-shifted by the fraction. Compared to running
    track_corners_batch AND warp_batch_chunked, this does ONE big gather
    instead of two, and the drift correction comes from measured pixels
    rather than the (possibly stale) corner inputs. Rotation/perspective
    drift is re-anchored by periodic full detection (bf_period).

    Tracking measures a full 4-DoF similarity per frame (_track_measure):
    the corner outputs carry rotation + scale, and the chunk handoff
    re-anchors the canvas on them, so sustained camera rotation no longer
    drifts silently (r2 probe: >1 cell at 4.65° under pure-translation
    tracking). The canonical CROP corrects translation only — residual
    in-chunk rotation is bounded by one chunk's worth (re-anchored every
    `chunk` frames) and stays well under a zone for realistic rates.

    frames: (B, H, W, 3); seed_corners: (4, 2) from detect_corners.
    Returns (canon (B, S, S, 3) float [0,1] with S = gsize·zone,
             corners (B, 4, 2) frame-space, sharpness (B,), align (B,),
             new_seed (4, 2)).
    """
    with jax.default_matmul_precision("float32"):
        b = frames.shape[0]
        scale = 1.0 / 255.0 if frames.dtype == jnp.uint8 else 1.0
        padb = (-b) % chunk
        if padb:
            frames = jnp.concatenate(
                [frames, frames[-1:].repeat(padb, axis=0)])
        k = frames.shape[0] // chunk
        fc = frames.reshape((k, chunk) + frames.shape[1:])

        size = gsize * zone                      # canonical side (304)
        pad = pad_cells * zone                   # drift margin (16)
        E = size + 2 * pad                       # expanded canvas (336)
        lo = pad + zone / 2.0 - 0.5
        hi = pad + size - zone / 2.0 - 0.5
        anchors = jnp.array([[lo, lo], [hi, lo], [hi, hi], [lo, hi]],
                            jnp.float32)
        # Correlation window must stay under one cell (the lattice is
        # periodic) and inside the crop margin.
        S = min(pad - 2, int(round(TRACK_WIN_OFFSET * zone)))
        us = jnp.arange(E, dtype=jnp.float32)
        uu, vv = jnp.meshgrid(us, us, indexing="xy")
        grid = jnp.stack([uu, vv], axis=-1)

        def body(carry, frames_chunk):
            seed, ref_col, ref_row, ref_ok = carry
            # Lock residual is chunk-local (see track_corners_batch.body).
            e_lock = jnp.zeros((2,), jnp.float32)
            # Raw-corner convention: the homography is built in pinhole
            # geometry and the canvas sample grid bends back through the
            # lens — the canvas lattice stays straight under distortion
            # (free: same gather, different coordinates).
            H = homography_dlt(anchors, undistort_pts(lens, seed))
            src = distort_pts(lens, apply_homography(H, grid))
            rect = jax.vmap(lambda f: bilinear_sample(
                f, src[..., 0], src[..., 1]))(frames_chunk) * scale
            luma = jnp.tensordot(
                rect, jnp.asarray([0.299, 0.587, 0.114], jnp.float32),
                axes=([-1], [0]), precision=_EXACT)        # (chunk, E, E)
            cf, rf, ct, cb, rl, rr = jax.vmap(
                lambda r: _split_profiles(r, gsize))(luma)
            cols, rows = cf, rf
            ref_col = jnp.where(ref_ok, ref_col, cols[0])
            ref_row = jnp.where(ref_ok, ref_row, rows[0])
            first = jnp.float32(lo)
            pitch = jnp.float32(zone)
            (tx, ty, theta, sigma, sharp, okf, rot_ok,
             scl_ok) = _track_measure(cf, rf, ct, cb, rl, rr,
                                      ref_col, ref_row, S,
                                      _half_geometry(anchors, E, gsize),
                                      gsize)
            dx = _hold_bad(tx, okf)
            dy = _hold_bad(ty, okf)
            theta = _hold_bad(theta, rot_ok & okf)
            sigma = _hold_bad(sigma, scl_ok & okf)

            # Absolute lattice lock (see _abs_lock_update): in this engine
            # the seed-implied comb is exactly the static anchors (teeth at
            # lo + k·zone by DLT construction), one pitch for both axes.
            e_lock = _abs_lock_update(cols[0], rows[0], first, first,
                                      pitch, pitch, dx[0], dy[0], okf[0],
                                      e_lock, S, gsize)
            dx = dx + e_lock[0]
            dy = dy + e_lock[1]

            # Canonical crop at the integer offset (per-frame dynamic slice,
            # sequential over the chunk — tiny DMAs, no batched gather),
            # then sub-pixel shift by the fractional remainder. The crop
            # offset is clamped to the pad-1 integer headroom + the ±2 px
            # _subpixel_shift range FIRST: dx = correlation (≤ S) + lattice
            # lock can exceed pad-1, and an unclamped fractional remainder
            # would silently saturate inside _subpixel_shift, mis-cropping
            # the whole chunk. Beyond the clamp the canvas simply does not
            # contain the needed pixels; the corner outputs keep the true
            # (unclamped) measurement and the next re-anchor recovers.
            dxc = jnp.clip(dx, -(pad + 1.0), pad + 1.0)
            dyc = jnp.clip(dy, -(pad + 1.0), pad + 1.0)
            ix = jnp.clip(jnp.round(dxc), -(pad - 1), pad - 1)
            iy = jnp.clip(jnp.round(dyc), -(pad - 1), pad - 1)
            fx = dxc - ix
            fy = dyc - iy

            def crop(_, x):
                r, ix_i, iy_i, fx_i, fy_i = x
                c = jax.lax.dynamic_slice(
                    r, (pad + iy_i.astype(jnp.int32),
                        pad + ix_i.astype(jnp.int32), 0),
                    (size, size, rect.shape[-1]))
                return None, _subpixel_shift(c, jnp.stack([fx_i, fy_i]))

            _, canon = jax.lax.scan(crop, None, (rect, ix, iy, fx, fy))

            rcs = _apply_similarity(anchors, dx, dy, theta, sigma)
            cs = jax.vmap(
                lambda rc: distort_pts(lens, apply_homography(H, rc)))(rcs)
            align = _align_quality(cols, rows, anchors, dx, dy, sigma, gsize)
            # Next chunk re-anchors at the last frame's corners: its lattice
            # lands back at `anchors` (exact, by DLT construction), so the
            # old reference needs no shift and the last profile realigns by
            # its own translation.
            new_seed = cs[-1]
            new_ref_col = (1 - TRACK_REF_EMA) * ref_col \
                + TRACK_REF_EMA * _profile_shift(cols[-1], dx[-1])
            new_ref_row = (1 - TRACK_REF_EMA) * ref_row \
                + TRACK_REF_EMA * _profile_shift(rows[-1], dy[-1])
            return ((new_seed, new_ref_col, new_ref_row, jnp.bool_(True)),
                    (canon, cs, sharp, align))

        carry0 = (seed_corners.astype(jnp.float32),
                  jnp.zeros((E,), jnp.float32),
                  jnp.zeros((E,), jnp.float32), jnp.bool_(False))
        _, (canon, cs, sharp, align) = jax.lax.scan(body, carry0, fc)
        new_seed = cs[-1, -1]
        canon = canon.reshape((k * chunk,) + canon.shape[2:])[:b]
        cs = cs.reshape(k * chunk, 4, 2)[:b]
        sharp = sharp.reshape(k * chunk)[:b]
        align = align.reshape(k * chunk)[:b]
        return canon, cs, sharp, align, new_seed


# ---------------------------------------------------------------------------
# Host finder class (the cvconf-registered algorithm; SURVEY §2.1 bf_auto).
# ---------------------------------------------------------------------------

from camkifu_tpu.board.boardfinder import BoardFinder


class BoardFinderAuto(BoardFinder):
    """Automatic goban localization with temporal stabilization: per-batch
    detections accumulate into an EMA once confident; isolated outlier
    detections are rejected (the reference's accumulate-until-stable).

    Once a confident detection exists, every batch is additionally TRACKED
    (track_corners_batch): per-frame corners are measured from each frame's
    own pixels and published through ``corners_batch`` for stones finders
    that accept them; full detection re-runs at bf_period cadence (and
    immediately when tracking sharpness collapses) to re-anchor against
    rotation/scale drift the translation tracker does not model.
    """

    label = "automatic"

    def __init__(self, vmanager):
        super().__init__(vmanager)
        self._estimate: np.ndarray | None = None
        self.track_seed = None             # device (4, 2), batch-fresh
        #: Radial lens model (ops/lens.py), calibrated once at the first
        #: successful anchor — a physical property of the camera, so it
        #: never re-estimates mid-session. None = pinhole. Stones finders
        #: read it (getattr(bf, "lens", None)) and compose it into their
        #: warps; corners everywhere stay raw frame coordinates.
        self.lens = None
        self._lens_checked = False
        self._align_anchor: float | None = None  # align at last re-anchor
        self._prev_tracked_last: np.ndarray | None = None  # (4, 2) continuity
        #: True while this batch's tracking hit a discontinuity (jump trip):
        #: stones finders must not trust readings made with these corners.
        self.suspect_batch = False
        #: True while this batch adopted a fresh full detection (first
        #: anchor, bf_period re-anchor, or post-trip recovery). Stones
        #: finders that know the committed game cross-check the new pose
        #: against it (SfMeta pose veto) and may reject_anchor().
        self.fresh_anchor = False

    def _doframe(self, frames, n: int | None = None) -> None:
        import jax.numpy as jnp

        self.suspect_batch = False
        super()._doframe(frames, n)        # periodic _detect + publish
        self.fresh_anchor = self._since_detect == 0
        if not self.ready():
            self.corners_batch = None
            self.track_seed = None
            return
        if self.track_seed is not None and self._since_detect == 0:
            # A fresh full detection just ran. Rotation/scale drift is
            # invisible to translation tracking, so ALWAYS pull the seed
            # toward the detection: a blend bounds the held drift to ~one
            # detection cadence while halving detection's own corner noise;
            # a jump beyond a cell is a camera bump — hard re-anchor.
            est = np.asarray(self.corners_array, np.float32)
            seed_np = np.asarray(self.track_seed)
            cell = np.linalg.norm(est[1] - est[0]) / (self.gsize - 1)
            if np.abs(seed_np - est).max() > 1.0 * cell:
                self.track_seed = None
            else:
                self.track_seed = jnp.asarray(
                    0.5 * seed_np + 0.5 * est, jnp.float32)
            # A fresh anchor resets the alignment baseline and the
            # frame-to-frame continuity reference (a legitimate re-anchor
            # step must not read as a discontinuity).
            self._align_anchor = None
            self._prev_tracked_last = None
        if self.track_seed is None:
            self.track_seed = jnp.asarray(self.corners_array, jnp.float32)
            self._align_anchor = None
            self._prev_tracked_last = None
        sf = getattr(self.vmanager, "stones_finder", None)
        if getattr(sf, "fused_tracking", False):
            # The stones finder tracks inside its fused rectify+classify
            # pass and reports back through report_tracking.
            return
        cs, sharp, align, new_seed = track_corners_batch(
            jnp.asarray(frames), self.track_seed, gsize=self.gsize,
            lens=self.lens)
        self.report_tracking(np.asarray(cs), new_seed,
                             float(np.asarray(sharp).mean()),
                             self.batch_align(align, sharp))

    @staticmethod
    def batch_align(align, sharp) -> float:
        """Batch lattice-alignment summary: mean over the frames whose
        correlation was sharp (occluded/blurred frames report held offsets —
        their align says nothing about geometric drift)."""
        align = np.asarray(align)
        good = np.asarray(sharp) >= TRACK_MIN_SHARPNESS
        return float(align[good].mean() if good.any() else align.mean())

    def report_tracking(self, corners_batch: np.ndarray, new_seed,
                        mean_sharp: float,
                        mean_align: float | None = None) -> None:
        """Adopt a batch's per-frame tracking result (own or the fused
        stones-finder pass). Three independent trip-wires force a full
        re-detection on the next batch:

        - sharpness collapse — tracking lost outright (bump, occlusion);
        - lattice-alignment decay vs the baseline recorded at the last
          re-anchor — slow model-mismatch drift (out-of-plane perspective
          change) that stays correlation-sharp because the reference EMA
          adapts along with it (the r2 rotation probe's failure mode).
          The baseline is a running MAX since the last re-anchor — never
          EMA-adapted, so arbitrarily slow decay still trips, but a later
          cleaner batch can raise a pin depressed by a partially occluded
          first batch (which would otherwise put the trip threshold out of
          reach of real drift);
        - frame-to-frame discontinuity (TRACK_JUMP_TRIP) — a camera bump.
          Neither other wire can see it: after a knock the correlation
          locks onto a whole-cell-shifted alias of the periodic lattice
          that is both sharp and well-aligned, silently relocating every
          stone. A step this large is also beyond the correlation window,
          so the tracked batch is untrustworthy by construction — drop it
          and flag it suspect so stones finders discard the batch too.
        """
        cb = np.asarray(corners_batch)
        seq = cb if self._prev_tracked_last is None else \
            np.concatenate([self._prev_tracked_last[None], cb])
        steps = np.linalg.norm(np.diff(seq, axis=0), axis=-1)      # (S-1, 4)
        cell = np.linalg.norm(cb[-1, 1] - cb[-1, 0]) / (self.gsize - 1)
        max_step = float(steps.max()) if steps.size else 0.0
        self.metadata["track_step"] = round(max_step, 2)
        jump = cell > 1.0 and max_step > TRACK_JUMP_TRIP * cell
        if jump:
            # A discontinuity is a LEVEL SHIFT, not a spike: after a real
            # bump the lattice stays at the new position, while a 1–2-frame
            # measurement excursion (deep AE dip + shot noise + glare on a
            # dark board — the r4 gauntlet's combination, which stays just
            # above the sharpness gate) returns home. Trip only when the
            # median of the following frames remains displaced from the
            # pre-jump pose; a confirmed spike is absorbed (votes already
            # smooth the one misaligned reading). A jump too close to the
            # batch tail to verify defers: the continuity reference stays
            # at the pre-jump pose, so the next batch re-evaluates it with
            # full evidence.
            j = int(np.argmax(
                (np.max(steps, axis=-1) > TRACK_JUMP_TRIP * cell)))
            after = seq[j + 2:j + 6]
            if len(after) >= 2:
                disp = np.linalg.norm(np.median(after, axis=0) - seq[j],
                                      axis=-1).max()
                if disp <= TRACK_JUMP_TRIP * cell:
                    jump = False                      # spike: absorbed
                    self._prev_tracked_last = cb[-1]
                    self.metadata["track_spike"] = round(max_step, 2)
            else:
                jump = False                          # defer to next batch
                self._prev_tracked_last = seq[j]
            if not jump:
                self.corners_batch = corners_batch
                self.track_seed = new_seed
                self.metadata["track_sharpness"] = round(mean_sharp, 2)
                return
        if jump:
            self._since_detect = 10 ** 9      # force re-detect next batch
            self.track_seed = None
            self.corners_batch = None
            self._align_anchor = None
            self._prev_tracked_last = None
            # The pose history is the thing the trip disproved: the next
            # detection must re-anchor FRESH, not EMA-blend into the
            # pre-bump estimate (measured: a 1-cell knock below _detect's
            # hard-reset threshold crawled at 0.8^k toward the new pose,
            # re-seeding every re-anchor ~0.5 cell stale and pinning the
            # tracker at sharpness ~1.6 for the rest of the game).
            self._estimate = None
            self.suspect_batch = True
            self.metadata["track_trip"] = "jump"
            sf = getattr(self.vmanager, "stones_finder", None)
            if sf is not None:
                sf.on_tracking_discontinuity()
            return
        self._prev_tracked_last = cb[-1]
        self.corners_batch = corners_batch
        self.track_seed = new_seed
        self.metadata["track_sharpness"] = round(mean_sharp, 2)
        if mean_align is not None:
            self.metadata["track_align"] = round(mean_align, 3)
            if self._align_anchor is None or mean_align > self._align_anchor:
                self._align_anchor = mean_align
            elif (self._align_anchor > 0.02
                  and mean_align < TRACK_ALIGN_TRIP * self._align_anchor):
                self._since_detect = 10 ** 9      # force re-detect next batch
                self._estimate = None     # re-anchor fresh (see jump trip)
        if mean_sharp < TRACK_MIN_SHARPNESS:
            self._since_detect = 10 ** 9
            self.track_seed = None
            self.corners_batch = None
            self._align_anchor = None
            self._prev_tracked_last = None
            self._estimate = None         # re-anchor fresh (see jump trip)

    def reject_anchor(self) -> None:
        """A stones finder vetoed the freshly adopted pose (its readings
        wholesale contradict the committed game — SfMeta pose veto): the
        detection was confidently wrong, which full detection CAN be on
        stone-saturated boards rotated ≥~14° in-plane (measured: 3–8 cells
        off at score 0.27–0.35; the 1D combs cannot represent that basin
        and the 2D evidence prior picks a shrunk impostor). Drop the pose
        and every derived state; detection re-runs each batch until a pose
        consistent with the game appears. The alternative — accepting the
        pose — lets bulk self-correction rewrite the entire kifu onto the
        impostor lattice (the pre-trip-wire bump disaster, resurrected
        through the recovery path itself)."""
        self._since_detect = 10 ** 9
        self.track_seed = None
        self.corners_batch = None
        self._align_anchor = None
        self._prev_tracked_last = None
        self._estimate = None             # the pose history is disproved
        self.fresh_anchor = False
        self.suspect_batch = True
        # Unpublish: a vetoed pose must not serve the classic fixed-corner
        # path (or the GUI overlay) while re-anchoring.
        self.corners.clear()
        self.mtx = None
        self.metadata["track_trip"] = "pose_veto"

    def _detect(self, frames) -> bool:
        import jax.numpy as jnp

        # Full detection is costly per frame — sample up to 4 frames of the
        # batch for the median rather than detecting on all of them.
        b = frames.shape[0]
        step = max(1, b // 4)
        sample = jnp.asarray(frames[::step][:4])
        if self.lens is not None:
            # Straight-line detection on pinhole-resampled frames; the
            # per-frame results are bent back to raw coordinates below.
            sample = _undistort_batch(sample, self.lens)
        corners_all, scores = detect_batch(sample, gsize=self.gsize)
        if self.lens is not None:
            corners_all = distort_pts(self.lens, corners_all)
        det = np.asarray(jnp.median(corners_all, axis=0))
        scores = np.asarray(scores)
        if not np.isfinite(det).all() or scores.max() < 0.1:
            return False
        if not self._lens_checked:
            # First successful board sighting: calibrate the (fixed,
            # physical) lens once, and re-run this batch's detection if a
            # lens was found — the pinhole detection that just succeeded
            # is up to ~1.25 cells off at webcam-typical k1 (PERF.md).
            k1, gain = estimate_lens_k1(sample[len(sample) // 2],
                                        gsize=self.gsize)
            self._lens_checked = True
            self.metadata["lens_k1"] = k1
            if k1 != 0.0:
                h, w = frames.shape[1], frames.shape[2]
                self.lens = make_lens(k1, (h, w))
                return self._detect(frames)
        if self._estimate is None:
            self._estimate = det
        else:
            jump = np.abs(det - self._estimate).max()
            cell = np.linalg.norm(self._estimate[1] - self._estimate[0]) \
                / (self.gsize - 1)
            if jump > 1.0 * cell:
                # Camera bump: restart accumulation from the new detection.
                # Detection corner noise measures ≤0.3 cell — a detection a
                # full cell away from the estimate is a moved camera, and
                # EMA-blending it would publish a pose between the two
                # (measured: a 1.05-cell knock crawled at 0.8^k for 5+
                # batches, each published pose wrong by ~0.5 cell).
                self._estimate = det
            else:
                self._estimate = 0.8 * self._estimate + 0.2 * det
        self.corners.clear()
        for p in self._estimate:
            self.corners.add(p)
        return self.corners.ready()


if __name__ == "__main__":          # golden-input probe (SURVEY §4)
    import sys

    import cv2

    from camkifu_tpu.utils import jaxcache

    jaxcache.enable()
    img = cv2.imread(sys.argv[1])
    if img is None:
        sys.exit(f"cannot read image: {sys.argv[1]}")
    det, score = detect_corners(jnp.asarray(img[:, :, ::-1].copy()))
    print("corners (tl,tr,br,bl):", np.asarray(det).round(1).tolist())
    print("score:", float(score))
    if len(sys.argv) > 2:           # optional overlay output
        for x, y in np.asarray(det):
            cv2.circle(img, (int(x), int(y)), 6, (0, 0, 255), 2)
        cv2.imwrite(sys.argv[2], img)
        print("overlay saved:", sys.argv[2])
