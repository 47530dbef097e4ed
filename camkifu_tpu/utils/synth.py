"""Synthetic goban renderer: frames (and whole games) with known ground truth.

The reference could only test against hand-recorded videos with hand-made SGF
oracles (SURVEY §4); this renderer generates them programmatically — a board
state (or move sequence) in, photorealistic-enough camera frames out, with the
exact corner coordinates and SGF available as ground truth. Host-side numpy +
cv2 (cv2 is the drawing/oracle library here, not part of the device path).
"""

from __future__ import annotations

import numpy as np

from camkifu_tpu.config import guiconf
from camkifu_tpu.gamemodel.move import B, W, Move
from camkifu_tpu.gamemodel.rules import RuleUnsafe

WOOD = (193, 154, 107)       # RGB board wood
LINE = (40, 30, 20)
BLACK_STONE = (28, 26, 24)
WHITE_STONE = (235, 233, 228)
TABLE = (70, 75, 60)         # background behind the board

#: Alternative looks for robustness testing: (wood, line, black, white).
PALETTES = {
    "kaya": (WOOD, LINE, BLACK_STONE, WHITE_STONE),
    "walnut": ((120, 85, 55), (25, 18, 12), (20, 20, 22), (228, 224, 210)),
    "bamboo": ((214, 190, 140), (60, 50, 35), (35, 32, 30), (240, 240, 235)),
}


def _wood_grain(size: int, amp: float, key: int) -> np.ndarray:
    """Procedural wood-grain multiplier (size, size): vertical streaks whose
    phase wanders smoothly down the board (growth-ring wiggle) over a
    low-frequency band pattern — the sim-real texture the flat-shaded r2
    boards lacked (VERDICT r2 missing #1). Deterministic per `key` so grain
    is stable across frames of a game (a real board does not shimmer)."""
    rng = np.random.default_rng((0xD00D, key))
    x = np.arange(size, dtype=np.float32)
    # Ring wiggle: smooth random walk along y (box-filtered white noise).
    wander = np.cumsum(rng.normal(0.0, 0.35, size).astype(np.float32))
    k = max(5, size // 24)
    kernel = np.ones(k, np.float32) / k
    wander = np.convolve(wander, kernel, mode="same")
    lam = size / (6.0 + rng.uniform(0, 3))         # streak wavelength
    streaks = np.sin(2 * np.pi * (x[None, :] / lam + 0.08 * wander[:, None]))
    bands = np.sin(2 * np.pi * (x[None, :] / (lam * 3.7)
                                + 0.03 * wander[:, None]) + 1.1)
    fine = rng.normal(0.0, 0.25, (size, size)).astype(np.float32)
    g = 0.55 * streaks + 0.3 * bands + 0.35 * fine
    return 1.0 + amp * g


def render_canonical(labels: np.ndarray, zone: int = 24,
                     rng: np.random.Generator | None = None,
                     stone_jitter: float = 0.0,
                     jitter_key: int = 0,
                     wood_texture: float = 0.0,
                     glare: float = 0.0,
                     palette: str = "kaya") -> np.ndarray:
    """Draw a top-down goban: labels (g, g) int (0=E, 1=B, 2=W) → RGB uint8.

    The image side is g*zone with intersection (r, c) at ((c+.5)z, (r+.5)z),
    matching the canonical-warp convention.
    """
    import cv2

    g = labels.shape[0]
    size = g * zone
    rng = rng or np.random.default_rng(0)
    wood, line, black, white = PALETTES[palette]
    img = np.empty((size, size, 3), np.uint8)
    img[:] = wood
    # Wood grain noise.
    img = np.clip(img.astype(np.int16)
                  + rng.integers(-8, 8, (size, 1, 1)), 0, 255).astype(np.uint8)
    if wood_texture:
        grain = _wood_grain(size, wood_texture, jitter_key)
        img = np.clip(img.astype(np.float32) * grain[..., None],
                      0, 255).astype(np.uint8)
    lo = int(zone / 2)
    hi = int(size - zone / 2)
    for i in range(g):
        p = int((i + 0.5) * zone)
        cv2.line(img, (lo, p), (hi, p), line, 1, cv2.LINE_AA)
        cv2.line(img, (p, lo), (p, hi), line, 1, cv2.LINE_AA)
    # Hoshi points.
    if g == 19:
        for r in (3, 9, 15):
            for c in (3, 9, 15):
                cv2.circle(img, (int((c + .5) * zone), int((r + .5) * zone)),
                           max(2, zone // 10), line, -1, cv2.LINE_AA)
    radius = int(zone * 0.47)
    glare_canvas = np.zeros(img.shape[:2], np.float32) if glare else None
    for r in range(g):
        for c in range(g):
            if labels[r, c] == 0:
                continue
            color = black if labels[r, c] == 1 else white
            jx = jy = 0.0
            if stone_jitter:
                # Deterministic per intersection: a stone keeps its placement
                # error for the whole game, regardless of when neighbors
                # arrive.
                srng = np.random.default_rng((jitter_key, r, c))
                jx, jy = srng.uniform(-stone_jitter, stone_jitter, 2) * zone
            center = (int((c + .5) * zone + jx), int((r + .5) * zone + jy))
            cv2.circle(img, center, radius, color, -1, cv2.LINE_AA)
            # Specular highlight / shading for realism.
            hl = tuple(min(255, v + 35) for v in color)
            cv2.circle(img, (center[0] - radius // 3, center[1] - radius // 3),
                       max(1, radius // 3), hl, -1, cv2.LINE_AA)
            if glare:
                # Overhead-light glare on glossy stone tops: a SATURATED
                # (clipped-to-white) elliptical highlight toward the light,
                # strongest on convex polished stones — the hazard is a
                # black stone whose glare cap reads as white pixels.
                # Deterministic per intersection (the light doesn't move).
                grng = np.random.default_rng((0x61A2E, jitter_key, r, c))
                amp = glare * float(grng.uniform(0.6, 1.0))
                ax = max(2, int(radius * (0.30 + 0.15 * grng.uniform())))
                ay = max(1, int(ax * 0.6))
                gc = (center[0] - int(radius * 0.38),
                      center[1] - int(radius * 0.38))
                cv2.ellipse(glare_canvas, gc, (ax, ay), -30.0, 0, 360,
                            amp, -1, cv2.LINE_AA)
    if glare_canvas is not None:
        glare_canvas = cv2.GaussianBlur(glare_canvas, (0, 0),
                                        max(1.0, radius * 0.18))
        img = np.clip(img.astype(np.float32)
                      + 255.0 * glare_canvas[..., None], 0, 255
                      ).astype(np.uint8)
    return img


def default_corners(frame_hw: tuple[int, int] = (1080, 1920),
                    perspective: float = 0.12) -> np.ndarray:
    """A plausible camera view: board fills most of the frame, mild keystone.

    Returns (4, 2) float32 (x, y) of the corner *intersections*, tl/tr/br/bl.
    """
    h, w = frame_hw
    cx, cy = w / 2.0, h / 2.0
    half = 0.42 * min(h, w)
    k = perspective * half
    return np.array([
        [cx - half + k, cy - half + k * 0.5],   # tl (pushed in: tilt away)
        [cx + half - k, cy - half + k * 0.5],   # tr
        [cx + half, cy + half],                 # br
        [cx - half, cy + half],                 # bl
    ], dtype=np.float32)


def render_frame(labels: np.ndarray, corners: np.ndarray | None = None,
                 frame_hw: tuple[int, int] = (1080, 1920),
                 noise: float = 3.0, seed: int = 0,
                 stone_jitter: float = 0.0,
                 light_gradient: float = 0.0,
                 blur_sigma: float = 0.0,
                 shadow: float = 0.0,
                 jitter_seed: int | None = None,
                 wood_texture: float = 0.0,
                 vignette: float = 0.0,
                 motion_blur: tuple[float, float] | None = None,
                 hand: tuple[float, float, float] | None = None,
                 palette: str = "kaya",
                 lens_k1: float = 0.0,
                 white_balance: float = 0.0,
                 glare: float = 0.0,
                 clutter: int = 0,
                 rolling_shutter: tuple[float, float] | None = None,
                 shot_noise: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """Render a camera frame of the given board state.

    light_gradient: relative brightness falloff corner-to-corner (0.3 =
    one side of the frame 30% darker — uneven room lighting).
    blur_sigma: defocus blur in pixels (camera out of focus).
    shadow: darkness of a soft elliptical shadow over part of the board
    (0.25 = 25% darker inside, feathered edge — a player leaning in).
    wood_texture: procedural grain amplitude (0.1 ≈ visible kaya streaks).
    vignette: corner darkening of the lens (0.25 = 25% darker at corners).
    motion_blur: (dx, dy) px — directional blur of camera motion this frame.
    hand: (x, y, reach) — a hand + forearm over the board, fingertip at
    frame position (x, y); reach ∈ [0, 1] fades it in/out so render_game
    can animate a move being placed.
    lens_k1: radial lens distortion coefficient (r normalized to half the
    short frame side; >0 = barrel — straight board lines bow outward —
    <0 = pincushion; cheap webcams sit around |k1| ≈ 0.03–0.08 at this
    normalization). The returned ground-truth corners are distorted
    through the same model.
    glare: overhead-light specular glare saturating stone tops (0.6 ≈
    clipped-white caps on glossy stones; the classification hazard is a
    black stone whose cap reads white).
    clutter: number of static foreign objects (capture bowls, a mug) on
    the table around the board — detection hazards with stone-like discs
    and board-like straight edges. Placement is deterministic per
    jitter_seed (objects don't move between frames of a game).
    rolling_shutter: (dx, dy) px — the full top-to-bottom scan displacement
    of a CMOS rolling shutter under camera motion: row y shows the scene
    shifted by (dx, dy)·y/H (vertical lines shear, the "jello" skew).
    Ground-truth corners are displaced through the same model.
    shot_noise: photon shot-noise gain — per-pixel noise std becomes
    sqrt(noise² + shot_noise·I) (dark read-noise floor + signal-dependent
    shot noise), replacing the flat gaussian grain; bright regions get
    visibly noisier, as on a real sensor.
    Returns (frame uint8 RGB (H, W, 3), corners (4, 2) float32 (x, y)).
    """
    import cv2

    rng = np.random.default_rng(seed)
    g = labels.shape[0]
    zone = 24
    # Stone placement jitter must be stable across frames of the same game
    # (stones sit still once played); camera noise varies per frame.
    canon = render_canonical(labels, zone=zone, rng=rng,
                             stone_jitter=stone_jitter,
                             jitter_key=jitter_seed if jitter_seed is not None
                             else seed, wood_texture=wood_texture,
                             glare=glare, palette=palette)
    h, w = frame_hw
    corners = default_corners(frame_hw) if corners is None else \
        np.asarray(corners, np.float32)
    # Canonical corner-intersection positions (x, y), tl/tr/br/bl.
    lo, hi = zone / 2.0, g * zone - zone / 2.0
    src = np.array([[lo, lo], [hi, lo], [hi, hi], [lo, hi]], np.float32)
    M = cv2.getPerspectiveTransform(src, corners)
    frame = np.empty((h, w, 3), np.uint8)
    frame[:] = TABLE
    frame = np.clip(frame.astype(np.int16)
                    + rng.integers(-6, 6, (h, w, 1)), 0, 255).astype(np.uint8)
    # Warp the board in, with a mask to blend over the table. The board slab
    # extends half a cell beyond the outer grid lines (like a real goban edge).
    warped = cv2.warpPerspective(canon, M, (w, h), flags=cv2.INTER_LINEAR)
    mask = cv2.warpPerspective(np.full(canon.shape[:2], 255, np.uint8), M,
                               (w, h), flags=cv2.INTER_NEAREST)
    frame[mask > 0] = warped[mask > 0]
    if clutter:
        frame = _draw_clutter(frame, mask, corners, clutter,
                              jitter_seed if jitter_seed is not None
                              else seed)
    if shadow:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        cx, cy = 0.65 * w, 0.4 * h
        d = np.sqrt(((xx - cx) / (0.35 * w)) ** 2
                    + ((yy - cy) / (0.45 * h)) ** 2)
        dark = 1.0 - shadow * np.clip(1.5 - d, 0.0, 1.0)
        frame = np.clip(frame.astype(np.float32) * dark[..., None],
                        0, 255).astype(np.uint8)
    if hand is not None and hand[2] > 0.0:
        frame = _draw_hand(frame, hand, rng)
    if lens_k1:
        # Radial distortion of the composed scene (optics happen before
        # the sensor): output pixel p_d samples the pinhole scene at the
        # inverse of p_d = c + (p_u − c)(1 + k1·r_u²), r normalized to
        # half the short side. The inverse radius comes from 4 fixed-point
        # iterations (exact to <1e-3 px for |k1| ≤ 0.2).
        s = min(h, w) / 2.0
        ccx, ccy = w / 2.0, h / 2.0
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        rd = np.sqrt((xx - ccx) ** 2 + (yy - ccy) ** 2) / s
        ru = rd.copy()
        for _ in range(4):
            ru = rd / (1.0 + lens_k1 * ru * ru)
        scale = np.where(rd > 1e-9, ru / np.maximum(rd, 1e-9), 1.0)
        map_x = (ccx + (xx - ccx) * scale).astype(np.float32)
        map_y = (ccy + (yy - ccy) * scale).astype(np.float32)
        frame = cv2.remap(frame, map_x, map_y, cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_REPLICATE)
        pc = corners - np.array([ccx, ccy], np.float32)
        r_u = np.linalg.norm(pc, axis=1, keepdims=True) / s
        corners = (np.array([ccx, ccy], np.float32)
                   + pc * (1.0 + lens_k1 * r_u ** 2)).astype(np.float32)
    if rolling_shutter is not None and any(rolling_shutter):
        # CMOS scan skew: row y is read y/H of a frame-time later, so under
        # camera motion it shows the scene displaced by (dx, dy)·y/H.
        # Output (x, y) therefore samples the nominal (row-0-time) scene at
        # (x − dx·y/H, y − dy·y/H).
        dx, dy = float(rolling_shutter[0]), float(rolling_shutter[1])
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        t = yy / float(h)
        frame = cv2.remap(frame, xx - dx * t, yy - dy * t, cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_REPLICATE)
        # Ground truth moves with the rows: y_out = y/(1 − dy/H), then the
        # x shear is evaluated at the row actually hit.
        cy = corners[:, 1] / max(1e-6, 1.0 - dy / float(h))
        corners = np.stack([corners[:, 0] + dx * cy / float(h), cy],
                           axis=1).astype(np.float32)
    if motion_blur is not None:
        dx, dy = float(motion_blur[0]), float(motion_blur[1])
        n_k = max(3, int(np.hypot(dx, dy)) | 1)
        if np.hypot(dx, dy) >= 1.0:
            k = np.zeros((n_k, n_k), np.float32)
            cv2.line(k, (int(n_k / 2 - dx / 2), int(n_k / 2 - dy / 2)),
                     (int(n_k / 2 + dx / 2), int(n_k / 2 + dy / 2)),
                     1.0, 1)
            k /= max(k.sum(), 1e-6)
            frame = cv2.filter2D(frame, -1, k)
    if blur_sigma:
        k = int(blur_sigma * 6) | 1
        frame = cv2.GaussianBlur(frame, (k, k), blur_sigma)
    if light_gradient:
        gx = np.linspace(1.0, 1.0 - light_gradient, w, dtype=np.float32)
        gy = np.linspace(1.0, 1.0 - 0.5 * light_gradient, h,
                         dtype=np.float32)
        frame = np.clip(frame.astype(np.float32)
                        * (gy[:, None] * gx[None, :])[..., None],
                        0, 255).astype(np.uint8)
    if vignette:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        r2 = (((xx - w / 2) / (w / 2)) ** 2
              + ((yy - h / 2) / (h / 2)) ** 2) / 2.0
        frame = np.clip(frame.astype(np.float32)
                        * (1.0 - vignette * r2)[..., None],
                        0, 255).astype(np.uint8)
    if white_balance:
        # Miscalibrated camera WB: warm (+) boosts R and cuts B, cool (−)
        # the reverse — shifts every chroma statistic the detectors use.
        f = frame.astype(np.float32)
        f[..., 0] *= 1.0 + white_balance
        f[..., 2] *= 1.0 - white_balance
        frame = np.clip(f, 0, 255).astype(np.uint8)
    if shot_noise:
        # Physical sensor model: read-noise floor (``noise``) + signal-
        # dependent photon shot noise — std grows with sqrt(intensity).
        f = frame.astype(np.float32)
        std = np.sqrt(noise * noise + shot_noise * f)
        frame = np.clip(f + rng.standard_normal(f.shape).astype(np.float32)
                        * std, 0, 255).astype(np.uint8)
    elif noise:
        frame = np.clip(frame.astype(np.float32)
                        + rng.normal(0, noise, frame.shape), 0, 255
                        ).astype(np.uint8)
    return frame, corners


#: Skin/sleeve colors for the animated hand.
_SKIN = (198, 160, 128)
_SLEEVE = (52, 56, 84)


def _draw_hand(frame: np.ndarray, hand, rng) -> np.ndarray:
    """A hand + forearm reaching in from the bottom edge, fingertip at
    (x, y), with a soft drop shadow under it. reach ∈ (0, 1] interpolates
    the fingertip from the bottom edge to (x, y) — animating it across
    frames produces the moving occluder real recordings have (a player
    placing a stone), which the flat r2 synth lacked."""
    import cv2

    h, w = frame.shape[:2]
    x, y, reach = float(hand[0]), float(hand[1]), float(hand[2])
    # Entry point on the bottom edge, roughly under the target.
    ex = np.clip(x + 0.18 * w, 0, w - 1)
    tip = np.array([ex + (x - ex) * reach, h - 1 + (y - (h - 1)) * reach],
                   np.float32)
    arm_dir = np.array([ex, h - 1], np.float32) - tip
    nrm = np.linalg.norm(arm_dir) + 1e-6
    arm_dir /= nrm
    ang = np.degrees(np.arctan2(arm_dir[1], arm_dir[0]))
    # Soft shadow (offset toward the light's opposite side).
    sh = frame.astype(np.float32)
    mask = np.zeros((h, w), np.uint8)
    cv2.ellipse(mask, (int(tip[0] + 12), int(tip[1] + 14)), (38, 22),
                ang, 0, 360, 80, -1)
    cv2.line(mask, (int(tip[0] + 12 + arm_dir[0] * 30),
                    int(tip[1] + 14 + arm_dir[1] * 30)),
             (int(ex + 12), h - 1), 60, 44)
    mask = cv2.GaussianBlur(mask, (31, 31), 12)
    sh *= (1.0 - (mask.astype(np.float32) / 255.0) * 0.5)[..., None]
    frame = np.clip(sh, 0, 255).astype(np.uint8)
    overlay = frame.copy()
    # Forearm (sleeve) then hand blob + two fingers.
    cv2.line(overlay, (int(tip[0] + arm_dir[0] * 34),
                       int(tip[1] + arm_dir[1] * 34)),
             (int(ex), h - 1), _SLEEVE, 40)
    cv2.ellipse(overlay, (int(tip[0] + arm_dir[0] * 16),
                          int(tip[1] + arm_dir[1] * 16)), (26, 17),
                ang, 0, 360, _SKIN, -1)
    f1 = tip + np.array([-arm_dir[1], arm_dir[0]]) * 5
    f2 = tip - np.array([-arm_dir[1], arm_dir[0]]) * 5
    for f in (f1, f2):
        cv2.line(overlay, (int(f[0] + arm_dir[0] * 18),
                           int(f[1] + arm_dir[1] * 18)),
                 (int(f[0]), int(f[1])), _SKIN, 7)
    return cv2.addWeighted(overlay, 0.96, frame, 0.04, 0)


def _draw_clutter(frame: np.ndarray, board_mask: np.ndarray,
                  corners: np.ndarray, n: int, key: int) -> np.ndarray:
    """Static foreign objects on the table around the board: capture bowls
    (dark glossy discs holding stone-colored discs — the detection hazard
    is stone-like circles OFF the lattice) and a mug (straight bright
    edges — a competing quad candidate). Never overlaps the board slab
    (real objects sit beside it); deterministic per ``key`` so objects
    stay put across the frames of a game."""
    import cv2

    h, w = frame.shape[:2]
    rng = np.random.default_rng((0xB071, key))
    # Keep-out: the board hull, dilated by a real-world margin (players
    # keep bowls a hand's width from the slab; a too-small margin also
    # merges the objects' edge-density halos into the board's at the
    # coarse resolution, which no component logic can then separate).
    keep_out = cv2.dilate(board_mask, np.ones((25, 25), np.uint8))
    out = frame.copy()
    placed = 0
    for _ in range(n * 12):
        if placed >= n:
            break
        x = int(rng.uniform(0.04, 0.96) * w)
        y = int(rng.uniform(0.04, 0.96) * h)
        r = int(rng.uniform(0.035, 0.075) * min(h, w))
        y0, y1 = max(0, y - r - 4), min(h, y + r + 4)
        x0, x1 = max(0, x - r - 4), min(w, x + r + 4)
        if keep_out[y0:y1, x0:x1].any():
            continue
        if placed % 3 == 2:
            # A mug: bright rounded rectangle + elliptical rim — straight
            # high-contrast edges near the board.
            col = (rng.integers(150, 230),) * 3
            cv2.rectangle(out, (x - r, y - int(r * 0.8)),
                          (x + r, y + int(r * 0.8)),
                          tuple(int(v) for v in col), -1)
            cv2.ellipse(out, (x, y - int(r * 0.8)), (r, int(r * 0.35)),
                        0, 0, 360, tuple(int(v * 0.8) for v in col), -1,
                        cv2.LINE_AA)
        else:
            # A capture bowl: dark wooden disc with a rim highlight and a
            # few captured stones inside (alternating bowls hold B and W).
            wood = (int(rng.integers(50, 90)), int(rng.integers(35, 65)),
                    int(rng.integers(20, 45)))
            cv2.circle(out, (x, y), r, wood, -1, cv2.LINE_AA)
            cv2.circle(out, (x, y), r,
                       tuple(min(255, int(v * 1.6)) for v in wood), 2,
                       cv2.LINE_AA)
            stone_col = ((28, 26, 24) if placed % 3 == 0
                         else (235, 233, 228))
            for _s in range(int(rng.integers(3, 7))):
                ang = rng.uniform(0, 2 * np.pi)
                rad = rng.uniform(0, 0.55) * r
                sr = max(2, int(r * 0.22))
                cv2.circle(out, (int(x + rad * np.cos(ang)),
                                 int(y + rad * np.sin(ang))), sr,
                           stone_col, -1, cv2.LINE_AA)
        placed += 1
    return out


def encode_roundtrip(frames, codec: str = "mp4v", fps: int = 25,
                     path: str | None = None) -> list[np.ndarray]:
    """Encode frames to a video file and decode them back — the sensor/
    compression artifact pass (macroblocking, chroma subsampling, ringing)
    between the renderer and the pipeline. Returns the decoded RGB frames.
    """
    import os
    import tempfile

    import cv2

    own = path is None
    if own:
        fd, path = tempfile.mkstemp(suffix=".mp4")
        os.close(fd)
    try:
        # Stream rendered frames straight into the encoder: materializing
        # the full game on both sides of the codec would double the peak
        # host RSS (a synth:100 realism game at 720p is ~2 GB per side).
        vw = None
        n_in = 0
        for f in frames:
            if vw is None:
                h, w = f.shape[:2]
                vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*codec),
                                     fps, (w, h))
                if not vw.isOpened():
                    raise RuntimeError(
                        f"VideoWriter failed for codec {codec!r}")
            vw.write(f[:, :, ::-1])
            n_in += 1
        if vw is None:
            raise RuntimeError("encode round-trip got no frames")
        vw.release()
        cap = cv2.VideoCapture(path)
        out = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            out.append(f[:, :, ::-1].copy())
        cap.release()
    finally:
        if own:
            os.unlink(path)
    if len(out) != n_in:
        raise RuntimeError(
            f"encode round-trip dropped frames: {n_in} in, "
            f"{len(out)} out")
    return out


def game_states(moves: list[Move], gsize: int = guiconf.gsize):
    """Board-state (g, g) int8 label grid after each move (rules applied,
    captures removed). Yields (state_after_move, move)."""
    rule = RuleUnsafe(gsize=gsize)
    for move in moves:
        rule.put(move)
        rule.confirm()
        yield rule.as_labels(), move


def render_game(moves: list[Move], frames_per_move=3,
                corners: np.ndarray | None = None,
                frame_hw: tuple[int, int] = (720, 1280),
                gsize: int = guiconf.gsize, seed: int = 0,
                empty_leadin: int = 2, hand_frames: int = 0,
                flicker: float = 0.0, removal_lag: int = 0,
                corners_fn=None, wb_drift: float = 0.0,
                rolling_shutter: float = 0.0, vfr: float = 0.0,
                arm_rests=None, **frame_kwargs):
    """Yield (frame, state_labels) for a whole game: ``empty_leadin`` frames of
    the empty board, then ``frames_per_move`` frames after each move. Extra
    kwargs (stone_jitter, light_gradient, blur_sigma, shadow, wood_texture,
    vignette, …) pass through to render_frame.

    frames_per_move may be a sequence with one entry per move — e.g. to
    model the players pausing mid-game (a knocked camera's settle time, a
    long think) by holding one position longer.

    corners_fn, if given, is called with the global frame index and must
    return that frame's (4, 2) board corners — a MOVING camera (handheld
    drift/rotation, or a discontinuous bump). It overrides ``corners``;
    the hand animation follows the moving pose.

    hand_frames > 0 animates a hand RETREATING from each just-played stone
    over that many frames (a real recording's moving occluder): frame 0
    after a move has the hand covering the new stone, then it withdraws.

    flicker > 0 simulates camera auto-exposure hunting: a per-frame global
    gain doing a seeded random walk within [1−flicker, 1+flicker], with a
    reactive dip toward 1−0.8·flicker while the hand is in frame (real AE
    compensates for the bright hand exactly when moves are played). At
    flicker=0.15 consecutive-frame steps reach ~10–15% — the regime
    measured to stall an exposure-naive motion gate board-wide.

    removal_lag > 0 keeps CAPTURED stones physically on the board for that
    many frames after the capturing move (real players lift captures out
    seconds late, often after the next move is already played); a hand
    sweeps over the group on its final lingering frames when hand_frames
    is on. The yielded state is the RENDERED one (stale stones included) —
    it is what the frame shows; game truth is ``game_states(moves)``.

    rolling_shutter > 0 shears each frame by that fraction of its own
    inter-frame camera motion (CMOS scan skew: ~0.5–0.9 of frame time for
    typical sensors) — only moving cameras (corners_fn) shear, and the
    shear direction/size tracks the actual motion, bump frames included.

    vfr > 0 simulates variable frame rate: with probability vfr/2 a frame
    is an exact DUPLICATE of the previous one (encoder freeze — its state
    label is the previous frame's), and with probability vfr/2 the camera
    clock jumps 1–2 extra steps (dropped frames — per-frame motion steps
    double or triple, stressing the tracker's continuity window).

    arm_rests: iterable of (move_index, n_frames) — after that move's
    normal frames, a hand + forearm RESTS motionless over the board for
    n_frames (a player thinking with their arm in frame for multiple
    seconds); votes under it must hold, not decay into phantom reads.
    """
    import cv2

    empty = np.zeros((gsize, gsize), np.int8)
    corners = default_corners(frame_hw) if corners is None else corners
    zone = 24
    lo, hi = zone / 2.0, gsize * zone - zone / 2.0
    src = np.array([[lo, lo], [hi, lo], [hi, hi], [lo, hi]], np.float32)
    fpm = (list(frames_per_move) if not isinstance(frames_per_move, int)
           else [frames_per_move] * len(moves))
    if len(fpm) != len(moves):
        raise ValueError(f"frames_per_move sequence has {len(fpm)} entries "
                         f"for {len(moves)} moves")

    def corners_at(idx):
        if corners_fn is None:
            return corners
        return np.asarray(corners_fn(idx), np.float32)

    rng_f = np.random.default_rng(seed + 940229)
    rng_wb = np.random.default_rng(seed + 615243)   # own stream: adding WB
    gain = 1.0                                      # must not move flicker
    wb = 0.0

    def expose(frame, hand_active):
        """Camera auto-pipeline per frame: AE gain hunting (``flicker``)
        and auto-white-balance hunting (``wb_drift`` — a random walk of
        the R/B gains within ±wb_drift, the slow color-temperature
        breathing real cameras show as the scene content changes)."""
        nonlocal gain, wb
        if wb_drift:
            wb += float(rng_wb.normal(0.0, 0.25 * wb_drift))
            wb = float(np.clip(wb, -wb_drift, wb_drift))
        if not flicker and not wb_drift:
            return frame
        if flicker:
            target = 1.0 - 0.8 * flicker if hand_active else 1.0
            gain += 0.35 * (target - gain) + rng_f.normal(0.0, 0.4 * flicker)
            gain = float(np.clip(gain, 1.0 - flicker, 1.0 + flicker))
        f = frame.astype(np.float32) * gain
        if wb_drift:
            f[..., 0] *= 1.0 + wb
            f[..., 2] *= 1.0 - wb
        return np.clip(f, 0, 255).astype(np.uint8)

    def to_frame_xy(row, col, idx):
        Mi = cv2.getPerspectiveTransform(
            src, np.asarray(corners_at(idx), np.float32))
        p = Mi @ np.array([(col + 0.5) * zone, (row + 0.5) * zone, 1.0])
        return p[0] / p[2], p[1] / p[2]

    #: (row, col) → [color_int, frames_left] of captured-but-not-yet-removed
    #: stones; counts down across move boundaries (lag routinely spans them).
    linger: dict[tuple[int, int], list[int]] = {}
    prev_state = empty
    rests = dict(arm_rests or ())
    rng_vfr = np.random.default_rng(seed + 424242)
    last_emit = None         # (frame, shown) of the previous rendered frame

    i = 0

    def render_one(shown_state, hand=None):
        """One camera frame at the current clock ``i``: VFR anomalies,
        motion-derived rolling shutter, then render. Returns
        (frame, state_shown) — for a duplicated frame, the PREVIOUS pair."""
        nonlocal i, last_emit
        if vfr and last_emit is not None:
            u = float(rng_vfr.uniform())
            if u < vfr / 2.0:                 # encoder freeze: exact dup
                return last_emit
            if u > 1.0 - vfr / 2.0:           # dropped frames: clock jumps
                i += int(rng_vfr.integers(1, 3))
        kw = frame_kwargs
        if rolling_shutter and i > 0:
            v = (np.asarray(corners_at(i), np.float32)
                 - np.asarray(corners_at(i - 1), np.float32)).mean(axis=0)
            kw = dict(frame_kwargs,
                      rolling_shutter=(rolling_shutter * float(v[0]),
                                       rolling_shutter * float(v[1])))
        frame, _ = render_frame(shown_state, corners_at(i), frame_hw,
                                seed=seed + i, jitter_seed=seed, hand=hand,
                                **kw)
        i += 1
        last_emit = (frame, shown_state)
        return last_emit

    for _ in range(empty_leadin):
        frame, shown = render_one(empty)
        yield expose(frame, False), shown
    for mi, (state, move) in enumerate(game_states(moves, gsize)):
        if removal_lag and (move.row, move.col) in linger:
            # The next move lands on a point whose captured stone is still
            # physically there — impossible: the player sweeps the dead
            # stones off first. Render that cleanup as a beat of the TRUE
            # pre-move position (all lingering captures gone) so readings
            # see the vacated points empty before the stone arrives.
            linger.clear()
            for _ in range(fpm[mi]):
                frame, shown = render_one(prev_state)
                yield expose(frame, False), shown
        if removal_lag:
            gone = (prev_state != 0) & (state == 0)
            for r, c in np.argwhere(gone):
                linger[(int(r), int(c))] = [int(prev_state[r, c]),
                                            removal_lag]
        prev_state = state
        for j in range(fpm[mi]):
            hand = None
            if hand_frames and j < hand_frames:
                x, y = to_frame_xy(move.row, move.col, i)
                hand = (x, y, 1.0 - j / float(hand_frames))
            shown = state
            if linger:
                shown = state.copy()
                removing = []
                for (r, c), entry in list(linger.items()):
                    color, left = entry
                    if left <= 0 or state[r, c] != 0:
                        del linger[(r, c)]     # removed, or legally reused
                        continue
                    shown[r, c] = color
                    entry[1] = left - 1
                    if left <= hand_frames:
                        removing.append((r, c, left))
                if removing and hand is None and hand_frames:
                    # The removing hand reaches IN over the group it is
                    # lifting out (reach grows as frames_left shrinks).
                    rr = float(np.mean([r for r, _, _ in removing]))
                    cc = float(np.mean([c for _, c, _ in removing]))
                    x, y = to_frame_xy(rr, cc, i)
                    hand = (x, y,
                            1.0 - min(l for _, _, l in removing)
                            / float(hand_frames))
            frame, shown_out = render_one(shown, hand=hand)
            yield expose(frame, hand is not None), shown_out
        for _ in range(rests.get(mi, 0)):
            # The player's arm RESTS over the board (multi-second
            # occlusion): fingertip parked a few cells south of the move,
            # motionless at full reach; AE keeps reacting to it.
            rx, ry = to_frame_xy(min(gsize - 1, move.row + 3), move.col, i)
            frame, shown_out = render_one(shown, hand=(rx, ry, 0.9))
            yield expose(frame, True), shown_out


def moves_from_sgf(path: str) -> list[Move]:
    from camkifu_tpu.gamemodel.kifu import Kifu
    return Kifu.load(path).moves()


def capture_rich_moves(n: int = 24, gsize: int = guiconf.gsize,
                       seed: int = 7) -> list[Move]:
    """An alternating game guaranteed to contain captures: a scripted
    opening where B captures a TWO-stone W group (move 11) and then a
    single W stone (move 19), padded to ``n`` with random capture-free
    filler. Multi-stone captures are the adversarial case for move
    extraction: re-placing one captured stone is legal (its vacated
    neighbors are liberties), so a reading that still shows the group
    pending physical removal looks like playable new moves.
    """
    assert gsize >= 9, "the scripted set pieces need at least a 9x9 board"
    gs, m = gsize, gsize // 2
    # Tenuki spots scale with the board (9x9/13x13 work too) and are
    # hand-placed clear of both capture clusters (top-left opening rows
    # ≤3 / cols ≤4, center cross at (m, m)±1).
    t = [(gs - 2, gs - 2), (gs - 3, 2), (gs - 2, gs - 5), (2, gs - 2),
         (gs - 5, gs - 2)]
    script = [
        # B builds the surround of W (2,2)+(2,3); W tenukis elsewhere.
        (B, 3, 2), (W, 2, 2), (B, 2, 1), (W, 2, 3), (B, 1, 2), (W, *t[0]),
        (B, 1, 3), (W, *t[1]), (B, 3, 3), (W, *t[2]),
        (B, 2, 4),                         # captures W (2,2) and (2,3)
        # Single-stone capture of W at the board center.
        (W, m, m), (B, m - 1, m), (W, *t[3]), (B, m + 1, m), (W, *t[4]),
        (B, m, m - 1), (W, 3, gs - 4),
        (B, m, m + 1),                     # captures W (m, m)
    ]
    rule = RuleUnsafe(gsize=gsize)
    moves = []
    for spec in script:                    # never truncated: n < len(script)
        m = Move("np", spec, gsize=gsize)  # returns the whole script (the
        rule.put(m)                        # captures are the point)
        rule.confirm()
        moves.append(m)
    rng = np.random.default_rng(seed)
    color = W if moves[-1].color == B else B
    tries = 0
    while len(moves) < n and tries < 80 * n:
        tries += 1
        r, c = int(rng.integers(gsize)), int(rng.integers(gsize))
        m = Move("np", (color, r, c), gsize=gsize)
        try:
            if rule.put(m):                # filler must not capture
                rule.discard()
                continue
            rule.confirm()
        except Exception:
            continue
        moves.append(m)
        color = W if color == B else B
    return moves


def gauntlet_scenario(n_moves: int = 19, seed: int = 11,
                      frame_hw: tuple[int, int] = (720, 1280),
                      gsize: int = guiconf.gsize):
    """THE GAUNTLET — every adversity at once, one game (see
    tests/test_gauntlet.py for the full rationale). Returns
    ``(moves, frames_factory)``: the ground-truth kifu and a zero-arg
    callable yielding the footage. The scenario stacks a capture-rich game
    with 60-frame physical removal lag, a handheld drifting + slowly
    rotating + slowly zooming camera, a mid-game camera BUMP landing while
    captured stones are still pending removal, auto-exposure flicker,
    auto-white-balance hunting (±8% R/B gain random walk), the full
    realism pass (grain, vignette, defocus, gradient, shadow, jitter,
    animated hand, walnut palette), the tier-3 sensor/scene hazards
    (rolling-shutter skew from the camera's own motion, shot+read sensor
    noise, specular glare saturating stone tops, capture bowls + a mug on
    the table, a multi-second resting-arm occlusion, variable frame rate
    with duplicated and dropped frames), and an mp4 encode round-trip.
    Runs at 9x9 and 13x13 as well as 19x19 (``gsize``).

    Reference parity: the reference was exercised on real recorded games
    where all of these co-occur (SURVEY §0.6, §4) — this is the closest
    synthetic equivalent; the bar is exact move-for-move agreement.
    """
    from camkifu_tpu.config import cvconf

    moves = capture_rich_moves(max(n_moves, 19), gsize=gsize, seed=seed)
    # +6, not the usual +3: the VFR hazard replaces ~vfr/2 of the frames
    # with duplicates of the previous position and the hand covers 2 more,
    # so the distinct-observation budget per move must clear the vote
    # window with margin (a real recording holds each position for
    # hundreds of frames; this pacing is already compressed ~20×).
    fpm = cvconf.vote_window + 6
    fpm_list = [fpm] * len(moves)
    fpm_list[13] += 36       # the players pause after the table is knocked
    fpm_list[-1] += 12       # trailing hold so the last move's votes commit
    leadin = 6
    # The knock lands mid-pause, while the two-stone capture's dead stones
    # are STILL physically on the board (lag 60 frames spans moves 10→16).
    bump_at = leadin + sum(fpm_list[:13]) + fpm

    base = default_corners(frame_hw)
    c0 = base.mean(axis=0)
    # The camera's TOTAL excursion is fixed (10° rotation + 6% zoom over
    # the whole game — the r3 envelope) and per-frame rates derive from the
    # timeline length: rates hardcoded per frame once silently grew with a
    # pacing change until the board's corner left the frame near the end,
    # which no detector can fix.
    total = leadin + sum(fpm_list)

    def cam(i):
        # Handheld: drift ≤0.7 px/frame, slow rotation and zoom — all an
        # order of magnitude under the jump trip.
        th = np.deg2rad(10.0) * i / total
        s = 1.0 + 0.06 * i / total
        if i >= bump_at:                   # the knock: +2° and ~31 px, once
            th += np.deg2rad(2.0)
        rot = np.array([[np.cos(th), -np.sin(th)],
                        [np.sin(th), np.cos(th)]], np.float32)
        cs = c0 + s * (base - c0) @ rot.T
        cs += np.array([6.0 * np.sin(i / 9.0), 5.0 * np.cos(i / 11.0)],
                       np.float32)
        if i >= bump_at:
            cs += np.array([26.0, -17.0], np.float32)
        return cs.astype(np.float32)

    def frames_factory():
        it = (f for f, _ in render_game(
            moves, frames_per_move=fpm_list, frame_hw=frame_hw, seed=seed,
            empty_leadin=leadin, corners_fn=cam, gsize=gsize,
            hand_frames=2, flicker=0.12, wb_drift=0.08, removal_lag=60,
            stone_jitter=0.07, light_gradient=0.3, blur_sigma=1.2,
            shadow=0.18, wood_texture=0.10, vignette=0.22,
            rolling_shutter=0.7, vfr=0.12, arm_rests=[(6, fpm)],
            glare=0.5, clutter=3, shot_noise=0.4,
            palette="walnut"))
        return iter(encode_roundtrip(it))

    return moves, frames_factory


def sample_moves(n: int = 40, gsize: int = guiconf.gsize, seed: int = 7
                 ) -> list[Move]:
    """A random legal alternating game (no captures sought, suicide avoided)."""
    rng = np.random.default_rng(seed)
    rule = RuleUnsafe(gsize=gsize)
    moves = []
    color = B
    tries = 0
    while len(moves) < n and tries < 50 * n:
        tries += 1
        r, c = int(rng.integers(gsize)), int(rng.integers(gsize))
        try:
            rule.put(Move("np", (color, r, c), gsize=gsize))
            rule.confirm()
        except Exception:
            continue
        moves.append(Move("np", (color, r, c), gsize=gsize))
        color = W if color == B else B
    return moves
