"""Per-frame corner tracking (BASELINE config 4 — honest per-frame board
re-detection): bf_auto.track_corners_batch.

The tracker measures each frame's board translation from that frame's own
pixels (chunk-shared rectification + lattice-profile correlation); full
detection re-anchors it at bf_period cadence. Reference parity: the
reference re-runs BoardFinderAuto._detect periodically and tracks corner
drift (SURVEY §2.1 boardfinder); per-frame measurement is the device upgrade.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from camkifu_tpu.board import bf_auto
from camkifu_tpu.config import cvconf
from camkifu_tpu.core.gamesync import MoveExtractor, score_moves
from camkifu_tpu.stone import sf_meta
from camkifu_tpu.utils import synth

HW = (720, 1280)
RES = 320


def _drifting_frames(labels, n, amp=(12.0, 9.0), seed=11):
    base = synth.default_corners(HW)
    frames, gts = [], []
    for i in range(n):
        drift = np.array([amp[0] * np.sin(i / 5), amp[1] * np.cos(i / 6)],
                         np.float32)
        c = base + drift[None, :]
        f, _ = synth.render_frame(labels, c, HW, seed=seed)
        frames.append(f)
        gts.append(c)
    return np.stack(frames), np.stack(gts)


@pytest.fixture(scope="module")
def midgame_labels():
    labels = np.zeros((19, 19), np.int8)
    rng = np.random.default_rng(1)
    idx = rng.choice(361, 80, replace=False)
    labels.flat[idx[:40]] = 1
    labels.flat[idx[40:]] = 2
    return labels


def test_tracks_drifting_board_subcell(midgame_labels):
    frames, gts = _drifting_frames(midgame_labels, 32)
    cs, sharp, _align, _ = bf_auto.track_corners_batch(
        jnp.asarray(frames), jnp.asarray(gts[0]), res=RES)
    err = np.abs(np.asarray(cs) - gts).max()
    cell = np.linalg.norm(gts[0][1] - gts[0][0]) / 18
    assert err < 0.15 * cell          # sub-cell on every frame
    assert (np.asarray(sharp) >= bf_auto.TRACK_MIN_SHARPNESS).all()


def test_tracking_resumes_across_batches(midgame_labels):
    frames, gts = _drifting_frames(midgame_labels, 48)
    seed = jnp.asarray(gts[0])
    cell = np.linalg.norm(gts[0][1] - gts[0][0]) / 18
    for k in range(0, 48, 16):
        cs, _, _, seed = bf_auto.track_corners_batch(
            jnp.asarray(frames[k:k + 16]), seed, res=RES)
        assert np.abs(np.asarray(cs) - gts[k:k + 16]).max() < 0.15 * cell


def test_imperfect_seed_absorbed(midgame_labels):
    """The first frame's correlation is measured against the seed anchor;
    a couple px of seed error must not grow while tracking."""
    frames, gts = _drifting_frames(midgame_labels, 16)
    seed = jnp.asarray(gts[0] + np.array([2.0, -1.5], np.float32))
    cs, _, _, _ = bf_auto.track_corners_batch(jnp.asarray(frames), seed,
                                           res=RES)
    err = np.abs(np.asarray(cs) - gts).max(axis=(1, 2))
    assert err.max() < err[0] + 4.0   # bounded by seed error + sub-cell


def test_handheld_game_end_to_end_tracked():
    """Config 4 full loop: detect once, track per frame, votes → 100% moves
    (the VERDICT r1 'honest c4' requirement: detection/tracking measured
    from the frames themselves, no ground-truth corners)."""
    moves = synth.sample_moves(10, seed=5)
    fpm = cvconf.vote_window + 3
    base = synth.default_corners(HW)
    frames = []
    t = 0
    for _, lab in synth.render_game(moves, frames_per_move=fpm,
                                    frame_hw=HW, seed=5, empty_leadin=6):
        drift = np.array([12.0 * np.sin(t / 7), 9.0 * np.cos(t / 9)],
                         np.float32)
        f, _ = synth.render_frame(lab, base + drift[None, :], HW, seed=5 + t)
        frames.append(f)
        t += 1
    frames = np.stack(frames)

    seed, score = bf_auto.detect_corners(jnp.asarray(frames[0]))
    assert float(score) > 0.1
    state = sf_meta.init_state()
    ex = MoveExtractor()
    B = 16
    for k in range(0, len(frames), B):
        fb = frames[k:k + B]
        n = fb.shape[0]
        if n < B:                      # pad tail (static jit shapes)
            fb = np.concatenate([fb, fb[-1:].repeat(B - n, 0)])
        # The production config-4 engine: fused track+rectify+classify+scan.
        state, labels, _, _, _cs, _sharp, _al, seed = sf_meta.track_read_batch(
            state, jnp.asarray(fb), seed)
        for lab in np.asarray(labels)[:n]:
            ex.advance(lab)
    rep = score_moves(ex.moves, moves)
    assert rep["agreement"] == 1.0, rep


def test_handheld_game_unfused_corner_batch_path():
    """The unfused path (track_corners_batch corners → read_batch's chunked
    warp) — what non-meta finders get from BoardFinderAuto. The clip holds
    the final position a moment (as any real recording does) so the last
    move's votes can settle."""
    moves = synth.sample_moves(8, seed=6)
    fpm = cvconf.vote_window + 3
    base = synth.default_corners(HW)
    frames = []
    t = 0
    for _, lab in synth.render_game(moves, frames_per_move=fpm,
                                    frame_hw=HW, seed=6, empty_leadin=6):
        drift = np.array([12.0 * np.sin(t / 7), 9.0 * np.cos(t / 9)],
                         np.float32)
        f, _ = synth.render_frame(lab, base + drift[None, :], HW, seed=6 + t)
        frames.append(f)
        t += 1
    for _ in range(12):                # trailing hold on the last position
        frames.append(frames[-1])
    frames = np.stack(frames)

    seed, score = bf_auto.detect_corners(jnp.asarray(frames[0]))
    assert float(score) > 0.1
    state = sf_meta.init_state()
    ex = MoveExtractor()
    B = 16
    for k in range(0, len(frames), B):
        fb = frames[k:k + B]
        n = fb.shape[0]
        if n < B:
            fb = np.concatenate([fb, fb[-1:].repeat(B - n, 0)])
        cs, _, _, seed = bf_auto.track_corners_batch(jnp.asarray(fb), seed,
                                                       res=RES)
        state, labels, _, _ = sf_meta.read_batch(state, jnp.asarray(fb), cs)
        for lab in np.asarray(labels)[:n]:
            ex.advance(lab)
    rep = score_moves(ex.moves, moves)
    assert rep["agreement"] == 1.0, rep


def test_runtime_auto_tracking_end_to_end():
    """The host runtime path of config 4: VManagerSeq + BoardFinderAuto
    (detect + per-batch tracking via corners_batch) + SfMeta consuming
    per-frame corners (VERDICT r1 item 3c / NEXT r1 item 2)."""
    from camkifu_tpu.board.bf_auto import BoardFinderAuto
    from camkifu_tpu.core.capture import ArrayCapture
    from camkifu_tpu.core.controllerv import ControllerVSeq
    from camkifu_tpu.core.vmanager import VManagerSeq
    from camkifu_tpu.stone.sf_meta import SfMeta

    moves = synth.sample_moves(6, seed=9)
    fpm = cvconf.vote_window + 3
    base = synth.default_corners(HW)
    frames = []
    t = 0
    for _, lab in synth.render_game(moves, frames_per_move=fpm,
                                    frame_hw=HW, seed=9, empty_leadin=6):
        drift = np.array([10.0 * np.sin(t / 8), 8.0 * np.cos(t / 11)],
                         np.float32)
        f, _ = synth.render_frame(lab, base + drift[None, :], HW, seed=9 + t)
        frames.append(f)
        t += 1

    controller = ControllerVSeq()
    vm = VManagerSeq(controller, video=None, bf_class=BoardFinderAuto,
                     sf_class=SfMeta, batch=16)
    vm.capture = ArrayCapture(frames)
    vm.instantiate_finders()
    vm.run()
    assert vm.board_finder.corners_batch is not None
    assert vm.board_finder.corners_batch.shape == (16, 4, 2)
    detected = controller.kifu.moves()
    assert [(m.color, m.row, m.col) for m in detected] == \
        [(m.color, m.row, m.col) for m in moves]


def test_camera_bump_recovers_end_to_end():
    """Camera knocked mid-game: an instantaneous 40-px + 2.5° pose jump —
    far beyond the per-frame correlation window — must collapse tracking,
    trip the forced re-detection, and re-anchor fast enough that every
    move before AND after the bump is read (the discrete counterpart of
    the gradual drift/rotation cases above)."""
    from camkifu_tpu.board.bf_auto import BoardFinderAuto
    from camkifu_tpu.core.capture import ArrayCapture
    from camkifu_tpu.core.controllerv import ControllerVSeq
    from camkifu_tpu.core.vmanager import VManagerSeq
    from camkifu_tpu.stone.sf_meta import SfMeta

    moves = synth.sample_moves(6, seed=17)
    fpm = cvconf.vote_window + 3
    base = synth.default_corners(HW)
    c0 = base.mean(axis=0)
    th = np.deg2rad(2.5)
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                   np.float32)
    bumped = (c0 + (base - c0) @ rot.T
              + np.array([34.0, -22.0], np.float32)).astype(np.float32)

    states = [lab for lab, _ in synth.game_states(moves)]
    frames = []
    empty = np.zeros((19, 19), np.int8)
    t = 0

    def emit(lab, corners, n):
        nonlocal t
        for _ in range(n):
            f, _ = synth.render_frame(lab, corners, HW, seed=17 + t)
            frames.append(f)
            t += 1

    emit(empty, base, 6)
    for lab in states[:3]:                 # first half: steady camera
        emit(lab, base, fpm)
    # The knock: next frame is at the new pose. Two batches of settle time
    # (trip fires on the first post-bump batch; re-detection lands on the
    # next) before play resumes — a realistic pause after a bumped table.
    emit(states[2], bumped, 32)
    for lab in states[3:]:                 # second half: new pose
        emit(lab, bumped, fpm)
    emit(states[-1], bumped, 12)           # trailing hold

    controller = ControllerVSeq()
    vm = VManagerSeq(controller, video=None, bf_class=BoardFinderAuto,
                     sf_class=SfMeta, batch=16)
    vm.capture = ArrayCapture(frames)
    vm.instantiate_finders()
    vm.run()
    detected = controller.kifu.moves()
    assert [(m.color, m.row, m.col) for m in detected] == \
        [(m.color, m.row, m.col) for m in moves]


def test_tracked_hard_palette_game():
    """Fused tracking + votes on adversarial footage (hard walnut: defocus,
    lighting gradient, shadow, stone jitter) with a drifting camera — the
    conditions where the classical reference pipeline collapses (PERF.md
    oracle table)."""
    from camkifu_tpu.stone.sf_meta import init_state, track_read_batch

    moves = synth.sample_moves(6, seed=4)
    fpm = cvconf.vote_window + 3
    base = synth.default_corners(HW)
    hard = dict(stone_jitter=0.07, light_gradient=0.3, blur_sigma=1.2,
                shadow=0.18, palette="walnut")
    frames = []
    t = 0
    for _, lab in synth.render_game(moves, frames_per_move=fpm,
                                    frame_hw=HW, seed=4, empty_leadin=6,
                                    **hard):
        drift = np.array([9.0 * np.sin(t / 6), 7.0 * np.cos(t / 8)],
                         np.float32)
        f, _ = synth.render_frame(lab, base + drift[None, :], HW,
                                  seed=4 + t, **hard)
        frames.append(f)
        t += 1
    frames = np.stack(frames)

    seed, score = bf_auto.detect_corners(jnp.asarray(frames[0]))
    assert float(score) > 0.1
    state = init_state()
    ex = MoveExtractor()
    B = 16
    for k in range(0, len(frames), B):
        fb = frames[k:k + B]
        n = fb.shape[0]
        if n < B:
            fb = np.concatenate([fb, fb[-1:].repeat(B - n, 0)])
        state, labels, _, _, _, _, _, seed = track_read_batch(
            state, jnp.asarray(fb), seed)
        for lab in np.asarray(labels)[:n]:
            ex.advance(lab)
    rep = score_moves(ex.moves, moves)
    assert rep["agreement"] == 1.0, rep


def _similarity_frames(labels, n, rate_deg=0.0, scale_rate=0.0,
                       drift_amp=(6.0, 4.0), seed=21, **render_kw):
    """Frames under a rotating/zooming/drifting camera, with ground-truth
    corner quads: c_i = center + s^i · R(i·rate) · (base − center) + drift."""
    base = synth.default_corners(HW)
    c0 = base.mean(axis=0)
    frames, gts = [], []
    for i in range(n):
        th = np.deg2rad(rate_deg) * i
        s = (1.0 + scale_rate) ** i
        rot = np.array([[np.cos(th), -np.sin(th)],
                        [np.sin(th), np.cos(th)]], np.float32)
        drift = np.array([drift_amp[0] * np.sin(i / 5),
                          drift_amp[1] * np.cos(i / 6)], np.float32)
        c = (c0 + s * (base - c0) @ rot.T + drift).astype(np.float32)
        f, _ = synth.render_frame(labels, c, HW, seed=seed, **render_kw)
        frames.append(f)
        gts.append(c)
    return np.stack(frames), np.stack(gts)


def test_tracks_rotating_board(midgame_labels):
    """VERDICT r2 top item: a slowly ROTATING camera (0.15°/frame across two
    batches) must hold ≤0.3 cell — the r2 translation-only tracker silently
    drifted to 1.4 cells by 4.65° while its sharpness gate never tripped."""
    frames, gts = _similarity_frames(midgame_labels, 32, rate_deg=0.15)
    cell = np.linalg.norm(gts[0][1] - gts[0][0]) / 18
    seed = jnp.asarray(gts[0])
    errs = []
    for k in range(0, 32, 16):
        cs, sharp, _, seed = bf_auto.track_corners_batch(
            jnp.asarray(frames[k:k + 16]), seed, res=RES)
        errs.append(np.abs(np.asarray(cs) - gts[k:k + 16]).max())
    assert max(errs) < 0.3 * cell, [round(e / cell, 3) for e in errs]


def test_tracks_zooming_board(midgame_labels):
    """Scale drift (camera dollying/zooming, 0.2%/frame) is the fourth DoF
    of the similarity measurement."""
    frames, gts = _similarity_frames(midgame_labels, 32, scale_rate=0.002)
    cell = np.linalg.norm(gts[0][1] - gts[0][0]) / 18
    seed = jnp.asarray(gts[0])
    errs = []
    for k in range(0, 32, 16):
        cs, _, _, seed = bf_auto.track_corners_batch(
            jnp.asarray(frames[k:k + 16]), seed, res=RES)
        errs.append(np.abs(np.asarray(cs) - gts[k:k + 16]).max())
    assert max(errs) < 0.3 * cell, [round(e / cell, 3) for e in errs]


def test_rotating_handheld_game_end_to_end():
    """The fused config-4 engine on a game whose camera ROTATES continuously
    (≈10° over the clip) while drifting — the r2 failure scenario, now
    required to read the game perfectly."""
    moves = synth.sample_moves(8, seed=12)
    fpm = cvconf.vote_window + 3
    base = synth.default_corners(HW)
    c0 = base.mean(axis=0)
    frames = []
    t = 0
    for _, lab in synth.render_game(moves, frames_per_move=fpm,
                                    frame_hw=HW, seed=12, empty_leadin=6):
        th = np.deg2rad(0.12) * t
        rot = np.array([[np.cos(th), -np.sin(th)],
                        [np.sin(th), np.cos(th)]], np.float32)
        drift = np.array([9.0 * np.sin(t / 7), 7.0 * np.cos(t / 9)],
                         np.float32)
        c = (c0 + (base - c0) @ rot.T + drift).astype(np.float32)
        f, _ = synth.render_frame(lab, c, HW, seed=12 + t)
        frames.append(f)
        t += 1
    for _ in range(12):                # trailing hold on the last position
        frames.append(frames[-1])
    frames = np.stack(frames)

    seed, score = bf_auto.detect_corners(jnp.asarray(frames[0]))
    assert float(score) > 0.1
    state = sf_meta.init_state()
    ex = MoveExtractor()
    B = 16
    for k in range(0, len(frames), B):
        fb = frames[k:k + B]
        n = fb.shape[0]
        if n < B:
            fb = np.concatenate([fb, fb[-1:].repeat(B - n, 0)])
        state, labels, _, _, _, _, _, seed = sf_meta.track_read_batch(
            state, jnp.asarray(fb), seed)
        for lab in np.asarray(labels)[:n]:
            ex.advance(lab)
    rep = score_moves(ex.moves, moves)
    assert rep["agreement"] == 1.0, rep


def test_align_tripwire_host_plumbing():
    """report_tracking must force a re-detection when the batch alignment
    decays below TRACK_ALIGN_TRIP × the baseline pinned at the last
    re-anchor — and must NOT adapt that baseline downward (the EMA-adapts-
    along failure that made the sharpness gate blind to slow drift)."""
    bf = _bare_bf()
    corners = np.zeros((16, 4, 2), np.float32)
    bf.report_tracking(corners, "seed", 3.0, 0.50)      # pins the baseline
    assert bf._align_anchor == 0.50 and bf._since_detect == 0
    bf.report_tracking(corners, "seed", 3.0, 0.40)      # mild decay: fine
    assert bf._since_detect == 0
    assert bf._align_anchor == 0.50                     # baseline not adapted
    bf.report_tracking(corners, "seed", 3.0, 0.20)      # < 0.5×baseline
    assert bf._since_detect >= 10 ** 9                  # re-detect forced


def test_align_baseline_rises_on_cleaner_batch():
    """The baseline is a running MAX since re-anchor: a partially occluded
    FIRST batch must not pin a depressed baseline that puts the trip
    threshold out of reach of real drift (it can rise, never adapt down)."""
    bf = _bare_bf()
    corners = np.zeros((16, 4, 2), np.float32)
    bf.report_tracking(corners, "seed", 3.0, 0.30)      # occluded first batch
    bf.report_tracking(corners, "seed", 3.0, 0.60)      # clean batch: raise
    assert bf._align_anchor == 0.60
    bf.report_tracking(corners, "seed", 3.0, 0.25)      # < trip×0.60 now
    assert bf._since_detect >= 10 ** 9


def _bare_bf():
    bf = bf_auto.BoardFinderAuto.__new__(bf_auto.BoardFinderAuto)
    bf.metadata = {}
    bf._align_anchor = None
    bf._since_detect = 0
    bf.track_seed = "seed"
    bf._prev_tracked_last = None
    bf.suspect_batch = False
    bf.gsize = 19

    class _VM:
        stones_finder = None
    bf.vmanager = _VM()
    return bf


def test_jump_tripwire_on_discontinuity():
    """A per-frame tracked-corner step beyond TRACK_JUMP_TRIP cells (a
    camera bump) must force re-detection, drop the tracked batch, and flag
    it suspect — even with perfect sharpness and alignment (the aliased
    whole-cell lattice lock is sharp AND aligned; measured e2e: a 40-px
    knock silently relocated every stone without this wire)."""
    bf = _bare_bf()
    base = synth.default_corners(HW)                    # cell ≈ 29 px
    steady = np.broadcast_to(base, (16, 4, 2)).astype(np.float32)
    bf.report_tracking(steady.copy(), "seed", 5.0, 2.0)
    assert bf._since_detect == 0 and not bf.suspect_batch

    jumped = steady.copy()
    jumped[8:] += np.array([34.0, -22.0], np.float32)   # knock mid-batch
    bf.report_tracking(jumped, "seed2", 5.0, 2.0)       # sharp, aligned...
    assert bf.suspect_batch                             # ...still tripped
    assert bf._since_detect >= 10 ** 9
    assert bf.corners_batch is None and bf.track_seed is None
    assert bf.metadata["track_trip"] == "jump"

    # Boundary discontinuity (the knock lands exactly between batches).
    bf = _bare_bf()
    bf.report_tracking(steady.copy(), "seed", 5.0, 2.0)
    bf.report_tracking(steady + np.array([30.0, 0.0], np.float32),
                       "seed2", 5.0, 2.0)
    assert bf.suspect_batch and bf._since_detect >= 10 ** 9


def test_perspective_drift_tracks_or_trips(midgame_labels):
    """Out-of-plane keystone drift is the one camera motion the 4-DoF
    similarity cannot model. The contract (r2's silent-drift hole, closed):
    for every batch of a growing keystone ramp, the tracker must either
    stay accurate (≤0.35 cell) or the host trip-wires (lattice-alignment
    decay vs the pinned baseline, or sharpness collapse) must force a full
    re-detection — NEVER drift on silently with no alarm."""
    base = synth.default_corners(HW)
    clean, _ = _similarity_frames(midgame_labels, 16)
    batches = []
    gts = []
    for i in range(32):
        # Out-of-plane tilt ramp: widen the top edge / shrink the bottom.
        k = 45.0 * (i + 1) / 32.0
        c = base + np.array([[-k, 0], [k, 0], [-k, 0], [k, 0]], np.float32)
        f, _ = synth.render_frame(midgame_labels, c, HW, seed=21)
        batches.append(f)
        gts.append(c)
    drifted = np.stack(batches)
    cell = np.linalg.norm(base[1] - base[0]) / 18

    seed = jnp.asarray(base)
    _, sharp_c, align_c, _ = bf_auto.track_corners_batch(
        jnp.asarray(clean), seed, res=RES)
    baseline = bf_auto.BoardFinderAuto.batch_align(align_c, sharp_c)
    assert baseline > 0.02                 # the baseline signal exists

    tripped = False
    worst = 0.0
    for k in range(0, 32, 16):
        cs, sharp, align, seed = bf_auto.track_corners_batch(
            jnp.asarray(drifted[k:k + 16]), seed, res=RES)
        err = np.abs(np.asarray(cs) - np.stack(gts[k:k + 16])).max() / cell
        worst = max(worst, err)
        a = bf_auto.BoardFinderAuto.batch_align(align, sharp)
        tripped = tripped or (a < bf_auto.TRACK_ALIGN_TRIP * baseline
                              or float(np.asarray(sharp).mean())
                              < bf_auto.TRACK_MIN_SHARPNESS)
        if tripped:
            break        # the host would force a full re-detection here
    # One batch of trip latency is the design's detection granularity; the
    # silent-failure bar is that the ramp cannot OUTRUN the alarm.
    assert worst <= 0.35 or tripped, (worst, baseline)


@pytest.mark.parametrize("gsize", [9, 13])
def test_tracking_other_board_sizes(gsize, midgame_labels):
    """The fused engine is gsize-generic (9/13/19 like everything else)."""
    labels = np.zeros((gsize, gsize), np.int8)
    rng = np.random.default_rng(2)
    idx = rng.choice(gsize * gsize, gsize, replace=False)
    labels.flat[idx[:gsize // 2]] = 1
    labels.flat[idx[gsize // 2:]] = 2
    base = synth.default_corners(HW)
    frames, gts = [], []
    for i in range(16):
        drift = np.array([8.0 * np.sin(i / 5), 6.0 * np.cos(i / 6)],
                         np.float32)
        c = base + drift[None, :]
        f, _ = synth.render_frame(labels, c, HW, seed=3)
        frames.append(f)
        gts.append(c)
    frames, gts = np.stack(frames), np.stack(gts)
    import jax

    canon, cs, sharp, _align, _ = bf_auto.rectify_track_batch(
        jnp.asarray(frames), jnp.asarray(gts[0]), gsize=gsize)
    cell = np.linalg.norm(gts[0][1] - gts[0][0]) / (gsize - 1)
    # Small-board canvases (144² lattice at g9) amplify per-px measurement
    # noise ~4× in cell units; the binding contract is the classification
    # below — corners just need to stay well inside a zone.
    assert np.abs(np.asarray(cs) - gts).max() < 0.3 * cell
    from camkifu_tpu.stone import sf_clustering
    lab, _ = jax.vmap(
        lambda c: sf_clustering.classify_canonical(c, gsize))(canon)
    assert (np.asarray(lab) == labels[None]).mean() > 0.999


def test_handheld_game_with_exposure_flicker():
    """Config 4 adversarial combo: handheld drift AND auto-exposure hunting
    (±15% gain walk) through the fused track+classify engine. The profile
    correlations are ratio-invariant to a global gain and the vote gate is
    exposure-compensated — agreement must stay 100% (probed r3: sharpness
    min 1.33, align healthy, 10/10 moves)."""
    moves = synth.sample_moves(8, seed=5)
    fpm = cvconf.vote_window + 3
    base = synth.default_corners(HW)
    rng = np.random.default_rng(99)
    frames, gain, t = [], 1.0, 0
    for _, lab in synth.render_game(moves, frames_per_move=fpm,
                                    frame_hw=HW, seed=5, empty_leadin=6):
        drift = np.array([12.0 * np.sin(t / 7), 9.0 * np.cos(t / 9)],
                         np.float32)
        f, _ = synth.render_frame(lab, base + drift[None, :], HW, seed=5 + t)
        gain = float(np.clip(gain + 0.35 * (1.0 - gain)
                             + rng.normal(0, 0.06), 0.85, 1.15))
        frames.append(np.clip(f.astype(np.float32) * gain, 0, 255)
                      .astype(np.uint8))
        t += 1
    frames = np.stack(frames)

    seed_c, score = bf_auto.detect_corners(jnp.asarray(frames[0]))
    assert float(score) > 0.1
    state = sf_meta.init_state()
    ex = MoveExtractor()
    B = 16
    for k in range(0, len(frames), B):
        fb = frames[k:k + B]
        n = fb.shape[0]
        if n < B:
            fb = np.concatenate([fb, fb[-1:].repeat(B - n, 0)])
        state, labels, _, _, _cs, _sharp, _al, seed_c = \
            sf_meta.track_read_batch(state, jnp.asarray(fb), seed_c)
        for lab in np.asarray(labels)[:n]:
            ex.advance(lab)
    rep = score_moves(ex.moves, moves)
    assert rep["agreement"] == 1.0, rep
