"""Shared-canvas batched redetection (VERDICT r4 item 3).

The per-frame refine pays two single-frame rectification gathers;
detect_batch routes
video-shaped batches (line-dominated, quads agreeing to a fraction of a
cell) through ONE batch-shared gather + per-frame comb/evidence/pin. These
tests pin the routing contract and the accuracy parity with the per-frame
path.
"""

import numpy as np
import jax.numpy as jnp

from camkifu_tpu.board import bf_auto
from camkifu_tpu.config import cvconf
from camkifu_tpu.utils import synth


def _drift_batch(b=4, n_stones=40, frame_hw=(720, 1280), drift=3.0):
    labels = np.zeros((19, 19), np.int8)
    rng = np.random.default_rng(1)
    idx = rng.choice(361, n_stones, replace=False)
    labels.flat[idx[::2]] = 1
    labels.flat[idx[1::2]] = 2
    base = synth.default_corners(frame_hw)
    frames, gts = [], []
    for i in range(b):
        c = base + np.array([drift * np.sin(i / 2.0),
                             drift * np.cos(i / 3.0)], np.float32)
        f, gt = synth.render_frame(labels, c, frame_hw, seed=i)
        frames.append(f)
        gts.append(gt)
    return np.stack(frames), np.stack(gts)


def test_shared_route_taken_and_accurate():
    frames, gts = _drift_batch()
    grays, quads, scores = bf_auto._detect_prepare_batch(
        jnp.asarray(frames), cvconf.bf_resolution)
    routed = bf_auto._detect_batch_routed(grays, quads, scores, 19)
    assert routed is not None, (np.asarray(scores), "route refused")
    err = np.abs(np.asarray(routed) - gts).max()
    assert err < 8.0, err
    # Parity with the per-frame refine: same frames, same quads.
    per_frame = np.stack([
        np.asarray(bf_auto._refine_one(grays[i], quads[i], scores[i], 19))
        for i in range(frames.shape[0])])
    assert np.abs(np.asarray(routed) - per_frame).max() < 4.0


def test_detect_batch_end_to_end_uses_route():
    frames, gts = _drift_batch(b=3)
    corners, scores = bf_auto.detect_batch(jnp.asarray(frames))
    assert np.abs(np.asarray(corners) - gts).max() < 8.0
    assert (np.asarray(scores) > 0.55).all()


def test_large_batch_routes_per_chunk():
    """B=32 handheld drift must keep the shared route via per-chunk
    medians (r5): the whole-batch median canvas stopped validating as the
    batch grew — at B=32 the drifting quads spread past
    SHARED_REFINE_SPREAD of the ONE median and the router fell back to
    the per-frame path for the whole batch."""
    frames, gts = _drift_batch(b=32, drift=4.0)
    grays, quads, scores = bf_auto._detect_prepare_batch(
        jnp.asarray(frames), cvconf.bf_resolution)
    corners, oks = bf_auto._route_and_refine_chunked(
        grays, quads, scores, 19, bf_auto.SHARED_CHUNK)
    assert np.asarray(oks).all(), np.asarray(oks)
    assert np.abs(np.asarray(corners) - gts).max() < 8.0
    # And the public API returns the routed result for the same batch.
    routed = bf_auto._detect_batch_routed(grays, quads, scores, 19)
    assert routed is not None
    assert np.abs(np.asarray(routed) - np.asarray(corners)).max() == 0.0


def test_mixed_chunk_validity_merges_paths():
    """One bad chunk (saturated frames) must fall back per frame while the
    good chunk keeps its shared-canvas result."""
    good, gts = _drift_batch(b=bf_auto.SHARED_CHUNK)
    labels = np.zeros((19, 19), np.int8)
    rng = np.random.default_rng(2)
    idx = rng.choice(361, 220, replace=False)
    labels.flat[idx[::2]] = 1
    labels.flat[idx[1::2]] = 2
    sat, sat_gt = synth.render_frame(labels, None, (720, 1280))
    frames = np.concatenate(
        [good, np.stack([sat] * bf_auto.SHARED_CHUNK)])
    grays, quads, scores = bf_auto._detect_prepare_batch(
        jnp.asarray(frames), cvconf.bf_resolution)
    sat_scores = np.asarray(scores)[bf_auto.SHARED_CHUNK:]
    routed = bf_auto._detect_batch_routed(grays, quads, scores, 19)
    if (sat_scores <= 0.55).any():
        # The saturated chunk fails validity; the good chunk's frames must
        # still come back accurate through the merged result.
        assert routed is not None
        assert np.abs(np.asarray(routed)[:bf_auto.SHARED_CHUNK]
                      - gts).max() < 8.0
        assert np.isfinite(np.asarray(routed)).all()


def test_route_refused_for_disjoint_stills():
    """Independent stills with different poses must take the per-frame
    path: the shared canvas would crop/smear the outlier's lattice."""
    labels = np.zeros((19, 19), np.int8)
    labels[3, 3] = 1
    labels[9, 9] = 2
    base = synth.default_corners((720, 1280))
    f1, _ = synth.render_frame(labels, base, (720, 1280))
    f2, _ = synth.render_frame(labels, base * 0.7 + 40.0, (720, 1280))
    frames = jnp.asarray(np.stack([f1, f2]))
    grays, quads, scores = bf_auto._detect_prepare_batch(
        frames, cvconf.bf_resolution)
    assert bf_auto._detect_batch_routed(grays, quads, scores, 19) is None
    # ...and the fallback still detects both correctly end to end.
    corners, _ = bf_auto.detect_batch(frames)
    assert np.isfinite(np.asarray(corners)).all()


def test_route_refused_on_saturated_frames():
    labels = np.zeros((19, 19), np.int8)
    rng = np.random.default_rng(2)
    idx = rng.choice(361, 220, replace=False)
    labels.flat[idx[::2]] = 1
    labels.flat[idx[1::2]] = 2
    f, _ = synth.render_frame(labels, None, (720, 1280))
    frames = jnp.asarray(np.stack([f, f]))
    grays, quads, scores = bf_auto._detect_prepare_batch(
        frames, cvconf.bf_resolution)
    if (np.asarray(scores) <= 0.55).any():     # saturated as intended
        assert bf_auto._detect_batch_routed(grays, quads, scores, 19) is None


def test_route_refused_on_rotated_board():
    """A rotated lattice needs the per-frame de-rotation pass, which the
    shared canvas cannot run — the derotate trip must bounce the batch."""
    labels = np.zeros((19, 19), np.int8)
    rng = np.random.default_rng(3)
    idx = rng.choice(361, 40, replace=False)
    labels.flat[idx[::2]] = 1
    labels.flat[idx[1::2]] = 2
    base = synth.default_corners((720, 1280))
    ctr = base.mean(axis=0)
    th = np.deg2rad(14.0)
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                   np.float32)
    c = (ctr + (base - ctr) @ rot.T).astype(np.float32)
    f, gt = synth.render_frame(labels, c, (720, 1280))
    frames = jnp.asarray(np.stack([f, f]))
    corners, scores = bf_auto.detect_batch(frames)
    # End to end the batch must still come out right (per-frame fallback
    # runs the derotate pass).
    cell = float(np.linalg.norm(gt[1] - gt[0])) / 18.0
    err = np.abs(np.asarray(corners) - gt[None]).max()
    assert err < 0.5 * cell, (err, cell)
