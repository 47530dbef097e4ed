"""Smoke test of the video→SGF pipeline on the GPU.

One process, one card (``python chip_smoke.py``), in this order:

(a) device: JAX's platform, device kind and count, and the card's name and
    power limit; anything but the GPU stops the run;
(b) parity: every device op of the main path, run on the GPU and on the
    host CPU in the same process at real widths, against stated tolerances;
(c) end to end: a seeded 1080p game of 24 moves with captures, rendered
    with a small numpy + scipy renderer (utils/render_np: per-frame sensor
    noise and a drifting camera), fed through ArrayCapture into the objects
    ``ckmain --nogui`` builds (ControllerVSeq + VManagerSeq with
    BoardFinderAuto and SfMeta); the kifu's moves must equal the truth;
(d) informational timings (compile seconds, detect_batch(64) and
    read_board_batch(128) frames/s), each line with the card's name and
    power limit. These are not benchmark numbers.

``python chip_smoke.py --multichip`` runs only the stream-sharded path on
four cards, compared with the same calls on a one-card mesh.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Every failure raises, so the run exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: A 24-move game (color, row, col). Move 7 captures W (3, 4); move 19
#: captures the two W stones at (9, 9) and (9, 10).
GAME = [
    ("B", 3, 3), ("W", 3, 4), ("B", 2, 4), ("W", 15, 15), ("B", 4, 4),
    ("W", 15, 3), ("B", 3, 5),                                # captures 1
    ("W", 9, 9), ("B", 8, 9), ("W", 9, 10), ("B", 8, 10), ("W", 16, 9),
    ("B", 10, 9), ("W", 13, 16), ("B", 10, 10), ("W", 5, 15),
    ("B", 9, 8), ("W", 16, 12),
    ("B", 9, 11),                                             # captures 2
    ("W", 14, 5), ("B", 16, 14), ("W", 2, 15), ("B", 12, 3), ("W", 6, 2),
]

#: Frames the board holds each position (the vote needs ~vote_window
#: consistent readings to commit), and empty-board frames before play.
FRAMES_PER_MOVE = 10
LEADIN = 8

HD = (1080, 1920)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def game_states(n_moves: int, gsize: int = 19):
    """The first ``n_moves`` of GAME as Moves, and the (g, g) label grid
    after each, computed by the rules engine (captures removed)."""
    from camkifu_tpu.gamemodel.move import Move
    from camkifu_tpu.gamemodel.rules import RuleUnsafe

    rule = RuleUnsafe(gsize=gsize)
    moves, states = [], []
    for spec in GAME[:n_moves]:
        move = Move("np", spec, gsize=gsize)
        rule.put(move)
        rule.confirm()
        moves.append(move)
        states.append(rule.as_labels())
    return moves, states


def render_game(n_moves: int, frame_hw, seed: int = 0,
                fpm: int = FRAMES_PER_MOVE, leadin: int = LEADIN):
    """Frames of the game (distinct: sensor noise + camera drift) and each
    frame's true corners. Returns (moves, frames list, corners (N, 4, 2))."""
    from camkifu_tpu.utils import render_np

    moves, states = game_states(n_moves)
    zone = render_np.zone_for(frame_hw)
    base = render_np.default_corners(frame_hw)
    seq = [np.zeros((19, 19), np.int8)] * leadin
    for st in states:
        seq += [st] * fpm
    frames, corners = [], []
    canon, last = None, None
    for t, lab in enumerate(seq):
        if last is None or lab is not last:
            canon, last = render_np.canonical_board(lab, zone), lab
        c = render_np.drifting_corners(base, t, frame_hw)
        frames.append(render_np.render_frame(canon, c, frame_hw,
                                             seed=seed * 100_003 + t))
        corners.append(c)
    return moves, frames, np.stack(corners)


def still_frames(n: int, frame_hw, seed: int = 1):
    """``n`` distinct frames of one mid-game position under camera drift:
    (frames (n, H, W, 3) uint8, corners (n, 4, 2), labels (g, g))."""
    from camkifu_tpu.utils import render_np

    _, states = game_states(len(GAME))
    lab = states[-1]
    canon = render_np.canonical_board(lab, render_np.zone_for(frame_hw))
    base = render_np.default_corners(frame_hw)
    cs = np.stack([render_np.drifting_corners(base, 3 * t, frame_hw)
                   for t in range(n)])
    frames = np.stack([render_np.render_frame(canon, c, frame_hw,
                                              seed=seed * 7919 + t)
                       for t, c in enumerate(cs)])
    return frames, cs, lab


# ---------------------------------------------------------------------------
# (b) Parity with the plain reference: the same op on the host CPU
# ---------------------------------------------------------------------------

#: Seconds of each op's first GPU call (compile + run), for phase (d).
FIRST_CALL_S: dict = {}


def _run(dev, fn, *args):
    """fn(*args) with every array argument committed to ``dev``; outputs
    fetched to host numpy."""
    import jax

    args = [jax.device_put(a, dev) if isinstance(a, np.ndarray) else a
            for a in args]
    with jax.default_device(dev):
        t0 = time.perf_counter()
        out = jax.tree.map(np.asarray, fn(*args))
        dt = time.perf_counter() - t0
    return out, dt


def _both(name, test_dev, ref_dev, fn, *args):
    out, dt = _run(test_dev, fn, *args)
    FIRST_CALL_S.setdefault(name, dt)
    ref, _ = _run(ref_dev, fn, *args)
    return out, ref


#: Tolerances of phase (b). Every product on these paths is pinned to full
#: f32 (precision HIGHEST), so the GPU and the CPU differ only in the order
#: of sums and in the last bits of transcendentals.
TOL = {
    # edge_map_batch: share of pixels whose edge/no-edge verdict agrees,
    # and the largest magnitude difference on common support relative to
    # the frame's largest magnitude.
    "edge_support_agree": 0.999,
    "edge_rel_mag": 1e-4,
    # warps: largest |Δ| of a canonical pixel, in grey levels (0–255).
    "warp_max_abs": 0.5,
    # homography_dlt: largest difference of a mapped corner, in pixels.
    "dlt_px": 1e-2,
    # read_board_batch / track_read_batch confidences (labels must be
    # identical). The canonical warps differ by a few hundredths of a grey
    # level (FMA contraction in the sample coordinates), and the uint8-
    # resolution radix medians of the zone statistics can step by 1/255 at
    # a bin edge, which moves a k-means confidence by about a percent.
    "conf_abs": 0.05,
    # detect_corners / detect_batch / track_read_batch: largest corner
    # difference, in pixels of the 1080p frame.
    "corner_px": 0.5,
}


def phase_parity(test_dev, ref_dev, frame_hw=HD, n_frames: int = 64,
                 edge_res: int = 256) -> dict:
    """Run each device op on ``test_dev`` and ``ref_dev``; return the
    measured differences and raise if any exceeds TOL."""
    import jax
    from scipy import ndimage

    from camkifu_tpu import pipeline
    from camkifu_tpu.board import bf_auto
    from camkifu_tpu.ops import edges, warp
    from camkifu_tpu.stone import sf_meta

    frames, cs, lab = still_frames(n_frames, frame_hw)
    m = {}

    # edge_map_batch on n_frames luma images at the detection resolution.
    rgb_to_luma = np.array([0.299, 0.587, 0.114], np.float32) / 255.0
    zoom = (edge_res / frame_hw[0], edge_res / frame_hw[1])
    grays = np.stack([ndimage.zoom(f.astype(np.float32) @ rgb_to_luma, zoom,
                                   order=1) for f in frames])
    out, ref = _both("edge_map_batch", test_dev, ref_dev,
                     jax.jit(edges.edge_map_batch), grays)
    m["edge_support_agree"] = float(((out > 0) == (ref > 0)).mean())
    both = (out > 0) & (ref > 0)
    scale = np.maximum(ref.reshape(len(ref), -1).max(axis=1), 1e-6)
    m["edge_rel_mag"] = float((np.abs(out - ref) * both
                               / scale[:, None, None]).max())

    # Canonical warps of 16 frames: fixed corners and per-frame corners.
    wf = jax.jit(lambda f, c: warp.warp_batch_fixed(f, c))
    wc = jax.jit(lambda f, c: warp.warp_batch_chunked(f, c))
    out, ref = _both("warp_batch_fixed", test_dev, ref_dev, wf,
                     frames[:16], cs[0])
    m["warp_fixed_max_abs"] = float(np.abs(out - ref).max())
    out, ref = _both("warp_batch_chunked", test_dev, ref_dev, wc,
                     frames[:16], cs[:16])
    m["warp_chunked_max_abs"] = float(np.abs(out - ref).max())

    # homography_dlt canonical → frame for every frame's corners.
    canon_pts = warp.canonical_corners()

    def dlt_map(quads):
        hs = jax.vmap(lambda q: warp.homography_dlt(canon_pts, q))(quads)
        return jax.vmap(lambda h: warp.apply_homography(h, canon_pts))(hs)

    out, ref = _both("homography_dlt", test_dev, ref_dev, jax.jit(dlt_map),
                     cs)
    m["dlt_px"] = float(np.abs(out - ref).max())
    m["dlt_fit_px"] = float(np.abs(out - cs).max())

    # read_board_batch: fixed corners, every frame classified.
    (lab_o, conf_o), (lab_r, conf_r) = _both(
        "read_board_batch", test_dev, ref_dev, pipeline.read_board_batch,
        frames, cs[0])
    m["read_labels_identical"] = bool(np.array_equal(lab_o, lab_r))
    m["read_labels_truth"] = float((lab_o == lab[None]).mean())
    m["read_conf_abs"] = float(np.abs(conf_o - conf_r).max())

    # Full detection, one frame at a time and as one batch.
    det = lambda f: bf_auto.detect_corners(f)[0]
    out = np.stack([_run(test_dev, det, f)[0] for f in frames])
    ref = np.stack([_run(ref_dev, det, f)[0] for f in frames])
    m["detect_corners_px"] = float(np.abs(out - ref).max())
    m["detect_corners_truth_px"] = float(np.abs(out - cs).max())
    (out, _), (ref, _) = _both("detect_batch", test_dev, ref_dev,
                               bf_auto.detect_batch, frames)
    m["detect_batch_px"] = float(np.abs(out - ref).max())
    m["detect_batch_truth_px"] = float(np.abs(out - cs).max())

    # Fused tracker + classify + vote scan over 32 drifting frames.
    trk = lambda f, seed: sf_meta.track_read_batch(
        sf_meta.init_state(), f, seed)
    out, ref = _both("track_read_batch", test_dev, ref_dev, trk,
                     frames[:32], cs[0])
    m["track_labels_identical"] = bool(np.array_equal(out[1], ref[1]))
    m["track_conf_abs"] = float(np.abs(out[2] - ref[2]).max())
    m["track_corners_px"] = float(np.abs(out[4] - ref[4]).max())

    print("parity: " + json.dumps(m), flush=True)
    bad = [k for k, lim in [
        ("edge_support_agree", None), ("edge_rel_mag", "edge_rel_mag"),
        ("warp_fixed_max_abs", "warp_max_abs"),
        ("warp_chunked_max_abs", "warp_max_abs"), ("dlt_px", "dlt_px"),
        ("read_conf_abs", "conf_abs"), ("track_conf_abs", "conf_abs"),
        ("detect_corners_px", "corner_px"), ("detect_batch_px", "corner_px"),
        ("track_corners_px", "corner_px")]
        if (m[k] < TOL[k] if lim is None else m[k] > TOL[lim])]
    bad += [k for k in ("read_labels_identical", "track_labels_identical")
            if not m[k]]
    if bad:
        raise AssertionError(f"parity out of tolerance: {bad}")
    return m


# ---------------------------------------------------------------------------
# (c) End to end through the ckmain --nogui objects
# ---------------------------------------------------------------------------

def phase_e2e(frame_hw=HD, n_moves: int = len(GAME), seed: int = 0,
              batch: int | None = None) -> dict:
    """Render the game, run it through ControllerVSeq + VManagerSeq
    (BoardFinderAuto, SfMeta; frames through ArrayCapture) and require the
    kifu's moves to equal the truth exactly."""
    from camkifu_tpu.board.bf_auto import BoardFinderAuto
    from camkifu_tpu.config import cvconf
    from camkifu_tpu.core.capture import ArrayCapture
    from camkifu_tpu.core.controllerv import ControllerVSeq
    from camkifu_tpu.core.vmanager import VManagerSeq
    from camkifu_tpu.stone.sf_meta import SfMeta

    t0 = time.perf_counter()
    moves, frames, _ = render_game(n_moves, frame_hw, seed=seed)
    render_s = time.perf_counter() - t0
    controller = ControllerVSeq()
    vm = VManagerSeq(controller, video=frames, bf_class=BoardFinderAuto,
                     sf_class=SfMeta, batch=batch or cvconf.frame_batch)
    vm.instantiate_finders()
    t0 = time.perf_counter()
    vm.run()
    run_s = time.perf_counter() - t0
    assert isinstance(vm.capture, ArrayCapture), type(vm.capture)
    got = [(m.color, m.row, m.col) for m in controller.kifu.moves()]
    want = [(m.color, m.row, m.col) for m in moves]
    rep = {"frames": len(frames), "moves": len(want), "detected": len(got),
           "render_s": round(render_s, 2), "run_s": round(run_s, 2)}
    print("e2e: " + json.dumps(rep), flush=True)
    if got != want:
        raise AssertionError(f"kifu differs from the truth:\n got {got}\n"
                             f"want {want}")
    return rep


# ---------------------------------------------------------------------------
# (d) Informational timings
# ---------------------------------------------------------------------------

def phase_timings(card: str, frame_hw=HD) -> dict:
    import jax

    from camkifu_tpu import pipeline
    from camkifu_tpu.board import bf_auto

    frames, cs, _ = still_frames(64, frame_hw, seed=5)
    f64 = jax.device_put(frames)
    f128 = jax.device_put(np.concatenate([frames, frames[::-1]]))
    c0 = jax.device_put(cs[0])
    fence = lambda x: np.asarray(jax.tree.leaves(x)[0])
    t0 = time.perf_counter()
    pipeline.read_board_batch.lower(f128, c0).compile()
    compile_read = time.perf_counter() - t0

    def rate(fn, n, reps=5):
        fence(fn())
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        fence(out)
        return n * reps / (time.perf_counter() - t0)

    t = {"compile_s_read_board_batch_128": round(compile_read, 2)}
    t.update({f"first_call_s_{k}": round(v, 2)
              for k, v in FIRST_CALL_S.items()})
    t["detect_batch_64_fps"] = round(
        rate(lambda: bf_auto.detect_batch(f64)[0], 64), 1)
    t["read_board_batch_128_fps"] = round(
        rate(lambda: pipeline.read_board_batch(f128, c0)[0], 128), 1)
    for k, v in t.items():
        print(f"timing (informational; {card}): {k} = {v}", flush=True)
    return t


# ---------------------------------------------------------------------------
# --multichip: stream sharding over four cards vs one
# ---------------------------------------------------------------------------

def stream_inputs(n_streams: int, per: int, frame_hw, seed: int = 2):
    """Distinct streams: each its own position, camera pose and drift.
    Returns (frames (S, B, H, W, 3) uint8, corners (S, B, 4, 2))."""
    from camkifu_tpu.utils import render_np

    _, states = game_states(len(GAME))
    zone = render_np.zone_for(frame_hw)
    frames = np.empty((n_streams, per) + tuple(frame_hw) + (3,), np.uint8)
    corners = np.empty((n_streams, per, 4, 2), np.float32)
    for s in range(n_streams):
        canon = render_np.canonical_board(
            states[(7 + 5 * s) % len(states)], zone)
        base = render_np.default_corners(frame_hw,
                                         perspective=0.06 + 0.02 * s)
        base = base + np.float32(0.01 * frame_hw[0] * (s - n_streams / 2))
        for t in range(per):
            c = render_np.drifting_corners(base, 11 * s + t, frame_hw)
            corners[s, t] = c
            frames[s, t] = render_np.render_frame(
                canon, c, frame_hw, seed=seed * 1009 + s * per + t)
    return frames, corners


def phase_multichip(devices, frame_hw=HD, n_streams: int = 8,
                    per: int = 16) -> dict:
    """multistream_read, multistream_read_meta and multistream_track_read
    on a 1-D ("stream",) mesh over ``devices``, against the same calls on
    a one-device mesh. Labels must be identical, tracked corners within
    TOL["corner_px"], every output sharded over all the devices, and the
    compiled modules free of collectives."""
    import jax
    from jax.sharding import Mesh

    from camkifu_tpu.parallel import mesh as pm

    frames, corners = stream_inputs(n_streams, per, frame_hw)
    seeds = corners[:, 0]
    fixed = corners[:, 0]

    def run(devs):
        mesh = Mesh(np.array(devs), axis_names=("stream",))
        read = pm.multistream_read(mesh, frames, fixed)
        meta = pm.multistream_read_meta(
            mesh, pm.multistream_init_states(n_streams), frames, fixed)
        track = pm.multistream_track_read(
            mesh, pm.multistream_init_states(n_streams), frames, seeds)
        return mesh, {"read": read[0], "meta": meta[1],
                      "track": track[1], "track_corners": track[4]}

    mesh_n, outs_n = run(devices)
    _, outs_1 = run(devices[:1])
    m = {}
    for k in ("read", "meta", "track"):
        m[f"{k}_labels_identical"] = bool(np.array_equal(
            np.asarray(outs_n[k]), np.asarray(outs_1[k])))
    m["track_corners_px"] = float(np.abs(
        np.asarray(outs_n["track_corners"])
        - np.asarray(outs_1["track_corners"])).max())
    m["track_corners_truth_px"] = float(np.abs(
        np.asarray(outs_n["track_corners"]) - corners).max())
    want = set(devices)
    m["sharded_on_all"] = all(
        {s.device for s in v.addressable_shards} == want
        for v in outs_n.values())

    sh = pm.stream_sharding(mesh_n)
    sf = jax.device_put(frames, sh)
    sc = jax.device_put(fixed, sh)
    st = jax.tree.map(lambda leaf: jax.device_put(leaf, sh),
                      pm.multistream_init_states(n_streams))
    with mesh_n:
        hlo = {
            "read": pm._read_fn(mesh_n, 19, 16).lower(sf, sc),
            "meta": pm._meta_all_streams.lower(st, sf, sc, 19, 16),
            "track": pm._track_fn(mesh_n, 19, 16).lower(st, sf, sc),
        }
        m["collectives"] = {k: pm.collective_ops(v.compile().as_text())
                            for k, v in hlo.items()}
    print("multichip: " + json.dumps(m), flush=True)
    bad = [k for k, v in m.items() if v is False]
    if m["track_corners_px"] > TOL["corner_px"]:
        bad.append("track_corners_px")
    if any(m["collectives"].values()):
        bad.append("collectives")
    if bad:
        raise AssertionError(f"multichip check failed: {bad}")
    return m


# ---------------------------------------------------------------------------

def _import_package():
    """Import camkifu_tpu from this checkout, and from nowhere else."""
    sys.path.insert(0, HERE)
    import camkifu_tpu

    pkg = os.path.dirname(os.path.abspath(camkifu_tpu.__file__))
    if os.path.dirname(pkg) != HERE:
        raise SystemExit(f"camkifu_tpu found at {pkg}, not beside "
                         f"{os.path.basename(__file__)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the stream-sharded path on four cards, "
                         "compared with a one-card mesh")
    args = ap.parse_args(argv)
    _import_package()
    from camkifu_tpu.utils import device, jaxcache

    jaxcache.enable()
    import jax

    dev = device.require_gpu()
    card = device.card_name_and_power_limit()
    print(f"device: platform={dev['platform']} kind={dev['kind']} "
          f"count={dev['count']}", flush=True)
    print(f"card: {card}", flush=True)
    if args.multichip:
        if dev["count"] < 4:
            raise SystemExit(f"--multichip needs 4 cards, found "
                             f"{dev['count']}")
        devs = jax.devices()[:4]
        phase_multichip(devs)
        dev = dict(dev, count=len(devs))
    else:
        gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
        phase_parity(gpu, cpu)
        phase_e2e()
        phase_timings(card)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
