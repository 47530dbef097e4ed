"""filecheck — batch scoring harness: pipeline vs a reference SGF.

Parity: the reference's ``test/mains`` filecheck (SURVEY §3.5/§4) — run the
whole pipeline headless on a recorded video with a known reference SGF and
report move-sequence agreement. This is the north-star accuracy metric
(BASELINE.md: ≥99% agreement).

Inputs: a video file (decoded on host via cv2), a directory of frames, or a
``synth:N[:seed]`` spec that renders an N-move synthetic game with known
ground truth (the oracle the reference never had — SURVEY §4 implication b).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from camkifu_tpu.config import cvconf, guiconf
from camkifu_tpu.core.gamesync import MoveExtractor, score_moves
from camkifu_tpu.gamemodel.kifu import Kifu


class KifuChecker:
    """Align a detected move sequence against a reference kifu and report.

    Parity: the reference's checker in ``test/mains`` (SURVEY §3.5 — "#good /
    #wrong / missing moves"). ``report()`` returns the metric dict;
    ``diff_lines()`` lists per-move disagreements for debugging.
    """

    def __init__(self, reference_moves):
        self.reference = list(reference_moves)

    def report(self, detected) -> dict:
        return score_moves(list(detected), self.reference)

    def diff_lines(self, detected) -> list[str]:
        """Per-move disagreements, derived from the SAME edit-distance
        alignment as report() — a positional zip would list every move after
        an early miss as wrong, contradicting the counts."""
        detected = list(detected)
        ops = score_moves(detected, self.reference, with_ops=True)["ops"]
        out = []
        for kind, di, rj in ops:
            if kind == "wrong":
                out.append(f"ref move {rj + 1}: expected "
                           f"{self.reference[rj]!r}, got {detected[di]!r}")
            elif kind == "missing":
                out.append(f"ref move {rj + 1}: missing "
                           f"{self.reference[rj]!r}")
            elif kind == "extra":
                out.append(f"extra detected move: {detected[di]!r}")
        return out


def iter_video_frames(path: str, bounds=(0.0, 1.0), decoders: int = 1):
    """Yield RGB uint8 frames from a video file (host-side cv2 decode;
    ``decoders`` > 1 uses the segmented parallel decoder)."""
    if decoders > 1:
        from camkifu_tpu.core.capture import ParallelFileCapture

        try:
            cap = ParallelFileCapture(path, bounds, workers=decoders)
        except ValueError:         # unknown frame count → sequential below
            cap = None
        if cap is not None:
            try:
                while True:
                    frames, done = cap.read_batch(32)
                    yield from frames
                    if done:
                        return
            finally:
                cap.release()
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if bounds != (0.0, 1.0):
                h = frame.shape[0]
                frame = frame[int(bounds[0] * h):int(bounds[1] * h)]
            yield frame[:, :, ::-1].copy()  # BGR → RGB
    finally:
        cap.release()


def batched(iterator, size: int):
    """Group an iterator into (stacked ndarray, count) batches, padding the
    tail by repeating the last frame (static shapes for jit)."""
    buf = []
    for item in iterator:
        buf.append(item)
        if len(buf) == size:
            yield np.stack(buf), size
            buf = []
    if buf:
        n = len(buf)
        while len(buf) < size:
            buf.append(buf[-1])
        yield np.stack(buf), n


def run_pipeline(frames_iter, corners: np.ndarray | None,
                 batch: int = cvconf.frame_batch,
                 gsize: int = guiconf.gsize,
                 extractor: MoveExtractor | None = None,
                 use_meta: bool = True,
                 use_neural: bool = True,
                 progress=None):
    """Drive the jitted pipeline over all frames; return (extractor, stats).

    corners=None → automatic board detection (board.bf_auto); otherwise the
    fixed (4, 2) corner set is used (manual/BoardFinderManual semantics).
    """
    import jax.numpy as jnp

    from camkifu_tpu import pipeline

    extractor = extractor or MoveExtractor(gsize=gsize)
    n_frames = 0
    t0 = time.perf_counter()
    state = None
    corners_dev = None if corners is None else jnp.asarray(corners, jnp.float32)
    from camkifu_tpu.core.feeder import prefetch_to_device

    for fb, n in prefetch_to_device(batched(frames_iter, batch)):
        if corners is None and corners_dev is None:
            # Fixed-camera automatic board detection: locate once on the
            # first batch (median over frames), as BoardFinderAuto commits a
            # stable homography (SURVEY §2.1). Handheld per-frame
            # re-detection is the (B, 4, 2) corners path.
            from camkifu_tpu.board import bf_auto
            corners_dev = bf_auto.detect_batch_stable(fb, gsize=gsize)
        if use_meta:
            from camkifu_tpu.stone import sf_meta
            if state is None:
                state = sf_meta.init_state(gsize=gsize)
                # Same opt-in neural voter as the SfMeta runtime host:
                # only a user-trained checkpoint joins (none is shipped —
                # two tied ablations, PERF.md); --no-neural ablates it.
                neural_params = None
                if use_neural:
                    try:
                        from camkifu_tpu.models import neural
                        neural_params = neural.load_params()
                    except Exception:
                        neural_params = None
            state, labels, conf, _agit = sf_meta.read_batch(
                state, fb, corners_dev, neural_params=neural_params,
                valid_count=(jnp.int32(n) if n < fb.shape[0] else None))
        else:
            labels, conf = pipeline.read_board_batch(fb, corners_dev,
                                                     gsize=gsize)
        labels = np.asarray(labels)
        for i in range(n):
            extractor.advance(labels[i])
        n_frames += n
        if progress:
            progress(n_frames)
    dt = time.perf_counter() - t0
    return extractor, {"frames": n_frames, "seconds": dt,
                       "fps": n_frames / dt if dt > 0 else 0.0,
                       "corners": (None if corners_dev is None else
                                   np.asarray(corners_dev).tolist())}


def run_runtime(frames, batch: int = 16, gsize: int = guiconf.gsize):
    """Drive the FULL vision runtime — VManagerSeq hosting BoardFinderAuto
    (per-frame 4-DoF corner tracking, trip-wires, forced re-detection) and
    SfMeta (temporal votes, pending-capture filter, bulk self-correction) —
    over in-memory frames; return (detected_moves, stats).

    This is the moving-camera path that the fixed-corner jitted pipeline
    (run_pipeline) cannot represent: corners are re-measured every frame
    and the finder hosts react to trips. ckfilecheck routes the 'gauntlet'
    scenario through it.
    """
    from camkifu_tpu.board.bf_auto import BoardFinderAuto
    from camkifu_tpu.core.capture import ArrayCapture
    from camkifu_tpu.core.controllerv import ControllerVSeq
    from camkifu_tpu.core.vmanager import VManagerSeq
    from camkifu_tpu.stone.sf_meta import SfMeta

    controller = ControllerVSeq()
    vm = VManagerSeq(controller, video=None, bf_class=BoardFinderAuto,
                     sf_class=SfMeta, batch=batch)
    vm.capture = ArrayCapture(frames)
    vm.instantiate_finders()
    t0 = time.perf_counter()
    vm.run()
    dt = time.perf_counter() - t0
    n = len(frames)
    return controller.kifu.moves(), {
        "frames": n, "seconds": dt, "fps": n / dt if dt > 0 else 0.0}


def check(video_spec: str, ref_sgf: str | None, corners=None,
          batch: int = cvconf.frame_batch, use_meta: bool = True,
          use_neural: bool = True, oracle: str = "jax",
          decoders: int = 1) -> dict:
    """Run the harness; return the score report dict.

    oracle: "jax" (the jitted pipeline), "cv2" (the independent host-side
    OpenCV pipeline — oracle_cv2, VERDICT r1 item 4), or "both" (run both
    and report JAX↔cv2 cross-agreement: the BASELINE north-star measurement
    "move agreement vs the OpenCV reference").
    """
    from camkifu_tpu.utils import synth

    gsize = guiconf.gsize
    if video_spec.startswith("synth:"):
        # synth:N[:seed][:hard|real|gauntlet][:flicker][:caps][:t3]
        # [:palette] —
        # rendered game with known
        # ground truth; 'hard' adds stone jitter, a 30% lighting gradient,
        # defocus blur, and a soft shadow (the adversarial eval for the
        # ≥99% target); 'real' adds, on top of hard, procedural wood-grain
        # texture, lens vignetting, an animated hand placing each stone,
        # and an H.264-class encode→decode round-trip (the sim-real gap
        # pass, VERDICT r2 item 3); a palette name (walnut/bamboo/…) swaps
        # the board look.
        parts = video_spec.split(":")
        n_moves = int(parts[1])
        rest = parts[2:]
        if "gauntlet" in rest:
            # THE GAUNTLET (synth.gauntlet_scenario / tests/test_gauntlet.py):
            # every adversity at once — capture-rich game with lingering
            # dead stones, handheld drift + rotation + zoom, a mid-game
            # camera bump, exposure flicker, the full realism pass, and an
            # mp4 round-trip. Runs through the FULL runtime (run_runtime):
            # board corners are tracked per frame, so fixed-corner modes
            # (--corners, --oracle cv2, --no-meta) do not apply.
            extra = [p for p in rest if p != "gauntlet" and not p.isdigit()]
            if extra or oracle != "jax" or corners is not None \
                    or not use_meta:
                raise ValueError(
                    "the gauntlet scenario is auto-detected, tracked and "
                    "meta-voted by construction: no extra tokens, "
                    "--corners, --no-meta, or --oracle cv2/both "
                    f"(got tokens {extra!r}, oracle={oracle!r})")
            g_seed = next((int(p) for p in rest if p.isdigit()), 11)
            moves, frames_factory = synth.gauntlet_scenario(
                n_moves, seed=g_seed)
            checker = KifuChecker(moves)
            # The scenario's pacing (pause lengths, bump timing, vote
            # windows) is authored against the 16-frame re-anchor cadence
            # the e2e test locks — batch is fixed, not the --batch flag.
            detected, stats = run_runtime(list(frames_factory()), batch=16)
            report = checker.report(detected)
            report.update(stats)
            report["diff"] = checker.diff_lines(detected)[:20]
            return report
        seed = next((int(p) for p in rest if p.isdigit()), 7)
        real = "real" in rest
        hard = "hard" in rest or real
        hard_kw = dict(stone_jitter=0.07, light_gradient=0.3,
                       blur_sigma=1.2, shadow=0.18) if hard else {}
        game_kw = {}
        if real:
            hard_kw.update(wood_texture=0.10, vignette=0.22)
            game_kw["hand_frames"] = 2
        if "flicker" in rest:
            # Auto-exposure hunting: per-frame global gain walk ±15%, with
            # a reactive dip while the hand is in frame (synth.render_game).
            game_kw["flicker"] = 0.15
        if "caps" in rest:
            # Capture-rich scripted game, with captured stones physically
            # lingering past the bulk-correction threshold (players lift
            # captures out seconds late) — exercises the pending-capture
            # filter and the explained-contradiction gate end-to-end.
            from camkifu_tpu.stone.stonesfinder import BULK_CORRECT_AFTER
            game_kw["removal_lag"] = BULK_CORRECT_AFTER + 20
        if "t3" in rest:
            # Tier-3 sensor/scene hazards on top of 'real': specular glare
            # saturating stone tops (white caps on black stones — the
            # classical ensemble's hardest classification case) and
            # shot/read sensor noise. (Rolling shutter and clutter are
            # camera/scene-motion hazards; they live in the gauntlet.)
            hard_kw.update(glare=0.5, shot_noise=0.4)
        palette = next((p for p in rest if p in synth.PALETTES), None)
        if palette:
            hard_kw["palette"] = palette
        bad = [p for p in rest
               if not (p.isdigit()
                       or p in ("hard", "real", "flicker", "caps", "t3")
                       or p in synth.PALETTES)]
        if bad:
            raise ValueError(
                f"unknown synth spec token(s) {bad}: expected a seed, "
                f"'hard'/'real'/'flicker'/'caps'/'t3', or a palette in "
                f"{sorted(synth.PALETTES)}")
        moves = (synth.capture_rich_moves(n_moves, seed=seed)
                 if "caps" in rest else
                 synth.sample_moves(n_moves, seed=seed))
        ref_moves = moves
        gt_corners = synth.default_corners((720, 1280))
        # With temporal votes a stone must persist ≈ the vote window before
        # it commits (a recorded game holds each position for seconds); the
        # per-frame classifiers need no persistence.
        fpm = cvconf.vote_window + 3 if use_meta else 3

        def frames_factory():
            it = (f for f, _ in synth.render_game(
                moves, frames_per_move=fpm, frame_hw=(720, 1280), seed=seed,
                empty_leadin=6, **game_kw, **hard_kw))
            if real:
                return iter(synth.encode_roundtrip(it))
            return it
        if corners is None and ref_sgf != "auto":
            corners = gt_corners
    else:
        def frames_factory():
            return iter_video_frames(video_spec, decoders=decoders)
        if ref_sgf is None:
            raise ValueError("a reference SGF is required for video input")
        ref_kifu = Kifu.load(ref_sgf)
        ref_moves = ref_kifu.moves()
        # The reference SGF's SZ property is the authoritative board size
        # for real footage (synth specs always render the default 19);
        # hardcoding 19 here would silently mis-grid a 9/13 video.
        gsize = ref_kifu.gsize

    checker = KifuChecker(ref_moves)
    report: dict = {}
    if oracle in ("jax", "both"):
        extractor, stats = run_pipeline(frames_factory(), corners,
                                        batch=batch, gsize=gsize,
                                        use_meta=use_meta,
                                        use_neural=use_neural)
        jax_corners = stats.pop("corners", None)
        report = checker.report(extractor.moves)
        report.update(stats)
        report["rejected_readings"] = extractor.rejected
        report["diff"] = checker.diff_lines(extractor.moves)[:20]
    if oracle in ("cv2", "both"):
        from camkifu_tpu import oracle_cv2
        cv2_ex, cv2_stats = oracle_cv2.run_pipeline_cv2(
            frames_factory(), corners, gsize=gsize)
        cv2_rep = checker.report(cv2_ex.moves)
        if oracle == "cv2":
            report = cv2_rep
            report.update(cv2_stats)
            report["rejected_readings"] = cv2_ex.rejected
            report["diff"] = checker.diff_lines(cv2_ex.moves)[:20]
        else:
            # The north-star cross-check: JAX moves vs the independent
            # OpenCV pipeline's moves on the SAME frames. Normalized by the
            # LONGER sequence so one pipeline detecting a subset cannot
            # score as full agreement.
            cross = score_moves(extractor.moves, cv2_ex.moves)
            denom = max(len(extractor.moves), len(cv2_ex.moves), 1)
            report["cv2_agreement_vs_ref"] = cv2_rep["agreement"]
            report["cv2_fps"] = round(cv2_stats["fps"], 1)
            report["jax_vs_cv2_agreement"] = cross["good"] / denom
            # Tier 2 — corners-SHARED (VERDICT r3 item 6): on hard/realism
            # footage the classical detector is what collapses, so the
            # fully-independent tier degenerates to cv2's own detection
            # failure rate. Re-running the cv2 classifier+votes on the
            # JAX pipeline's detected corners isolates CLASSIFICATION agreement —
            # measurable exactly where the footage is interesting. Only
            # distinct from tier 1 when detection was automatic (with
            # explicit --corners both tiers share geometry by construction).
            if corners is None and jax_corners is not None:
                sh_ex, _sh_stats = oracle_cv2.run_pipeline_cv2(
                    frames_factory(),
                    np.asarray(jax_corners, np.float32), gsize=gsize)
                sh_rep = checker.report(sh_ex.moves)
                sh_cross = score_moves(extractor.moves, sh_ex.moves)
                sh_denom = max(len(extractor.moves), len(sh_ex.moves), 1)
                report["cv2_shared_agreement_vs_ref"] = sh_rep["agreement"]
                report["jax_vs_cv2_shared_agreement"] = (
                    sh_cross["good"] / sh_denom)
    return report


def main(argv=None) -> int:
    from camkifu_tpu.utils import device, jaxcache
    jaxcache.enable()
    device.check_entry("ckfilecheck")
    ap = argparse.ArgumentParser(
        description="Score the vision pipeline against a reference SGF.")
    ap.add_argument("video",
                    help="video file, or synth:N[:seed][:hard|real|"
                         "gauntlet][:flicker][:caps][:t3][:palette] — "
                         "'gauntlet' runs the everything-at-once moving-"
                         "camera scenario through the full runtime; 't3' "
                         "adds specular glare + sensor shot noise")
    ap.add_argument("sgf", nargs="?", default=None,
                    help="reference SGF ('auto' with synth: to force "
                         "auto board detection)")
    ap.add_argument("--batch", type=int, default=cvconf.frame_batch)
    ap.add_argument("--corners", type=str, default=None,
                    help="8 comma-separated floats: x1,y1,...,x4,y4 "
                         "(tl,tr,br,bl) — manual board corners")
    ap.add_argument("--no-meta", action="store_true",
                    help="per-frame clustering only (no temporal votes)")
    ap.add_argument("--decoders", type=int, default=1,
                    help="host decode workers for video files")
    ap.add_argument("--no-neural", action="store_true",
                    help="ablate the neural voter (classical ensemble only; "
                         "the voter participates only when a user-trained "
                         "cktrain checkpoint exists)")
    ap.add_argument("--oracle", choices=("jax", "cv2", "both"),
                    default="jax",
                    help="which pipeline to score: the JAX pipeline, the "
                         "independent host-side OpenCV pipeline, or both "
                         "(adds JAX-vs-cv2 cross-agreement)")
    args = ap.parse_args(argv)

    corners = None
    if args.corners:
        vals = [float(v) for v in args.corners.split(",")]
        corners = np.array(vals, np.float32).reshape(4, 2)

    report = check(args.video, args.sgf, corners=corners, batch=args.batch,
                   use_meta=not args.no_meta, use_neural=not args.no_neural,
                   oracle=args.oracle, decoders=args.decoders)
    print(json.dumps(report, indent=2, default=float))
    ok = report["agreement"] >= 0.99
    print(f"\n{'PASS' if ok else 'FAIL'}: {report['good']}/{report['ref_moves']} "
          f"moves agree ({report['agreement']:.1%}), "
          f"{report['wrong']} wrong, {report['missing']} missing, "
          f"{report['extra']} extra @ {report['fps']:.0f} fps")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
