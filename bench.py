"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline (BASELINE.json): sustained 1080p frames/sec/card for board tracking
(detect + stone classify) — measured as BASELINE config 2 (batch of stills,
board detect once + per-frame classify). The other four BASELINE configs are
reported as sub-metrics in the same line:

  c1_still_ms        single 1080p still: detect + classify (latency)
  c2_fps             batch-128 1080p: one full board detection per batch +
                     per-frame classify, detection in the timed region
                     ← headline
  c3_video_fps       720p sequential frames through the SfMeta vote scan
                     (film mode: corners fixed after initial detection)
  c4_handheld_fps    1080p handheld: full detection (first frame) + per-
                     frame corner tracking + vote scan, all timed; the
                     every-frame-full-redetect rate is reported alongside
  c5_streams_fps     8 concurrent 1080p streams batched on one card

Inputs are drawn by utils/render_np (numpy + scipy). Method: inputs staged
in device memory once, `reps` dispatches queued
(pipelined, as the real feeder runs), fenced by a host fetch; best of 3.
Host→device staging is excluded from the steady-state numbers and reported
alongside. One process, on the GPU only: any other platform, or a card
whose peaks are not in utils/device.PEAKS, is an error.

Utilization accounting: for each config the compiled executable's XLA cost
analysis (flops + bytes accessed) is divided by the measured time and
compared against the card's published peaks. "bytes accessed" counts every
operand of every op, so it is an upper bound on device-memory traffic.

vs_baseline: ratio against the reference's implied live throughput (~30 fps
single-stream CPU webcam processing — BASELINE.md; it publishes no figures).

Run: ``python bench.py`` (one GPU).
"""

from __future__ import annotations

import json
import time

import numpy as np

#: c2's batch (the headline's frames per dispatch).
C2_BATCH = 128


def _timeit(fn, fence, reps=10, tries=3):
    fence(fn())                       # compile + sync
    best = float("inf")
    for _ in range(tries):
        t0 = time.perf_counter()
        out = None
        for _ in range(reps):
            out = fn()
        fence(out)
        best = min(best, time.perf_counter() - t0)
    return best / reps


def _cost(jitfn, *args, **kwargs):
    """(flops, bytes accessed) of one dispatch of an already-used jit.

    Lowering with the same signature as the timed call hits the jit cache —
    no extra compile."""
    ca = jitfn.lower(*args, **kwargs).compile().cost_analysis()
    return float(ca.get("flops", 0.0)), float(ca.get("bytes accessed", 0.0))


def _utilization(costs, seconds, peaks):
    """Roofline fractions for one config from per-dispatch XLA costs.

    costs: list of (flops, bytes) per dispatch in the timed unit. The flop
    bound uses the f32 peak: the pipeline pins its products to full f32.
    """
    flops = sum(c[0] for c in costs)
    byts = sum(c[1] for c in costs)
    fl_frac = flops / seconds / peaks["f32_flops_per_s"]
    hbm_frac = byts / seconds / peaks["hbm_bytes_per_s"]
    return {
        "gflops_per_s": round(flops / seconds / 1e9, 1),
        "hbm_GBps": round(byts / seconds / 1e9, 1),
        "flops_frac": round(fl_frac, 4),
        "hbm_frac": round(hbm_frac, 4),
        "bound": "hbm" if hbm_frac >= fl_frac else "flops",
        "roofline_frac": round(max(fl_frac, hbm_frac), 4),
    }


def main() -> None:
    from camkifu_tpu.utils import device, jaxcache
    jaxcache.enable()

    import jax
    import jax.numpy as jnp

    from camkifu_tpu import pipeline
    from camkifu_tpu.board import bf_auto
    from camkifu_tpu.stone import sf_meta
    from camkifu_tpu.utils import render_np

    dev = device.require_gpu()
    peaks = device.peaks(dev["kind"])
    card = device.card_name_and_power_limit()
    print(f"device: platform={dev['platform']} kind={dev['kind']} "
          f"count={dev['count']}; card: {card}", flush=True)

    fence = lambda x: np.asarray(jax.tree.leaves(x)[0])

    labels = np.zeros((19, 19), np.int8)
    rng = np.random.default_rng(0)
    idx = rng.choice(361, 100, replace=False)
    labels.flat[idx[:50]] = 1
    labels.flat[idx[50:]] = 2

    def render(hw):
        corners = render_np.default_corners(hw)
        canon = render_np.canonical_board(labels, render_np.zone_for(hw))
        return render_np.render_frame(canon, corners, hw), corners

    frame1080, corners1080 = render((1080, 1920))
    frame720, corners720 = render((720, 1280))

    t0 = time.perf_counter()
    batch = C2_BATCH
    f1080_b = jax.device_put(jnp.broadcast_to(jnp.asarray(frame1080),
                                              (batch,) + frame1080.shape))
    fence(f1080_b)
    stage_s = time.perf_counter() - t0
    c1080 = jax.device_put(jnp.asarray(corners1080, jnp.float32))

    # -- c2 (headline): batch stills, detect + classify. Detection runs
    # INSIDE the timed region (the metric name says "detect") at the
    # fixed-camera cadence: one full board detection per batch, stone
    # classification on every frame.
    def c2():
        cs, _ = bf_auto.detect_corners(f1080_b[0])
        return pipeline.read_board_batch(f1080_b, cs)[0]
    c2_s = _timeit(c2, fence)
    c2_fps = C2_BATCH / c2_s
    cs_probe, _ = bf_auto.detect_corners(f1080_b[0])
    c2_util = _utilization(
        [_cost(bf_auto.detect_corners, f1080_b[0]),
         _cost(pipeline.read_board_batch, f1080_b, cs_probe)], c2_s, peaks)

    # -- c1: single-still latency (detect + classify, one frame) ------------
    f1 = f1080_b[:1]
    def c1():
        cs, _ = bf_auto.detect_corners(f1[0])
        return pipeline.read_board_batch(f1, cs)[0]
    c1_ms = _timeit(c1, fence, reps=3) * 1e3

    # -- c3: recorded 720p video through the SfMeta scan --------------------
    f720_b = jax.device_put(jnp.broadcast_to(jnp.asarray(frame720),
                                             (batch,) + frame720.shape))
    c720 = jax.device_put(jnp.asarray(corners720, jnp.float32))
    state0 = sf_meta.init_state()
    c3_s = _timeit(lambda: sf_meta.read_batch(state0, f720_b, c720)[1],
                   fence)
    c3_fps = batch / c3_s
    c3_util = _utilization([_cost(sf_meta.read_batch, state0, f720_b, c720)],
                           c3_s, peaks)

    # -- c4: handheld — REAL per-frame board measurement in the timed
    # region (VERDICT r1 item 3): full detection on the batch's first frame
    # + per-frame corner tracking (every frame's corners measured from its
    # own pixels) + the vote scan on the tracked (B, 4, 2) corners. The
    # amortized full-redetect rate is reported alongside.
    def c4():
        seed, _ = bf_auto.detect_corners(f1080_b[0])
        return sf_meta.track_read_batch(state0, f1080_b, seed)[1]
    c4_s = _timeit(c4, fence)
    c4_fps = batch / c4_s
    seed_probe, _ = bf_auto.detect_corners(f1080_b[0])
    c4_util = _utilization(
        [_cost(bf_auto.detect_corners, f1080_b[0]),
         _cost(sf_meta.track_read_batch, state0, f1080_b, seed_probe)], c4_s,
        peaks)
    # Full-redetection rate: every frame fully re-detected through the
    # batch API (batched stage 1 + shared-canvas or per-frame refine; see
    # detect_batch's docstring), 64 frames per batch so the per-batch fixed
    # cost amortizes over more frames.
    redet_n = 64
    det_s = _timeit(lambda: bf_auto.detect_batch(f1080_b[:redet_n])[0],
                    fence, reps=3)
    c4_full_redetect_fps = redet_n / det_s

    # -- c5: 8 concurrent 1080p streams on one chip (the multi-stream
    # flattening of parallel.mesh._read_all_streams) ------------------------
    from camkifu_tpu.parallel.mesh import _read_all_streams

    streams, per = 8, 16
    f_multi = jax.device_put(jnp.broadcast_to(
        jnp.asarray(frame1080), (streams, per) + frame1080.shape))
    c_multi = jax.device_put(jnp.broadcast_to(c1080, (streams, 4, 2)))
    c5_s = _timeit(
        lambda: _read_all_streams(f_multi, c_multi, 19, 16)[0], fence)
    c5_fps = streams * per / c5_s
    c5_util = _utilization([_cost(_read_all_streams, f_multi, c_multi,
                                  19, 16)], c5_s, peaks)

    # Sanity: the pipeline must still read the board correctly.
    out, _ = pipeline.read_board_batch(f1080_b[:1], c1080)
    ok = bool(np.array_equal(np.asarray(out[0]), labels))

    util = {"c2": c2_util, "c3": c3_util, "c4": c4_util, "c5": c5_util}
    print(json.dumps({
        "metric": "1080p_frames_per_sec_per_chip_detect_classify",
        "value": round(c2_fps, 1),
        "unit": "fps",
        "vs_baseline": round(c2_fps / 30.0, 2),
        "c2_batch": C2_BATCH,
        "accuracy_sanity": ok,
        "c1_still_ms": round(c1_ms, 2),
        "c2_fps": round(c2_fps, 1),
        "c3_video_fps": round(c3_fps, 1),
        "c4_handheld_fps": round(c4_fps, 1),
        "c4_full_redetect_fps": round(c4_full_redetect_fps, 1),
        "c5_streams_fps": round(c5_fps, 1),
        "staging_MBps": round(batch * frame1080.nbytes / 1e6 / stage_s, 1),
        "device": dev,
        "card": card,
        "utilization": util,
    }))


if __name__ == "__main__":
    main()
