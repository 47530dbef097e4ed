"""Saturated cold-start stress probe (stones x perspective, 1080p, CPU).

Measures max corner error (px and cells) of full detect_corners on
stone-saturated synthetic boards — the round-3 weak pose (PERF.md:
candidate-set-limited ~39 px at 220 stones / perspective 0.30). Run after
any change to the saturated refinement branch.

Usage: JAX_PLATFORMS=cpu python tools/sat_probe.py [nstones:persp ...]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax.numpy as jnp

from camkifu_tpu.board import bf_auto
from camkifu_tpu.utils import synth

CONFIGS = [(220, 0.05), (220, 0.15), (220, 0.30),
           (250, 0.05), (250, 0.30), (140, 0.30), (180, 0.22)]


def run(nstones, persp, hw=(1080, 1920)):
    rng = np.random.default_rng(7 + nstones)
    labels = np.zeros((19, 19), np.int8)
    idx = rng.choice(361, nstones, replace=False)
    labels.flat[idx[: nstones // 2]] = 1
    labels.flat[idx[nstones // 2:]] = 2
    corners = synth.default_corners(hw, perspective=persp)
    frame, corners = synth.render_frame(labels, corners=corners,
                                        frame_hw=hw)
    det, score = bf_auto.detect_corners(jnp.asarray(frame))
    cell = np.linalg.norm(corners[1] - corners[0]) / 18.0
    err = np.linalg.norm(np.asarray(det) - corners, axis=-1)
    return float(err.max()), float(err.max() / cell), float(score)


if __name__ == "__main__":
    configs = CONFIGS
    if len(sys.argv) > 1:
        configs = [tuple(map(float, a.split(":"))) for a in sys.argv[1:]]
        configs = [(int(n), p) for n, p in configs]
    for n, p in configs:
        px, cells, score = run(n, p)
        print(f"stones={n:4d} persp={p:.2f}  max_err={px:7.1f} px "
              f"({cells:5.2f} cells)  score={score:.2f}", flush=True)
