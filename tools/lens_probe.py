"""Radial lens distortion probe: detection accuracy vs lens_k1.

Real webcams are not pinhole cameras — straight board lines bow. The
detection model (homography + straight lattice) has no distortion term,
so this measures the graceful-degradation envelope: max corner error of
full detect_corners against the DISTORTED ground-truth corners, across
barrel (k1>0) and pincushion (k1<0) strengths, at a mid-game density.

Usage: JAX_PLATFORMS=cpu python tools/lens_probe.py [k1 ...]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax.numpy as jnp

from camkifu_tpu.board import bf_auto
from camkifu_tpu.utils import synth

K1S = [0.0, 0.02, 0.04, 0.08, 0.12, -0.04, -0.08]


def run(k1, nstones=60, hw=(1080, 1920), persp=0.12):
    rng = np.random.default_rng(13)
    labels = np.zeros((19, 19), np.int8)
    idx = rng.choice(361, nstones, replace=False)
    labels.flat[idx[: nstones // 2]] = 1
    labels.flat[idx[nstones // 2:]] = 2
    corners = synth.default_corners(hw, perspective=persp)
    frame, corners = synth.render_frame(labels, corners=corners,
                                        frame_hw=hw, lens_k1=k1)
    fj = jnp.asarray(frame)
    det, score = bf_auto.detect_corners(fj)
    cell = np.linalg.norm(corners[1] - corners[0]) / 18.0
    err = np.linalg.norm(np.asarray(det) - corners, axis=-1)
    # Calibrated path: estimate k1 from the frame, detect with the lens.
    est, gain = bf_auto.estimate_lens_k1(fj)
    det_c, _, _ = bf_auto._detect_k1_probe(fj, jnp.float32(est))
    err_c = np.linalg.norm(np.asarray(det_c) - corners, axis=-1)
    return (float(err.max() / cell), float(score), est,
            float(err_c.max() / cell))


if __name__ == "__main__":
    k1s = [float(a) for a in sys.argv[1:]] or K1S
    for k1 in k1s:
        cells, score, est, cells_c = run(k1)
        print(f"k1={k1:+.3f}  plain={cells:5.2f} cells (score={score:.2f})"
              f"  est={est:+.4f}  calibrated={cells_c:5.2f} cells",
              flush=True)
