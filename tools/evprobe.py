"""Evidence-landscape diagnostic for the saturated + strong-perspective
residual (NEXT.md item 4: 220 stones / persp 0.30 detects ~0.55 cells off).

Separates the two _evidence_map channels (luma-deviation vs gradient
center-surround) and reports, per channel combination:
  - evidence at TRUTH vs at the current DETECTION result;
  - where _evidence_polish walks when started AT truth (walk-away px).

Usage: JAX_PLATFORMS=cpu python tools/evprobe.py [nstones persp]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if os.environ.get("JAX_PLATFORMS"):
    import jax

    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
import numpy as np
import jax
import jax.numpy as jnp

from camkifu_tpu.board import bf_auto
from camkifu_tpu.ops.filters import sobel
from camkifu_tpu.utils import synth


def channel_maps(rect, gsize):
    """The two center-surround channels of _evidence_map, un-summed."""
    res = rect.shape[0]
    from camkifu_tpu.ops.zones import median_u8
    wood = median_u8(rect[::4, ::4].reshape(1, -1))[0]
    dev = jnp.abs(rect - wood)
    gx, gy = sobel(rect)
    edge = jnp.abs(gx) + jnp.abs(gy)
    s_cell = res / (gsize + 1.0)
    r_in = max(1, int(s_cell * 0.18))
    r_out = max(r_in + 2, int(s_cell * 0.6))
    cs_dev = bf_auto._box_blur(dev, r_in) - bf_auto._box_blur(dev, r_out)
    cs_edge = bf_auto._box_blur(edge, r_in) - bf_auto._box_blur(edge, r_out)
    Ed = jnp.maximum(cs_dev, 0.0) / jnp.maximum(jnp.abs(cs_dev).max(), 1e-9)
    Ee = jnp.maximum(cs_edge, 0.0) / jnp.maximum(jnp.abs(cs_edge).max(), 1e-9)
    return Ed, Ee


def main(nstones=220, persp=0.30, hw=(1080, 1920), gsize=19):
    rng = np.random.default_rng(7 + nstones)
    labels = np.zeros((gsize, gsize), np.int8)
    idx = rng.choice(gsize * gsize, nstones, replace=False)
    labels.flat[idx[: nstones // 2]] = 1
    labels.flat[idx[nstones // 2:]] = 2
    corners = synth.default_corners(hw, perspective=persp)
    frame, corners = synth.render_frame(labels, corners=corners, frame_hw=hw)
    frame = jnp.asarray(frame)
    truth = jnp.asarray(corners, jnp.float32)

    det, score = bf_auto.detect_corners(frame)
    det = jnp.asarray(det)
    cell = float(np.linalg.norm(corners[1] - corners[0]) / (gsize - 1))
    err_det = float(np.abs(np.asarray(det) - corners).max())
    print(f"score={float(score):.3f} det max_err={err_det:.1f} px "
          f"(cell={cell:.1f} px)")

    gray, quad, _ = bf_auto._detect_prepare(frame, bf_auto.cvconf.bf_resolution)
    H, _, _, rect = bf_auto._rect_profiles_rect(gray, quad, gsize, margin=0.10)
    Hinv = jnp.linalg.inv(H)
    Ed, Ee = jax.jit(channel_maps, static_argnums=1)(rect, gsize)

    combos = [("dev+edge", Ed + Ee), ("dev only", Ed), ("edge only", Ee)]
    pair = jnp.stack([truth, det])
    for name, E in combos:
        ev = bf_auto._lattice_evidence(E, Hinv, pair, gsize)
        pol = bf_auto._evidence_polish(E, H, Hinv, truth, gsize)
        walk = float(jnp.abs(pol - truth).max())
        print(f"[{name:9s}] ev(truth)={float(ev[0]):.4f} "
              f"ev(det)={float(ev[1]):.4f}  "
              f"polish-from-truth walk={walk:6.1f} px "
              f"({walk / cell:.2f} cells)")

    # Rank-level: the full prior-carrying ranking the detector actually
    # uses, plus where polish seeded on the DETECTED winner lands.
    E = Ed + Ee
    qcell = jnp.linalg.norm(quad[1] - quad[0]) / gsize
    pol_det = bf_auto._evidence_polish(E, H, Hinv, det, gsize)
    trio = jnp.stack([truth, det, pol_det])
    rank = bf_auto._rank_evidence(trio, E, Hinv, quad, qcell, gsize)
    ev3 = bf_auto._lattice_evidence(E, Hinv, trio, gsize)
    err_pol = float(np.abs(np.asarray(pol_det) - corners).max())
    print(f"rank(truth)={float(rank[0]):.4f} rank(det)={float(rank[1]):.4f} "
          f"rank(polish-from-det)={float(rank[2]):.4f}")
    print(f"prior(truth)={float(rank[0] - ev3[0]):+.4f} "
          f"prior(det)={float(rank[1] - ev3[1]):+.4f} "
          f"prior(pol)={float(rank[2] - ev3[2]):+.4f}")
    print(f"polish-from-det err={err_pol:.1f} px ({err_pol / cell:.2f} cells)"
          f" ev={float(ev3[2]):.4f}")


if __name__ == "__main__":
    args = sys.argv[1:]
    if args:
        main(int(args[0]), float(args[1]))
    else:
        main()
