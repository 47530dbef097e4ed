"""The jitted vision pipeline: frame batches in, board readings out.

This is the device replacement for the reference's thread-per-finder loop
(SURVEY §2.4): instead of a BoardFinder thread and a StonesFinder thread
trading frames through locks, one pure jitted function consumes a batch of
frames and returns fixed-shape per-frame board states + confidences; the host
runtime (core.vmanager) feeds batches and diffs readings into moves.

Stage composition per batch:
  uint8 frames (B, H, W, 3)
    → [board detect: corners per frame or fixed]      (board.bf_auto)
    → warp to canonical (B, S, S, 3) float [0,1]      (ops.warp)
    → per-frame stone classify                        (stone.*)
    → temporal vote scan carrying state across frames (stone.sf_meta)
    → labels (B, g, g) int8, confidence, agitation
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from camkifu_tpu.config import cvconf, guiconf
from camkifu_tpu.ops.warp import warp_batch_chunked, warp_batch_fixed
from camkifu_tpu.stone import sf_clustering


@functools.partial(jax.jit, static_argnames=("gsize", "zone"))
def read_board_batch(frames: jnp.ndarray, corners: jnp.ndarray,
                     gsize: int = guiconf.gsize,
                     zone: int = cvconf.zone_size, lens=None):
    """Stage-3 slice (BASELINE config 1/2): fixed corners, per-frame
    clustering classification, no temporal state.

    frames: (B, H, W, 3) uint8.  corners: (4, 2) float32 (fixed camera) or
    (B, 4, 2) per-frame.
    Returns (labels (B, g, g) int8, confidence (B, g, g) float32).

    Matmul precision is pinned to float32 throughout: the DLT solve and the
    zone-statistic einsums are numerically tiny but accuracy-critical, and
    a reduced default matmul precision (bf16 on some accelerators, TF32 on
    the GPU) corrupts the homography (pixel-scale warp error →
    misclassification). The neural classifier opts into bf16 explicitly.
    """
    with jax.default_matmul_precision("float32"):
        # Warp straight from uint8 (the gather converts only its taps) and
        # rescale the small canonical output — converting frames first would
        # write a 4× f32 copy of every frame to device memory.
        scale = 1.0 / 255.0 if frames.dtype == jnp.uint8 else 1.0
        if corners.ndim == 2:
            canon = warp_batch_fixed(frames, corners, gsize, zone,
                                     lens) * scale
        else:
            canon = warp_batch_chunked(frames, corners, gsize, zone,
                                       lens=lens) * scale
        return jax.vmap(
            lambda c: sf_clustering.classify_canonical(c, gsize, zone))(canon)
