"""camkifu_tpu — an accelerator-native JAX rebuild of CamKifu's video→kifu
pipeline.

The reference (ArnaudPel/CamKifu + its Golib dependency; see SURVEY.md) watches a
physical Go game through a camera and emits the game record as SGF. This package
rebuilds every capability of that stack in JAX, compiled by XLA for the GPU:

- ``camkifu_tpu.gamemodel``  — Go game core (Move, rules + captures, SGF, Kifu);
  host-side Python (parity with Golib ``golib/model`` — SURVEY §2.2).
- ``camkifu_tpu.ops``        — the device compute primitives replacing the reference's
  OpenCV calls (SURVEY §2.3): homography warp, Gaussian/Sobel/NMS edges, Hough
  accumulation, k-means, morphology, background models; plain jnp/lax.
- ``camkifu_tpu.board``      — BoardFinder family (auto Hough-corner detection and
  manual corners; SURVEY §2.1 ``camkifu/board``).
- ``camkifu_tpu.stone``      — StonesFinder family (clustering / contours / meta
  temporal-vote ensemble / tutorial / neural; SURVEY §2.1 ``camkifu/stone``).
- ``camkifu_tpu.core``       — runtime: frame feeder (VManager equivalent),
  vision controller (ControllerV equivalent), capture wrappers.
- ``camkifu_tpu.models``     — flax neural stone classifier (sf_neural equivalent).
- ``camkifu_tpu.parallel``   — device-mesh sharding of the pipeline over streams.
- ``camkifu_tpu.gui``        — optional Tk GUI (goban display + corrections).
"""

__version__ = "0.1.0"
