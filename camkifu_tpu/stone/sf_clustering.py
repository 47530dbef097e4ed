"""SfClustering — whole-board k-means color classification.

Parity: ``camkifu/stone/sf_clustering.py`` (SURVEY §2.1) — per-intersection
color statistics, k-means K=3, clusters ordered by luminance (darkest=black,
brightest=white, middle=wood), with self-assessment: the algorithm abstains
when clusters are not well separated (degenerate with few stones on board).

Device-first: the device function is pure and static-shape; cv2.kmeans becomes
fixed-iteration Lloyd (ops.kmeans); clustering runs on per-channel local
*contrast* (disc mean − annulus background) which keeps the three populations
separable under lighting gradients; abstention becomes explicit per-
intersection confidence (SURVEY §5: same abstention semantics as confidence
outputs). vmaps over the frame axis.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from camkifu_tpu.config import cvconf, guiconf
from camkifu_tpu.ops.kmeans import kmeans

# Labels follow the gamemodel convention: 0=E, 1=B, 2=W.
EMPTY, BLACK, WHITE = 0, 1, 2

_LUMA = np.array([0.299, 0.587, 0.114], dtype=np.float32)

#: Minimum RGB-contrast norm (on [0,1] scale) for a cluster to count as
#: stones. The norm (not luma alone) matters: white stones on light wood
#: have little *luma* contrast but differ strongly in the blue channel.
MIN_CLUSTER_CONTRAST = 0.15

#: Initial centroids in contrast space (gray): black, wood, white.
INIT_CONTRAST = (-0.35, 0.0, 0.35)


def classify_features(feats: jnp.ndarray, iters: int = 8):
    """Classify all intersections of one frame from zone features.

    feats: (g, g, 7) from ops.zones.zone_features, values scaled to [0, 1].
    Returns (labels (g, g) int8 ∈ {E, B, W}, confidence (g, g) in [0, 1]).
    """
    g = feats.shape[0]
    return _classify_contrast(
        (feats[..., 0:3] - feats[..., 3:6]).reshape(g * g, 3), g, iters)


def _classify_contrast(contrast: jnp.ndarray, g: int, iters: int = 8):
    """Core k-means classification on (g·g, 3) per-channel local contrast."""
    init = jnp.array([[c, c, c] for c in INIT_CONTRAST], jnp.float32)
    cents, raw_labels, _ = kmeans(contrast, k=3, iters=iters, init=init)

    # Order clusters by luminance of their contrast: most negative = black,
    # most positive = white (reference: order by luminance).
    cluster_luma = jnp.matmul(cents, _LUMA, precision="highest")  # (3,)
    rank = jnp.argsort(jnp.argsort(cluster_luma))     # 0=darkest..2=brightest
    # rank-of-my-cluster → label: darkest→B, middle→E, brightest→W
    rank_to_label = jnp.array([BLACK, EMPTY, WHITE], jnp.int8)
    labels = rank_to_label[rank[raw_labels]]

    # Self-assessment: a "stone" cluster whose centroid contrast *norm* is
    # too weak is degenerate (few/no stones of that color) — its members are
    # empty.
    cluster_mag = jnp.linalg.norm(cents, axis=-1)              # (3,)
    strong = cluster_mag >= MIN_CLUSTER_CONTRAST
    member_strong = strong[raw_labels]
    labels = jnp.where(member_strong | (labels == EMPTY), labels, EMPTY)

    # Confidence from the sample's own contrast norm: stones scale up from
    # the threshold, empties scale down toward zero contrast.
    mag = jnp.linalg.norm(contrast, axis=-1)          # (g*g,)
    conf_stone = jnp.clip((mag - MIN_CLUSTER_CONTRAST)
                          / (0.45 - MIN_CLUSTER_CONTRAST), 0.0, 1.0)
    conf_empty = jnp.clip(1.0 - mag / MIN_CLUSTER_CONTRAST, 0.0, 1.0)
    conf = jnp.where(labels == EMPTY, conf_empty, conf_stone)
    return labels.reshape(g, g), conf.reshape(g, g)


def classify_stats(stats: dict, iters: int = 8):
    """Classify from shared zone statistics (ops.zones.zone_stats)."""
    contrast = stats["disc_mean_rgb"] - stats["bg_rgb"]      # (g, g, 3)
    g = contrast.shape[0]
    return _classify_contrast(contrast.reshape(g * g, 3), g, iters)


def classify_canonical(canonical: jnp.ndarray, gsize: int = guiconf.gsize,
                       zone: int = cvconf.zone_size):
    """Canonical image (S, S, 3) in [0, 1] → (labels, confidence)."""
    from camkifu_tpu.ops.zones import zone_stats

    return classify_stats(zone_stats(canonical, gsize, zone))


classify_batch = jax.vmap(classify_canonical)


# ---------------------------------------------------------------------------
# Host finder class (cvconf-registered; SURVEY §2.1 sf_clustering).
# ---------------------------------------------------------------------------

from camkifu_tpu.stone.stonesfinder import StonesFinder as _SF  # noqa: E402


class SfClustering(_SF):
    """Whole-board k-means finder host: per-frame classification, no
    temporal state (the meta finder adds votes)."""

    label = "clustering"

    def _find(self, frames, corners):
        import jax.numpy as jnp

        from camkifu_tpu import pipeline

        return pipeline.read_board_batch(jnp.asarray(frames),
                                         jnp.asarray(corners, jnp.float32),
                                         gsize=self.gsize,
                                         lens=self._bf_lens())


if __name__ == "__main__":          # golden-input probe (SURVEY §4)
    import sys

    import cv2

    from camkifu_tpu.board import bf_auto
    from camkifu_tpu.ops.warp import warp_to_canonical
    from camkifu_tpu.utils import board_to_ascii, jaxcache

    jaxcache.enable()
    img = cv2.imread(sys.argv[1])
    if img is None:
        sys.exit(f"cannot read image: {sys.argv[1]}")
    frame = jnp.asarray(img[:, :, ::-1].copy())
    if len(sys.argv) > 2:
        vals = [float(v) for v in sys.argv[2].split(",")]
        corners = jnp.asarray(np.array(vals, np.float32).reshape(4, 2))
    else:
        corners, score = bf_auto.detect_corners(frame)
        print("auto-detected corners, score", float(score))
    canon = warp_to_canonical(frame, corners) / 255.0
    labels, conf = classify_canonical(canon)
    print(board_to_ascii(labels))
    print(f"stones: {int((np.asarray(labels) != 0).sum())}, "
          f"min conf {float(jnp.min(conf)):.2f}")
