"""Vision configuration + algorithm registries.

Parity: ``camkifu/config/cvconf.py`` (SURVEY §2.1) — the one place both the GUI
and the vision manager learn which detection algorithms exist. Adding a finder
class to ``bfinders`` / ``sfinders`` makes it appear in the GUI menu, exactly as
the reference's documented plugin surface (doc/Tutorial.md) promises.

Device-native additions: canonical geometry is chosen so that zone extraction is a
pure reshape on device (each intersection owns a ``zone_size``-square cell, the
canonical image side is ``gsize * zone_size``), and batching/scan constants for
the jitted pipeline live here.
"""

from __future__ import annotations

import dataclasses

from camkifu_tpu.config import guiconf

# ---------------------------------------------------------------------------
# Canonical geometry.
#
# The homography maps the four *corner intersections* of the physical goban to
# the centers of the four corner cells of the canonical image, so intersection
# (r, c) sits exactly at pixel ((r + 0.5) * zone_size, (c + 0.5) * zone_size).
# Zone extraction on device is then a reshape, not a gather (SURVEY §2.3:
# `_getzone` 361-gather → device reshape).
# ---------------------------------------------------------------------------

zone_size = 16                                  # px per intersection cell (canonical)
canonical_size = guiconf.gsize * zone_size      # 304 for gsize=19


def canonical_size_for(gsize: int, zone: int = zone_size) -> int:
    return gsize * zone


# ---------------------------------------------------------------------------
# Pipeline constants (device runtime).
# ---------------------------------------------------------------------------

#: Frames per jitted batch in film (recorded video) mode. The device scan
#: carries vote state across batches, so batch size only trades latency for
#: throughput.
frame_batch = 32

#: Temporal vote window F (SURVEY §2.1 sf_meta: cyclic buffer across F frames).
#: Votes decay with rate (1 - 1/F), so vote mass asymptotes at F.
vote_window = 7

#: Vote mass required before a reading commits. With window 7 this is
#: reached after ~6 consecutive consistent readings (mass = F·(1−(1−1/F)^k)).
vote_threshold = 4

#: Minimum per-intersection classifier confidence for a reading to cast a
#: vote at all.
vote_min_conf = 0.25

#: Fraction of changed pixels above which the frame is "agitated" (hand over
#: board) and stone reading is gated off (SURVEY §3.3 agitation check).
agitation_threshold = 0.012

#: EMA coefficient of the background model used for agitation / bg-sub.
background_ema = 0.05

#: Board re-detection period, in frames, when tracking is stable.
bf_period = 8

# ---------------------------------------------------------------------------
# Board-finder (Hough) constants.
# ---------------------------------------------------------------------------

#: Edge/Hough working resolution (detection runs on a downsampled gray frame).
bf_resolution = 256

#: Number of theta bins in the Hough accumulator.
hough_thetas = 128

#: Number of rho bins in the Hough accumulator.
hough_rhos = 256

#: Top-K edge pixels fed to the Hough vote (static shape, SURVEY §7 hard-part a).
hough_topk = 4096


# ---------------------------------------------------------------------------
# Dataclass config used by the runtime / CLI.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VisionConfig:
    gsize: int = guiconf.gsize
    zone_size: int = zone_size
    frame_batch: int = frame_batch
    vote_window: int = vote_window
    vote_threshold: int = vote_threshold
    vote_min_conf: float = vote_min_conf
    agitation_threshold: float = agitation_threshold
    background_ema: float = background_ema
    bf_period: int = bf_period
    bf_resolution: int = bf_resolution
    hough_thetas: int = hough_thetas
    hough_rhos: int = hough_rhos
    hough_topk: int = hough_topk

    @property
    def canonical_size(self) -> int:
        return self.gsize * self.zone_size


DEFAULT = VisionConfig()


# ---------------------------------------------------------------------------
# Algorithm registries (populated lazily to avoid import cycles; finders import
# this module for constants). First entry of each list = default in the GUI,
# mirroring the reference's convention.
# ---------------------------------------------------------------------------

def bfinders():
    from camkifu_tpu.board.bf_auto import BoardFinderAuto
    from camkifu_tpu.board.bf_manual import BoardFinderManual

    return [BoardFinderAuto, BoardFinderManual]


def sfinders():
    from camkifu_tpu.stone.sf_bgsub import SfBgSub
    from camkifu_tpu.stone.sf_clustering import SfClustering
    from camkifu_tpu.stone.sf_contours import SfContours
    from camkifu_tpu.stone.sf_meta import SfMeta
    from camkifu_tpu.stone.sf_neural import SfNeural
    from camkifu_tpu.stone.sf_tuto import SfTuto

    return [SfMeta, SfClustering, SfContours, SfBgSub, SfNeural, SfTuto]
