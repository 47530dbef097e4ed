"""SfBgSub — background-subtraction stone detection.

Parity: the reference's frame-diff / background-subtraction stones path
(SURVEY §2.1 row "absdiff / background subtraction / MOG-style", §2.3;
``sf_bgsub.py`` existed on reference branches — SURVEY Appendix A.2). Where
SfContours compares a zone against a *spatial* background estimate (corner
wood), this finder learns the actual empty-board appearance *temporally*:
an EMA RGB background of the canonical view, updated only where the board
is stably empty and motionless, so stones and hands never melt into it. A
stone is a persistent signed luma deviation of the disc median from the
remembered background — robust to unusual board textures and markings that
fool spatial estimates.

Device-first: a lax.scan with an explicit, host-resettable state pytree, like
SfMeta; shares the vote machinery (stone.votes).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from camkifu_tpu.config import cvconf, guiconf
from camkifu_tpu.ops import background
from camkifu_tpu.ops.color import rgb_to_gray
from camkifu_tpu.ops.warp import warp_batch_chunked, warp_to_canonical
from camkifu_tpu.ops.zones import disc_mask, extract_zones
from camkifu_tpu.stone.votes import vote_update, zone_motion_gate

EMPTY, BLACK, WHITE = 0, 1, 2

#: |disc-median luma − background| to call a stone.
PRESENCE_THRESH = 0.13

#: EMA rate of the empty-board background (per eligible frame).
BG_EMA = 0.08

#: Motion-gate pooling factor (canonical → small grid), as in sf_meta.
GATE_FACTOR = 4


class BgSubState(NamedTuple):
    votes: jnp.ndarray        # (g, g, 3)
    stable: jnp.ndarray       # (g, g) int8
    bg: jnp.ndarray           # (S, S) float32 — empty-board luma
    prev: jnp.ndarray         # (S/f, S/f) float32 — previous small luma
    frame_count: jnp.ndarray  # () int32


def init_state(gsize: int = guiconf.gsize,
               zone: int = cvconf.zone_size) -> BgSubState:
    s = gsize * zone
    return BgSubState(
        votes=jnp.zeros((gsize, gsize, 3), jnp.float32),
        stable=jnp.zeros((gsize, gsize), jnp.int8),
        bg=jnp.full((s, s), -1.0, jnp.float32),
        prev=jnp.full((s // GATE_FACTOR, s // GATE_FACTOR), -1.0,
                      jnp.float32),
        frame_count=jnp.zeros((), jnp.int32),
    )


def step_frame(state: BgSubState, canonical: jnp.ndarray,
               gsize: int = guiconf.gsize, zone: int = cvconf.zone_size,
               cfg: cvconf.VisionConfig = cvconf.DEFAULT):
    """canonical (S, S, 3) in [0, 1] → (state, (labels, conf, agitation))."""
    luma = rgb_to_gray(canonical)                          # (S, S)
    small = luma[:luma.shape[0] // GATE_FACTOR * GATE_FACTOR,
                 :luma.shape[1] // GATE_FACTOR * GATE_FACTOR] \
        .reshape(luma.shape[0] // GATE_FACTOR, GATE_FACTOR,
                 luma.shape[1] // GATE_FACTOR, GATE_FACTOR).mean(axis=(1, 3))
    prev = jnp.where(state.prev[0, 0] < 0, small, state.prev)
    zone_calm, agitation = zone_motion_gate(small, prev, gsize)

    # First frame initializes the background. Known limitation (shared with
    # the reference's experimental bgsub finders): stones already on the
    # board at initialization are absorbed into the background and stay
    # invisible to this finder until they move — start from an empty board,
    # or use SfMeta (whose spatial estimators have no such memory).
    bg = jnp.where(state.bg[0, 0] < 0, luma, state.bg)

    # Exposure compensation: normalize the frame to the background's
    # exposure (robust_gain — histogram median of the ratio, immune to
    # stones/hands as long as they are a pixel minority). Without it a
    # sustained auto-exposure shift biases EVERY disc's |luma − bg| by
    # ~gain·luma — at 20% that is ≈0.11, most of PRESENCE_THRESH, flipping
    # whole boards into phantom stones until the EMA re-converges.
    # The gain is one global scalar: estimate it on the 4×-downsampled
    # luma (already computed for the motion gate) against an equally
    # downsampled background — the full-res histogram costs ~16× more
    # comparisons inside this per-frame scan for the same median.
    bg_small = background.downsample_luma(bg, GATE_FACTOR)
    luma = luma / background.robust_gain(small, bg_small)

    # Presence: disc median of (luma − bg) per zone.
    zones_diff = extract_zones((luma - bg)[..., None], gsize, zone)[..., 0]
    flat = zones_diff.reshape(gsize, gsize, zone * zone)
    disc_idx = np.nonzero(np.asarray(disc_mask(zone)).reshape(-1) > 0.5)[0]
    med_diff = jnp.median(flat[..., disc_idx], axis=-1)    # (g, g)

    is_stone = jnp.abs(med_diff) > PRESENCE_THRESH
    color = jnp.where(med_diff < 0, BLACK, WHITE).astype(jnp.int8)
    labels = jnp.where(is_stone, color, EMPTY).astype(jnp.int8)
    conf = jnp.clip((jnp.abs(med_diff) - PRESENCE_THRESH)
                    / (0.4 - PRESENCE_THRESH), 0.0, 1.0)
    conf = jnp.where(is_stone, conf,
                     jnp.clip(1.0 - jnp.abs(med_diff) / PRESENCE_THRESH,
                              0.0, 1.0))

    new_votes, new_stable, out_conf = vote_update(
        state.votes, state.stable, labels, conf, zone_calm, cfg)

    # Background learning: only pixels of zones that are stably EMPTY, read
    # empty *right now*, and are calm may update. Gating on the stable state
    # alone loses a race: a freshly placed stone needs ~6 frames of votes to
    # commit, and an EMA at 0.08 absorbs a third of its contrast in that
    # time — enough to push low-contrast (white) stones under the detection
    # threshold before they ever commit.
    empty_zone = (new_stable == EMPTY).astype(jnp.float32) \
        * (labels == EMPTY).astype(jnp.float32) * zone_calm
    pixel_mask = jnp.kron(empty_zone, jnp.ones((zone, zone), jnp.float32))
    rate = BG_EMA * pixel_mask
    new_bg = bg * (1.0 - rate) + luma * rate

    new_state = BgSubState(votes=new_votes, stable=new_stable, bg=new_bg,
                           prev=small, frame_count=state.frame_count + 1)
    return new_state, (new_stable, out_conf, agitation)


@functools.partial(jax.jit, static_argnames=("gsize", "zone"))
def read_batch(state: BgSubState, frames: jnp.ndarray, corners: jnp.ndarray,
               gsize: int = guiconf.gsize, zone: int = cvconf.zone_size,
               valid_count=None, lens=None):
    """Scan over a frame batch; same contract as sf_meta.read_batch
    (incl. valid_count masking padded tail frames out of the state).

    The warp (the expensive stage) runs batched; the scan carries only the
    background/vote state and does per-frame zone medians against the
    *current* background — exact sequential semantics at a fraction of the
    cost of scanning the whole pipeline.
    """
    with jax.default_matmul_precision("float32"):
        per_frame = corners.ndim == 3
        scale = 1.0 / 255.0 if frames.dtype == jnp.uint8 else 1.0

        if per_frame:
            canon = warp_batch_chunked(frames, corners, gsize, zone,
                                       lens=lens) * scale
        else:
            canon = jax.vmap(
                lambda f: warp_to_canonical(f, corners, gsize, zone,
                                            lens) * scale)(frames)

        b = canon.shape[0]
        if valid_count is None:
            valid = jnp.ones((b,), bool)
        else:
            valid = jnp.arange(b) < valid_count

        def body(carry, x):
            canonical, v = x
            new_carry, outs = step_frame(carry, canonical, gsize, zone)
            kept = jax.tree.map(lambda n, o: jnp.where(v, n, o),
                                new_carry, carry)
            return kept, outs

        state, outs = jax.lax.scan(body, state, (canon, valid))
        return (state,) + outs


def reset_votes(state: BgSubState, positions) -> BgSubState:
    votes = np.asarray(state.votes).copy()
    stable = np.asarray(state.stable).copy()
    for r, c in positions:
        votes[r, c] = 0.0
        stable[r, c] = 0
    return state._replace(votes=jnp.asarray(votes),
                          stable=jnp.asarray(stable))


# ---------------------------------------------------------------------------
# Host finder class (cvconf-registered).
# ---------------------------------------------------------------------------

from camkifu_tpu.stone.stonesfinder import StonesFinder as _SF  # noqa: E402


class SfBgSub(_SF):
    """Background-subtraction finder host: carries the scan state across
    batches; corrections invalidate votes."""

    label = "bgsub"

    def __init__(self, vmanager):
        super().__init__(vmanager)
        self.state = init_state(gsize=self.gsize)

    def _find(self, frames, corners):
        n = self._batch_valid
        vc = None if n is None or n >= frames.shape[0] else jnp.int32(n)
        self.state, labels, conf, agitation = read_batch(
            self.state, jnp.asarray(frames),
            jnp.asarray(corners, jnp.float32), gsize=self.gsize,
            valid_count=vc, lens=self._bf_lens())
        self.metadata["agitation"] = round(
            float(np.asarray(agitation).mean()), 4)
        return labels, conf

    def _invalidate(self, positions) -> None:
        self.state = reset_votes(self.state, positions)
