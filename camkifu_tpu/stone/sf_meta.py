"""SfMeta — the production ensemble: contours + clustering, per-region trust,
agitation gating, temporal vote accumulation.

Parity: ``camkifu/stone/sf_meta.py`` (SURVEY §2.1) — region state machines
(3×3 sub-boards, calibration → search), agitation gating via frame diffing,
SfContours early → SfClustering once it cross-validates, per-intersection
votes in a cyclic buffer across F frames, with only consistent readings
becoming suggestions, and periodic full-board re-reads for self-correction.

Device-first mapping (SURVEY §5 long-context analogue): the frame axis is a
``lax.scan`` carrying a small state pytree — the cyclic vote buffer becomes a
decayed vote accumulator (g, g, 3); the region state machines become a (3, 3)
trust EMA of contours/clustering agreement; the agitation gate zeroes the
vote update. The scan state is an explicit, host-resettable pytree so human
corrections can invalidate votes (SURVEY §7 hard-part c).
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
from camkifu_tpu.ops.zones import zone_stats
from camkifu_tpu.stone import sf_clustering, sf_contours
from camkifu_tpu.stone.votes import vote_update, zone_motion_gate

#: Region-trust EMA rate and the threshold above which a region switches
#: from contours to clustering (the reference's calibration→search promote).
TRUST_EMA = 0.08
TRUST_PROMOTE = 0.9

#: Background downsample factor (canonical → bg grid).
BG_FACTOR = 4

#: Pose veto (SfMeta._pose_vetoed): minimum committed stones for the check
#: to be meaningful, and the minimum fraction of them a freshly anchored
#: pose's readings must reproduce. A correct anchor reads ≥~0.9 of the
#: committed stones even under capture lag / a hand in frame. An impostor
#: pose does NOT read them at ~⅓ chance: Go colors cluster spatially, so
#: on a saturated board a lattice several cells off still agrees on the
#: interior of every large group (measured: 0.69 agreement at 5 cells off,
#: 200 stones, 17° camera) — only the group boundaries scramble. 0.8 sits
#: between the measured impostor ceiling and the correct-anchor floor.
POSE_VETO_MIN_STONES = 15
POSE_VETO_MIN_AGREE = 0.8


class MetaState(NamedTuple):
    """Scan carry. All arrays fixed-shape; host code may reset slices."""
    votes: jnp.ndarray        # (g, g, 3) decayed per-label vote mass
    stable: jnp.ndarray       # (g, g) int8 — last committed board reading
    bg: jnp.ndarray           # (S/f, S/f) float32 EMA luma background
    prev: jnp.ndarray         # (S/f, S/f) float32 previous-frame luma
    trust: jnp.ndarray        # (3, 3) float32 region agreement EMA
    frame_count: jnp.ndarray  # () int32


def init_state(gsize: int = guiconf.gsize, zone: int = cvconf.zone_size,
               ) -> MetaState:
    s = gsize * zone // BG_FACTOR
    return MetaState(
        votes=jnp.zeros((gsize, gsize, 3), jnp.float32),
        stable=jnp.zeros((gsize, gsize), jnp.int8),
        bg=jnp.full((s, s), -1.0, jnp.float32),   # -1 → "uninitialized"
        prev=jnp.full((s, s), -1.0, jnp.float32),
        trust=jnp.zeros((3, 3), jnp.float32),
        frame_count=jnp.zeros((), jnp.int32),
    )


def _region_index(gsize: int) -> np.ndarray:
    """(g, g) int: which of the 3×3 sub-boards each intersection belongs to."""
    thirds = np.minimum(np.arange(gsize) * 3 // gsize, 2)
    return (thirds[:, None] * 3 + thirds[None, :]).astype(np.int32)


@functools.partial(jax.jit, static_argnames=("gsize", "zone"))
def read_batch(state: MetaState, frames: jnp.ndarray, corners: jnp.ndarray,
               gsize: int = guiconf.gsize, zone: int = cvconf.zone_size,
               neural_params=None, valid_count=None, lens=None):
    """The meta state machine over a batch of frames.

    frames: (B, H, W, 3) uint8; corners: (4, 2) fixed or (B, 4, 2) per-frame.
    valid_count: optional traced scalar — frames beyond it are repeats of
    the last real one (capture padding for static jit shapes) and must not
    cast votes (a 1-frame transient would otherwise be amplified by the pad
    count, defeating the vote window).
    Returns (state, labels (B, g, g) int8, conf (B, g, g), agitation (B,)).

    Structure: warp + both classifiers are stateless per frame, so they run
    *batched* (vmapped); only the genuinely
    sequential carry (votes/stable/trust/bg — a few (g, g)-sized updates per
    frame) goes through lax.scan. Running the classifiers inside the scan
    serialized the whole pipeline.
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
        return _scan_canonical(state, canon, gsize, zone, neural_params,
                               valid_count)


def _scan_canonical(state: MetaState, canon: jnp.ndarray, gsize: int,
                    zone: int, neural_params=None, valid_count=None):
    """Classifiers + temporal vote scan over precomputed canonical frames
    (B, S, S, 3) float [0,1]. Shared by read_batch (which warps first) and
    track_read_batch (whose canonical comes from the fused tracker).
    Frames at index ≥ valid_count (if given) pass through without touching
    the carry (votes/trust/bg/prev)."""
    with jax.default_matmul_precision("float32"):
        luma_small = jax.vmap(
            lambda c: background.downsample_luma(rgb_to_gray(c), BG_FACTOR))(
                canon)                                     # (B, s, s)

        # One shared zone-statistics pass feeds both classifiers (they need
        # the same zone extraction, luma planes, and corner-median
        # backgrounds).
        def both(c):
            stats = zone_stats(c, gsize, zone)
            return (sf_contours.classify_stats(stats, zone),
                    sf_clustering.classify_stats(stats))

        (lab_cont, conf_cont), (lab_clus, conf_clus) = jax.vmap(both)(canon)

        if neural_params is not None:
            # Third voter (opt-in: only when a trained checkpoint exists).
            # The CNN competes per intersection by confidence like the
            # others; its softmax max is discounted slightly (CNNs are
            # overconfident) so it breaks ties rather than overruling a
            # decisive classical read.
            from camkifu_tpu.models import neural as _neural
            from camkifu_tpu.ops.zones import extract_zones

            b = canon.shape[0]
            patches = jax.vmap(
                lambda c: extract_zones(c, gsize, zone))(canon) \
                .reshape(b * gsize * gsize, zone, zone, 3)
            logits = _neural.PatchNet().apply(neural_params, patches)
            probs = jax.nn.softmax(logits, axis=-1)
            lab_nn = jnp.argmax(probs, -1).astype(jnp.int8) \
                .reshape(b, gsize, gsize)
            conf_nn = (0.85 * jnp.max(probs, -1)).astype(jnp.float32) \
                .reshape(b, gsize, gsize)
        else:
            lab_nn = jnp.zeros_like(lab_cont)
            conf_nn = jnp.full_like(conf_cont, -1.0)

        # Motion gates: prev of frame i is frame i−1 (state carries the
        # batch boundary).
        prev0 = jnp.where(state.prev[0, 0] < 0, luma_small[0], state.prev)
        prevs = jnp.concatenate([prev0[None], luma_small[:-1]], axis=0)
        zone_calm, agitation = jax.vmap(
            lambda a, b: zone_motion_gate(a, b, gsize))(luma_small, prevs)

        region = _region_index(gsize)
        agree = (lab_cont == lab_clus).astype(jnp.float32)   # (B, g, g)
        counts = np.bincount(region.reshape(-1), minlength=9).astype(
            np.float32)
        region_agree = jax.vmap(lambda a: jax.ops.segment_sum(
            a.reshape(-1), region.reshape(-1), num_segments=9) / counts)(
                agree).reshape(-1, 3, 3)

        cfg = cvconf.DEFAULT
        b = canon.shape[0]
        if valid_count is None:
            valid = jnp.ones((b,), bool)
        else:
            valid = jnp.arange(b) < valid_count

        def body(carry, x):
            votes, stable, bg, trust = carry
            (lc, cc, lk, ck, ln, cn, calm, agit, ragree, lsm, v) = x
            calm_scalar = agit <= cfg.agitation_threshold
            new_trust = jnp.where(calm_scalar,
                                  trust * (1 - TRUST_EMA) + ragree * TRUST_EMA,
                                  trust)
            trust_per = new_trust.reshape(-1)[region.reshape(-1)] \
                .reshape(gsize, gsize)
            # Eligible readings compete by confidence: contours always,
            # clustering once its region's trust promotes, the neural net
            # when a checkpoint was given.
            ck_eff = jnp.where(trust_per >= TRUST_PROMOTE, ck, -1.0)
            confs = jnp.stack([cc, ck_eff, cn])            # (3, g, g)
            labs = jnp.stack([lc, lk, ln])
            pick = jnp.argmax(confs, axis=0)
            labels = jnp.take_along_axis(labs, pick[None], axis=0)[0]
            conf = jnp.take_along_axis(confs, pick[None], axis=0)[0]
            new_votes, new_stable, out_conf = vote_update(
                votes, stable, labels, conf, calm, cfg)
            new_bg = background.update_background(
                jnp.where(bg[0, 0] < 0, lsm, bg), lsm, agit,
                cfg.background_ema)
            # Padded frames (capture repeats of the last real one) emit the
            # current stable reading but leave the carry untouched.
            old_conf = jnp.clip(jnp.max(votes, axis=-1) / cfg.vote_window,
                                0.0, 1.0)
            carry_out = (jnp.where(v, new_votes, votes),
                         jnp.where(v, new_stable, stable),
                         jnp.where(v, new_bg, bg),
                         jnp.where(v, new_trust, trust))
            return carry_out, (carry_out[1], jnp.where(v, out_conf, old_conf))

        carry0 = (state.votes, state.stable, state.bg, state.trust)
        (votes, stable, bg, trust), (labels, conf) = jax.lax.scan(
            body, carry0,
            (lab_cont, conf_cont, lab_clus, conf_clus, lab_nn, conf_nn,
             zone_calm, agitation, region_agree, luma_small, valid))
        new_state = MetaState(
            votes=votes, stable=stable, bg=bg, prev=luma_small[-1],
            trust=trust,
            frame_count=state.frame_count + jnp.sum(valid).astype(jnp.int32))
        return new_state, labels, conf, agitation


@functools.partial(jax.jit, static_argnames=("gsize", "zone", "chunk"))
def track_read_batch(state: MetaState, frames: jnp.ndarray,
                     seed_corners: jnp.ndarray,
                     gsize: int = guiconf.gsize,
                     zone: int = cvconf.zone_size,
                     chunk: int = 16, neural_params=None, valid_count=None,
                     lens=None):
    """Config-4 engine: fused per-frame board tracking + rectification +
    classification + vote scan in ONE jit region.

    frames: (B, H, W, 3); seed_corners: (4, 2) from a full detection (the
    host re-detects at bf_period cadence and re-anchors the seed).
    chunk: frames that share one rectification grid. 16 was tuned on the
    first accelerator this ran on; unmeasured on the GPU (ROADMAP C4).
    lens: optional radial distortion model (ops/lens.py, calibrated by
    BoardFinderAuto) — composed into the tracker's sample coordinates.
    Returns (state, labels, conf, agitation, corners (B, 4, 2),
    sharpness (B,), align (B,), new_seed (4, 2)).
    """
    from camkifu_tpu.board.bf_auto import rectify_track_batch

    canon, corners, sharp, align, new_seed = rectify_track_batch(
        frames, seed_corners, gsize=gsize, zone=zone, chunk=chunk, lens=lens)
    new_state, labels, conf, agitation = _scan_canonical(
        state, canon, gsize, zone, neural_params, valid_count)
    return new_state, labels, conf, agitation, corners, sharp, align, new_seed


# -- host-side state surgery (human-correction feedback; SURVEY §3.4) --------

def reset_votes(state: MetaState, positions) -> MetaState:
    """Invalidate votes (and the stable reading) at (row, col) positions so a
    corrected misread does not immediately re-suggest — the reference's
    ``corrected()`` behavior."""
    votes = np.asarray(state.votes).copy()
    stable = np.asarray(state.stable).copy()
    for r, c in positions:
        votes[r, c] = 0.0
        stable[r, c] = 0
    return state._replace(votes=jnp.asarray(votes), stable=jnp.asarray(stable))


def set_stable(state: MetaState, board: np.ndarray) -> MetaState:
    """Force the stable reading (e.g. on --sgf resume: the loaded game's
    board state is ground truth)."""
    return state._replace(stable=jnp.asarray(board.astype(np.int8)),
                          votes=jnp.zeros_like(state.votes))


# ---------------------------------------------------------------------------
# Host finder class (default algorithm; SURVEY §2.1 sf_meta).
# ---------------------------------------------------------------------------

from camkifu_tpu.stone.stonesfinder import StonesFinder as _SF  # noqa: E402


class SfMeta(_SF):
    """The production finder host: carries the device scan state across
    batches; human corrections invalidate votes at the touched positions."""

    label = "meta"

    #: BoardFinderAuto skips its separate tracking pass for this finder:
    #: tracking runs fused with rectification+classification here
    #: (track_read_batch — one gather instead of two per frame).
    fused_tracking = True

    def __init__(self, vmanager):
        super().__init__(vmanager)
        self.state = init_state(gsize=self.gsize)
        # Opt-in neural voter: participates only if the user trained a
        # checkpoint (cktrain); absent checkpoint = classical ensemble only.
        # A checkpoint that cannot be loaded (flax/orbax missing, corrupt
        # files) raises rather than silently dropping the voter.
        from camkifu_tpu.models import neural
        self.neural_params = neural.load_params()
        if self.neural_params is not None:
            self.metadata["neural"] = "on"
        # --sgf resume: the loaded game's board is ground truth (SURVEY §5).
        if self.controller is not None:
            board = self.controller.stones()
            if board.any():
                self.state = set_stable(self.state, board)
                self._resync()

    def _doframe(self, frames, n=None) -> None:
        """Use the fused track+rectify+classify+scan pass when the board
        finder maintains a tracking seed (BoardFinderAuto); otherwise the
        classic path (fixed/manual corners) via the base class."""
        import numpy as _np

        bf = getattr(self.vmanager, "board_finder", None)
        seed = getattr(bf, "track_seed", None)
        if seed is None:
            return super()._doframe(frames, n)
        import jax.numpy as jnp

        (self.state, labels, conf, agitation, corners, sharp, align,
         new_seed) = track_read_batch(
            self.state, jnp.asarray(frames), seed, gsize=self.gsize,
            neural_params=self.neural_params,
            valid_count=self._valid_arg(frames, n),
            lens=getattr(bf, "lens", None))
        bf.report_tracking(_np.asarray(corners), new_seed,
                           float(_np.asarray(sharp).mean()),
                           bf.batch_align(align, sharp))
        if getattr(bf, "suspect_batch", False):
            # Jump trip fired on this batch: the labels were read through
            # discontinuous corners (on_tracking_discontinuity already
            # reset the scan state) — never diff them into moves.
            self.metadata["status"] = "re-anchoring"
            return
        if getattr(bf, "fresh_anchor", False) \
                and self._pose_vetoed(labels, bf):
            return
        self._report(agitation)
        self._consume(labels, n)

    def _pose_vetoed(self, labels, bf) -> bool:
        """Cross-check a freshly anchored pose against the committed game.

        Full detection can be confidently WRONG — measured: stone-saturated
        boards rotated ≥~14° in-plane detect 3–8 cells off at score
        0.27–0.35 (the 1D combs cannot express that basin). A pose that is
        cells off reads the committed stones scrambled, and within a vote
        window the bulk self-correction machinery would rewrite the entire
        kifu onto the impostor lattice. The committed game is the one
        ground truth that survives any camera event: if this batch's
        readings disagree with ≥(1−POSE_VETO_MIN_AGREE) of the committed
        stones, reject the pose (bf.reject_anchor — detection then re-runs
        every batch until a consistent pose appears) and discard the
        poisoned vote state. Below POSE_VETO_MIN_STONES committed stones
        the check is off: sparse boards are the line-dominated regime where
        detection is reliable (±25° envelope), and a handful of points
        cannot distinguish pose error from capture lag or an occluding
        hand.
        """
        import numpy as _np

        committed = self.controller.stones() if self.controller is not None \
            else self.extractor.state()
        nz = committed != 0
        if int(nz.sum()) < POSE_VETO_MIN_STONES:
            return False
        lab = _np.asarray(labels)                       # (B, g, g)
        agree = float((lab[:, nz] == committed[nz]).mean())
        self.metadata["pose_agreement"] = round(agree, 3)
        if agree >= POSE_VETO_MIN_AGREE:
            return False
        bf.reject_anchor()
        # The batch already folded into the scan state before the veto
        # could fire — re-seed perception from the committed game, as with
        # any discontinuity.
        self.state = set_stable(self.state, committed)
        self.metadata["status"] = "re-anchoring"
        return True

    @staticmethod
    def _valid_arg(frames, n):
        """Traced valid-count scalar for padded batches, None when full
        (the common case keeps the mask-free jit specialization; a traced
        scalar avoids recompiling per distinct tail length)."""
        import jax.numpy as jnp

        if n is None or n >= frames.shape[0]:
            return None
        return jnp.int32(n)

    def _find(self, frames, corners):
        import jax.numpy as jnp

        self.state, labels, conf, agitation = read_batch(
            self.state, jnp.asarray(frames),
            jnp.asarray(corners, jnp.float32), gsize=self.gsize,
            neural_params=self.neural_params,
            valid_count=self._valid_arg(frames, self._batch_valid),
            lens=self._bf_lens())
        self._report(agitation)
        return labels, conf

    def _report(self, agitation) -> None:
        import numpy as _np

        self.metadata["agitation"] = round(
            float(_np.asarray(agitation).mean()), 4)
        trust = _np.asarray(self.state.trust)
        self.metadata["regions_promoted"] = int((trust >= TRUST_PROMOTE).sum())

    def _invalidate(self, positions) -> None:
        self.state = reset_votes(self.state, positions)

    def on_tracking_discontinuity(self) -> None:
        """Camera bump: the batch just folded into the scan state was read
        through wrong corners (on the fused path the evidence lands before
        the trip can fire). Re-seed perception from the game model — the
        committed kifu is the surviving ground truth — and zero the votes,
        discarding the poisoned accumulation."""
        board = self.controller.stones() if self.controller is not None \
            else self.extractor.state()
        self.state = set_stable(self.state, board)
