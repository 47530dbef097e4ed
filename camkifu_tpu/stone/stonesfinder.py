"""StonesFinder ABC — the contract all stone-detection algorithms implement.

Parity: ``camkifu/stone/stonesfinder.py`` (SURVEY §2.1) — consumes canonical
frames (warped via the board finder's homography), owns grid geometry
(``PosGrid``), synchronizes with the game model, and emits moves through the
controller: ``suggest(color, r, c)`` → ``controller.pipe("append", …)``;
receives human fixes through ``corrected()``.

Device-first: subclasses implement ``_find(frames, corners) → (labels, conf)``
as a batched device computation; the base class turns per-frame readings into
moves (core.gamesync.MoveExtractor) and handles model synchronization.
"""

from __future__ import annotations

import numpy as np

from camkifu_tpu.config import cvconf, guiconf
from camkifu_tpu.core.gamesync import MoveExtractor
from camkifu_tpu.core.video import VidProcessor
from camkifu_tpu.gamemodel.move import INT_TO_COLOR, Move


class PosGrid:
    """Intersection pixel centers in canonical coordinates, with drift
    learning (SURVEY §2.1: ``learn()`` nudges positions toward observed stone
    centers; ``closest()`` maps a pixel to its intersection)."""

    def __init__(self, gsize: int = guiconf.gsize,
                 zone: int = cvconf.zone_size):
        self.gsize = gsize
        self.zone = zone
        base = (np.arange(gsize, dtype=np.float32) + 0.5) * zone - 0.5
        self.centers = np.stack(
            np.meshgrid(base, base, indexing="ij"), axis=-1)  # (g,g,2) y,x
        self.offsets = np.zeros_like(self.centers)

    def pos(self, r: int, c: int) -> tuple[float, float]:
        y, x = self.centers[r, c] + self.offsets[r, c]
        return float(y), float(x)

    def learn(self, r: int, c: int, observed_yx, rate: float = 0.2) -> None:
        """Drift intersection (r, c) toward an observed stone center."""
        target = np.asarray(observed_yx, np.float32) - self.centers[r, c]
        limit = self.zone * 0.4
        target = np.clip(target, -limit, limit)
        self.offsets[r, c] = (1 - rate) * self.offsets[r, c] + rate * target

    def closest(self, y: float, x: float) -> tuple[int, int]:
        pts = self.centers + self.offsets
        d = (pts[..., 0] - y) ** 2 + (pts[..., 1] - x) ** 2
        idx = int(np.argmin(d))
        return idx // self.gsize, idx % self.gsize


#: Consecutive stabilized frames an intersection must contradict the game
#: state before a bulk correction fires (the reference's periodic re-scan →
#: ``pipe("bulk", …)`` self-correction; SURVEY §3.3).
BULK_CORRECT_AFTER = 40


class StonesFinder(VidProcessor):
    label = "sf-base"

    def __init__(self, vmanager):
        super().__init__(vmanager)
        self.controller = getattr(vmanager, "controller", None)
        self.gsize = self.controller.kifu.gsize \
            if self.controller is not None else guiconf.gsize
        self.grid = PosGrid(self.gsize)
        self.extractor = MoveExtractor(gsize=self.gsize,
                                       on_move=self._emit)
        self._contradict = np.zeros((self.gsize, self.gsize), np.int32)
        self._batch_valid: int | None = None

    # -- model synchronization ---------------------------------------------

    def get_stones(self) -> np.ndarray:
        """Snapshot of the model board (under the rules lock) — what readings
        are diffed against (SURVEY §3.3)."""
        if self.controller is not None:
            return self.controller.stones()
        return self.extractor.state()

    def _resync(self) -> None:
        """Adopt the controller's board as the extractor's ground state
        (after human edits / navigation)."""
        if self.controller is None:
            return
        labels = self.controller.stones()
        grid = np.full((self.gsize, self.gsize), "E", dtype="<U1")
        grid[labels == 1] = "B"
        grid[labels == 2] = "W"
        self.extractor.rule.stones = grid
        self.extractor.rule.discard()
        if not self.extractor.moves:
            self.extractor.set_next_color(self.controller.next_color())

    # -- the vision→model channel -----------------------------------------

    def _emit(self, move: Move) -> None:
        if self.controller is not None:
            self.suggest(move.color, move.row, move.col)

    def suggest(self, color: str, r: int, c: int) -> None:
        move = Move("np", (color, r, c), gsize=self.gsize)
        self.controller.pipe("append", move)
        self.metadata["last_suggest"] = repr(move)

    # -- frame processing ---------------------------------------------------

    def _doframe(self, frames, n: int | None = None) -> None:
        corners = self._corners()
        if corners is None:
            self.metadata["status"] = "waiting for board"
            return
        # Finders with temporal state read this to mask padded tail frames
        # out of their vote updates (capture.pad_batch).
        self._batch_valid = n
        labels, conf = self._find(frames, corners)
        self._consume(labels, n)

    def _consume(self, labels, n: int | None) -> None:
        """Diff per-frame readings into moves (first n frames are real)."""
        labels = np.asarray(labels)
        n = labels.shape[0] if n is None else min(n, labels.shape[0])
        for i in range(n):
            self.extractor.advance(labels[i])
            self._track_contradictions(labels[i])

    #: Whether _find accepts per-frame (B, 4, 2) corners. All bundled
    #: finders do (their warps route through warp_batch_chunked when
    #: corners.ndim == 3); a custom plugin may opt out.
    accepts_corner_batch = True

    def _corners(self):
        bf = getattr(self.vmanager, "board_finder", None)
        if bf is None or not bf.ready():
            return None
        if getattr(bf, "suspect_batch", False):
            # Tracking hit a discontinuity (camera bump) this batch: the
            # published corners are stale and the frames' true pose is
            # unknown until re-detection — reading them would feed the
            # vote machine confidently wrong evidence. Sit the batch out.
            return None
        cb = getattr(bf, "corners_batch", None)
        if self.accepts_corner_batch and cb is not None:
            return cb                       # per-frame corners (tracking)
        return bf.corners_array

    def _bf_lens(self):
        """The board finder's calibrated radial lens model (ops/lens.py),
        or None. Finders compose it into their warp sample coordinates so
        interior stones land in their zones on distorted footage (corners
        alone only pin the four board corners — at webcam-typical
        k1 = 0.08 an uncorrected interior is ~1 cell off mid-edge)."""
        return getattr(getattr(self.vmanager, "board_finder", None),
                       "lens", None)

    def _find(self, frames, corners):
        """Batched device classification → (labels (B, g, g), conf)."""
        raise NotImplementedError

    def on_tracking_discontinuity(self) -> None:
        """The board finder detected a camera bump (tracking jump trip):
        any temporal evidence accumulated this batch was read through
        wrong corners. Stateless finders have nothing to do; finders with
        vote state override this to discard it (the committed game model
        is the surviving ground truth)."""

    # -- self-correction: persistent contradictions → bulk fixes ------------

    def _track_contradictions(self, reading: np.ndarray) -> None:
        """The reference periodically re-scans the whole board and pushes
        bulk corrections for mistakes it committed earlier (SURVEY §3.3).
        Here: an intersection whose stabilized reading contradicts the game
        state for BULK_CORRECT_AFTER consecutive frames (the move extractor
        having found no legal move explaining it) is force-corrected through
        the controller's bulk channel."""
        state = self.extractor.state()
        diff = reading != state
        # Captured stones awaiting physical removal are EXPLAINED
        # contradictions: never count them toward a bulk fix (players
        # leave captures on the board well past BULK_CORRECT_AFTER; a
        # "fix" would resurrect the dead group in the kifu).
        diff &= ~self.extractor.stale_capture_mask(reading)
        self._contradict = np.where(diff, self._contradict + 1, 0)
        hits = np.argwhere(self._contradict >= BULK_CORRECT_AFTER)
        if hits.size == 0:
            return
        fixes = []
        for r, c in hits:
            r, c = int(r), int(c)
            old, new = int(state[r, c]), int(reading[r, c])
            err = Move("np", (INT_TO_COLOR[old], r, c), gsize=self.gsize) \
                if old else None
            exp = Move("np", (INT_TO_COLOR[new], r, c), gsize=self.gsize) \
                if new else None
            fixes.append((err, exp))
            self.extractor.apply_correction(err, exp)
            self._contradict[r, c] = 0
        if self.controller is not None:
            self.controller.pipe("bulk", fixes)
        self.metadata["bulk_fixes"] = len(fixes)

    # -- human-correction feedback (SURVEY §3.4) ----------------------------

    def corrected(self, err: Move | None, exp: Move | None) -> None:
        """A human fixed the game: re-sync and forget contrary evidence so
        the same misread does not immediately re-suggest."""
        self.extractor.apply_correction(err, exp)
        self._resync()
        self._invalidate([p for p in
                          [(err.row, err.col) if err else None,
                           (exp.row, exp.col) if exp else None] if p])

    def _invalidate(self, positions) -> None:
        """Subclasses with temporal state drop votes at these positions."""
