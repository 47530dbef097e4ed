"""Image/geometry helpers shared by the finder families.

Parity: ``camkifu/core/imgutil.py`` (SURVEY §2.1) — ``Segment`` line-segment
math (norm, angle, intersection — load-bearing for board detection in the
reference), drawing overlays (``draw_lines``/``draw_circles``/``draw_str``,
host-side cv2, debug path only), the ``around`` neighborhood iterator, the
tl/tr/br/bl corner ordering, and a cyclic buffer utility.

The JAX pipeline itself does not draw — these helpers serve the GUI/debug
path and host-side geometry, exactly the split the reference had.
"""

from __future__ import annotations

import math

import numpy as np

from camkifu_tpu.board.boardfinder import order_corners  # noqa: F401  (re-export)


class Segment:
    """A 2D line segment between (x1, y1) and (x2, y2)."""

    def __init__(self, p1, p2):
        self.p1 = (float(p1[0]), float(p1[1]))
        self.p2 = (float(p2[0]), float(p2[1]))

    @property
    def norm(self) -> float:
        return math.hypot(self.p2[0] - self.p1[0], self.p2[1] - self.p1[1])

    @property
    def angle(self) -> float:
        """Orientation in [0, π) (undirected)."""
        a = math.atan2(self.p2[1] - self.p1[1], self.p2[0] - self.p1[0])
        return a % math.pi

    def intersection(self, other: "Segment"):
        """Intersection point of the *lines* through the two segments, or
        None if parallel. (The reference intersects Hough segments the same
        way to get corner candidates.)"""
        x1, y1 = self.p1
        x2, y2 = self.p2
        x3, y3 = other.p1
        x4, y4 = other.p2
        den = (x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4)
        if abs(den) < 1e-12:
            return None
        a = x1 * y2 - y1 * x2
        b = x3 * y4 - y3 * x4
        px = (a * (x3 - x4) - (x1 - x2) * b) / den
        py = (a * (y3 - y4) - (y1 - y2) * b) / den
        return (px, py)

    def distance_to(self, point) -> float:
        """Perpendicular distance of a point to the segment's line."""
        x1, y1 = self.p1
        x2, y2 = self.p2
        n = self.norm
        if n == 0:
            return math.hypot(point[0] - x1, point[1] - y1)
        return abs((x2 - x1) * (y1 - point[1])
                   - (x1 - point[0]) * (y2 - y1)) / n

    def __repr__(self) -> str:
        return f"Segment({self.p1} -> {self.p2})"


def around(row: int, col: int, radius: int = 1, gsize: int = 19,
           include_center: bool = False):
    """Yield in-bounds (r, c) neighbors within a square radius — the
    reference's neighborhood iterator."""
    for dr in range(-radius, radius + 1):
        for dc in range(-radius, radius + 1):
            if not include_center and dr == 0 and dc == 0:
                continue
            r, c = row + dr, col + dc
            if 0 <= r < gsize and 0 <= c < gsize:
                yield r, c


class CyclicBuffer:
    """Fixed-size rolling buffer of ndarray slots (the host-side analogue of
    the reference's per-intersection vote buffer; the device path keeps its
    votes in the SfMeta scan state instead)."""

    def __init__(self, shape, length: int, dtype=np.float32):
        self.buffer = np.zeros((length,) + tuple(shape), dtype)
        self.length = length
        self.index = 0
        self.filled = 0

    def append(self, value) -> None:
        self.buffer[self.index % self.length] = value
        self.index += 1
        self.filled = min(self.filled + 1, self.length)

    def view(self) -> np.ndarray:
        """Valid slots, oldest first."""
        if self.filled < self.length:
            return self.buffer[:self.filled]
        i = self.index % self.length
        return np.concatenate([self.buffer[i:], self.buffer[:i]])

    def __len__(self) -> int:
        return self.filled


# -- host-side drawing (debug overlays; cv2 only here, never on device) -----

def draw_lines(img: np.ndarray, segments, color=(255, 0, 0)) -> np.ndarray:
    import cv2

    for seg in segments:
        cv2.line(img, (int(seg.p1[0]), int(seg.p1[1])),
                 (int(seg.p2[0]), int(seg.p2[1])), color, 1, cv2.LINE_AA)
    return img


def draw_circles(img: np.ndarray, centers, radius: int = 5,
                 color=(0, 255, 0)) -> np.ndarray:
    import cv2

    for x, y in centers:
        cv2.circle(img, (int(x), int(y)), radius, color, 1, cv2.LINE_AA)
    return img


def draw_str(img: np.ndarray, text: str, origin=(10, 20),
             color=(255, 255, 255)) -> np.ndarray:
    import cv2

    cv2.putText(img, text, origin, cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0),
                3, cv2.LINE_AA)
    cv2.putText(img, text, origin, cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1,
                cv2.LINE_AA)
    return img


def draw_metadata(img: np.ndarray, metadata: dict) -> np.ndarray:
    """Overlay a VidProcessor's metadata dict (fps, frame nr, algo messages)
    on a frame — the reference's per-window debug overlay (SURVEY §5)."""
    y = 20
    for key, value in sorted(metadata.items()):
        draw_str(img, f"{key}: {value}", origin=(10, y))
        y += 18
    return img
