"""Observability: structured per-batch stats + jax.profiler hooks.

Parity+upgrade (SURVEY §5): the reference only overlays per-thread fps on
the video window; here every batch can emit a structured record (fps,
agitation, votes, detection confidence) and a jax.profiler trace can wrap
any span for device timeline inspection.
"""

from __future__ import annotations

import contextlib
import json
import time


class BatchStats:
    """Rolling per-batch statistics with an optional JSONL sink."""

    def __init__(self, sink_path: str | None = None, window_s: float = 5.0):
        self.sink_path = sink_path
        self.window_s = window_s
        self._events: list[tuple[float, int]] = []
        self._sink = None
        if sink_path:
            self._sink = open(sink_path, "a", encoding="utf-8")

    def record(self, frames: int, **fields) -> dict:
        now = time.perf_counter()
        self._events.append((now, frames))
        cutoff = now - self.window_s
        self._events = [(t, n) for t, n in self._events if t >= cutoff]
        rec = {"t": round(now, 4), "frames": frames,
               "fps": round(self.fps(), 2), **fields}
        if self._sink:
            self._sink.write(json.dumps(rec, default=float) + "\n")
            self._sink.flush()
        return rec

    def fps(self) -> float:
        if len(self._events) < 2:
            return 0.0
        span = self._events[-1][0] - self._events[0][0]
        n = sum(k for _, k in self._events[1:])
        return n / span if span > 0 else 0.0

    def close(self) -> None:
        if self._sink:
            self._sink.close()
            self._sink = None


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a jax.profiler trace (view with TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named span inside a profiler trace."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield
