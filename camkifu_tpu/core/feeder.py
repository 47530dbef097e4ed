"""DeviceFeeder — the double-buffered host→device frame feeder.

Parity/upgrade: the reference's VManager threads share one synchronized
CaptureReader (SURVEY §2.4 row "frame fan-out"); the device-native equivalent
named there is this feeder: a decode thread stays ahead of the device by one
batch, starting the (asynchronous) host→device transfer of batch k+1 while the
pipeline computes on batch k, so transfer latency hides behind compute.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class DeviceFeeder:
    """Iterates (device_frames, count, done) batches, decoded + transferred
    one batch ahead of the consumer."""

    def __init__(self, capture, batch: int, depth: int = 2):
        self.capture = capture
        self.batch = batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="device-feeder")
        self._thread.start()

    def _pump(self) -> None:
        import jax
        import jax.numpy as jnp

        from camkifu_tpu.core.capture import pad_batch

        err = None
        try:
            done = False
            while not done and not self._stop.is_set():
                frames, done = self.capture.read_batch(self.batch)
                # Arrival timestamps (live captures only) must be snapshotted
                # HERE, before the next read_batch overwrites them — the
                # feeder runs a batch ahead of the consumer.
                arrivals = getattr(self.capture, "last_batch_arrivals", None)
                frames, n = pad_batch(frames, self.batch)
                if n:
                    # device_put returns immediately; the DMA overlaps with
                    # the consumer's compute on the previous batch. The last
                    # host frame rides along for the GUI preview window.
                    # Frames are padded to the static batch size so every
                    # dispatch hits the same jit specialization (live rings
                    # vary in occupancy).
                    dev = jax.device_put(jnp.asarray(frames))
                    self._q.put((dev, n, done, frames[n - 1], arrivals))
                elif done:
                    break
        except BaseException as exc:       # noqa: BLE001 — relayed, not eaten
            err = exc
        finally:
            # A sentinel must be enqueued even if read_batch/device_put
            # raises, or the consumer blocks on the queue forever. The
            # failure itself rides the sentinel: plain None would make a
            # decode error (corrupt file, camera unplug) indistinguishable
            # from clean end-of-video, silently truncating the game.
            self._q.put(err)     # None = end-of-stream; exception = failure

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise RuntimeError("video capture failed "
                                   "mid-stream") from item
            yield item

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


def prefetch_to_device(batches, depth: int = 2):
    """Wrap an iterator of (numpy_frames, count) batches: device_put runs one
    batch ahead on a worker thread so the transfer overlaps the consumer's
    compute. Yields (device_frames, count)."""
    import jax
    import jax.numpy as jnp

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    err: list[BaseException] = []   # pump → consumer failure relay

    def pump():
        try:
            for frames, n in batches:
                if stop.is_set():
                    return
                item = (jax.device_put(jnp.asarray(frames)), n)
                # Bounded put re-checking stop: an unbounded q.put would
                # block forever when the consumer exits early (its finally
                # can't drain a thread already parked in put), leaking the
                # thread + two device-resident batches per abandoned run.
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as exc:   # noqa: BLE001 — relayed, not eaten
            # A decode/device_put failure must not masquerade as clean
            # end-of-stream: the consumer would score a silently truncated
            # game instead of surfacing the error (same contract as
            # DeviceFeeder._pump). Recorded before the sentinel lands.
            err.append(exc)
        finally:
            # Sentinel must always land — but NEVER at the cost of queued
            # real batches while the consumer is still draining (evicting
            # one would silently truncate the video's last `depth` batches).
            # Block politely until there is room; only once the consumer is
            # known gone (stop set) may pending items be evicted.
            while not stop.is_set():
                try:
                    q.put(None, timeout=0.1)
                    return
                except queue.Full:
                    continue
            while True:
                try:
                    q.put_nowait(None)
                    break
                except queue.Full:
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        pass

    t = threading.Thread(target=pump, daemon=True, name="prefetch-to-device")
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                if err:
                    raise RuntimeError(
                        "frame prefetch failed mid-stream") from err[0]
                return
            yield item
    finally:
        stop.set()
