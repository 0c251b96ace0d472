"""Staged ingest for host-format streams (the port's own copy of
``prefetch`` and ``H2DRing``, ``sheep_tpu/utils/prefetch.py:227`` and
``:258``).

:func:`prefetch` reads, parses and pads upcoming chunks on a worker
thread, keeping up to ``depth`` of them ready (file reads and numpy
release the GIL, so the overlap is real). :class:`H2DRing` keeps up to
``depth`` blocks' host-to-device copies in flight ahead of the consumer:
each block is copied from pinned host memory on a side stream, with an
event that the consumer's stream waits on before the block is used, so
neither the read nor the copy sits in the dispatch chain. Order is kept
exactly and every block equals what a plain copy gives, so the fixpoint
sees the same segments at every depth. On the CPU the ring hands the host
blocks over as they are.

Both close deterministically (``close()``, or ``with``): the worker is
stopped and joined, staged blocks are dropped, and iterating after close
stops.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque

import numpy as np
import torch

_END = object()

#: :meth:`Prefetcher.poll_nowait` when nothing is queued yet
NOT_READY = object()


class _Raised:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetcher:
    """A worker thread iterating ``iterable``, up to ``depth`` items ahead
    of the consumer; its exceptions reach the consumer at ``next()``."""

    def __init__(self, iterable, depth: int = 2):
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._closed = self._done = False
        self._thread = threading.Thread(target=self._worker,
                                        args=(iterable,), daemon=True,
                                        name="sheep-torch-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, iterable) -> None:
        try:
            for item in iterable:
                if not self._put(item) or self._stop.is_set():
                    return
        except BaseException as e:  # delivered to the consumer
            self._put(_Raised(e))
            return
        self._put(_END)

    def _take(self, item):
        if item is _END:
            self._done = True
            self._stop.set()
            raise StopIteration
        if isinstance(item, _Raised):
            self._done = True
            self._stop.set()
            raise item.exc
        return item

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed or self._done:
            raise StopIteration
        while True:
            try:
                return self._take(self._q.get(timeout=0.5))
            except queue.Empty:
                if not self._thread.is_alive():
                    try:  # the worker's last put may have just landed
                        return self._take(self._q.get_nowait())
                    except queue.Empty:
                        self._done = True
                        raise RuntimeError(
                            "prefetch worker died without delivering a "
                            "result or its end")

    def poll_nowait(self):
        """The next item if one is queued, else :data:`NOT_READY`."""
        if self._closed or self._done:
            raise StopIteration
        try:
            item = self._q.get_nowait()
        except queue.Empty:
            return NOT_READY
        return self._take(item)

    def close(self, timeout: float = 5.0) -> None:
        """Stop and join the worker; idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._drain()  # wakes a worker blocked on a full queue
        self._thread.join(timeout=timeout)
        self._drain()  # its last put, if any

    def _drain(self) -> None:
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def prefetch(iterable, depth: int = 2) -> Prefetcher:
    """Iterate ``iterable`` on a worker thread, ``depth`` items ahead."""
    return Prefetcher(iterable, depth=depth)


class H2DRing:
    """Up to ``depth`` host blocks (numpy arrays) copied ahead of the
    consumer to ``device``, in order.

    On CUDA each block is pinned, copied with ``non_blocking`` on a side
    stream, and an event recorded after the copy; when the consumer takes
    the block, its current stream waits on that event (a device-side
    wait, not a host one) and the block is recorded as used on that
    stream. Refills poll a :class:`Prefetcher` source without blocking
    while the ring still holds blocks. Counters in ``stats``, unrounded:
    ``h2d_staged_ms`` (wall issuing copies ahead of need, the first fill
    included), ``h2d_blocked_ms`` (wall the consumer waited for a block
    the ring did not have), ``h2d_staged_bytes``, ``h2d_ring_depth``."""

    def __init__(self, source, device, depth: int = 2, stats=None):
        if depth < 1:
            raise ValueError("h2d ring depth must be >= 1")
        self.depth = int(depth)
        self.device = torch.device(device)
        self._src = source if hasattr(source, "__next__") else iter(source)
        self._poll = getattr(self._src, "poll_nowait", None)
        self._ring: deque = deque()
        self._side = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._stats = stats if stats is not None else {}
        for key in ("h2d_staged_ms", "h2d_blocked_ms"):
            self._stats.setdefault(key, 0.0)
        self._stats.setdefault("h2d_staged_bytes", 0)
        self._stats["h2d_ring_depth"] = self.depth
        self._exhausted = self._closed = self._started = False

    def _issue(self, block: np.ndarray) -> None:
        self._stats["h2d_staged_bytes"] += int(block.nbytes)
        host = torch.from_numpy(np.ascontiguousarray(block))
        if self._side is None:
            self._ring.append((host, None))
            return
        host = host.pin_memory()
        with torch.cuda.stream(self._side):
            dev = host.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._side)
        self._ring.append((dev, done))

    def _fill(self, want: int, may_block: bool) -> None:
        while len(self._ring) < want and not self._exhausted:
            try:
                if self._poll is not None and not may_block:
                    block = self._poll()
                    if block is NOT_READY:
                        return
                else:
                    block = next(self._src)
            except StopIteration:
                self._exhausted = True
                return
            self._issue(block)
            may_block = False  # at most one blocking pull per fill

    def __iter__(self):
        return self

    def __next__(self) -> torch.Tensor:
        if self._closed:
            raise StopIteration
        if not self._ring and not self._exhausted:
            t0 = time.perf_counter()
            self._fill(1, may_block=True)
            key = "h2d_blocked_ms" if self._started else "h2d_staged_ms"
            self._stats[key] += (time.perf_counter() - t0) * 1e3
        if not self._ring:
            raise StopIteration
        self._started = True
        out, done = self._ring.popleft()
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            out.record_stream(stream)
        t0 = time.perf_counter()
        self._fill(self.depth, may_block=self._poll is None)
        self._stats["h2d_staged_ms"] += (time.perf_counter() - t0) * 1e3
        return out

    def close(self) -> None:
        """Drop the staged blocks and close a closeable source."""
        if self._closed:
            return
        self._closed = True
        self._ring.clear()
        close = getattr(self._src, "close", None)
        if close is not None:
            close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
