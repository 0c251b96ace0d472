"""Heartbeat thread: periodic progress records of a running build (the
port's copy of ``sheep_tpu/obs/heartbeat.py``).

A long build is a black box between launch and its scores unless
something writes while it runs; the heartbeat tells a dead run from a slow
one (the last beat's age against the cadence). Each record carries the
instrumented loops' progress fields (phase, chunks done and total, edges
done), edges/s and an ETA, the counter registry, and on a CUDA device the
allocator's counters (``utils/metrics.device_memory_stats``):

    {"event": "heartbeat", "ts": ..., "seq": 3, "phase": "build",
     "chunks_done": 12, "chunks_total": 64, "edges_done": 100663296,
     "edges_per_sec": 3.1e6, "eta_s": 140.9,
     "counters": {"host_syncs": 13, "device_rounds": 29, ...},
     "memory": {"peak_bytes_in_use": ..., ...}}

``stop()`` always writes one last record (``"final": true``), so a run
faster than the cadence still leaves one heartbeat.
"""

from __future__ import annotations

import threading
import time

from sheep_tpu_torch.utils.metrics import device_memory_stats


class Heartbeat:
    """Daemon thread writing ``heartbeat`` records through ``tracer``
    every ``interval_s`` seconds until :meth:`stop`. ``device``, the run's
    device, adds its allocator's counters as ``memory`` on CUDA; on the
    CPU (or None) there is none and ``torch.cuda`` is not touched.
    ``service``, a callable returning a dict, adds its fields to each beat
    (the daemon's queue depth and active jobs)."""

    def __init__(self, tracer, interval_s: float, device=None,
                 service=None):
        self.tracer = tracer
        self.interval = max(0.05, float(interval_s))
        self._device = device
        self._service = service
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="sheep-heartbeat", daemon=True)
        self._seq = 0
        self._last = None  # (perf_counter, edges_done) of the last beat

    def start(self) -> "Heartbeat":
        self._last = (time.perf_counter(), 0)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the thread, then write the final record (after the join,
        so it cannot race a periodic one)."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2 * self.interval + 5)
        try:
            self._beat(final=True)
        except Exception:  # noqa: BLE001, teardown must not mask the run's
            pass           # own outcome

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._beat()
            except Exception:  # noqa: BLE001
                # one failed write (a disk blip) must not silence the rest
                # of the run: silence would read as a dead run
                continue

    def _beat(self, final: bool = False) -> None:
        tr = self.tracer
        prog = dict(tr.progress)  # a racy copy by design: scalar fields
        now = time.perf_counter()
        rec = {"seq": self._seq}
        rec.update(prog)
        edges = prog.get("edges_done")
        if isinstance(edges, (int, float)) and self._last is not None:
            t0, e0 = self._last
            # a phase change resets edges_done: skip that beat's rate
            if now > t0 and edges >= e0:
                rate = (edges - e0) / (now - t0)
                if rate > 0:
                    rec["edges_per_sec"] = round(rate, 1)
                    total = prog.get("edges_total")
                    if isinstance(total, (int, float)) and total >= edges:
                        rec["eta_s"] = round((total - edges) / rate, 1)
            self._last = (now, edges)
        if self._service is not None:
            try:
                svc = self._service()
            except Exception:  # noqa: BLE001
                svc = None  # a wedged sampler must not kill the beat
            if svc:
                rec.update(svc)
        counters = tr.counters.snapshot()
        if counters:
            rec["counters"] = counters
        if self._device is not None:
            mem = device_memory_stats(self._device)
            if mem:
                rec["memory"] = mem
        if final:
            rec["final"] = True
        tr.emit("heartbeat", **rec)
        self._seq += 1
