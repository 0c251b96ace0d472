"""Structured JSON-lines metrics (the port's copy of
``sheep_tpu/utils/metrics.py``).

One JSON object a line, appended to a file or any writable handle: the
run's throughput, each phase's seconds, the partition's scores, the part
loads and the card's allocator high-water mark.

    mw = MetricsWriter(path)
    mw.emit("phase", phase="build", seconds=2.3, edges_per_sec=1.2e8)
    mw.close()
"""

from __future__ import annotations

import json
import threading
import time
from typing import IO, Optional, Union

import numpy as np
import torch


class MetricsWriter:
    """Append-only JSONL sink; every record gets ``event`` and ``ts``.

    ``emit`` is serialized by a lock: the heartbeat thread and the main
    thread share one writer, and an interleaved line would corrupt the
    trace for every reader."""

    def __init__(self, dest: Union[str, IO]):
        if isinstance(dest, str):
            self._fh: IO = open(dest, "a")
            self._owns = True
        else:
            self._fh = dest
            self._owns = False
        self._lock = threading.Lock()

    def emit(self, event: str, **fields) -> None:
        rec = {"event": event, "ts": round(time.time(), 3)}
        rec.update(fields)
        line = json.dumps(rec, default=_jsonable) + "\n"
        with self._lock:
            self._fh.write(line)
            self._fh.flush()

    def close(self) -> None:
        # under the lock: a heartbeat racing the owner's teardown must not
        # interleave with the close
        with self._lock:
            if self._owns:
                self._fh.close()

    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def _jsonable(x):
    # a tensor on the card is refused, not pulled: the pull would be a
    # hidden host sync inside whatever instrumentation point emitted it
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise TypeError(f"not JSON serializable: a {x.device.type} "
                            f"tensor (pull it to the host first)")
        return x.tolist()
    # np.bool_ first: it is not an np.integer, and bool() is the only
    # faithful JSON mapping
    if isinstance(x, np.bool_):
        return bool(x)
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        # the other numpy scalars (np.str_, np.bytes_, np.datetime64):
        # their Python value, or its text where that is not JSON either
        v = x.item()
        if isinstance(v, bytes):
            return v.decode("utf-8", "replace")
        try:
            json.dumps(v)
            return v
        except TypeError:
            return str(v)
    raise TypeError(f"not JSON serializable: {type(x)}")


def device_memory_stats(device) -> Optional[dict]:
    """The caching allocator's counters of ``device`` under the reference's
    names: ``bytes_in_use`` and ``peak_bytes_in_use`` (allocated),
    ``bytes_reserved`` and ``peak_bytes_reserved``, ``bytes_limit`` (the
    card's memory). A host query of the allocator's own books: it never
    waits for the device. None for a CPU device, where ``torch.cuda`` is
    not touched."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    out = {"bytes_in_use": "allocated_bytes.all.current",
           "peak_bytes_in_use": "allocated_bytes.all.peak",
           "bytes_reserved": "reserved_bytes.all.current",
           "peak_bytes_reserved": "reserved_bytes.all.peak"}
    out = {k: int(stats.get(v, 0)) for k, v in out.items()}
    out["bytes_limit"] = int(
        torch.cuda.get_device_properties(device).total_memory)
    return out


def emit_run_metrics(mw, res, n_vertices: int, wall_seconds: float,
                     graph: Optional[str] = None, device=None) -> None:
    """The record set of one partition run: throughput, each phase's
    seconds, the scores, the diagnostics, the part loads and, on a CUDA
    ``device``, the allocator's counters. ``mw`` is a
    :class:`MetricsWriter` or anything with its ``emit`` (a tracer)."""
    m = res.total_edges
    mw.emit("run", graph=graph, backend=res.backend, k=res.k,
            n_vertices=int(n_vertices), total_edges=int(m),
            wall_seconds=round(wall_seconds, 4),
            edges_per_sec=round(m / wall_seconds, 1)
            if wall_seconds > 0 else None)
    for phase, secs in res.phase_times.items():
        mw.emit("phase", phase=phase, seconds=round(secs, 6),
                edges_per_sec=round(m / secs, 1) if secs > 0 else None)
    mw.emit("scores", edge_cut=int(res.edge_cut),
            cut_ratio=float(res.cut_ratio), balance=float(res.balance),
            comm_volume=None if res.comm_volume is None
            else int(res.comm_volume))
    if res.diagnostics:
        mw.emit("diagnostics", **res.diagnostics)
    loads = np.bincount(res.assignment, minlength=res.k)
    mw.emit("part_loads", loads=loads, max=int(loads.max()),
            min=int(loads.min()))
    mem = device_memory_stats(device) if device is not None else None
    if mem is not None:
        mw.emit("device_memory", **mem)
