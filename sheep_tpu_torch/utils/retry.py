"""Fault classes and the bounded retry policy (the port's copy of
``sheep_tpu/utils/retry.py``).

Every error a build sees is classified into one of four classes, and a
:class:`RetryPolicy` decides, per class with bounded attempts and
exponential backoff, whether the driver may try again:

    TRANSIENT    flaky I/O, link blips: retry in place.
    RESOURCE     out-of-memory and other allocation failures: retry after
                 the caller sheds memory (spill the resident chunks, then
                 halve the dispatch batch, depth or ring by
                 ``utils/membudget.degraded_dispatch``).
    DEVICE_LOSS  the device went away: the caller saves its snapshot,
                 reinitializes what it can (:func:`reinit_devices`) and
                 resumes from the last confirmed state.
    FATAL        everything else, bugs, bad input and the kill
                 injections. Never retried.

Classification reads an explicit ``fault_class`` attribute (the injected
faults of ``utils/fault.py``), then the exception's type, then its text
against the JAX package's patterns, unchanged: PyTorch's
``torch.OutOfMemoryError`` ("CUDA out of memory ...") matches "out of
memory" and is a resource fault; an illegal address or a device-side
assert matches nothing and is fatal, as it is: the CUDA context cannot be
revived in process, and the checkpoint is the way back.

Knobs (read when a policy is built), as in the JAX package:

    SHEEP_RETRY_MAX      attempts a fault class (default 3; 0 turns the
                         in-process retry off)
    SHEEP_RETRY_BASE_S   first backoff in seconds (default 0.05)
"""

from __future__ import annotations

import os
import random
import sys
import time
from typing import Optional

from sheep_tpu_torch import obs

TRANSIENT = "transient"
RESOURCE = "resource"
DEVICE_LOSS = "device_loss"
FATAL = "fatal"

# matched case-insensitively against "TypeName: message"
_RESOURCE_PATTERNS = (
    "resource_exhausted",
    "out of memory",
    "allocation failure",
    "failed to allocate",
    "oom",
)
_DEVICE_LOSS_PATTERNS = (
    "device_lost",
    "device lost",
    "device or resource busy",
    "failed_precondition: device",
    "tpu worker",
    "device is in an invalid state",
    "internal: failed to connect",
)
_TRANSIENT_PATTERNS = (
    "unavailable",
    "deadline_exceeded",
    "connection reset",
    "connection refused",
    "temporarily unavailable",
    "broken pipe",
    "try again",
)


def classify(exc: BaseException) -> str:
    """Fault class of an exception: an explicit ``fault_class`` wins, then
    ``MemoryError``, then the message patterns (resource and device loss
    before transient), then ``OSError`` as transient; else fatal."""
    cls = getattr(exc, "fault_class", None)
    if cls in (TRANSIENT, RESOURCE, DEVICE_LOSS, FATAL):
        return cls
    if isinstance(exc, MemoryError):
        return RESOURCE
    text = f"{type(exc).__name__}: {exc}".lower()
    for pat in _RESOURCE_PATTERNS:
        if pat in text:
            return RESOURCE
    for pat in _DEVICE_LOSS_PATTERNS:
        if pat in text:
            return DEVICE_LOSS
    if isinstance(exc, (OSError, IOError, TimeoutError)):
        return TRANSIENT
    for pat in _TRANSIENT_PATTERNS:
        if pat in text:
            return TRANSIENT
    return FATAL


class RetryPolicy:
    """Bounded retry budget a fault class, with exponential backoff and
    seeded jitter (``seed``; None draws from entropy). One instance covers
    one logical operation; attempts are counted by class."""

    def __init__(self, max_retries: Optional[int] = None,
                 base_delay_s: Optional[float] = None,
                 max_delay_s: float = 5.0, jitter: float = 0.5,
                 seed: Optional[int] = None):
        if max_retries is None:
            max_retries = int(os.environ.get("SHEEP_RETRY_MAX", "3"))
        if base_delay_s is None:
            base_delay_s = float(os.environ.get("SHEEP_RETRY_BASE_S",
                                                "0.05"))
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.max_retries = int(max_retries)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)
        self.attempts = {TRANSIENT: 0, RESOURCE: 0, DEVICE_LOSS: 0}

    def admit(self, fault_class: str) -> bool:
        """True while the class has retry budget left (never for fatal)."""
        if fault_class not in self.attempts:
            return False
        return self.attempts[fault_class] < self.max_retries

    def delay_s(self, attempt: int) -> float:
        """base * 2^attempt, capped, +/- ``jitter`` of it at random."""
        d = min(self.base_delay_s * (2 ** max(0, attempt)),
                self.max_delay_s)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, d)

    def record(self, fault_class: str, exc: BaseException,
               where: str = "") -> float:
        """Count one admitted fault, write the ``retry`` event, note it on
        stderr and return the backoff to sleep. Call only after
        :meth:`admit` said yes."""
        attempt = self.attempts[fault_class]
        self.attempts[fault_class] = attempt + 1
        d = self.delay_s(attempt)
        obs.event("retry", fault_class=fault_class, where=where,
                  attempt=attempt + 1, max_retries=self.max_retries,
                  delay_s=round(d, 3),
                  error=f"{type(exc).__name__}: {str(exc)[:200]}")
        print(f"sheep retry: {fault_class} fault in {where or 'run'} "
              f"(attempt {attempt + 1}/{self.max_retries}, "
              f"backoff {d:.2f}s): {type(exc).__name__}: "
              f"{str(exc)[:200]}", file=sys.stderr)
        return d

    def backoff(self, fault_class: str, exc: BaseException,
                where: str = "") -> None:
        time.sleep(self.record(fault_class, exc, where=where))


def handle_build_fault(policy: RetryPolicy, exc: BaseException,
                       where: str, stats: dict,
                       on_resource=None, on_device_loss=None) -> str:
    """The build's fault epilogue: classify, check the class's budget
    (re-raising fatal faults and spent budgets), count the retry in
    ``stats["dispatch_retries"]``, run the class's recovery hook, back
    off. Returns the fault class when the caller should retry."""
    cls = classify(exc)
    if not policy.admit(cls):
        raise exc
    stats["dispatch_retries"] = stats.get("dispatch_retries", 0) + 1
    if cls == RESOURCE and on_resource is not None:
        on_resource()
    elif cls == DEVICE_LOSS and on_device_loss is not None:
        on_device_loss()
    policy.backoff(cls, exc, where=where)
    return cls


def degrade_dispatch(n: int, chunk_edges: int, batch: int, inflight: int,
                     donate: bool, stats: dict, resume_chunk: int,
                     h2d_ring=None, residency=None):
    """One rung of the resource ladder: with spillable resident chunks
    (``residency``, a :class:`~sheep_tpu_torch.utils.residency.
    ResidencyManager`), spill them and halve the residency budget, the
    dispatch knobs unchanged (``spill_degrades``); else the halving of
    (dispatch_batch, inflight[, h2d_ring]) that the memory model says frees
    the most (``degraded_*`` counters); the ``dispatch_spilled`` or
    ``dispatch_degraded`` event records the rung. Returns the new pair or
    triple, or None when every knob is 1. ``resume_chunk`` is where the
    retry restarts."""
    from sheep_tpu_torch.utils import membudget

    spillable = residency.spillable_bytes() if residency is not None \
        else 0
    nxt = membudget.degraded_dispatch(n, chunk_edges, batch, inflight,
                                      donate, h2d_ring=h2d_ring,
                                      spillable_bytes=spillable)
    if nxt is not None and nxt[0] == "spill":
        freed = residency.pressure_spill()
        stats["spill_degrades"] = stats.get("spill_degrades", 0) + 1
        obs.event("dispatch_spilled", resume_chunk=int(resume_chunk),
                  freed_bytes=int(freed),
                  residency_budget=int(residency.budget))
        return nxt[1:]
    if nxt is not None:
        stats["degraded_dispatch_batch"] = nxt[0]
        stats["degraded_inflight"] = nxt[1]
        event = {"dispatch_batch": nxt[0], "inflight": nxt[1]}
        if len(nxt) > 2:
            stats["degraded_h2d_ring"] = nxt[2]
            event["h2d_ring"] = nxt[2]
        obs.event("dispatch_degraded", resume_chunk=int(resume_chunk),
                  **event)
    return nxt


def recover_device_loss(stats: dict, resume_chunk: int,
                        save_snapshot=None, device=None) -> bool:
    """The device-loss rung: save the build's snapshot first (the
    kill-and-resume contract holds from here even if the device stays
    dead), then :func:`reinit_devices` on ``device`` (one device or a
    sequence: a mesh's distinct devices), counted in
    ``device_loss_recoveries`` and written as the ``device_reinit`` event.
    Returns whether every device answered."""
    if save_snapshot is not None:
        save_snapshot()
    alive = reinit_devices(device)
    stats["device_loss_recoveries"] = \
        stats.get("device_loss_recoveries", 0) + 1
    obs.event("device_reinit", alive=bool(alive),
              resume_chunk=int(resume_chunk))
    return alive


def reinit_devices(device=None) -> bool:
    """Best-effort check of the devices after a device-loss fault: wait
    for each one's queued work, then run a one-element probe on it.
    ``device`` is one device (None: the current CUDA device) or a sequence
    of them. True when every one answered (always on the CPU). A CUDA
    context that a sticky error has killed stays dead in this process, and
    then this returns False; the snapshot saved before it is the way
    back."""
    import torch

    devices = device if isinstance(device, (list, tuple)) else [device]
    try:
        for d in devices:
            dev = torch.device("cuda" if d is None else d)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            probe = torch.ones(1, dtype=torch.int32, device=dev)
            if int(probe.sum()) != 1:
                return False
        return True
    except Exception:  # noqa: BLE001, the device's state is the answer
        return False
