"""Fault injection (the port's copy of ``sheep_tpu/utils/fault.py``).

A test hook that raises faults mid-stream, to exercise checkpoint/resume
and the in-process retry layer (``utils/retry.py``). It reads the same
environment variable as the JAX package, ``SHEEP_FAULT_INJECT``, with the
same three grammars:

**Kill at a point**::

    SHEEP_FAULT_INJECT="<phase>:<count>"      e.g. "build:3"

raises :class:`InjectedFault` once the named phase has processed that many
chunks, and at every later call, so a fault caught and ignored cannot let
the run go on. ``<phase>`` may also name an enclosing :func:`scope`
("level0:3", "level:1": the hierarchy's granularities).

**Typed fault at a point**::

    SHEEP_FAULT_INJECT="<kind>@<phase>:<count>[:<shots>]"
                                                   e.g. "oom@dispatch:2"

raises the kind's exception at the first call where the count is reached,
at most ``shots`` times a process (default 1: these faults are handled in
process, and raising again at the same point would defeat the retry).
Kinds:

    oom      :class:`InjectedResourceExhausted`  (fault_class resource)
    device   :class:`InjectedDeviceLoss`         (fault_class device_loss)
    read     :class:`InjectedReadError`          (an OSError; transient)
    kill     :class:`InjectedFault`              (fatal)
    stall    no exception: sleeps ``STALL_S`` seconds at the point

**Seeded chaos schedule**::

    SHEEP_FAULT_INJECT="chaos:<seed>[:<budget>[:<rate>]]"

draws at every injection point from a seeded RNG and, with probability
``rate`` (default 0.08), raises one fault of a kind the point declared,
until ``budget`` faults (default 2) have fired.

Phase names are injection points: the batched driver reports "dispatch"
an execution issued, the edge readers "read" a physical read, and the
per-chunk sites "degrees", "build" and "score". The module state (shots
consumed, chaos schedules, scopes) is this package's own: a process that
runs both packages arms each one's separately, and :func:`reset` clears
this one's.
"""

from __future__ import annotations

import os
import random
import time
from contextlib import contextmanager
from typing import Dict, List, Tuple

from sheep_tpu_torch import obs

ENV_VAR = "SHEEP_FAULT_INJECT"

# enclosing execution scopes (e.g. "level0" while the hierarchy's level-0
# partition streams); injection is a single-threaded test hook
_SCOPES: List[str] = []

# shots consumed by the typed grammar, keyed by spec; re-armed when the
# environment's value changes (unset included) and by reset()
_CONSUMED: Dict[str, int] = {}

# chaos schedules, keyed by spec
_CHAOS: Dict[str, dict] = {}

_LAST_SPEC: List = [None]

CHAOS_DEFAULT_BUDGET = 2
CHAOS_DEFAULT_RATE = 0.08

STALL_S = 0.5


def reset() -> None:
    """Forget every consumed shot and chaos schedule, re-arming whatever
    spec is (or will be) in the environment. A test helper."""
    _CONSUMED.clear()
    _CHAOS.clear()
    _LAST_SPEC[0] = None


class InjectedFault(RuntimeError):
    """Kill-style injected fault; the retry layer classifies it fatal."""

    fault_class = "fatal"


class InjectedResourceExhausted(RuntimeError):
    """Injected allocation failure: the retry layer's path for a real
    out-of-memory error."""

    fault_class = "resource"


class InjectedDeviceLoss(RuntimeError):
    """Injected device loss: snapshot, reinitialize, resume."""

    fault_class = "device_loss"


class InjectedReadError(OSError):
    """Injected transient read failure, which the streams' bounded read
    retry absorbs."""

    fault_class = "transient"


_KINDS = {
    "kill": InjectedFault,
    "oom": InjectedResourceExhausted,
    "device": InjectedDeviceLoss,
    "read": InjectedReadError,
    "stall": None,  # sleeps instead of raising
}


@contextmanager
def scope(name: str):
    """The dynamic extent of a named scope: a spec whose phase names it
    fires in any streaming phase running under it."""
    _SCOPES.append(name)
    try:
        yield
    finally:
        _SCOPES.pop()


def _parse(spec: str) -> Tuple[str, str, int, int]:
    """spec -> (kind, phase, count, shots); kind '' is the kill grammar."""
    head, _, count = spec.partition(":")
    kind, at, phase = head.partition("@")
    if not at:
        kind, phase = "", head
    elif kind not in _KINDS:
        raise ValueError(f"bad {ENV_VAR} kind {kind!r}; "
                         f"want one of {sorted(_KINDS)}")
    count, _, shots = count.partition(":")
    try:
        return kind, phase, int(count), int(shots) if shots else 1
    except ValueError:
        raise ValueError(f"bad {ENV_VAR} spec {spec!r}; want "
                         f"'[kind@]<phase>:<int>[:<shots>]' or "
                         f"'chaos:<seed>'")


def _raise_kind(kind: str, msg: str):
    if kind == "stall":
        time.sleep(STALL_S)
        return
    exc_type = _KINDS[kind]
    if kind == "oom":
        # the status text a real failure carries, so that classification
        # by pattern is exercised too
        raise exc_type(f"RESOURCE_EXHAUSTED (injected): {msg}")
    raise exc_type(f"injected {kind} fault: {msg}")


def _chaos_state(spec: str) -> dict:
    st = _CHAOS.get(spec)
    if st is None:
        parts = spec.split(":")
        try:
            seed = int(parts[1])
            budget = int(parts[2]) if len(parts) > 2 \
                else CHAOS_DEFAULT_BUDGET
            rate = float(parts[3]) if len(parts) > 3 \
                else CHAOS_DEFAULT_RATE
        except (IndexError, ValueError):
            raise ValueError(f"bad {ENV_VAR} spec {spec!r}; want "
                             f"'chaos:<seed>[:<budget>[:<rate>]]'")
        st = _CHAOS[spec] = {"rng": random.Random(seed),
                             "budget": budget, "rate": rate,
                             "points": 0, "injected": 0}
    return st


def _maybe_chaos(spec: str, phase: str, kinds: Tuple[str, ...]) -> None:
    st = _chaos_state(spec)
    st["points"] += 1
    if st["injected"] >= st["budget"]:
        return
    # draw even where the point offers no kind, so the schedule does not
    # depend on which kinds the points declare
    r = st["rng"].random()
    pick = st["rng"].randrange(len(kinds)) if kinds else 0
    if r >= st["rate"] or not kinds:
        return
    kind = kinds[pick]
    st["injected"] += 1
    obs.event("chaos_inject", kind=kind, phase=phase, point=st["points"],
              injected=st["injected"], budget=st["budget"])
    _raise_kind(kind, f"chaos point {st['points']} in phase {phase!r}")


def maybe_fail(phase: str, chunks_done: int,
               kinds: Tuple[str, ...] = ("kill",)) -> None:
    """Injection point: raise as the armed ``SHEEP_FAULT_INJECT`` spec
    says, if it targets this phase (or an enclosing scope) and count.
    ``kinds`` are the fault kinds this point can absorb; a chaos schedule
    draws from them only."""
    spec = os.environ.get(ENV_VAR)
    if spec != _LAST_SPEC[0]:
        # a newly (re)armed spec starts with fresh shots and schedule
        _LAST_SPEC[0] = spec
        if spec:
            _CONSUMED.pop(spec, None)
            _CHAOS.pop(spec, None)
    if not spec:
        return
    if spec.startswith("chaos:"):
        _maybe_chaos(spec, phase, kinds)
        return
    kind, target_phase, target_count, shots = _parse(spec)
    if target_phase != phase and target_phase not in _SCOPES:
        return
    if chunks_done < target_count:
        return
    where = (f"phase {phase!r}"
             + (f" (scope {target_phase!r})" if target_phase != phase
                else "")
             + f" after {chunks_done} chunks")
    if not kind:  # the kill grammar raises at every later call too
        raise InjectedFault(f"injected fault in {where}")
    if _CONSUMED.get(spec, 0) >= shots:
        return
    _CONSUMED[spec] = _CONSUMED.get(spec, 0) + 1
    obs.event("fault_inject", kind=kind, phase=phase,
              chunks_done=int(chunks_done))
    _raise_kind(kind, where)
