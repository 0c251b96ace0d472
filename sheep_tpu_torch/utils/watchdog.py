"""Progress watchdog of the streaming passes (the port's copy of
``sheep_tpu/utils/watchdog.py``).

A run whose peer dies does not crash: it hangs in its next collective.
A daemon thread watches a progress clock that the driver loop touches
once a batch, and when nothing has touched it for ``timeout_s`` it

1. writes a ``straggler_timeout`` trace event and a diagnosis on stderr
   (pass, last progress label, stall age, process rank),
2. interrupts the main thread (``KeyboardInterrupt``), so the driver
   unwinds through its exception path and the last cadence checkpoint
   makes the run resumable, and
3. only with ``escalate``, exits hard with :data:`EXIT_CODE` after a
   second window, for a main thread wedged in native code that never
   takes the interrupt; supervisors read that code as "stalled: resume
   me".

``SHEEP_PEER_TIMEOUT_S=<seconds>`` turns it on in the sharded driver
(off by default: pick a timeout well above the slowest batch, the
kernels' first build included).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

EXIT_CODE = 121  # distinct "stalled, resumable" exit for supervisors

ENV_TIMEOUT = "SHEEP_PEER_TIMEOUT_S"


def env_timeout_s() -> float:
    """The SHEEP_PEER_TIMEOUT_S value, 0.0 when unset/invalid (off)."""
    try:
        return max(0.0, float(os.environ.get(ENV_TIMEOUT, "0") or "0"))
    except ValueError:
        return 0.0


class StallWatchdog:
    """Progress watchdog: ``touch()`` per unit of progress; a monitor
    thread converts ``timeout_s`` of silence into a diagnosed
    interrupt (see module docstring). Use as a context manager so the
    monitor never outlives the loop it watches."""

    def __init__(self, timeout_s: float, label: str = "run",
                 process: int = 0, escalate: bool = False,
                 poll_s: Optional[float] = None):
        if timeout_s <= 0:
            raise ValueError("watchdog timeout must be > 0 seconds")
        self.timeout_s = float(timeout_s)
        self.label = label
        self.process = int(process)
        self.escalate = bool(escalate)
        self._poll_s = poll_s if poll_s is not None \
            else min(1.0, self.timeout_s / 4)
        self._last = time.monotonic()
        self._last_what = "start"
        self._stop = threading.Event()
        self._fired = False
        self.fired_at: Optional[float] = None  # stall age when fired
        self._thread: Optional[threading.Thread] = None

    # -- driver-side API ---------------------------------------------------
    def touch(self, what: str = "") -> None:
        """Mark progress (cheap: two attribute writes, no locking — the
        monitor only ever reads, and a torn read merely shifts one poll
        by one interval)."""
        self._last = time.monotonic()
        if what:
            self._last_what = what

    def start(self) -> "StallWatchdog":
        self._last = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"sheep-watchdog-{self.label}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self._poll_s + 1.0)
            self._thread = None

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- monitor -----------------------------------------------------------
    def _diagnose(self, age: float) -> None:
        import sys

        from sheep_tpu_torch import obs

        msg = (f"watchdog: no progress in {self.label!r} for "
               f"{age:.1f}s (timeout {self.timeout_s:.1f}s, last: "
               f"{self._last_what}, process {self.process}) — "
               f"interrupting the run; resume from the last checkpoint")
        print(f"sheep {msg}", file=sys.stderr)
        obs.event("straggler_timeout", label=self.label,
                  process=self.process, stalled_s=round(age, 1),
                  timeout_s=self.timeout_s, last=self._last_what)

    def _run(self) -> None:
        import _thread

        while not self._stop.wait(self._poll_s):
            age = time.monotonic() - self._last
            if age < self.timeout_s:
                continue
            if not self._fired:
                self._fired = True
                self.fired_at = age
                try:
                    self._diagnose(age)
                except Exception:
                    pass  # a broken sink must not mute the interrupt
                _thread.interrupt_main()
                # give the main thread one full window to unwind
                self._last = time.monotonic()
            elif self.escalate:
                # the interrupt never landed (main thread wedged in a
                # native collective): hard-exit so the supervisor's
                # auto-resume loop takes over — flush what we can first
                import sys

                print(f"sheep watchdog: interrupt did not unwind "
                      f"{self.label!r} within {self.timeout_s:.1f}s; "
                      f"hard exit {EXIT_CODE}", file=sys.stderr)
                sys.stderr.flush()
                try:
                    from sheep_tpu_torch import obs

                    tr = obs.get_tracer()
                    if tr is not None:
                        tr.close()
                except Exception:
                    pass
                os._exit(EXIT_CODE)


def maybe_watchdog(procs: int, label: str, process: int = 0):
    """A started :class:`StallWatchdog` per the env knob, or None.
    Multi-process runs escalate to the hard exit (a wedged collective
    cannot process interrupts); single-process runs stop at the
    interrupt, which always lands there eventually."""
    t = env_timeout_s()
    if t <= 0 or procs < 1:
        return None
    return StallWatchdog(t, label=label, process=process,
                         escalate=procs > 1).start()


class _NullWatchdog:
    """Inert stand-in when the env knob is off: the driver loops call
    touch() unconditionally without branching per batch."""

    __slots__ = ()

    def touch(self, what: str = "") -> None:
        pass

    def stop(self) -> None:
        pass


NULL_WATCHDOG = _NullWatchdog()


class watched:
    """``with watched(procs, label, process) as wd`` — a started
    watchdog (or the inert null object) that is ALWAYS stopped on
    scope exit, so a driver exception can never leave a live monitor
    thread interrupting whatever the interpreter runs next."""

    def __init__(self, procs: int, label: str, process: int = 0):
        self._args = (procs, label, process)
        self._wd = None

    def __enter__(self):
        self._wd = maybe_watchdog(*self._args) or NULL_WATCHDOG
        return self._wd

    def __exit__(self, *exc) -> bool:
        if self._wd is not None:
            self._wd.stop()
        return False
