"""Chunk residency: device memory as a cache tier over the stream (the
port's copy of ``sheep_tpu/utils/residency.py``).

Every chunk can be read again from the stream (a file, or a synthetic
stream's counter hash), so a chunk dropped from the device costs a
re-read and nothing else. The manager keeps chunks on the device within a
byte budget, in two tiers:

- **sticky prefix**: chunks admitted from the stream's head while they
  fit. The three streaming passes (degrees, build, score) all read from
  chunk 0, so the lowest indices are the ones to keep (LRU would evict
  exactly the chunks the next pass needs first).
- **rotating tail window**: once the stream outgrows the budget, a
  quarter of it is carved from the prefix's top and rotated over the
  chunks since the last confirmed checkpoint, so that a retry in the same
  process (an out-of-memory degrade, a device loss), which re-folds from
  the snapshot's chunk, finds them on the device. Checkpoint boundaries
  are the eviction points: :meth:`ResidencyManager.boundary` drops the
  window's entries behind the confirmed chunk, which only a later pass
  reads again, never a retry.

A chunk's bits do not depend on where it lives, so a build under a tiny
budget equals the unconstrained one exactly.

Counters, into the caller's stats dict (the run's diagnostics):

    spill_evictions       entries dropped from the device
    spill_reloads         chunks read again after their eviction
    spill_reload_bytes    and their bytes
    spill_resident_bytes  the resident set's high-water mark
    residency_hits        chunks served from the device
    residency_boundary_evictions  boundaries that dropped entries

The entries hold device tensors. Eviction drops the manager's reference
only: a consumer that still holds the tensor (an execution in flight)
keeps its memory alive, so eviction cannot corrupt issued work. The
counters are this byte accounting, not the allocator's. A leased entry's
bytes are not reclaimable, so eviction refuses it
(:class:`LeasedChunkError`) and the spill scans skip it.
"""

from __future__ import annotations

from typing import Optional

#: tier tags for resident entries
_PREFIX = 0
_WINDOW = 1


class LeasedChunkError(RuntimeError):
    """Eviction was asked to drop a chunk some consumer still leases."""


class _Entry:
    __slots__ = ("ref", "nbytes", "tier", "leases")

    def __init__(self, ref, nbytes: int, tier: int):
        self.ref = ref
        self.nbytes = int(nbytes)
        self.tier = tier
        self.leases = 0


def manager_from_env(stats: Optional[dict] = None,
                     window_fraction: float = 0.25):
    """A :class:`ResidencyManager` of an explicit ``SHEEP_CACHE_BYTES``
    budget, or None when it is unset or not positive: the sharded
    driver's opt-in, as the reference's (the single-device backend sizes
    its budget from the card's memory; the sharded one keeps chunks on
    the devices only where the operator set the budget)."""
    import os

    try:
        budget = int(os.environ.get("SHEEP_CACHE_BYTES", "0") or "0")
    except ValueError:
        budget = 0
    if budget <= 0:
        return None
    return ResidencyManager(budget, stats=stats,
                            window_fraction=window_fraction)


class ResidencyManager:
    """Byte-accounted device residency for streamed chunks.

    ``budget_bytes`` caps the resident set; ``stats`` (optional dict —
    typically the build's stats) receives the spill counters so
    they ride the existing diagnostics plumbing unchanged.
    ``window_fraction`` bounds the rotating tail window carved out once
    the stream overflows the budget (the carve only happens *on first
    overflow*, so a stream that fits keeps the whole budget as prefix,
    with zero evictions)."""

    def __init__(self, budget_bytes: int, stats: Optional[dict] = None,
                 window_fraction: float = 0.25):
        self.budget = max(0, int(budget_bytes))
        self.stats = stats if stats is not None else {}
        self.window_fraction = float(window_fraction)
        self.entries: dict = {}          # idx -> _Entry
        self.used = 0
        self.complete = False
        self._overflowed = False         # stream outgrew the budget once
        self._window_budget = 0          # carved on first overflow
        self._window_used = 0
        self._window_order: list = []    # admission order (FIFO rotation)
        self._evicted: set = set()       # ids once resident, since dropped

    # -- counters ------------------------------------------------------
    def _count(self, key: str, delta) -> None:
        self.stats[key] = self.stats.get(key, 0) + delta

    def _high_water(self) -> None:
        if self.used > self.stats.get("spill_resident_bytes", 0):
            self.stats["spill_resident_bytes"] = self.used

    def spillable_bytes(self) -> int:
        """Bytes the spill scans could free right now (unleased)."""
        return sum(e.nbytes for e in self.entries.values()
                   if e.leases == 0)

    # -- serving -------------------------------------------------------
    def get(self, idx: int):
        """Resident ref for chunk ``idx`` or None (host/disk re-read)."""
        e = self.entries.get(idx)
        if e is None:
            return None
        self._count("residency_hits", 1)
        return e.ref

    def admit(self, idx: int, ref, nbytes: int) -> bool:
        """Offer an uploaded chunk for residence; returns True when
        retained. Re-uploads of previously evicted ids are counted as
        reloads whether or not they are re-retained (the reload cost —
        the host->device transfer — was paid either way)."""
        nbytes = int(nbytes)
        if idx in self._evicted:
            self._count("spill_reload_bytes", nbytes)
            self._count("spill_reloads", 1)
            self._evicted.discard(idx)
        if self.budget <= 0:
            return False
        old = self.entries.get(idx)
        if old is not None:
            old.ref = ref  # refresh (same bits; same accounted size)
            return True
        if not self._overflowed:
            if self.used + nbytes <= self.budget:
                self.entries[idx] = _Entry(ref, nbytes, _PREFIX)
                self.used += nbytes
                self._high_water()
                return True
            # first overflow: carve the rotating window out of the
            # prefix top — from here on the stream is out-of-core
            self._overflowed = True
            # at least one chunk wide so rotation can make progress,
            # clamped to the budget so the cap holds even when a single
            # chunk exceeds it (such a chunk is refused below)
            self._window_budget = min(self.budget, max(
                nbytes, int(self.budget * self.window_fraction)))
            self._shrink_prefix_to(self.budget - self._window_budget)
        # window admission: rotate out the oldest unleased window
        # entries until this chunk fits the carve-out
        if nbytes > self._window_budget:
            return False
        while self._window_used + nbytes > self._window_budget:
            if not self._rotate_window():
                return False  # everything left is leased
        self.entries[idx] = _Entry(ref, nbytes, _WINDOW)
        self._window_order.append(idx)
        self._window_used += nbytes
        self.used += nbytes
        self._high_water()
        return True

    def note_stream_end(self, total_chunks: int) -> None:
        """A head-anchored pass consumed the whole stream: when every
        chunk stayed resident, later passes serve entirely from the device
        (the legacy cache's ``complete`` fast path)."""
        if not self._overflowed and not self._evicted \
                and len(self.entries) >= total_chunks:
            self.complete = True

    # -- leases --------------------------------------------------------
    def lease(self, idx: int) -> None:
        e = self.entries.get(idx)
        if e is not None:
            e.leases += 1

    def release(self, idx: int) -> None:
        e = self.entries.get(idx)
        if e is not None and e.leases > 0:
            e.leases -= 1

    # -- eviction ------------------------------------------------------
    def _drop(self, idx: int) -> int:
        e = self.entries.pop(idx)
        self.used -= e.nbytes
        if e.tier == _WINDOW:
            self._window_used -= e.nbytes
            try:
                self._window_order.remove(idx)
            except ValueError:
                pass
        self._evicted.add(idx)
        self._count("spill_evictions", 1)
        return e.nbytes

    def evict(self, idx: int) -> int:
        """Drop one resident chunk; refuses a leased one — its bytes
        are not reclaimable while a consumer holds it for issued work."""
        e = self.entries.get(idx)
        if e is None:
            return 0
        if e.leases > 0:
            raise LeasedChunkError(
                f"chunk {idx} has {e.leases} active lease(s); its bytes "
                "are pinned by in-flight work and cannot be evicted")
        return self._drop(idx)

    def _rotate_window(self) -> bool:
        for idx in list(self._window_order):
            if self.entries[idx].leases == 0:
                self._drop(idx)
                return True
        return False

    def _shrink_prefix_to(self, target_bytes: int) -> int:
        """Evict unleased prefix entries top-down (highest idx first —
        the lowest indices are the ones every later pass re-reads
        first) until the prefix fits ``target_bytes``."""
        freed = 0
        prefix_used = self.used - self._window_used
        for idx in sorted((i for i, e in self.entries.items()
                           if e.tier == _PREFIX), reverse=True):
            if prefix_used <= target_bytes:
                break
            if self.entries[idx].leases:
                continue
            nb = self._drop(idx)
            prefix_used -= nb
            freed += nb
        return freed

    def boundary(self, confirmed_idx: int) -> int:
        """Checkpoint boundary = eviction point: window entries behind
        the confirmed index can only ever be re-read by a later *pass*
        (the prefix's job), never by a retry — their recovery state is
        on disk now. Returns bytes freed."""
        freed = 0
        for idx in list(self._window_order):
            if idx < confirmed_idx and self.entries[idx].leases == 0:
                freed += self._drop(idx)
        if freed:
            self._count("residency_boundary_evictions", 1)
        return freed

    def spill(self, target_bytes: Optional[int] = None) -> int:
        """Free resident bytes under memory pressure: window first
        (oldest first — coldest for a head-anchored re-read), then the
        prefix top-down. ``None`` spills everything unleased."""
        freed = 0
        for idx in list(self._window_order):
            if target_bytes is not None and freed >= target_bytes:
                return freed
            if self.entries[idx].leases == 0:
                freed += self._drop(idx)
        remaining = None if target_bytes is None \
            else max(0, target_bytes - freed)
        if remaining is None or remaining > 0:
            freed += self._shrink_prefix_to(
                0 if remaining is None
                else max(0, (self.used - self._window_used) - remaining))
        return freed

    def pressure_spill(self) -> int:
        """The RESOURCE-fault spill step (spill-before-shrink, threaded
        via utils/retry.degrade_dispatch): drop everything unleased AND
        halve the budget, so the refill pressure shrinks with the
        device that just proved too small. Repeated faults walk the
        budget to 0 — the point where the degrade ladder falls through
        to halving dispatch knobs, exactly the old behavior."""
        freed = self.spill(None)
        self.budget //= 2
        self._overflowed = self.budget > 0 and self._overflowed
        self._window_budget = min(self._window_budget, self.budget)
        self.complete = False
        return freed
