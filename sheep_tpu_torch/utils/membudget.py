"""Device-memory model of the streaming build, and the auto dispatch batch
(the port's copy of ``build_phase_bytes`` and ``dispatch_batch_for`` in
``sheep_tpu/utils/membudget.py``; the same numbers for the same
arguments).

All vertex-indexed state is int32[n+1]; a chunk contributes int32[C]
work arrays. The model counts the worst-case live set of the build phase:
the persistent tables, the chunk's transients, the lifting stack, the
staging of the batched and pipelined dispatch, and the chunks the
residency tier keeps on the device. ``dispatch_batch_for`` sizes the
dispatch batch N against it
(``backends.torch_backend.resolve_dispatch_batch``), and
``degraded_dispatch`` picks the knob an out-of-memory fault halves.
"""

from __future__ import annotations

from sheep_tpu_torch.ops.elim import EXACT_TABLE_BYTES


def build_phase_bytes(n: int, chunk_edges: int, dispatch_batch: int = 1,
                      inflight: int = 1, donate: bool = False,
                      h2d_ring: int = 0, resident_bytes: int = 0) -> dict:
    """Estimated peak device bytes of the build phase, by term.

    Persistent: pos, order and the table twice (4 tables). Transient: ~6
    C-sized arrays. Lifting: the exact descent's stack up to
    ``EXACT_TABLE_BYTES``, else one table. Staging: the (N, C, 2) chunk
    stack and the oriented [N, C] blocks of the batched dispatch (N > 1)
    or of the pipeline (D > 1), once per execution in flight; ``donate``
    (buffers reused in place across executions, as the port's batched
    path does) credits back one table and half a staging unit. The staged
    H2D ring holds ``h2d_ring`` blocks of N (C, 2) chunks.
    ``resident_bytes`` are the chunks the residency tier
    (``utils/residency.py``) holds or budgets on the device: live memory
    like the staging, but reclaimable, so the degrade ladder spills them
    before it halves a knob. (The reference's ``lift_levels`` and
    ``descent`` are left out: no caller sets them; the levels come from n,
    the descent from the stack's size.)"""
    table = 4 * (n + 1)
    stack = max(1, int(n).bit_length()) * table
    descent = "exact" if stack <= EXACT_TABLE_BYTES else "stream"
    lift_bytes = min(stack, EXACT_TABLE_BYTES) if descent == "exact" \
        else table
    persistent = 4 * table
    transient = 6 * 4 * chunk_edges
    # the synchronous per-segment driver (N == 1 == D) stages nothing
    # beyond the transients
    staging_unit = 4 * 4 * chunk_edges * max(1, dispatch_batch) \
        if dispatch_batch > 1 or inflight > 1 else 0
    staging = staging_unit * max(1, inflight)
    if donate and staging_unit:
        persistent -= table
        staging -= staging_unit // 2
    ring_bytes = 4 * 2 * chunk_edges * max(1, dispatch_batch) \
        * max(0, h2d_ring)
    resident = max(0, int(resident_bytes))
    total = persistent + transient + staging + ring_bytes + lift_bytes \
        + resident
    return {
        "persistent_bytes": persistent,
        "transient_bytes": transient,
        "staging_bytes": staging,
        "h2d_ring_bytes": ring_bytes,
        "lift_bytes": lift_bytes,
        "resident_bytes": resident,
        "descent": descent,
        "total_bytes": total,
    }


def dispatch_batch_for(hbm_bytes: int, n: int, chunk_edges: int,
                       cap: int = 16, inflight: int = 1,
                       donate: bool = False, h2d_ring: int = 0) -> int:
    """Largest power-of-two dispatch batch N in [1, cap] whose build phase
    fits ``hbm_bytes`` by :func:`build_phase_bytes`."""
    best = 1
    nb = 2
    while nb <= cap:
        if build_phase_bytes(n, chunk_edges, dispatch_batch=nb,
                             inflight=inflight, donate=donate,
                             h2d_ring=h2d_ring)["total_bytes"] > hbm_bytes:
            break
        best = nb
        nb *= 2
    return best


def degraded_dispatch(n: int, chunk_edges: int, dispatch_batch: int,
                      inflight: int, donate: bool = False,
                      h2d_ring=None, spillable_bytes: int = 0):
    """One out-of-memory degrade step (the reference's function of the
    same name): with ``spillable_bytes`` > 0 the first rung is
    ``("spill", dispatch_batch, inflight[, h2d_ring])``, the knobs
    unchanged, because resident chunks come back for free; else the
    halving of the dispatch batch, the depth or (when ``h2d_ring`` is an
    int) the ring that leaves the smallest modeled total, ties to the
    batch. Returns the new pair (``h2d_ring`` None) or triple, or None when
    every knob is 1."""
    batch, depth = max(1, int(dispatch_batch)), max(1, int(inflight))
    ring = None if h2d_ring is None else max(1, int(h2d_ring))
    if spillable_bytes > 0:
        step = ("spill", batch, depth)
        return step + (ring,) if ring is not None else step
    if batch <= 1 and depth <= 1 and (ring is None or ring <= 1):
        return None

    def total(b, d, r):
        return build_phase_bytes(n, chunk_edges, dispatch_batch=b,
                                 inflight=d, donate=donate,
                                 h2d_ring=r or 0)["total_bytes"]

    r0 = ring or 0
    cand = []
    if batch > 1:
        cand.append((total(batch // 2, depth, r0),
                     (batch // 2, depth, r0)))
    if depth > 1:
        cand.append((total(batch, depth // 2, r0),
                     (batch, depth // 2, r0)))
    if ring is not None and ring > 1:
        cand.append((total(batch, depth, ring // 2),
                     (batch, depth, ring // 2)))
    best = min(cand, key=lambda c: c[0])[1]
    return best if ring is not None else best[:2]


def max_vertices_for(hbm_bytes: int, chunk_edges: int) -> int:
    """Largest power-of-two vertex count whose build phase fits
    ``hbm_bytes`` by :func:`build_phase_bytes` (the ceiling past which
    the CLI picks the vertex-sharded build)."""
    v = 1
    while build_phase_bytes(2 * v, chunk_edges)["total_bytes"] <= hbm_bytes:
        v *= 2
    return v
