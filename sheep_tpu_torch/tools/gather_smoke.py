"""The gather probes of ``tools/pallas_smoke.py``, run through the port's
hand-written kernels.

    python -m sheep_tpu_torch.tools.gather_smoke --variant {1,2,3} [--perf]
        [--device cpu]

Each probe shape of the reference goes through its Hopper kernel and is
checked exactly against the kernel's plain PyTorch version and numpy:

1. the 1-D gather ``ops/gather.vmem_gather`` (kernel K1) at the probe's
   table of 2^20 and 2^16 Knuth-hashed indices, block 8192;
2. the 2-D forms A-E: A row take (K2 ``take_rows``), B sublane and C lane
   ``take_along_axis`` (K3 ``take_along`` on axis 0 and 1), D the
   composite scalar gather, whose function is the flat gather (K1 on the
   flattened table), and E the lane-routed bulk gather (K3 on axis 0 with
   ``shift = 7``). ``--perf`` adds the legs of the reference's ``_perf2``
   at its (8192, 128) table and 2^20 balanced lookups: ``torch.take`` on
   the flat table (the library yardstick), K1, K3 alone on routed input,
   E with its router (a stable argsort by ``i & 127``) and E with router
   and un-route;
3. the lane gather (K3, axis 1) on (8, R) at the reference's eight widths.
   Every width runs: K3 reads the row through L2 at any width, where the
   reference stopped at the first width Mosaic rejected.

One JSON line per form or width: ``form``, ``built`` (the kernel was
built and launched), ``ok``, ``max_abs_err`` (against the plain version),
``ms`` (mean device time of a call by CUDA events, the card kept busy
while the host queues the calls), ``plain_ms`` (the plain version's),
``host_ms`` (the same calls launched back to back with nothing queued
ahead: the host's launch time where it exceeds the device's), ``melems``
(M elements/s at ``ms``), ``bound_ms`` (the bytes the function must
move over an H100's 3.35 TB/s: idx in, out back, and each table element
that this run's lookups reach read once) and ``library_ms`` (one PyTorch
call that computes the same function, device time). K2's and K3's
records on CUDA add ``plan`` (the launch plan, ``ops/gather2d.py``) and
``chain_bound_ms`` (an empty kernel launched as they are, on the plan's
grid, plus two dependent loads at the card's measured load latency), and
K3's ``sector_bytes`` (the 32-byte sectors each warp-wide load of 32
consecutive lookups reaches, summed: the L2's traffic). The tool runs on
CUDA; ``--device cpu`` runs the plain versions for their semantics only,
with no time. The exit code is 0 only when every record is ``ok``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

# H100 SXM device memory rate (NVIDIA data sheet), for the bytes bound
HBM_BYTES_PER_S = 3.35e12

P3_WIDTHS = (128, 256, 512, 1024, 4096, 8192, 16384, 32768)


# cycles of the spin kernel that keeps the card busy while the host queues
# a timed run (about 10 ms at an H100's clock)
PREFILL_CYCLES = 20_000_000


def time_ms(fn, iters: int = 50, prefill: bool = True) -> float:
    """Mean time of one call, by CUDA events over ``iters`` calls after a
    warm-up call. With ``prefill`` a spin kernel holds the card while the
    host queues the calls, so the events bracket device time; without it
    a call that the card finishes faster than the host launches it
    measures the host's launch time (``host_ms`` in the records)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if prefill:
        torch.cuda._sleep(PREFILL_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def chase_yardsticks(blocks: int = 1, T: int = (1 << 22) + 1,
                     steps: int = 4096) -> dict:
    """Chain yardsticks on the card, by ``lift.chase``: the launch floor
    (an empty kernel of ``blocks`` blocks of 256 threads) and the latency
    of one dependent load (a chase of ``steps`` loads on one thread over a
    random cycle through ``T`` entries, warm in L2 after the warm-up call,
    less the empty one-block kernel, over the steps)."""
    from sheep_tpu_torch.ops import lift

    g = torch.Generator(device="cuda").manual_seed(47)
    order = torch.randperm(T, device="cuda", generator=g)
    t = torch.empty(T, dtype=torch.int32, device="cuda")
    t[order] = torch.roll(order, -1).int()
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    floor = time_ms(lambda: lift.chase(t, 0, 0, out, blocks))
    empty = time_ms(lambda: lift.chase(t, 0, 0, out))
    chased = time_ms(lambda: lift.chase(t, 0, steps, out), iters=10)
    torch.cuda.synchronize()
    at = int((order == 0).nonzero()[0, 0])
    if int(out[0]) != int(order[(at + steps) % T]):
        raise RuntimeError("chase: the chain did not end where the cycle "
                           "says")
    return {"floor_ms": floor, "empty_one_block_ms": empty,
            "chase_ms": chased, "chase_steps": steps,
            "load_latency_ms": max(chased - empty, 0.0) / steps}


def chain_bound_ms(plan, latency_ms: float) -> float:
    """The chain bound of a K2 or K3 launch plan: an empty kernel launched
    as they are on the plan's grid and blocks, plus two dependent loads
    (idx, then the table entry) at ``latency_ms``."""
    from sheep_tpu_torch.ops import gather2d

    grid = getattr(plan, "grid", None) or (plan.blocks, 1)
    return time_ms(lambda: gather2d.launch_empty(
        "cuda", grid, plan.threads)) + 2 * latency_ms


def sector_bytes(x: torch.Tensor, idx: torch.Tensor, axis: int,
                 shift: int = 0) -> int:
    """K3: the L2's sector traffic, in bytes: for each run of 32
    consecutive lookups (one warp-wide load), the 32-byte sectors of ``x``
    it reaches, summed. Where the lookups scatter, each is a sector of its
    own, and this, not the bytes the function must move, is what the L2
    sends the SMs."""
    j = (idx >> shift).clamp(0, x.shape[axis] - 1).long()
    other = torch.arange(idx.shape[1 - axis], device=idx.device)
    lin = (j * x.shape[1] + other if axis == 0
           else other[:, None] * x.shape[1] + j)
    sec = ((lin + x.storage_offset()) // 8).reshape(-1)
    pad = -sec.numel() % 32
    if pad:  # repeat the last lookup: no new sector
        sec = torch.cat([sec, sec[-1:].expand(pad)])
    runs = sec.view(-1, 32).sort(dim=1).values
    return 32 * (runs.shape[0] + int((runs[:, 1:] != runs[:, :-1]).sum()))


# The bytes a gather must move on this run's data: idx read once, out
# written once, and each table element the lookups reach (after the shift
# and the clip) read once; never more of the table than the lookups can
# reach.

def _distinct(j: torch.Tensor) -> int:
    return int(torch.unique(j).numel())


def take_bytes(table_numel: int, idx: torch.Tensor) -> int:
    """K1: ``table[clip(idx)]`` on a flat table."""
    return 8 * idx.numel() + 4 * _distinct(idx.clamp(0, table_numel - 1))


def rows_bytes(t: torch.Tensor, idx: torch.Tensor) -> int:
    """K2: whole rows of the (R, W) table ``t``."""
    b, w = idx.numel(), t.shape[1]
    rows = _distinct(idx.clamp(0, t.shape[0] - 1))
    return 4 * b + 4 * b * w + 4 * w * rows


def along_bytes(x: torch.Tensor, idx: torch.Tensor, axis: int,
                shift: int = 0) -> int:
    """K3: ``take_along_axis(x, clip(idx >> shift), axis)``."""
    j = (idx >> shift).clamp(0, x.shape[axis] - 1).long()
    other = torch.arange(idx.shape[1 - axis], device=idx.device)
    lin = (j * x.shape[1] + other if axis == 0
           else other[:, None] * x.shape[1] + j)
    return 8 * idx.numel() + 4 * _distinct(lin)


def view_at(a: torch.Tensor, at: int) -> torch.Tensor:
    """``a``'s values in a contiguous view that starts ``at`` elements into
    a larger buffer (off a 16-byte boundary for at % 4 != 0)."""
    buf = torch.empty(a.numel() + at, dtype=a.dtype, device=a.device)
    v = buf[at:].view(a.shape)
    v.copy_(a)
    return v


def _rows_plan(t: torch.Tensor, idx: torch.Tensor):
    """K2's plan for a fresh (16-byte aligned) output."""
    from sheep_tpu_torch.ops import gather2d

    return gather2d.plan_take_rows(t.shape[1], len(idx), t.data_ptr(), 0,
                                   gather2d.sms(t.device))


def _along_plan(idx: torch.Tensor):
    from sheep_tpu_torch.ops import gather2d

    return gather2d.plan_take_along(*idx.shape, gather2d.sms(idx.device))


def route(t2: torch.Tensor, i: torch.Tensor):
    """Form E with its router: lookups ``i`` into the flattened (R, 128)
    table ``t2``, sorted by ``i & 127`` so that lane j holds only residue
    j, gathered by K3 (axis 0, shift 7). Returns the values in routed
    order and the routing permutation. Exact only for balanced residue
    counts (``len(i) / 128`` of each), as in the reference."""
    if len(i) % 128:
        raise ValueError(f"route: {len(i)} lookups, not a multiple of 128")
    from sheep_tpu_torch.ops import gather2d

    order = torch.argsort(i & 127, stable=True)
    routed = i[order].reshape(128, -1).T.contiguous()
    z = gather2d.take_along(t2, routed, 0, shift=7)
    return z.T.reshape(-1), order


def unroute(z: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Values in routed order back to the lookups' own order."""
    out = torch.empty_like(z)
    out[order] = z
    return out


class Probe:
    """Runs cases on one device and keeps their records."""

    def __init__(self, device):
        from sheep_tpu_torch.device import resolve_device

        self.dev = resolve_device(device)
        self.cuda = self.dev.type == "cuda"
        self.records: list = []
        self._latency = None

    def latency_ms(self) -> float:
        """One dependent load's latency (:func:`chase_yardsticks`),
        measured once."""
        if self._latency is None:
            self._latency = chase_yardsticks()["load_latency_ms"]
        return self._latency

    def tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    def case(self, form, port, plain, expect, nbytes, n, library=None,
             plan=None, **extra) -> dict:
        """Run ``port``, check it exactly against ``plain`` and the numpy
        ``expect`` (None: ``plain`` only); on CUDA time it, ``plain`` and
        ``library``, and with ``plan`` (a callable giving K2's or K3's
        launch plan) add the plan and its chain bound; print the
        record."""
        rec = {"form": form, "n": n, **extra}
        try:
            out = port()
            if self.cuda:
                torch.cuda.synchronize()
        except (RuntimeError, OSError) as e:
            rec.update(built=False, ok=False,
                       error=f"{type(e).__name__}: {e}"[:800])
            self._emit(rec)
            return rec
        ref = plain()
        rec["built"] = self.cuda
        rec["ok"] = bool(out.shape == ref.shape and torch.equal(out, ref) and
                         (expect is None
                          or np.array_equal(out.cpu().numpy(), expect)))
        rec["max_abs_err"] = (
            None if out.shape != ref.shape
            else int((out.long() - ref.long()).abs().max()) if out.numel()
            else 0)
        rec["ms"] = rec["melems"] = rec["library_ms"] = None
        rec["host_ms"] = rec["plain_ms"] = None
        if self.cuda:
            rec["ms"] = time_ms(port)
            rec["host_ms"] = time_ms(port, prefill=False)
            rec["plain_ms"] = time_ms(plain)
            rec["melems"] = n / rec["ms"] / 1e3
            if library is not None:
                rec["library_ms"] = time_ms(library)
            if plan is not None:
                plan = plan()
                rec["plan"] = dataclasses.asdict(plan)
                rec["chain_bound_ms"] = chain_bound_ms(plan,
                                                       self.latency_ms())
        rec["bound_ms"] = bound_ms(nbytes)
        self._emit(rec)
        return rec

    def _emit(self, rec: dict) -> None:
        self.records.append(rec)
        print(json.dumps(rec), flush=True)


def variant1(p: Probe) -> None:
    from sheep_tpu_torch.ops import gather

    T, M, block = 1 << 20, 1 << 16, 8192
    table_np = np.arange(T, dtype=np.int32)
    # in int64 on the host: the Knuth constant overflows int32
    idx_np = ((np.arange(M, dtype=np.int64) * 2654435761) % T).astype(
        np.int32)
    table, idx = p.tensor(table_np), p.tensor(idx_np)
    idx64 = idx.long()
    p.case("V1_vmem_gather", lambda: gather.vmem_gather(table, idx, block),
           lambda: gather.gather_clip_plain(table, idx), table_np[idx_np],
           take_bytes(T, idx), M, library=lambda: torch.take(table, idx64),
           kernel="K1")


def variant2(p: Probe, perf: bool) -> None:
    from sheep_tpu_torch.ops import gather, gather2d

    # the reference's draws, in its order, so the inputs are its inputs
    R, B = 4096, 1024
    rng = np.random.default_rng(0)
    tnp = rng.integers(0, 1 << 30, (R, 128), dtype=np.int32)
    t = p.tensor(tnp)

    a_np = rng.integers(0, R, (B,), dtype=np.int32)
    a = p.tensor(a_np)
    p.case("A_row_take", lambda: gather2d.take_rows(t, a),
           lambda: gather2d.take_rows_plain(t, a), tnp[a_np],
           rows_bytes(t, a), B * 128,
           library=lambda: torch.index_select(t, 0, a), kernel="K2",
           plan=lambda: _rows_plan(t, a))

    b_np = rng.integers(0, R, (8, 128), dtype=np.int32)
    b = p.tensor(b_np)
    b64 = b.long()
    p.case("B_sublane_gather", lambda: gather2d.take_along(t, b, 0),
           lambda: gather2d.take_along_plain(t, b, 0),
           np.take_along_axis(tnp, b_np, axis=0), along_bytes(t, b, 0),
           b.numel(), library=lambda: torch.gather(t, 0, b64), kernel="K3",
           plan=lambda: _along_plan(b), sector_bytes=sector_bytes(t, b, 0))

    x8_np = rng.integers(0, 1 << 30, (8, 128), dtype=np.int32)
    c_np = rng.integers(0, 128, (8, 128), dtype=np.int32)
    x8, c = p.tensor(x8_np), p.tensor(c_np)
    c64 = c.long()
    p.case("C_lane_gather", lambda: gather2d.take_along(x8, c, 1),
           lambda: gather2d.take_along_plain(x8, c, 1),
           np.take_along_axis(x8_np, c_np, axis=1),
           along_bytes(x8, c, 1), c.numel(),
           library=lambda: torch.gather(x8, 1, c64), kernel="K3", axis=1,
           plan=lambda: _along_plan(c), sector_bytes=sector_bytes(x8, c, 1))

    S = 64
    d_np = rng.integers(0, R * 128, (S, 8), dtype=np.int32)
    d = p.tensor(d_np)
    d_flat, d64 = d.reshape(-1), d.long()
    flat = t.reshape(-1)
    p.case("D_composite_scalar",
           lambda: gather.gather_clip(flat, d_flat).reshape(S, 8),
           lambda: gather.gather_clip_plain(flat, d_flat).reshape(S, 8),
           tnp.reshape(-1)[d_np], take_bytes(flat.numel(), d_flat),
           d.numel(),
           library=lambda: torch.take(t, d64), kernel="K1")

    SB = 64
    lanes = np.arange(128, dtype=np.int32)[None, :]
    e_np = rng.integers(0, R, (SB, 128), dtype=np.int32) * 128 + lanes
    e = p.tensor(e_np)
    e64 = e.long()
    p.case("E_lane_routed_bulk", lambda: gather2d.take_along(t, e, 0, 7),
           lambda: gather2d.take_along_plain(t, e, 0, 7),
           tnp.reshape(-1)[e_np], along_bytes(t, e, 0, 7), e.numel(),
           library=lambda: torch.take(t, e64), kernel="K3",
           plan=lambda: _along_plan(e), sector_bytes=sector_bytes(t, e, 0, 7))

    if perf:
        _perf2(p, rng)


def _perf2(p: Probe, rng) -> None:
    from sheep_tpu_torch.ops import gather, gather2d

    R, NI = 1 << 13, 1 << 20
    SB = NI // 128
    tnp = rng.integers(0, 1 << 30, (R, 128), dtype=np.int32)
    # balanced residues by construction (NI/128 indices per lane class,
    # randomly interleaved), as in the reference
    rows1 = rng.integers(0, R, (NI,), dtype=np.int32)
    res1 = np.repeat(np.arange(128, dtype=np.int32), NI // 128)
    rng.shuffle(res1)
    i_np = rows1 * 128 + res1
    t2, i = p.tensor(tnp), p.tensor(i_np)
    flat, i64 = t2.reshape(-1), i.long()
    want = tnp.reshape(-1)[i_np]
    nbytes = take_bytes(flat.numel(), i)
    take = lambda: torch.take(flat, i64)  # noqa: E731

    p.case("P2_take_1d", take, lambda: gather.gather_clip_plain(flat, i),
           want, nbytes, NI, library=take, kernel="library")
    p.case("P2_K1", lambda: gather.gather_clip(flat, i),
           lambda: gather.gather_clip_plain(flat, i), want, nbytes, NI,
           library=take, kernel="K1")

    lanes = np.arange(128, dtype=np.int32)[None, :]
    e_np = rng.integers(0, R, (SB, 128), dtype=np.int32) * 128 + lanes
    e = p.tensor(e_np)
    e64 = e.long()
    p.case("P2_E_kernel_only", lambda: gather2d.take_along(t2, e, 0, 7),
           lambda: gather2d.take_along_plain(t2, e, 0, 7),
           tnp.reshape(-1)[e_np], along_bytes(t2, e, 0, 7), NI,
           library=lambda: torch.take(t2, e64), kernel="K3",
           plan=lambda: _along_plan(e),
           sector_bytes=sector_bytes(t2, e, 0, 7))

    order_np = np.argsort(i_np & 127, kind="stable")
    order = p.tensor(order_np)
    p.case("P2_E_with_router", lambda: route(t2, i)[0],
           lambda: torch.take(flat, i64[order]), want[order_np], nbytes,
           NI, library=take, kernel="K3")
    p.case("P2_E_router_unroute", lambda: unroute(*route(t2, i)),
           take, want, nbytes, NI, library=take, kernel="K3")


def variant3(p: Probe) -> None:
    from sheep_tpu_torch.ops import gather2d

    for R in P3_WIDTHS:
        rng = np.random.default_rng(0)
        x_np = rng.integers(0, 1 << 30, (8, R), dtype=np.int32)
        i_np = rng.integers(0, R, (8, R), dtype=np.int32)
        x, i = p.tensor(x_np), p.tensor(i_np)
        i64 = i.long()
        p.case(f"P3_lane_R{R}", lambda: gather2d.take_along(x, i, 1),
               lambda: gather2d.take_along_plain(x, i, 1),
               np.take_along_axis(x_np, i_np, axis=1), along_bytes(x, i, 1),
               x.numel(), library=lambda: torch.gather(x, 1, i64),
               kernel="K3", lane_extent=R, axis=1,
               plan=lambda: _along_plan(i),
               sector_bytes=sector_bytes(x, i, 1))


def run(variant: int, perf: bool = False, device=None) -> list:
    """Run one variant; print and return its records."""
    p = Probe(device)
    name = torch.cuda.get_device_name(p.dev) if p.cuda else "cpu"
    print(json.dumps({"platform": p.dev.type, "device": name}), flush=True)
    if variant == 1:
        variant1(p)
    elif variant == 2:
        variant2(p, perf)
    elif variant == 3:
        variant3(p)
    else:
        raise ValueError(f"variant must be 1, 2 or 3, got {variant}")
    return p.records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", type=int, default=1, choices=(1, 2, 3))
    ap.add_argument("--perf", action="store_true",
                    help="variant 2: add the P2 throughput legs")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (plain versions, "
                         "semantics only)")
    args = ap.parse_args(argv)
    records = run(args.variant, args.perf, args.device)
    return 0 if records and all(r["ok"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
