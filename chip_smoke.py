#!/usr/bin/env python3
"""Smoke run of sheep_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, one result line each; any failure exits non-zero before the last
line is printed:

  1. the card's name and power limit (nvidia-smi);
  2. build every native library of the port from ``sheep_tpu_torch/csrc``
     (the CUDA kernels with nvcc, the host split with the C++ compiler);
  3. kernel K1 (``gather_clip``) against its plain PyTorch version on the
     card, exactly, at the build path's shapes (T = 2^22+1 tables, M = 2^23
     climb and M = T squaring gathers) and a ragged out-of-range case, with
     its time, the plain version's, ``torch.take``'s (timed only, as a
     yardstick) and the bytes bound (``gather_smoke.Probe``);
  3b. gather forms: what the probe tool lacks, in the same way: K3 on a
     row wider than a block's shared memory (R = 65,536), and ragged
     out-of-range cases of K2 and K3 on their scalar paths; then the
     port's probe tool ``gather_smoke``, variants 1-3 with ``--perf``,
     in-process, with the kernels' launches counted: each of its records
     (forms A-E, the P2 legs, the eight P3 widths) holds its kernel
     exactly against the plain version and is timed, and every record
     must be ok;
  3c. the round's lifting kernels (``ops/lift.py``): ``lift_stack`` and
     ``climb_tail`` against their plain PyTorch versions on the card,
     exactly (stack levels, depth, outputs and the control word), at the
     s22 shapes (T = 2^22+1, C = 2^23) on synthetic position-space
     forests (P[p] in (p, n]; one random, one with a chain through half
     the positions) with live-slot shares of 100%, 10% and 1%, each timed
     beside its plain version, ``torch.take(t, t)`` for one squaring
     level, and its bytes bound;
  4. the port on CUDA against the port on the CPU at rmat-hash:16:16:7,
     k=64: forest, assignment and scores exactly equal;
  4b. the same at rmat-hash:14:16:7, k=16, with the table budget set to 0
     so that the fixpoint takes its stream descent (K1 and torch.where a
     level, no lifting kernel);
  5. the full-size build rmat-hash:22:16:42 (Graph500 R-MAT, 4,194,304
     vertices, 67,108,864 edges), k=64, chunk 2^23, dispatch batch 8, on
     the card, with the native split: the launches of K1, ``lift_stack``
     and ``climb_tail`` in the run are counted (K1 at most once a round),
     the rounds' live-slot share and depth are summarized, and edge cut,
     total edges and comm volume must equal the JAX package's values;
  5b. one more phase 3c case at the main path's median depth and median
     live share (a path laid through the forest for that depth);
  6. one JSON line listing every kernel with its numbers, the lifting
     kernels at the case of 5b;
  7. the last line, {"ok": true, "device": {...}}.

Without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# The JAX package's values for the full-size build, from its cpu backend:
#   JAX_PLATFORMS=cpu python -c 'import sheep_tpu; print(sheep_tpu.partition(
#       "rmat-hash:22:16:42", 64, backend="cpu").summary())'
S22_SPEC, S22_K = "rmat-hash:22:16:42", 64
S22_EDGE_CUT = 62191637
S22_TOTAL_EDGES = 67107073
S22_COMM_VOLUME = 18440186


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def gathers(card):
    """Phases 3 and 3b: every gather kernel against its plain version on
    the card, exactly, each case timed (``gather_smoke.Probe``); then the
    probe tool, its launches counted. Returns the records by case and the
    tool's launches by kernel."""
    import torch

    from sheep_tpu_torch.ops import gather, gather2d
    from sheep_tpu_torch.tools import gather_smoke as gs

    p = gs.Probe("cuda")
    g = torch.Generator().manual_seed(11)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int32).cuda()

    def passed(rec):
        check(rec["built"] and rec["ok"],
              f"{rec['kernel']} {rec['form']} did not launch or disagrees "
              f"with its plain version: {rec}")
        return rec

    def k1(name, T, M, lo, hi):
        table, idx = ints(0, T, (T,)), ints(lo, hi, (M,))
        lib = None
        if lo >= 0 and hi <= T:  # torch.take does not clip
            idx64 = idx.long()
            lib = lambda: torch.take(table, idx64)  # noqa: E731
        return passed(p.case(
            name, lambda: gather.gather_clip(table, idx),
            lambda: gather.gather_clip_plain(table, idx), None,
            gs.take_bytes(T, idx), M, library=lib, kernel="K1", T=T, M=M))

    def k3(name, xshape, ishape, axis, shift, lo, hi):
        x, i = ints(0, 1 << 30, xshape), ints(lo, hi, ishape)
        lib = None
        if lo >= 0 and hi <= xshape[axis] and not shift:  # gather: no clip
            i64 = i.long()
            lib = lambda: torch.gather(x, axis, i64)  # noqa: E731
        return passed(p.case(
            name, lambda: gather2d.take_along(x, i, axis, shift),
            lambda: gather2d.take_along_plain(x, i, axis, shift), None,
            gs.along_bytes(x, i, axis, shift), i.numel(), library=lib,
            kernel="K3", axis=axis, shift=shift))

    # 3. K1 at the build path's shapes
    T = (1 << 22) + 1
    k1("climb", T, 1 << 23, 0, T)
    k1("square", T, T, 0, T)
    k1("K1-ragged-out-of-range", 1_000_003, 3_000_001, -500_000, 1_500_000)

    # 3b. what the probe tool does not run: K3 on a row wider than a
    # block's shared memory holds (232,448 bytes on an H100), and ragged
    # out-of-range cases on the scalar paths
    t, i = ints(0, 1 << 30, (1001, 37)), ints(-500, 1500, (3001,))
    passed(p.case("K2-ragged-out-of-range", lambda: gather2d.take_rows(t, i),
                  lambda: gather2d.take_rows_plain(t, i), None,
                  gs.rows_bytes(t, i), i.numel() * 37, kernel="K2"))
    k3("P3_lane_R65536", (8, 65536), (8, 65536), 1, 0, 0, 65536)
    k3("K3-axis0-ragged-out-of-range", (1001, 37), (513, 37), 0, 3, -8000,
       16000)
    k3("K3-axis1-ragged-out-of-range", (7, 999), (7, 1001), 1, 0, -300,
       1300)
    k3("K3-axis1-wide-ragged-out-of-range", (5, 60001), (5, 1003), 1, 0,
       -300, 70000)

    # the probe tool, the path of K2 and K3: its launches are counted
    gather.reset_launches()
    gather2d.reset_launches()
    t0 = time.perf_counter()
    records = []
    for variant in (1, 2, 3):
        records += gs.run(variant, perf=True, device="cuda")
    launches = {"K1": gather.LAUNCHES["gather_clip"],
                "K2": gather2d.LAUNCHES["take_rows"],
                "K3": gather2d.LAUNCHES["take_along"]}
    bad = [r["form"] for r in records if not (r["ok"] and r["built"])]
    check(not bad, f"gather_smoke records not ok: {bad}")
    for name in ("K1", "K2", "K3"):
        check(launches[name] > 0, f"gather_smoke launched no {name}")
    print("gather_smoke " + json.dumps({
        "records": len(records), "all_ok": True, "launches": launches,
        "s": time.perf_counter() - t0, "card": card}), flush=True)
    return {r["form"]: r for r in p.records + records}, launches


def climb_bytes(lo, hi, P, st, d: int, n: int) -> int:
    """The bytes one climb pass must move on these inputs: lo in and two
    outputs back (12 bytes a slot), and 32 bytes for each distinct sector
    that the pass must read of hi (at the live slots), of old_at_lo (at
    the retiring slots) and of each table (P at lo for the live slots,
    then levels d-1 .. 1 and P for the slots that climb)."""
    import torch

    def sectors(j):
        return torch.unique(j >> 3).numel()

    slot = torch.arange(lo.numel(), device=lo.device)
    live = lo != n
    retire = live & (hi == P[lo.long()])
    up = live & ~retire
    reads = sectors(slot[live]) + sectors(slot[retire])
    cur, h = lo[up], hi[up]
    for k in range(d - 1, 0, -1):
        reads += sectors(cur)
        cand = st[k - 1][cur.long()]
        cur = torch.where(cand < h, cand, cur)
    reads += sectors(torch.cat([lo[live], cur]))
    return 12 * lo.numel() + 32 * reads


def chain_for_depth(depth: int, n: int) -> int:
    """The length of a path through the first positions that gives a
    forest of phase 3c the depth ``depth``: 1.5 * 2^(depth-2) hops, so that
    the longest path (the path and a random forest's short tail) lies in
    (2^(depth-2), 2^(depth-1)] and d - 1 = ceil(log2) of it. The random
    forest alone gives d of 8-10, so below 11 no path is laid."""
    return min(3 << (depth - 3), n - 1) if depth >= 11 else 0


def lifts(card, cases, n: int = 1 << 22, C: int = 1 << 23,
          dev: str = "cuda"):
    """Phase 3c: ``lift_stack`` and ``climb_tail`` against their plain
    versions on the card, exactly, at the s22 shapes (the defaults), each
    case timed with its bound. ``cases`` holds (name, path length, live
    share): a random position-space forest (P[p] in (p, n]) with a path
    through its first positions, and slots with that share live. Returns
    the records."""
    import torch

    from sheep_tpu_torch.ops import lift
    from sheep_tpu_torch.ops.gather import gather_clip_plain
    from sheep_tpu_torch.tools import gather_smoke as gs

    T, L = n + 1, n.bit_length()
    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(13)

    def forest(path):
        p = torch.arange(n, device=dev)
        step = torch.empty(n, device=dev).geometric_(1 / 50, generator=g)
        P = torch.minimum(p + step.long(), torch.tensor(n, device=dev))
        P[torch.rand(n, device=dev, generator=g) < 0.1] = n
        P[:max(path - 1, 0)] = torch.arange(1, max(path, 1), device=dev)
        return torch.cat([P, torch.tensor([n], device=dev)]).int()

    def slots(share):
        lo = torch.randint(0, n - 1, (C,), device=dev, generator=g)
        u = torch.rand(C, device=dev, generator=g, dtype=torch.float64)
        hi = lo + 1 + (u * (n - 1 - lo)).long()
        dead = torch.rand(C, device=dev, generator=g) >= share
        lo[dead] = n
        hi[dead] = n
        return lo.int(), hi.int()

    records = []
    for name, path, share in cases:
        P0 = forest(path)
        lo, hi = slots(share)
        old = gather_clip_plain(P0, lo)
        P = P0.clone()
        P.scatter_reduce_(0, lo.long(), hi, reduce="amin",
                          include_self=True)
        st, d = lift.lift_stack_plain(P, L)
        p_lo, p_hi, ch, ret, live = lift.climb_tail_plain(
            lo, hi, old, P, st, d)
        want_ctl = [d - 1, int(ch), int(ret), int(live)]
        rec = {"case": name, "T": T, "C": C, "L": L, "path": path,
               "share": share, "depth": d, "live": int(live),
               "retired": int(ret)}
        stack = lift.new_stack(T, L, dev)
        ctl = lift.new_ctl(dev)
        lift.lift_stack(P, stack, ctl)
        out_lo, out_hi = lift.climb_tail(lo, hi, old, P, stack, ctl)
        torch.cuda.synchronize()
        errs = [int((stack[:d - 1, :T].long() - st[:d - 1].long())
                    .abs().max()) if d > 1 else 0,
                int((out_lo.long() - p_lo.long()).abs().max()),
                int((out_hi.long() - p_hi.long()).abs().max())]
        rec["max_abs_err"] = max(errs)
        check(max(errs) == 0 and ctl.tolist() == want_ctl,
              f"{name}: kernels disagree with their plain versions "
              f"(errors {errs}, ctl {ctl.tolist()} != {want_ctl})")
        rec["lift_ms"] = gs.time_ms(lambda: lift.lift_stack(P, stack, ctl))
        # the ladders left ctl at this case's rows; the climbs add to it
        rec["climb_ms"] = gs.time_ms(
            lambda: lift.climb_tail(lo, hi, old, P, stack, ctl))
        del stack
        rec["lift_plain_ms"] = gs.time_ms(
            lambda: lift.lift_stack_plain(P, L), iters=3)
        rec["climb_plain_ms"] = gs.time_ms(
            lambda: lift.climb_tail_plain(lo, hi, old, P, st, d), iters=5)
        P64 = P.long()
        rec["take_level_ms"] = gs.time_ms(lambda: torch.take(P, P64))
        rec["lift_bound_ms"] = gs.bound_ms(4 * T * (1 + min(d, L - 1)))
        rec["climb_bound_ms"] = gs.bound_ms(climb_bytes(lo, hi, P, st, d, n))
        rec["card"] = card
        print("lift " + json.dumps(rec), flush=True)
        records.append(rec)
    return records


def lift_entries(head, cases, launches) -> list:
    """The kernels-line entries of ``lift_stack`` and ``climb_tail``: each
    at ``head``, the phase 3c case at the main path's median depth and
    median live share, the other cases beside it; launches from the main
    path."""
    out = []
    for name, replaces, lib_key in (
            ("lift_stack", "sheep_tpu/ops/elim.py:295", "take_level_ms"),
            ("climb_tail", "sheep_tpu/ops/elim.py:128", None)):
        key = name.split("_")[0]
        out.append({
            "name": name, "route": "cuda",
            "source": "sheep_tpu_torch/csrc/lift.cu", "replaces": replaces,
            "also_replaces": ["sheep_tpu/ops/pallas_gather.py:70 (B1 in the "
                              + ("squaring)" if key == "lift" else
                                 "climb)")],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": head[f"{key}_ms"], "plain_ms": head[f"{key}_plain_ms"],
            "bound_ms": head[f"{key}_bound_ms"], "bound_by": "bytes",
            "library_ms": head[lib_key] if lib_key else None,
            "library_scope": "torch.take(t, t), one squaring level"
            if lib_key else None,
            "case": head["case"],
            "cases": {r["case"]: {"ms": r[f"{key}_ms"],
                                  "plain_ms": r[f"{key}_plain_ms"],
                                  "bound_ms": r[f"{key}_bound_ms"],
                                  "depth": r["depth"]}
                      for r in cases}})
    return out


def same_result(a, b, what: str) -> None:
    import numpy as np

    check(np.array_equal(a.tree["parent"], b.tree["parent"]),
          f"{what}: forests differ")
    check(np.array_equal(a.assignment, b.assignment),
          f"{what}: assignments differ")
    for key in ("edge_cut", "total_edges", "comm_volume", "balance"):
        check(getattr(a, key) == getattr(b, key), f"{what}: {key} differs")
    check(a.diagnostics["device_rounds"] == b.diagnostics["device_rounds"],
          f"{what}: device_rounds differ")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 2
    import statistics

    import sheep_tpu_torch
    from sheep_tpu_torch.ops import _build, elim, gather, lift

    t_all = time.perf_counter()
    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f}s "
          f"({_build.build_dir()})", flush=True)

    # 3, 3b. the gather kernels against their plain versions, and the
    # probe tool
    cases, tool_launches = gathers(card)

    # 3c. the round's lifting kernels against their plain versions
    n22 = 1 << 22
    lift_cases = lifts(card, [
        (f"{kind}-live{share:g}", path, share)
        for kind, path in (("random", 0), ("chain", n22 // 2))
        for share in (1.0, 0.1, 0.01)])

    # 4. the port on CUDA against the port on the CPU
    spec16 = "rmat-hash:16:16:7"
    opts = dict(chunk_edges=1 << 17, dispatch_batch=3, keep_tree=True)
    t0 = time.perf_counter()
    on_gpu = sheep_tpu_torch.partition(spec16, 64, device="cuda", **opts)
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = sheep_tpu_torch.partition(spec16, 64, device="cpu", **opts)
    t_cpu = time.perf_counter() - t0
    same_result(on_gpu, on_cpu, spec16)
    for key in ("gather_launches", "lift_launches", "climb_launches"):
        check(on_gpu.diagnostics[key] > 0, f"the CUDA run has no {key}")
    print(f"parity {spec16} k=64: cuda == cpu (edge_cut {on_gpu.edge_cut}, "
          f"device_rounds {on_gpu.diagnostics['device_rounds']:.0f}; "
          f"wall cuda {t_gpu:.2f}s cpu {t_cpu:.2f}s)", flush=True)
    # 4b. the stream descent (K1 and torch.where a level), which the
    # table budget keeps for larger graphs, forced by a budget of 0
    spec14 = "rmat-hash:14:16:7"
    opts = dict(chunk_edges=1 << 15, dispatch_batch=3, keep_tree=True)
    budget, elim.EXACT_TABLE_BYTES = elim.EXACT_TABLE_BYTES, 0
    try:
        on_gpu = sheep_tpu_torch.partition(spec14, 16, device="cuda", **opts)
        on_cpu = sheep_tpu_torch.partition(spec14, 16, device="cpu", **opts)
    finally:
        elim.EXACT_TABLE_BYTES = budget
    same_result(on_gpu, on_cpu, f"{spec14} (stream descent)")
    dg = on_gpu.diagnostics
    check(dg["gather_launches"] > 0 and dg["lift_launches"] == 0 and
          dg["climb_launches"] == 0, "the stream descent's CUDA run did "
          "not go through K1 alone")
    print(f"parity {spec14} k=16, stream descent: cuda == cpu (edge_cut "
          f"{on_gpu.edge_cut}, device_rounds {dg['device_rounds']:.0f}, "
          f"K1 launches {dg['gather_launches']:.0f})", flush=True)

    # 5. the full-size build on the card, through the user's entry point
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gather.reset_launches()
    lift.reset_launches()
    elim.ROUND_LOG = []
    t0 = time.perf_counter()
    res = sheep_tpu_torch.partition(S22_SPEC, S22_K, device="cuda",
                                    chunk_edges=1 << 23, dispatch_batch=8)
    wall = time.perf_counter() - t0
    launches = {"gather_clip": gather.LAUNCHES["gather_clip"],
                **lift.LAUNCHES}
    round_log, elim.ROUND_LOG = elim.ROUND_LOG, None
    peak = torch.cuda.max_memory_allocated()
    d = res.diagnostics
    rounds = int(d["device_rounds"])
    for name, key in (("gather_clip", "gather_launches"),
                      ("lift_stack", "lift_launches"),
                      ("climb_tail", "climb_launches")):
        check(launches[name] > 0, f"the main path launched no {name}")
        check(launches[name] == d[key],
              f"{name}: launch counter and diagnostics disagree")
    check(launches["gather_clip"] <= rounds,
          f"K1 launched {launches['gather_clip']} times in {rounds} rounds")
    check(len(res.assignment) == 1 << 22, "assignment has the wrong shape")
    check(int(res.assignment.min()) >= 0 and
          int(res.assignment.max()) < S22_K, "part id out of range")
    check(res.edge_cut == S22_EDGE_CUT,
          f"edge_cut {res.edge_cut} != JAX {S22_EDGE_CUT}")
    check(res.total_edges == S22_TOTAL_EDGES,
          f"total_edges {res.total_edges} != JAX {S22_TOTAL_EDGES}")
    check(res.comm_volume == S22_COMM_VOLUME,
          f"comm_volume {res.comm_volume} != JAX {S22_COMM_VOLUME}")
    slots = 1 << 23
    check(len(round_log) == rounds, "the round log missed rounds")
    depth_med = statistics.median_low(r[0] for r in round_log)
    share_med = statistics.median_low(r[1] for r in round_log) / slots
    print("s22 " + json.dumps({
        "spec": S22_SPEC, "k": S22_K, "wall_s": wall,
        "phase_s": res.phase_times, "edge_cut": res.edge_cut,
        "total_edges": res.total_edges, "comm_volume": res.comm_volume,
        "balance": res.balance, "device_rounds": d["device_rounds"],
        "host_syncs": d["host_syncs"], "batch_execs": d["batch_execs"],
        "launches": launches, "peak_mem_bytes": peak,
        "live_share_mean": d["live_sum"] / (rounds * slots),
        "live_share_max": d["live_max"] / slots,
        "live_share_median": share_med,
        "depth_mean": d["depth_sum"] / rounds, "depth_max": d["depth_max"],
        "depth_median": depth_med,
        "split": "native", "split_s": res.phase_times["split"],
        "card": card}), flush=True)

    # 5b. the lifting kernels at the main path's median round (phase 3c)
    main_case = lifts(card, [(f"main-d{depth_med}-live{share_med:.3g}",
                              chain_for_depth(depth_med, n22),
                              share_med)])[0]

    # 6. every kernel: K1's launches are the main path's (phase 5), K2's
    # and K3's the probe tool's (phase 3b), their only path
    def entry(name, source, replaces, rec, launches, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": "bytes", "library_ms": rec["library_ms"],
                "case": rec["form"], **extra}

    def max_err(kernel):
        return max(r["max_abs_err"] for r in cases.values()
                   if r["kernel"] == kernel)

    square = cases["square"]
    kernels = [
        entry("gather_clip", "sheep_tpu_torch/csrc/gather.cu",
              "sheep_tpu/ops/pallas_gather.py:70", cases["climb"],
              launches["gather_clip"],
              also_replaces=["tools/pallas_smoke.py:166 (form D)"],
              square_ms=square["ms"], square_bound_ms=square["bound_ms"],
              tool_launches=tool_launches["K1"],
              cases_max_abs_err=max_err("K1")),
        entry("take_rows", "sheep_tpu_torch/csrc/gather2d.cu",
              "tools/pallas_smoke.py:166", cases["A_row_take"],
              tool_launches["K2"], cases_max_abs_err=max_err("K2")),
        entry("take_along", "sheep_tpu_torch/csrc/gather2d.cu",
              "tools/pallas_smoke.py:336", cases["P2_E_kernel_only"],
              tool_launches["K3"],
              also_replaces=["tools/pallas_smoke.py:166 (forms B, C, E)",
                             "tools/pallas_smoke.py:420"],
              cases_max_abs_err=max_err("K3"))]
    kernels += lift_entries(main_case, lift_cases + [main_case], launches)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}  total {time.perf_counter() - t_all:.1f}s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
