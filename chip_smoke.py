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
  4. the port on CUDA against the port on the CPU at rmat-hash:16:16:7,
     k=64: forest, assignment and scores exactly equal;
  5. the full-size build rmat-hash:22:16:42 (Graph500 R-MAT, 4,194,304
     vertices, 67,108,864 edges), k=64, chunk 2^23, dispatch batch 8, on
     the card, with the native split: the gather launches of the run are
     counted, and edge cut, total edges and comm volume must equal the JAX
     package's values;
  6. one JSON line listing every kernel with its numbers;
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
    import sheep_tpu_torch
    from sheep_tpu_torch.ops import _build, gather

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
    check(on_gpu.diagnostics["gather_launches"] > 0,
          "the CUDA run launched no K1")
    print(f"parity {spec16} k=64: cuda == cpu (edge_cut {on_gpu.edge_cut}, "
          f"device_rounds {on_gpu.diagnostics['device_rounds']:.0f}; "
          f"wall cuda {t_gpu:.2f}s cpu {t_cpu:.2f}s)", flush=True)

    # 5. the full-size build on the card, through the user's entry point
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gather.reset_launches()
    t0 = time.perf_counter()
    res = sheep_tpu_torch.partition(S22_SPEC, S22_K, device="cuda",
                                    chunk_edges=1 << 23, dispatch_batch=8)
    wall = time.perf_counter() - t0
    launches = gather.LAUNCHES["gather_clip"]
    peak = torch.cuda.max_memory_allocated()
    check(launches > 0, "the main path launched no K1")
    check(launches == res.diagnostics["gather_launches"],
          "launch counter and diagnostics disagree")
    check(len(res.assignment) == 1 << 22, "assignment has the wrong shape")
    check(int(res.assignment.min()) >= 0 and
          int(res.assignment.max()) < S22_K, "part id out of range")
    check(res.edge_cut == S22_EDGE_CUT,
          f"edge_cut {res.edge_cut} != JAX {S22_EDGE_CUT}")
    check(res.total_edges == S22_TOTAL_EDGES,
          f"total_edges {res.total_edges} != JAX {S22_TOTAL_EDGES}")
    check(res.comm_volume == S22_COMM_VOLUME,
          f"comm_volume {res.comm_volume} != JAX {S22_COMM_VOLUME}")
    d = res.diagnostics
    print("s22 " + json.dumps({
        "spec": S22_SPEC, "k": S22_K, "wall_s": wall,
        "phase_s": res.phase_times, "edge_cut": res.edge_cut,
        "total_edges": res.total_edges, "comm_volume": res.comm_volume,
        "balance": res.balance, "device_rounds": d["device_rounds"],
        "host_syncs": d["host_syncs"], "batch_execs": d["batch_execs"],
        "gather_launches": launches, "peak_mem_bytes": peak,
        "split": "native", "split_s": res.phase_times["split"],
        "card": card}), flush=True)

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
              "sheep_tpu/ops/pallas_gather.py:70", cases["climb"], launches,
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}  total {time.perf_counter() - t_all:.1f}s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
