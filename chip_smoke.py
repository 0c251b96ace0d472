#!/usr/bin/env python3
"""Smoke run of sheep_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, one result line each; any failure exits non-zero before the last
line is printed:

  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the port from ``sheep_tpu_torch/csrc``;
  3. kernel K1 (``gather_clip``) against its plain PyTorch version on the
     card, exactly, at the build path's shapes (T = 2^22+1 tables, M = 2^23
     climb and M = T squaring gathers) and a ragged out-of-range case, with
     its time, the plain version's, ``torch.take``'s (timed only, as a
     yardstick) and the bytes bound;
  4. the port on CUDA against the port on the CPU at rmat-hash:16:16:7,
     k=64: forest, assignment and scores exactly equal;
  5. the full-size build rmat-hash:22:16:42 (Graph500 R-MAT, 4,194,304
     vertices, 67,108,864 edges), k=64, chunk 2^23, dispatch batch 8, on
     the card: the gather launches of the run are counted, and edge cut,
     total edges and comm volume must equal the JAX package's values;
  6. one JSON line listing every kernel of the path with its numbers;
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

# H100 SXM device memory rate (NVIDIA data sheet), for the bytes bound
HBM_BYTES_PER_S = 3.35e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, iters: int = 50) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls
    after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gather_case(name, T, M, lo, hi, seed):
    """K1 vs the plain version on (T, M), exact; returns the numbers."""
    import torch

    from sheep_tpu_torch.ops import gather

    g = torch.Generator().manual_seed(seed)
    table = torch.randint(0, T, (T,), generator=g,
                          dtype=torch.int32).cuda()
    idx = torch.randint(lo, hi, (M,), generator=g, dtype=torch.int32).cuda()
    out = gather.gather_clip(table, idx)
    ref = gather.gather_clip_plain(table, idx)
    torch.cuda.synchronize()
    err = int((out.long() - ref.long()).abs().max())
    check(err == 0, f"K1 disagrees with the plain gather on {name}")
    ms = time_ms(lambda: gather.gather_clip(table, idx))
    plain_ms = time_ms(lambda: gather.gather_clip_plain(table, idx))
    library_ms = None
    if lo >= 0 and hi <= T:  # torch.take does not clip
        idx64 = idx.long()
        library_ms = time_ms(lambda: torch.take(table, idx64))
    bound_bytes = 4 * M + 4 * M + 4 * T  # idx in, out back, table once
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    rec = {"case": name, "T": T, "M": M, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": "bytes"}
    print("gather " + json.dumps(rec), flush=True)
    return rec


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

    # 3. K1 against its plain version at the build path's shapes
    T = (1 << 22) + 1
    climb = gather_case("climb", T, 1 << 23, 0, T, 1)
    square = gather_case("square", T, T, 0, T, 2)
    gather_case("ragged-out-of-range", 1_000_003, 3_000_001, -500_000,
                1_500_000, 3)

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
        "card": card}), flush=True)

    # 6. every kernel of the path
    kernels = [{
        "name": "gather_clip", "route": "cuda",
        "source": "sheep_tpu_torch/csrc/gather.cu",
        "replaces": "sheep_tpu/ops/pallas_gather.py:70",
        "launches": launches, "max_abs_err": climb["max_abs_err"],
        "ms": climb["ms"], "plain_ms": climb["plain_ms"],
        "bound_ms": climb["bound_ms"], "bound_by": "bytes",
        "library_ms": climb["library_ms"],
        "square_ms": square["ms"], "square_bound_ms": square["bound_ms"]}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}  total {time.perf_counter() - t_all:.1f}s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
