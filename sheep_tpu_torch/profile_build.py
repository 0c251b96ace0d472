"""Where the device time of one build goes, by kernel name, at each
pipeline depth asked for.

    python -m sheep_tpu_torch.profile_build [--input SPEC] [--k K]
        [--inflight 1,2] [--out DIR]

Runs one partition on CUDA under ``torch.profiler`` for each depth of
``--inflight`` and prints one JSON line: for each depth, the wall and
per-phase seconds, the host reads (``host_syncs``), executions and device
rounds, the launches of each of the port's kernels, the summed device
time by kernel name (top entries, with their call counts), the
device-busy share of the profiled wall and of the fixpoint
(``fixpoint``: from the start of ``fold_segments_pipelined`` on the host
to the end of the last device interval that starts before it returns;
busy time is the union of the kernel and copy intervals there); and the
card's name and power limit. The full tables go to
``DIR/profile_build_d<D>.txt`` when ``--out`` is given. Needs a GPU; the
profiler itself slows the host side, so phase times here are not the
unprofiled ones.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


FIXPOINT = "fixpoint"


def fixpoint_busy(events):
    """Device time, window and busy share of the fixpoint: the host span
    named FIXPOINT, to the end of the last device interval that starts in
    it. The profiler mirrors the span onto the device's timeline; that
    copy is no device work and is left out. None when the trace holds no
    such span or no device interval."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans = [e.time_range for e in events
             if e.name == FIXPOINT and e.device_type != cuda]
    device = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.device_type == cuda and e.name != FIXPOINT
                    and e.time_range.end > e.time_range.start)
    if not spans or not device:
        return None
    start, stop = spans[0].start, spans[0].end
    busy = end = 0.0
    reach = start  # the union of the intervals that start in the span
    for a, b in device:
        if not start <= a <= stop:
            continue
        busy += max(0.0, b - max(a, reach))
        reach = max(reach, b)
        end = max(end, b)
    window = max(end, stop) - start
    return {"window_s": window / 1e6, "device_s": busy / 1e6,
            "busy_share": busy / window if window else 0.0}


def profile_one(args, inflight: int) -> dict:
    """One profiled partition at pipeline depth ``inflight``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import sheep_tpu_torch
    from sheep_tpu_torch.ops import elim, fixpoint, gather, lift, synth

    counters = (gather, lift, fixpoint, synth)
    for c in counters:
        c.reset_launches()
    fold = elim.fold_segments_pipelined

    def marked_fold(*a, **kw):
        with record_function(FIXPOINT):
            return fold(*a, **kw)

    elim.fold_segments_pipelined = marked_fold
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = sheep_tpu_torch.partition(
                args.input, args.k, device="cuda",
                chunk_edges=args.chunk_edges,
                dispatch_batch=args.dispatch_batch, inflight=inflight)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        elim.fold_segments_pipelined = fold
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA
              and e.key != FIXPOINT]
    events.sort(key=lambda e: -e.device_time_total)
    device_us = sum(e.device_time_total for e in events)
    top = [{"name": e.key[:90], "calls": e.count,
            "device_ms": e.device_time_total / 1e3,
            "share": e.device_time_total / device_us if device_us else 0.0}
           for e in events[:args.top]]
    d = res.diagnostics
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"profile_build_d{inflight}.txt"),
                  "w") as f:
            f.write(prof.key_averages().table(
                sort_by="device_time_total", row_limit=60))
    return {"inflight": inflight, "wall_s": wall,
            "phase_s": res.phase_times,
            **{key: d[key] for key in (
                "device_rounds", "rounds_enqueued", "host_syncs",
                "batch_execs", "inflight_discards", "host_blocked_ms",
                "device_gap_ms")},
            "launches": {k: v for c in counters
                         for k, v in c.LAUNCHES.items()},
            "device_ms": device_us / 1e3,
            "device_busy_share": device_us / 1e6 / wall if wall else 0.0,
            "fixpoint": fixpoint_busy(prof.events()),
            "top_kernels": top}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--input", default="rmat-hash:22:16:42")
    p.add_argument("--k", type=int, default=64)
    p.add_argument("--chunk-edges", type=int, default=1 << 23)
    p.add_argument("--dispatch-batch", type=int, default=8)
    p.add_argument("--inflight", default="1,2",
                   help="comma-separated pipeline depths, one run each")
    p.add_argument("--top", type=int, default=12)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from sheep_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("profile_build: no CUDA device", file=sys.stderr)
        return 2
    _build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    runs = [profile_one(args, int(d)) for d in args.inflight.split(",")]
    print(json.dumps({"input": args.input, "k": args.k, "runs": runs,
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
