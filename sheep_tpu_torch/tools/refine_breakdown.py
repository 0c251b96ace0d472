"""Where one call of the neighbour histogram spends its device time.

    python -m sheep_tpu_torch.tools.refine_breakdown

``neighbor_hist_chunk`` is four kernels on the caller's stream (the
bucket count, the scan, the scatter and the tiled or hashed apply,
``csrc/refine.cu``). For one 2^22-edge chunk of sbm-hash:22:64:0.05:16:42
under a random assignment at k = 8 and 64 and under its planted partition
at k = 64 and 8, and one of rmat-hash:22:16:42 at k = 8 and 64 (the
phase 3g chunks of ``chip_smoke.py``), the tool prints one JSON line a
case: the call's mean device time by CUDA events (``ms``) and each
kernel's mean device ms over ``--calls`` calls by ``torch.profiler``
(``kernels_ms``), with the card's name and power limit. It needs CUDA and
a process of its own: a process that has profiled before may have lost
kernel records. Each result is checked exactly against the plain version
first; the exit code is 0 only when all agree.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else torch.cuda.get_device_name(0)


def kernels_ms(fn, calls: int) -> dict:
    """Mean device ms a call of each kernel ``fn`` launches."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return {name: t / calls for name, t in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("refine_breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    from sheep_tpu_torch.io.generators import RmatHashStream, SbmHashStream
    from sheep_tpu_torch.ops import refine
    from sheep_tpu_torch.tools import gather_smoke as gs

    dev = torch.device("cuda")
    card = _card()
    n = C = 1 << 22
    g = torch.Generator(device=dev).manual_seed(17)
    sbm = SbmHashStream(22, 64, 0.05, 16, 42)
    scratch = refine.HistScratch(C, dev)
    ok = True
    for src, stream, cases in (
            ("sbm", sbm, ((8, ""), (64, ""), (64, "-planted"),
                          (8, "-planted"))),
            ("rmat", RmatHashStream(22, 16, seed=42), ((8, ""), (64, "")))):
        chunk = stream.device_chunk(0, C, n, dev).clone()
        chunk[-4096:] = n
        for k, kind in cases:
            if kind:
                assign = torch.from_numpy(np.concatenate(
                    [sbm.ground_truth(k), np.zeros(1, np.int32)])).to(dev)
            else:
                assign = torch.randint(0, k, (n + 1,), device=dev,
                                       generator=g, dtype=torch.int32)
            hist = torch.zeros((n + 1, k), dtype=torch.int32, device=dev)
            want = torch.zeros_like(hist)

            def call():
                refine.neighbor_hist_chunk(hist, chunk, assign, n, k,
                                           scratch=scratch)
            call()
            refine.neighbor_hist_plain(want, chunk, assign, n, k)
            same = bool(torch.equal(hist, want))
            ok &= same
            del want
            print(json.dumps({
                "case": f"{src}-k{k}{kind}", "ok": same,
                "ms": gs.time_ms(call),
                "kernels_ms": kernels_ms(call, args.calls), "card": card}),
                flush=True)
            del hist
            torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
