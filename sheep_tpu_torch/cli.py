"""Command line of the port (a subset of ``sheep_tpu/cli.py``).

    python -m sheep_tpu_torch.cli --input rmat-hash:16 --k 8 --device cpu

prints the phase times and scores, then one JSON result line (the same
fields as the reference's) as the last line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sheep-torch",
                                description="SHEEP graph partitioning on "
                                            "PyTorch/CUDA")
    p.add_argument("--input", required=True,
                   help="edge-list file or rmat-hash:SCALE[:EF[:SEED]]")
    p.add_argument("--k", type=int, required=True, help="number of parts")
    p.add_argument("--chunk-edges", type=int, default=1 << 22)
    p.add_argument("--dispatch-batch", type=int, default=8, metavar="N",
                   help="chunks folded by one fixpoint execution; 1 needs "
                        "a pipeline depth of 2 or more (--inflight)")
    p.add_argument("--inflight", type=int, default=0, metavar="D",
                   help="fixpoint executions in flight (0 = auto: 2 on "
                        "CUDA, 1 on the CPU)")
    p.add_argument("--h2d-ring", type=int, default=0, metavar="D",
                   help="file chunks staged to the device ahead of use "
                        "(0 = auto: 2 on CUDA, 1 on the CPU)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--output", default=None,
                   help="write the partition map (.parts text or .pbin)")
    p.add_argument("--json", action="store_true",
                   help="print only the JSON result line")
    args = p.parse_args(argv)
    if args.inflight < 0:
        p.error("--inflight must be >= 0 (0 = auto)")
    if args.h2d_ring < 0:
        p.error("--h2d-ring must be >= 0 (0 = auto)")

    import sheep_tpu_torch
    from sheep_tpu_torch.io import formats

    t0 = time.perf_counter()
    res = sheep_tpu_torch.partition(args.input, args.k, device=args.device,
                                    chunk_edges=args.chunk_edges,
                                    dispatch_batch=args.dispatch_batch,
                                    inflight=args.inflight,
                                    h2d_ring=args.h2d_ring)
    wall = time.perf_counter() - t0
    if args.output:
        formats.write_partition(args.output, res.assignment)
    m = res.total_edges
    n = len(res.assignment)
    if not args.json:
        print(f"graph: {args.input}  V={n:,}  E={m:,}")
        print(f"backend: {res.backend}  k={res.k}")
        for phase, secs in res.phase_times.items():
            print(f"  {phase:>16}: {secs:.3f}s")
        print(f"k={res.k}: edge cut {res.edge_cut:,} "
              f"({100 * res.cut_ratio:.2f}%)  balance {res.balance:.4f}"
              + (f"  comm volume {res.comm_volume:,}"
                 if res.comm_volume is not None else ""))
        if args.output:
            print(f"partition map written to {args.output}")
        print(f"wall: {wall:.2f}s")
    summary = res.summary()
    summary["wall_seconds"] = round(wall, 4)
    summary["edges_per_sec"] = round(m / wall, 1) if wall > 0 else None
    summary["n_vertices"] = n
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
