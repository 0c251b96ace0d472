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
    p.add_argument("--dispatch-batch", type=int, default=None, metavar="N",
                   help="chunks folded by one fixpoint execution (0 = "
                        "auto, the default: sized from the card's memory "
                        "on CUDA, 1 on the CPU); at N = 1 and a pipeline "
                        "depth of 1 the per-segment driver runs. Excludes "
                        "--carry-tail/--tail-overlap above 1")
    p.add_argument("--inflight", type=int, default=None, metavar="D",
                   help="fixpoint executions in flight (0 = auto: 2 on "
                        "CUDA, 1 on the CPU). Excludes --carry-tail/"
                        "--tail-overlap above 1")
    p.add_argument("--segment-rounds", type=int, default=None,
                   help="fixpoint rounds a segment (default 2)")
    p.add_argument("--warm-schedule", default=None, metavar="R:L[,R:L...]",
                   help="low-lift warm rounds before full-depth rounds of "
                        "the per-segment driver, e.g. '1:8' (the default) "
                        "or '' to disable")
    p.add_argument("--host-tail-threshold", type=int, default=None,
                   help="hand the fixpoint tail to the native host pass at "
                        "this live-pair count (default: chunk/2 on CUDA, "
                        "auto on the CPU)")
    p.add_argument("--carry-tail", dest="carry_tail", action="store_true",
                   default=None,
                   help="carry each chunk's fixpoint tail into the next "
                        "chunk's fold instead of finishing it on the host")
    p.add_argument("--no-carry-tail", dest="carry_tail",
                   action="store_false",
                   help="finish every chunk's tail on the host (default)")
    p.add_argument("--tail-overlap", dest="tail_overlap",
                   action="store_true", default=None,
                   help="resolve each chunk's tail on the host in a worker "
                        "thread while the device folds the next chunk; the "
                        "resolved links join a later fold (same forest; "
                        "excludes --carry-tail)")
    p.add_argument("--no-tail-overlap", dest="tail_overlap",
                   action="store_false",
                   help="finish each tail before the next chunk (default)")
    p.add_argument("--stale-reuse", type=int, default=None,
                   help="full segments a lifting stack (1 = rebuilt every "
                        "segment)")
    p.add_argument("--lift-levels", type=int, default=None,
                   help="binary-lifting depth of the climb (0 = auto)")
    p.add_argument("--h2d-ring", type=int, default=None, metavar="D",
                   help="file chunks staged to the device ahead of use "
                        "(0 = auto: 2 on CUDA, 1 on the CPU)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--output", default=None,
                   help="write the partition map (.parts text or .pbin)")
    p.add_argument("--json", action="store_true",
                   help="print only the JSON result line")
    args = p.parse_args(argv)
    opts = _build_options(p, args)

    import sheep_tpu_torch
    from sheep_tpu_torch.io import formats

    t0 = time.perf_counter()
    res = sheep_tpu_torch.partition(args.input, args.k, device=args.device,
                                    chunk_edges=args.chunk_edges, **opts)
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


def _parse_warm_schedule(spec: str, parser) -> tuple:
    """'R:L[,R:L...]' -> ((R, L), ...); '' -> (); a malformed spec is a
    usage error (the reference's ``_parse_warm_schedule``)."""
    out = []
    for part in spec.split(","):
        if not part:
            continue
        bits = part.split(":")
        if len(bits) != 2 or not all(b.isdigit() for b in bits):
            parser.error(f"--warm-schedule: expected R:L pairs, got {part!r}")
        rounds, levels = int(bits[0]), int(bits[1])
        if rounds < 1 or levels < 1:
            parser.error(f"--warm-schedule: R and L must be >= 1 in {part!r}")
        out.append((rounds, levels))
    return tuple(out)


def _build_options(parser, args) -> dict:
    """The build's keywords for :func:`sheep_tpu_torch.partition` from the
    flags given (a flag left out keeps the backend's default), checked as
    the reference's CLI checks them."""
    if args.carry_tail and args.tail_overlap:
        parser.error("--carry-tail and --tail-overlap are mutually "
                     "exclusive tail strategies")
    opts = {}
    for name in ("segment_rounds", "host_tail_threshold", "carry_tail",
                 "tail_overlap"):
        if getattr(args, name) is not None:
            opts[name] = getattr(args, name)
    if args.warm_schedule is not None:
        opts["warm_schedule"] = _parse_warm_schedule(args.warm_schedule,
                                                    parser)
    for name, flag, low in (("stale_reuse", "--stale-reuse", 1),
                            ("lift_levels", "--lift-levels", 0),
                            ("h2d_ring", "--h2d-ring", 0)):
        value = getattr(args, name)
        if value is not None:
            if value < low:
                parser.error(f"{flag} must be >= {low}"
                             + (" (0 = auto)" if name == "h2d_ring" else ""))
            opts[name] = value
    tails = args.carry_tail or args.tail_overlap
    for name, flag, why in (
            ("dispatch_batch", "--dispatch-batch",
             "folds whole segments on device"),
            ("inflight", "--inflight", "pipelines whole batched executions")):
        value = getattr(args, name)
        if value is not None:
            if value < 0:
                parser.error(f"{flag} must be >= 0 (0 = auto)")
            if value > 1 and tails:
                parser.error(f"{flag} > 1 {why}; it excludes --carry-tail/"
                             f"--tail-overlap")
            opts[name] = value
    return opts


if __name__ == "__main__":
    sys.exit(main())
