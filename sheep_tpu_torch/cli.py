"""Command line of the port (a subset of ``sheep_tpu/cli.py``).

    python -m sheep_tpu_torch.cli --input rmat-hash:16 --k 8 --device cpu
    python -m sheep_tpu_torch.cli --input g.edges.gz --k 8,64 --output g.parts
    python -m sheep_tpu_torch.cli --input g.csr --score-only g.parts

prints the phase times and scores, then one JSON result line per k (the
same fields as the reference's) last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sheep-torch",
                                description="SHEEP graph partitioning on "
                                            "PyTorch/CUDA")
    p.add_argument("--input",
                   help="edge list (text, .gz text, .bin32/.bin64, .csr) or "
                        "a synthetic spec: rmat-hash:SCALE[:EF[:SEED]], "
                        "rmat:SCALE[:EF[:SEED]], sbm-hash/plsbm-hash/"
                        "bipartite-hash:SCALE:BLOCKS:POUT[:EF[:SEED]], "
                        "nearclique-hash:SCALE:CLIQUE_BITS:POUT[:EF[:SEED]]")
    p.add_argument("--k", help="number of parts; a comma list (e.g. "
                               "--k 8,64,256) splits one elimination-tree "
                               "build for every k, one result line each")
    p.add_argument("--score-only", default=None, metavar="PARTS",
                   help="skip partitioning: score this partition map "
                        "(.parts/.pbin) against --input on the device; --k "
                        "is inferred from the map if omitted")
    p.add_argument("--weights", choices=["unit", "degree"], default="unit",
                   help="vertex weights for balance (default unit)")
    p.add_argument("--alpha", type=float, default=1.0,
                   help="bag capacity factor for the tree split (default "
                        "1.0)")
    p.add_argument("--no-comm-volume", action="store_true",
                   help="skip the communication-volume count")
    p.add_argument("--num-vertices", type=int, default=None,
                   help="vertex count if known (skips a counting pass)")
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
    if args.input is None or (args.k is None and not args.score_only):
        p.error("--input and --k are required")
    opts = _build_options(p, args)
    if args.score_only:
        if args.k is not None:
            raw_k = args.k
            try:
                args.k = int(raw_k)
            except ValueError:
                args.k = 0
            if args.k < 1:
                p.error(f"--score-only takes a single positive --k "
                        f"(got {raw_k!r})")
        return _score_only(args, opts.get("h2d_ring", 0))
    try:
        ks = [int(x) for x in str(args.k).split(",") if x != ""]
    except ValueError:
        ks = []
    if not ks or any(k < 1 for k in ks):
        p.error(f"--k must be a positive int or comma list of them "
                f"(got {args.k!r})")
    # a repeated k would alias its output path: keep the first
    ks = list(dict.fromkeys(ks))

    import sheep_tpu_torch
    from sheep_tpu_torch.io import formats
    from sheep_tpu_torch.types import UnsupportedGraphError

    run = dict(device=args.device, chunk_edges=args.chunk_edges,
               weights=args.weights, alpha=args.alpha,
               comm_volume=not args.no_comm_volume,
               n_vertices=args.num_vertices, **opts)
    t0 = time.perf_counter()
    try:
        if len(ks) > 1:
            results = sheep_tpu_torch.partition_multi(args.input, ks, **run)
        else:
            results = [sheep_tpu_torch.partition(args.input, ks[0], **run)]
    except UnsupportedGraphError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    wall = time.perf_counter() - t0
    res = results[0]

    def out_path(k: int) -> str:
        if len(ks) == 1:
            return args.output
        root, ext = os.path.splitext(args.output)
        return f"{root}.k{k}{ext}"

    if args.output:
        for r in results:
            formats.write_partition(out_path(r.k), r.assignment)
    m = res.total_edges
    n = len(res.assignment)
    if not args.json:
        print(f"graph: {args.input}  V={n:,}  E={m:,}")
        print(f"backend: {res.backend}  k={','.join(str(k) for k in ks)}")
        for phase, secs in res.phase_times.items():
            print(f"  {phase:>16}: {secs:.3f}s")
        for r in results:
            print(f"k={r.k}: edge cut {r.edge_cut:,} "
                  f"({100 * r.cut_ratio:.2f}%)  balance {r.balance:.4f}"
                  + (f"  comm volume {r.comm_volume:,}"
                     if r.comm_volume is not None else ""))
            if args.output:
                print(f"partition map written to {out_path(r.k)}")
        print(f"wall: {wall:.2f}s")
    # one JSON line per k, last; a further k carries its marginal cost
    # (its split and share of the scoring pass), the first the rest
    marginal = {r.k: sum(r.phase_times.values()) for r in results[1:]}
    for r in results:
        summary = r.summary()
        r_wall = marginal.get(r.k, wall - sum(marginal.values()))
        summary["wall_seconds"] = round(r_wall, 4)
        summary["edges_per_sec"] = round(m / r_wall, 1) if r_wall > 0 \
            else None
        summary["n_vertices"] = n
        print(json.dumps(summary))
    return 0


def _score_only(args, h2d_ring: int) -> int:
    """--score-only PARTS: the map's cut, total, balance and comm volume
    against the input, scored on the device (the reference's
    ``_score_only``)."""
    from sheep_tpu_torch.backends.torch_backend import (TorchBackend,
                                                        device_chunks)
    from sheep_tpu_torch.io.edgestream import open_input
    from sheep_tpu_torch.io.formats import read_partition
    from sheep_tpu_torch.ops import degrees

    assignment = read_partition(args.score_only)
    be = TorchBackend(chunk_edges=args.chunk_edges, device=args.device,
                      h2d_ring=h2d_ring)
    with open_input(args.input, n_vertices=args.num_vertices) as es:
        n = es.num_vertices
        if len(assignment) != n:
            print(f"error: partition map has {len(assignment)} entries, "
                  f"graph has {n} vertices", file=sys.stderr)
            return 2
        k = args.k if args.k is not None else int(assignment.max()) + 1
        if assignment.min() < 0 or assignment.max() >= k:
            print(f"error: partition map assigns parts outside [0, {k})",
                  file=sys.stderr)
            return 2
        t0 = time.perf_counter()
        w = None
        if args.weights == "degree":
            cs = es.clamp_chunk_edges(args.chunk_edges)
            deg = degrees.init_degrees(n, be.device)
            for chunk in device_chunks(es, cs, n, be.device):
                degrees.degree_chunk(deg, chunk, n)
            w = deg[:n].cpu().numpy()
        cut, total, balance, cv = be.score_stream(
            es, {k: assignment}, comm_volume=not args.no_comm_volume,
            weights=w)[k]
        wall = time.perf_counter() - t0
    line = {"k": k, "edge_cut": cut, "total_edges": total,
            "cut_ratio": cut / max(total, 1), "balance": balance,
            "comm_volume": cv, "backend": "score-only",
            "wall_seconds": round(wall, 4), "n_vertices": n}
    if not args.json:
        print(f"score-only: {args.score_only} vs {args.input}")
        print(f"k={k}: edge cut {cut:,} ({100 * cut / max(total, 1):.2f}%)  "
              f"balance {balance:.4f}"
              + (f"  comm volume {cv:,}" if cv is not None else ""))
    print(json.dumps(line))
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
