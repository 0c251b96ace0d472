"""Command line of the port (a subset of ``sheep_tpu/cli.py``).

    python -m sheep_tpu_torch.cli --input rmat-hash:16 --k 8 --device cpu
    python -m sheep_tpu_torch.cli --input g.edges.gz --k 8,64 --output g.parts
    python -m sheep_tpu_torch.cli --input g.csr --score-only g.parts
    python -m sheep_tpu_torch.cli --input sbm-hash:16:16:0.05 --k 16 --refine 4
    python -m sheep_tpu_torch.cli --input sbm-hash:16:16:0.05 --k-levels 4,4
    python -m sheep_tpu_torch.cli --input sbm-hash:22:64:0.05 --k 64 \
        --auto-recipe
    python -m sheep_tpu_torch.cli --input rmat-hash:22 --k 64 \
        --checkpoint-dir ck --resume
    python -m sheep_tpu_torch.cli --input rmat-hash:22 --k 64 \
        --trace t.jsonl --heartbeat-secs 1 --metrics-out m.jsonl
    python -m sheep_tpu_torch.cli --input base.bin64 --k 8 --deltas g.dlog
    python -m sheep_tpu_torch.cli --input rmat-hash:16 --k 8 \
        --backend torch-sharded --n-devices 8 --device cpu
    python -m sheep_tpu_torch.cli --input rmat-hash:16 --k 8 \
        --backend torch-bigv --n-devices 8 --jumps 64 --device cpu
    python -m sheep_tpu_torch.cli --list-backends
    python -m sheep_tpu_torch --input g.edges --k 8 --device cpu \
        --n-devices 4 --coordinator 127.0.0.1:29500 --num-processes 2 \
        --process-id 0     (and --process-id 1 in a second process)
    python -m sheep_tpu_torch.cli serve --socket s.sock --state-dir S \
        [--device cpu]
    python -m sheep_tpu_torch.cli submit --server s.sock \
        --input rmat-hash:16 --k 8 --wait
    python -m sheep_tpu_torch.cli update JOB --server s.sock --deltas g.dlog

prints the phase times and scores, then one JSON result line per k (the
same fields as the reference's) last. ``--trace`` appends the run's
manifest, span tree, heartbeats and scores as JSONL (render it with
``tools/trace_report.py``); ``--profile-dir`` writes a ``torch.profiler``
Chrome trace of the partition.

``--coordinator``/``--num-processes``/``--process-id`` run one process of a
multi-process build (the reference's multi-host flags): every process is
launched with the same flags and its own id, the backend defaults to
``torch-sharded`` (``--n-devices`` counts every process's shards), and
process 0 alone writes the trace, the metrics, the partition map and the
result lines. ``--dist-backend`` names the transport (default: nccl on
CUDA, one card a process; gloo on the CPU; gloo on CUDA lets several
processes share one card).

The verbs ``serve``, ``submit`` and ``update`` are the served engine's
(``sheep_tpu_torch/server/``): the daemon, and its client's submit and
resident-update calls; ``top`` comes with the fleet slice.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from contextlib import contextmanager

from sheep_tpu_torch import BACKENDS, SHARDED_BACKENDS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sheep-torch",
                                description="SHEEP graph partitioning on "
                                            "PyTorch/CUDA")
    p.add_argument("--input",
                   help="edge list (text, .gz text, .bin32/.bin64, .csr) or "
                        "a synthetic spec: rmat-hash:SCALE[:EF[:SEED]], "
                        "rmat:SCALE[:EF[:SEED]], sbm-hash/plsbm-hash/"
                        "bipartite-hash:SCALE:BLOCKS:POUT[:EF[:SEED]], "
                        "nearclique-hash:SCALE:CLIQUE_BITS:POUT[:EF[:SEED]], "
                        "delta:LOG[@EPOCH]")
    p.add_argument("--k", help="number of parts; a comma list (e.g. "
                               "--k 8,64,256) splits one elimination-tree "
                               "build for every k, one result line each")
    p.add_argument("--k-levels", default=None, metavar="K1,K2",
                   help="hierarchical partitioning into K1*K2*... parts: "
                        "partition and refine at K1, then each part's "
                        "induced subgraph at the remaining levels; --refine "
                        "rounds apply at every level (default 8); replaces "
                        "--k")
    p.add_argument("--final-refine", type=int, default=None, metavar="N",
                   help="with --k-levels (or --auto-recipe): N warm-start "
                        "refine rounds at the full k after the hierarchy")
    p.add_argument("--auto-recipe", action="store_true",
                   help="let the quality advisor pick the hierarchy recipe "
                        "when the intra-degree/k signal says flat "
                        "refinement will stall at --k; without it the "
                        "advisor only prints its recommendation")
    p.add_argument("--spill-dir", default=None, metavar="DIR",
                   help="with --k-levels: where each part's intra-edge "
                        "shard spills (default: the system's temporary "
                        "directory); 8 bytes an intra edge of a level")
    p.add_argument("--refine", type=int, default=None, metavar="N",
                   help="up to N rounds of capacity-capped label "
                        "propagation after the build (the cut never gets "
                        "worse); default 0 for flat runs, 8 a level with "
                        "--k-levels")
    p.add_argument("--refine-alpha", type=float, default=1.10,
                   help="refinement balance cap (x ceil(V/k) a part)")
    p.add_argument("--refine-budget-gb", type=float, default=4.0,
                   metavar="GB",
                   help="histogram budget of the refinement: above "
                        "(V+1)*k*4 bytes it takes the histogram in vertex "
                        "blocks, one stream pass each (same result)")
    p.add_argument("--balance", type=float, default=None, metavar="BETA",
                   help="balance bound: runs the split at alpha = BETA - 1 "
                        "(at most 1) and clamps --refine-alpha to BETA; "
                        "with --k-levels, BETA**(1/levels) a level; BETA > "
                        "1, excludes --alpha")
    p.add_argument("--deltas", default=None, metavar="LOG",
                   help="incremental replay: build --input, then fold the "
                        "delta log's epochs (add and tombstone batches) "
                        "into the converged table, each in O(delta); the "
                        "same partition as a one-shot build of the delta: "
                        "input at the last epoch. Single k, flat run")
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
    p.add_argument("--chunk-edges", type=int, default=None,
                   help="edges a streamed chunk (default 2^22; 2^20 with "
                        "--backend torch-bigv)")
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
    p.add_argument("--jumps", type=int, default=None,
                   help="torch-bigv: single-step climbs a tail round "
                        "(default 128)")
    p.add_argument("--hoist-bytes", type=int, default=None,
                   help="torch-bigv: a shard's device bytes for the "
                        "lifting stack built once a segment (0 = squaring "
                        "every round, the default)")
    p.add_argument("--h2d-ring", type=int, default=None, metavar="D",
                   help="file chunks staged to the device ahead of use "
                        "(0 = auto: 2 on CUDA, 1 on the CPU)")
    p.add_argument("--no-cache-chunks", action="store_true",
                   help="disable the device-resident edge-chunk cache "
                        "(each pass re-streams)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save O(V) chunk-level checkpoints to this dir")
    p.add_argument("--checkpoint-every", type=int, default=64,
                   help="checkpoint cadence in chunks (default 64)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in "
                        "--checkpoint-dir")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--backend", choices=list(BACKENDS), default=None,
                   help="torch (the default): the single-device build; "
                        "torch-sharded: the sharded build, edge chunks "
                        "round-robin over --n-devices shards, their forests "
                        "merged by a butterfly; torch-bigv: the "
                        "vertex-sharded build, every vertex table "
                        "block-sharded over --n-devices shards, one "
                        "distributed forest (one GPU a shard on CUDA, "
                        "virtual shards with --device cpu). Left out: "
                        "torch, or torch-bigv on CUDA when the graph's "
                        "vertices pass what the card's memory holds "
                        "replicated")
    p.add_argument("--n-devices", type=int, default=None, metavar="D",
                   help="with --backend torch-sharded or torch-bigv: the "
                        "shards (default: every GPU; with --device cpu, "
                        "1)")
    p.add_argument("--list-backends", action="store_true",
                   help="list the backends and exit")
    from sheep_tpu_torch import __version__

    p.add_argument("--version", action="version",
                   version=f"sheep_tpu_torch {__version__}")
    mh = p.add_argument_group("multi-process (the reference's multi-host "
                              "flags)")
    mh.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="rendezvous address; launch every process with "
                         "the same value")
    mh.add_argument("--num-processes", type=int, default=None,
                    help="processes in the run")
    mh.add_argument("--process-id", type=int, default=None,
                    help="this process's rank in [0, num_processes)")
    mh.add_argument("--dist-backend", choices=["nccl", "gloo"],
                    default=None,
                    help="the processes' transport (default: nccl on "
                         "CUDA, gloo on the CPU; gloo on CUDA stages each "
                         "collective through host memory and lets "
                         "processes share a card)")
    p.add_argument("--output", default=None,
                   help="write the partition map (.parts text or .pbin)")
    p.add_argument("--json", action="store_true",
                   help="print only the JSON result line")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="record the partition under torch.profiler (CPU "
                        "and CUDA activities; CPU only with --device cpu) "
                        "and write its Chrome trace into DIR")
    p.add_argument("--metrics-out", default=None, metavar="FILE",
                   help="append structured JSONL metrics (phases, scores, "
                        "part loads, device memory) to FILE")
    p.add_argument("--trace", default=None, metavar="FILE",
                   help="append a structured trace (JSONL: run manifest, "
                        "span tree with counter deltas, heartbeats, "
                        "scores) to FILE; render with "
                        "tools/trace_report.py")
    p.add_argument("--heartbeat-secs", type=float, default=None,
                   metavar="S",
                   help="with --trace: a progress heartbeat record (phase, "
                        "chunks done, edges/s, ETA, counters, device "
                        "memory) every S seconds, and a final one")
    return p


def _verb(argv):
    """The served engine's verbs, dispatched before the flat grammar as
    the reference's CLI dispatches them: ``serve`` runs the daemon,
    ``submit`` talks to one, ``update JOB ...`` is ``submit --update
    JOB ...``. Returns the exit code, or None for a flat run."""
    verb = argv[0] if argv else None
    if verb == "serve":
        from sheep_tpu_torch.server.daemon import main as daemon_main

        return daemon_main(argv[1:])
    if verb in ("submit", "update"):
        from sheep_tpu_torch.server.client import main as submit_main

        rest = list(argv[1:])
        if verb == "update" and rest and not rest[0].startswith("-"):
            rest = ["--update", rest[0]] + rest[1:]
        return submit_main(rest)
    if verb == "top":
        print("top: the live console comes with the fleet slice of the "
              "port; use `submit --metrics` or GET /metrics meanwhile",
              file=sys.stderr)
        return 2
    return None


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    rc = _verb(argv)
    if rc is not None:
        return rc
    p = build_parser()
    args = p.parse_args(argv)
    if args.heartbeat_secs is not None:
        if args.trace is None:
            p.error("--heartbeat-secs requires --trace (heartbeats are "
                    "trace records)")
        if args.heartbeat_secs <= 0:
            p.error("--heartbeat-secs must be > 0")
    if not _multi_process(args):
        if args.dist_backend is not None:
            p.error("--dist-backend needs --coordinator or "
                    "--num-processes")
        return _traced(p, args)
    from sheep_tpu_torch.parallel.mesh import shutdown_distributed

    _multihost_setup(p, args)
    try:
        return _traced(p, args)
    finally:
        shutdown_distributed()


def _multi_process(args) -> bool:
    return bool(args.coordinator or args.num_processes)


def _is_main() -> bool:
    """Process 0 of the run (the only process of a single-process one)."""
    from sheep_tpu_torch.parallel.mesh import host_shard_info

    return host_shard_info()[0] == 0


def _multihost_setup(p, args) -> None:
    """The processes' bring-up, shared by the flat and --k-levels paths
    (the reference's ``_multihost_setup``): join the group, and default
    --backend to the sharded build."""
    from sheep_tpu_torch.parallel.mesh import init_distributed

    if args.deltas:
        p.error("--coordinator/--num-processes not supported with --deltas "
                "(the incremental replay is flat, single-k, "
                "single-process)")
    if args.num_processes is not None and args.num_processes < 1:
        p.error("--num-processes must be >= 1")
    init_distributed(args.coordinator, args.num_processes, args.process_id,
                     backend=args.dist_backend, device=args.device)
    if args.backend is None:
        args.backend = "torch-sharded"


def _traced(p, args) -> int:
    """The run, traced by process 0 when --trace is given (the other
    processes run untraced: the trace is one file)."""
    if args.trace is None or not _is_main():
        return _run(p, args)

    from sheep_tpu_torch import obs
    from sheep_tpu_torch.device import resolve_device

    # a CUDA run without a card raises here, before the trace starts
    device = resolve_device(args.device)
    tracer = obs.install(obs.Tracer(args.trace))
    root = None
    try:
        # the backend asked for (null when left out, as the reference
        # records it; the backend_resolved event says which runs)
        obs.emit_manifest(tracer, config=vars(args), backend=args.backend,
                          device=device)
        if args.heartbeat_secs:
            tracer.heartbeat = obs.Heartbeat(
                tracer, args.heartbeat_secs, device=device).start()
        root = obs.begin("run")
        return _run(p, args)
    finally:
        if tracer.heartbeat is not None:
            tracer.heartbeat.stop()
        if root is not None:
            root.end()
        obs.uninstall()
        tracer.close()


def _run(p, args) -> int:
    if args.list_backends:
        print(" ".join(BACKENDS))
        return 0
    if args.input is None or (args.k is None and not args.score_only
                              and not args.k_levels):
        p.error("--input and --k are required")
    if args.resume and not args.checkpoint_dir:
        p.error("--resume requires --checkpoint-dir")
    opts = _build_options(p, args)
    if args.backend in SHARDED_BACKENDS:
        _sharded_options(p, args, opts)
    elif args.backend is not None:
        _single_options(p, args)
        if _multi_process(args):
            p.error(f"--backend {args.backend} runs in one process; several "
                    f"take torch-sharded or torch-bigv")
    # the vertex-sharded build's own default, unless given
    chunk_given = args.chunk_edges is not None
    if not chunk_given and args.backend != "torch-bigv":
        args.chunk_edges = 1 << 22
    if args.k_levels:
        if args.score_only:
            p.error("--k-levels does not combine with --score-only")
        if args.auto_recipe:
            p.error("--auto-recipe asks the advisor to pick the levels; it "
                    "replaces --k-levels")
        return _k_levels(p, args)
    if (args.final_refine and not args.auto_recipe) or args.spill_dir:
        p.error("--final-refine/--spill-dir require --k-levels (the flat "
                "pipeline has no hierarchy to repair or spill; "
                "--final-refine also composes with --auto-recipe)")
    if args.auto_recipe and args.score_only:
        p.error("--auto-recipe has no effect with --score-only (nothing is "
                "partitioned)")
    if args.score_only:
        if args.deltas:
            p.error("--deltas does not combine with --score-only (score the "
                    "delta: input spec instead)")
        if args.balance is not None:
            p.error("--balance has no effect with --score-only (the split "
                    "already happened)")
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
    if len(ks) > 1 and (args.checkpoint_dir or args.refine):
        p.error("--k lists do not combine with --checkpoint-dir or "
                "--refine; run those single-k")
    if args.deltas:
        # the replay is flat, single-k and single-process
        bad = [f for f, v in (("--k lists", len(ks) > 1 or None),
                              ("--refine", args.refine),
                              ("--auto-recipe", args.auto_recipe or None),
                              ("--checkpoint-dir", args.checkpoint_dir),
                              ("--resume", args.resume or None)) if v]
        if bad:
            p.error(f"{', '.join(bad)} not supported with --deltas (the "
                    f"incremental replay is flat, single-k, "
                    f"single-process)")
        if not os.path.exists(args.deltas):
            p.error(f"--deltas {args.deltas!r} does not exist")
    if args.auto_recipe and len(ks) > 1:
        p.error("--auto-recipe takes a single --k (the recipe is per "
                "target k)")
    if args.auto_recipe:
        # the applied recipe is a --k-levels run: what it cannot take is
        # refused whatever the input's signal says
        unsupported = _build_flags(args)
        if unsupported:
            p.error(f"{', '.join(unsupported)} not supported with "
                    f"--auto-recipe (the applied recipe is a --k-levels "
                    f"run, which does not take them)")
    if len(ks) == 1:
        applied = _advise(p, args, ks[0])
        if applied is not None:
            return applied

    from sheep_tpu_torch import obs
    from sheep_tpu_torch.device import resolve_device
    from sheep_tpu_torch.io import formats
    from sheep_tpu_torch.types import UnsupportedGraphError

    if args.balance is not None:
        if args.balance <= 1.0:
            p.error("--balance must be > 1 (it bounds max part load at "
                    "BETA * total/k)")
        if args.alpha != 1.0:
            p.error("--balance sets alpha = BETA - 1; do not also pass "
                    "--alpha")
        args.alpha = min(args.balance - 1.0, 1.0)
        if args.refine and args.refine_alpha > args.balance:
            # a looser refine cap would void the bound
            print(f"note: --balance {args.balance} clamps --refine-alpha "
                  f"{args.refine_alpha} to the contract bound",
                  file=sys.stderr)
            args.refine_alpha = args.balance
    device = resolve_device(args.device)
    # auto: --backend left out, resolved here (torch, or the vertex-sharded
    # build where the card's memory picks it), as the reference marks it
    auto = args.backend is None
    if auto:
        args.backend = _auto_backend(args, device)
        if args.backend == "torch-bigv":
            if not chunk_given:
                args.chunk_edges = None
            _sharded_options(p, args, opts)
        else:
            _single_options(p, args)
    run = dict(device=device, chunk_edges=args.chunk_edges,
               weights=args.weights, alpha=args.alpha,
               comm_volume=not args.no_comm_volume, **opts)
    # the manifest records the backend asked for; this event what runs
    obs.event("backend_resolved", backend=args.backend, auto=auto)
    t0 = time.perf_counter()
    try:
        with _profiled(args.profile_dir, device):
            results = _flat(args, ks, run)
    except UnsupportedGraphError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    wall = time.perf_counter() - t0
    res = results[0]
    if not _is_main():
        # process 0 writes the map, the metrics and the result lines
        return 0

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
    if args.metrics_out:
        from sheep_tpu_torch.utils.metrics import (MetricsWriter,
                                                   emit_run_metrics)

        with MetricsWriter(args.metrics_out) as mw:
            for r in results:
                emit_run_metrics(mw, r, n, wall, graph=args.input,
                                 device=device)
    tracer = obs.get_tracer()
    if tracer is not None:
        # the trace is self-contained: the same record set rides in it
        from sheep_tpu_torch.utils.metrics import emit_run_metrics

        for r in results:
            emit_run_metrics(tracer, r, n, wall, graph=args.input,
                             device=device)
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
        print(f"wall: {wall:.2f}s  "
              f"({m / wall if wall > 0 else 0:,.0f} edges/s)")
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


def _flat(args, ks: list, run: dict) -> list:
    """The flat run's results: the --deltas replay, ``partition_multi``
    over a k list, else one partition (from --checkpoint-dir, refined with
    --refine)."""
    import sheep_tpu_torch
    from sheep_tpu_torch.io.edgestream import open_input

    if args.deltas:
        return [_replay(args, ks[0], run)]
    if len(ks) > 1:
        return sheep_tpu_torch.partition_multi(
            args.input, ks, n_vertices=args.num_vertices, **run)
    res = sheep_tpu_torch.partition(
        args.input, ks[0], n_vertices=args.num_vertices,
        **_checkpoint_options(args), **run)
    if args.refine and _is_main():
        # process 0 alone reports, so it alone refines
        # the partition knows n: the stream need not count it again
        with open_input(args.input, n_vertices=len(res.assignment)) as es:
            res = sheep_tpu_torch.refine_result(
                res, es, rounds=args.refine, alpha=args.refine_alpha,
                weights=args.weights,
                budget_bytes=int(args.refine_budget_gb * (1 << 30)),
                device=run["device"])
    return [res]


def _replay(args, k: int, run: dict):
    """--deltas LOG: the base build, each logged epoch past the base's
    folded in unscored, then one refresh (with the comm volume unless
    --no-comm-volume), as the reference's replay."""
    from sheep_tpu_torch import incremental
    from sheep_tpu_torch.backends.torch_backend import TorchBackend
    from sheep_tpu_torch.backends.torch_bigv_backend import TorchBigVBackend
    from sheep_tpu_torch.backends.torch_sharded_backend import \
        TorchShardedBackend
    from sheep_tpu_torch.io.deltalog import DeltaLogReader
    from sheep_tpu_torch.io.edgestream import open_input

    opts = dict(run)
    weights, comm_volume = opts.pop("weights"), opts.pop("comm_volume")
    backend = opts.pop("backend", "torch")
    if backend == "torch-sharded":
        be = TorchShardedBackend(**opts)
    elif backend == "torch-bigv":
        if opts["chunk_edges"] is None:
            del opts["chunk_edges"]
        be = TorchBigVBackend(**opts)
    else:
        opts.pop("n_devices", None)
        be = TorchBackend(**opts)
    with open_input(args.input, n_vertices=args.num_vertices) as es:
        state, _ = incremental.begin_incremental(
            es, k, backend=be, weights=weights, comm_volume=False)
        applied = 0
        for ep, adds, dels in DeltaLogReader(args.deltas).epochs(
                start_epoch=state.epoch):
            be.partition_update(state, adds=adds, deletes=dels, epoch=ep,
                                score=False)
            applied += 1
        res = incremental.refresh(be, state, comm_volume=comm_volume)
    if not args.json:
        print(f"deltas: applied {applied} epoch(s) from {args.deltas} -> "
              f"epoch {state.epoch} (stale deletes {state.stale_deletes}, "
              f"compactions {state.compactions})")
    return res


@contextmanager
def _profiled(profile_dir, device):
    """--profile-dir: the block under ``torch.profiler`` (CPU and CUDA
    activities, CPU alone on a CPU device), its Chrome trace written into
    ``profile_dir`` as ``sheep_torch.<pid>.pt.trace.json`` when the block
    returns. A CUDA run whose profile holds no device record raises: the
    profiler could not trace the card, and the run does not pass for a
    profiled one."""
    if not profile_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    if device.type == "cuda" and not any(
            e.device_type == torch.autograd.DeviceType.CUDA
            for e in prof.events()):
        raise RuntimeError("--profile-dir: torch.profiler recorded no CUDA "
                           "activity; the card could not be traced")
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"sheep_torch.{os.getpid()}.pt.trace.json"))


# the flags a --k-levels run refuses rather than ignores: the metrics and
# the profile of a flat run, and the build's
_BUILD_FLAGS = (("--metrics-out", "metrics_out"),
                ("--profile-dir", "profile_dir"),
                ("--segment-rounds", "segment_rounds"),
                ("--warm-schedule", "warm_schedule"),
                ("--host-tail-threshold", "host_tail_threshold"),
                ("--no-cache-chunks", "no_cache_chunks"),
                ("--carry-tail", "carry_tail"),
                ("--tail-overlap", "tail_overlap"),
                ("--stale-reuse", "stale_reuse"),
                ("--dispatch-batch", "dispatch_batch"),
                ("--inflight", "inflight"), ("--h2d-ring", "h2d_ring"),
                ("--lift-levels", "lift_levels"), ("--deltas", "deltas"),
                ("--jumps", "jumps"), ("--hoist-bytes", "hoist_bytes"))


def _build_flags(args) -> list:
    # --no-cache-chunks is a store_true flag: False is its default
    values = {**vars(args), "no_cache_chunks": args.no_cache_chunks or None}
    return [flag for flag, name in _BUILD_FLAGS if values[name] is not None]


def _checkpoint_options(args) -> dict:
    """``checkpointer`` and ``resume`` from --checkpoint-dir,
    --checkpoint-every and --resume (none without a directory); each
    process keeps its own manifest in the directory."""
    if not args.checkpoint_dir:
        return {}
    from sheep_tpu_torch.parallel.mesh import host_shard_info
    from sheep_tpu_torch.utils.checkpoint import Checkpointer

    return {"checkpointer": Checkpointer(args.checkpoint_dir,
                                         every=args.checkpoint_every,
                                         process=host_shard_info()[0]),
            "resume": args.resume}


def _k_levels(parser, args) -> int:
    """--k-levels K1,K2,...: the hierarchy
    (:func:`sheep_tpu_torch.partition_hierarchical`), one JSON line."""
    import sheep_tpu_torch
    from sheep_tpu_torch.io import formats

    if args.k is not None:
        parser.error("--k-levels replaces --k")
    if args.balance is not None and args.alpha != 1.0:
        parser.error("--balance sets the per-level alpha (BETA**(1/levels) "
                     "per level); do not also pass --alpha")
    ignored = _build_flags(args)
    if ignored:
        parser.error(f"{', '.join(ignored)} not supported with --k-levels "
                     f"(would be silently ignored)")
    try:
        levels = [int(x) for x in args.k_levels.split(",") if x != ""]
    except ValueError:
        levels = []
    if not levels or any(k < 1 for k in levels):
        parser.error(f"--k-levels must be a comma list of positive ints "
                     f"(got {args.k_levels!r})")
    sharded = {}
    if args.backend in SHARDED_BACKENDS:
        # every level through the sharded build; several processes
        # reconcile a resume collectively
        from sheep_tpu_torch.parallel.mesh import host_shard_info

        sharded = {"backend": args.backend, "n_devices": args.n_devices,
                   "nprocs": host_shard_info()[1]}
    t0 = time.perf_counter()
    res = sheep_tpu_torch.partition_hierarchical(
        args.input, levels, device=args.device,
        refine=8 if args.refine is None else args.refine,
        refine_alpha=args.refine_alpha, chunk_edges=args.chunk_edges,
        comm_volume=not args.no_comm_volume, weights=args.weights,
        balance=args.balance, final_refine=args.final_refine or 0,
        spill_dir=args.spill_dir, n_vertices=args.num_vertices,
        refine_budget_bytes=int(args.refine_budget_gb * (1 << 30)),
        **_checkpoint_options(args), **sharded,
        **({} if args.balance is not None else {"alpha": args.alpha}))
    wall = time.perf_counter() - t0
    if not _is_main():
        return 0
    if args.output:
        formats.write_partition(args.output, res.assignment)
    summary = res.summary()
    summary["wall_seconds"] = round(wall, 4)
    summary["n_vertices"] = int(len(res.assignment))
    from sheep_tpu_torch import obs

    obs.event("scores", **summary)
    if not args.json:
        print(f"graph: {args.input}  k-levels: {levels}")
        print(f"k={res.k}: edge cut {res.edge_cut:,} "
              f"({100 * res.cut_ratio:.2f}%)  balance {res.balance:.4f}"
              + (f"  comm volume {res.comm_volume:,}"
                 if res.comm_volume is not None else ""))
        if args.output:
            print(f"partition map written to {args.output}")
        print(f"wall: {wall:.2f}s")
    print(json.dumps(summary))
    return 0


def _advise(parser, args, k: int):
    """The quality advisor before a single-k flat run: from 2E/V, known in
    O(1) or not at all, it notes on stderr when flat refinement will stall
    at k and what recipe it recommends; with --auto-recipe the run becomes
    that --k-levels run (its exit code is returned), else None."""
    from sheep_tpu_torch.io.edgestream import open_input
    from sheep_tpu_torch.ops.degrees import advise_recipe

    advice = None
    try:
        with open_input(args.input, n_vertices=args.num_vertices) as es0:
            m = es0.num_edges_cheap
            # the vertex count must be O(1) too: synthetic and in-memory
            # streams (no path), .csr headers, or --num-vertices
            cheap_v = (getattr(es0, "path", None) is None
                       or getattr(es0, "fmt", None) == "csr"
                       or getattr(es0, "_n_vertices", None) is not None)
            if m is not None and cheap_v:
                advice = advise_recipe(es0.num_vertices, m, k)
            else:
                advice = {"mode": "unknown", "signal": None, "k": k}
    except (OSError, ValueError):
        pass  # an unopenable input: the run itself raises the real error
    if advice is not None and advice["mode"] == "hier":
        lv = ",".join(str(x) for x in advice["k_levels"])
        # an explicit --final-refine 0 or --balance survives
        fr = advice["final_refine"] if args.final_refine is None \
            else args.final_refine
        bal = args.balance if args.balance is not None \
            else advice["balance"]
        flags = f"--k-levels {lv} --final-refine {fr} --balance {bal}"
        if args.refine is not None:
            flags += f" --refine {args.refine}"
        # the note is process 0's; every process applies the recipe
        if _is_main():
            print(f"note: quality advisor: intra-degree/k signal "
                  f"{advice['signal']:.2f} < {advice['threshold']:.2f} at "
                  f"k={k} — flat label propagation stalls below the signal "
                  f"threshold (BASELINE.md 'SBM quality'); recommended "
                  f"recipe: {flags}"
                  + ("" if args.auto_recipe else
                     "  (pass --auto-recipe to apply)"), file=sys.stderr)
        if args.auto_recipe:
            args.k_levels = lv
            args.k = None
            args.final_refine = fr
            args.balance = bal
            return _k_levels(parser, args)
    elif args.auto_recipe:
        if advice is None or advice.get("signal") is None:
            why = ("the stream's size is not O(1)-knowable (text inputs, "
                   "or binary without --num-vertices), so the signal is "
                   "unknown")
        elif advice["signal"] >= advice["threshold"]:
            why = (f"signal {advice['signal']:.2f} >= "
                   f"{advice['threshold']:.2f} (flat LP is fine)")
        else:
            why = (f"signal {advice['signal']:.2f} is low but k={k} has no "
                   f"usable level split (prime past the per-level cap)")
        if _is_main():
            print(f"note: quality advisor: {why}; running the flat path "
                  f"as asked"
                  + (" (--final-refine only applies when the advisor "
                     "selects a hierarchy; ignored)"
                     if args.final_refine else ""), file=sys.stderr)
    return None


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
    from sheep_tpu_torch import obs

    obs.event("scores", **line)
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


def _single_options(parser, args) -> None:
    """The flags of the sharded backends, refused by the single-device
    build."""
    bad = [flag for flag, on in (("--n-devices", args.n_devices),
                                 ("--jumps", args.jumps),
                                 ("--hoist-bytes", args.hoist_bytes))
           if on is not None]
    if bad:
        parser.error(f"{', '.join(bad)} need --backend "
                     + ("torch-bigv" if bad != ["--n-devices"] else
                        "torch-sharded or torch-bigv"))


def _auto_backend(args, device) -> str:
    """--backend left out: ``torch``, or ``torch-bigv`` on CUDA when the
    input's vertices pass ``membudget.max_vertices_for`` at 0.9 of the
    card's memory and the chunk width (the reference's selection, with a
    note on stderr). The vertex count, when counted here, is kept in
    ``args.num_vertices`` for the run."""
    if device.type != "cuda":
        return "torch"
    from sheep_tpu_torch.backends.torch_backend import device_memory_bytes
    from sheep_tpu_torch.io.edgestream import open_input
    from sheep_tpu_torch.utils.membudget import max_vertices_for

    with open_input(args.input, n_vertices=args.num_vertices) as es:
        n = es.num_vertices
    if args.num_vertices is None and not args.input.startswith("delta:"):
        args.num_vertices = n
    cs = args.chunk_edges or (1 << 22)
    if n <= max_vertices_for(int(0.9 * device_memory_bytes(device)), cs):
        return "torch"
    print(f"note: V={n:,} exceeds the replicated-table ceiling for this "
          f"card's memory; auto-selected the vertex-sharded torch-bigv "
          f"backend", file=sys.stderr)
    return "torch-bigv"


def _sharded_options(parser, args, opts: dict) -> None:
    """Check the flags against --backend torch-sharded or torch-bigv and
    add their keywords to ``opts``: the sharded build takes the batched
    dispatch's knobs, the vertex-sharded build --jumps, --hoist-bytes,
    --segment-rounds and --lift-levels; neither takes the per-segment
    driver's tail strategies or the staging ring, or scores a map (with
    --k-levels every level runs through the backend). With several
    processes --n-devices counts every process's shards: on the CPU each
    process fakes its share."""
    bigv = args.backend == "torch-bigv"
    bad = [flag for flag, on in (
        ("--score-only", args.score_only),
        ("--host-tail-threshold", args.host_tail_threshold is not None),
        ("--carry-tail", args.carry_tail),
        ("--tail-overlap", args.tail_overlap),
        ("--stale-reuse", args.stale_reuse is not None),
        ("--h2d-ring", args.h2d_ring is not None),
        ("--no-cache-chunks", args.no_cache_chunks),
        ("--jumps", not bigv and args.jumps is not None),
        ("--hoist-bytes", not bigv and args.hoist_bytes is not None),
        ("--dispatch-batch", bigv and args.dispatch_batch is not None),
        ("--inflight", bigv and args.inflight is not None),
        ("--warm-schedule", bigv and args.warm_schedule is not None))
        if on]
    if bad:
        parser.error(f"{', '.join(bad)} not supported with --backend "
                     f"{args.backend}")
    for name, flag, low in (("jumps", "--jumps", 1),
                            ("hoist_bytes", "--hoist-bytes", 0)):
        value = getattr(args, name)
        if value is not None:
            if value < low:
                parser.error(f"{flag} must be >= {low}")
            opts[name] = value
    if args.n_devices is not None:
        if args.n_devices < 1:
            parser.error("--n-devices must be >= 1")
        if args.device == "cpu":
            from sheep_tpu_torch.parallel.mesh import (force_cpu_devices,
                                                       host_shard_info)

            # an uneven count raises in shards_mesh, as the reference's
            force_cpu_devices(max(1, args.n_devices // host_shard_info()[1]))
    # --no-carry-tail / --no-tail-overlap leave a False behind
    for name in ("carry_tail", "tail_overlap"):
        opts.pop(name, None)
    opts["backend"] = args.backend
    opts["n_devices"] = args.n_devices


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
    if args.no_cache_chunks:
        opts["cache_chunks"] = False
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
