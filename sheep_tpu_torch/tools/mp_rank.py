"""One process of a multi-process build of the port's sharded backends,
over a list of runs, each written as one JSON record:

    python -m sheep_tpu_torch.tools.mp_rank --coordinator 127.0.0.1:29500 \\
        --num-processes 2 --process-id 0 --dist-backend gloo --shards 2 \\
        --runs '[{"label": "s22", "spec": "rmat-hash:22:16:42", "k": 64}]' \\
        --out rank0.json

Every process of the run is launched with the same flags and its own
``--process-id``; each holds ``--shards`` shards of its card (``cuda:``
``LOCAL_RANK``, else its rank, modulo the visible cards) or of the CPU
(``--device cpu``). A run is a dict: ``label``, ``spec`` (any input of
``open_input``), ``k``, and optionally ``backend`` ("torch-sharded", the
default, or "torch-bigv"), ``chunk_edges``, ``dispatch_batch`` and
``inflight`` (the sharded build's; 1 and 1 by default), ``n_vertices``,
``checkpoint_dir`` with ``every``, ``fault`` (a ``SHEEP_FAULT_INJECT``
spec armed for the run) and ``resume``. The record of a run holds its
wall and phase seconds, edges a second, the scores, SHA-1 digests of the
forest and the assignment, the non-time diagnostics, the kernels' launches
and the peak device memory of this process; a run killed by its injected
fault records ``"fault"``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time


def digest(arr) -> str:
    """SHA-1 of an array's int64 bytes (equal arrays, equal digests)."""
    import numpy as np

    return hashlib.sha1(np.ascontiguousarray(
        np.asarray(arr, dtype=np.int64)).tobytes()).hexdigest()


def _non_time(diag: dict) -> dict:
    """The diagnostics that do not measure time."""
    return {k: v for k, v in sorted(diag.items())
            if isinstance(v, (int, str)) and not isinstance(v, bool)
            and not k.endswith("_ms") and not k.startswith("t_")}


def run_one(run: dict, mesh, process: int) -> dict:
    import torch

    from sheep_tpu_torch.backends.torch_bigv_backend import TorchBigVBackend
    from sheep_tpu_torch.backends.torch_sharded_backend import \
        TorchShardedBackend
    from sheep_tpu_torch.io.edgestream import open_input
    from sheep_tpu_torch.ops import (compact, fixpoint, gather, lift,
                                     routed, synth)
    from sheep_tpu_torch.utils import fault
    from sheep_tpu_torch.utils.checkpoint import Checkpointer

    counters = (gather, lift, fixpoint, compact, synth, routed)
    if run.get("backend", "torch-sharded") == "torch-bigv":
        kw = {"chunk_edges": run["chunk_edges"]} \
            if run.get("chunk_edges") else {}
        be = TorchBigVBackend(mesh=mesh, **kw)
    else:
        be = TorchShardedBackend(
            mesh=mesh, chunk_edges=run.get("chunk_edges", 1 << 22),
            dispatch_batch=run.get("dispatch_batch", 1),
            inflight=run.get("inflight", 1))
    opts = {}
    if run.get("checkpoint_dir"):
        opts = {"checkpointer": Checkpointer(run["checkpoint_dir"],
                                             every=run.get("every", 4),
                                             process=process),
                "resume": bool(run.get("resume"))}
    devices = mesh.distinct()
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
    for c in counters:
        c.reset_launches()
    if run.get("fault"):
        os.environ[fault.ENV_VAR] = run["fault"]
    fault.reset()
    t0 = time.perf_counter()
    try:
        with open_input(run["spec"], n_vertices=run.get("n_vertices")) as s:
            res = be.partition(s, run["k"], keep_tree=True, **opts)
    except fault.InjectedFault:
        return {"outcome": "fault", "wall_s": time.perf_counter() - t0}
    finally:
        os.environ.pop(fault.ENV_VAR, None)
        fault.reset()
    wall = time.perf_counter() - t0
    peak = max((torch.cuda.max_memory_allocated(dev) for dev in devices
                if dev.type == "cuda"), default=0)
    return {
        "outcome": "ok", "backend": res.backend, "wall_s": wall,
        "phase_s": res.phase_times,
        "edges_per_s": res.total_edges / wall if wall > 0 else None,
        "edge_cut": res.edge_cut, "total_edges": res.total_edges,
        "comm_volume": res.comm_volume, "balance": res.balance,
        "parent_sha1": digest(res.tree["parent"]),
        "assignment_sha1": digest(res.assignment),
        "diagnostics": _non_time(res.diagnostics),
        "launches": {k: v for c in counters
                     for k, v in c.LAUNCHES.items()},
        "peak_mem_bytes": peak}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mp_rank", description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--coordinator", required=True, metavar="HOST:PORT")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--shards", type=int, default=1,
                   help="shards of this process (default 1)")
    p.add_argument("--runs", required=True, help="a JSON list of runs")
    p.add_argument("--out", required=True,
                   help="the JSON file of this process's records")
    args = p.parse_args(argv)

    import torch

    from sheep_tpu_torch.device import resolve_device
    from sheep_tpu_torch.parallel import mesh as meshes

    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    dev = resolve_device(args.device)
    meshes.init_distributed(args.coordinator, args.num_processes,
                            args.process_id, backend=args.dist_backend,
                            device=dev)
    try:
        rank, world = meshes.host_shard_info()
        if dev.type == "cuda":
            card = torch.device("cuda", meshes.local_card(rank))
            torch.cuda.set_device(card)
        else:
            card = torch.device("cpu")
        mesh = meshes.Mesh([card] * args.shards, procs=world, proc=rank)
        out = {"process": rank, "processes": world,
               "transport": meshes.transport(), "shards": args.shards,
               "device": str(card), "runs": {}}
        for run in json.loads(args.runs):
            out["runs"][run["label"]] = run_one(run, mesh, rank)
            with open(args.out, "w") as f:
                json.dump(out, f)
            print(f"{run['label']}: {out['runs'][run['label']]['outcome']} "
                  f"{out['runs'][run['label']]['wall_s']:.2f}s", flush=True)
    finally:
        meshes.shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
