"""Single-device PyTorch backend (counterpart of ``TpuBackend.partition`` in
``sheep_tpu/backends/tpu_backend.py``, its batched segment dispatch only).

  degrees   scatter-add per chunk, int64 on the device
  sort      stable argsort of the degrees -> pos / order
  build     batched fixpoint over [N, C] position blocks, up to
            ``inflight`` executions in flight
  split     tree split on the host
  score     per-chunk cut counts and comm-volume keys

Chunks are padded to a fixed (C, 2) shape with the sentinel vertex n, and
the last group of ``dispatch_batch`` chunks is filled with all-sentinel
chunks as the reference stages it, so the fixpoint runs the same rounds.
Streams that can synthesize chunks on the device (``device_chunk``) do so
and never stage; others are read and padded on a worker thread and copied
over through the staged H2D ring (``utils/prefetch.py``), ``h2d_ring``
blocks ahead. ``inflight`` and ``h2d_ring`` of 0 resolve as the
reference's accelerator defaults: 2 on CUDA, 1 on the CPU.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sheep_tpu_torch.core import pure
from sheep_tpu_torch.device import resolve_device
from sheep_tpu_torch.ops import degrees as degrees_ops
from sheep_tpu_torch.ops import elim as elim_ops
from sheep_tpu_torch.ops import gather as gather_ops
from sheep_tpu_torch.ops import lift as lift_ops
from sheep_tpu_torch.ops import order as order_ops
from sheep_tpu_torch.ops import score as score_ops
from sheep_tpu_torch.ops import split as split_ops
from sheep_tpu_torch.ops import fixpoint as fixpoint_ops
from sheep_tpu_torch.types import PartitionResult, check_vertex_range
from sheep_tpu_torch.utils.prefetch import H2DRing, prefetch


# diagnostics key -> kernel: the build's launches of each kernel
LAUNCH_KEYS = {"gather_launches": "gather_clip",
               "scatter_launches": "scatter_min",
               "lift_launches": "lift_stack",
               "climb_launches": "climb_tail",
               "climb_level_launches": "climb_level",
               "exec_finish_launches": "exec_finish"}


def pad_chunk(chunk: np.ndarray, size: int, n: int) -> np.ndarray:
    """Pad a (c, 2) chunk to (size, 2) int32 with the sentinel vertex n."""
    c = np.asarray(chunk, dtype=np.int64)
    if np.any(c >= np.iinfo(np.int32).max):
        raise ValueError("vertex id >= 2^31 in chunk; ids must fit int32")
    out = np.full((size, 2), n, dtype=np.int32)
    out[: len(c)] = c
    return out


def device_chunks(stream, cs: int, n: int, device, ring: int = 1,
                  stats=None):
    """Padded (cs, 2) int32 chunks on ``device``, in stream order. A
    stream with ``device_chunk`` synthesizes them in place; any other is
    read and padded on a worker thread and staged through an
    :class:`H2DRing` of depth ``ring`` (counters into ``stats``)."""
    if hasattr(stream, "device_chunk"):
        for i in range(stream.num_chunks(cs)):
            yield stream.device_chunk(i, cs, n, device)
        return
    with prefetch(pad_chunk(c, cs, n) for c in stream.chunks(cs)) as pf, \
            H2DRing(pf, device, depth=ring, stats=stats) as staged:
        yield from staged


def resolve_inflight(inflight: int, device) -> int:
    """Pipeline depth: an explicit D >= 1 passes; 0 (auto) is 2 on CUDA
    (one execution running while the previous one's stats word is read)
    and 1 on the CPU, as the reference's ``resolve_inflight``."""
    if inflight != 0:
        return max(1, int(inflight))
    return 2 if torch.device(device).type == "cuda" else 1


def resolve_h2d_ring(h2d_ring: int, device) -> int:
    """Staged H2D ring depth: an explicit D >= 1 passes; 0 (auto) is 2 on
    CUDA and 1 on the CPU, as the reference's ``resolve_h2d_ring``.
    Device streams never stage, whatever this says."""
    if h2d_ring != 0:
        return max(1, int(h2d_ring))
    return 2 if torch.device(device).type == "cuda" else 1


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TorchBackend:
    name = "torch"

    def __init__(self, chunk_edges: int = 1 << 22, dispatch_batch: int = 8,
                 alpha: float = 1.0, device=None, inflight: int = 0,
                 h2d_ring: int = 0):
        if dispatch_batch < 1:
            raise ValueError("dispatch_batch must be >= 1")
        if inflight < 0:
            raise ValueError("inflight must be >= 0 (0 = auto)")
        if h2d_ring < 0:
            raise ValueError("h2d_ring must be >= 0 (0 = auto)")
        self.inflight = int(inflight)
        self.h2d_ring = int(h2d_ring)
        self.chunk_edges = int(chunk_edges)
        self.dispatch_batch = int(dispatch_batch)
        self.alpha = alpha
        self.device = resolve_device(device)

    def _staged_groups(self, chunks, cs: int, n: int, pos: torch.Tensor):
        """[N, C] oriented position blocks, one per group of N chunks; the
        last group is filled with all-sentinel chunks."""
        N, dev = self.dispatch_batch, self.device
        group: list = []
        for chunk in chunks:
            group.append(chunk)
            if len(group) == N:
                yield elim_ops.orient_chunks_batch_pos(
                    torch.stack(group), pos, n)
                group = []
        if group:
            sentinel = torch.full((cs, 2), n, dtype=torch.int32, device=dev)
            group += [sentinel] * (N - len(group))
            yield elim_ops.orient_chunks_batch_pos(torch.stack(group), pos, n)

    def partition(self, stream, k: int, weights: str = "unit",
                  comm_volume: bool = True, keep_tree: bool = False,
                  round_log=None) -> PartitionResult:
        """``round_log``, a list, receives (depth, live slots) of every
        counted fixpoint round, from the executions' device logs."""
        dev = self.device
        inflight = resolve_inflight(self.inflight, dev)
        if self.dispatch_batch == 1 and inflight == 1:
            raise ValueError(
                "dispatch_batch=1 at pipeline depth 1: the reference runs "
                "its adaptive per-segment driver there, which the port does "
                "not have yet; use dispatch_batch >= 2, or inflight >= 2")
        t = {}
        cs = stream.clamp_chunk_edges(self.chunk_edges)
        t0 = time.perf_counter()
        n = stream.num_vertices
        check_vertex_range(n)
        ring = resolve_h2d_ring(self.h2d_ring, dev)
        # one record across the three streaming passes: the ingest
        # counters add up wherever chunks cross, the build adds its own
        stats: dict = {"dispatch_batch": self.dispatch_batch,
                       "inflight_depth": inflight,
                       "h2d_staged_ms": 0.0, "h2d_blocked_ms": 0.0}

        def chunks():
            return device_chunks(stream, cs, n, dev, ring, stats)

        deg = degrees_ops.init_degrees(n, dev)
        for chunk in chunks():
            degrees_ops.degree_chunk(deg, chunk, n)
        deg_host = deg[:n].cpu().numpy()
        t["degrees"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        pos, order = order_ops.elimination_order(deg, n)
        del deg
        _sync(dev)
        t["sort"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        counters = (gather_ops.LAUNCHES, lift_ops.LAUNCHES,
                    fixpoint_ops.LAUNCHES)
        launches0 = {k: v for c in counters for k, v in c.items()}
        P = torch.full((n + 1,), n, dtype=torch.int32, device=dev)
        # the reference's defaults: lift levels from n, and a round budget
        # of 2 rounds per staged chunk for each execution
        groups = chunks()
        staged = self._staged_groups(groups, cs, n, pos)
        try:
            P, total_rounds = elim_ops.fold_segments_pipelined(
                P, staged, n, inflight=inflight, stats=stats,
                round_log=round_log)
        finally:
            # a fold that stops early leaves both generators open: close
            # them, and with them the prefetch worker and the ring
            staged.close()
            groups.close()
        minp = P[pos.long()]
        del P
        _sync(dev)
        launches = {k: v for c in counters for k, v in c.items()}
        for key, name in LAUNCH_KEYS.items():
            stats[key] = launches[name] - launches0[name]
        t["build"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        parent = elim_ops.minp_to_parent(minp, order, n)
        pos_host = pos[:n].cpu().numpy()
        w = deg_host.astype(np.float64) if weights == "degree" else None
        assign_host = split_ops.tree_split_host(parent, pos_host, k,
                                                weights=w, alpha=self.alpha)
        assign = torch.from_numpy(np.concatenate(
            [assign_host.astype(np.int32), np.zeros(1, np.int32)])).to(dev)
        t["split"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        cut = torch.zeros((), dtype=torch.int64, device=dev)
        total = torch.zeros((), dtype=torch.int64, device=dev)
        cv_chunks: list = []
        for chunk in chunks():
            c, tt = score_ops.score_chunk(chunk, assign, n)
            cut += c
            total += tt
            if comm_volume:
                score_ops.accumulate_cv_keys(
                    cv_chunks, score_ops.cut_pair_keys(chunk, assign, n, k))
        cut, total = int(cut), int(total)
        cv = score_ops.comm_volume(cv_chunks) if comm_volume else None
        balance = pure.part_balance(
            assign_host, k, deg_host if weights == "degree" else None)
        t["score"] = time.perf_counter() - t0

        diagnostics = {"fixpoint_rounds": float(total_rounds)}
        diagnostics.update({key: (round(float(v), 3) if key.startswith("t_")
                                  else float(v))
                            for key, v in stats.items()})
        return PartitionResult(
            assignment=assign_host, k=k, edge_cut=cut, total_edges=total,
            cut_ratio=cut / max(total, 1), balance=balance, comm_volume=cv,
            phase_times=t, backend=f"{self.name}:{dev.type}",
            diagnostics=diagnostics,
            tree={"parent": parent, "pos": pos_host, "deg": deg_host}
            if keep_tree else None)
