"""Single-device PyTorch backend (counterpart of ``TpuBackend.partition`` in
``sheep_tpu/backends/tpu_backend.py``, its batched segment dispatch only).

  degrees   scatter-add per chunk, int64 on the device
  sort      stable argsort of the degrees -> pos / order
  build     batched fixpoint over [N, C] position blocks, depth 1
  split     tree split on the host
  score     per-chunk cut counts and comm-volume keys

Chunks are padded to a fixed (C, 2) shape with the sentinel vertex n, and
the last group of ``dispatch_batch`` chunks is filled with all-sentinel
chunks as the reference stages it, so the fixpoint runs the same rounds.
Streams that can synthesize chunks on the device (``device_chunk``) do so;
others are read on the host, padded and copied over.
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
from sheep_tpu_torch.types import PartitionResult, check_vertex_range


def pad_chunk(chunk: np.ndarray, size: int, n: int) -> np.ndarray:
    """Pad a (c, 2) chunk to (size, 2) int32 with the sentinel vertex n."""
    c = np.asarray(chunk, dtype=np.int64)
    if np.any(c >= np.iinfo(np.int32).max):
        raise ValueError("vertex id >= 2^31 in chunk; ids must fit int32")
    out = np.full((size, 2), n, dtype=np.int32)
    out[: len(c)] = c
    return out


def device_chunks(stream, cs: int, n: int, device):
    """Padded (cs, 2) int32 chunks on ``device``, in stream order."""
    if hasattr(stream, "device_chunk"):
        for i in range(stream.num_chunks(cs)):
            yield stream.device_chunk(i, cs, n, device)
        return
    for c in stream.chunks(cs):
        yield torch.from_numpy(pad_chunk(c, cs, n)).to(device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TorchBackend:
    name = "torch"

    def __init__(self, chunk_edges: int = 1 << 23, dispatch_batch: int = 8,
                 alpha: float = 1.0, device=None):
        if dispatch_batch < 1:
            raise ValueError("dispatch_batch must be >= 1")
        self.chunk_edges = int(chunk_edges)
        self.dispatch_batch = int(dispatch_batch)
        self.alpha = alpha
        self.device = resolve_device(device)

    def _staged_groups(self, stream, cs: int, n: int, pos: torch.Tensor):
        """[N, C] oriented position blocks, one per group of N chunks; the
        last group is filled with all-sentinel chunks."""
        N, dev = self.dispatch_batch, self.device
        group: list = []
        for chunk in device_chunks(stream, cs, n, dev):
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
                  comm_volume: bool = True,
                  keep_tree: bool = False) -> PartitionResult:
        dev = self.device
        t = {}
        cs = stream.clamp_chunk_edges(self.chunk_edges)
        t0 = time.perf_counter()
        n = stream.num_vertices
        check_vertex_range(n)

        deg = degrees_ops.init_degrees(n, dev)
        for chunk in device_chunks(stream, cs, n, dev):
            degrees_ops.degree_chunk(deg, chunk, n)
        deg_host = deg[:n].cpu().numpy()
        t["degrees"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        pos, order = order_ops.elimination_order(deg, n)
        del deg
        _sync(dev)
        t["sort"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        stats: dict = {"dispatch_batch": self.dispatch_batch}
        launches0 = {**gather_ops.LAUNCHES, **lift_ops.LAUNCHES}
        P = torch.full((n + 1,), n, dtype=torch.int32, device=dev)
        # the reference's defaults: lift levels from n, and a round budget
        # of 2 rounds per staged chunk for each execution
        P, total_rounds = elim_ops.fold_segments_pipelined(
            P, self._staged_groups(stream, cs, n, pos), n, stats=stats)
        minp = P[pos.long()]
        del P
        _sync(dev)
        launches = {**gather_ops.LAUNCHES, **lift_ops.LAUNCHES}
        for key, name in (("gather_launches", "gather_clip"),
                          ("lift_launches", "lift_stack"),
                          ("climb_launches", "climb_tail")):
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
        for chunk in device_chunks(stream, cs, n, dev):
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
