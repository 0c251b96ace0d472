"""The sharded multi-device backend, ``torch-sharded`` (counterpart of
``sheep_tpu/backends/tpu_sharded_backend.py``).

Edge chunks go round-robin over the shards of a mesh
(``parallel/mesh.py``), each shard builds a forest with the port's
kernels, the forests are merged by the butterfly and the score is summed
(``parallel/pipeline.py``, ``ShardedPipeline.run``). On a mesh of one
shard the result equals the single-device ``torch`` backend's.
Incremental epochs fold through the same per-shard machinery
(:meth:`TorchShardedBackend._fold_delta`), and a scored epoch rescores
the moved vertices' arcs over the shards with one reduction
(:meth:`TorchShardedBackend._move_rescore`).
"""

from __future__ import annotations

import numpy as np

from sheep_tpu_torch.backends.torch_backend import (
    TorchBackend, pad_chunk, resolve_dispatch_batch, resolve_inflight)
from sheep_tpu_torch.device import resolve_device
from sheep_tpu_torch.parallel.mesh import shards_mesh
from sheep_tpu_torch.parallel.pipeline import ShardedPipeline
from sheep_tpu_torch.types import (PartitionResult, check_vertex_range,
                                   refuse_anchored)


class TorchShardedBackend:
    name = "torch-sharded"
    supports_checkpoint = True
    supports_multidevice = True
    supports_incremental = True

    def __init__(self, chunk_edges: int = 1 << 22, lift_levels: int = 0,
                 alpha: float = 1.0, n_devices: int | None = None,
                 segment_rounds: int = 32, warm_schedule=((1, 8),),
                 dispatch_batch: int = 0, inflight: int = 0, device=None,
                 mesh=None):
        """The reference's knobs and defaults. ``n_devices`` shards on
        ``device`` (None: CUDA, one GPU a shard; ``"cpu"``: the virtual
        shards of ``mesh.force_cpu_devices``), or an explicit ``mesh``
        (several shards may share a card). ``dispatch_batch`` and
        ``inflight`` of 0 are auto: 1 and 1 on the CPU; on CUDA N from a
        card's memory (one shard a card) and depth 2."""
        if dispatch_batch < 0:
            raise ValueError("dispatch_batch must be >= 0 (0 = auto)")
        if inflight < 0:
            raise ValueError("inflight must be >= 0 (0 = auto)")
        self.chunk_edges = chunk_edges
        self.lift_levels = lift_levels
        self.alpha = alpha
        self.n_devices = n_devices
        self.segment_rounds = segment_rounds
        self.warm_schedule = tuple(warm_schedule)
        self.dispatch_batch = dispatch_batch
        self.inflight = inflight
        self.device = resolve_device(device if mesh is None else mesh[0])
        self._mesh = mesh

    def mesh(self):
        return self._mesh if self._mesh is not None \
            else shards_mesh(self.n_devices, device=self.device)

    def partition(self, stream, k: int, weights: str = "unit",
                  comm_volume: bool = True, checkpointer=None,
                  resume: bool = False, **opts) -> PartitionResult:
        """``keep_tree=True`` keeps the forest (``tree``: parent, pos,
        degrees) for a re-split at another k."""
        mesh = self.mesh()
        refuse_anchored(stream, mesh)
        n = stream.num_vertices
        check_vertex_range(n)
        cs = stream.clamp_chunk_edges(self.chunk_edges, parts=mesh.size)
        inflight = resolve_inflight(self.inflight, self.device)
        # the folds update their buffers in place: the memory model's
        # donation
        nb = resolve_dispatch_batch(self.dispatch_batch, n, cs, self.device,
                                    inflight=inflight, donate=True)
        pipe = ShardedPipeline(n, cs, mesh, lift_levels=self.lift_levels,
                               segment_rounds=self.segment_rounds,
                               warm_schedule=self.warm_schedule,
                               dispatch_batch=nb, inflight=inflight)
        timings: dict = {}
        out = pipe.run(stream, k, alpha=self.alpha, weights=weights,
                       comm_volume=comm_volume, timings=timings,
                       checkpointer=checkpointer, resume=resume)
        return PartitionResult(
            assignment=out["assignment"], k=k, edge_cut=out["edge_cut"],
            total_edges=out["total_edges"],
            cut_ratio=out["edge_cut"] / max(out["total_edges"], 1),
            balance=out["balance"], comm_volume=out["comm_volume"],
            phase_times=timings, backend=f"{self.name}:{self.device.type}",
            diagnostics={k_: (round(v, 3)
                              if (k_.startswith("t_")
                                  or k_.endswith("_ms"))
                              and isinstance(v, float)
                              else v if isinstance(v, (int, float))
                              else str(v))
                         for k_, v in {**out["build_stats"],
                                       **out["merge_stats"]}.items()},
            tree={"parent": np.asarray(out["parent"]), "pos": out["pos"],
                  "deg": out["degrees"]} if opts.get("keep_tree") else None)

    def score_stream(self, stream, assignments: dict,
                     comm_volume: bool = True, weights=None,
                     stats=None) -> dict:
        """{k: (cut, total, balance, comm volume)} of existing assignments
        in one pass (``TorchBackend.score_stream`` on the first shard's
        device)."""
        return TorchBackend(chunk_edges=self.chunk_edges,
                            device=self.mesh()[0]).score_stream(
            stream, assignments, comm_volume=comm_volume, weights=weights,
            stats=stats)

    # one build split at every k, scored in one more pass (the forest
    # kept by partition(keep_tree=True), the extra ks by score_stream)
    partition_multi = TorchBackend.partition_multi

    # -- incremental repartitioning --------------------------------------
    partition_update = TorchBackend.partition_update

    def _update_pipe(self, n: int, m: int) -> ShardedPipeline:
        """The per-segment pipeline of the update path, its chunk width
        the delta's rounded up to a power of two."""
        from sheep_tpu_torch.ops import elim as elim_ops

        cs = elim_ops.pow2_at_least(min(m, self.chunk_edges),
                                    floor=1 << 10)
        return ShardedPipeline(n, cs, self.mesh(),
                               lift_levels=self.lift_levels,
                               segment_rounds=self.segment_rounds,
                               warm_schedule=self.warm_schedule)

    def _fold_delta(self, state, edges) -> None:
        """Fold one epoch's adds into the carried table: shard 0 seeded
        with the converged table (merging is associative and idempotent),
        the delta's chunks round-robin over the shards, the butterfly
        merge back. The same forest as a one-shot build of the delta:
        input under the anchored order."""
        e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if not len(e):
            return
        n = state.n
        pipe = self._update_pipe(n, len(e))
        cs, rows = pipe.cs, pipe.n_local
        stats = state.stats
        order_sent = np.concatenate([state.order,
                                     np.asarray([n], np.int64)])
        pos_sent = np.concatenate([state.pos.astype(np.int32),
                                   np.asarray([n], np.int32)])
        fa = np.full((rows, n + 1), n, np.int32)
        fa[0] = np.asarray(state.minp, np.int32)[order_sent]
        P_all = pipe._rows(fa)
        pos = pipe.put_replicated(pos_sent)
        chunks = [pad_chunk(e[off: off + cs], cs, n)
                  for off in range(0, len(e), cs)]
        sentinel = None
        for g0 in range(0, len(chunks), rows):
            group = chunks[g0: g0 + rows]
            if len(group) < rows:
                if sentinel is None:
                    sentinel = np.full((cs, 2), n, np.int32)
                group = group + [sentinel] * (rows - len(group))
            P_all = pipe.build_step(P_all, pipe.put_batch(np.stack(group)),
                                    pos, stats=stats)
        merged = pipe.merge(P_all, stats=stats, consume=True)
        state.minp = pipe.to_minp(merged, pos).cpu().numpy()
        stats["update_folds"] = stats.get("update_folds", 0) + 1

    def _move_rescore(self, src, dst, prevs, news, masks):
        """The incremental score's rescore of moved vertices' arcs over
        the shards (:func:`sheep_tpu_torch.ops.score.move_rescore_sharded`):
        every k at once, one reduction."""
        from sheep_tpu_torch.ops.score import move_rescore_sharded

        return move_rescore_sharded(src, dst, prevs, news, masks,
                                    self.mesh())
