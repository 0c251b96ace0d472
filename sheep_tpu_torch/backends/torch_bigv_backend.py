"""The vertex-sharded backend, ``torch-bigv`` (counterpart of
``sheep_tpu/backends/tpu_bigv_backend.py``).

For graphs whose vertex tables do not fit one device: every
vertex-indexed table is block-sharded over the shards of a mesh and the
fixpoint runs as one distributed forest through routed collectives
(``parallel/bigv.py``), O(n / D) table rows a shard. On graphs that fit
one card, ``torch`` and ``torch-sharded`` are faster; the result is the
same. Incremental epochs fold into the one forest
(:meth:`TorchBigVBackend._fold_delta`), and a scored epoch rescores the
moved vertices' arcs over the shards with one reduction
(:meth:`TorchBigVBackend._move_rescore`).
"""

from __future__ import annotations

import numpy as np

from sheep_tpu_torch.backends.torch_backend import TorchBackend, pad_chunk
from sheep_tpu_torch.device import resolve_device
from sheep_tpu_torch.parallel.bigv import BigVPipeline
from sheep_tpu_torch.parallel.mesh import shards_mesh
from sheep_tpu_torch.types import (PartitionResult, check_vertex_range,
                                   refuse_anchored)


class TorchBigVBackend:
    name = "torch-bigv"
    supports_checkpoint = True
    supports_multidevice = True
    supports_incremental = True

    def __init__(self, chunk_edges: int = 1 << 20, alpha: float = 1.0,
                 jumps: int = 128, n_devices: int | None = None,
                 lift_levels: int = 0, segment_rounds: int = 16,
                 hoist_bytes: int | None = None, device=None, mesh=None):
        """The reference's knobs and defaults. ``n_devices`` shards on
        ``device`` (None: CUDA, one GPU a shard; ``"cpu"``: the virtual
        shards of ``mesh.force_cpu_devices``), or an explicit ``mesh``
        (several shards may share a card). ``jumps``: single-step climbs
        a tail round; ``lift_levels`` (0: auto) the bulk rounds' lifting
        depth; ``segment_rounds`` the rounds a segment; ``hoist_bytes`` a
        shard's bytes for the lifting stack built once a segment (None:
        ``SHEEP_BIGV_HOIST_BYTES``, else 0, squaring every round)."""
        self.chunk_edges = chunk_edges
        self.alpha = alpha
        self.jumps = jumps
        self.n_devices = n_devices
        self.lift_levels = lift_levels
        self.segment_rounds = segment_rounds
        self.hoist_bytes = hoist_bytes
        self.device = resolve_device(device if mesh is None else mesh[0])
        self._mesh = mesh

    def mesh(self):
        return self._mesh if self._mesh is not None \
            else shards_mesh(self.n_devices, device=self.device)

    def _pipe(self, n: int, cs: int) -> BigVPipeline:
        return BigVPipeline(n, cs, self.mesh(), jumps=self.jumps,
                            lift_levels=self.lift_levels,
                            segment_rounds=self.segment_rounds,
                            hoist_bytes=self.hoist_bytes)

    def partition(self, stream, k: int, weights: str = "unit",
                  comm_volume: bool = True, checkpointer=None,
                  resume: bool = False, **opts) -> PartitionResult:
        """``keep_tree=True`` keeps the forest (``tree``: parent, pos,
        degrees), which ``partition_multi`` re-splits at every k."""
        mesh = self.mesh()
        refuse_anchored(stream, mesh)
        n = stream.num_vertices
        check_vertex_range(n)
        cs = self.chunk_edges
        m_cheap = stream.num_edges_cheap
        if m_cheap is not None:
            cs = min(cs, max(1024, -(-m_cheap // mesh.size)))
        pipe = self._pipe(n, cs)
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
            diagnostics={"fixpoint_rounds": out["fixpoint_rounds"],
                         # the clamped width that ran
                         "chunk_edges_effective": cs,
                         **out["build_stats"]},
            tree={"parent": out["parent"], "pos": out["pos"],
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

    # one build split at every k, scored in one more pass
    partition_multi = TorchBackend.partition_multi

    # -- incremental repartitioning --------------------------------------
    partition_update = TorchBackend.partition_update

    def _update_pipe(self, n: int, m: int) -> BigVPipeline:
        """The update path's pipeline, its chunk width the delta's rounded
        up to a power of two (at least 2^10)."""
        from sheep_tpu_torch.ops.elim import pow2_at_least

        return self._pipe(n, pow2_at_least(min(m, self.chunk_edges),
                                           floor=1 << 10))

    def _fold_delta(self, state, edges) -> None:
        """Fold one epoch's adds into the one distributed forest: the
        carried vertex-space table goes block-sharded into position space
        (``P = minp[order]``), the delta's chunks fold through the routed
        segments in groups of D (the last group filled with all-sentinel
        chunks), and the converged table comes back (``minp =
        P[pos]``). The same forest as a one-shot build of the delta:
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
        pos_pad = np.concatenate([state.pos.astype(np.int32),
                                  np.asarray([n], np.int32)])
        pos = pipe._shard_table(pos_pad)
        P = pipe._shard_table(np.asarray(state.minp, np.int32)[order_sent])
        chunks = [pad_chunk(e[off: off + cs], cs, n)
                  for off in range(0, len(e), cs)]
        sentinel = None
        total_rounds = 0
        for g0 in range(0, len(chunks), rows):
            group = chunks[g0: g0 + rows]
            if len(group) < rows:
                if sentinel is None:
                    sentinel = np.full((cs, 2), n, np.int32)
                group = group + [sentinel] * (rows - len(group))
            P, rounds = pipe.build_step(P, pos, pipe._put(np.stack(group)),
                                        stats=stats)
            total_rounds += int(rounds)
        P_host = pipe._allgather_table(pipe._local_block(P))[:n + 1]
        state.minp = P_host[pos_pad]
        stats["update_folds"] = stats.get("update_folds", 0) + 1
        stats["update_rounds"] = \
            stats.get("update_rounds", 0) + total_rounds

    def _move_rescore(self, src, dst, prevs, news, masks):
        """The incremental score's rescore of moved vertices' arcs over
        the shards (:func:`sheep_tpu_torch.ops.score.move_rescore_sharded`):
        every k at once, one reduction."""
        from sheep_tpu_torch.ops.score import move_rescore_sharded

        return move_rescore_sharded(src, dst, prevs, news, masks,
                                    self.mesh())
