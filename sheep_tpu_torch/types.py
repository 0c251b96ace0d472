"""Result and value types of the port (counterpart of ``sheep_tpu/types.py``).

The containers carry the same fields as the JAX package's, so a result of
the port and one of the reference compare field by field.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

# Every device vertex table (pos, order, P, assignment) is int32, so vertex
# ids must stay below 2^31.
MAX_DEVICE_VERTICES = 2**31 - 1


class UnsupportedGraphError(ValueError):
    """Graph outside the port's envelope, raised before any streaming pass."""


def refuse_anchored(stream, mesh) -> None:
    """A ``delta:`` input streams as one shard: a mesh of several processes
    cannot split an anchored log, so the sharded backends refuse it there
    (the reference's refusal)."""
    if getattr(stream, "order_anchor", False) and \
            getattr(mesh, "procs", 1) > 1:
        raise UnsupportedGraphError(
            "delta: inputs stream single-shard; a multi-process mesh "
            "cannot split an anchored log — run the delta build in one "
            "process or with --backend torch")


def check_vertex_range(n: int) -> None:
    if n > MAX_DEVICE_VERTICES:
        raise UnsupportedGraphError(
            f"graph has {n:,} vertices but the port keeps int32 device "
            f"tables (max {MAX_DEVICE_VERTICES:,})")


@dataclasses.dataclass
class ElimTree:
    """An elimination forest over a fixed global vertex order.

    ``parent[v]`` is the tree parent of ``v`` (-1 for roots); ``pos[v]`` its
    elimination position. Invariant: ``pos[parent[v]] > pos[v]``.
    """

    parent: np.ndarray  # int64[V], -1 for roots
    pos: np.ndarray  # int64[V]
    n: int


@dataclasses.dataclass
class PartitionResult:
    assignment: np.ndarray  # int32[V] vertex -> part
    k: int
    edge_cut: int
    total_edges: int
    cut_ratio: float
    balance: float
    comm_volume: Optional[int] = None
    phase_times: Dict[str, float] = dataclasses.field(default_factory=dict)
    backend: str = ""
    diagnostics: Dict[str, float] = dataclasses.field(default_factory=dict)
    # {parent, pos, deg} when the caller passed keep_tree=True
    tree: Optional[Dict[str, np.ndarray]] = None

    def summary(self) -> Dict:
        return {
            "k": self.k,
            "edge_cut": int(self.edge_cut),
            "total_edges": int(self.total_edges),
            "cut_ratio": float(self.cut_ratio),
            "balance": float(self.balance),
            "comm_volume": None if self.comm_volume is None
            else int(self.comm_volume),
            "backend": self.backend,
            "phase_times": {k: round(v, 6)
                            for k, v in self.phase_times.items()},
            **({"diagnostics": self.diagnostics} if self.diagnostics else {}),
        }
