"""Host reference pieces of the pipeline the port needs (counterpart of
``tree_split`` and ``part_balance`` in ``sheep_tpu/core/pure.py``).

Same semantics as the reference to the bit: ascending elimination order,
stable descending sort of child subtrees, and the same (load, part) heap
tie-breaking, so the assignment is identical.
"""

from __future__ import annotations

import heapq
from typing import Optional

import numpy as np

from sheep_tpu_torch.types import ElimTree


def tree_split(tree: ElimTree, k: int, weights: Optional[np.ndarray] = None,
               alpha: float = 1.0) -> np.ndarray:
    """Greedy k-way split of the elimination forest.

    Bottom-up bag packing in ascending elimination order: a vertex whose
    accumulated un-assigned subtree weight reaches the bag capacity
    ``alpha * total/k`` first-fit-packs its un-cut child subtrees
    (heaviest first) into bags of at most capacity; each full bag goes to
    the least-loaded part. Residue propagates upward; root residue joins
    the least-loaded part. Then every vertex takes the part of its nearest
    cut ancestor."""
    n, parent, pos = tree.n, tree.parent, tree.pos
    if weights is None:
        weights = np.ones(n, dtype=np.int64)
    w = weights.astype(np.float64)
    total = float(w.sum())
    cap = max(alpha * total / k, 1.0)

    order = np.argsort(pos, kind="stable")
    rem = w.copy()
    uncut_kids: list = [[] for _ in range(n)]
    cut_part = np.full(n, -1, dtype=np.int32)
    loads = [(0.0, p) for p in range(k)]
    heapq.heapify(loads)

    def flush(bag_vertices, bag_weight):
        load, p = heapq.heappop(loads)
        for x in bag_vertices:
            cut_part[x] = p
        heapq.heappush(loads, (load + bag_weight, p))

    for v in order.tolist():
        kids = uncut_kids[v]
        tot = w[v] + sum(rem[c] for c in kids)
        is_root = parent[v] < 0
        if tot < cap and not is_root:
            rem[v] = tot
            uncut_kids[int(parent[v])].append(v)
            continue
        kids.sort(key=lambda c: -rem[c])
        bag: list = []
        bagw = 0.0
        for c in kids:
            if bag and bagw + rem[c] > cap:
                flush(bag, bagw)
                bag, bagw = [], 0.0
            bag.append(c)
            bagw += rem[c]
        if is_root or bagw + w[v] >= cap:
            flush(bag + [v], bagw + w[v])
        else:
            rem[v] = bagw + w[v]
            uncut_kids[int(parent[v])].append(v)

    assignment = np.full(n, -1, dtype=np.int32)
    for v in order[::-1].tolist():
        if cut_part[v] >= 0:
            assignment[v] = cut_part[v]
        else:
            assignment[v] = assignment[parent[v]]
    return assignment


def part_balance(assignment: np.ndarray, k: int,
                 weights: Optional[np.ndarray] = None) -> float:
    """max part load / ideal load (1.0 = perfect)."""
    if weights is None:
        weights = np.ones(len(assignment), dtype=np.int64)
    loads = np.bincount(assignment, weights=weights, minlength=k)
    return float(loads.max() / (weights.sum() / k)) if weights.sum() else 1.0
