"""Tree split on the host (counterpart of ``sheep_tpu/ops/split.py``).

The split runs over O(V) tree state. The reference dispatches to its native
C++ split when built; the port has no native split yet and runs its copy
of the numpy/heapq reference, which the reference's native split matches
bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from sheep_tpu_torch.core import pure
from sheep_tpu_torch.types import ElimTree


def tree_split_host(parent: np.ndarray, pos: np.ndarray, k: int,
                    weights: Optional[np.ndarray] = None,
                    alpha: float = 1.0) -> np.ndarray:
    parent64 = np.asarray(parent, dtype=np.int64)
    pos64 = np.asarray(pos, dtype=np.int64)
    tree = ElimTree(parent=parent64, pos=pos64, n=len(parent64))
    return pure.tree_split(tree, k, weights=weights, alpha=alpha)
