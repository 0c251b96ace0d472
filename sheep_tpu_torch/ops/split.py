"""Tree split on the host (counterpart of ``sheep_tpu/ops/split.py``).

The split runs over O(V) tree state. Like the reference on every backend
that has its native core, the port runs the native C++ split
(``csrc/sheep_core.cpp``, through ``core/native.py``), always: a library
that fails to build or load raises. The numpy/heapq copy in
``core/pure.py`` is the executable spec the tests hold it to; the two are
bit-identical.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from sheep_tpu_torch.core import native


def tree_split_host(parent: np.ndarray, pos: np.ndarray, k: int,
                    weights: Optional[np.ndarray] = None,
                    alpha: float = 1.0) -> np.ndarray:
    return native.tree_split(parent, pos, k, weights=weights, alpha=alpha)
