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

from sheep_tpu_torch import obs
from sheep_tpu_torch.core import native


def tree_split_host(parent: np.ndarray, pos: np.ndarray, k: int,
                    weights: Optional[np.ndarray] = None,
                    alpha: float = 1.0) -> np.ndarray:
    assign = native.tree_split(parent, pos, k, weights=weights, alpha=alpha)
    account_split(assign, k, weights, alpha)
    return assign


def account_split(assign, k: int, weights, alpha: float) -> None:
    """The split's balance and capacity on the trace, as the reference's
    ``account_split``: the ``split_balance`` event and the
    ``split_parts_at_capacity`` gauge, against the contract's ceiling
    (1 + alpha) * total/k. Only while tracing: the O(V) count is for the
    trace alone."""
    if not obs.enabled():
        return
    from sheep_tpu_torch.ops.score import part_loads_accounting

    total = float(len(assign)) if weights is None \
        else float(np.sum(weights))
    acct = part_loads_accounting(assign, k, weights=weights,
                                 cap=(1.0 + alpha) * total / max(k, 1))
    obs.event("split_balance", k=k, alpha=float(alpha), **acct)
    obs.gauge("split_parts_at_capacity", acct["parts_at_capacity"])
