"""Build state carried between the reference and the port.

The JAX package saves its build state as ``deg`` int64[n] and the
vertex-space ``minp`` int32[n+1] (minp[v] = elimination position of v's
parent, n = none). The port folds in position space: P[p] = minp[order[p]].
With these two functions a build begun by the JAX package is finished by
the port, and back.
"""

from __future__ import annotations

import numpy as np
import torch


def _with_sentinel(a, n: int) -> np.ndarray:
    a = np.asarray(a, dtype=np.int64)
    return a if len(a) == n + 1 else np.concatenate([a, [n]])


def state_from_jax(arrays: dict, pos, order, device) -> torch.Tensor:
    """``{"deg", "minp"}`` payload -> the port's position-space P
    (int32[n+1] on ``device``). ``pos``/``order`` may carry the sentinel
    slot or not."""
    minp = np.asarray(arrays["minp"], dtype=np.int32)
    n = len(minp) - 1
    order = _with_sentinel(order.cpu().numpy() if isinstance(
        order, torch.Tensor) else order, n)
    return torch.from_numpy(np.ascontiguousarray(minp[order])).to(device)


def state_to_numpy(P: torch.Tensor, pos, deg) -> dict:
    """The port's P -> the reference's ``{"deg", "minp"}`` payload."""
    n = len(P) - 1
    pos = _with_sentinel(pos.cpu().numpy() if isinstance(
        pos, torch.Tensor) else pos, n)
    deg = deg.cpu().numpy() if isinstance(deg, torch.Tensor) else deg
    return {"deg": np.asarray(deg, dtype=np.int64)[:n],
            "minp": P.cpu().numpy()[pos].astype(np.int32)}
