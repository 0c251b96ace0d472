"""The case tables of the planner (``refine.plan_moves``) and the live-pair
compaction (``compact.compact_live``): inputs made with numpy from fixed
seeds where the kernels' designs branch. The CPU tests hold the port
against the JAX package on them, and the ``cuda``-marked tests and
``chip_smoke.py`` (phases 3e and 3g) hold the kernels against their plain
versions on the same inputs.

Each case is a name and a dict of its arguments: numpy int32 vectors and
Python ints.
"""

from __future__ import annotations

import numpy as np


def plan_inputs(k: int, seed: int, n: int = 5000):
    """n, assign, best, gain, cap: loads skewed so that the cap fills the
    low parts and leaves the high ones open, gains in [-2, 6) (many
    ties)."""
    rng = np.random.default_rng(seed)
    assign = np.minimum(rng.integers(0, k, n + 1),
                        rng.integers(0, k, n + 1)).astype(np.int32)
    best = rng.integers(0, k, n + 1).astype(np.int32)
    gain = rng.integers(-2, 6, n + 1).astype(np.int32)
    cap = int(1.10 * (-(-n // k)))
    return n, assign, best, gain, cap


def _movers(best, gain, n: int, parity: int, part: int):
    vid = np.arange(len(best))
    return (vid < n) & (vid % 2 == parity) & (gain > 0) & (best == part)


def _load(assign, n: int, part: int) -> int:
    return int((assign[:n] == part).sum())


def _plan(n, k, parity, cap, best, gain, assign) -> dict:
    return {"best": best.astype(np.int32), "gain": gain.astype(np.int32),
            "assign": assign.astype(np.int32), "cap": int(cap),
            "parity": parity, "n": n, "k": k}


def _at_gains(seed: int, n: int, k: int, parity: int, part: int,
              values, cut: float, movers: int = 0) -> dict:
    """Gains in [-2, 6) but ``part``'s movers, whose gains are drawn from
    ``values``; the cap leaves that part room for its movers above the
    smallest value in ``values``[0] and ``cut`` of those at it. With
    ``movers``, that many rows of the parity more move to ``part``."""
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, k, n + 1)
    best = rng.integers(0, k, n + 1)
    gain = rng.integers(-2, 6, n + 1)
    rows = np.arange(parity, n, 2)
    extra = rng.choice(rows, min(movers, len(rows)), replace=False)
    best[extra], gain[extra] = part, 1
    mine = _movers(best, gain, n, parity, part)
    gain[mine] = rng.choice(np.asarray(values), int(mine.sum()))
    at = int((gain[mine] == values[0]).sum())
    above = int((gain[mine] > values[0]).sum())
    cap = _load(assign, n, part) + above + int(cut * at)
    return _plan(n, k, parity, cap, best, gain, assign)


def plan_cases() -> list:
    """The planner's cases: the random ones at k = 7, 64, 257 and both
    parities, then :func:`plan_edge_cases`."""
    cases = []
    for k in (7, 64, 257):
        for parity in (0, 1):
            n, assign, best, gain, cap = plan_inputs(k, k + parity)
            cases.append((f"k{k}-parity{parity}",
                          _plan(n, k, parity, cap, best, gain, assign)))
    return cases + plan_edge_cases()


def plan_edge_cases() -> list:
    """The planner's edges (see each)."""
    cases = []
    # the threshold at a gain of 300 (the count's overflow bin), ties cut
    cases.append(("gain300", _at_gains(1, 6001, 7, 0, 3,
                                       [300, 300, 301, 299, 512, 2], 0.5)))
    # at 70,000 with neighbours that differ in each of its digits, and a
    # gain past 2^24: every gain digit is walked
    cases.append(("gain70000", _at_gains(
        2, 8001, 5, 1, 2, [70000, 70000, 70001, 69999, 70000 + 256,
                           70000 - 256, 70000 + 65536, 2**24 + 7,
                           2**31 - 1, 3], 0.35)))
    # k = 1000: the count's bins shrunk to 16 a part so that k of them fit
    # shared memory, the threshold at a gain of 20 in the overflow bin
    cases.append(("k1000-small-bins", _at_gains(
        6, 20001, 1000, 1, 7, [20, 20, 21, 19, 40, 2], 0.5, movers=300)))
    # k = 4000: too many parts for shared counters, so the count's 256
    # bins a part are added in global memory; the last part split at 300
    cases.append(("k4000-global-bins", _at_gains(
        7, 30001, 4000, 0, 3999, [300, 300, 301, 299, 5000, 2], 0.4,
        movers=500)))
    # a part whose movers equal its head, the others capped
    rng = np.random.default_rng(3)
    n, k = 3001, 7
    assign = rng.integers(0, k, n + 1)
    best = rng.integers(0, k, n + 1)
    gain = rng.integers(-2, 6, n + 1)
    cap = _load(assign, n, 4) + int(_movers(best, gain, n, 0, 4).sum())
    cases.append(("head-equals-movers",
                  _plan(n, k, 0, cap, best, gain, assign)))
    # a part with no room: its load above the cap
    assign = np.where(rng.random(n + 1) < 0.4, 0, assign)
    cases.append(("head-zero", _plan(n, k, 1, int(1.10 * (-(-n // k))),
                                     best, gain, assign)))
    # every mover of part 1 at one gain, over 20,001 rows (many blocks of
    # rows), the cap cutting the tie in the middle
    rng = np.random.default_rng(4)
    n, k = 20001, 4
    assign = rng.integers(0, k, n + 1)
    best = rng.integers(0, k, n + 1)
    gain = rng.integers(-2, 6, n + 1)
    mine = _movers(best, gain, n, 0, 1)
    gain[mine] = 5
    cap = _load(assign, n, 1) + int(mine.sum()) // 2 + 123
    cases.append(("tie-across-blocks",
                  _plan(n, k, 0, cap, best, gain, assign)))
    # one part, and rows outside it (a part id of 1, not counted in the
    # load) moving in while its room lasts
    rng = np.random.default_rng(5)
    n = 1001
    gain = rng.integers(-2, 6, n + 1)
    assign = (rng.random(n + 1) < 0.3).astype(np.int32)
    cap = _load(assign, n, 0) + 37
    cases.append(("k1", _plan(n, 1, 0, cap, np.zeros(n + 1), gain,
                              assign)))
    # odd and even n at parity 1 (the last row of the parity, or not)
    for n in (999, 1000):
        _, assign, best, gain, cap = plan_inputs(3, n, n)
        cases.append((f"n{n}-parity1", _plan(n, 3, 1, cap, best, gain,
                                             assign)))
    return cases


def compact_pairs(rng, C: int, n: int, share: float, dup: float):
    """C position pairs lo < hi with ``share`` of them live, about ``dup``
    of the live ones copies of others."""
    lo = rng.integers(0, n - 1, C)
    hi = lo + 1 + (rng.random(C) * (n - 1 - lo)).astype(np.int64)
    copy = rng.random(C) < dup
    src = rng.integers(0, C, C)
    lo[copy], hi[copy] = lo[src[copy]], hi[src[copy]]
    dead = rng.random(C) >= share
    lo[dead] = n
    hi[dead] = n
    return lo.astype(np.int32), hi.astype(np.int32)


def compact_cases() -> list:
    """The compaction's cases: n sets the bits of each half of the packed
    key and so the sort's passes; sizes below, at and above the distinct
    live pairs."""
    rng = np.random.default_rng(9)
    cases = []
    for C, n, share, size in ((1 << 20, 1 << 18, 0.5, 1 << 20),
                              (100_003, 1 << 18, 0.01, 4096),
                              (5, 1 << 18, 0.9, 2), (0, 1 << 18, 0.0, 16),
                              (3000, 7, 0.6, 64),
                              (70_001, 1000, 0.4, 1 << 16)):
        lo, hi = compact_pairs(rng, C, n, share, 0.3) if C else \
            (np.zeros(0, np.int32), np.zeros(0, np.int32))
        cases.append((f"C{C}-n{n}-live{share:g}-size{size}",
                      {"lo": lo, "hi": hi, "n": n, "size": size}))
    # every slot live, all one pair
    C, n = 10_000, 5000
    cases.append(("one-pair", {"lo": np.full(C, 3, np.int32),
                               "hi": np.full(C, 7, np.int32), "n": n,
                               "size": 16}))
    # n = 1: the pairs (0, 0) and (0, 1) live, (1, 1) dead
    lo = rng.integers(0, 2, 5000).astype(np.int32)
    hi = np.where(lo == 1, 1, rng.integers(0, 2, 5000)).astype(np.int32)
    cases.append(("n1", {"lo": lo, "hi": hi, "n": 1, "size": 8}))
    # slots not a multiple of the sort's 4096-key tile, all live, more
    # distinct pairs than size
    lo, hi = compact_pairs(rng, 3 * 4096 + 77, 1 << 18, 1.0, 0.3)
    cases.append(("ragged-over-size", {"lo": lo, "hi": hi, "n": 1 << 18,
                                       "size": 1000}))
    return cases
