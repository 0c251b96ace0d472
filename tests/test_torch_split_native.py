"""The port's native tree split (sheep_tpu_torch/csrc/sheep_core.cpp through
core/native.py) against the port's pure split and both of the JAX
package's, assignment for assignment, and the host build that compiles it
without nvcc. Exact: the split's output is an integer assignment, and all
four implementations share one float formula."""

import ctypes

import numpy as np
import pytest

from sheep_tpu.core import native as jnative
from sheep_tpu.core import pure as jpure
from sheep_tpu.io import generators
from sheep_tpu_torch.core import native, pure
from sheep_tpu_torch.ops import _build, split
from sheep_tpu_torch.types import ElimTree


def _tree(edges, n):
    deg = jpure.degrees(edges, n)
    pos = jpure.elimination_order(deg)
    return jpure.build_elim_tree(edges, pos), deg


def _disconnected():
    a = generators.random_graph(100, 300, seed=2)
    b = generators.random_graph(100, 300, seed=4) + 100
    return np.concatenate([a, b])


# the cases of tests/test_split_native.py: (id, edges, n, k, weighted, alpha)
_GRAPHS = [
    ("karate", generators.karate_club(), 34, 2),
    ("karate_k5", generators.karate_club(), 34, 5),
    ("path", generators.path_graph(257), 257, 4),
    ("star", generators.star_graph(200), 200, 8),
    ("grid", generators.grid_graph(17, 23), 17 * 23, 6),
    ("random", generators.random_graph(500, 2000, seed=3), 500, 8),
    ("random_multi", generators.random_graph(100, 5000, seed=7), 100, 16),
    ("rmat12", generators.rmat(12, 8, seed=11), 1 << 12, 64),
    ("rmat10_k100", generators.rmat(10, 16, seed=5), 1 << 10, 100),
]
CASES = [(f"{name}-{'deg' if w else 'unit'}", e, n, k, w, 1.0)
         for name, e, n, k in _GRAPHS for w in (False, True)]
CASES += [(f"rmat11-alpha{a}", generators.rmat(11, 8, seed=13), 1 << 11, 32,
           False, a) for a in (0.8, 1.0, 1.5)]
CASES += [("disconnected", _disconnected(), 200, 8, False, 1.0),
          ("k_gt_n", generators.karate_club(), 34, 50, False, 1.0),
          ("k_gt_n-deg", generators.karate_club(), 34, 50, True, 1.0)]


@pytest.mark.parametrize("name,edges,n,k,weighted,alpha", CASES,
                         ids=[c[0] for c in CASES])
def test_native_split_matches_all(name, edges, n, k, weighted, alpha):
    tree, deg = _tree(edges, n)
    if name == "disconnected":
        assert (tree.parent < 0).sum() >= 2
    w = deg.astype(np.float64) if weighted else None
    got = native.tree_split(tree.parent, tree.pos, k, weights=w, alpha=alpha)
    assert got.dtype == np.int32 and got.shape == (n,)
    port_tree = ElimTree(parent=tree.parent, pos=tree.pos, n=n)
    np.testing.assert_array_equal(
        got, pure.tree_split(port_tree, k, weights=w, alpha=alpha))
    np.testing.assert_array_equal(
        got, jnative.tree_split(tree.parent, tree.pos, k, weights=w,
                                alpha=alpha))
    np.testing.assert_array_equal(
        got, jpure.tree_split(tree, k, weights=w, alpha=alpha))
    np.testing.assert_array_equal(
        split.tree_split_host(tree.parent, tree.pos, k, weights=w,
                              alpha=alpha), got)


def test_native_split_rejects_bad_arguments():
    tree, _ = _tree(generators.karate_club(), 34)
    with pytest.raises(ValueError, match="pos"):
        native.tree_split(tree.parent, tree.pos[:-1], 2)
    with pytest.raises(ValueError, match="k must be"):
        native.tree_split(tree.parent, tree.pos, 0)
    with pytest.raises(ValueError, match="weights"):
        native.tree_split(tree.parent, tree.pos, 2, weights=np.ones(3))


def _bad_pos(pos):
    dup = pos.copy()
    dup[1] = dup[0]
    return [pos + 1, pos - 1, dup]


def _bad_parent(parent, pos):
    big = parent.copy()
    big[np.flatnonzero(parent >= 0)[0]] = len(parent)
    # a child that comes after its parent
    c = np.flatnonzero(parent >= 0)[0]
    late = parent.copy()
    late[parent[c]] = c
    return [big, late]


def test_native_split_rejects_out_of_bounds_indices():
    """pos and parent index C arrays: a bad one raises before the call."""
    tree, _ = _tree(generators.karate_club(), 34)
    for bad in _bad_pos(tree.pos.astype(np.int64)):
        with pytest.raises(ValueError, match="permutation"):
            native.tree_split(tree.parent, bad, 2)
    for bad in _bad_parent(tree.parent.astype(np.int64), tree.pos):
        with pytest.raises(ValueError, match="forest"):
            native.tree_split(bad, tree.pos, 2)
    # the empty forest and a forest of roots are valid
    assert native.tree_split(np.zeros(0, np.int64), np.zeros(0, np.int64),
                             2).shape == (0,)
    np.testing.assert_array_equal(
        native.tree_split(-np.ones(5, np.int64), np.arange(5), 2),
        pure.tree_split(ElimTree(parent=-np.ones(5, np.int64),
                                 pos=np.arange(5), n=5), 2))


def _fresh_build(monkeypatch, tmp_path):
    """Point the build at an empty directory and forget loaded libraries."""
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(native, "_LIB", None)


def test_host_build_needs_no_nvcc(monkeypatch, tmp_path):
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    libs = _build.build_all(["sheep_core"])
    assert list(libs) == ["sheep_core"]
    assert libs["sheep_core"].startswith(str(tmp_path))
    lib = ctypes.CDLL(libs["sheep_core"])
    lib.sheep_core_abi_version.restype = ctypes.c_int64
    assert lib.sheep_core_abi_version() == native.ABI_VERSION
    # the CUDA sources still need nvcc, and say so before any compiler runs
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()
    tree, _ = _tree(generators.karate_club(), 34)
    np.testing.assert_array_equal(
        split.tree_split_host(tree.parent, tree.pos, 3),
        jnative.tree_split(tree.parent, tree.pos, 3))


def test_split_raises_when_the_build_fails(monkeypatch, tmp_path):
    """No quiet fallback to the Python split."""
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(_build, "_cxx", lambda: "false")
    tree, _ = _tree(generators.karate_club(), 34)
    with pytest.raises(RuntimeError, match="sheep_core.cpp"):
        split.tree_split_host(tree.parent, tree.pos, 2)
