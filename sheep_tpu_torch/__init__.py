"""sheep_tpu_torch — the SHEEP elimination-tree partitioner on PyTorch and CUDA.

The port of ``sheep_tpu`` (JAX on a TPU) to an NVIDIA H100. It imports
nothing of the JAX package and keeps its own copies of the host code it
needs; its module names mirror the JAX package's. Entry points run on CUDA
unless the caller passes ``device="cpu"``; without a GPU, ``device=None``
raises.

Incremental repartitioning (``sheep_tpu_torch/incremental.py``):
:func:`begin_incremental` builds a resident partition,
:func:`apply_update` folds a delta epoch into it, :func:`refresh` scores
it, :func:`compact_state` compacts its tombstones, :func:`save_state` and
:func:`load_state` snapshot it.
"""

__version__ = "0.1.0"

_INCREMENTAL = ("begin_incremental", "apply_update", "refresh",
                "compact_state", "save_state", "load_state")


def __getattr__(name):
    # the incremental entry points, imported on first use as the others
    if name in _INCREMENTAL:
        from sheep_tpu_torch import incremental

        return getattr(incremental, name)
    raise AttributeError(f"module 'sheep_tpu_torch' has no attribute "
                         f"{name!r}")


def partition_hierarchical(path, k_levels, **kw):
    """Lazy re-export of
    :func:`sheep_tpu_torch.hierarchy.partition_hierarchical` (k =
    prod(k_levels), one level at a time)."""
    from sheep_tpu_torch.hierarchy import partition_hierarchical as ph

    return ph(path, k_levels, **kw)


def partition(path, k, device=None, chunk_edges=None, dispatch_batch=0,
              comm_volume=True, weights="unit", alpha=1.0, keep_tree=False,
              inflight=0, h2d_ring=0, round_log=None, n_vertices=None,
              refine=0, refine_alpha=1.10, checkpointer=None, resume=False,
              cache_chunks=True, backend="torch", n_devices=None,
              **build_opts):
    """Partition the graph at *path* (a file or a synthetic spec of
    :func:`sheep_tpu_torch.io.edgestream.open_input`) into *k* parts with
    the single-device build; returns a
    :class:`~sheep_tpu_torch.types.PartitionResult`. ``chunk_edges`` are
    the edges a chunk (None, the default: the backend's own, 2^22, and
    2^20 for ``torch-bigv``, as the reference's backends take theirs). ``dispatch_batch``
    (chunks an execution), ``inflight`` (the fixpoint pipeline's depth) and
    ``h2d_ring`` (file chunks staged ahead) of 0 are auto: N from the
    card's memory on CUDA and 1 on the CPU, D 2 on CUDA and 1 on the CPU;
    at N == 1 == D the per-segment driver runs. ``build_opts``: the
    driver's other knobs of
    :class:`~sheep_tpu_torch.backends.torch_backend.TorchBackend`
    (``segment_rounds``, ``warm_schedule``, ``host_tail_threshold``,
    ``carry_tail``, ``tail_overlap``, ``stale_reuse``, ``lift_levels``).
    ``round_log``, a list, receives (depth, live slots) of every counted
    round of the batched driver. ``n_vertices``, when known, spares a
    file's counting pass. ``refine=N`` runs up to N rounds of
    capacity-capped label propagation after the build
    (:func:`refine_result`, cap ``refine_alpha * ceil(n / k)``); the
    refined cut is never worse than the unrefined one.
    ``checkpointer`` (a
    :class:`~sheep_tpu_torch.utils.checkpoint.Checkpointer`) saves the
    build every ``checkpointer.every`` chunks, and ``resume`` continues
    from its latest step (the refinement after it is not checkpointed, as
    in the reference); ``cache_chunks`` keeps the chunks on the device
    across the passes (``SHEEP_CACHE_BYTES`` sets its budget).
    ``backend="torch-sharded"`` runs the sharded build
    (:class:`~sheep_tpu_torch.backends.torch_sharded_backend.
    TorchShardedBackend`) over ``n_devices`` shards (None: every GPU, or
    every virtual CPU shard of ``parallel.mesh.force_cpu_devices``); it
    takes ``segment_rounds``, ``warm_schedule`` and ``lift_levels`` of
    ``build_opts`` and keeps chunks on the devices only under
    ``SHEEP_CACHE_BYTES``; it raises ``ValueError`` on ``round_log``, a
    non-zero ``h2d_ring`` or ``cache_chunks=False``, as the CLI refuses
    their flags. ``backend="torch-bigv"`` runs the vertex-sharded build
    (:class:`~sheep_tpu_torch.backends.torch_bigv_backend.
    TorchBigVBackend`: every vertex table block-sharded over the
    ``n_devices`` shards, one distributed forest); it takes ``jumps``,
    ``hoist_bytes``, ``segment_rounds`` and ``lift_levels`` of
    ``build_opts`` and refuses the batched dispatch's knobs as well."""
    from sheep_tpu_torch.io.edgestream import open_input

    with open_input(path, n_vertices=n_vertices) as stream:
        return _partition_stream(
            stream, k, device=device, chunk_edges=chunk_edges,
            dispatch_batch=dispatch_batch, comm_volume=comm_volume,
            weights=weights, alpha=alpha, keep_tree=keep_tree,
            inflight=inflight, h2d_ring=h2d_ring, round_log=round_log,
            refine=refine, refine_alpha=refine_alpha,
            checkpointer=checkpointer, resume=resume,
            cache_chunks=cache_chunks, backend=backend, n_devices=n_devices,
            **build_opts)


def _partition_stream(stream, k, device=None, chunk_edges=None,
                      dispatch_batch=0, comm_volume=True, weights="unit",
                      alpha=1.0, keep_tree=False, inflight=0, h2d_ring=0,
                      round_log=None, refine=0, refine_alpha=1.10,
                      checkpointer=None, resume=False, backend="torch",
                      n_devices=None, **build_opts):
    """:func:`partition` over an open stream (shared with the hierarchy,
    whose parts' subgraphs are streams of their own)."""
    if backend in SHARDED_BACKENDS and round_log is not None:
        raise ValueError(f"round_log is not supported with "
                         f"backend={backend!r}")
    be = _backend(device, chunk_edges, dispatch_batch, alpha, inflight,
                  h2d_ring, build_opts, backend, n_devices)
    kw = {} if be.name != "torch" else {"round_log": round_log}
    res = be.partition(stream, k, weights=weights, comm_volume=comm_volume,
                       keep_tree=keep_tree, checkpointer=checkpointer,
                       resume=resume, **kw)
    if refine:
        res = refine_result(res, stream, rounds=refine, alpha=refine_alpha,
                            weights=weights, device=be.device)
    return res


def partition_multi(path, ks, device=None, chunk_edges=None,
                    dispatch_batch=0, comm_volume=True, weights="unit",
                    alpha=1.0, inflight=0, h2d_ring=0, n_vertices=None,
                    backend="torch", n_devices=None, **build_opts):
    """Like :func:`partition`, but one result per part count in ``ks``
    from one build: the forest does not depend on k, so each further k
    costs a re-split on the host and a share of one more scoring pass.
    Returns the results in ``ks`` order. ``backend`` and ``n_devices`` as
    in :func:`partition`."""
    from sheep_tpu_torch.io.edgestream import open_input

    be = _backend(device, chunk_edges, dispatch_batch, alpha, inflight,
                  h2d_ring, build_opts, backend, n_devices)
    with open_input(path, n_vertices=n_vertices) as stream:
        return be.partition_multi(stream, ks, weights=weights,
                                  comm_volume=comm_volume)


BACKENDS = ("torch", "torch-sharded", "torch-bigv")
# the backends over a mesh of shards (``n_devices``)
SHARDED_BACKENDS = ("torch-sharded", "torch-bigv")


# the build options the vertex-sharded backend takes
_BIGV_OPTS = ("jumps", "hoist_bytes", "segment_rounds", "lift_levels")


def _backend(device, chunk_edges, dispatch_batch, alpha, inflight, h2d_ring,
             build_opts, backend="torch", n_devices=None):
    from sheep_tpu_torch.backends.torch_backend import TorchBackend

    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; the port has "
                         f"{', '.join(BACKENDS)}")
    if backend == "torch-bigv":
        return _bigv_backend(device, chunk_edges, dispatch_batch, alpha,
                             inflight, h2d_ring, build_opts, n_devices)
    if chunk_edges is None:
        chunk_edges = 1 << 22
    if backend == "torch-sharded":
        from sheep_tpu_torch.backends.torch_sharded_backend import \
            TorchShardedBackend

        opts = dict(build_opts)
        bad = [name for name, on in (
            ("h2d_ring", h2d_ring), ("cache_chunks=False",
                                     not opts.pop("cache_chunks", True)))
               if on]
        if bad:
            raise ValueError(f"{', '.join(bad)} not supported with "
                             f"backend='torch-sharded'")
        return TorchShardedBackend(
            chunk_edges=chunk_edges, dispatch_batch=dispatch_batch,
            alpha=alpha, inflight=inflight, device=device,
            n_devices=n_devices, **opts)
    if n_devices is not None:
        raise ValueError("n_devices needs backend='torch-sharded' or "
                         "'torch-bigv'")
    return TorchBackend(chunk_edges=chunk_edges,
                        dispatch_batch=dispatch_batch, alpha=alpha,
                        device=device, inflight=inflight, h2d_ring=h2d_ring,
                        **build_opts)


def _bigv_backend(device, chunk_edges, dispatch_batch, alpha, inflight,
                  h2d_ring, build_opts, n_devices):
    """The ``torch-bigv`` backend of :func:`partition`: the batched
    dispatch's knobs, the staging ring and ``cache_chunks=False`` raise,
    as the CLI refuses their flags."""
    from sheep_tpu_torch.backends.torch_bigv_backend import TorchBigVBackend

    opts = dict(build_opts)
    bad = [name for name, on in (
        ("dispatch_batch", dispatch_batch), ("inflight", inflight),
        ("h2d_ring", h2d_ring),
        ("cache_chunks=False", not opts.pop("cache_chunks", True)),
        *((name, True) for name in opts if name not in _BIGV_OPTS)) if on]
    if bad:
        raise ValueError(f"{', '.join(bad)} not supported with "
                         f"backend='torch-bigv'")
    if chunk_edges is not None:
        opts["chunk_edges"] = chunk_edges
    return TorchBigVBackend(alpha=alpha, device=device, n_devices=n_devices,
                            **opts)


def comm_volume_of(assignment, stream, n, k, chunk_edges=1 << 22,
                   device=None):
    """The distinct (vertex, foreign part) pairs of an assignment's cut
    edges over one pass of the stream: the count every partition reports,
    for passes that change the assignment after it was scored (refinement,
    the hierarchy). ``n`` is the stream's vertex count."""
    from sheep_tpu_torch.backends.torch_backend import TorchBackend

    scorer = TorchBackend(chunk_edges=chunk_edges, device=device)
    return scorer.score_stream(stream, {k: assignment})[k][3]


def refine_result(res, stream, rounds=3, alpha=1.10, weights="unit",
                  degrees=None, budget_bytes: int = 4 << 30, device=None):
    """Refine a PartitionResult (``ops/refine.refine_assignment``) and
    rescore its cut and balance, and its comm volume when it has one, as
    the reference's ``refine_result``. ``weights="degree"`` caps parts by
    degree weight, counted in one more pass unless ``degrees`` gives them.
    ``budget_bytes`` bounds the (n+1) x k histogram before the blocked
    mode. A ``ValueError`` of the refinement leaves the result unrefined,
    with the reason under ``refine_skipped``. Runs on ``device`` (None:
    CUDA)."""
    import dataclasses

    import numpy as np

    from sheep_tpu_torch.core import pure
    from sheep_tpu_torch.ops.refine import refine_assignment

    n = stream.num_vertices
    w = degrees
    if weights == "degree" and w is None:
        w = np.zeros(n, dtype=np.int64)
        for c in stream.chunks(1 << 22):
            w += np.bincount(np.asarray(c, np.int64).ravel(),
                             minlength=n)[:n]
    try:
        new_assign, rstats = refine_assignment(
            res.assignment, stream, n, res.k, rounds=rounds, alpha=alpha,
            weights=w, budget_bytes=budget_bytes, device=device)
    except ValueError as e:
        # a finished partition is never lost to a refinement that cannot
        # run: it comes back unrefined, with the reason
        import sys

        print(f"refine skipped: {e}", file=sys.stderr)
        return dataclasses.replace(
            res, diagnostics={**(res.diagnostics or {}),
                              "refine_skipped": str(e)})
    cv = res.comm_volume
    if cv is not None:
        cv = comm_volume_of(new_assign, stream, n, res.k, device=device)
    return dataclasses.replace(
        res, assignment=new_assign,
        edge_cut=rstats["refine_cut_after"],
        cut_ratio=rstats["refine_cut_after"] / max(res.total_edges, 1),
        balance=pure.part_balance(new_assign, res.k, w),
        comm_volume=cv,
        diagnostics={**(res.diagnostics or {}),
                     **{kk: float(vv) for kk, vv in rstats.items()}})
