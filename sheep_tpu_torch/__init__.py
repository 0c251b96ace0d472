"""sheep_tpu_torch — the SHEEP elimination-tree partitioner on PyTorch and CUDA.

The port of ``sheep_tpu`` (JAX on a TPU) to an NVIDIA H100. It imports
nothing of the JAX package and keeps its own copies of the host code it
needs; its module names mirror the JAX package's. Entry points run on CUDA
unless the caller passes ``device="cpu"``; without a GPU, ``device=None``
raises.
"""

__version__ = "0.1.0"


def partition(path, k, device=None, chunk_edges=1 << 22, dispatch_batch=0,
              comm_volume=True, weights="unit", alpha=1.0, keep_tree=False,
              inflight=0, h2d_ring=0, round_log=None, n_vertices=None,
              **build_opts):
    """Partition the graph at *path* (a file or a synthetic spec of
    :func:`sheep_tpu_torch.io.edgestream.open_input`) into *k* parts with
    the single-device build; returns a
    :class:`~sheep_tpu_torch.types.PartitionResult`. ``dispatch_batch``
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
    file's counting pass."""
    from sheep_tpu_torch.io.edgestream import open_input

    be = _backend(device, chunk_edges, dispatch_batch, alpha, inflight,
                  h2d_ring, build_opts)
    with open_input(path, n_vertices=n_vertices) as stream:
        return be.partition(stream, k, weights=weights,
                            comm_volume=comm_volume, keep_tree=keep_tree,
                            round_log=round_log)


def partition_multi(path, ks, device=None, chunk_edges=1 << 22,
                    dispatch_batch=0, comm_volume=True, weights="unit",
                    alpha=1.0, inflight=0, h2d_ring=0, n_vertices=None,
                    **build_opts):
    """Like :func:`partition`, but one result per part count in ``ks``
    from one build: the forest does not depend on k, so each further k
    costs a re-split on the host and a share of one more scoring pass.
    Returns the results in ``ks`` order."""
    from sheep_tpu_torch.io.edgestream import open_input

    be = _backend(device, chunk_edges, dispatch_batch, alpha, inflight,
                  h2d_ring, build_opts)
    with open_input(path, n_vertices=n_vertices) as stream:
        return be.partition_multi(stream, ks, weights=weights,
                                  comm_volume=comm_volume)


def _backend(device, chunk_edges, dispatch_batch, alpha, inflight, h2d_ring,
             build_opts):
    from sheep_tpu_torch.backends.torch_backend import TorchBackend

    return TorchBackend(chunk_edges=chunk_edges,
                        dispatch_batch=dispatch_batch, alpha=alpha,
                        device=device, inflight=inflight, h2d_ring=h2d_ring,
                        **build_opts)
