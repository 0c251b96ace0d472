"""sheep_tpu_torch — the SHEEP elimination-tree partitioner on PyTorch and CUDA.

The port of ``sheep_tpu`` (JAX on a TPU) to an NVIDIA H100. It imports
nothing of the JAX package and keeps its own copies of the host code it
needs; its module names mirror the JAX package's. Entry points run on CUDA
unless the caller passes ``device="cpu"``; without a GPU, ``device=None``
raises.
"""

__version__ = "0.1.0"


def partition(path, k, device=None, chunk_edges=1 << 22, dispatch_batch=8,
              comm_volume=True, weights="unit", alpha=1.0, keep_tree=False,
              inflight=0, h2d_ring=0, round_log=None):
    """Partition the graph at *path* (a file, or ``rmat-hash:SCALE[:EF[:SEED]]``)
    into *k* parts with the single-device build; returns a
    :class:`~sheep_tpu_torch.types.PartitionResult`. ``inflight`` (the
    fixpoint pipeline's depth) and ``h2d_ring`` (file chunks staged ahead)
    of 0 are auto: 2 on CUDA, 1 on the CPU. ``round_log``, a list,
    receives (depth, live slots) of every counted fixpoint round."""
    from sheep_tpu_torch.backends.torch_backend import TorchBackend
    from sheep_tpu_torch.io.edgestream import open_input

    be = TorchBackend(chunk_edges=chunk_edges, dispatch_batch=dispatch_batch,
                      alpha=alpha, device=device, inflight=inflight,
                      h2d_ring=h2d_ring)
    with open_input(path) as stream:
        return be.partition(stream, k, weights=weights,
                            comm_volume=comm_volume, keep_tree=keep_tree,
                            round_log=round_log)
