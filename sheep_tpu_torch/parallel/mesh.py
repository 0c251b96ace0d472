"""The shard mesh and its collectives (counterpart of
``sheep_tpu/parallel/mesh.py`` and of the ``lax`` collectives the sharded
pipeline uses under ``shard_map``).

The workload is data parallel over edge shards, so the mesh is one axis,
``shards``: an ordered tuple of ``torch.device``, one entry a shard. On
CUDA :func:`shards_mesh` gives the first visible GPUs, one shard each; a
caller may also build a :class:`Mesh` that repeats a device, several
shards then sharing one card. On the CPU the shards are virtual, all on
``cpu``, as many as :func:`force_cpu_devices` set (the JAX package's
tests fake an 8-device CPU platform the same way).

The collectives are plain functions over a list of per-shard tensors, in
one process: across GPUs a result moves by device-to-device copy, between
shards of one device by a copy on that device. ``ppermute`` gives a shard
with no partner zeros, as ``lax.ppermute`` does; ``psum``, ``pmax`` and
``pmin`` reduce per-shard scalars or small vectors and hand every shard
the result on its own device (shards of one device share the tensor; it
is read, never written). ``all_gather`` and ``all_to_all`` (the
vertex-sharded build's routing) give the shards of one device views of
one buffer, and copy nothing when every shard lies on one device and the
inputs are the rows of one buffer.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from sheep_tpu_torch.device import resolve_device

SHARD_AXIS = "shards"

# how many virtual shards a CPU mesh has (force_cpu_devices)
_CPU_SHARDS = [1]


class Mesh(tuple):
    """An ordered tuple of ``torch.device``, one entry a shard."""

    def __new__(cls, devices: Sequence):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one shard")
        return super().__new__(cls, devs)

    def distinct(self) -> list:
        """The devices in first-appearance order, each once."""
        out: list = []
        for d in self:
            if d not in out:
                out.append(d)
        return out


def force_cpu_devices(n: int) -> None:
    """Set how many virtual shards ``shards_mesh(device="cpu")`` gives."""
    if n < 1:
        raise ValueError("force_cpu_devices needs n >= 1")
    _CPU_SHARDS[0] = int(n)


def device_count(device=None) -> int:
    """Shards available: visible GPUs on CUDA, the virtual count on the
    CPU."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" \
        else _CPU_SHARDS[0]


def shards_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh over the first ``n_devices`` shards (default: all): GPUs on
    CUDA (``device=None``: CUDA, which raises without a GPU), virtual
    shards on the CPU."""
    dev = resolve_device(device)
    have = device_count(dev)
    if n_devices is not None:
        if n_devices > have:
            raise ValueError(f"requested {n_devices} devices, have {have}")
        if n_devices < 1:
            raise ValueError("n_devices must be >= 1")
    count = have if n_devices is None else int(n_devices)
    if dev.type == "cuda":
        return Mesh([torch.device("cuda", i) for i in range(count)])
    return Mesh([torch.device("cpu")] * count)


# -- collectives --------------------------------------------------------------

def ppermute(xs: Sequence[torch.Tensor], perm) -> list:
    """``lax.ppermute``: shard ``dst`` receives shard ``src``'s tensor for
    each (src, dst) of ``perm``, copied onto its device; a shard that is
    no destination receives zeros."""
    out = [torch.zeros_like(x) for x in xs]
    for src, dst in perm:
        out[dst].copy_(xs[src])
    return out


def _reduce(xs: Sequence[torch.Tensor], op) -> list:
    home = xs[0].device
    red = op(torch.stack([x.to(home) for x in xs]))
    on = {}
    return [on.setdefault(x.device, red if x.device == home
                          else red.to(x.device)) for x in xs]


def psum(xs: Sequence[torch.Tensor]) -> list:
    """``lax.psum`` of per-shard tensors of one shape."""
    return _reduce(xs, lambda t: t.sum(0, dtype=t.dtype))


def pmax(xs: Sequence[torch.Tensor]) -> list:
    """``lax.pmax`` of per-shard tensors of one shape."""
    return _reduce(xs, lambda t: t.amax(0))


def pmin(xs: Sequence[torch.Tensor]) -> list:
    """``lax.pmin`` of per-shard tensors of one shape."""
    return _reduce(xs, lambda t: t.amin(0))


def stacked_view(ts: Sequence[torch.Tensor]) -> Optional[torch.Tensor]:
    """The tensors of ``ts`` as one (len(ts), ...) view when they are
    consecutive equal-shaped contiguous blocks of one storage (the rows of
    one buffer); None otherwise."""
    t0 = ts[0]
    step = t0.numel()
    if not t0.is_contiguous():
        return None
    ptr = t0.untyped_storage().data_ptr()
    for i, t in enumerate(ts):
        if (t.device != t0.device or t.dtype != t0.dtype
                or t.shape != t0.shape or not t.is_contiguous()
                or t.untyped_storage().data_ptr() != ptr
                or t.storage_offset() != t0.storage_offset() + i * step):
            return None
    return t0.as_strided((len(ts),) + tuple(t0.shape),
                         (step,) + tuple(t0.stride()))


def all_gather(xs: Sequence[torch.Tensor]) -> list:
    """``lax.all_gather(x, SHARD_AXIS)``: every shard receives the (D, ...)
    stack of all shards' tensors, on its own device. Shards of one device
    share one buffer; when every shard lies on one device and the tensors
    are the rows of one buffer, that buffer is the result and nothing is
    copied."""
    devs = {x.device for x in xs}
    if len(devs) == 1:
        view = stacked_view(xs)
        if view is not None:
            return [view] * len(xs)
    on: dict = {}
    for x in xs:
        if x.device not in on:
            on[x.device] = torch.stack([y.to(x.device) for y in xs])
    return [on[x.device] for x in xs]


def all_to_all(xs: Sequence[torch.Tensor]) -> list:
    """``lax.all_to_all(x, SHARD_AXIS, 0, 0)``: shard j holds a (D, ...)
    block whose row s goes to shard s; shard s receives the (D, ...) stack
    of row s of every shard's block, on its own device. The results of one
    device's shards are views of one (D, shards of the device, ...)
    buffer; when every shard lies on one device and the blocks are the
    rows of one (D, D, ...) buffer, the results are views of that buffer
    and nothing is copied."""
    d = len(xs)
    devs = {x.device for x in xs}
    if len(devs) == 1:
        view = stacked_view(xs)
        if view is not None:
            return [view.select(1, s) for s in range(d)]
    out: list = [None] * d
    for dev in dict.fromkeys(x.device for x in xs):
        mine = [s for s in range(d) if xs[s].device == dev]
        # rows picked on the sender's device: no index crosses the host
        buf = torch.stack([torch.stack([x[s] for s in mine]).to(dev)
                           for x in xs])
        for i, s in enumerate(mine):
            out[s] = buf.select(1, i)
    return out
