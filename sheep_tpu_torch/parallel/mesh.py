"""The shard mesh and its collectives (counterpart of
``sheep_tpu/parallel/mesh.py`` and of the ``lax`` collectives the sharded
pipeline uses under ``shard_map``).

The workload is data parallel over edge shards, so the mesh is one axis,
``shards``: an ordered tuple of ``torch.device``, one entry a shard of
this process. On CUDA :func:`shards_mesh` gives the first visible GPUs,
one shard each; a caller may also build a :class:`Mesh` that repeats a
device, several shards then sharing one card. On the CPU the shards are
virtual, all on ``cpu``, as many as :func:`force_cpu_devices` set (the
JAX package's tests fake an 8-device CPU platform the same way).

The collectives are plain functions over a list of this process's
per-shard tensors: across GPUs a result moves by device-to-device copy,
between shards of one device by a copy on that device. ``ppermute`` gives
a shard with no partner zeros, as ``lax.ppermute`` does; ``psum``,
``pmax`` and ``pmin`` reduce per-shard scalars or small vectors and hand
every shard the result on its own device (shards of one device share the
tensor; it is read, never written). ``all_gather`` and ``all_to_all`` (the
vertex-sharded build's routing) give the shards of one device views of
one buffer, and copy nothing when every shard lies on one device and the
inputs are the rows of one buffer.

Several processes (the reference's multi-host runs): after
:func:`init_distributed`, a mesh spans every process, ``procs`` of them,
this one ``proc``, each holding ``len(mesh)`` shards; global shard
``proc * len(mesh) + i`` is this process's shard i (the reference's
contiguous rows, ``sheep_tpu/parallel/pipeline.py:271-280``). Each
collective then reduces, gathers or routes the local shards first and
crosses the processes with one ``torch.distributed`` call: ``all_reduce``
for ``psum``/``pmax``/``pmin``, ``batch_isend_irecv`` for the pairs of
``ppermute`` that cross processes, ``all_gather_into_tensor`` for
``all_gather``, ``all_to_all_single`` for ``all_to_all``, ``broadcast``
for :func:`shard0`. The transports:

  nccl   one card a process (``torch.cuda.set_device``); a gloo side
         group carries the host arrays of :func:`process_allgather`
  gloo   CPU shards; or CUDA shards when the caller names it (the only
         way several processes share one card: NCCL refuses two ranks on
         one device). Gloo routes no CUDA tensor, so each crossing copies
         the device tensor to the host, runs the collective there and
         copies the result back: explicit staging, one designed host
         synchronization a collective

With one process every collective is what it was, copy for copy.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch

from sheep_tpu_torch.device import resolve_device

SHARD_AXIS = "shards"

# how many virtual shards a CPU mesh has (force_cpu_devices)
_CPU_SHARDS = [1]

# the process group's transport and the gloo side group of the host
# arrays (None: the default group is gloo already)
_DIST: dict = {"backend": None, "host_group": None}

# seconds a collective may wait for the other processes before it fails
DEFAULT_TIMEOUT_S = 600.0


class Mesh(tuple):
    """An ordered tuple of ``torch.device``, one entry a shard of this
    process; ``procs`` processes hold one such tuple each, this one being
    ``proc`` (a mesh given as ``devices`` passes both on)."""

    def __new__(cls, devices: Sequence, procs: Optional[int] = None,
                proc: Optional[int] = None):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one shard")
        self = super().__new__(cls, devs)
        self.procs = int(getattr(devices, "procs", 1) if procs is None
                         else procs)
        self.proc = int(getattr(devices, "proc", 0) if proc is None
                        else proc)
        if not 0 <= self.proc < self.procs:
            raise ValueError(f"bad process {self.proc} of {self.procs}")
        if self.procs > 1 and host_shard_info() != (self.proc, self.procs):
            raise ValueError(
                f"a mesh of process {self.proc} of {self.procs} needs "
                f"init_distributed with that rank and world size (have "
                f"{host_shard_info()})")
        return self

    @property
    def size(self) -> int:
        """Shards over every process (the reference's ``devices.size``)."""
        return self.procs * len(self)

    @property
    def base(self) -> int:
        """The global index of this process's first shard."""
        return self.proc * len(self)

    def distinct(self) -> list:
        """The devices in first-appearance order, each once."""
        out: list = []
        for d in self:
            if d not in out:
                out.append(d)
        return out


def force_cpu_devices(n: int) -> None:
    """Set how many virtual shards ``shards_mesh(device="cpu")`` gives (a
    process's own, with several processes)."""
    if n < 1:
        raise ValueError("force_cpu_devices needs n >= 1")
    _CPU_SHARDS[0] = int(n)


def device_count(device=None) -> int:
    """Shards available to this process: visible GPUs on CUDA, the
    virtual count on the CPU."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" \
        else _CPU_SHARDS[0]


def local_card(rank: int) -> int:
    """The card of process ``rank`` on its host: ``LOCAL_RANK`` when set
    (as ``torchrun`` sets it), else ``rank``, modulo the visible cards."""
    return int(os.environ.get("LOCAL_RANK", rank)) % \
        max(1, torch.cuda.device_count())


def shards_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh over the first ``n_devices`` shards (default: all): GPUs on
    CUDA (``device=None``: CUDA, which raises without a GPU), virtual
    shards on the CPU. With several processes ``n_devices`` counts every
    process's shards and must divide evenly among them (the reference
    raises on uneven devices a process too); a process holds its virtual
    CPU shards, or shards of its own card
    (``cuda:`` :func:`local_card`), one by default."""
    dev = resolve_device(device)
    have = device_count(dev)
    rank, world = host_shard_info()
    if n_devices is not None and n_devices < 1:
        raise ValueError("n_devices must be >= 1")
    if world > 1:
        per = 1 if dev.type == "cuda" else have
        if n_devices is None:
            count = per
        elif n_devices % world:
            raise ValueError(f"uneven devices per process not supported "
                             f"({n_devices} shards over {world} "
                             f"processes)")
        else:
            count = n_devices // world
            if dev.type == "cpu" and count > have:
                raise ValueError(f"requested {count} devices a process, "
                                 f"have {have}")
        card = torch.device("cuda", local_card(rank)) \
            if dev.type == "cuda" else torch.device("cpu")
        return Mesh([card] * count, procs=world, proc=rank)
    if n_devices is not None and n_devices > have:
        raise ValueError(f"requested {n_devices} devices, have {have}")
    count = have if n_devices is None else int(n_devices)
    if dev.type == "cuda":
        return Mesh([torch.device("cuda", i) for i in range(count)])
    return Mesh([torch.device("cpu")] * count)


# -- processes ----------------------------------------------------------------

def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None) -> None:
    """Join the processes of a multi-process run (the reference's
    ``jax.distributed.initialize``). ``coordinator`` is ``host:port`` of
    the rendezvous, with ``num_processes`` and ``process_id``; without
    it, the ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``
    environment that ``torchrun`` sets (given arguments override the
    last two). ``backend`` None means ``nccl`` when the shards are CUDA
    devices (``device``, resolved as the entry points resolve it) and
    ``gloo`` on the CPU; ``nccl`` on the CPU raises, and so does an NCCL
    group that fails to form (there is no switch to gloo: gloo on CUDA is
    asked for by name). A collective waits ``DEFAULT_TIMEOUT_S`` for the
    others before it fails."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown process-group backend {backend!r}; "
                         f"want 'nccl' or 'gloo'")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl transport needs CUDA shards; a CPU mesh "
                         "takes gloo")
    if dist.is_initialized():
        raise RuntimeError("init_distributed: the process group is "
                           "already initialised")
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and "
                             "--process-id")
        init_method = f"tcp://{coordinator}"
    else:
        init_method = "env://"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    if backend == "nccl":
        rank = kw.get("rank", int(os.environ.get("RANK", "0")))
        torch.cuda.set_device(local_card(rank))
    dist.init_process_group(backend, init_method=init_method,
                            timeout=timedelta(seconds=DEFAULT_TIMEOUT_S),
                            **kw)
    _DIST["backend"] = backend
    _DIST["host_group"] = dist.new_group(backend="gloo") \
        if backend == "nccl" else None


def shutdown_distributed() -> None:
    """Leave the process group (no-op without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _DIST["backend"] = _DIST["host_group"] = None


def host_shard_info():
    """(rank, world size) of this process; (0, 1) without a group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def transport() -> Optional[str]:
    """The process group's backend, "nccl" or "gloo"; None without one."""
    return _DIST["backend"]


def process_allgather(arr) -> np.ndarray:
    """Every process's ``arr`` (one shape and dtype on all), stacked:
    (world, *arr.shape) on the host (the reference's
    ``multihost_utils.process_allgather``). Over the gloo group, CPU
    tensors: host values never go to a card just to cross."""
    import torch.distributed as dist

    a = np.ascontiguousarray(arr)
    rank, world = host_shard_info()
    if world == 1:
        return a[None].copy()
    t = torch.from_numpy(a.reshape(-1).copy())
    out = torch.empty(world * t.numel(), dtype=t.dtype)
    dist.all_gather_into_tensor(out, t, group=_DIST["host_group"])
    return out.numpy().reshape((world,) + a.shape)


def _procs(mesh) -> int:
    return 1 if mesh is None else getattr(mesh, "procs", 1)


def _staged(t: torch.Tensor) -> bool:
    """Gloo moves no CUDA tensor: such a crossing stages through the
    host."""
    return _DIST["backend"] == "gloo" and t.device.type == "cuda"


@contextmanager
def _crossing(device):
    """A collective across processes is a designed synchronization point:
    torch.cuda's sync debug mode is off for it."""
    if device.type != "cuda":
        yield
        return
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


def _all_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    """``t`` (a fresh tensor) reduced over the processes."""
    import torch.distributed as dist

    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}[op]
    with _crossing(t.device):
        if _staged(t):
            buf = t.contiguous().cpu()
            dist.all_reduce(buf, op=red)
            return buf.to(t.device)
        t = t.contiguous()
        dist.all_reduce(t, op=red)
        return t


def _all_gather_rows(local: torch.Tensor, procs: int) -> torch.Tensor:
    """(procs * R, ...) rows of every process's (R, ...) ``local``, in
    rank order, on ``local``'s device."""
    import torch.distributed as dist

    with _crossing(local.device):
        src = local.contiguous()
        src = src.cpu() if _staged(local) else src
        out = torch.empty((procs * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src)
        return out.to(local.device) if _staged(local) else out


def _local_stack(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The local shards' tensors as one (S, ...) tensor on the first one's
    device: the rows' own buffer when they are one, else a stack."""
    home = xs[0].device
    if all(x.device == home for x in xs):
        view = stacked_view(xs)
        if view is not None:
            return view
    return torch.stack([x.to(home) for x in xs])


# -- collectives --------------------------------------------------------------

def ppermute(xs: Sequence[torch.Tensor], perm, mesh=None) -> list:
    """``lax.ppermute``: shard ``dst`` receives shard ``src``'s tensor for
    each (src, dst) of ``perm`` (global shard indices), copied onto its
    device; a shard that is no destination receives zeros. Pairs that
    cross processes go by one ``batch_isend_irecv``."""
    out = [torch.zeros_like(x) for x in xs]
    if _procs(mesh) == 1:
        for src, dst in perm:
            out[dst].copy_(xs[src])
        return out
    import torch.distributed as dist

    nl, base, me = len(mesh), mesh.base, mesh.proc
    ops, landing = [], []
    with _crossing(xs[0].device):
        for tag, (src, dst) in enumerate(perm):
            sr, dr = src // nl, dst // nl
            if sr == me and dr == me:
                out[dst - base].copy_(xs[src - base])
            elif sr == me:
                t = xs[src - base]
                t = t.contiguous()
                t = t.cpu() if _staged(t) else t
                ops.append(dist.P2POp(dist.isend, t, dr, tag=tag))
            elif dr == me:
                tgt = out[dst - base]
                buf = torch.empty_like(tgt, device="cpu") \
                    if _staged(tgt) else tgt
                ops.append(dist.P2POp(dist.irecv, buf, sr, tag=tag))
                if buf is not tgt:
                    landing.append((buf, tgt))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for buf, tgt in landing:
            tgt.copy_(buf)
    return out


def _reduce(xs: Sequence[torch.Tensor], op, mesh=None,
            cross: str = "") -> list:
    home = xs[0].device
    red = op(torch.stack([x.to(home) for x in xs]))
    if _procs(mesh) > 1:
        red = _all_reduce(red, cross)
    on = {}
    return [on.setdefault(x.device, red if x.device == home
                          else red.to(x.device)) for x in xs]


def psum(xs: Sequence[torch.Tensor], mesh=None) -> list:
    """``lax.psum`` of per-shard tensors of one shape."""
    return _reduce(xs, lambda t: t.sum(0, dtype=t.dtype), mesh, "sum")


def pmax(xs: Sequence[torch.Tensor], mesh=None) -> list:
    """``lax.pmax`` of per-shard tensors of one shape."""
    return _reduce(xs, lambda t: t.amax(0), mesh, "max")


def pmin(xs: Sequence[torch.Tensor], mesh=None) -> list:
    """``lax.pmin`` of per-shard tensors of one shape."""
    return _reduce(xs, lambda t: t.amin(0), mesh, "min")


def shard0(xs: Sequence[torch.Tensor], mesh=None) -> torch.Tensor:
    """Global shard 0's tensor on this process's first device (the
    reference's replicated ``P_all[0]``): one ``broadcast`` from process
    0 with several processes."""
    if _procs(mesh) == 1:
        return xs[0]
    import torch.distributed as dist

    t = xs[0]
    with _crossing(t.device):
        if _staged(t):
            buf = t.contiguous().cpu() if mesh.proc == 0 \
                else torch.empty_like(t, device="cpu")
            dist.broadcast(buf, src=0)
            return buf.to(t.device)
        buf = t.contiguous() if mesh.proc == 0 else torch.empty_like(t)
        dist.broadcast(buf, src=0)
        return buf


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


def all_gather(xs: Sequence[torch.Tensor], mesh=None) -> list:
    """``lax.all_gather(x, SHARD_AXIS)``: every shard receives the (D, ...)
    stack of all shards' tensors, on its own device. Shards of one device
    share one buffer; when every shard lies on one device and the tensors
    are the rows of one buffer, that buffer is the result and nothing is
    copied (one process)."""
    if _procs(mesh) > 1:
        full = _all_gather_rows(_local_stack(xs), mesh.procs)
        on = {full.device: full}
        return [on.setdefault(x.device, full.to(x.device)) for x in xs]
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


def all_to_all(xs: Sequence[torch.Tensor], mesh=None) -> list:
    """``lax.all_to_all(x, SHARD_AXIS, 0, 0)``: shard j holds a (D, ...)
    block whose row s goes to shard s; shard s receives the (D, ...) stack
    of row s of every shard's block, on its own device. The results of one
    device's shards are views of one (D, shards of the device, ...)
    buffer; when every shard lies on one device and the blocks are the
    rows of one (D, D, ...) buffer, the results are views of that buffer
    and nothing is copied (one process). With several processes the
    blocks cross by one ``all_to_all_single`` of equal splits, and the
    results are views of one (D, local shards, ...) buffer."""
    if _procs(mesh) > 1:
        return _all_to_all_procs(xs, mesh)
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


def _all_to_all_procs(xs: Sequence[torch.Tensor], mesh) -> list:
    """:func:`all_to_all` across processes: the local (S, D, ...) blocks
    reordered to (procs, S, S, ...) by destination process, one
    ``all_to_all_single``, and the (procs, S, S, ...) received read as
    (D, S, ...): row s of it came from global shard s."""
    import torch.distributed as dist

    nl, P = len(xs), mesh.procs
    local = _local_stack(xs)
    rest = tuple(local.shape[2:])
    home = local.device
    with _crossing(home):
        send = local.reshape((nl, P, nl) + rest).transpose(0, 1)
        send = send.contiguous()
        send = send.cpu() if _staged(local) else send
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        buf = recv.view((P * nl, nl) + rest)
        if _staged(local):
            buf = buf.to(home)
    on = {home: buf}
    return [on.setdefault(x.device, buf.to(x.device)).select(1, i)
            for i, x in enumerate(xs)]
