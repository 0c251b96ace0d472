"""K2 and K3 timed in turns against another build of ``csrc/gather2d.cu``
(the parent commit's, say), in one process on one card, on the same
inputs.

    git show REV:sheep_tpu_torch/csrc/gather2d.cu > other.cu
    python -m sheep_tpu_torch.tools.gather_turns --other other.cu

The other source is compiled with the package's nvcc flags into
``sheep_tpu_torch/_build/other-<hash>/`` and called through the interface
its own ``extern "C"`` declarations of ``sheep_take_rows`` and
``sheep_take_along`` state: this tree's (launched with this tree's plans),
or the one before the launch plans moved to Python (``sheep_take_rows(t,
rows, w, idx, out, b, stream)``, ``sheep_take_along(x, xr, xc, idx, out,
ir, ic, axis, shift, stream)``). A source that declares any other is
refused. Every case runs the other build, then this tree's default plan
("new"), then the plans of other rows a warp (K2) or block sizes (K3),
then the same in reverse order; each is checked exactly against the plain
version before it is timed (``gather_smoke.time_ms``). One JSON line a
case: ``ms`` by variant (both turns), ``library_ms``, ``bound_ms``
(bytes), ``chain_ms`` (``gather_smoke.chain_bound_ms``: an empty kernel
launched as the default plan is, plus two dependent loads at the measured
load latency), the default plan; for K2's bulk case the card's memset and
copy of the output's bytes, for K3 the bytes of the 32-byte sectors the
lookups reach and, for the form-E cases, K1 on the same lookups. Without
``--other`` only this tree's plans run.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

import torch

from sheep_tpu_torch.ops import _build, gather, gather2d
from sheep_tpu_torch.tools import gather_smoke as gs

# the interface before the launch plans moved to Python: parameters of
# sheep_take_rows and sheep_take_along as declared
PLANLESS = (
    ("const void* t", "long long rows", "long long w", "const void* idx",
     "void* out", "long long b", "void* stream"),
    ("const void* x", "long long xr", "long long xc", "const void* idx",
     "void* out", "long long ir", "long long ic", "int axis", "int shift",
     "void* stream"),
)


def declared(source: str) -> tuple:
    """The parameters of ``sheep_take_rows`` and ``sheep_take_along`` as
    ``source`` declares them, each normalised to "type name"."""
    sig = []
    for fn in ("sheep_take_rows", "sheep_take_along"):
        m = re.search(r'extern\s+"C"\s+int\s+' + fn + r"\s*\(([^)]*)\)",
                      source)
        if m is None:
            raise ValueError(f"{fn} is not declared")
        sig.append(tuple(" ".join(p.replace("*", "* ").split()).replace(
            " *", "*") for p in m.group(1).split(",")))
    return tuple(sig)


def interface_of(source: str) -> str:
    """"plans" (this tree's interface) or "planless"; anything else is
    refused, since ctypes would call it with the wrong arguments."""
    sig = declared(source)
    with open(os.path.join(_build.CSRC, "gather2d.cu")) as f:
        if sig == declared(f.read()):
            return "plans"
    if sig == PLANLESS:
        return "planless"
    raise ValueError("the other gather2d.cu declares an interface this "
                     f"tool does not know: {sig}")


def other_library(path: str):
    """Compile ``path`` (a gather2d.cu) and load it: (library, interface)."""
    with open(path, "rb") as f:
        data = f.read()
    interface = interface_of(data.decode())
    out_dir = os.path.join(_build.BUILD_ROOT,
                           f"other-{hashlib.sha1(data).hexdigest()[:16]}")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libgather2d_other.so")
    if not os.path.exists(lib_path):
        p = subprocess.run(_build._command(path, lib_path),
                           capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"compiling {path} failed:\n{p.stderr}")
    lib = ctypes.CDLL(lib_path)
    if interface == "plans":
        return gather2d.declare(lib), interface
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.sheep_take_rows.argtypes = [vp, ll, ll, vp, vp, ll, vp]
    lib.sheep_take_rows.restype = ctypes.c_int
    lib.sheep_take_along.argtypes = [vp, ll, ll, vp, vp, ll, ll,
                                     ctypes.c_int, ctypes.c_int, vp]
    lib.sheep_take_along.restype = ctypes.c_int
    return lib, interface


def _stream():
    return torch.cuda.current_stream().cuda_stream


def other_rows(other, t, idx, out, plan):
    lib, interface = other

    def run():
        if interface == "plans":
            gather2d.launch_take_rows(t, idx, out, plan, lib)
            return out
        rc = lib.sheep_take_rows(t.data_ptr(), t.shape[0], t.shape[1],
                                 idx.data_ptr(), out.data_ptr(), len(idx),
                                 _stream())
        if rc:
            raise RuntimeError(f"other take_rows: {rc}")
        return out
    return run


def other_along(other, x, idx, out, axis, shift, plan):
    lib, interface = other

    def run():
        if interface == "plans":
            gather2d.launch_take_along(x, idx, out, axis, shift, plan, lib)
            return out
        rc = lib.sheep_take_along(x.data_ptr(), x.shape[0], x.shape[1],
                                  idx.data_ptr(), out.data_ptr(),
                                  idx.shape[0], idx.shape[1], axis, shift,
                                  _stream())
        if rc:
            raise RuntimeError(f"other take_along: {rc}")
        return out
    return run


def turns(variants: dict, plain, out_of) -> dict:
    """Each variant checked against ``plain`` once, then timed in the
    order given and again in reverse; {name: [ms, ms]}."""
    want = plain()
    for name, fn in variants.items():
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(out_of(got), want):
            raise RuntimeError(f"variant {name} disagrees with the plain "
                               f"version")
    times = {name: [] for name in variants}
    for name in list(variants) + list(reversed(variants)):
        times[name].append(gs.time_ms(variants[name]))
    return times


def _ints(g, lo, hi, shape):
    return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32,
                         device="cuda")


def rows_cases(g):
    """(name, t, idx, out offset) for K2."""
    P2R = 1 << 13
    t = _ints(g, 0, 1 << 30, (4096, 128))
    yield "P1-A", t, _ints(g, 0, 4096, (1024,)), 0
    tb = _ints(g, 0, 1 << 30, (P2R, 128))
    yield "K2-bulk", tb, _ints(g, 0, P2R, (1 << 16,)), 0
    yield "K2-bulk-t-at-1", gs.view_at(tb, 1), \
        _ints(g, 0, P2R, (1 << 16,)), 0
    yield "K2-bulk-out-at-1", tb, _ints(g, 0, P2R, (1 << 16,)), 1
    yield "K2-odd-w37", _ints(g, 0, 1 << 30, (1001, 37)), \
        _ints(g, -500, 1500, (3001,)), 0


def along_cases(g):
    """(name, x, idx, axis, shift, idx offset) for K3."""
    t = _ints(g, 0, 1 << 30, (4096, 128))
    yield "P1-B", t, _ints(g, 0, 4096, (8, 128)), 0, 0, 0
    yield "P1-C", _ints(g, 0, 1 << 30, (8, 128)), \
        _ints(g, 0, 128, (8, 128)), 1, 0, 0
    lanes = torch.arange(128, dtype=torch.int32, device="cuda")[None, :]
    yield "P1-E", t, _ints(g, 0, 4096, (64, 128)) * 128 + lanes, 0, 7, 0
    t2 = _ints(g, 0, 1 << 30, (1 << 13, 128))
    e = _ints(g, 0, 1 << 13, ((1 << 20) // 128, 128)) * 128 + lanes
    yield "P2-kernel-only", t2, e, 0, 7, 0
    yield "P2-idx-at-1", t2, gs.view_at(e, 1), 0, 7, 1
    for R in gs.P3_WIDTHS + (1 << 16,):
        yield f"P3-R{R}", _ints(g, 0, 1 << 30, (8, R)), \
            _ints(g, 0, R, (8, R)), 1, 0, 0
    yield "K3-axis1-odd-w1001", _ints(g, 0, 1 << 30, (7, 999)), \
        _ints(g, -300, 1300, (7, 1001)), 1, 0, 0
    yield "K3-axis0-odd-w37", _ints(g, 0, 1 << 30, (1001, 37)), \
        _ints(g, -8000, 16000, (513, 37)), 0, 3, 0
    x = _ints(g, 0, 1 << 30, (8, 1 << 15))
    yield "P3-R32768-idx-at-1", x, \
        gs.view_at(_ints(g, 0, 1 << 15, (8, 1 << 15)), 1), 1, 0, 1


def rows_variants(t, idx, out, sms):
    """This tree's K2 plans: the default, then each rows a warp."""
    default = gather2d.plan_take_rows(t.shape[1], len(idx), t.data_ptr(),
                                      out.data_ptr(), sms)
    plans = {"new": default}
    for lg in range(6):
        plans[f"rows{1 << lg}"] = gather2d.RowsPlan.covering(
            default.vec, lg, len(idx))
    return default, {
        name: (lambda p=p: gather2d.launch_take_rows(t, idx, out, p) or out)
        for name, p in _unique(plans).items()}


def along_variants(x, idx, out, axis, shift, sms):
    """This tree's K3 plans: the default, then each block size."""
    default = gather2d.plan_take_along(*idx.shape, sms)
    plans = {"new": default}
    for bt in (32, 64, 128, 256):
        plans[f"t{bt}"] = gather2d.AlongPlan.covering(*idx.shape, bt)
    return default, {
        name: (lambda p=p: gather2d.launch_take_along(x, idx, out, axis,
                                                      shift, p) or out)
        for name, p in _unique(plans).items()}


def _unique(plans: dict) -> dict:
    """The plans by name, each plan once (its first name)."""
    seen, out = set(), {}
    for name, p in plans.items():
        if p not in seen:
            seen.add(p)
            out[name] = p
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", default=None,
                    help="another gather2d.cu to time against")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("gather_turns needs a CUDA device")
    other = other_library(args.other) if args.other else None
    sms = gather2d.sms("cuda")
    latency = gs.chase_yardsticks()["load_latency_ms"]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "sms": sms,
                      "load_latency_ms": latency}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(20)
    ok = True
    for name, t, idx, at in rows_cases(g):
        b, w = len(idx), t.shape[1]
        out = gs.view_at(torch.empty((b, w), dtype=torch.int32,
                                     device="cuda"), at)
        plan, variants = rows_variants(t, idx, out, sms)
        if other is not None:
            variants = {"other": other_rows(other, t, idx, out, plan),
                        **variants}
        rec = {"kernel": "K2", "case": name, "t": list(t.shape), "b": b,
               "plan": plan.__dict__}
        try:
            rec["ms"] = turns(variants,
                              lambda: gather2d.take_rows_plain(t, idx),
                              lambda o: o)
        except RuntimeError as e:
            ok = False
            rec["error"] = str(e)[:400]
        if idx.min() >= 0 and idx.max() < t.shape[0]:
            i64 = idx.long()
            rec["library_ms"] = gs.time_ms(
                lambda: torch.index_select(t, 0, i64))
        rec["bound_ms"] = gs.bound_ms(gs.rows_bytes(t, idx))
        rec["chain_ms"] = gs.chain_bound_ms(plan, latency)
        if b * w >= 1 << 22:
            # the card's own floors for the bytes: writing out (a memset)
            # and copying out's bytes from a buffer of its size
            src = torch.empty_like(out)
            rec["memset_ms"] = gs.time_ms(lambda: out.zero_())
            rec["copy_ms"] = gs.time_ms(lambda: out.copy_(src))
        print(json.dumps(rec), flush=True)
    for name, x, idx, axis, shift, at in along_cases(g):
        out = torch.empty_like(idx)
        plan, variants = along_variants(x, idx, out, axis, shift, sms)
        if other is not None:
            variants = {"other": other_along(other, x, idx, out, axis,
                                             shift, plan), **variants}
        rec = {"kernel": "K3", "case": name, "x": list(x.shape),
               "idx": list(idx.shape), "axis": axis, "shift": shift,
               "idx_at": at, "plan": plan.__dict__}
        try:
            rec["ms"] = turns(
                variants,
                lambda: gather2d.take_along_plain(x, idx, axis, shift),
                lambda o: o)
        except RuntimeError as e:
            ok = False
            rec["error"] = str(e)[:400]
        if not shift and idx.min() >= 0 and idx.max() < x.shape[axis]:
            i64 = idx.long()
            rec["library_ms"] = gs.time_ms(
                lambda: torch.gather(x, axis, i64))
        elif shift == 7:
            e64 = idx.long()
            rec["library_ms"] = gs.time_ms(lambda: torch.take(x, e64))
        rec["bound_ms"] = gs.bound_ms(gs.along_bytes(x, idx, axis, shift))
        rec["chain_ms"] = gs.chain_bound_ms(plan, latency)
        rec["sector_bytes"] = gs.sector_bytes(x, idx, axis, shift)
        if shift == 7:
            # K1's 1-D gather of the same lookups on the flat table: a
            # yardstick of the L2's rate of scattered sectors
            flat, i1 = x.view(-1), idx.reshape(-1)
            rec["k1_same_lookups_ms"] = gs.time_ms(
                lambda: gather.gather_clip(flat, i1))
        print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
