"""Build of the port's native libraries.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` and each
``csrc/<name>.cpp`` (host code) with the C++ compiler (``CXX``, else
``c++`` or ``g++``) into a shared library with a plain C interface, loaded
with ``ctypes``; ``csrc/*.cuh`` are headers the ``.cu`` files share. A
host library needs no ``nvcc``. The output goes to
``sheep_tpu_torch/_build/<hash of the sources, headers and flags>/``, so
an edited source builds anew and an unchanged one is reused. The sources asked for
compile together, one compiler process each, started at once. A failed
build raises with the compiler's stderr. Nothing is built when the module
is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# no -march=native: the split's float sums must be the Python spec's on
# any host, so nothing may contract or reorder them
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]

_lock = threading.Lock()
_libs: dict = {}
# libraries compiled by build_all and loaded by load in this process: the
# served engine's warm-state evidence (a repeat job adds to neither)
COUNTS = {"built": 0, "loaded": 0}


def _sources() -> dict:
    return {os.path.splitext(f)[0]: os.path.join(CSRC, f)
            for f in sorted(os.listdir(CSRC)) if f.endswith((".cu", ".cpp"))}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME); the port's "
                       "CUDA kernels are compiled on the machine with the GPU")


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler found (set CXX); the port's native "
                       "split is compiled at first use")


def _command(src: str, out: str) -> list:
    if src.endswith(".cu"):
        return [_nvcc(), *NVCC_FLAGS, "-o", out, src]
    return [_cxx(), *CXX_FLAGS, "-o", out, src]


def build_dir() -> str:
    """The output directory: a hash of the flags, the sources and the
    headers they share (``csrc/*.cuh``)."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS + ["|"] + CXX_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh", ".cpp")):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build_all(names=None) -> dict:
    """Compile every source (or those in ``names``) not yet built; return
    {name: library path} for them."""
    sources = _sources()
    if names is not None:
        sources = {name: sources[name] for name in names}
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    libs = {name: os.path.join(out_dir, f"lib{name}.so") for name in sources}
    # every command is resolved before any compiler starts, so a missing
    # compiler raises with no process left behind
    todo = {}
    for name, src in sources.items():
        if not os.path.exists(libs[name]):
            tmp = os.path.join(out_dir, f"lib{name}.{os.getpid()}.tmp.so")
            todo[name] = (src, tmp, _command(src, tmp))
    procs = {name: (src, tmp, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for name, (src, tmp, cmd) in todo.items()}
    errors = []
    for name, (src, tmp, p) in procs.items():
        so, se = p.communicate()
        if p.returncode != 0:
            errors.append(f"compiling csrc/{os.path.basename(src)} failed "
                          f"(rc={p.returncode}):\n{se}{so}")
        else:
            os.replace(tmp, libs[name])
            COUNTS["built"] += 1
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all([name])[name])
            _libs[name] = lib
            COUNTS["loaded"] += 1
        return lib
