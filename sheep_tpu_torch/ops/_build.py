"""Build of the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The output goes
to ``sheep_tpu_torch/_build/<hash of the sources>/``, so an edited source
builds anew and an unchanged one is reused. All sources compile together,
one ``nvcc`` each, started at once. A failed build raises with nvcc's
stderr. Nothing is built when the module is imported.
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

_lock = threading.Lock()
_libs: dict = {}


def _sources() -> dict:
    return {f[:-3]: os.path.join(CSRC, f)
            for f in sorted(os.listdir(CSRC)) if f.endswith(".cu")}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME); the port's "
                       "CUDA kernels are compiled on the machine with the GPU")


def build_dir() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name, path in _sources().items():
        with open(path, "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build_all() -> dict:
    """Compile every source not yet built; return {name: library path}."""
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    libs = {name: os.path.join(out_dir, f"lib{name}.so")
            for name in _sources()}
    todo = {name: src for name, src in _sources().items()
            if not os.path.exists(libs[name])}
    if todo:
        nvcc = _nvcc()
        procs = {}
        for name, src in todo.items():
            tmp = os.path.join(out_dir, f"lib{name}.{os.getpid()}.tmp.so")
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        errors = []
        for name, (tmp, p) in procs.items():
            so, se = p.communicate()
            if p.returncode != 0:
                errors.append(f"nvcc failed on csrc/{name}.cu "
                              f"(rc={p.returncode}):\n{se}{so}")
            else:
                os.replace(tmp, libs[name])
        if errors:
            raise RuntimeError("\n".join(errors))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all()[name])
            _libs[name] = lib
        return lib
