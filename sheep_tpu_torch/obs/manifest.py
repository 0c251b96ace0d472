"""Run manifest: what ran, captured at launch (the port's copy of
``sheep_tpu/obs/manifest.py``).

One ``manifest`` record a traced run makes a trace file self-describing:
the command line and its config, the backend, the git SHA, the versions
and the device. Where the reference records jax, jaxlib and its devices,
the port records ``torch_version``, ``cuda_version`` (``torch.version.cuda``),
``platform`` ("gpu" or "cpu"), ``devices`` (each with its name and compute
capability) and the card's ``power_limit`` as ``nvidia-smi`` reports it.
Collection is best-effort: a field that cannot be read is null, with an
``*_error`` field beside it, and never takes the run down. A CPU run does
not touch ``torch.cuda`` or ``nvidia-smi``.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Optional


def _git_sha(repo_dir: str) -> Optional[str]:
    """HEAD's short commit: ``git`` first, then the ``.git`` files, so a
    checkout without the git binary still records it."""
    try:
        r = subprocess.run(["git", "rev-parse", "--short=12", "HEAD"],
                           cwd=repo_dir, capture_output=True, text=True,
                           timeout=5)
        if r.returncode == 0 and r.stdout.strip():
            return r.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    try:
        with open(os.path.join(repo_dir, ".git", "HEAD")) as f:
            head = f.read().strip()
        if head.startswith("ref: "):
            ref = os.path.join(repo_dir, ".git", *head[5:].split("/"))
            with open(ref) as f:
                return f.read().strip()[:12]
        return head[:12]
    except OSError:
        return None


def _jsonable_config(config: dict) -> dict:
    """An argparse namespace holds simple values, but anything that is not
    JSON is written as its text rather than failing the record."""
    import json

    out = {}
    for k, v in config.items():
        try:
            json.dumps(v)
            out[k] = v
        except (TypeError, ValueError):
            out[k] = str(v)
    return out


def _smi_line(index: int) -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for card ``index``."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=30)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi exited {r.returncode}: "
                           f"{r.stderr.strip()[:200]}")
    return r.stdout.strip().splitlines()[index]


def collect_manifest(config: Optional[dict] = None,
                     backend: Optional[str] = None, device=None) -> dict:
    """The manifest record's body for a run on ``device`` (None: CUDA, as
    the entry points default). In a multi-process run each device entry
    also names its process (this one's rank)."""
    rec = _collect(config, backend, device)
    if rec["process_count"] > 1:
        for dev in rec.get("devices") or ():
            dev["process"] = rec["process_index"]
    return rec


def _collect(config, backend, device) -> dict:
    import platform as _platform

    import numpy as np
    import torch

    repo_dir = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    rec: dict = {
        "argv": list(sys.argv),
        "python": sys.version.split()[0],
        "hostname": _platform.node(),
        "pid": os.getpid(),
        "git_sha": _git_sha(repo_dir),
        "numpy_version": np.__version__,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }
    # this process's rank in a multi-process run, and its devices' process
    from sheep_tpu_torch.parallel.mesh import host_shard_info

    rank, world = host_shard_info()
    rec["process_index"], rec["process_count"] = rank, world
    if backend is not None:
        rec["backend"] = backend
    if config is not None:
        rec["config"] = _jsonable_config(dict(config))
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        rec.update(platform="cpu", device_count=1, local_device_count=1,
                   devices=[{"id": 0, "name": "cpu", "capability": None}],
                   power_limit=None)
        return rec
    rec["platform"] = "gpu"
    try:
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        rec["device_count"] = rec["local_device_count"] = \
            torch.cuda.device_count()
        rec["devices"] = [
            {"id": i, "name": torch.cuda.get_device_name(i),
             "capability": ".".join(
                 str(c) for c in torch.cuda.get_device_capability(i))}
            for i in range(rec["device_count"])]
        rec["device_index"] = index
    except Exception as e:  # noqa: BLE001, a broken runtime is recorded
        rec["devices"] = None
        rec["cuda_error"] = f"{type(e).__name__}: {str(e)[:200]}"
        index = 0
    try:
        rec["power_limit"] = _smi_line(index).rsplit(",", 1)[1].strip()
    except Exception as e:  # noqa: BLE001, as the reference's jax_error
        rec["power_limit"] = None
        rec["power_limit_error"] = f"{type(e).__name__}: {str(e)[:200]}"
    return rec


def emit_manifest(tracer, config: Optional[dict] = None,
                  backend: Optional[str] = None, device=None) -> dict:
    rec = collect_manifest(config=config, backend=backend, device=device)
    tracer.emit("manifest", **rec)
    return rec
