"""One daemon of the port in a subprocess (``python -m sheep_tpu_torch.cli
serve --device cpu``) on a unix socket under ``tmp_path``: the port's
``submit --wait`` and the JAX package's ``SheepClient`` both submit to
it, each result equals the in-process scheduler's, and SIGTERM drains it
to exit code 0. Every subprocess has a timeout and is killed in a
``finally``; this file starts one daemon at a time."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sheep_tpu.server.client import SheepClient as RefClient
from sheep_tpu_torch.server.protocol import JobSpec
from sheep_tpu_torch.server.scheduler import Scheduler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 60
CHUNK = 1024


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU kernels are many small ops: beside the other
    workers of a parallel run, torch's intra-op threads cost more than
    they save, so the module runs on one thread and restores the count
    after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
                PYTHONPATH=REPO)


def _in_process(body: dict):
    """The in-process scheduler's result of one request body."""
    sched = Scheduler(device="cpu")
    t = threading.Thread(target=sched.run, daemon=True)
    t.start()
    try:
        job = sched.wait(sched.submit(JobSpec.from_request(
            body, tenant="t")).id, timeout_s=WAIT)
        assert job.state == "done", job.error
        return job.results[0]
    finally:
        sched.shutdown()
        t.join(timeout=WAIT)
        assert not t.is_alive()


def _wait_for(path: str, proc) -> None:
    deadline = time.monotonic() + WAIT
    while not os.path.exists(path):
        assert proc.poll() is None, "the daemon exited"
        assert time.monotonic() < deadline, "daemon did not come up"
        time.sleep(0.05)


def test_daemon_serves_both_clients_and_drains_on_sigterm(tmp_path):
    sock = str(tmp_path / "d.sock")
    state = str(tmp_path / "state")
    body_a = {"input": "rmat:10:8:1", "k": [4], "chunk_edges": CHUNK,
              "comm_volume": True}
    body_b = {"input": "rmat:10:8:2", "k": [4], "chunk_edges": CHUNK,
              "return_assignment": True}
    log = open(tmp_path / "daemon.log", "w")
    daemon = subprocess.Popen(
        [sys.executable, "-m", "sheep_tpu_torch.cli", "serve", "--device",
         "cpu", "--socket", sock, "--state-dir", state, "--metrics-port",
         "0"], cwd=REPO, env=_env(), stdout=log, stderr=log)
    try:
        _wait_for(sock, daemon)
        # the port's client, as a user runs it
        out = subprocess.run(
            [sys.executable, "-m", "sheep_tpu_torch.cli", "submit",
             "--server", sock, "--input", body_a["input"], "--k", "4",
             "--chunk-edges", str(CHUNK), "--comm-volume", "--wait",
             "--timeout", str(WAIT), "--tenant", "port"],
            cwd=REPO, env=_env(), capture_output=True, text=True,
            timeout=WAIT + 30)
        assert out.returncode == 0, out.stderr
        desc_a = json.loads(out.stdout.strip().splitlines()[-1])
        # the reference's client, against the same daemon
        with RefClient(sock, timeout_s=WAIT) as c:
            jid = c.submit(body_b["input"], k=[4], tenant="ref",
                           chunk_edges=CHUNK,
                           return_assignment=True)["job_id"]
            desc_b = c.wait(jid, timeout_s=WAIT)
            assign_b = c.result_assignment(desc_b)
            text = c.metrics()
            # a repeat of the first request answers from the result store
            again = c.wait(c.submit(body_a["input"], k=[4], tenant="port",
                                    chunk_edges=CHUNK,
                                    comm_volume=True)["job_id"],
                           timeout_s=WAIT)
        assert desc_a["state"] == "done" and desc_b["state"] == "done"
        assert again["state"] == "done" and again["jit_compiles"] == 0
        assert again["results"][0]["edge_cut"] == \
            desc_a["results"][0]["edge_cut"]
        assert "sheepd_jobs_submitted_total" in text
        daemon.send_signal(signal.SIGTERM)
        assert daemon.wait(timeout=WAIT) == 0
        assert "shut down cleanly" in (tmp_path / "daemon.log").read_text()
    finally:
        if daemon.poll() is None:
            daemon.kill()
            daemon.wait(timeout=WAIT)
        log.close()
    ref_a = _in_process(body_a)
    ref_b = _in_process(body_b)
    row = desc_a["results"][0]
    assert (row["edge_cut"], row["total_edges"], row["comm_volume"]) == \
        (ref_a.edge_cut, ref_a.total_edges, ref_a.comm_volume)
    assert row["diagnostics"]["device_rounds"] == \
        ref_a.diagnostics["device_rounds"]
    np.testing.assert_array_equal(assign_b, ref_b.assignment)
    assert desc_b["results"][0]["edge_cut"] == ref_b.edge_cut


def test_in_process_daemon_leaves_signal_handlers_alone():
    from sheep_tpu_torch.server import daemon as daemon_mod

    before = (signal.getsignal(signal.SIGTERM),
              signal.getsignal(signal.SIGINT))
    args = daemon_mod.build_parser().parse_args(["--device", "cpu"])
    d = daemon_mod.Daemon(args)
    sched = Scheduler(device="cpu")
    assert d.scheduler is None and sched.budget is None
    assert (signal.getsignal(signal.SIGTERM),
            signal.getsignal(signal.SIGINT)) == before
    sched.shutdown()
    sched.run()  # returns at once, and takes its flight recorder down


def test_cli_verbs_top_and_device_default():
    from sheep_tpu_torch import cli

    assert cli.main(["top"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Scheduler()
