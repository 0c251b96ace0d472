"""The port's served engine in process (``Scheduler(device="cpu")``)
against the port's own ``partition`` and the JAX package's served jobs,
exactly: forest (assignment), ``edge_cut``, ``total_edges``,
``comm_volume``, ``device_rounds`` and every counter that is not a time.
Interleaved, faulted, resumed, drained and reattached jobs each equal
their solo runs, and a resident job's delta epoch equals the reference's
served epoch.

Every wait is bounded (60 s at most) and every dispatch thread is joined
with a timeout and asserted dead; both packages' fault state is reset
around each injection."""

import os
import threading
import time
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import sheep_tpu_torch
from sheep_tpu.server.protocol import JobSpec as RefJobSpec
from sheep_tpu.server.scheduler import Scheduler as RefScheduler
from sheep_tpu_torch.server.protocol import JobSpec
from sheep_tpu_torch.server.scheduler import Scheduler

INPUT_A = "rmat:10:8:1"
INPUT_B = "rmat:10:8:2"
CHUNK = 1024
WAIT = 60


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


@contextmanager
def running(sched_cls=Scheduler, **kw):
    if sched_cls is Scheduler:
        kw.setdefault("device", "cpu")
    sched = sched_cls(**kw)
    t = threading.Thread(target=sched.run, daemon=True,
                         name="test-torch-sheepd-dispatch")
    t.start()
    try:
        yield sched
    finally:
        sched.shutdown()
        t.join(timeout=WAIT)
        assert not t.is_alive(), "dispatch loop failed to shut down"


def spec(input=INPUT_A, ks=(4,), tenant="t", cls=JobSpec, **fields):
    body = {"input": input, "k": list(ks), "chunk_edges": CHUNK}
    body.update(fields)
    return cls.from_request(body, tenant=tenant)


def serve(sched, sp):
    job = sched.submit(sp)
    job = sched.wait(job.id, timeout_s=WAIT)
    assert job.state == "done", (job.state, job.error)
    return job


def counters(res) -> dict:
    """The result's counters that are not times, under the reference's
    keys (the port adds its own launch and round-log keys)."""
    return {k: v for k, v in res.diagnostics.items()
            if not (k.startswith("t_") or k.endswith("_ms")
                    or k.endswith("_s"))}


def same_result(got, want, launches: bool = False) -> None:
    np.testing.assert_array_equal(got.assignment, want.assignment)
    for key in ("k", "edge_cut", "total_edges", "comm_volume"):
        assert getattr(got, key) == getattr(want, key), key
    mine, theirs = counters(got), counters(want)
    for key in theirs:
        assert mine.get(key) == theirs[key], key
    if launches:
        assert {k: v for k, v in mine.items() if "launches" in k} == \
            {k: v for k, v in theirs.items() if "launches" in k}


@pytest.fixture(scope="module")
def reference():
    """The JAX package's served results: A (with comm volume) and B."""
    with running(RefScheduler) as sched:
        a = serve(sched, spec(INPUT_A, cls=RefJobSpec, comm_volume=True))
        b = serve(sched, spec(INPUT_B, cls=RefJobSpec))
        return {"A": a.results[0], "B": b.results[0]}


def test_served_equals_partition_and_reference(reference):
    with running() as sched:
        job = serve(sched, spec(INPUT_A, comm_volume=True))
        text = sched.render_metrics()
    res = job.results[0]
    assert res.backend == "sheepd"
    same_result(res, reference["A"])
    cli = sheep_tpu_torch.partition(INPUT_A, 4, device="cpu",
                                    chunk_edges=CHUNK, comm_volume=True)
    np.testing.assert_array_equal(res.assignment, cli.assignment)
    assert (res.edge_cut, res.total_edges, res.comm_volume) == \
        (cli.edge_cut, cli.total_edges, cli.comm_volume)
    assert res.diagnostics["device_rounds"] > 0
    from sheep_tpu_torch.obs.metrics import parse_prometheus

    assert ({"tenant": "t", "state": "done"}, 1.0) in \
        parse_prometheus(text)["sheepd_jobs_terminal_total"]


def test_multi_k_query_one_shared_tree():
    with running() as sched:
        job = serve(sched, spec(INPUT_A, ks=(4, 8)))
    assert [r.k for r in job.results] == [4, 8]
    for r in job.results:
        cli = sheep_tpu_torch.partition(INPUT_A, r.k, device="cpu",
                                        chunk_edges=CHUNK,
                                        comm_volume=False)
        np.testing.assert_array_equal(r.assignment, cli.assignment)
        assert r.edge_cut == cli.edge_cut


def test_warm_repeat_reports_zero_compiles():
    with running() as sched:
        first = serve(sched, spec(INPUT_B))
        repeat = serve(sched, spec(INPUT_B, tenant="again"))
    assert repeat.jit_compiles == 0
    assert first.jit_compiles is not None and first.jit_compiles >= 0
    same_result(repeat.results[0], first.results[0])


def test_interleaved_jobs_equal_their_solo_runs(reference):
    with running() as sched:
        ja = sched.submit(spec(INPUT_A, tenant="alice", comm_volume=True))
        jb = sched.submit(spec(INPUT_B, tenant="bob"))
        ja = sched.wait(ja.id, timeout_s=WAIT)
        jb = sched.wait(jb.id, timeout_s=WAIT)
    assert ja.state == "done" and jb.state == "done"
    # each started before the other finished: their steps alternated
    assert ja.start_t < jb.end_t and jb.start_t < ja.end_t
    same_result(ja.results[0], reference["A"])
    same_result(jb.results[0], reference["B"])


def test_admission_rejects_over_tiny_budget(monkeypatch):
    monkeypatch.setenv("SHEEP_CACHE_BYTES", "10000")
    with running() as sched:
        assert sched.budget == 10000
        job = sched.wait(sched.submit(spec()).id, timeout_s=WAIT)
    assert job.state == "rejected"
    assert "admission budget" in job.error and "10,000" in job.error


def test_cpu_has_no_budget_unless_set(monkeypatch):
    monkeypatch.delenv("SHEEP_CACHE_BYTES", raising=False)
    with running() as sched:
        assert sched.budget is None


def test_admission_queues_on_headroom_then_serializes():
    from sheep_tpu_torch.utils import membudget

    m = membudget.build_phase_bytes(1 << 10, CHUNK,
                                    dispatch_batch=1)["total_bytes"]
    with running(budget_bytes=int(1.5 * m)) as sched:
        ja = sched.submit(spec(INPUT_A, dispatch_batch=1))
        jb = sched.submit(spec(INPUT_B, dispatch_batch=1))
        ja = sched.wait(ja.id, timeout_s=WAIT)
        jb = sched.wait(jb.id, timeout_s=WAIT)
    assert ja.state == "done" and jb.state == "done"
    assert jb.start_t >= ja.end_t, \
        "second job admitted before the first released its bytes"


def test_cancellation_frees_the_queue(reference):
    from sheep_tpu_torch.utils import membudget

    mv = membudget.build_phase_bytes(1 << 12, 256,
                                     dispatch_batch=1)["total_bytes"]
    with running(budget_bytes=int(1.1 * mv)) as sched:
        victim = sched.submit(JobSpec.from_request(
            {"input": "rmat:12:8:3", "k": [4], "chunk_edges": 256,
             "dispatch_batch": 1}, tenant="victim"))
        jb = sched.submit(spec(INPUT_B, dispatch_batch=1))
        jc = sched.submit(spec(INPUT_A, dispatch_batch=1))
        # a queued job leaves the queue at once
        assert sched.cancel(jc.id) == "cancelled"
        deadline = time.monotonic() + WAIT
        while sched.get(victim.id).state == "queued" \
                and time.monotonic() < deadline:
            time.sleep(0.002)
        sched.cancel(victim.id)
        victim = sched.wait(victim.id, timeout_s=WAIT)
        jb = sched.wait(jb.id, timeout_s=WAIT)
    assert victim.state == "cancelled"
    assert jb.state == "done", jb.error
    same_result(jb.results[0], reference["B"])


def test_deadline_does_not_poison_the_jobs_around_it(reference):
    with running() as sched:
        doomed = sched.submit(JobSpec.from_request(
            {"input": "rmat:12:8:3", "k": [4], "chunk_edges": 256,
             "deadline_s": 0.005}, tenant="doomed"))
        jb = sched.submit(spec(INPUT_B, tenant="bob"))
        doomed = sched.wait(doomed.id, timeout_s=WAIT)
        jb = sched.wait(jb.id, timeout_s=WAIT)
        again = serve(sched, spec(INPUT_B))
    assert doomed.state == "deadline_exceeded"
    assert jb.state == "done", jb.error
    same_result(jb.results[0], reference["B"])
    same_result(again.results[0], reference["B"])


@contextmanager
def armed(monkeypatch, inject: str):
    """``SHEEP_FAULT_INJECT`` armed around one job; both packages read it
    and keep their own shot state, so both are reset on each side."""
    from sheep_tpu.utils import fault as ref_fault
    from sheep_tpu_torch.utils import fault

    monkeypatch.setenv("SHEEP_FAULT_INJECT", inject)
    monkeypatch.setenv("SHEEP_RETRY_BASE_S", "0.01")
    fault.reset()
    ref_fault.reset()
    try:
        yield
    finally:
        monkeypatch.delenv("SHEEP_FAULT_INJECT")
        fault.reset()
        ref_fault.reset()


def test_oom_and_read_faults_degrade_the_job_bit_identically(
        tmp_path, monkeypatch):
    from sheep_tpu_torch.io import formats

    graph = str(tmp_path / "soak.bin64")
    formats.write_edges(graph, np.random.default_rng(7).integers(
        0, 512, (4096, 2)))
    body = {"input": graph, "k": [4], "chunk_edges": 512,
            "num_vertices": 512}
    with running() as sched:
        clean = serve(sched, JobSpec.from_request(body, tenant="clean"))
        for inject, retried in (("oom@dispatch:1", True),
                                ("read@read:2", False)):
            with armed(monkeypatch, inject):
                job = serve(sched, JobSpec.from_request(body,
                                                        tenant=inject))
            np.testing.assert_array_equal(job.results[0].assignment,
                                          clean.results[0].assignment)
            assert job.results[0].edge_cut == clean.results[0].edge_cut
            if retried:
                assert job.stats.get("dispatch_retries", 0) >= 1
        # and the scheduler goes on serving
        serve(sched, JobSpec.from_request(body, tenant="after"))


def test_fault_budget_exhaustion_fails_the_job_not_the_daemon(
        monkeypatch):
    monkeypatch.setenv("SHEEP_RETRY_MAX", "2")
    with running() as sched:
        with armed(monkeypatch, "oom@dispatch:1:99"):
            doomed = sched.wait(sched.submit(spec(tenant="doomed")).id,
                                timeout_s=WAIT)
        assert doomed.state == "failed"
        assert "RESOURCE_EXHAUSTED" in doomed.error \
            or "out of memory" in doomed.error.lower()
        serve(sched, spec(tenant="after"))


def durable(tmp_path):
    return str(tmp_path / "journal.jsonl"), str(tmp_path / "ckpt")


def crash_mid_build(jpath, ck, sp, min_steps=4):
    """A durable scheduler driven to mid-build on this thread, then
    abandoned as a kill leaves it on disk: no finalize, no terminal
    record, checkpoints in place. Returns the job id."""
    sched = Scheduler(journal=jpath, checkpoint_dir=ck, checkpoint_every=1,
                      device="cpu")
    job = sched.submit(sp)
    with sched._lock:
        sched._admit_locked()
    for _ in range(2000):
        sched._step(job)
        if job.phase == "build" and job.steps >= min_steps \
                and job.stats.get("ckpt_saves"):
            break
        assert job.state == "running", (job.state, job.error)
    assert job.phase == "build"
    job.gen.close()
    sched.journal.close()
    return job.id


def test_abandoned_mid_build_replays_and_resumes(tmp_path, reference):
    jpath, ck = durable(tmp_path)
    jid = crash_mid_build(jpath, ck, spec(INPUT_B))
    with running(journal=jpath, checkpoint_dir=ck,
                 checkpoint_every=1) as sched:
        job = sched.wait(jid, timeout_s=WAIT)
        assert sched.stats()["restarts"] == 1
    assert job.state == "done", job.error
    assert job.stats.get("journal_resumed") == 1
    assert job.stats.get("resume_phase_idx") == 1.0  # the build
    res = job.results[0]
    np.testing.assert_array_equal(res.assignment,
                                  reference["B"].assignment)
    assert (res.edge_cut, res.total_edges) == \
        (reference["B"].edge_cut, reference["B"].total_edges)
    # a terminal job leaves no checkpoint behind
    assert not os.path.exists(os.path.join(ck, jid))


def test_shutdown_suspend_drains_then_resumes(tmp_path, reference):
    jpath, ck = durable(tmp_path)
    sched = Scheduler(journal=jpath, checkpoint_dir=ck, checkpoint_every=4,
                      device="cpu")
    job = sched.submit(spec(INPUT_B))
    with sched._lock:
        sched._admit_locked()
    for _ in range(6):
        sched._step(job)
    sched.shutdown_suspend(grace_s=30)
    t = threading.Thread(target=sched.run, daemon=True)
    t.start()
    t.join(timeout=WAIT)
    assert not t.is_alive(), "the drain did not finish"
    assert job.suspended and job.state == "running"
    with pytest.raises(Exception, match="shutting down"):
        sched.submit(spec(INPUT_A))
    with running(journal=jpath, checkpoint_dir=ck,
                 checkpoint_every=4) as sched2:
        done = sched2.wait(job.id, timeout_s=WAIT)
    assert done.state == "done", done.error
    assert done.stats.get("journal_resumed") == 1
    np.testing.assert_array_equal(done.results[0].assignment,
                                  reference["B"].assignment)


def test_digest_matched_resubmit_reattaches(tmp_path):
    jpath, ck = durable(tmp_path)
    with running(journal=jpath, checkpoint_dir=ck) as sched:
        first, again = sched.reattach_or_submit(spec(INPUT_A))
        assert not again
        twin, again = sched.reattach_or_submit(spec(INPUT_A))
        assert again and twin is first
        assert sched.wait(first.id, timeout_s=WAIT).state == "done"
        other, again = sched.reattach_or_submit(spec(INPUT_A, ks=(8,)))
        assert not again and other.id != first.id
        sched.wait(other.id, timeout_s=WAIT)
    with running(journal=jpath, checkpoint_dir=ck) as sched2:
        # the journaled DONE twin answers after a restart
        twin, again = sched2.reattach_or_submit(spec(INPUT_A))
        assert again and twin.id == first.id and twin.state == "done"


def test_resident_delta_epoch_equals_reference_epoch(tmp_path):
    rng = np.random.default_rng(21)
    n = 512
    E = rng.integers(0, n, (3000, 2)).astype(np.int64)
    base = str(tmp_path / "base.bin64")
    with open(base, "wb") as f:
        f.write(E[:1500].astype("<u8").tobytes())
    out = []
    for cls, sp_cls, backend in ((Scheduler, JobSpec, "torch"),
                                 (RefScheduler, RefJobSpec, "tpu")):
        sp = spec(base, cls=sp_cls, chunk_edges=512, num_vertices=n,
                  resident=True, update_backend=backend)
        with running(cls) as sched:
            job = serve(sched, sp)
            r1 = sched.update(job.id, adds=E[1500:2200], epoch=1,
                              timeout_s=WAIT)
            r2 = sched.update(job.id, adds=E[2200:], dels=E[:100],
                              epoch=2, score=True, timeout_s=WAIT)
            info = sched.epoch_info(job.id, timeout_s=WAIT)
            out.append((r1, r2, info,
                        sched.get(job.id).results[0].assignment.copy()))
    (p1, p2, pinfo, passign), (q1, q2, qinfo, qassign) = out
    assert p1 == q1 and pinfo == qinfo
    assert p2["epoch"] == 2 == q2["epoch"]
    for mine, theirs in zip(p2["results"], q2["results"]):
        for key in ("k", "edge_cut", "total_edges", "balance"):
            assert mine[key] == theirs[key], key
    np.testing.assert_array_equal(passign, qassign)


def test_profile_verb_captures_steps_then_stops(tmp_path):
    from sheep_tpu_torch.server.protocol import ProtocolError

    with running() as sched:
        with pytest.raises(ProtocolError):
            sched.arm_profile(str(tmp_path), steps=0)
        info = sched.arm_profile(str(tmp_path / "prof"), steps=3)
        assert info["state"] == "armed"
        with pytest.raises(ProtocolError, match="already"):
            sched.arm_profile(str(tmp_path / "other"))
        serve(sched, spec(INPUT_B))
        deadline = time.monotonic() + WAIT
        while sched.stats()["profile"]["state"] in ("armed", "capturing") \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        prof = sched.stats()["profile"]
    assert prof["state"] == "done" and prof["steps_captured"] == 3
    assert os.path.exists(tmp_path / "prof" / "sheepd_trace.json")
