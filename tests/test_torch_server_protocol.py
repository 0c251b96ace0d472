"""The served engine's host layers against the JAX package's: the wire
protocol (codec bytes, digests, errors, the backend names), the metric
registry's rendering (the reference's golden file) and parser, the job
journal's replay edge cases in both directions, the result store and
the flight recorder; and a fresh interpreter importing the port's
server modules pulls in neither JAX nor the JAX package."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from sheep_tpu.obs import metrics as ref_metrics
from sheep_tpu.server import journal as ref_journal
from sheep_tpu.server import protocol as ref_protocol
from sheep_tpu.server import resultstore as ref_resultstore
from sheep_tpu_torch.obs import metrics as port_metrics
from sheep_tpu_torch.obs.flightrec import FlightRecorder
from sheep_tpu_torch.server import journal as port_journal
from sheep_tpu_torch.server import protocol as port_protocol
from sheep_tpu_torch.server import resultstore as port_resultstore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "metrics_prom.txt")

# (request body, tenant): valid requests; their digests and wire bytes
VALID = [
    ({"input": "rmat:10:8:1", "k": 4}, "t"),
    ({"input": "rmat:10:8:1", "k": [8, 8, 4], "chunk_edges": 1024}, "a"),
    ({"input": "g.bin64", "k": [4], "dispatch_batch": 2, "h2d_ring": 1,
      "inflight": 3, "segment_rounds": 4, "alpha": 1.3,
      "weights": "degree", "comm_volume": True, "num_vertices": 99,
      "deadline_s": 5.5, "output": "o.parts",
      "return_assignment": True}, "b"),
    ({"input": "g.bin64", "k": 4, "resident": True}, "t"),
    ({"input": "g.bin64", "k": 4, "resident": True,
      "update_backend": "tpu-sharded"}, "t"),
    ({"input": "g.bin64", "k": 4, "update_backend": "tpu-bigv"}, "t"),
    ({"input": "g.bin64", "k": 4, "update_backend": "tpu"}, "t"),
]

# invalid requests with the same error in both packages
INVALID = [
    {"k": [4]},
    {"input": "g", "k": []},
    {"input": "g", "k": [0]},
    {"input": "g", "k": "4"},
    {"input": "g", "k": 4, "bogus": 1},
    {"input": "g", "k": 4, "deadline_s": -1},
    {"input": "g", "k": 4, "chunk_edges": 0},
    {"input": "g", "k": 4, "dispatch_batch": -1},
    {"input": "g", "k": 4, "h2d_ring": -2},
    {"input": "g", "k": 4, "inflight": -1},
    {"input": "g", "k": 4, "weights": "edge"},
    {"input": "g", "k": 4, "alpha": 0},
    [1, 2],
]

PORT_NAMES = {"tpu": "torch", "tpu-sharded": "torch-sharded",
              "tpu-bigv": "torch-bigv"}


def _error(mod, body):
    with pytest.raises(mod.ProtocolError) as e:
        mod.JobSpec.from_request(body)
    return str(e.value)


@pytest.mark.parametrize("body,tenant", VALID)
def test_valid_requests_same_spec_and_digest(body, tenant):
    ref = ref_protocol.JobSpec.from_request(dict(body), tenant=tenant)
    port = port_protocol.JobSpec.from_request(dict(body), tenant=tenant)
    want = {f: getattr(ref, f) for f in ref.__dataclass_fields__}
    got = {f: getattr(port, f) for f in port.__dataclass_fields__}
    # the port names the reference's backends by its own names
    want["update_backend"] = PORT_NAMES[want["update_backend"]]
    assert got == want
    assert port_journal.job_digest(port) == ref_journal.job_digest(ref)


@pytest.mark.parametrize("body", INVALID)
def test_invalid_requests_same_error(body):
    assert _error(port_protocol, body) == _error(ref_protocol, body)


def test_update_backend_names():
    def backend(name):
        return port_protocol.JobSpec.from_request(
            {"input": "g", "k": 4, "update_backend": name}).update_backend

    for name in ("torch", "torch-sharded", "torch-bigv"):
        assert backend(name) == name
    for ref_name, port_name in PORT_NAMES.items():
        assert backend(ref_name) == port_name
    # the default is the single-device backend in both packages
    assert port_protocol.JobSpec.from_request(
        {"input": "g", "k": 4}).update_backend == "torch"
    for name in ("pure", "cpu", "gpu"):
        msg = _error(port_protocol, {"input": "g", "k": 4,
                                     "update_backend": name})
        assert "torch/torch-sharded/torch-bigv" in msg and name in msg
    # a reference journal's spec reconstructs under the port's names
    spec = port_protocol.JobSpec(input="g", ks=[4],
                                 update_backend="tpu-bigv")
    assert spec.update_backend == "torch-bigv"


def test_codecs_and_lines_are_the_reference_bytes():
    g = np.random.default_rng(3)
    edges = g.integers(0, 1 << 40, size=(37, 2))
    assign = g.integers(0, 64, size=1001).astype(np.int32)
    assert port_protocol.encode_edges(edges) == \
        ref_protocol.encode_edges(edges)
    assert port_protocol.encode_assignment(assign) == \
        ref_protocol.encode_assignment(assign)
    doc = {"op": "submit", "tenant": "t", "job": {"input": "g", "k": [4]},
           "trace": ref_protocol.make_traceparent("ab" * 16, 7)}
    line = port_protocol.dumps(doc)
    assert line == ref_protocol.dumps(doc)
    assert port_protocol.parse_request(line.rstrip(b"\n")) == \
        ref_protocol.parse_request(line.rstrip(b"\n"))
    np.testing.assert_array_equal(port_protocol.decode_edges(
        ref_protocol.encode_edges(edges)), edges)
    np.testing.assert_array_equal(port_protocol.decode_assignment(
        ref_protocol.encode_assignment(assign)), assign)
    assert port_protocol.parse_traceparent(doc["trace"]) == \
        ref_protocol.parse_traceparent(doc["trace"])
    for bad in (b"[1]", b"{\"op\": \"nope\"}", b"not json"):
        with pytest.raises(port_protocol.ProtocolError) as e:
            port_protocol.parse_request(bad)
        with pytest.raises(ref_protocol.ProtocolError) as f:
            ref_protocol.parse_request(bad)
        assert str(e.value) == str(f.value)
    assert port_protocol.OPS == ref_protocol.OPS
    assert port_protocol.JOB_STATES == ref_protocol.JOB_STATES


def _golden_registry(mod):
    r = mod.MetricRegistry()
    c = r.counter("sheepd_jobs_submitted_total",
                  "jobs accepted at the protocol boundary", ("tenant",))
    c.inc(tenant="alice")
    c.inc(2, tenant="bob")
    g = r.gauge("sheepd_queue_depth", "jobs waiting for headroom")
    g.set(3)
    h = r.histogram("sheepd_request_latency_seconds",
                    "queued->done request latency (the SLO series)",
                    ("tenant",), buckets=(0.1, 1.0, 10.0))
    h.observe(0.05, tenant="alice")
    h.observe(1.0, tenant="alice")
    h.observe(25.0, tenant="alice")
    r.add_collector(lambda: {"sheepd_uptime_seconds": 42})
    r.add_collector(lambda: [("sheepd_job_steps",
                              {"job": "j1", "tenant": 'a"b'}, 7)])
    return r


def test_metrics_render_golden_and_parse_round_trip():
    text = _golden_registry(port_metrics).render()
    with open(GOLDEN) as f:
        assert text == f.read()
    assert text == _golden_registry(ref_metrics).render()
    parsed = port_metrics.parse_prometheus(text)
    assert parsed == ref_metrics.parse_prometheus(text)
    assert parsed["sheepd_jobs_submitted_total"] == [
        ({"tenant": "alice"}, 1.0), ({"tenant": "bob"}, 2.0)]
    assert ({"job": "j1", "tenant": 'a"b'}, 7.0) in \
        parsed["sheepd_job_steps"]
    for q in (0.1, 0.5, 0.9, 0.99):
        got, want = (mod_reg.histogram(
            "sheepd_request_latency_seconds", labelnames=("tenant",),
            buckets=(0.1, 1.0, 10.0)).quantile(q, tenant="alice")
            for mod_reg in (_golden_registry(port_metrics),
                            _golden_registry(ref_metrics)))
        assert got == want


# -- the journal: replay edge cases, each journal replayed by both ----------

SUBMIT = {"v": 1, "rec": "submit", "job_id": "j1", "t": 1.0,
          "tenant": "t", "n_vertices": 8, "state": "queued",
          "spec": {"input": "g.bin64", "ks": [4]}}


def _replays(path):
    """(port replay, reference replay) of one journal, each as a
    comparable tuple, or the exception type each raised."""
    out = []
    for mod in (port_journal, ref_journal):
        try:
            rep = mod.replay(str(path))
        except ValueError as e:
            out.append(type(e).__name__)
            continue
        out.append(([(j.job_id, j.state, j.error, j.end_t, j.results,
                      j.digest, j.delta_epoch, j.resident_released)
                     for j in rep.jobs], rep.next_id, rep.daemon_starts,
                    len(rep.warnings)))
    return out


def _lines(path, recs, tail=""):
    path.write_text("".join(json.dumps(r) + "\n" for r in recs) + tail)


CASES = {
    "missing": None,
    "empty": ([], ""),
    "torn_tail": ([SUBMIT], '{"v": 1, "rec": "termi'),
    "duplicate_terminal": ([SUBMIT,
                            {"v": 1, "rec": "terminal", "job_id": "j1",
                             "state": "done", "t": 2.0},
                            {"v": 1, "rec": "terminal", "job_id": "j1",
                             "state": "cancelled", "t": 3.0}], ""),
    "unknown_and_newer": ([SUBMIT,
                           {"v": 1, "rec": "replica_handoff",
                            "job_id": "j1"},
                           {"v": 99, "rec": "submit", "job_id": "j9",
                            "t": 9.0, "spec": {"input": "g", "ks": [4]}},
                           {"v": 1, "rec": "state", "job_id": "jX",
                            "state": "running"}], ""),
    "resident_lineage": ([dict(SUBMIT, job_id="j4"),
                          {"v": 1, "rec": "terminal", "job_id": "j4",
                           "state": "done", "t": 2.0,
                           "results": [{"k": 4, "edge_cut": 3}]},
                          {"v": 1, "rec": "delta_epoch", "job_id": "j4",
                           "epoch": 3},
                          {"v": 1, "rec": "resident_release",
                           "job_id": "j4"}], ""),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_journal_replay_edge_cases_both_packages(case, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv("SHEEP_IO_POLICY", "strict")
    path = tmp_path / "j.jsonl"
    if CASES[case] is not None:
        _lines(path, *CASES[case])
    port, ref = _replays(path)
    assert port == ref
    if case in ("missing", "empty"):
        assert port == ([], 1, 0, 0)
    if case == "torn_tail":
        assert port[0] == [("j1", "queued", None, None, None, None, 0,
                            False)]
    if case == "duplicate_terminal":
        assert port[0][0][1] == "done"
    if case == "resident_lineage":
        assert port[0][0][6:] == (3, True) and port[1] == 5


def test_journal_mid_file_damage_under_io_policy(tmp_path, monkeypatch):
    path = tmp_path / "j.jsonl"
    path.write_text(json.dumps(SUBMIT) + "\nGARBAGE NOT JSON\n" +
                    json.dumps({"v": 1, "rec": "terminal", "job_id": "j1",
                                "state": "done", "t": 2.0}) + "\n")
    monkeypatch.setenv("SHEEP_IO_POLICY", "strict")
    assert _replays(path) == ["JournalError", "JournalError"]
    monkeypatch.setenv("SHEEP_IO_POLICY", "quarantine")
    port, ref = _replays(path)
    assert port == ref and port[0][0][1] == "done"


def test_journal_written_by_either_replays_in_the_other(tmp_path):
    """A journal each package's appender wrote (a torn tail healed by
    the other's appender on reopen) replays to the same jobs in both."""
    for first, second in ((port_journal, ref_journal),
                          (ref_journal, port_journal)):
        path = tmp_path / f"{first.__name__.split('.')[0]}.jsonl"
        j = first.JobJournal(str(path))
        j.append({"rec": "daemon_start", "t": 1.0, "pid": 1}, fsync=True)
        j.append({k: v for k, v in SUBMIT.items() if k != "v"},
                 fsync=True)
        j.append({"rec": "state", "job_id": "j1", "state": "running",
                  "t": 2.0})
        j.close()
        with open(path, "a") as f:
            f.write('{"v": 1, "rec": "termi')  # the crash
        j = second.JobJournal(str(path))
        j.append({"rec": "daemon_start", "t": 3.0, "pid": 2}, fsync=True)
        j.close()
        port, ref = _replays(path)
        assert port == ref
        assert port[0][0][:2] == ("j1", "running") and port[2] == 2


def test_result_store_entries_shared(tmp_path, monkeypatch):
    """An entry either package's store wrote serves from the other's,
    and damage follows the IO policy in both."""
    row = {"k": 4, "edge_cut": 11, "total_edges": 40,
           "assignment": port_protocol.encode_assignment(
               np.arange(10) % 4)}
    entry = {"t": 1.0, "tenant": "t", "n_vertices": 10, "results": [row]}
    port = port_resultstore.ResultStore(str(tmp_path / "p"))
    ref = ref_resultstore.ResultStore(str(tmp_path / "r"))
    assert port.put("ab" * 20, entry) and ref.put("ab" * 20, entry)
    for name in os.listdir(tmp_path / "p"):
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "r" / name).read_bytes()
    reread = ref_resultstore.ResultStore(str(tmp_path / "p"))
    assert reread.get("ab" * 20)["results"][0]["edge_cut"] == 11
    path = tmp_path / "p" / os.listdir(tmp_path / "p")[0]
    path.write_bytes(path.read_bytes()[:-7])
    monkeypatch.setenv("SHEEP_IO_POLICY", "strict")
    with pytest.raises(port_resultstore.ResultStoreError):
        port.get("ab" * 20)
    monkeypatch.setenv("SHEEP_IO_POLICY", "quarantine")
    assert port.get("ab" * 20) is None and not path.exists()


def test_flight_recorder_rings_through_the_facade():
    from sheep_tpu_torch import obs

    fr = obs.install_flight(FlightRecorder(per_job=4))
    try:
        with obs.flight_job_context("j1"):
            assert obs.flight_job() == "j1"
            for i in range(6):
                obs.event("step", i=i)
        obs.event("job_phase", job="j2", phase="build")
        obs.event("daemon_note")
        assert [e["i"] for e in fr.events("j1")] == [2, 3, 4, 5]
        assert fr.events("j2")[0]["phase"] == "build"
        assert [e["ev"] for e in fr.events(None)] == ["daemon_note"]
        assert fr.dump_all(reason="test") == 3
    finally:
        obs.uninstall_flight()
    assert obs.flight_job() is None


def test_server_modules_import_no_jax():
    code = ("import sys\n"
            "import sheep_tpu_torch.server\n"
            "import sheep_tpu_torch.server.protocol, "
            "sheep_tpu_torch.server.journal, "
            "sheep_tpu_torch.server.resultstore, "
            "sheep_tpu_torch.server.engine, "
            "sheep_tpu_torch.server.scheduler, "
            "sheep_tpu_torch.server.daemon, "
            "sheep_tpu_torch.server.client, "
            "sheep_tpu_torch.obs.metrics, sheep_tpu_torch.obs.flightrec, "
            "sheep_tpu_torch.cli\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'sheep_tpu' or "
            "m.startswith('sheep_tpu.'))\n"
            "print(bad)\n")
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
