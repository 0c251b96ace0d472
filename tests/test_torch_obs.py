"""The port's observability (``sheep_tpu_torch/obs``, ``utils/metrics.py``
and the CLI's --trace, --heartbeat-secs, --metrics-out and --profile-dir)
on the CPU: the tracer, heartbeat, manifest and metrics writer alone, as
``tests/test_obs.py`` holds the JAX package's; then the same CLI runs of
both packages, whose traces must give the same span tree, the same event
names and fields and the same counter deltas a span, and which
``tools/trace_report.py --check`` accepts."""

import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sheep_tpu import cli as jcli
from sheep_tpu import obs as jobs
from sheep_tpu.utils import fault as jfault

from sheep_tpu_torch import cli, obs
from sheep_tpu_torch.backends.torch_backend import LAUNCH_KEYS
from sheep_tpu_torch.obs import Heartbeat, Tracer
from sheep_tpu_torch.utils import fault, metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPEC = "rmat-hash:12:16:42"
BASE = ["--input", SPEC, "--chunk-edges", "1024", "--heartbeat-secs",
        "0.2", "--json"]

# Counters the port's drivers keep and the reference's do not: the
# resolved dispatch batch and depth on the per-segment driver too (the
# reference records them on the batched one alone), the batched
# executions' device round log (rounds enqueued, depth and live-slot
# sums and maxima) and the kernels' launches (0 on the CPU, so never in a
# delta here).
PORT_COUNTERS = {"dispatch_batch", "inflight_depth", "rounds_enqueued",
                 "depth_sum", "depth_max", "live_sum", "live_max",
                 *LAUNCH_KEYS}
# Bytes the H2D ring has staged when a span closes: its worker thread reads
# ahead as the scheduler lets it, on both packages, so the split between
# spans varies run to run; the totals are compared.
LOOKAHEAD = {"h2d_staged_bytes"}
# Manifest fields of one package alone: the reference's jax and jaxlib
# versions, the port's torch and CUDA versions and the card's power limit.
JAX_MANIFEST = {"jax_version", "jaxlib_version"}
PORT_MANIFEST = {"torch_version", "cuda_version", "power_limit"}
# Values that differ by name (the backend, "tpu" against "torch", also in
# a retry's "where"), and seconds.
UNCOMPARED = {"backend", "where", "wall_seconds", "edges_per_sec",
              "phase_times", "seconds", "secs", "ts"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU runs issue many small ops; beside the other workers
    of a parallel test run torch's intra-op threads cost more than they
    save."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_reference_flight_recorder():
    """The reference's process-wide flight recorder (its served scheduler
    installs one) adds ``flight_dump`` events to the reference's traces on
    an injected fault. A test file run earlier in the same worker can leave
    one installed; the port's recorder is a no-op until the served engine
    is ported. So each test here runs with none installed, and any that was
    is put back after."""
    was = jobs.uninstall_flight()
    yield
    if was is not None:
        jobs.install_flight(was)


def _records(buf):
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def _timing(key: str) -> bool:
    return key.endswith("_ms") or key.endswith("_s") or key.startswith("t_")


# -- spans and counters ------------------------------------------------------

def test_span_nesting_parent_ids():
    buf = io.StringIO()
    with obs.tracing(buf):
        with obs.span("a"):
            with obs.span("b", i=1):
                pass
            with obs.span("b", i=2):
                with obs.span("c"):
                    pass
    recs = _records(buf)
    starts = {r["id"]: r for r in recs if r["event"] == "span_start"}
    ends = {r["id"]: r for r in recs if r["event"] == "span_end"}
    assert set(starts) == set(ends)
    by_name = {}
    for r in ends.values():
        by_name.setdefault(r["span"], []).append(r)
    a = by_name["a"][0]
    assert a["parent"] is None
    assert all(b["parent"] == a["id"] for b in by_name["b"])
    assert by_name["c"][0]["parent"] == by_name["b"][1]["id"]
    for r in ends.values():
        assert starts[r["id"]]["parent"] == r["parent"]
    assert sorted(b["i"] for b in by_name["b"]) == [1, 2]
    assert all(e["secs"] >= 0 for e in ends.values())


def test_span_begin_end_annotate_and_detached():
    buf = io.StringIO()
    with obs.tracing(buf):
        sp = obs.begin("seg", i=7)
        sp.annotate(cut_before=5)
        sp.end(rounds=3)
        sp.end(rounds=99)  # a second end is a no-op
        with obs.span("outer") as outer:
            assert obs.current_span_id() == outer.id
            det = obs.begin_detached("job", parent=None)
            inner = obs.begin("inner")
            inner.end()
            det.end()
    ends = {r["span"]: r for r in _records(buf) if r["event"] == "span_end"}
    assert ends["seg"]["rounds"] == 3 and ends["seg"]["i"] == 7
    assert ends["seg"]["cut_before"] == 5
    assert ends["job"]["parent"] is None, "detached: not on the stack"
    assert ends["inner"]["parent"] == ends["outer"]["id"]


def test_span_counter_deltas_at_boundaries():
    buf = io.StringIO()
    with obs.tracing(buf):
        with obs.span("outer"):
            obs.inc("syncs")
            with obs.span("inner"):
                obs.inc("syncs")
                obs.absorb({"rounds": 5, "mode": "compact"})
            obs.gauge("parts", 3)
    recs = _records(buf)
    ends = {r["span"]: r for r in recs if r["event"] == "span_end"}
    assert ends["inner"]["counters"] == {"syncs": 1, "rounds": 5,
                                         "mode": "compact"}
    assert ends["outer"]["counters"]["syncs"] == 2
    assert ends["outer"]["counters"]["parts"] == 3
    final = [r for r in recs if r["event"] == "counters"]
    assert final and final[0]["syncs"] == 2 and final[0]["rounds"] == 5


def test_disabled_tracing_is_noop():
    """Off, every facade call is one global read and a shared no-op."""
    assert obs.get_tracer() is None and not obs.enabled()
    assert obs.span("x") is obs.NULL_SPAN and obs.begin("x") is obs.NULL_SPAN
    assert obs.begin_detached("x") is obs.NULL_SPAN
    assert obs.stats_accumulator() is obs.NULL_STATS
    with obs.span("x", i=1) as sp:
        sp.annotate(a=1)
        sp.end()
    obs.inc("c")
    obs.gauge("g", 1)
    obs.absorb({"a": 1})
    obs.stats_accumulator().absorb({"a": 1})
    obs.progress(chunks_done=3)
    obs.chunk_progress(1, 10)
    obs.event("whatever", x=1)
    assert obs.current_span_id() is None
    assert obs.flight_job() is None
    with obs.flight_job_context("job"):
        pass
    assert obs.get_tracer() is None


def test_error_inside_span_is_recorded_and_closed():
    buf = io.StringIO()
    with pytest.raises(RuntimeError):
        with obs.tracing(buf):
            with obs.span("doomed"):
                raise RuntimeError("boom")
    ends = [r for r in _records(buf) if r["event"] == "span_end"]
    assert ends and ends[0]["error"] == "RuntimeError"
    assert obs.get_tracer() is None


def test_registry_and_accumulator_match_jax():
    """The same absorb, inc and gauge sequence gives the reference's
    registry, deltas and span records (timestamps and seconds aside)."""

    def run(pkg):
        buf = io.StringIO()
        reg = pkg.CounterRegistry()
        reg.inc("a")
        reg.inc("a", 4)
        reg.gauge("mode", "dense")
        before = reg.snapshot()
        reg.absorb({"a": 9, "b": 2.5, "mode": "compact"})
        reg.absorb({"a": 9, "b": 2.5})  # overwrite-merge is idempotent
        delta = pkg.CounterRegistry.delta(before, reg.snapshot())
        with pkg.tracing(buf):
            for run_i in range(2):
                acc = pkg.stats_accumulator()  # fresh a run
                stats = {}
                with pkg.span("build", run=run_i):
                    for syncs in (1, 2, 3):
                        stats["host_syncs"] = syncs
                        stats["mode"] = "compact"
                        acc.absorb(stats)
        recs = [{k: v for k, v in r.items() if k not in ("ts", "secs")}
                for r in _records(buf)]
        return dict(reg), delta, recs

    ours, ref = run(obs), run(jobs)
    assert ours == ref
    assert ours[1] == {"a": 4, "b": 2.5, "mode": "compact"}
    builds = [r for r in ours[2] if r["event"] == "span_end"]
    assert [b["counters"]["host_syncs"] for b in builds] == [3, 3]
    assert ours[2][-1]["host_syncs"] == 6


def test_writer_is_thread_safe():
    buf = io.StringIO()
    tr = Tracer(buf)

    def hammer(tid):
        for i in range(50):
            tr.emit("e", tid=tid, i=i)

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert len(_records(buf)) == 200  # raises on an interleaved line


# -- heartbeat ---------------------------------------------------------------

@pytest.mark.parametrize("interval,steps", [(0.05, 4), (60.0, 0)])
def test_heartbeat_cadence_and_final_flush(interval, steps):
    """At a 50 ms cadence over ~600 ms of work: several beats, a rate and
    an ETA; at 60 s, the final flush alone. Either way the last beat is
    final and carries the counters, and a CPU run has no memory field."""
    buf = io.StringIO()
    tr = Tracer(buf)
    obs.install(tr)
    try:
        hb = Heartbeat(tr, interval, device=torch.device("cpu")).start()
        obs.progress(phase="build", edges_done=0, edges_total=1000)
        for i in range(steps):
            time.sleep(0.15)
            obs.progress(edges_done=(i + 1) * 250)
            obs.inc("host_syncs")
        hb.stop()
    finally:
        obs.uninstall()
        tr.close()
    beats = [r for r in _records(buf) if r["event"] == "heartbeat"]
    assert [b["seq"] for b in beats] == list(range(len(beats)))
    assert beats[-1]["final"] is True
    assert all("memory" not in b for b in beats)
    if steps:
        assert len(beats) >= 3, beats
        assert beats[-1]["edges_done"] == 1000
        assert beats[-1]["counters"]["host_syncs"] == steps
        assert any("edges_per_sec" in b for b in beats)
        assert any("eta_s" in b for b in beats)
    else:
        assert len(beats) == 1


def test_heartbeat_survives_emit_failures():
    """A failed write must not end the thread: silence reads as a dead
    run."""
    buf = io.StringIO()
    tr = Tracer(buf)
    fails = {"n": 2}
    real_emit = tr.emit

    def flaky_emit(event, **fields):
        if event == "heartbeat" and fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("disk blip")
        real_emit(event, **fields)

    tr.emit = flaky_emit
    hb = Heartbeat(tr, 0.05).start()
    deadline = time.time() + 10
    while fails["n"] > 0 and time.time() < deadline:
        time.sleep(0.05)
    time.sleep(0.15)  # at least one beat after the failures
    hb.stop()
    tr.close()
    beats = [r for r in _records(buf) if r["event"] == "heartbeat"]
    assert fails["n"] == 0
    assert len(beats) >= 2 and beats[-1]["final"] is True


# -- the CPU never touches torch.cuda; the card's branch, faked ---------------

@pytest.fixture
def no_cuda(monkeypatch):
    """torch.cuda and nvidia-smi raise if anything calls them."""
    def boom(*a, **k):
        raise AssertionError("a CPU run touched torch.cuda or nvidia-smi")

    for name in ("is_available", "device_count", "current_device",
                 "get_device_name", "get_device_capability",
                 "get_device_properties", "memory_stats", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, boom)
    real_run = subprocess.run

    def run(cmd, *a, **k):
        if cmd and cmd[0] == "nvidia-smi":
            boom()
        return real_run(cmd, *a, **k)

    monkeypatch.setattr(subprocess, "run", run)


def test_cpu_run_never_touches_cuda(no_cuda):
    """Manifest, heartbeat and metrics of a CPU device: no torch.cuda call,
    no nvidia-smi, no memory records."""
    m = obs.collect_manifest(config={"k": 8}, backend="torch",
                             device="cpu")
    assert m["platform"] == "cpu" and m["power_limit"] is None
    assert metrics.device_memory_stats("cpu") is None
    buf = io.StringIO()
    with obs.tracing(buf, heartbeat_secs=0.05, device="cpu"):
        time.sleep(0.12)
    beats = [r for r in _records(buf) if r["event"] == "heartbeat"]
    assert beats and all("memory" not in b for b in beats)


def test_manifest_completeness_matches_jax():
    """The reference's fields, with jax's replaced by torch's, CUDA's and
    the power limit's; JSON-clean even with an odd config value."""
    config = {"input": "g.edges", "k": 8, "weird": object()}
    m = obs.collect_manifest(config=config, backend="torch", device="cpu")
    ref = jobs.collect_manifest(config=config, backend="tpu")
    assert set(m) - PORT_MANIFEST == set(ref) - JAX_MANIFEST
    assert m["git_sha"] and m["git_sha"] == ref["git_sha"]
    assert m["config"] == ref["config"] and m["config"]["k"] == 8
    assert m["torch_version"] == torch.__version__
    assert m["cuda_version"] == torch.version.cuda
    assert m["devices"] == [{"id": 0, "name": "cpu", "capability": None}]
    json.dumps(m)


@pytest.mark.parametrize("smi", ["ok", "missing"])
def test_manifest_and_memory_on_a_card(monkeypatch, smi):
    """The card's branch with torch.cuda and nvidia-smi faked: its name,
    capability and power limit; a failed nvidia-smi leaves the field null
    with its error, as the reference's jax_error. The allocator's counters
    under the reference's names, read for the run's device."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda i=0: (9, 0))
    real_run = subprocess.run

    def run(cmd, *a, **k):
        if cmd and cmd[0] == "nvidia-smi":
            if smi == "missing":
                raise FileNotFoundError("nvidia-smi")
            return subprocess.CompletedProcess(
                cmd, 0, "NVIDIA H100 80GB HBM3, 700.00 W\n", "")
        return real_run(cmd, *a, **k)

    monkeypatch.setattr(subprocess, "run", run)
    m = obs.collect_manifest(backend="torch", device="cuda")
    assert m["platform"] == "gpu" and m["device_count"] == 1
    assert m["devices"] == [{"id": 0, "name": "NVIDIA H100 80GB HBM3",
                             "capability": "9.0"}]
    if smi == "ok":
        assert m["power_limit"] == "700.00 W"
        assert "power_limit_error" not in m
    else:
        assert m["power_limit"] is None
        assert m["power_limit_error"].startswith("FileNotFoundError")

    seen = []

    def memory_stats(device):
        seen.append(device)
        return {"allocated_bytes.all.current": 5,
                "allocated_bytes.all.peak": 9,
                "reserved_bytes.all.current": 16,
                "reserved_bytes.all.peak": 32}

    class Props:
        total_memory = 80 << 30

    monkeypatch.setattr(torch.cuda, "memory_stats", memory_stats)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: Props)
    mem = metrics.device_memory_stats("cuda:0")
    assert mem == {"bytes_in_use": 5, "peak_bytes_in_use": 9,
                   "bytes_reserved": 16, "peak_bytes_reserved": 32,
                   "bytes_limit": 80 << 30}
    assert seen == [torch.device("cuda:0")]


# -- the metrics writer --------------------------------------------------------

def test_jsonable_numpy_and_tensors():
    """numpy scalars as the reference writes them; a CPU tensor as its
    list; a tensor off the CPU (a meta tensor stands in for one on the
    card) refused with a TypeError, never pulled."""
    buf = io.StringIO()
    mw = metrics.MetricsWriter(buf)
    fields = dict(flag=np.bool_(True), f32=np.float32(1.5),
                  i16=np.int16(-3), s=np.str_("hi"), b=np.bytes_(b"raw"),
                  dt=np.datetime64("2026-08-03"),
                  arr=np.array([np.bool_(False)]))
    mw.emit("diag", t=torch.tensor([1, 2]), **fields)
    rec = _records(buf)[0]
    ref_buf = io.StringIO()
    from sheep_tpu.utils.metrics import MetricsWriter as JMetricsWriter

    JMetricsWriter(ref_buf).emit("diag", **fields)
    ref = _records(ref_buf)[0]
    assert {k: v for k, v in rec.items() if k not in ("ts", "t")} == \
        {k: v for k, v in ref.items() if k != "ts"}
    assert rec["t"] == [1, 2] and rec["b"] == "raw"
    with pytest.raises(TypeError, match="meta tensor"):
        mw.emit("diag", t=torch.empty(2, device="meta"))


# -- the CLI -------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--input", "x", "--k", "2", "--heartbeat-secs", "1"],
    ["--input", "x", "--k", "2", "--trace", "t", "--heartbeat-secs", "0"],
    ["--input", "x", "--k-levels", "2,2", "--metrics-out", "m"],
    ["--input", "x", "--k-levels", "2,2", "--profile-dir", "p"]])
def test_cli_refuses_as_jax(argv, capsys):
    """--heartbeat-secs needs --trace and a positive cadence; --k-levels
    takes neither --metrics-out nor --profile-dir, on both packages."""
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit) as exc:
            main(argv + (["--device", "cpu"] if main is cli.main else []))
        assert exc.value.code == 2
    assert obs.get_tracer() is None


def _port(args, capsys):
    # the backend named, as _jax names the reference's (a left-out one is
    # recorded apart: test_cli_left_out_backend_recorded_as_jax)
    assert cli.main(args + ["--device", "cpu", "--backend", "torch"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _jax(args, capsys):
    assert jcli.main(args + ["--backend", "tpu"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_profile_dir_writes_a_chrome_trace(tmp_path, capsys):
    """--profile-dir on the CPU: one Chrome trace of the partition's CPU
    activity in the directory; the result is the unprofiled one."""
    args = ["--input", "rmat-hash:9:8:3", "--k", "4", "--chunk-edges",
            "1024", "--json"]
    pdir = str(tmp_path / "prof")
    plain = _port(args, capsys)
    line = _port(args + ["--profile-dir", pdir], capsys)
    for key in ("edge_cut", "total_edges", "comm_volume", "balance"):
        assert line[key] == plain[key]
    assert line["diagnostics"]["device_rounds"] == \
        plain["diagnostics"]["device_rounds"]
    traces = os.listdir(pdir)
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    with open(os.path.join(pdir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


# -- the traces of both CLIs ---------------------------------------------------

def _runs(path):
    """The trace's runs (each opened by its manifest)."""
    runs = []
    for line in open(path):
        rec = json.loads(line)
        if rec["event"] == "manifest":
            runs.append([])
        runs[-1].append(rec)
    return runs


def _tree(recs):
    """Nested (name, attributes, counter delta without timing keys or the
    port's own counters, unclosed) spans in start order; the backend's
    name is left out of the attributes' values, not their keys."""
    starts, ends, kids, roots = {}, {}, {}, []
    for r in recs:
        if r["event"] == "span_start":
            starts[r["id"]] = r
            parent = r["parent"]
            (kids.setdefault(parent, []) if parent in starts
             else roots).append(r["id"])
        elif r["event"] == "span_end":
            ends[r["id"]] = r

    def node(i):
        rec = ends.get(i, starts[i])
        attrs = {k: None if k == "backend" else v
                 for k, v in rec.items() if k not in (
                     "event", "ts", "span", "id", "parent", "secs",
                     "counters")}
        counters = {k: v for k, v in rec.get("counters", {}).items()
                    if not _timing(k) and k not in PORT_COUNTERS | LOOKAHEAD}
        return (starts[i]["span"], attrs, counters, i not in ends,
                [node(j) for j in kids.get(i, [])])

    return [node(i) for i in roots]


def _events(recs):
    """(event, field keys, compared values) of every record but the spans
    and heartbeats."""
    out = []
    for r in recs:
        ev = r["event"]
        if ev in ("span_start", "span_end", "heartbeat"):
            continue
        keys = set(r) - {"ts"}
        if ev == "manifest":
            keys -= JAX_MANIFEST | PORT_MANIFEST
        elif ev in ("diagnostics", "counters"):
            keys -= PORT_COUNTERS
        values = {k: r[k] for k in keys if k not in UNCOMPARED
                  and not _timing(k) and ev not in (
                      "manifest", "diagnostics", "counters")}
        out.append((ev, sorted(keys), values))
    return out


def _assert_same_trace(port_path, jax_path):
    got, want = _runs(port_path), _runs(jax_path)
    assert len(got) == len(want)
    for ours, ref in zip(got, want):
        assert _tree(ours) == _tree(ref)
        assert _events(ours) == _events(ref)
        totals = [{k: v for k, v in run[-1].items()
                   if k not in PORT_COUNTERS and not _timing(k)
                   and k != "ts"} for run in (ours, ref)
                  if run[-1]["event"] == "counters"]
        assert len(totals) in (0, 2) and totals[:1] == totals[1:]
        for name, pkg in (("torch", ours), ("tpu", ref)):
            m = pkg[0]
            assert m["backend"] == name and m["platform"] == "cpu"
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                     "trace_report.py"),
                        "--check", port_path], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _same_result(line, ref, out, ref_out):
    for key in ("k", "edge_cut", "total_edges", "comm_volume", "balance"):
        assert line[key] == ref[key], key
    if "device_rounds" in ref.get("diagnostics", {}):
        assert line["diagnostics"]["device_rounds"] == \
            ref["diagnostics"]["device_rounds"]
    assert np.array_equal(np.loadtxt(out, dtype=np.int64),
                          np.loadtxt(ref_out, dtype=np.int64))


CASES = {"auto": ["--k", "8"],
         "dispatch": ["--k", "8", "--dispatch-batch", "2", "--inflight",
                      "2"],
         "refine": ["--k", "8", "--refine", "2"],
         "k_levels": ["--k-levels", "2,4"]}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_trace_matches_jax(case, tmp_path, capsys):
    """The same traced CLI run on both packages: the span tree (names,
    nesting, counts, attributes), the events and their fields, the counter
    deltas a span; the port's result is its untraced one (the reference's
    here; tests/test_torch_*.py hold the untraced port to it), and
    trace_report --check accepts its trace. The flat runs also take
    --metrics-out: the reference's record set, with no device memory on
    the CPU."""
    t, jt = str(tmp_path / "t.jsonl"), str(tmp_path / "jt.jsonl")
    out, jout = str(tmp_path / "g.parts"), str(tmp_path / "jg.parts")
    m, jm = str(tmp_path / "m.jsonl"), str(tmp_path / "jm.jsonl")
    flat = case != "k_levels"  # --k-levels refuses --metrics-out
    args = BASE + CASES[case]
    line = _port(args + ["--trace", t, "--output", out]
                 + (["--metrics-out", m] if flat else []), capsys)
    ref = _jax(args + ["--trace", jt, "--output", jout]
               + (["--metrics-out", jm] if flat else []), capsys)
    _same_result(line, ref, out, jout)
    _assert_same_trace(t, jt)
    if flat:
        got = [json.loads(x) for x in open(m)]
        want = [json.loads(x) for x in open(jm)]
        assert [r["event"] for r in got] == [r["event"] for r in want]
        assert "device_memory" not in [r["event"] for r in got]
        for a, b in zip(got, want):
            if a["event"] != "diagnostics":
                assert set(a) == set(b)
            if a["event"] in ("scores", "part_loads"):
                assert a == {**b, "ts": a["ts"]}
    spans = {r["span"] for r in _runs(t)[0] if r["event"] == "span_end"}
    want = {"auto": "segment", "dispatch": "dispatch", "refine": "refine",
            "k_levels": "hier_spill"}[case]
    assert want in spans
    assert obs.get_tracer() is None and jobs.get_tracer() is None


def test_cli_left_out_backend_recorded_as_jax(tmp_path, capsys):
    """With --backend left out both CLIs record it as the reference does:
    no backend in the manifest (a null one in its config), and one
    backend_resolved event marked auto with the backend that ran (torch
    here; the reference's first available). trace_report reads the
    port's manifest line as the resolved backend, auto."""
    from sheep_tpu.backends import list_backends

    t, jt = str(tmp_path / "t.jsonl"), str(tmp_path / "jt.jsonl")
    args = ["--input", "rmat-hash:9:8:3", "--k", "4", "--chunk-edges",
            "1024", "--heartbeat-secs", "0.2", "--json"]
    assert cli.main(args + ["--trace", t, "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jcli.main(args + ["--trace", jt]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("edge_cut", "total_edges", "comm_volume", "balance"):
        assert line[key] == ref[key]
    resolved = []
    for path in (t, jt):
        (run,) = _runs(path)
        m = run[0]
        # no backend key: the manifest records none
        assert m["event"] == "manifest" and "backend" not in m
        assert m["config"]["backend"] is None
        events = [r for r in run if r["event"] == "backend_resolved"]
        assert len(events) == 1 and events[0]["auto"] is True
        resolved.append(events[0])
    assert set(resolved[0]) == set(resolved[1])
    assert resolved[0]["backend"] == "torch"
    assert resolved[1]["backend"] == next(
        b for b in ("tpu", "cpu", "pure") if b in list_backends())
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                     "trace_report.py"),
                        "--check", t], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "backend=torch (auto)" in r.stdout
    # named, the backend is recorded as named and not auto
    assert cli.main(args + ["--trace", t, "--device", "cpu", "--backend",
                            "torch"]) == 0
    capsys.readouterr()
    named = _runs(t)[-1]
    assert named[0]["backend"] == "torch"
    assert [r["auto"] for r in named
            if r["event"] == "backend_resolved"] == [False]


def test_cli_trace_score_only_matches_jax(tmp_path, capsys):
    """--score-only traced: the run span and its ``scores`` event, as the
    reference's."""
    parts = str(tmp_path / "g.parts")
    rng = np.random.default_rng(5)
    np.savetxt(parts, rng.integers(0, 8, 1 << 12), fmt="%d")
    t, jt = str(tmp_path / "t.jsonl"), str(tmp_path / "jt.jsonl")
    args = BASE + ["--score-only", parts]
    line = _port(args + ["--trace", t], capsys)
    ref = _jax(args + ["--trace", jt], capsys)
    for key in ("k", "edge_cut", "total_edges", "comm_volume", "balance"):
        assert line[key] == ref[key]
    _assert_same_trace(t, jt)
    assert [e[0] for e in _events(_runs(t)[0])] == ["manifest", "scores"]


def test_cli_trace_kill_and_resume_matches_jax(tmp_path, capsys,
                                               monkeypatch):
    """Killed at build:5 with a checkpoint every 2 chunks, then resumed,
    into one appended trace on each package: the killed run's partition and
    build spans unclosed, the resumed run's ``resume`` event, the same
    trees; trace_report --check accepts the port's file (it reports the
    last run)."""
    t, jt = str(tmp_path / "t.jsonl"), str(tmp_path / "jt.jsonl")
    out, jout = str(tmp_path / "g.parts"), str(tmp_path / "jg.parts")
    results = {}
    for name, run, mod, trace, path in (
            ("torch", _port, fault, t, out), ("tpu", _jax, jfault, jt, jout)):
        ck = str(tmp_path / f"ck_{name}")
        args = BASE + ["--k", "8", "--checkpoint-dir", ck,
                       "--checkpoint-every", "2", "--trace", trace]
        jfault.reset()
        fault.reset()
        monkeypatch.setenv(fault.ENV_VAR, "build:5")
        with pytest.raises(mod.InjectedFault):
            run(args, capsys)
        monkeypatch.delenv(fault.ENV_VAR)
        jfault.reset()
        fault.reset()
        results[name] = run(args + ["--resume", "--output", path], capsys)
    _same_result(results["torch"], results["tpu"], out, jout)
    _assert_same_trace(t, jt)
    killed, resumed = _runs(t)
    unclosed = {n[0] for n in _tree(killed)[0][4] if n[3]}
    assert unclosed == {"partition"}
    assert [r for r in resumed if r["event"] == "resume"][0]["phase"] == \
        "build"


def test_event_sites_match_jax(tmp_path, monkeypatch):
    """A torn .bin32 under SHEEP_IO_POLICY=quarantine writes
    ``chunk_quarantined``, a degraded checkpoint recovery
    ``checkpoint_degraded`` and a chaos schedule's fault
    ``chaos_inject``, each with the reference's fields."""
    from sheep_tpu.io import edgestream as jes
    from sheep_tpu.utils import checkpoint as jckpt

    from sheep_tpu_torch.io import edgestream
    from sheep_tpu_torch.utils import checkpoint

    path = str(tmp_path / "g.bin32")
    np.arange(40, dtype=np.int32).tofile(path)
    with open(path, "ab") as f:
        f.write(b"\x01\x02\x03")  # torn trailing bytes
    monkeypatch.setenv("SHEEP_IO_POLICY", "quarantine")
    got = []
    for pkg, es_mod, ck_mod, f_mod in ((obs, edgestream, checkpoint, fault),
                                       (jobs, jes, jckpt, jfault)):
        buf = io.StringIO()
        with pkg.tracing(buf):
            with es_mod.open_input(path) as es:
                edges = sum(len(c) for c in es.chunks(8))
            ck_mod._warn("step 3 unreadable; falling back")
            f_mod.reset()
            monkeypatch.setenv(fault.ENV_VAR, "chaos:3:1:1.0")
            with pytest.raises(f_mod.InjectedResourceExhausted):
                f_mod.maybe_fail("dispatch", 1, kinds=("oom",))
            monkeypatch.delenv(fault.ENV_VAR)
            f_mod.reset()
        got.append((edges, _events(_records(buf))))
    assert got[0] == got[1]
    assert [e[0] for e in got[0][1]] == ["chunk_quarantined",
                                         "checkpoint_degraded",
                                         "chaos_inject"]


FAULTS = {"oom": ("oom@dispatch:2", "dispatch_degraded"),
          "device": ("device@dispatch:1", "device_reinit")}


# device last: the reference's recovery drops every compiled program
@pytest.mark.parametrize("kind", ["oom", "device"])
def test_fault_events_match_jax(kind, monkeypatch):
    """A fault recovered in process (N = D = 2): the injection, retry and
    recovery events and their fields as the reference's; the dispatch span
    that the fault unwound ends with its ``error`` on the port."""
    import sheep_tpu

    import sheep_tpu_torch

    spec, recovery = FAULTS[kind]
    kw = dict(chunk_edges=1024, dispatch_batch=2, inflight=2)
    traces = {}
    for name in ("torch", "tpu"):
        jfault.reset()
        fault.reset()
        monkeypatch.setenv(fault.ENV_VAR, spec)
        buf = io.StringIO()
        pkg = obs if name == "torch" else jobs
        with pkg.tracing(buf):
            if name == "torch":
                res = sheep_tpu_torch.partition(SPEC, 8, device="cpu", **kw)
            else:
                res = sheep_tpu.partition(SPEC, 8, backend="tpu", **kw)
        monkeypatch.delenv(fault.ENV_VAR)
        traces[name] = (_records(buf), res)
    jfault.reset()
    fault.reset()
    (ours, res), (ref, jres) = traces["torch"], traces["tpu"]
    assert res.edge_cut == jres.edge_cut
    assert res.diagnostics["dispatch_retries"] == 1
    names = [e[0] for e in _events(ours)]
    assert recovery in names and "retry" in names
    assert _events(ours) == _events(ref)
    failed = [r for r in ours if r["event"] == "span_end"
              and r["span"] == "dispatch" and "error" in r]
    assert len(failed) == 1
