"""The port's flat-run entry points against the JAX package's, exactly:
``partition`` on the new synthetic inputs, ``partition_multi`` and the
device scorer, the ``.gz`` text and ``.csr`` readers, and the CLI's k
lists, ``--score-only``, ``--weights``, ``--alpha``, ``--no-comm-volume``
and ``--num-vertices`` (JSON numbers and output files)."""

import gzip
import json

import numpy as np
import pytest
import torch

import sheep_tpu
import sheep_tpu_torch
from sheep_tpu import cli as jcli
from sheep_tpu.backends.base import score_stream as jscore_stream
from sheep_tpu.backends.tpu_backend import TpuBackend
from sheep_tpu.io import csr as jcsr
from sheep_tpu.io import edgestream as jes
from sheep_tpu.io import formats as jformats
from sheep_tpu.io import generators as jgen
from sheep_tpu_torch import cli
from sheep_tpu_torch.backends.torch_backend import TorchBackend
from sheep_tpu_torch.io import csr, edgestream, formats

SPECS = ["sbm-hash:12:16:0.05:8:7", "nearclique-hash:12:6:0.02:8:7",
         "plsbm-hash:12:16:0.05:8:7", "bipartite-hash:12:8:0.02:8:7",
         "rmat:12:8:7"]
SCORES = ("edge_cut", "total_edges", "comm_volume", "balance")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These CPU runs issue many small ops; beside the other workers of a
    parallel test run, torch's intra-op threads cost more than they save
    (a case of ~7 s alone took ~110 s beside five other workers on eight
    cores), so the module runs on one thread and restores the count
    after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same(res, ref, rounds=True):
    assert np.array_equal(res.assignment, ref.assignment)
    for key in SCORES:
        assert getattr(res, key) == getattr(ref, key), key
    if rounds:
        assert np.array_equal(res.tree["parent"], ref.tree["parent"])
        assert res.diagnostics["device_rounds"] == \
            ref.diagnostics["device_rounds"]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("driver", [
    {}, {"dispatch_batch": 2, "inflight": 1}], ids=["defaults", "batched"])
def test_partition_matches_jax_on_new_inputs(spec, driver):
    opts = dict(chunk_edges=1 << 13, **driver)
    with jes.open_input(spec) as js:
        ref = TpuBackend(**opts).partition(js, 16, keep_tree=True)
    got = sheep_tpu_torch.partition(spec, 16, device="cpu", keep_tree=True,
                                    **opts)
    _same(got, ref)


@pytest.mark.parametrize("spec,weights,alpha", [
    ("sbm-hash:12:16:0.05:8:7", "unit", 1.0),
    ("rmat-hash:11:8:3", "degree", 1.3),
    ("bipartite-hash:11:8:0.02:8:7", "degree", 1.0)])
def test_partition_multi_matches_jax(spec, weights, alpha):
    ks = [4, 16, 64]
    opts = dict(chunk_edges=1 << 13, weights=weights, alpha=alpha)
    ref = sheep_tpu.partition_multi(spec, ks, backend="tpu", **opts)
    got = sheep_tpu_torch.partition_multi(spec, ks, device="cpu", **opts)
    assert [r.k for r in got] == ks
    for a, b in zip(got, ref):
        _same(a, b, rounds=False)
    assert got[1].tree is got[0].tree


@pytest.mark.parametrize("comm_volume", [True, False])
@pytest.mark.parametrize("degree", [False, True])
def test_score_stream_matches_the_host_scorer(comm_volume, degree):
    """All assignments against each device chunk in one pass: (cut,
    total, balance, cv) of the reference's host scorer, whatever the
    assignment."""
    spec = "sbm-hash:11:8:0.1:4:2"
    rng = np.random.default_rng(1)
    n = 1 << 11
    assigns = {k: rng.integers(0, k, n).astype(np.int32) for k in (2, 7, 64)}
    w = rng.integers(1, 9, n).astype(np.float64) if degree else None
    ref = jscore_stream(jes.open_input(spec), assigns, chunk_edges=3000,
                        comm_volume=comm_volume, weights=w)
    be = TorchBackend(chunk_edges=3000, device="cpu")
    got = be.score_stream(edgestream.open_input(spec), assigns,
                          comm_volume=comm_volume, weights=w)
    assert got == ref


@pytest.fixture(scope="module")
def graph_files(tmp_path_factory):
    """One graph as .bin32, gzip text (written by the reference) and .csr
    (the reference's writer), with one vertex past the last endpoint."""
    d = tmp_path_factory.mktemp("entry")
    e = jgen.sbm_hash_range(11, 0, 1 << 14, 16, 0.05, seed=3)
    paths = {ext: str(d / f"g{ext}") for ext in (".bin32", ".edges.gz",
                                                   ".csr")}
    jformats.write_edges(paths[".bin32"], e)
    jformats.write_edges(paths[".edges.gz"], e)
    jcsr.write_csr(paths[".csr"], jes.open_input(paths[".bin32"]))
    return paths


@pytest.mark.parametrize("ext", [".edges.gz", ".csr"])
@pytest.mark.parametrize("cs", [1000, 1 << 22])
def test_gz_and_csr_streams_match(graph_files, ext, cs):
    path = graph_files[ext]
    assert formats.detect_format(path) == jformats.detect_format(path)
    ts, js = edgestream.open_input(path), jes.open_input(path)
    assert ts.num_vertices == js.num_vertices
    assert ts.clamp_chunk_edges(cs) == js.clamp_chunk_edges(cs)
    got, ref = list(ts.chunks(cs)), list(js.chunks(cs))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)


def test_csr_reader_matches(graph_files):
    path = graph_files[".csr"]
    h, jh = csr.read_header(path), jcsr.read_header(path)
    assert (h.n_vertices, h.n_edges, h.wide) == \
        (jh.n_vertices, jh.n_edges, jh.wide)
    g, jg = csr.CsrGraph(path), jcsr.CsrGraph(path)
    for start, end in ((0, 0), (0, 5), (17, 4000), (9000, 1 << 20)):
        assert np.array_equal(g.edge_slice(start, end),
                              jg.edge_slice(start, end))
    with open(path, "rb") as f:
        data = f.read()
    bad = path + ".bad.csr"
    with open(bad, "wb") as f:
        f.write(b"NOTACSR!" + data[8:])
    with pytest.raises(ValueError, match="not a SHEEPCSR file"):
        csr.read_header(bad)


def test_partition_of_gz_and_csr_equal_the_bin32(graph_files):
    ref = sheep_tpu_torch.partition(graph_files[".bin32"], 8, device="cpu",
                                    chunk_edges=4096, keep_tree=True)
    for ext in (".edges.gz", ".csr"):
        got = sheep_tpu_torch.partition(graph_files[ext], 8, device="cpu",
                                        chunk_edges=4096, keep_tree=True)
        _same(got, ref, rounds=False)


def test_gzip_text_written_by_the_port_reads_back(tmp_path):
    e = jgen.karate_club()
    path = str(tmp_path / "k.edges.gz")
    formats.write_edges(path, e)
    with gzip.open(path, "rt") as f:
        assert f.read() == "".join(f"{u} {v}\n" for u, v in e)
    assert np.array_equal(jformats.read_edges(path), e)
    with pytest.raises(ValueError, match="text edge lists only"):
        formats.detect_format("g.bin32.gz")


def _json_lines(out: str) -> list:
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


NUMBERS = ("k", "edge_cut", "total_edges", "cut_ratio", "balance",
           "comm_volume", "n_vertices")


def _run_both(capsys, argv, jax_extra=("--backend", "tpu")):
    rc = jcli.main([*argv, *jax_extra])
    ref = capsys.readouterr()
    got_rc = cli.main([*argv, "--device", "cpu"])
    got = capsys.readouterr()
    assert got_rc == rc
    return _json_lines(got.out), _json_lines(ref.out), got, ref


def _cli_case(graph_files, tmp_path, name):
    """(argv, output paths written) of the named CLI case."""
    out = str(tmp_path / "p.parts")
    cases = {
        "k-list": (["--input", "sbm-hash:11:16:0.05:4:7", "--k", "4,16,4",
                    "--output", out], ["p.k4.parts", "p.k16.parts"]),
        "degree-alpha": (["--input", "rmat-hash:11:8:3", "--k", "8",
                          "--weights", "degree", "--alpha", "1.3",
                          "--output", out], ["p.parts"]),
        "no-comm-volume": (["--input", "nearclique-hash:11:5:0.02:4:7",
                            "--k", "8,3", "--no-comm-volume"], []),
        "num-vertices": (["--input", graph_files[".bin32"], "--k", "4",
                          "--num-vertices", "3000", "--output", out],
                         ["p.parts"]),
        "gz": (["--input", graph_files[".edges.gz"], "--k", "4,16",
                "--chunk-edges", "5000"], []),
        "csr": (["--input", graph_files[".csr"], "--k", "16,4",
                 "--weights", "degree"], []),
    }
    return cases[name]


@pytest.mark.parametrize("name", ["k-list", "degree-alpha", "no-comm-volume",
                                  "num-vertices", "gz", "csr"])
def test_cli_matches_jax(graph_files, tmp_path, capsys, name):
    argv, files = _cli_case(graph_files, tmp_path, name)
    got, ref, _, _ = _run_both(capsys, ["--json", *argv])
    assert len(got) == len(ref) >= 1
    for a, b in zip(got, ref):
        assert {k: a[k] for k in NUMBERS} == {k: b[k] for k in NUMBERS}
    if files:  # the port's maps, then the reference's over them
        ported = {}
        for f in files:
            ported[f] = (tmp_path / f).read_bytes()
        jcli.main(["--json", *argv, "--backend", "tpu"])
        capsys.readouterr()
        for f in files:
            assert (tmp_path / f).read_bytes() == ported[f], f


@pytest.mark.parametrize("extra", [[], ["--k", "16"], ["--weights", "degree"],
                                   ["--no-comm-volume"]])
def test_score_only_matches_jax(graph_files, tmp_path, capsys, extra):
    parts = str(tmp_path / "s.parts")
    jcli.main(["--input", graph_files[".csr"], "--k", "12", "--output",
               parts, "--backend", "tpu", "--json"])
    capsys.readouterr()
    argv = ["--input", graph_files[".csr"], "--score-only", parts, "--json",
            *extra]
    got, ref, _, _ = _run_both(capsys, argv, jax_extra=())
    assert len(got) == len(ref) == 1
    assert {k: got[0][k] for k in NUMBERS} == {k: ref[0][k] for k in NUMBERS}
    assert got[0]["backend"] == ref[0]["backend"] == "score-only"


def test_score_only_refuses_a_map_of_another_graph(graph_files, tmp_path,
                                                   capsys):
    parts = str(tmp_path / "short.parts")
    formats.write_partition(parts, np.zeros(10, np.int32))
    argv = ["--input", graph_files[".bin32"], "--score-only", parts]
    for main, extra in ((jcli.main, []), (cli.main, ["--device", "cpu"])):
        assert main([*argv, *extra]) == 2
    err = capsys.readouterr().err
    assert err.count("partition map has 10 entries") == 2


@pytest.mark.parametrize("argv", [
    ["--input", "rmat-hash:8", "--k", "0"],
    ["--input", "rmat-hash:8", "--k", "4,x"],
    ["--input", "rmat-hash:8", "--k", ","],
    ["--input", "rmat-hash:8"],
    ["--k", "4"],
    ["--input", "rmat-hash:8", "--score-only", "p.parts", "--k", "0"],
    ["--input", "rmat-hash:8", "--k", "4", "--weights", "edge"],
])
def test_cli_usage_errors_match_jax(capsys, argv):
    for main in (jcli.main, cli.main):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2
    err = capsys.readouterr().err.splitlines()
    messages = [line for line in err if "error:" in line]
    assert len(messages) == 2
    assert messages[0].split("error:")[1] == messages[1].split("error:")[1]


def test_cli_refuses_scale_32_as_the_reference_does(capsys):
    argv = ["--input", "rmat-hash:32:1", "--k", "4"]
    assert jcli.main([*argv, "--backend", "tpu"]) == 2
    assert cli.main([*argv, "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert err.count("error: graph has 4,294,967,296 vertices") == 2
