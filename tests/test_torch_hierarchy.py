"""The port's hierarchy (``sheep_tpu_torch/hierarchy.py``), quality advisor
(``ops/degrees.py``) and their CLI flags against the JAX package's,
exactly, on the CPU: ``partition_hierarchical`` with one, two and three
levels, ``balance``, ``final_refine`` and degree weights, the degenerate
tiny parts, the spill's cleanup, ``level_ledger``, ``advise_recipe`` and
``factor_levels`` over a grid, and the CLI's ``--refine``,
``--k-levels``, ``--final-refine``, ``--balance``, ``--auto-recipe`` and
``--spill-dir`` with their errors."""

import json
import os

import numpy as np
import pytest

import sheep_tpu
import sheep_tpu_torch
from sheep_tpu import cli as jcli
from sheep_tpu import hierarchy as jhier
from sheep_tpu.backends.base import score_stream as jscore_stream
from sheep_tpu.io import edgestream as jes
from sheep_tpu.io import formats as jformats
from sheep_tpu.io import generators as jgen
from sheep_tpu.ops import degrees as jdeg
from sheep_tpu.ops import score as jscore
from sheep_tpu_torch import cli, hierarchy
from sheep_tpu_torch.io import edgestream
from sheep_tpu_torch.ops import degrees, score

SCORES = ("k", "edge_cut", "total_edges", "cut_ratio", "balance",
          "comm_volume")


def _same(got, ref):
    assert np.array_equal(got.assignment, ref.assignment)
    for key in SCORES:
        assert getattr(got, key) == getattr(ref, key), key
    assert got.diagnostics == ref.diagnostics
    assert got.backend.split("+")[1] == ref.backend.split("+")[1]


@pytest.mark.parametrize("spec,levels,kw", [
    ("sbm-hash:11:16:0.05:16:1", [4], {}),
    ("sbm-hash:11:16:0.05:16:1", [4, 4],
     dict(balance=1.1, final_refine=2)),
    ("rmat-hash:10:8:2", [2, 3], dict(weights="degree", refine=2)),
    ("sbm-hash:10:8:0.05:8:3", [2, 2, 2],
     dict(refine=1, comm_volume=False, alpha=0.5)),
], ids=["one-level", "balance-final-refine", "degree", "three-levels"])
def test_partition_hierarchical_matches_jax(spec, levels, kw):
    ref = sheep_tpu.partition_hierarchical(spec, levels, backend="cpu", **kw)
    got = sheep_tpu_torch.partition_hierarchical(spec, levels, device="cpu",
                                                 **kw)
    _same(got, ref)
    assert got.backend == f"torch:cpu+hier{levels}"
    if kw.get("final_refine"):
        assert got.edge_cut == 1606 and got.balance == 1.0


def test_tiny_parts_round_robin_matches_jax(tmp_path):
    """Karate at [8, 8]: level-0 parts of at most 8 members take their
    labels round-robin; the final refine repairs them where it can."""
    path = str(tmp_path / "karate.bin32")
    jformats.write_edges(path, jgen.karate_club())
    kw = dict(final_refine=2, refine=2)
    ref = sheep_tpu.partition_hierarchical(path, [8, 8], backend="cpu", **kw)
    got = sheep_tpu_torch.partition_hierarchical(path, [8, 8], device="cpu",
                                                 **kw)
    _same(got, ref)
    counts = np.bincount(got.assignment // 8, minlength=8)
    assert counts.max() <= 8


def test_spill_is_removed_on_success_and_failure(tmp_path, monkeypatch):
    spec = "sbm-hash:10:8:0.05:8:3"
    spill = tmp_path / "spill"
    spill.mkdir()
    res = sheep_tpu_torch.partition_hierarchical(
        spec, [2, 2], device="cpu", spill_dir=str(spill), refine=1)
    assert res.diagnostics["level0_spill_bytes"] > 0
    assert os.listdir(spill) == []
    calls = []
    inner = sheep_tpu_torch._partition_stream

    def fail_in_level_one(stream, k, **kw):
        calls.append(k)
        if len(calls) == 2:
            raise RuntimeError("level-1 build failed")
        return inner(stream, k, **kw)

    monkeypatch.setattr(sheep_tpu_torch, "_partition_stream",
                        fail_in_level_one)
    with pytest.raises(RuntimeError, match="level-1 build failed"):
        sheep_tpu_torch.partition_hierarchical(
            spec, [2, 2], device="cpu", spill_dir=str(spill), refine=1)
    assert os.listdir(spill) == []


def test_arguments_refused_as_the_reference_does():
    for kw in (dict(balance=1.0), dict(balance=1.2, alpha=0.3)):
        with pytest.raises(ValueError):
            sheep_tpu_torch.partition_hierarchical("rmat-hash:8", [2, 2],
                                                   device="cpu", **kw)
    with pytest.raises(ValueError, match="positive"):
        sheep_tpu_torch.partition_hierarchical("rmat-hash:8", [2, 0],
                                               device="cpu")
    # nprocs is taken as the reference takes it: in one process, with no
    # checkpointer to reconcile, the run is the plain one
    # (tests/test_torch_multiprocess.py runs it over several processes)
    ref = sheep_tpu.partition_hierarchical("rmat-hash:8", [2, 2],
                                           backend="cpu", nprocs=2)
    got = sheep_tpu_torch.partition_hierarchical("rmat-hash:8", [2, 2],
                                                 device="cpu", nprocs=2)
    _same(got, ref)


@pytest.mark.parametrize("levels", [[4, 4], [2, 1, 4], [16]])
def test_level_ledger_matches_jax(levels):
    spec = "sbm-hash:10:16:0.1:8:4"
    rng = np.random.default_rng(len(levels))
    final = rng.integers(0, int(np.prod(levels)), 1 << 10).astype(np.int32)
    with jes.open_input(spec) as js, edgestream.open_input(spec) as ts:
        cut, total, _, _ = jscore_stream(
            js, {16: final}, comm_volume=False)[16]
        ref = jhier.level_ledger(js, final, levels, cut, total)
        got = hierarchy.level_ledger(ts, final, levels, cut, total,
                                     device="cpu")
    assert got == ref
    assert sum(row["cut"] for row in got) == cut


def test_part_loads_accounting_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 9, 4000)
    w = rng.integers(1, 20, 4000)
    for weights, cap in ((None, None), (None, 480.0), (w, 4600.0)):
        assert score.part_loads_accounting(a, 9, weights, cap) == \
            jscore.part_loads_accounting(a, 9, weights, cap)


def test_advisor_matches_jax_over_a_grid():
    for n in (1, 1000, 1 << 22):
        for m in (None, 0, 500, 8 * 1000, 16 << 22):
            for k in (1, 2, 3, 4, 7, 8, 12, 64, 97, 128, 256, 1000, 4096):
                assert degrees.advise_recipe(n, m, k) == \
                    jdeg.advise_recipe(n, m, k)
    for k in range(1, 300):
        for cap in (1, 2, 3, 5, 8, 32, 100):
            assert degrees.factor_levels(k, cap) == \
                jdeg.factor_levels(k, cap)
    assert degrees.advise_recipe(1 << 22, 16 << 22, 64)["k_levels"] == \
        [8, 8]
    for name in ("LP_SIGNAL_THRESHOLD", "ADVISED_FINAL_REFINE",
                 "ADVISED_BALANCE"):
        assert getattr(degrees, name) == getattr(jdeg, name)


def _lines(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def _run_both(capsys, argv):
    rc = jcli.main([*argv, "--backend", "cpu"])
    ref = capsys.readouterr()
    got_rc = cli.main([*argv, "--device", "cpu"])
    got = capsys.readouterr()
    assert got_rc == rc == 0
    return _lines(got.out), _lines(ref.out), got.err, ref.err


def _quality(line):
    """The refine statistics of a flat result line; a hierarchical line's
    whole diagnostics (spill bytes, refine statistics, ledger)."""
    diag = line.get("diagnostics", {})
    if "+hier" in line["backend"]:
        return diag
    return {key: v for key, v in diag.items() if key.startswith("refine_")}


def _notes(err):
    return [line for line in err.splitlines() if line.startswith("note:")]


@pytest.mark.parametrize("argv", [
    ["--input", "sbm-hash:11:16:0.05:16:1", "--k", "16", "--refine", "4"],
    ["--input", "rmat-hash:10:8:2", "--k", "8", "--refine", "3",
     "--weights", "degree", "--refine-alpha", "1.3", "--balance", "1.2",
     "--no-comm-volume"],
    ["--input", "rmat-hash:10:8:2", "--k", "64", "--refine", "2",
     "--refine-budget-gb", "0.0001"],
    ["--input", "sbm-hash:10:8:0.05:8:3", "--k-levels", "2,4",
     "--balance", "1.1", "--final-refine", "2"],
    ["--input", "sbm-hash:10:8:0.05:8:3", "--k-levels", "2,2", "--refine",
     "1", "--alpha", "0.5", "--weights", "degree"],
    ["--input", "sbm-hash:11:4:0.05:1:1", "--k", "4", "--auto-recipe"],
    ["--input", "sbm-hash:11:4:0.05:1:1", "--k", "4", "--auto-recipe",
     "--final-refine", "0", "--refine", "1"],
], ids=["refine", "refine-balance", "refine-budget", "k-levels",
        "k-levels-alpha", "auto-recipe", "auto-recipe-flags"])
def test_cli_matches_jax(capsys, tmp_path, argv):
    argv = [*argv, "--spill-dir", str(tmp_path)] \
        if "--k-levels" in argv else argv
    got, ref, got_err, ref_err = _run_both(capsys, ["--json", *argv])
    assert len(got) == len(ref) == 1
    for key in (*SCORES, "n_vertices"):
        assert got[0][key] == ref[0][key], key
    diag = _quality(got[0])
    assert diag == _quality(ref[0])
    assert _notes(got_err) == _notes(ref_err)
    if "--refine" in argv and "--k-levels" not in argv and \
            "--auto-recipe" not in argv:
        assert diag["refine_rounds_run"] >= 1
    if "--auto-recipe" in argv:
        assert "--k-levels 2,2" in _notes(got_err)[0]
        assert got[0]["backend"] == "torch:cpu+hier[2, 2]"
    if "--k-levels" in argv:
        assert os.listdir(tmp_path) == []


def test_cli_advisor_note_without_auto_recipe(capsys):
    argv = ["--input", "sbm-hash:11:4:0.05:1:1", "--k", "4", "--json"]
    got, ref, got_err, ref_err = _run_both(capsys, argv)
    assert _notes(got_err) == _notes(ref_err)
    assert "pass --auto-recipe to apply" in _notes(got_err)[0]
    assert got[0]["edge_cut"] == ref[0]["edge_cut"]


@pytest.mark.parametrize("argv", [
    ["--input", "rmat-hash:8", "--k", "4", "--k-levels", "2,2"],
    ["--input", "rmat-hash:8", "--k-levels", "2,x"],
    ["--input", "rmat-hash:8", "--k-levels", "2,0"],
    ["--input", "rmat-hash:8", "--k-levels", "2,2", "--score-only", "p"],
    ["--input", "rmat-hash:8", "--k-levels", "2,2", "--auto-recipe"],
    ["--input", "rmat-hash:8", "--k-levels", "2,2", "--balance", "1.2",
     "--alpha", "0.5"],
    ["--input", "rmat-hash:8", "--k-levels", "2,2", "--dispatch-batch", "2",
     "--inflight", "1"],
    ["--input", "rmat-hash:8", "--k-levels", "4,4", "--inflight", "0"],
    ["--input", "rmat-hash:8", "--k-levels", "2,2", "--no-carry-tail"],
    ["--input", "rmat-hash:8", "--k-levels", "2,2", "--no-cache-chunks",
     "--no-tail-overlap"],
    ["--input", "rmat-hash:8", "--k", "4", "--final-refine", "2"],
    ["--input", "rmat-hash:8", "--k", "4", "--spill-dir", "x"],
    ["--input", "rmat-hash:8", "--k", "4,8", "--refine", "2"],
    ["--input", "rmat-hash:8", "--k", "4,8", "--auto-recipe"],
    ["--input", "rmat-hash:8", "--k", "4", "--auto-recipe", "--h2d-ring",
     "1"],
    ["--input", "rmat-hash:8", "--k", "4", "--auto-recipe",
     "--dispatch-batch", "0"],
    ["--input", "rmat-hash:8", "--k", "4", "--auto-recipe",
     "--no-tail-overlap"],
    ["--input", "rmat-hash:8", "--score-only", "p", "--auto-recipe"],
    ["--input", "rmat-hash:8", "--score-only", "p", "--balance", "1.1"],
    ["--input", "rmat-hash:8", "--k", "4", "--balance", "1.0"],
    ["--input", "rmat-hash:8", "--k", "4", "--balance", "1.2", "--alpha",
     "0.5"],
], ids=lambda a: " ".join(a[2:]))
def test_cli_errors_match_jax(capsys, argv):
    for main in (jcli.main, cli.main):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2
    err = capsys.readouterr().err.splitlines()
    messages = [line for line in err if "error:" in line]
    assert len(messages) == 2
    assert messages[0].split("error:")[1] == messages[1].split("error:")[1]
