#!/usr/bin/env python3
"""Smoke run of sheep_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --sharded-cards   # phases 5l, 5m, 5n, >= 2 cards
    python3 chip_smoke.py --multiprocess    # phase 5n and its references

Phases, one result line each; any failure exits non-zero before the last
line is printed:

  1. the card's name and power limit (nvidia-smi);
  2. build every native library of the port from ``sheep_tpu_torch/csrc``
     (the CUDA kernels with nvcc, the host split with the C++ compiler);
  3. kernel K1 (``gather_clip``) against its plain PyTorch version on the
     card, exactly, at the build path's shapes (T = 2^22+1 tables, M = 2^23
     climb and M = T squaring gathers) and a ragged out-of-range case, with
     its time, the plain version's, ``torch.take``'s (timed only, as a
     yardstick) and the bytes bound (``gather_smoke.Probe``);
  3b. gather forms: what the probe tool lacks, in the same way: K3 on a
     row wider than a block's shared memory (R = 65,536), ragged
     out-of-range cases of K2 and K3, and the cases of their redesign:
     K2 in bulk (2^16 random rows of P2's (8192, 128) table, 32 MiB
     written), K3 on axis 1 at R = 16384 and 32768, views that start at
     element 1 (t, x, idx or out) and odd widths, each one launch a call
     and with its chain bound (an empty kernel launched as K2 and K3 are,
     on the plan's grid, plus two dependent loads) beside its bytes bound;
     then the port's probe tool ``gather_smoke``, variants 1-3 with
     ``--perf``, in-process, with the kernels' launches counted: each of
     its records (forms A-E, the P2 legs, the eight P3 widths) holds its
     kernel exactly against the plain version and is timed, and every
     record must be ok;
  3c. the round's lifting kernels (``ops/lift.py``): ``lift_stack`` and
     ``climb_tail`` against their plain PyTorch versions on the card,
     exactly (stack levels, depth, outputs and the control word), at the
     s22 shapes (T = 2^22+1, C = 2^23) on synthetic position-space
     forests (P[p] in (p, n]; one random, one with a chain through half
     the positions) with live-slot shares of 100%, 10% and 1%, each timed
     beside its plain version, ``torch.take(t, t)`` for one squaring
     level, and its bytes bound; a ladder is one kernel launch and no
     memset (``torch.profiler``), and over a stack filled with -1 it
     writes the levels up to the first all-n one, max(d - 1, 1) rows,
     and no more;
  3d. the batched execution's kernels (``ops/fixpoint.py``) against their
     plain versions on the card, exactly: ``scatter_min`` at T = 2^22+1, C =
     2^23 with 100% and 1% of the slots live, also against the library pair
     it replaced (``torch.where`` for the dead-slot index and
     ``scatter_reduce_``), and on the rows of [3, C] blocks with C not a
     multiple of 4 (row starts off 16-byte boundaries); ``exec_finish`` on
     [8, 2^23] blocks with all and half the rows converged;
     ``stream_descent`` (the stream descent's climb and squaring, one
     cooperative launch a round, witnessed by ``torch.profiler``'s runtime
     calls) at T = 2^22+1, C = 2^23 on a random forest and one with a
     chain (``chain_for_depth(23)``), L = 23 and 8, 100%, 1% and a median
     round's share (2^-20) of the slots live, and on a stopped execution
     (nothing written); each timed beside its plain version (and
     ``torch.take(t, t)`` a level), with its bytes bound; then the round's
     end, folded into ``climb_tail``'s
     last block: whole executions over [3, 2^13] blocks, exact and stream
     descent, with budgets that run out mid-row and that leave no-op rounds,
     round by round against the CPU (``climb_rows``'s plain version and
     ``round_end_plain``), every word of the execution's state and of the
     control word equal;
  3e. the per-segment driver's kernels against their plain versions on
     the card, exactly: ``compact_live`` at C = 2^22 pairs with 50%, 10%
     and 1% live (with duplicates) into the driver's ``size``, with the
     duplicates dropped and (the sharded driver's ``dedup=False``) kept,
     and on the case table ``kernel_cases.compact_cases``; one cooperative launch a
     call (``torch.profiler``'s runtime calls); timed beside the plain
     version, ``torch.unique`` of the packed keys with a masked select,
     and its bytes bound; ``climb_jumps`` (``climb_tail``'s jump mode, up
     to 16 steps, ending at the first that does not move) at C' = 2^14 on
     a chain forest, hi 1-48 and 1-3 above lo, with its bytes bound and
     its chain bound: the launch floor (an empty kernel on its grid) and
     the latency of a dependent load (a pointer chase), ``lift.chase``;
  3f. the chunk synthesis ``hash_chunk`` (``csrc/synth.cu``, B12) against
     its plain version on the card, exactly: R-MAT at scale 22 (2^23 rows)
     at counter 0, across the 2^32 carry and with a ragged count; SBM at
     scale 22 with 64 blocks, with 2 blocks at p_out 1.0, and near-clique
     with clique bits 8; each timed beside its plain version (the int64
     passes), with its bound: bytes, or the SASS instructions its rows
     execute (``cuobjdump -sass``) over the card's instruction rate;
  3g. the refinement's kernels (``csrc/refine.cu``, B11) against their
     plain versions on the card, exactly, at s22 shapes: ``neighbor_hist``
     on a 2^22-edge chunk of sbm-hash:22:64:0.05:16:42 and of
     rmat-hash:22:16:42 at k = 8 and 64 (full, with the fused cut and
     total) and at k = 256 blocked (vb = 2^22, base 0 and 2^22), and the
     SBM chunk under its planted partition at k = 64 and 8;
     ``hist_stats`` on (2^22+1, 64), (2^22, 256), (2^22, 7) and (2^22+1,
     7) histograms with planted ties; ``plan_moves`` at n = 2^22, k = 64
     with the cap filling some parts and on ``hist_stats`` of the planted
     k = 64 histogram, both parities; each timed beside its plain
     version, a library yardstick (``torch.bincount``, ``torch.max`` +
     ``gather``, ``torch.sort``) and its bytes bound, the device kernels a
     call (``torch.profiler``'s runtime launches, which must be four for
     ``neighbor_hist``, one for ``hist_stats`` and one cooperative launch
     for ``plan_moves``); the weighted planner (plain PyTorch, no kernel)
     timed on the card with its bytes bound, equal to its run on the CPU;
     then the three kernels at small sizes where their designs branch (k
     = 1, 3, 7, 64, 257 and 40,000, blocked off a bucket start, ragged
     and misaligned stats tiles, a chunk of invalid edges, a hub vertex;
     the planner's case table ``kernel_cases.plan_cases``);
  3h. the vertex-sharded build's routed kernels (``csrc/routed.cu``,
     ``ops/routed.py``, B14) against their plain versions on the card,
     every output word equal, at bigv's s22 shapes (4 shards on the card,
     n = 2^22, B = 1,048,577, Q = 2^20 requests a shard), one launch a
     card serving all four: ``owned_gather`` at width Q with 100%, 10% and
     1% of the requests live (the rest at the sentinel row n, 1% of the
     live ones past the table) and at the squaring width B;
     ``owned_scatter_min`` (answers mode: three launches in stream
     order; card mode: one cooperative launch, beside the yardstick
     ``torch.take`` + ``scatter_reduce_`` + ``torch.take``) with every
     request on one row (a star's hub) and on a random forest's slots;
     ``routed_step`` (the climb's rewrite, and the plain min of a
     squaring, beside ``torch.amin``, also on rows that start off 16
     bytes) and ``routed_round_end`` (with its live words) on their
     answers; the card forms ``routed_climb`` (a tail round's whole jump
     climb at 2^13 slots a shard on the random and a chain forest at
     100%, 10% and 1% live, with its chain bound on the random forest; a
     lifting round's first launch at width Q) and ``routed_square``
     (width B, beside ``torch.take``); each timed beside its plain
     version, with its bytes bound;
  4. the port on CUDA at its auto pipeline depth (2) against the port on
     the CPU at depths 1 and 2, rmat-hash:16:16:7, k=64: forest,
     assignment and scores exactly equal, and device rounds at depth 2;
  4b. the same at depth 2 on both at rmat-hash:14:16:7, k=16, with the
     table budget set to 0 so that the fixpoint takes its stream descent:
     K1, ``scatter_min``, ``stream_descent`` and ``climb_tail`` once a
     round enqueued, no ``lift_stack``;
  4c. a .bin32 file through the staged H2D ring (``h2d_ring=2``), CUDA
     against the CPU, both at depth 2; the same edges as a text file
     (read by the native parser, its last line without a newline) give
     the same partition;
  4d. the per-segment driver (dispatch batch 1, depth 1), CUDA against
     the CPU at rmat-hash:16:16:7, k=64, chunk 2^17, the host tail at 4096
     live pairs: with ``stale_reuse`` 1 and 2, ``carry_tail`` and
     ``tail_overlap``, forest, assignment, scores, device rounds and every
     segment and compaction counter equal; then one chunk's adaptive fold
     with ``host_tail=False``, whose tail runs as jump-mode segments
     (``climb_jumps``);
  4e. the new inputs, CUDA against the CPU at depth 2 (chunk 2^17):
     sbm-hash, nearclique-hash (through ``hash_chunk``), plsbm-hash,
     bipartite-hash and the rmat replay stream (through the ring) at scale
     16, forest, assignment, scores and device rounds equal;
     ``partition_multi`` at k = 4, 16, 64 equal on both; a ``.csr`` file
     and an ``.edges.gz`` of the same edges as a ``.bin32`` give its
     partition;
  4f. refinement and the hierarchy, CUDA against the CPU at
     sbm-hash:16:16:0.05:16:1, k = 16: ``partition(refine=4)`` (full
     histogram, spooled), ``refine_assignment`` blocked, host-planned and
     degree-weighted, and ``partition_hierarchical`` [4, 4] with balance
     1.1 and a final refine of 2: assignment, scores and every refine and
     hierarchy statistic equal;
  4g. checkpoints, recovery and residency, CUDA against the CPU at
     rmat-hash:16:16:7, k = 64, chunk 2^17, a checkpoint every 2 chunks:
     killed (``SHEEP_FAULT_INJECT``) at degrees:3, build:5 and score:3,
     batched (N = D = 2) and per segment with ``carry_tail``, the same step
     and arrays saved on both devices, and the card resuming its own step
     and the CPU's to the uninterrupted partition; ``oom@dispatch:2`` and
     ``device@dispatch:2`` recovered in process with the same counters on
     both; the class a real out-of-memory error of the card gets; a
     ``.bin32`` under a quarter of the stream resident, the same spill and
     reload counters on both and the unconstrained partition;
     ``partition_hierarchical`` [4, 4] at sbm-hash:16:16:0.05:16:1 killed
     at level:2 and resumed from the level boundary with its spill shards
     reused;
  5. the full-size build rmat-hash:22:16:42 (Graph500 R-MAT, 4,194,304
     vertices, 67,108,864 edges), k=64, chunk 2^23, dispatch batch 8, on
     the card at the default depth (2), with the native split; the
     pipeline's dispatch loop runs under torch.cuda's sync debug mode
     "error". Every kernel of the path launched once a round enqueued
     (``exec_finish`` once an execution; the round's end has no launch of
     its own), one host read per confirmed execution, the device's round
     log one entry per counted round, ``hash_chunk`` once a chunk (the
     degrees pass synthesizes the 8 chunks, which stay on the card for the
     build and the score); the rounds' live-slot share and
     depth summarized; edge cut, total edges and comm volume equal to the
     JAX package's values;
  5b. one more phase 3c case, one more scatter case and K1's case (the
     read of the table before the scatter) at the main path's median
     depth and median live share; at that case ``climb_tail`` is also
     timed with the round's end folded in (``climb_rows`` on a one-row
     execution, in place, its live slots and state restored between
     calls); then ``lift_stack`` on the table of phase 5's own forest
     (P[pos[v]] = pos[parent[v]]), exactly against its plain version,
     with the rows it wrote counted and its launch profiled as in 3c,
     timed beside the stream floor (one row copied on the ladder's grid),
     with each level's entries below n and the distinct 32-byte sectors
     that a warp's gathers reach; and ``stream_descent`` on that table at
     L = 23 and 8, at the median share and at 100%, as in 3d (every
     ``stream_descent`` case also times one whole stream round on its
     inputs);
  5c. the full-size build at depths 1 and 3: the same partition, one host
     read per execution;
  5d. the full-size build through the per-segment driver (dispatch batch
     1, depth 1, chunk 2^22): the JAX package's cut, total and comm
     volume, one host read a segment; its phase seconds, segments by
     kind, host tails and launches, and the dispatch batch that auto
     resolves to on this card;
  5e. the full-size build with the entry point's defaults (auto dispatch
     batch and depth, chunk 2^22): the JAX package's cut, total and comm
     volume, the dispatch batch the auto rule gives, and the peak device
     memory beside the model's total and within 0.9 of the card's;
  5f. the planted partition at full size, sbm-hash:22:64:0.05:16:42
     (4,194,304 vertices, 67,108,864 edges, 64 blocks), through
     ``partition_multi`` at k = 64, 8, 256 and the entry point's defaults:
     one build, the JAX package's cut, total and comm volume at each k,
     the planted cut ratio beside the cut ratio, ``hash_chunk``'s
     launches;
  5g. the same graph through the port's CLI, in-process, ``--k 64
     --auto-recipe --json``: the advisor picks [8, 8], a final refine of
     10 and balance 1.05 (refine 8 a level); level 0 (build and refine at
     k = 8, spooled), the spill, eight level-1 builds and refines, the
     final refine at k = 64 (a 1 GiB histogram), the ledger and the score
     equal the JAX package's (``HIER22_*``); each refinement call's
     seconds, passes and cuts, the kernels' launches, the phase seconds
     and the peak device memory; then a pass of the final refine against
     its kernels' time at the phase 3g cases;
  5h. faults at full size, rmat-hash:22:16:42, k = 64, chunk 2^22: (a)
     N = 4, D = 2, a checkpoint every 4 chunks, killed at build:10 and
     resumed from its last build step, each save's seconds and bytes and
     the resumed run's phase seconds; (b) a real out-of-memory error of
     the card, under ``torch.cuda.set_per_process_memory_fraction``: at
     the default cache budget, where the ladder's retries run out on
     spills (ROADMAP Queue 3 item 8), its outcome recorded; then with one
     chunk cached, recovered in process through each rung (printed); (c)
     the graph as a .bin32 file with the default cache (the build and the
     score stage nothing), without it, and under a 128 MiB budget (spill
     and reload); each against the JAX package's cut, total and comm
     volume;
  5i. phase 5's build traced (``sheep_tpu_torch.obs``): in this process,
     untraced, traced, traced, untraced (a heartbeat every 0.25 s), each
     with phase 5's cut, comm volume, device rounds and host reads, their
     build and wall seconds; the port's CLI in a fresh process with
     ``--trace``, ``--heartbeat-secs 0.25`` and ``--metrics-out`` at phase
     5's settings: phase 5's result, ``tools/trace_report.py --check``
     passing, the span tree run > partition > {degrees, sort, build >
     dispatch x (host reads + 1), split, score} with the dispatch spans'
     rounds summing to the device rounds, a final heartbeat whose memory
     high-water is at most the run's peak, the manifest's device name and
     power limit nvidia-smi's; then with ``--profile-dir``: the Chrome
     trace names the ladder's, K1's, ``scatter_min``'s and
     ``climb_tail``'s kernels, with their summed device ms;
  5j. incremental epochs at full size (``s22-incremental``): 5h (c)'s
     .bin32 of rmat-hash:22:16:42 as the base of a delta log written by the
     port's ``DeltaLogWriter`` (epochs 1-4 add 2^20 edges each of
     rmat-hash:22:1:7, epoch 5 tombstones 2^18 base edges, epoch 6 adds
     2^16 of rmat-hash:22:1:8), k = 64, the backend's defaults: (a) epochs
     1-4 folded unscored (seconds, rounds, host reads and the path kernels'
     launches a fold), then a refresh with the comm volume, whose first full
     pass seeds the score cache (the survivor index's seconds and bytes):
     table, assignment, cut, total and comm volume equal to the one-shot
     ``partition("delta:LOG@4")`` (timed); (b) epoch 5 and a full
     compaction, equal to a clean build of the survivors; (c) epochs 5 and
     6 scored under ``SHEEP_SCORE_AUDIT=1``; (d) the same replay at
     rmat-hash:16:16:42 on CUDA and on the CPU, equal at every stage;
  5k. R-MAT at scale 24, rmat-hash:24:16:42 (16,777,216 vertices,
     268,435,456 edges), k = 64, at the entry point's defaults (chunks
     made on the card): its lifting stack passes the table budget, so
     every round takes the stream descent (no ``lift_stack`` launch, one
     ``stream_descent`` launch a round enqueued); the JAX package's cut,
     total and comm volume; its seconds, rounds, executions, host reads,
     launches, peak memory and the depth of its forest's table; then
     ``stream_descent`` on that forest's table at the build's shapes (L =
     25, rows of 2^22 slots; the median share and 100%), as in 3d;
  5l. the sharded build (``sheep_tpu_torch/parallel/``): phase 5's graph
     and k through ``ShardedPipeline`` on a mesh of 4 shards on the one
     card, per segment (N = 1, D = 1) and batched (N = 4, D = 2), then
     ``partition(..., backend="torch-sharded")`` on one shard (with more
     than one card visible, also both runs and the entry point on a mesh
     of every card, one shard a card; ``--sharded-cards`` runs this
     phase and 5m alone): each forest, assignment, cut, total, comm volume and
     balance equal to phase 5's; the merge's mode and payload, rounds,
     host reads, executions, pass seconds, edges/s, each kernel's
     launches and peak memory;
  5m. the vertex-sharded build (``TorchBigVBackend``, ``parallel/bigv.py``)
     of phase 5's graph and k at the backend's defaults (chunk 2^20, jumps
     128, 16 rounds a segment, L = 23, no hoisted stack) on 4 shards of
     the card, each round one host call (``routed.CardRound``: the
     card-mode scatter, ``routed_climb`` and ``routed_square`` launches,
     the round's end), the segment loop under sync debug mode "error"
     with one read a segment: forest, assignment, cut, total, comm volume
     and balance equal to phase 5's, its rounds, host reads, compactions,
     q_rounds and collective counts equal to ``BIGV_S22_COUNTS``, every
     routed kernel launched; its pass seconds, edges/s, launches by
     kernel and peak memory; the launches of one lifting and one tail
     round (at most 3 + 2L and 5, what ``CardRound`` counts, and the
     runtime's calls of one round: one cooperative launch and the rest
     kernel launches); then
     the hoisted stack (``hoist_bytes=1 << 30``) at rmat-hash:20:16:42
     against the ``torch`` backend; then ``BIGV_PATHS_SPEC`` on 4 shards of
     the card both ways, each round one ``CardRound`` and each round
     through the collectives and the wrappers card after card (the path of
     a mesh of several cards), equal to each other and to the ``torch``
     backend, with both build times (``--sharded-cards``: one shard a
     card, the rounds through the collectives, phase 5's graph for its
     pace only, stopped after the first batch past ``BIGV_CARDS_BUDGET_S``
     because all 16 batches do not fit a run, then ``BIGV_PATHS_SPEC`` in
     full, equal to the ``torch`` backend);
  5n. multi-process runs on ``torch.distributed``: two processes started
     with ``python -m sheep_tpu_torch.tools.mp_rank``, each holding two
     shards of the card over gloo with host staging (NCCL refuses two
     ranks on one card): phase 5's graph through ``torch-sharded`` per
     segment and batched (N = 4, D = 2), equal to phase 5;
     ``BIGV_PATHS_SPEC`` through ``torch-bigv``, as plain text through
     byte-range spans, and killed at ``build:2`` on both ranks then
     resumed from their checkpoints, each equal to the single-device
     build; every rank's forest and assignment digests and scores equal,
     and the ranks' non-time diagnostics equal; each rank hashes its own
     chunks on the card (``hash_chunk``) except for the text; one
     ``s22-multiprocess`` line a run with its ranks, shards, transport,
     seconds, edges/s, rounds, host reads, merge payload, each rank's peak
     memory and launches, and the card; then ``BIGV_PATHS_SPEC`` through
     ``python -m sheep_tpu_torch`` with the three flags, process 0's map
     and scores equal to the single-device build's (``--sharded-cards``:
     the same over NCCL, one rank a card, one shard a rank);
  6. one JSON line listing every kernel with its numbers, the lifting
     kernels and the scatter at the case of 5b, the round's end as folded
     into ``climb_tail`` (no launches of its own; its time the fused
     pass's less the plain pass's), ``lift_stack`` with the s22-forest
     case beside it; ``stream_descent``'s and ``compact_live``'s launches
     from 5d (``stream_descent``'s from 4b and 5k beside, ``lift_stack``'s
     from 5 with 5d's beside), ``climb_jumps``'s from the jump-mode fold
     of 4d, ``hash_chunk``'s R-MAT mode from 5 and its SBM
     mode from 5f, and the refinement's kernels from 5g; the delta fold's
     launches (5j) and the sharded builds' (5l) beside the main path's;
     the routed kernels with their 5m launches, at their 3h head cases;
  7. the last line, {"ok": true, "device": {...}}.

Without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time

# The JAX package's values for the full-size build, from its cpu backend:
#   JAX_PLATFORMS=cpu python -c 'import sheep_tpu; print(sheep_tpu.partition(
#       "rmat-hash:22:16:42", 64, backend="cpu").summary())'
S22_SPEC, S22_K = "rmat-hash:22:16:42", 64
S22_EDGE_CUT = 62191637
S22_TOTAL_EDGES = 67107073
S22_COMM_VOLUME = 18440186
# ... and for R-MAT at scale 24 (16,777,216 vertices, 268,435,456 edges),
# whose lifting stack passes the table budget, so that the fixpoint takes
# its stream descent, from its cpu backend:
#   JAX_PLATFORMS=cpu python -c 'import sheep_tpu; print(sheep_tpu.partition(
#       "rmat-hash:24:16:42", 64, backend="cpu").summary())'
S24_SPEC = "rmat-hash:24:16:42"
S24_EDGE_CUT = 248281185
S24_TOTAL_EDGES = 268432685
S24_COMM_VOLUME = 63283195
# ... and for the planted partition at the same size (64 blocks), one
# build split at three k, from its cpu backend:
#   JAX_PLATFORMS=cpu python -c 'import sheep_tpu; [print(r.summary()) for
#       r in sheep_tpu.partition_multi("sbm-hash:22:64:0.05:16:42",
#       [64, 8, 256], backend="cpu")]'
SBM22_SPEC, SBM22_KS = "sbm-hash:22:64:0.05:16:42", (64, 8, 256)
# k -> (edge cut, total edges, comm volume)
SBM22_SCORES = {64: (63429157, 67107864, 67362086),
                8: (58102508, 67107864, 28448493),
                256: (63713463, 67107864, 72638671)}
# ... and the same graph through the JAX package's CLI with the quality
# advisor's recipe ([8, 8], refine 8 a level, final refine 10, balance
# 1.05), from its cpu backend:
#   JAX_PLATFORMS=cpu python -m sheep_tpu.cli --input
#       sbm-hash:22:64:0.05:16:42 --k 64 --auto-recipe --json --backend cpu
# (edge cut, total edges, balance, comm volume)
HIER22_SCORES = (9941220, 67107864, 1.0492706298828125, 11113886)
HIER22_DIAGNOSTICS = {
    "level0_spill_bytes": 293172512, "refine_rounds_run": 10.0,
    "refine_hist_blocks": 1.0, "refine_host_plan": 0.0,
    "refine_moves_wanted": 10985373.0, "refine_moves_applied": 2845199.0,
    "refine_moves_capacity_blocked": 8140174.0,
    "refine_cut_before": 47445153.0, "refine_cut_after": 9941220.0,
    "cut_level0": 6692778, "cut_ratio_level0": 0.099732,
    "cut_level1": 3248442, "cut_ratio_level1": 0.048406,
    "ledger_parts_at_capacity": 0, "ledger_frozen_load_fraction": 0.0,
    "final_refine_repaired": 37503933}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def gathers(card):
    """Phases 3 and 3b: every gather kernel against its plain version on
    the card, exactly, each case timed (``gather_smoke.Probe``); then the
    probe tool, its launches counted. Returns the records by case and the
    tool's launches by kernel."""
    import torch

    from sheep_tpu_torch.ops import gather, gather2d
    from sheep_tpu_torch.tools import gather_smoke as gs

    p = gs.Probe("cuda")
    g = torch.Generator().manual_seed(11)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int32).cuda()

    def passed(rec):
        check(rec["built"] and rec["ok"],
              f"{rec['kernel']} {rec['form']} did not launch or disagrees "
              f"with its plain version: {rec}")
        return rec

    def k1(name, T, M, lo, hi):
        table, idx = ints(0, T, (T,)), ints(lo, hi, (M,))
        lib = None
        if lo >= 0 and hi <= T:  # torch.take does not clip
            idx64 = idx.long()
            lib = lambda: torch.take(table, idx64)  # noqa: E731
        return passed(p.case(
            name, lambda: gather.gather_clip(table, idx),
            lambda: gather.gather_clip_plain(table, idx), None,
            gs.take_bytes(T, idx), M, library=lib, kernel="K1", T=T, M=M))

    def k3(name, xshape, ishape, axis, shift, lo, hi):
        x, i = ints(0, 1 << 30, xshape), ints(lo, hi, ishape)
        lib = None
        if lo >= 0 and hi <= xshape[axis] and not shift:  # gather: no clip
            i64 = i.long()
            lib = lambda: torch.gather(x, axis, i64)  # noqa: E731
        return passed(p.case(
            name, lambda: gather2d.take_along(x, i, axis, shift),
            lambda: gather2d.take_along_plain(x, i, axis, shift), None,
            gs.along_bytes(x, i, axis, shift), i.numel(), library=lib,
            kernel="K3", axis=axis, shift=shift))

    # 3. K1 at the build path's shapes
    T = (1 << 22) + 1
    k1("climb", T, 1 << 23, 0, T)
    k1("square", T, T, 0, T)
    k1("K1-ragged-out-of-range", 1_000_003, 3_000_001, -500_000, 1_500_000)

    # 3b. what the probe tool does not run: K3 on a row wider than a
    # block's shared memory holds (232,448 bytes on an H100), and ragged
    # out-of-range cases on the scalar paths
    t, i = ints(0, 1 << 30, (1001, 37)), ints(-500, 1500, (3001,))
    passed(p.case("K2-ragged-out-of-range", lambda: gather2d.take_rows(t, i),
                  lambda: gather2d.take_rows_plain(t, i), None,
                  gs.rows_bytes(t, i), i.numel() * 37, kernel="K2"))
    k3("P3_lane_R65536", (8, 65536), (8, 65536), 1, 0, 0, 65536)
    k3("K3-axis0-ragged-out-of-range", (1001, 37), (513, 37), 0, 3, -8000,
       16000)
    k3("K3-axis1-ragged-out-of-range", (7, 999), (7, 1001), 1, 0, -300,
       1300)
    k3("K3-axis1-wide-ragged-out-of-range", (5, 60001), (5, 1003), 1, 0,
       -300, 70000)
    redesign_cases(p, ints, passed)

    # the probe tool, the path of K2 and K3: its launches are counted
    gather.reset_launches()
    gather2d.reset_launches()
    t0 = time.perf_counter()
    records = []
    for variant in (1, 2, 3):
        records += gs.run(variant, perf=True, device="cuda")
    launches = {"K1": gather.LAUNCHES["gather_clip"],
                "K2": gather2d.LAUNCHES["take_rows"],
                "K3": gather2d.LAUNCHES["take_along"]}
    bad = [r["form"] for r in records if not (r["ok"] and r["built"])]
    check(not bad, f"gather_smoke records not ok: {bad}")
    for name in ("K1", "K2", "K3"):
        check(launches[name] > 0, f"gather_smoke launched no {name}")
    print("gather_smoke " + json.dumps({
        "records": len(records), "all_ok": True, "launches": launches,
        "s": time.perf_counter() - t0, "card": card}), flush=True)
    return {r["form"]: r for r in p.records + records}, launches


def redesign_cases(p, ints, passed):
    """Phase 3b, the cases of K2's and K3's redesign: K2 in bulk (P2's
    (8192, 128) table, 2^16 random rows, 32 MiB written), K3 on axis 1 at
    R = 16384 and 32768 (R = 65536 beside them), and views that start at
    element 1 (t, x, idx or out) and odd widths on both kernels. Each is
    exact against its plain version, makes one launch a call
    (``gather2d.LAUNCHES``), and carries its chain bound
    (``gather_smoke.chain_bound_ms``) beside its bytes bound; K3's the
    bytes of the 32-byte sectors its lookups reach (``gather_smoke.Probe``
    adds both)."""
    import torch

    from sheep_tpu_torch.ops import gather2d
    from sheep_tpu_torch.tools import gather_smoke as gs

    sms = gather2d.sms("cuda")

    def one_launch(fn, key):
        n0 = gather2d.LAUNCHES[key]
        fn()
        torch.cuda.synchronize()
        check(gather2d.LAUNCHES[key] == n0 + 1,
              f"{key}: {gather2d.LAUNCHES[key] - n0} launches a call")

    def k2(name, t, i, out_at=0):
        out = gs.view_at(torch.empty((len(i), t.shape[1]),
                                     dtype=torch.int32, device="cuda"),
                         out_at)
        port = lambda: gather2d.take_rows(t, i, out=out)  # noqa: E731
        one_launch(port, "take_rows")
        lib = None
        if int(i.min()) >= 0 and int(i.max()) < t.shape[0]:
            i64 = i.long()
            lib = lambda: torch.index_select(t, 0, i64)  # noqa: E731
        return passed(p.case(
            name, port, lambda: gather2d.take_rows_plain(t, i), None,
            gs.rows_bytes(t, i), i.numel() * t.shape[1], library=lib,
            kernel="K2", plan=lambda: gather2d.plan_take_rows(
                t.shape[1], len(i), t.data_ptr(), out.data_ptr(), sms)))

    def k3(name, x, i, axis, shift=0, out_at=0):
        out = gs.view_at(torch.empty_like(i), out_at)
        port = lambda: gather2d.take_along(x, i, axis, shift,  # noqa: E731
                                           out=out)
        one_launch(port, "take_along")
        lib = None
        if not shift and int(i.min()) >= 0 and int(i.max()) < x.shape[axis]:
            i64 = i.long()
            lib = lambda: torch.gather(x, axis, i64)  # noqa: E731
        return passed(p.case(
            name, port, lambda: gather2d.take_along_plain(x, i, axis, shift),
            None, gs.along_bytes(x, i, axis, shift), i.numel(), library=lib,
            kernel="K3", axis=axis, shift=shift,
            plan=lambda: gather2d.plan_take_along(*i.shape, sms),
            sector_bytes=gs.sector_bytes(x, i, axis, shift)))

    tb = ints(0, 1 << 30, (1 << 13, 128))
    k2("K2-bulk", tb, ints(0, 1 << 13, (1 << 16,)))
    k2("K2-t-at-1", gs.view_at(tb, 1), ints(0, 1 << 13, (1 << 16,)))
    k2("K2-idx-at-1", tb, gs.view_at(ints(0, 1 << 13, (1 << 16,)), 1))
    k2("K2-out-at-1", tb, ints(0, 1 << 13, (1 << 16,)), out_at=1)
    k2("K2-odd-w37-out-at-1", ints(0, 1 << 30, (1001, 37)),
       ints(-500, 1500, (3001,)), out_at=1)
    for R in (1 << 14, 1 << 15):
        k3(f"K3-axis1-R{R}", ints(0, 1 << 30, (8, R)), ints(0, R, (8, R)), 1)
    x32 = ints(0, 1 << 30, (8, 1 << 15))
    i32 = ints(0, 1 << 15, (8, 1 << 15))
    k3("K3-axis1-x-at-1", gs.view_at(x32, 1), i32, 1)
    k3("K3-axis1-idx-at-1", x32, gs.view_at(i32, 1), 1)
    k3("K3-axis1-out-at-1", x32, ints(0, 1 << 15, (8, 1 << 15)), 1,
       out_at=1)
    lanes = torch.arange(128, dtype=torch.int32, device="cuda")[None, :]
    e = ints(0, 1 << 13, ((1 << 20) // 128, 128)) * 128 + lanes
    k3("K3-axis0-idx-at-1", tb, gs.view_at(e, 1), 0, 7)
    k3("K3-axis0-x-at-1", gs.view_at(tb, 1), e, 0, 7)
    k3("K3-axis0-odd-w37-out-at-1", ints(0, 1 << 30, (1001, 37)),
       ints(-8000, 16000, (513, 37)), 0, 3, out_at=1)
    k3("K3-axis1-odd-w1001-idx-at-1", ints(0, 1 << 30, (7, 999)),
       gs.view_at(ints(-300, 1300, (7, 1001)), 1), 1)
    # more tiles of rows than a grid's 65,535 y blocks: the kernel strides
    k3("K3-axis0-rows-past-grid-y", ints(0, 1 << 30, (1000, 1)),
       ints(-10, 1010, ((1 << 24) + 3, 1)), 0)


def climb_bytes(lo, hi, P, st, d: int, n: int) -> int:
    """The bytes one climb pass must move on these inputs: lo in and two
    outputs back (12 bytes a slot), and 32 bytes for each distinct sector
    that the pass must read of hi (at the live slots), of old_at_lo (at
    the retiring slots) and of each table (P at lo for the live slots,
    then levels d-1 .. 1 and P for the slots that climb)."""
    import torch

    def sectors(j):
        return torch.unique(j >> 3).numel()

    slot = torch.arange(lo.numel(), device=lo.device)
    live = lo != n
    retire = live & (hi == P[lo.long()])
    up = live & ~retire
    reads = sectors(slot[live]) + sectors(slot[retire])
    cur, h = lo[up], hi[up]
    for k in range(d - 1, 0, -1):
        reads += sectors(cur)
        cand = st[k - 1][cur.long()]
        cur = torch.where(cand < h, cand, cur)
    reads += sectors(torch.cat([lo[live], cur]))
    return 12 * lo.numel() + 32 * reads


def chain_for_depth(depth: int, n: int) -> int:
    """The length of a path through the first positions that gives a
    forest of phase 3c the depth ``depth``: 1.5 * 2^(depth-2) hops, so that
    the longest path (the path and a random forest's short tail) lies in
    (2^(depth-2), 2^(depth-1)] and d - 1 = ceil(log2) of it. The random
    forest alone gives d of 8-10, so below 11 no path is laid."""
    return min(3 << (depth - 3), n - 1) if depth >= 11 else 0


def synthetic_forest(n: int, path: int, g):
    """Phase 3c's position-space forest on ``g``'s device: parents a
    geometric(1/50) step ahead, 10% roots, and a path through the first
    ``path`` positions."""
    import torch

    dev = g.device
    p = torch.arange(n, device=dev)
    step = torch.empty(n, device=dev).geometric_(1 / 50, generator=g)
    P = torch.minimum(p + step.long(), torch.tensor(n, device=dev))
    P[torch.rand(n, device=dev, generator=g) < 0.1] = n
    P[:max(path - 1, 0)] = torch.arange(1, max(path, 1), device=dev)
    return torch.cat([P, torch.tensor([n], device=dev)]).int()


def synthetic_slots(n: int, C: int, share: float, g):
    """C slots (lo, hi), lo < hi < n, with ``share`` of them live; the
    others dead (n, n)."""
    import torch

    dev = g.device
    lo = torch.randint(0, n - 1, (C,), device=dev, generator=g)
    u = torch.rand(C, device=dev, generator=g, dtype=torch.float64)
    hi = lo + 1 + (u * (n - 1 - lo)).long()
    dead = torch.rand(C, device=dev, generator=g) >= share
    lo[dead] = n
    hi[dead] = n
    return lo.int(), hi.int()


def lifts(card, cases, n: int = 1 << 22, C: int = 1 << 23,
          dev: str = "cuda", fused: bool = False):
    """Phase 3c: ``lift_stack`` and ``climb_tail`` against their plain
    versions on the card, exactly, at the s22 shapes (the defaults), each
    case timed with its bound. ``cases`` holds (name, path length, live
    share): a random position-space forest (P[p] in (p, n]) with a path
    through its first positions, and slots with that share live. With
    ``fused``, ``climb_tail`` is also run and timed as the round's last
    kernel (``climb_rows`` on a one-row execution, which ends the round
    in its last block): its state against ``round_end_plain``'s, exactly,
    and its time from restored inputs (``fused_ms``). Returns the
    records."""
    import torch

    from sheep_tpu_torch.ops import lift
    from sheep_tpu_torch.ops.gather import gather_clip_plain
    from sheep_tpu_torch.tools import gather_smoke as gs

    T, L = n + 1, n.bit_length()
    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(13)

    records = []
    for name, path, share in cases:
        P0 = synthetic_forest(n, path, g)
        lo, hi = synthetic_slots(n, C, share, g)
        old = gather_clip_plain(P0, lo)
        P = P0.clone()
        P.scatter_reduce_(0, lo.long(), hi, reduce="amin",
                          include_self=True)
        st, d = lift.lift_stack_plain(P, L)
        p_lo, p_hi, ch, ret, live = lift.climb_tail_plain(
            lo, hi, old, P, st, d)
        want_ctl = [d - 1, int(ch), int(ret), int(live)]
        rec = {"case": name, "T": T, "C": C, "L": L, "path": path,
               "share": share, "depth": d, "live": int(live),
               "retired": int(ret)}
        stack = lift.new_stack(T, L, dev)
        ctl = lift.new_ctl(dev)
        if not records and not fused and dev.type == "cuda":
            # once, in phase 3c: a later profiler session in the same
            # process has come back empty on the card
            rec["ladder_profile"] = one_launch_ladder(P, stack, ctl)
        stack.fill_(-1)  # no entry of a level: rows_written counts them
        lift.lift_stack(P, stack, ctl)
        rec["levels_computed"] = rows_written(stack, T, d, name)
        out_lo, out_hi = lift.climb_tail(lo, hi, old, P, stack, ctl)
        torch.cuda.synchronize()
        errs = [int((stack[:d - 1, :T].long() - st[:d - 1].long())
                    .abs().max()) if d > 1 else 0,
                int((out_lo.long() - p_lo.long()).abs().max()),
                int((out_hi.long() - p_hi.long()).abs().max())]
        rec["max_abs_err"] = max(errs)
        check(max(errs) == 0 and ctl.tolist() == want_ctl + [0],
              f"{name}: kernels disagree with their plain versions "
              f"(errors {errs}, ctl {ctl.tolist()} != {want_ctl})")
        rec["lift_ms"] = gs.time_ms(lambda: lift.lift_stack(P, stack, ctl))
        # the ladders left ctl at this case's rows; the climbs add to it
        rec["climb_ms"] = gs.time_ms(
            lambda: lift.climb_tail(lo, hi, old, P, stack, ctl))
        if fused:
            rec.update(fused_climb(lo, hi, old, P, stack, n, want_ctl))
        del stack
        rec["lift_plain_ms"] = gs.time_ms(
            lambda: lift.lift_stack_plain(P, L), iters=3)
        rec["climb_plain_ms"] = gs.time_ms(
            lambda: lift.climb_tail_plain(lo, hi, old, P, st, d), iters=5)
        P64 = P.long()
        rec["take_level_ms"] = gs.time_ms(lambda: torch.take(P, P64))
        rec["lift_bound_ms"] = gs.bound_ms(ladder_bytes(T, d))
        rec["climb_bound_ms"] = gs.bound_ms(climb_bytes(lo, hi, P, st, d, n))
        rec["card"] = card
        print("lift " + json.dumps(rec), flush=True)
        records.append(rec)
    return records


def ladder_bytes(T: int, d: int) -> int:
    """The bytes a ladder of depth d must move: P read once and the levels
    t_1 .. t_{d-1} written once."""
    return 4 * T * d


def rows_written(stack, T: int, d: int, what: str) -> int:
    """The stack rows that a ladder wrote over a stack filled with -1
    (no entry of a level is negative): each row written in full or not at
    all, the written ones first, none past T; checked to be the levels up
    to the first all-n one of a position-space table, max(d - 1, 1), so
    that t_d, which equals t_{d-1}, was never computed."""
    rows = len(stack)
    touched = stack[:, :T] != -1
    full = touched.all(1)
    count = int(full.sum())
    check(bool((full == touched.any(1)).all()) and bool(full[:count].all())
          and bool((stack[:, T:] == -1).all()),
          f"{what}: the ladder wrote part of a row, or past a gap")
    want = min(max(d - 1, 1), rows)
    check(count == want, f"{what}: the ladder computed {count} levels, not "
          f"max(d - 1, 1) = {want} (d = {d})")
    return count


def one_launch_ladder(P, stack, ctl) -> dict:
    """The device work of one ``lift_stack`` call, by ``torch.profiler``:
    the CUDA runtime's launch, memset and copy calls (``api``), checked
    to be one ``cudaLaunchCooperativeKernel`` and nothing else, and the
    device's records (``kernels``), checked to hold no kernel or memset
    but ``lift_ladder``. The runtime calls are the witness: on an H100,
    once phase 4d has run, a session keeps the runtime call and the
    records of ordinary kernels but drops the cooperative kernel's own
    record for the rest of the process (PERF.md, section 7), so
    ``kernels`` may then be empty."""
    import torch

    from sheep_tpu_torch.ops import lift

    lift.lift_stack(P, stack, ctl)
    torch.cuda.synchronize()
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        lift.lift_stack(P, stack, ctl)
        torch.cuda.synchronize()
    events = prof.events()
    api = [e.name for e in events
           if e.device_type == torch.autograd.DeviceType.CPU and
           re.match(r"cuda(Launch|Memset|Memcpy)", e.name)]
    kernels = [e.name for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    check(api == ["cudaLaunchCooperativeKernel"] and len(kernels) <= 1 and
          all("lift_ladder" in k for k in kernels),
          f"lift_stack is not one kernel launch a ladder: runtime calls "
          f"{api}, device records {kernels}")
    return {"api": api, "kernels": kernels}


def forest_table(res, n: int, dev: str = "cuda"):
    """The position-space table of a result's forest on ``dev``:
    P[pos[v]] = pos[parent[v]], roots -> n, P[n] = n."""
    import torch

    parent = torch.from_numpy(res.tree["parent"]).to(dev)
    pos = torch.from_numpy(res.tree["pos"][:n].astype("int64")).to(dev)
    P = torch.full((n + 1,), n, dtype=torch.int32, device=dev)
    has = parent >= 0
    P[pos[has]] = pos[parent[has]].int()
    return P


def level_sectors(P, d: int, n: int) -> list:
    """For each level j the ladder computes (gathering from t_j at t_j's
    entries): the entries below n, and the distinct 32-byte sectors that
    a warp's gathers reach (a warp takes 128 consecutive entries an
    iteration: 32 lanes of a 16-byte quad), over all entries and over
    those below n; by torch ops on the card."""
    import torch

    from sheep_tpu_torch.ops.gather import gather_clip_plain

    T = len(P)
    warp = torch.arange(T, device=P.device) >> 7
    per_warp = (T >> 3) + 1
    out, t = [], P
    for j in range(max(d - 1, 1)):
        key = warp * per_warp + (t.long() >> 3)
        below = t != n
        out.append({"level": j, "below_n": int(below.sum()),
                    "sectors": torch.unique(key).numel(),
                    "sectors_below_n": torch.unique(key[below]).numel()})
        t = gather_clip_plain(t, t)
    return out


def forest_ladder(card, res, n: int = 1 << 22) -> dict:
    """Phase 5b's s22-forest case: ``lift_stack`` on the table of the
    full-size build's own forest (T = 2^22 + 1), exactly against its plain
    version (stack rows 0 .. rows-1 and all five ctl words), the rows it
    wrote counted (:func:`rows_written`) and its launch profiled
    (:func:`one_launch_ladder`); its time, the
    plain version's, ``torch.take(t, t)`` for one level, the stream floor
    (one row copied on the ladder's grid, ``lift.copy_row``), the bytes
    bound, and each level's entries below n and warp sectors."""
    import torch

    from sheep_tpu_torch.ops import lift
    from sheep_tpu_torch.tools import gather_smoke as gs

    T, L = n + 1, n.bit_length()
    P = forest_table(res, n)
    st, d = lift.lift_stack_plain(P, L)
    stack = lift.new_stack(T, L, P.device)
    ctl = lift.new_ctl(P.device)
    ctl.fill_(7)  # the ladder zeroes every word
    stack.fill_(-1)
    lift.lift_stack(P, stack, ctl)
    levels = rows_written(stack, T, d, "s22 forest")
    err = int((stack[:d - 1, :T].long() - st[:d - 1].long()).abs().max()) \
        if d > 1 else 0
    check(err == 0 and ctl.tolist() == [d - 1, 0, 0, 0, 0],
          f"s22 forest: lift_stack disagrees with its plain version (error "
          f"{err}, ctl {ctl.tolist()}, depth {d})")
    profile = one_launch_ladder(P, stack, ctl)
    blocks, threads = lift.ladder_grid(T)
    P64 = P.long()
    rec = {"case": "s22-forest", "T": T, "L": L, "depth": d,
           "levels_computed": levels, "ladder_profile": profile,
           "max_abs_err": err,
           "lift_ms": gs.time_ms(lambda: lift.lift_stack(P, stack, ctl)),
           "lift_plain_ms": gs.time_ms(lambda: lift.lift_stack_plain(P, L),
                                       iters=3),
           "take_level_ms": gs.time_ms(lambda: torch.take(P, P64)),
           "floor_ms": gs.time_ms(lambda: lift.copy_row(P, stack[0])),
           "floor_bound_ms": gs.bound_ms(8 * T),
           "lift_bound_ms": gs.bound_ms(ladder_bytes(T, d)),
           "grid": [blocks, threads],
           "levels": level_sectors(P, d, n), "card": card}
    rec["gather_bytes"] = 32 * sum(lv["sectors_below_n"]
                                   for lv in rec["levels"])
    print("lift-forest " + json.dumps(rec), flush=True)
    return rec


def fused_climb(lo, hi, old, P, stack, n: int, want_ctl, budget: int = 64):
    """``climb_tail`` with the round's end folded in (``climb_rows`` on a
    one-row execution): one call from a fresh state against
    ``round_end_plain`` on the plain control word, every word of the state
    equal; then its time (``fused_ms``) and that of the same pass without
    the round's end (``unfused_ms``: the same kernel with no execution
    state, written in place into the same row), each from the same inputs
    restored before each call (the live slots, which the pass moves in
    place, and the state), less the restore's time (``inplace_ms``); and
    the plain round's end on the card's tensors."""
    import torch

    from sheep_tpu_torch.ops import fixpoint, lift
    from sheep_tpu_torch.tools import gather_smoke as gs

    dev = lo.device
    loB, hiB = lo[None].clone(), hi[None].clone()
    at = (lo != n).nonzero().squeeze(1)
    lo_at, hi_at = lo[at], hi[at]
    state0 = fixpoint.new_state(budget, dev)
    state = state0.clone()
    ctl = lift.new_ctl(dev)
    ctl[lift.ROWS] = want_ctl[lift.ROWS]
    lift.climb_rows(loB, hiB, old, P, stack, ctl, state, budget)
    want = state0.cpu()
    fixpoint.round_end_plain(torch.tensor(want_ctl + [0], dtype=torch.int32),
                             want, 1, budget)
    got_ctl = ctl.tolist()
    err = int((state.cpu() - want).abs().max())
    check(err == 0 and got_ctl == want_ctl + [0],
          f"climb_rows with the round's end disagrees with its plain "
          f"versions (state error {err}, ctl {got_ctl} != {want_ctl})")

    def restore():
        loB[0].index_copy_(0, at, lo_at)
        hiB[0].index_copy_(0, at, hi_at)
        state.copy_(state0)

    # the same pass without the round's end (no execution state), into
    # the same row in place, after the same restore: the baseline of the
    # difference
    unfused = inplace_ms(restore, lambda: lift._launch_climb(
        loB[0], hiB[0], old, P, stack, ctl, loB[0], hiB[0]))

    # the plain round's end on the card's tensors (its reads go to the
    # host), on a state whose row the round does not move
    plain_ctl = torch.tensor(want_ctl + [0], dtype=torch.int32, device=dev)
    plain_ctl[lift.CHANGED] = 1
    plain_state = fixpoint.new_state(1000, dev)
    return {"fused_max_abs_err": err, "fused_ms": inplace_ms(
        restore, lambda: lift.climb_rows(loB, hiB, old, P, stack, ctl, state,
                                         budget)), "unfused_ms": unfused,
        "round_end_plain_ms": gs.time_ms(lambda: fixpoint.round_end_plain(
            plain_ctl, plain_state, 1, 1000), iters=5),
        # ctl and the state's counters read, the counters and a log entry
        # written
        "round_end_bound_ms": gs.bound_ms(16 + 8 * fixpoint.LOG * 2 + 16)}


def sectors(j) -> int:
    """Distinct 32-byte sectors of int32 entries at indices ``j``."""
    import torch

    return torch.unique(j >> 3).numel()


def inplace_ms(reset, fn, iters: int = 50) -> float:
    """Time of ``fn`` on freshly reset inputs: (reset + fn) less reset
    alone, both by ``gather_smoke.time_ms``."""
    from sheep_tpu_torch.tools import gather_smoke as gs

    both = gs.time_ms(lambda: (reset(), fn()), iters=iters)
    return max(both - gs.time_ms(reset, iters=iters), 0.0)


def scatters(card, shares, n: int = 1 << 22, C: int = 1 << 23):
    """Phase 3d: ``scatter_min`` against its plain version and against
    the library pair it replaced (the dead-slot ``torch.where`` index and
    ``scatter_reduce_``), exactly, at the s22 shapes (T = n + 1, C slots)
    with each share of live slots, on a random position-space table. Each
    timed from a fresh copy of the table, with its bound: lo in, hi at
    the live slots, one sector of P for each distinct sector written."""
    import torch

    from sheep_tpu_torch.ops import fixpoint
    from sheep_tpu_torch.tools import gather_smoke as gs

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    P0 = torch.randint(1, n + 1, (n + 1,), device=dev, generator=g,
                       dtype=torch.int32)
    P0[n] = n
    spread = torch.arange(C, device=dev) % (n + 1)
    records = []
    for share in shares:
        lo = torch.randint(0, n - 1, (C,), device=dev, generator=g)
        hi = torch.randint(0, n, (C,), device=dev, generator=g).maximum(lo + 1)
        dead = torch.rand(C, device=dev, generator=g) >= share
        lo[dead] = n
        hi[dead] = n
        lo, hi = lo.int(), hi.int()
        live = lo != n
        P, ref, lib = P0.clone(), P0.clone(), P0.clone()

        def library():
            lib.scatter_reduce_(0, torch.where(lo == n, spread, lo.long()),
                                hi, reduce="amin", include_self=True)

        fixpoint.scatter_min(P, lo, hi)
        fixpoint.scatter_min_plain(ref, lo, hi)
        library()
        torch.cuda.synchronize()
        err = max(int((P.long() - ref.long()).abs().max()),
                  int((lib.long() - ref.long()).abs().max()))
        check(err == 0, f"scatter_min at live share {share:g} disagrees "
                        f"with its plain version or the library pair")
        slot = torch.arange(C, device=dev)
        rec = {"case": f"live{share:g}", "T": n + 1, "C": C, "share": share,
               "live": int(live.sum()), "max_abs_err": err,
               "ms": inplace_ms(lambda: P.copy_(P0),
                                lambda: fixpoint.scatter_min(P, lo, hi)),
               "plain_ms": inplace_ms(
                   lambda: ref.copy_(P0),
                   lambda: fixpoint.scatter_min_plain(ref, lo, hi),
                   iters=5),
               "library_ms": inplace_ms(lambda: lib.copy_(P0), library),
               "bound_ms": gs.bound_ms(4 * C + 32 * sectors(slot[live])
                                       + 32 * sectors(lo[live])),
               "card": card}
        print("scatter_min " + json.dumps(rec), flush=True)
        records.append(rec)
    return records


def k1_main(card, share, n: int = 1 << 22, C: int = 1 << 23):
    """Phase 5b: K1 at the main path's case, the read of the table before
    the scatter (``old_at_lo = P[lo]``) with a median round's share of
    live slots (the dead ones read P[n]), against its plain version,
    exactly, timed beside it, ``torch.take`` and its bound: lo in and the
    result out (8 B a slot), and each distinct sector of P it reaches."""
    import torch

    from sheep_tpu_torch.ops import gather
    from sheep_tpu_torch.tools import gather_smoke as gs

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(29)
    P = torch.randint(1, n + 1, (n + 1,), device=dev, generator=g,
                      dtype=torch.int32)
    P[n] = n
    lo = torch.randint(0, n - 1, (C,), device=dev, generator=g)
    lo[torch.rand(C, device=dev, generator=g) >= share] = n
    lo = lo.int()
    got = gather.gather_clip(P, lo)
    want = gather.gather_clip_plain(P, lo)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    check(err == 0, "K1 at the main case disagrees with its plain version")
    lo64 = lo.long()
    rec = {"case": f"main-live{share:.3g}", "T": n + 1, "M": C,
           "live": int((lo != n).sum()), "max_abs_err": err,
           "ms": gs.time_ms(lambda: gather.gather_clip(P, lo)),
           "plain_ms": gs.time_ms(lambda: gather.gather_clip_plain(P, lo)),
           "library_ms": gs.time_ms(lambda: torch.take(P, lo64)),
           "bound_ms": gs.bound_ms(8 * C + 32 * sectors(lo64)),
           "card": card}
    print("K1-main " + json.dumps(rec), flush=True)
    return rec


def scatter_rows(C: int = (1 << 20) + 3, N: int = 3, n: int = 1 << 20,
                 dev: str = "cuda"):
    """Phase 3d: ``scatter_min`` on each row of [N, C] blocks, C not a
    multiple of 4, so that rows 1 and 2 start off a 16-byte boundary (its
    scalar head and tail), with 50% and 1% of the slots live, against its
    plain version on that row, exactly."""
    import torch

    from sheep_tpu_torch.ops import fixpoint

    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(23)
    P0 = torch.randint(1, n + 1, (n + 1,), device=dev, generator=g,
                       dtype=torch.int32)
    P0[n] = n
    worst = 0
    for share in (0.5, 0.01):
        loB = torch.randint(0, n - 1, (N, C), device=dev, generator=g)
        hiB = torch.randint(0, n, (N, C), device=dev,
                            generator=g).maximum(loB + 1)
        dead = torch.rand(N, C, device=dev, generator=g) >= share
        loB[dead] = n
        hiB[dead] = n
        loB, hiB = loB.int(), hiB.int()
        for row in range(N):
            state = fixpoint.new_state(1, dev)
            state[fixpoint.ROW] = row
            P, ref = P0.clone(), P0.clone()
            fixpoint.scatter_min(P, loB, hiB, state)
            fixpoint.scatter_min_plain(ref, loB[row], hiB[row])
            torch.cuda.synchronize()
            err = int((P.long() - ref.long()).abs().max())
            check(err == 0, f"scatter_min on row {row} of [{N}, {C}] blocks "
                            f"(live share {share:g}) disagrees with its "
                            f"plain version")
            worst = max(worst, err)
    print(f"scatter_min rows: [{N}, {C}] blocks, rows 0-{N - 1}, exact "
          f"(max_abs_err {worst})", flush=True)
    return worst


def fused_rounds(card, scale: int = 14, N: int = 3, C: int = 1 << 13,
                 dev: str = "cuda"):
    """Phase 3d: the round's end folded into ``climb_tail``'s last block,
    held against the CPU round by round. Executions over [N, C] blocks of
    an R-MAT graph (the port's generator, order and orientation), on the
    exact and the stream descent, with budgets that run out in the middle
    of a row and that leave no-op rounds after the last row; after each
    round every word of the execution's state and of the control word on
    the card equals the CPU's (``climb_rows``'s plain version, then
    ``round_end_plain``). Returns the rounds compared."""
    import torch

    from sheep_tpu_torch.io import generators
    from sheep_tpu_torch.ops import degrees, elim, fixpoint, order

    cpu, dev = torch.device("cpu"), torch.device(dev)
    n = 1 << scale
    e = torch.from_numpy(generators.rmat_hash_range(scale, 0, N * C,
                                                    seed=3)).int()
    deg = degrees.init_degrees(n, cpu)
    degrees.degree_chunk(deg, e, n)
    pos, _ = order.elimination_order(deg, n)
    loB0, hiB0 = elim.orient_chunks_batch_pos(e.reshape(N, C, 2), pos, n)
    seen = {"row_switch": False, "budget_spent": False, "no_op": False}
    compared = 0
    t0 = time.perf_counter()
    for descent in ("exact", "stream"):
        L = n.bit_length()
        for budget in (5, 23, 400):
            runs = []
            for d in (cpu, dev):
                runs.append((elim._pos_round_body(n, L, descent),
                             torch.full((n + 1,), n, dtype=torch.int32,
                                        device=d),
                             loB0.clone().to(d), hiB0.clone().to(d),
                             fixpoint.new_state(budget, d)))
            for r in range(budget):
                for body, P, loB, hiB, state in runs:
                    body(loB, hiB, P, state, budget)
                (cb, _, _, _, cs), (gb, gP, glo, ghi, gs_) = runs
                torch.cuda.synchronize()
                check(torch.equal(gs_.cpu(), cs) and
                      torch.equal(gb.ctl.cpu(), cb.ctl),
                      f"{descent} budget {budget} round {r}: the card's "
                      f"state or control word differs from the CPU's")
                compared += 1
            (_, P, loB, hiB, cs), (_, gP, glo, ghi, _) = runs
            check(torch.equal(gP.cpu(), P) and torch.equal(glo.cpu(), loB)
                  and torch.equal(ghi.cpu(), hiB),
                  f"{descent} budget {budget}: table or blocks differ")
            rows, rounds = int(cs[fixpoint.ROW]), int(cs[fixpoint.ROUNDS])
            seen["row_switch"] |= rows >= 1
            seen["budget_spent"] |= rows < N
            seen["no_op"] |= rounds < budget
    check(all(seen.values()), f"the executions missed a case: {seen}")
    print("round_end-fused " + json.dumps({
        "blocks": [N, C], "scale": scale, "rounds_compared": compared,
        "cases": seen, "s": time.perf_counter() - t0, "card": card}),
        flush=True)
    return compared


def exec_kernels(card, n: int = 1 << 22, N: int = 8, C: int = 1 << 23):
    """Phase 3d, the execution's other kernel against its plain version,
    exactly, at the s22 shapes, timed with its bound: ``exec_finish`` on
    [N, C] blocks with all rows and with half the rows converged. Returns
    the records by kernel."""
    import torch

    from sheep_tpu_torch.ops import fixpoint
    from sheep_tpu_torch.tools import gather_smoke as gs

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    out = {}

    # exec_finish: all rows converged, then half
    loB0 = torch.randint(0, n + 1, (N, C), device=dev, generator=g,
                         dtype=torch.int32)
    hiB0 = torch.randint(0, n + 1, (N, C), device=dev, generator=g,
                         dtype=torch.int32)
    cases = []
    for done in (N, N // 2):
        state = fixpoint.new_state(1, dev)
        state[fixpoint.ROW], state[fixpoint.ROUNDS] = done, 16
        state[fixpoint.RETIRED] = 777
        a_lo, a_hi = loB0.clone(), hiB0.clone()
        sv = fixpoint.exec_finish(a_lo, a_hi, state, n)
        b_lo, b_hi = loB0.clone(), hiB0.clone()
        sv_p = fixpoint.exec_finish_plain(b_lo, b_hi, state.cpu(), n)
        torch.cuda.synchronize()
        err = max(int((a_lo.long() - b_lo.long()).abs().max()),
                  int((a_hi.long() - b_hi.long()).abs().max()),
                  int((sv.cpu().long() - sv_p.long()).abs().max()))
        check(err == 0, f"exec_finish with {done} rows done disagrees with "
                        f"its plain version")
        rec = {"case": f"done{done}of{N}", "max_abs_err": err,
               "ms": gs.time_ms(
                   lambda: fixpoint.exec_finish(a_lo, a_hi, state, n)),
               "plain_ms": gs.time_ms(lambda: fixpoint.exec_finish_plain(
                   b_lo, b_hi, state.cpu(), n), iters=5),
               # rows below done written (lo and hi), the rest of lo read
               "bound_ms": gs.bound_ms(8 * done * C + 4 * (N - done) * C),
               "library_ms": None, "card": card}
        cases.append(rec)
    out["exec_finish"] = dict(cases[0], cases=cases)
    for name, rec in out.items():
        print(f"{name} " + json.dumps(rec), flush=True)
    return out


def descent_bytes(P, lo, hi, L: int, n: int):
    """The bytes one stream descent must move on these inputs, the levels
    it squares and its gathers' sectors: lo read once (4 B a slot), hi
    read and pre written at the live slots (8 B each); for each level
    squared (up to the first all n, or equal to its source, or after
    which no slot moves, where the kernel stops), t_j read and t_{j+1}
    written (8 B an entry): the gathers of both the squaring and the
    climb fall in t_j, read whole; for the last level climbed, unsquared,
    32 B for each distinct sector of it that the gathers of the slots
    still moving reach. Returns (bytes, levels squared, the distinct
    32-byte sectors that a warp's gathers of the squared levels' entries
    below n reach, as ``level_sectors`` counts them, in bytes: L2
    traffic beside the bound, not in it)."""
    import torch

    T = len(P)
    live = lo != n
    cur, h = lo[live].long(), hi[live]
    going = torch.ones_like(h, dtype=torch.bool)
    nbytes = 4 * lo.numel() + 8 * cur.numel()
    warp = torch.arange(T, device=P.device) >> 7
    per_warp = (T >> 3) + 1
    t, squared, gather = P, 0, 0
    for j in range(L):
        reach = 32 * sectors(cur[going])
        cand = t[cur]
        going &= cand < h
        cur = torch.where(going, cand.long(), cur)
        if j == L - 1:
            nbytes += reach
            break
        key = warp * per_warp + (t.long() >> 3)
        gather += 32 * torch.unique(key[t != n]).numel()
        nbytes += 8 * T
        t2 = t[t.long()]
        squared += 1
        if not bool((t2 != n).any()) or torch.equal(t2, t) or \
                not bool(going.any()):
            break
        t = t2
    return nbytes, squared, gather


def stream_round(P0, lo, hi, L: int) -> dict:
    """One whole stream round, ``_pos_round_body(n, L, "stream")`` on a
    one-row execution (K1, ``scatter_min``, ``stream_descent``,
    ``climb_tail``), from the table and slots given, restored before each
    call: its device ms less the restore's, and its launches by kernel,
    which must be one of each of those four."""
    import torch

    from sheep_tpu_torch.ops import elim, fixpoint, gather, lift
    from sheep_tpu_torch.tools import gather_smoke as gs

    n = len(P0) - 1
    body = elim._pos_round_body(n, L, "stream")
    P, loB, hiB = P0.clone(), lo[None].clone(), hi[None].clone()
    state0 = fixpoint.new_state(1, P.device)
    state = state0.clone()

    def restore():
        P.copy_(P0)
        loB[0].copy_(lo)
        hiB[0].copy_(hi)
        state.copy_(state0)

    def one():
        restore()
        body(loB, hiB, P, state, 1)

    def counts():
        return {k: v for c in (gather, fixpoint, lift)
                for k, v in c.LAUNCHES.items()}

    one()
    before = counts()
    one()
    launches = {k: v - before[k] for k, v in counts().items()
                if v != before[k]}
    check(launches == {"gather_clip": 1, "scatter_min": 1,
                       "stream_descent": 1, "climb_tail": 1},
          f"a stream round launched {launches}")
    both = gs.time_ms(one, iters=20)
    alone = gs.time_ms(restore, iters=20)
    return {"round_ms": both - alone, "round_restore_ms": alone,
            "round_launches": launches}


def descents(card, cases, C: int = 1 << 23, seed: int = 41):
    """``stream_descent`` against its plain version on the card, exactly
    (``pre`` at the live slots, and ``ctl`` = [L - 1, 0, 0, 0, 0] over a
    word filled with 7), at C slots (2^23, the s22 shapes, by default).
    ``cases`` holds (name, table, L, live share): phase 3d's synthetic
    forests (``synthetic_forest``, random and with a chain of
    ``chain_for_depth``), and the tables of the s22 build's own forest
    (5b) and of the s24 build's (5k, T = 2^24 + 1, L = 25, C = 2^22)
    (``forest_table``). Each timed beside its plain version and
    ``torch.take(t, t)`` (one squaring level, the library yardstick), with
    its bytes bound (``descent_bytes``) and the whole stream round on the
    same inputs (:func:`stream_round`); the first is one cooperative
    launch (``device_launches``). Returns the records."""
    import torch

    from sheep_tpu_torch.ops import lift
    from sheep_tpu_torch.tools import gather_smoke as gs

    g = torch.Generator(device="cuda").manual_seed(seed)
    records = []
    for name, P, L, share in cases:
        T = len(P)
        n = T - 1
        lo, hi = synthetic_slots(n, C, share, g)
        want = lift.stream_descent_plain(P, lo, hi, L)
        scratch = lift.new_descent(T, C, L, P.device)
        ctl = lift.new_ctl(P.device).fill_(7)

        def kernel():
            return lift.stream_descent(P, lo, hi, L, scratch, ctl)

        pre = kernel()
        torch.cuda.synchronize()
        live = lo != n
        err = int((pre[live].long() - want[live].long()).abs().max()) \
            if bool(live.any()) else 0
        check(err == 0 and ctl.tolist() == [L - 1, 0, 0, 0, 0],
              f"stream_descent {name}: disagrees with its plain version "
              f"(error {err}, ctl {ctl.tolist()})")
        nbytes, squared, gather = descent_bytes(P, lo, hi, L, n)
        P64 = P.long()
        rec = {"case": name, "T": T, "C": C, "L": L, "share": share,
               "live": int(live.sum()), "levels_squared": squared,
               "gather_bytes": gather,
               "max_abs_err": err, "ms": gs.time_ms(kernel),
               "plain_ms": gs.time_ms(
                   lambda: lift.stream_descent_plain(P, lo, hi, L), iters=3),
               "library_ms": gs.time_ms(lambda: torch.take(P, P64)),
               "bound_ms": gs.bound_ms(nbytes), "bound_by": "bytes",
               **stream_round(P, lo, hi, L), "card": card}
        if not records:
            rec["device"] = device_launches(kernel, f"stream_descent {name}",
                                            [COOPERATIVE])
        print("stream_descent " + json.dumps(rec), flush=True)
        records.append(rec)
    return records


def stopped_descent(card, n: int = 1 << 22, C: int = 1 << 23, L: int = 23):
    """``stream_descent`` on a stopped execution: [1, C] blocks, a state
    with STOP set; nothing written (``pre``, the rows, the mask and ``ctl``
    keep their fill), and its time, the floor of a stopped round's
    launch."""
    import torch

    from sheep_tpu_torch.ops import fixpoint, lift
    from sheep_tpu_torch.tools import gather_smoke as gs

    g = torch.Generator(device="cuda").manual_seed(43)
    P = synthetic_forest(n, 0, g)
    lo, hi = synthetic_slots(n, C, 1.0, g)
    state = fixpoint.new_state(1, P.device)
    state[fixpoint.STOP] = 1
    scratch = lift.new_descent(n + 1, C, L, P.device)
    ctl = lift.new_ctl(P.device)
    for t in (*scratch, ctl):
        t.fill_(7)

    def kernel():
        lift.stream_descent(P, lo[None], hi[None], L, scratch, ctl, state)

    kernel()
    torch.cuda.synchronize()
    check(all(bool((t == 7).all()) for t in (*scratch, ctl)),
          "stream_descent wrote on a stopped execution")
    rec = {"case": "stopped", "T": n + 1, "C": C, "L": L,
           "ms": gs.time_ms(kernel), "card": card}
    print("stream_descent " + json.dumps(rec), flush=True)
    return rec


def compactions(card, shares=(0.5, 0.1, 0.01), n: int = 1 << 22,
                C: int = 1 << 22, dup: float = 0.3):
    """Phase 3e: ``compact_live`` against its plain version on the card,
    exactly, at the adaptive driver's widest buffer (C = 2^22 pairs, T =
    2^22+1 positions), each share of live pairs with about ``dup`` of them
    copies of others, and ``size`` the driver's rule, pow2_at_least(2 live,
    2^14); then on the case table ``kernel_cases.compact_cases``. Its
    launches a call are ``torch.profiler``'s runtime calls, which must be
    one cooperative kernel launch and nothing else. Timed: the whole
    call, the plain version, and ``torch.unique`` of the packed keys with
    a masked select of the live ones as a yardstick (it and the plain
    version read their sizes back to the host, so they are timed without
    the spin prefill); the bound: lo read (4 B a slot), the 32 B sectors of
    hi that hold a live slot, and the output written (8 B a slot of
    ``size``)."""
    import torch

    from sheep_tpu_torch.ops import compact
    from sheep_tpu_torch.ops.elim import pow2_at_least
    from sheep_tpu_torch.tools import gather_smoke as gs
    from sheep_tpu_torch.tools import kernel_cases

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    records = []
    for share in shares:
        lo = torch.randint(0, n - 1, (C,), device=dev, generator=g)
        u = torch.rand(C, device=dev, generator=g, dtype=torch.float64)
        hi = lo + 1 + (u * (n - 1 - lo)).long()
        copy = torch.rand(C, device=dev, generator=g) < dup
        src = torch.randint(0, C, (C,), device=dev, generator=g)
        lo = torch.where(copy, lo[src], lo)
        hi = torch.where(copy, hi[src], hi)
        dead = torch.rand(C, device=dev, generator=g) >= share
        lo[dead] = n
        hi[dead] = n
        lo, hi = lo.int(), hi.int()
        live = int((lo != n).sum())
        size = pow2_at_least(2 * live, 1 << 14)
        got = compact.compact_live(lo, hi, n, size)
        want = compact.compact_live_plain(lo, hi, n, size)
        torch.cuda.synchronize()
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(got, want))
        check(err == 0, f"compact_live at live share {share:g} disagrees "
                        f"with its plain version")
        # the sharded driver's compaction keeps the duplicates
        kept = compact.compact_live(lo, hi, n, size, dedup=False)
        want = compact.compact_live_plain(lo, hi, n, size, dedup=False)
        torch.cuda.synchronize()
        kept_err = max(int((a.long() - b.long()).abs().max())
                       for a, b in zip(kept, want))
        check(kept_err == 0 and int((kept[0] != n).sum()) == live,
              f"compact_live(dedup=False) at live share {share:g} "
              f"disagrees with its plain version")
        del kept
        packed = (lo.long() << 32) | hi.long()

        def library():
            u = torch.unique(packed)
            return u[(u >> 32) != n]

        def kernel():
            return compact.compact_live(lo, hi, n, size)

        rec = {"case": f"live{share:g}", "C": C, "T": n + 1, "live": live,
               "distinct": int(library().numel()), "size": size,
               "max_abs_err": err, "kept_dups_max_abs_err": kept_err,
               "kept_dups_ms": gs.time_ms(
                   lambda: compact.compact_live(lo, hi, n, size,
                                                dedup=False)),
               "ms": gs.time_ms(kernel),
               "device": device_launches(kernel, f"compact_live {share:g}",
                                         [COOPERATIVE]),
               "plain_ms": gs.time_ms(
                   lambda: compact.compact_live_plain(lo, hi, n, size),
                   iters=5, prefill=False),
               "library_ms": gs.time_ms(library, iters=5, prefill=False),
               "bound_ms": gs.bound_ms(4 * C + 32 * sectors(
                   torch.nonzero(lo != n).flatten()) + 8 * size),
               "bound_by": "bytes", "card": card}
        rec["device_launches"] = len(rec["device"]["api"])
        print("compact_live " + json.dumps(rec), flush=True)
        records.append(rec)
    del lo, hi, packed, got, want
    for name, c in kernel_cases.compact_cases():
        lo, hi = torch.from_numpy(c["lo"]), torch.from_numpy(c["hi"])
        want = compact.compact_live_plain(lo, hi, c["n"], c["size"])
        got = compact.compact_live(lo.to(dev), hi.to(dev), c["n"], c["size"])
        check(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
              f"compact_live case {name} disagrees with its plain version")
        want = compact.compact_live_plain(lo, hi, c["n"], c["size"],
                                          dedup=False)
        got = compact.compact_live(lo.to(dev), hi.to(dev), c["n"], c["size"],
                                   dedup=False)
        check(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
              f"compact_live case {name} (dedup=False) disagrees with its "
              f"plain version")
    print(f"compact-edges {len(kernel_cases.compact_cases())} cases equal to "
          f"the plain version, duplicates dropped and kept", flush=True)
    return records


def chain_floor(C: int = 1 << 14, T: int = (1 << 22) + 1,
                steps: int = 4096):
    """The yardsticks of ``climb_jumps``' chain on the card
    (``gather_smoke.chase_yardsticks``): the launch floor (an empty kernel
    on ``climb_jumps``' grid, C slots a thread each in blocks of 256) and
    the latency of one dependent load (a chase of ``steps`` loads, one
    thread, over a random cycle through T entries, warm in L2)."""
    from sheep_tpu_torch.tools import gather_smoke as gs

    return gs.chase_yardsticks(-(-C // 256), T, steps)


def jump_climbs(card, n: int = 1 << 22, C: int = 1 << 14, jumps: int = 16,
                chain: int = 4096):
    """Phase 3e: ``climb_jumps`` (``climb_tail``'s jump mode) against its
    plain version on the card, exactly (outputs and the control word), at
    the small buffer's width (C' = 2^14 slots, 90% live, T = 2^22+1) on a
    chain forest (P[p] = p + 1, every ``chain``-th position a root), after
    the round's scatter; the slots' hi 1-48 positions above lo, so that
    climbing slots take up to ``jumps`` steps, and 1-3 above, so that most
    chains end within two. Each timed beside its plain version, with its
    bytes bound (lo in and two outputs back, 12 B a slot, hi at the live
    slots, old_at_lo at the retiring ones, and each distinct sector of P
    that the steps read) and its chain bound: the launch floor and the
    longest chain's dependent loads (lo, P[lo], and each step loaded up to
    the first that does not move) at the load latency (``chain_floor``).
    Returns the records, the 1-48 case first."""
    import torch

    from sheep_tpu_torch.ops import fixpoint, lift
    from sheep_tpu_torch.tools import gather_smoke as gs

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(37)
    p = torch.arange(n, device=dev)
    P0 = torch.where(p % chain == chain - 1, n, p + 1)
    P0 = torch.cat([P0, torch.tensor([n], device=dev)]).int()
    yard = chain_floor(C, n + 1)
    records = []
    for reach in (48, 3):
        lo = torch.randint(0, n - 64, (C,), device=dev, generator=g)
        hi = lo + torch.randint(1, reach + 1, (C,), device=dev, generator=g)
        dead = torch.rand(C, device=dev, generator=g) >= 0.9
        lo[dead] = n
        hi[dead] = n
        lo, hi = lo.int(), hi.int()
        old = P0[lo.long()]
        P = P0.clone()
        fixpoint.scatter_min_plain(P, lo, hi)
        want = lift.climb_tail_plain(lo, hi, old, P, None, 1, jumps=jumps)
        ctl = lift.new_ctl(dev)
        got = lift.climb_tail(lo, hi, old, P, None, ctl, jumps=jumps)
        torch.cuda.synchronize()
        err = max(int((got[0].long() - want[0].long()).abs().max()),
                  int((got[1].long() - want[1].long()).abs().max()))
        want_ctl = [0, int(want[2]), int(want[3]), int(want[4]), 0]
        check(err == 0 and ctl.tolist() == want_ctl,
              f"climb_jumps (hi up to {reach} above lo) disagrees with its "
              f"plain version (error {err}, ctl {ctl.tolist()} != "
              f"{want_ctl})")
        # the P entries the round reads: P[lo] at the live slots, then
        # each step of the climbing ones up to the first that does not
        # move
        live = lo != n
        now = P[lo.long()]
        climbing = live & (hi != now)
        reads, cur = [lo[live]], lo[climbing]
        h = hi[climbing]
        going = torch.ones_like(cur, dtype=torch.bool)
        loads = torch.zeros_like(cur)
        for _ in range(jumps):
            reads.append(cur[going])
            loads += going.int()
            cand = P[cur.long()]
            going = going & (cand < h)
            cur = torch.where(going, cand, cur)
        retiring = int((live & ~climbing).sum())
        chain_loads = 2 + (int(loads.max()) if loads.numel() else 0)
        rec = {"case": f"chain{chain}-reach{reach}-jumps{jumps}", "C": C,
               "T": n + 1, "live": int(live.sum()), "retiring": retiring,
               "steps_loaded_mean": float(loads.float().mean())
               if loads.numel() else 0.0,
               "chain_loads": chain_loads, "max_abs_err": err,
               "ms": gs.time_ms(lambda: lift.climb_tail(
                   lo, hi, old, P, None, ctl, jumps=jumps)),
               "plain_ms": gs.time_ms(lambda: lift.climb_tail_plain(
                   lo, hi, old, P, None, 1, jumps=jumps), iters=5),
               "bound_ms": gs.bound_ms(
                   12 * C + 4 * int(live.sum()) + 4 * retiring
                   + 32 * sectors(torch.cat(reads).long())),
               "bound_by": "bytes",
               "chain_bound_ms": yard["floor_ms"]
               + chain_loads * yard["load_latency_ms"],
               **yard, "library_ms": None, "card": card}
        print("climb_jumps " + json.dumps(rec), flush=True)
        records.append(rec)
    return records


SEGMENT_COUNTERS = ("warm_segments", "full_segments", "small_segments",
                    "stack_rebuilds", "compactions", "host_tails",
                    "host_tail_live", "host_syncs", "device_rounds",
                    "carried_tails", "carried_live", "overlap_tails")


def per_segment(card, counters):
    """Phase 4d: the per-segment driver on the card against the port on
    the CPU, rmat-hash:16:16:7, k=64, chunk 2^17, dispatch batch 1, depth
    1, the host tail at 4096 live pairs on both: with ``stale_reuse`` 1
    and 2, with ``carry_tail`` and with ``tail_overlap``, forest,
    assignment, scores and every segment and compaction counter equal,
    the path's kernels launched; then the adaptive fold of one chunk with
    no host tail (``host_tail=False``), so that its tail runs as jump-mode
    segments (``climb_jumps``): table, rounds and counters equal. Returns
    the launches of that fold."""
    import torch

    import sheep_tpu_torch
    from sheep_tpu_torch.io import generators
    from sheep_tpu_torch.ops import degrees, elim, order

    spec16, cs = "rmat-hash:16:16:7", 1 << 17
    base = dict(chunk_edges=cs, dispatch_batch=1, inflight=1,
                host_tail_threshold=1 << 12, keep_tree=True)

    def counted(fn):
        for c in counters:
            c.reset_launches()
        out = fn()
        return out, {k: v for c in counters for k, v in c.LAUNCHES.items()}

    def same_counts(a, b, what):
        for key in SEGMENT_COUNTERS:
            check(a.get(key) == b.get(key),
                  f"{what}: {key} {a.get(key)} != {b.get(key)}")

    drain = elim.TailOverlap.drain
    for name, extra in (("stale_reuse1", {}),
                        ("stale_reuse2", dict(stale_reuse=2)),
                        ("carry_tail", dict(carry_tail=True)),
                        ("tail_overlap", dict(tail_overlap=True))):
        # which fold a tail resolved by the worker thread joins depends on
        # whether the worker has finished when the next chunk starts (the
        # reference's drain without waiting), and so do the rounds; here
        # every drain waits, on both devices, so that the two runs fold
        # the same pairs in the same order
        if name == "tail_overlap":
            elim.TailOverlap.drain = lambda self, block: drain(self, True)
        try:
            t0 = time.perf_counter()
            on_gpu, launches = counted(lambda: sheep_tpu_torch.partition(
                spec16, 64, device="cuda", **base, **extra))
            t_gpu = time.perf_counter() - t0
            on_cpu = sheep_tpu_torch.partition(spec16, 64, device="cpu",
                                               **base, **extra)
        finally:
            elim.TailOverlap.drain = drain
        what = f"{spec16} per segment, {name}"
        same_result(on_gpu, on_cpu, what)
        same_counts(on_gpu.diagnostics, on_cpu.diagnostics, what)
        dg = on_gpu.diagnostics
        need = ["gather_clip", "scatter_min", "climb_tail", "stream_descent",
                "lift_stack"]
        need += ["climb_jumps"] if dg.get("small_segments") else []
        need += ["compact_live"] if dg.get("compactions") or \
            dg.get("host_tails") or dg.get("carried_tails") else []
        for kernel in need:
            check(launches[kernel] > 0, f"{what}: no {kernel} launch")
        print("per-segment " + json.dumps({
            "case": name, "spec": spec16, "k": 64, "edge_cut":
            on_gpu.edge_cut, **{k: dg[k] for k in SEGMENT_COUNTERS
                                if k in dg},
            "launches": {k: launches[k] for k in need}, "cuda_s": t_gpu,
            "card": card}), flush=True)

    # the ops-level fold of one chunk, its tail in jump mode
    cpu = torch.device("cpu")
    n = 1 << 16
    e = torch.from_numpy(generators.rmat_hash_range(16, 0, cs, seed=7)).int()
    deg = degrees.init_degrees(n, cpu)
    degrees.degree_chunk(deg, e, n)
    pos, _ = order.elimination_order(deg, n)
    lo, hi = elim.orient_edges_pos(e, pos, n)
    runs = []
    for dev in ("cuda", "cpu"):
        stats: dict = {}
        (P, rounds), launches = counted(lambda: elim.fold_edges_adaptive_pos(
            torch.full((n + 1,), n, dtype=torch.int32, device=dev),
            lo.clone().to(dev), hi.clone().to(dev), n, host_tail=False,
            warm_schedule=((1, 8),), stats=stats))
        runs.append((P.cpu(), rounds, stats, launches))
    (gP, gr, gs_, gl), (cP, cr, cs_, _) = runs
    check(torch.equal(gP, cP) and gr == cr,
          "the jump-mode fold's table or rounds differ on the card")
    same_counts(gs_, cs_, "the jump-mode fold")
    check(gs_.get("small_segments", 0) > 0 and gl["climb_jumps"] > 0 and
          gl["compact_live"] > 0,
          f"the jump-mode fold ran no small segment on the card: {gs_}")
    print("per-segment-jumps " + json.dumps({
        "n": n, "C": cs, "rounds": gr, **{k: gs_[k] for k in
                                          SEGMENT_COUNTERS if k in gs_},
        "launches": {k: gl[k] for k in ("climb_jumps", "compact_live",
                                        "stream_descent", "lift_stack",
                                        "climb_tail")},
        "card": card}), flush=True)
    return gl


# SASS of hash_chunk: "/*0230*/  ULDC UR6, c[0x0][UR5+0x210] ;"
_SASS_LINE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRANCH = re.compile(r"\bBRA\s+(0x[0-9a-f]+)")


def sass_row_ops(lib_path: str) -> dict:
    """The SASS instructions a row of ``hash_chunk`` executes, by mode, from
    ``cuobjdump -sass`` of the built library: {mode: (straight, loop,
    sentinel)}, where a row of the chunk's edges executes ``straight``
    instructions (through the first unpredicated EXIT, predicated ones
    included) plus ``loop`` more for each level past the first (the
    rolled level loop, the one backward branch; 0 in SBM mode), and a
    sentinel row ``sentinel`` (through its predicated EXIT)."""
    from sheep_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                         text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr}")
    funcs, cur = {}, None
    for line in out.stdout.splitlines():
        if "Function : " in line:
            cur = line.split("Function : ")[1].strip()
            funcs[cur] = []
            continue
        m = _SASS_LINE.match(line)
        if m and cur is not None:
            funcs[cur].append((int(m.group(1), 16), m.group(2).strip()))
    ops = {}
    for mode, tag in (("rmat", "ILi0E"), ("sbm", "ILi1E")):
        names = [f for f in funcs if "hash_chunk_kernel" in f and tag in f]
        check(len(names) == 1, f"hash_chunk<{mode}> not found in the SASS")
        instrs = funcs[names[0]]
        end = next(i for i, (_, t) in enumerate(instrs) if t == "EXIT")
        path = instrs[:end + 1]
        exits = [i for i, (_, t) in enumerate(path) if t.endswith(" EXIT")]
        loops = []
        for addr, text in path:
            m = _BRANCH.search(text)
            if m and int(m.group(1), 16) < addr:
                loops.append(sum(1 for a, _ in path
                                 if int(m.group(1), 16) <= a <= addr))
        check(len(loops) == (1 if mode == "rmat" else 0),
              f"hash_chunk<{mode}>: {len(loops)} loops in the SASS")
        ops[mode] = (len(path), loops[0] if loops else 0, exits[-1] + 1)
    return ops


def hash_chunks(card):
    """Phase 3f: ``hash_chunk`` (B12) against its plain version on the
    card, exactly: R-MAT at scale 22 (pad 2^23) at counter 0, at 2^32 -
    2^20 (the 64-bit carry) and with a ragged count (2^23 - 12,345); SBM
    at scale 22 with 64 blocks at p_out 0.05, with 2 blocks at p_out 1.0,
    and near-clique with clique bits 8 (2^14 blocks). Each timed beside
    its plain version (the int64 passes the main path ran before). The
    bound is the larger of the bytes (8 a row written, nothing read) over
    3.35 TB/s and the instructions the rows execute (``sass_row_ops``) over
    the instruction rate: one warp instruction a clock on each of an SM's four
    schedulers, at the SMs and the maximum SM clock the card reports."""
    import torch

    from sheep_tpu_torch.io import generators as g
    from sheep_tpu_torch.ops import _build, synth
    from sheep_tpu_torch.tools import gather_smoke as gs

    dev = torch.device("cuda")
    row_ops = sass_row_ops(_build.build_all(["synth"])["synth"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    clock_hz = float(smi.stdout.split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    instr_per_s = sms * 4 * 32 * clock_hz
    n, pad = 1 << 22, 1 << 23
    rk = g._rmat_hash_keys(22, 42)
    th = g._rmat_hash_thresholds(0.57, 0.19, 0.19)
    sk = g._sbm_hash_keys(42)
    carry = (1 << 32) - (1 << 20)
    cases = [("rmat-s22", synth.RMAT, 0, pad, rk, th),
             ("rmat-s22-carry", synth.RMAT, carry, pad, rk, th),
             ("rmat-s22-ragged", synth.RMAT, 5 * pad, pad - 12_345, rk, th),
             ("sbm-s22-b64", synth.SBM, 0, pad, sk,
              (g._sbm_t_out(0.05), 64, 16)),
             ("sbm-s22-b2-p1", synth.SBM, carry, pad, sk,
              (g._sbm_t_out(1.0), 2, 21)),
             ("nearclique-s22-c8", synth.SBM, 0, pad, sk,
              (g._sbm_t_out(0.02), 1 << 14, 8))]
    records = {}
    for name, mode, start, count, keys, params in cases:
        args = (mode, start, count, pad, n, keys, params, dev)
        got = synth.hash_chunk(*args)
        want = synth.hash_chunk_plain(*args)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        check(err == 0, f"hash_chunk {name} disagrees with its plain "
                        f"version")
        straight, loop, sentinel = row_ops["rmat" if mode == synth.RMAT
                                           else "sbm"]
        per_row = straight + loop * (len(keys) - 1)
        ops = count * per_row + (pad - count) * sentinel
        bytes_ms = gs.bound_ms(8 * pad)
        ops_ms = ops / instr_per_s * 1e3
        rec = {"case": name, "mode": "rmat" if mode == synth.RMAT else "sbm",
               "start": start, "count": count, "pad_to": pad,
               "levels": len(keys), "max_abs_err": err,
               "ms": gs.time_ms(lambda: synth.hash_chunk(*args)),
               "plain_ms": gs.time_ms(lambda: synth.hash_chunk_plain(*args),
                                      iters=5),
               "library_ms": None, "sass_ops_per_row": per_row,
               "ops": ops, "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms,
               "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "sms": sms, "clock_mhz": clock_hz / 1e6, "card": card}
        print("hash_chunk " + json.dumps(rec), flush=True)
        records[name] = rec
    return records


def write_csr(path: str, edges, n: int) -> None:
    """``edges`` as a ``.csr`` file of the JAX package's layout (the port
    reads it, and does not write it): edges grouped by source in a stable
    order, int32 destinations."""
    import numpy as np

    order = np.argsort(edges[:, 0], kind="stable")
    indptr = np.zeros(n + 1, dtype="<i8")
    np.cumsum(np.bincount(edges[:, 0], minlength=n), out=indptr[1:])
    with open(path, "wb") as f:
        f.write(struct.pack("<8sIIQQ", b"SHEEPCSR", 1, 0, n, len(edges)))
        f.write(indptr.tobytes())
        f.write(edges[order, 1].astype("<i4").tobytes())


PLANTED_SPECS = ("sbm-hash:16:16:0.05:16:7", "nearclique-hash:16:6:0.02:16:7",
                 "plsbm-hash:16:16:0.05:16:7", "bipartite-hash:16:8:0.02:16:7",
                 "rmat:16:16:7")


def planted_parity(card, counters):
    """Phase 4e: the new inputs, CUDA against the CPU at depth 2: the
    five specs of ``PLANTED_SPECS`` (chunk 2^17, dispatch batch 3): forest,
    assignment, scores and device rounds equal, the device-synthesized
    ones through ``hash_chunk``, the others through the H2D ring;
    ``partition_multi`` at k = 4, 16, 64 equal on both devices; a ``.csr``
    file and an ``.edges.gz`` of the same edges as a ``.bin32`` give its
    partition on the card."""
    import numpy as np

    import sheep_tpu_torch
    from sheep_tpu_torch.io import formats, generators
    from sheep_tpu_torch.ops import synth

    opts = dict(chunk_edges=1 << 17, dispatch_batch=3, keep_tree=True,
                inflight=2)
    for spec in PLANTED_SPECS:
        for c in counters:
            c.reset_launches()
        t0 = time.perf_counter()
        on_gpu = sheep_tpu_torch.partition(spec, 16, device="cuda", **opts)
        t_gpu = time.perf_counter() - t0
        synthesized = synth.LAUNCHES["hash_chunk"]
        on_cpu = sheep_tpu_torch.partition(spec, 16, device="cpu", **opts)
        same_result(on_gpu, on_cpu, f"{spec} cuda D=2, cpu D=2")
        dg = on_gpu.diagnostics
        device_synth = spec.startswith(("sbm-hash", "nearclique-hash"))
        check(synthesized > 0 if device_synth else
              synthesized == 0 and dg.get("h2d_staged_bytes", 0) > 0,
              f"{spec}: {synthesized} hash_chunk launches, "
              f"{dg.get('h2d_staged_bytes', 0):.0f} B staged")
        print("planted " + json.dumps({
            "spec": spec, "k": 16, "edge_cut": on_gpu.edge_cut,
            "total_edges": on_gpu.total_edges,
            "comm_volume": on_gpu.comm_volume,
            "device_rounds": dg["device_rounds"],
            "hash_chunk_launches": synthesized,
            "h2d_staged_bytes": dg.get("h2d_staged_bytes", 0),
            "cuda_s": t_gpu,
            "card": card}), flush=True)
    spec, ks = PLANTED_SPECS[0], [4, 16, 64]
    multi = [sheep_tpu_torch.partition_multi(spec, ks, device=dev,
                                             chunk_edges=1 << 17,
                                             dispatch_batch=3, inflight=2)
             for dev in ("cuda", "cpu")]
    for a, b in zip(*multi):
        # a further k is a re-split: no rounds of its own
        same_result(a, b, f"{spec} partition_multi k={a.k}",
                    rounds=a is multi[0][0])
    print("planted-multi " + json.dumps({
        "spec": spec, "ks": ks, "edge_cut": [r.edge_cut for r in multi[0]],
        "comm_volume": [r.comm_volume for r in multi[0]], "card": card}),
        flush=True)
    n = 1 << 14
    edges = generators.sbm_hash_range(14, 0, 16 << 14, 16, 0.05, seed=5)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {ext: os.path.join(tmp, f"sbm14{ext}")
                 for ext in (".bin32", ".edges.gz", ".csr")}
        formats.write_edges(paths[".bin32"], edges)
        formats.write_edges(paths[".edges.gz"], edges)
        write_csr(paths[".csr"], edges, n)
        opts = dict(chunk_edges=1 << 15, dispatch_batch=3, keep_tree=True,
                    inflight=2)
        ref = sheep_tpu_torch.partition(paths[".bin32"], 16, device="cuda",
                                        **opts)
        for ext in (".edges.gz", ".csr"):
            got = sheep_tpu_torch.partition(paths[ext], 16, device="cuda",
                                            **opts)
            # the .csr file regroups the edges by source: the same forest
            # and partition, other rounds
            same_result(got, ref, f"sbm14{ext} against .bin32",
                        rounds=ext != ".csr")
            check(np.array_equal(got.tree["deg"], ref.tree["deg"]),
                  f"sbm14{ext}: degrees differ")
    print(f"planted-files sbm14 k=16: .edges.gz == .csr == .bin32 on cuda "
          f"(edge_cut {ref.edge_cut})", flush=True)


# the runtime's call for a kernel whose blocks meet at grid barriers
COOPERATIVE = "cudaLaunchCooperativeKernel"


def device_launches(fn, what: str, want) -> dict:
    """The device work of one call of ``fn`` (after a warm-up call), by
    ``torch.profiler``: the CUDA runtime's launch, memset and copy calls
    (``api``), the witness, which must be ``want`` kernel launches (or the
    list of runtime calls ``want``) and nothing else, and the device's
    kernel records (``kernels``), which a process that has profiled before
    may have lost (PERF.md, section 7)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    rec = {"api": [e.name for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU and
                   re.match(r"cuda(Launch|Memset|Memcpy)", e.name)],
           "kernels": [e.name for e in events
                       if e.device_type == torch.autograd.DeviceType.CUDA]}
    if isinstance(want, int):
        want = ["cudaLaunchKernel"] * want
    check(rec["api"] == list(want),
          f"{what}: a call made the runtime calls {rec['api']}, not "
          f"{want}")
    return rec


def refine_edge_cases(dev) -> int:
    """``neighbor_hist`` (full and blocked) and ``hist_stats`` against
    their plain versions where their designs branch: k = 1, 3, 7, 64, 257;
    k = 40,000, a row past the apply's tile and the stats' ring; blocked
    at a base that does not start a bucket; row counts that leave a
    ragged last stats tile; a chunk of invalid edges only; a hub vertex
    that takes most updates; a histogram that starts off a 16-byte
    boundary. Then ``plan_moves`` on its case table
    (``kernel_cases.plan_cases``), with one scratch a shape, reused as
    the refinement reuses it. ``tests/test_torch_refine.py`` runs the same
    cases on a card. Returns the cases checked."""
    import numpy as np
    import torch

    from sheep_tpu_torch.ops import refine
    from sheep_tpu_torch.tools import kernel_cases

    rng = np.random.default_rng(5)
    scratch = refine.HistScratch(1 << 12, dev)

    def chunk_of(n, C, hub=False, invalid=False):
        e = rng.integers(0, n, (C, 2)).astype(np.int32)
        if hub:  # vertex 3 at one end of nine edges in ten
            e[rng.random(C) < 0.9, 0] = 3
        loops = rng.random(C) < 0.05
        e[loops, 1] = e[loops, 0]
        e[rng.random(C) < 0.02, 0] = n + 3
        e[rng.random(C) < 0.02, 1] = -1
        e[-C // 8:] = n
        if invalid:
            e[:, 1] = e[:, 0]
        return torch.from_numpy(e)

    cases = 0
    for n, k, C, base, vb, hub, invalid in (
            (3001, 1, 1 << 14, 0, None, False, False),
            (3001, 3, 1 << 14, 0, None, False, False),
            (3001, 7, 1 << 14, 0, None, False, False),
            (3001, 64, 1 << 14, 0, None, False, False),
            (3001, 257, 1 << 14, 0, None, False, False),
            (200, 40000, 1 << 12, 0, None, False, False),
            (20001, 64, 1 << 15, 777, 9000, False, False),
            (20001, 7, 1 << 15, 19999, 5, False, False),
            (3001, 8, 1 << 14, 0, None, True, False),
            (3001, 64, 1 << 14, 0, None, False, True)):
        assign = torch.from_numpy(rng.integers(0, k, n + 1).astype(np.int32))
        chunk = chunk_of(n, C, hub, invalid)
        rows = n + 1 if vb is None else vb
        want = torch.zeros((rows, k), dtype=torch.int32)
        got = torch.zeros((rows, k), dtype=torch.int32, device=dev)
        if vb is None:
            wc = torch.zeros(2, dtype=torch.int64)
            gc = torch.zeros(2, dtype=torch.int64, device=dev)
            for _ in range(2):
                refine.neighbor_hist_plain(want, chunk, assign, n, k,
                                           counts=wc)
                refine.neighbor_hist_chunk(got, chunk.to(dev),
                                           assign.to(dev), n, k, gc, scratch)
            check(torch.equal(gc.cpu(), wc), f"neighbor_hist counts at n={n} "
                                             f"k={k}")
            check(not invalid or (int(want.sum()) == 0
                                  and wc.tolist() == [0, 0]),
                  "neighbor_hist: a chunk of invalid edges added cells")
        else:
            for _ in range(2):
                refine.neighbor_hist_plain(want, chunk, assign, n, k, base,
                                           vb)
                refine.neighbor_hist_block(got, chunk.to(dev),
                                           assign.to(dev), base, n, k, vb,
                                           scratch)
        check(torch.equal(got.cpu(), want),
              f"neighbor_hist at n={n} k={k} base={base} vb={vb} hub={hub} "
              f"invalid={invalid} disagrees with its plain version")
        cases += 1
        cur = assign[base:base + rows] if vb is not None else assign
        cur = torch.cat([cur, torch.zeros(rows - len(cur), dtype=torch.int32)])
        # ties planted across 32-wide strides and at the row's ends
        hist = got.clone()
        hist[1::7, k - 1] = 9
        hist[1::7, (k - 1) // 2] = 9
        hist[2::9, 0] = 8
        hist[2::9, k - 1] = 8
        for r in (rows, rows - 1, rows - 2, rows - 3):
            a = refine.hist_stats(hist[:r], cur[:r].to(dev))
            b = refine.hist_stats_plain(hist[:r].cpu(), cur[:r])
            check(all(torch.equal(x.cpu(), y) for x, y in zip(a, b)),
                  f"hist_stats at rows={r} k={k} disagrees with its plain "
                  f"version")
            cases += 1
    # histograms that start off a 16-byte boundary: the dense apply's
    # scalar sweep, the stats' plain copies
    n, k = 3001, 8
    assign = torch.from_numpy(rng.integers(0, k, n + 1).astype(np.int32))
    chunk = chunk_of(n, 1 << 14)
    want = torch.zeros((n + 1, k), dtype=torch.int32)
    refine.neighbor_hist_plain(want, chunk, assign, n, k)
    got = torch.zeros((n + 1) * k + 1, dtype=torch.int32,
                      device=dev)[1:].view(n + 1, k)
    refine.neighbor_hist_chunk(got, chunk.to(dev), assign.to(dev), n, k,
                               scratch=scratch)
    check(torch.equal(got.cpu(), want), "neighbor_hist off a 16-byte "
                                        "boundary disagrees with its plain "
                                        "version")
    hist = torch.randint(0, 5, (4001 * 7 + 1,), device=dev,
                         dtype=torch.int32)[1:].view(4001, 7)
    cur = torch.randint(0, 7, (4001,), device=dev, dtype=torch.int32)
    a = refine.hist_stats(hist, cur)
    b = refine.hist_stats_plain(hist.cpu(), cur.cpu())
    check(all(torch.equal(x.cpu(), y) for x, y in zip(a, b)),
          "hist_stats off a 16-byte boundary disagrees with its plain "
          "version")
    plans = kernel_cases.plan_cases()
    scratches = {}
    for name, c in plans:
        args = [torch.from_numpy(c[x]) for x in ("best", "gain", "assign")]
        shape = (c["n"], c["k"])
        if shape not in scratches:
            scratches[shape] = refine.PlanScratch(*shape, dev)
        want = refine.plan_moves_plain(*args, c["cap"], c["parity"], *shape)
        for _ in range(2):
            got = refine.plan_moves(*(t.to(dev) for t in args), c["cap"],
                                    c["parity"], *shape, scratches[shape])
            check(torch.equal(got.cpu(), want),
                  f"plan_moves case {name} disagrees with its plain version")
    return cases + 2 + len(plans)


PLAN_BINS = 256  # the planner's count bins a part at k = 64


def plan_bytes(mover, n: int) -> int:
    """The least bytes of one ``plan_moves`` call: gain and the assignment
    read and the new assignment written (12 B a row), and the 32 B sectors
    of best that hold a mover (``mover``: a bool a row)."""
    import torch

    return 12 * (n + 1) + 32 * sectors(torch.nonzero(mover).flatten())


def rmat_hub_gains(scratch, n: int, k: int, g):
    """Planner inputs with R-MAT hub gains: the k-part histogram of the
    whole ``rmat-hash:22:16:42`` (16 chunks of 2^22 edges) under a random
    assignment, every vertex moved to its best part with no cap (one
    unconstrained step), and the histogram again: a hub whose one-edge
    neighbours followed its old part now gains thousands. Returns (best,
    gain, assignment) of ``hist_stats`` after that step."""
    import torch

    from sheep_tpu_torch.io.generators import RmatHashStream
    from sheep_tpu_torch.ops import refine

    dev = torch.device("cuda")
    stream = RmatHashStream(22, 16, seed=42)
    chunk_edges = 1 << 22
    assign = torch.randint(0, k, (n + 1,), device=dev, generator=g,
                           dtype=torch.int32)
    hist = torch.zeros((n + 1, k), dtype=torch.int32, device=dev)
    for step in (0, 1):
        if step:
            assign = stats[0].clone()
            assign[n] = 0
            hist.zero_()
        for i in range(-(-stream.num_edges_upper_bound // chunk_edges)):
            refine.neighbor_hist_chunk(
                hist, stream.device_chunk(i, chunk_edges, n, dev), assign,
                n, k, scratch=scratch)
        stats = refine.hist_stats(hist, assign)
    del hist
    torch.cuda.empty_cache()
    return stats[0], stats[3], assign


def overflow_cap(best, gain, assign, parity: int, n: int, k: int,
                 bins: int = PLAN_BINS):
    """The cap at which the most parts are split for the parity's movers
    (more movers than a head of at least one) with the head-th mover's
    gain in the planner's overflow bin (bins - 1 and up), the first such
    cap; and that number of parts ((None, 0) where no cap does)."""
    import torch

    vid = torch.arange(n + 1, device=best.device)
    mover = (gain > 0) & (vid < n) & (vid % 2 == parity)
    movers = torch.bincount(best[mover].long(), minlength=k)
    big = torch.bincount(best[mover & (gain >= bins - 1)].long(),
                         minlength=k)
    loads = torch.bincount(assign[:n].long(), minlength=k)
    top = torch.minimum(big, movers - 1)  # the heads split in overflow
    first, last = loads + 1, loads + top
    caps = first[top >= 1]
    if not len(caps):
        return None, 0
    parts = ((first[None, :] <= caps[:, None])
             & (caps[:, None] <= last[None, :])).sum(1)
    i = int(parts.argmax())
    return int(caps[i]), int(parts[i])


def refine_kernels(card):
    """Phase 3g: B11's kernels (``csrc/refine.cu``) against their plain
    versions on the card, exactly, at the s22 shapes. ``neighbor_hist`` on
    one 2^22-edge chunk of sbm-hash:22:64:0.05:16:42 and one of
    rmat-hash:22:16:42 (its last 4096 rows sentinel padding), a random
    assignment, at k = 8 and 64 (full, (2^22+1) rows, with the fused cut
    and total) and at k = 256 blocked with vb = 2^22 at base 0 and 2^22;
    then the SBM chunk under its planted partition at k = 64 and 8
    (``ground_truth(k)`` and the sentinel slot), a partition correlated
    with the graph as the refine passes of 5g meet it; ``hist_stats`` on
    (2^22+1, 64), (2^22, 256), (2^22, 7) and (2^22+1, 7) histograms of
    small counts (the last with a ragged final tile), with rows of zeros
    and ties planted across 32-wide strides; ``plan_moves`` at n = 2^22,
    k = 64, at both parities, on uniform gains in [-2, 40) with loads
    skewed so that the cap fills some parts and leaves others open, on
    the best parts and gains of ``hist_stats`` over the planted k = 64
    histogram under its partition (as 5g's refine passes meet them), and
    on R-MAT hub gains (``rmat_hub_gains``) at the cap that puts the most
    parts' thresholds in the count's overflow bin (``overflow_cap``), so
    that the gain digits are walked; then ``refine_edge_cases``. Each timed beside its plain version and a
    library yardstick (timed only): ``torch.bincount`` of the precomputed
    row * k + part keys, ``torch.max(dim=1)`` with ``torch.gather``, and
    ``torch.sort(stable)`` of the planner's 64-bit keys. The kernel
    launches a call are ``torch.profiler``'s runtime calls, four for
    ``neighbor_hist`` (count, scan, scatter, apply), one for
    ``hist_stats`` and one cooperative launch for ``plan_moves``; the run
    fails on any other count. Bounds by
    bytes: ``neighbor_hist`` 8 B an edge, one 32 B sector read and written
    back for each distinct histogram sector the edges touch, and the
    assignment once; ``hist_stats`` the histogram and the current parts
    read, four int32 outputs written; ``plan_moves`` gain and the
    assignment read and the new one written, 12 B a row, and the sectors
    of best that hold a mover (``plan_bytes``)."""
    import numpy as np
    import torch

    from sheep_tpu_torch.io.generators import RmatHashStream, SbmHashStream
    from sheep_tpu_torch.ops import refine
    from sheep_tpu_torch.tools import gather_smoke as gs

    dev = torch.device("cuda")
    n = C = 1 << 22
    g = torch.Generator(device=dev).manual_seed(17)
    records = {"neighbor_hist": [], "hist_stats": [], "plan_moves": []}
    sbm = SbmHashStream(22, 64, 0.05, 16, 42)
    scratch = refine.HistScratch(C, dev)
    for src, stream in (("sbm", sbm),
                        ("rmat", RmatHashStream(22, 16, seed=42))):
        chunk = stream.device_chunk(0, C, n, dev).clone()
        chunk[-4096:] = n
        cases = [(8, None, ""), (64, None, ""), (256, 0, ""),
                 (256, 1 << 22, "")]
        if src == "sbm":
            cases += [(64, None, "-planted"), (8, None, "-planted")]
        for k, base, kind in cases:
            if kind:
                assign = torch.from_numpy(np.concatenate(
                    [sbm.ground_truth(k), np.zeros(1, np.int32)])).to(dev)
            else:
                assign = torch.randint(0, k, (n + 1,), device=dev,
                                       generator=g, dtype=torch.int32)
            vb = None if base is None else 1 << 22
            rows = n + 1 if vb is None else vb
            hist = torch.zeros((rows, k), dtype=torch.int32, device=dev)
            want = torch.zeros_like(hist)
            counts = want_counts = None
            if vb is None:
                counts = torch.zeros(2, dtype=torch.int64, device=dev)
                want_counts = torch.zeros_like(counts)

                def kernel():
                    refine.neighbor_hist_chunk(hist, chunk, assign, n, k,
                                               counts, scratch)
            else:
                def kernel():
                    refine.neighbor_hist_block(hist, chunk, assign, base, n,
                                               k, vb, scratch)
            kernel()
            refine.neighbor_hist_plain(want, chunk, assign, n, k, base or 0,
                                       vb, want_counts)
            torch.cuda.synchronize()
            err = int((hist - want).abs().max())
            if counts is not None:
                err = max(err, int((counts - want_counts).abs().max()))
            name = f"{src}-k{k}" + ("" if vb is None else f"-base{base}") \
                + kind
            check(err == 0, f"neighbor_hist {name} disagrees with its plain "
                            f"version")
            del want
            # the cells the valid edges touch, as row * k + part keys
            u, v = chunk[:, 0].long(), chunk[:, 1].long()
            ok = (u < n) & (v < n) & (u != v)
            u, v = u[ok], v[ok]
            rows_all = torch.cat([u, v]) - (base or 0)
            cols = torch.cat([assign[v].long(), assign[u].long()])
            if vb is not None:
                keep = (rows_all >= 0) & (rows_all < vb)
                rows_all, cols = rows_all[keep], cols[keep]
            keys = rows_all * k + cols
            sectors = int(torch.unique(keys >> 3).numel())
            del u, v, ok, rows_all, cols
            plain_hist = torch.zeros_like(hist)
            rec = {"case": name, "C": C, "k": k, "rows": rows,
                   "valid": int(want_counts[1]) if vb is None else None,
                   "cells_added": int(keys.numel()), "sectors": sectors,
                   "max_abs_err": err, "ms": gs.time_ms(kernel),
                   "device": device_launches(kernel,
                                             f"neighbor_hist {name}", 4),
                   "plain_ms": gs.time_ms(
                       lambda: refine.neighbor_hist_plain(
                           plain_hist, chunk, assign, n, k, base or 0, vb),
                       iters=5),
                   "library_ms": gs.time_ms(
                       lambda: torch.bincount(keys, minlength=rows * k),
                       iters=5),
                   "bound_ms": gs.bound_ms(8 * C + 64 * sectors
                                           + 4 * (n + 1)),
                   "bound_by": "bytes", "card": card}
            rec["device_launches"] = len(rec["device"]["api"])
            if name == "sbm-k64-planted":
                # the planner's inputs as 5g's refine passes meet them
                stats = refine.hist_stats(hist, assign)
                planted = (stats[0], stats[3], assign)
                del stats
            del plain_hist, hist, keys
            torch.cuda.empty_cache()
            print("neighbor_hist " + json.dumps(rec), flush=True)
            records["neighbor_hist"].append(rec)
    hubs = rmat_hub_gains(scratch, n, 64, g)
    del scratch
    for rows, k in ((n + 1, 64), (n, 256), (n, 7), (n + 1, 7)):
        hist = torch.randint(0, 3, (rows, k), device=dev, generator=g,
                             dtype=torch.int32)
        hist[::7] = 0
        # a tie across two 32-wide strides (the first wins), and one at
        # the row's last column
        hist[1::11, min(31, k - 1)] = 9
        hist[1::11, k - 1] = 9
        hist[2::13, k - 1] = 8
        cur = torch.randint(0, k, (rows,), device=dev, generator=g,
                            dtype=torch.int32)
        got = refine.hist_stats(hist, cur)
        want = refine.hist_stats_plain(hist, cur)
        torch.cuda.synchronize()
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(got, want))
        name = f"rows{rows}-k{k}"
        check(err == 0, f"hist_stats {name} disagrees with its plain "
                        f"version")

        def library():
            mx = torch.max(hist, dim=1)
            return mx, hist.gather(1, cur.long()[:, None])

        rec = {"case": name, "rows": rows, "k": k, "max_abs_err": err,
               "ms": gs.time_ms(lambda: refine.hist_stats(hist, cur)),
               "device": device_launches(
                   lambda: refine.hist_stats(hist, cur), f"hist_stats {name}",
                   1),
               "plain_ms": gs.time_ms(
                   lambda: refine.hist_stats_plain(hist, cur), iters=5),
               "library_ms": gs.time_ms(library, iters=5),
               "bound_ms": gs.bound_ms(4 * rows * k + 4 * rows + 16 * rows),
               "bound_by": "bytes", "card": card}
        rec["device_launches"] = len(rec["device"]["api"])
        del hist, got, want
        torch.cuda.empty_cache()
        print("hist_stats " + json.dumps(rec), flush=True)
        records["hist_stats"].append(rec)
    k = 64
    # skewed loads: low parts above the cap, high parts open
    assign = torch.minimum(
        torch.randint(0, k, (n + 1,), device=dev, generator=g),
        torch.randint(0, k, (n + 1,), device=dev, generator=g)).int()
    best = torch.randint(0, k, (n + 1,), device=dev, generator=g,
                         dtype=torch.int32)
    gain = torch.randint(-2, 40, (n + 1,), device=dev, generator=g,
                         dtype=torch.int32)
    cap = int(1.10 * (-(-n // k)))
    loads = torch.bincount(assign[:n].long(), minlength=k)
    full_parts = int((loads >= cap).sum())
    check(0 < full_parts < k, f"plan_moves: {full_parts} of {k} parts at "
                              f"the cap")
    scratch = refine.PlanScratch(n, k, dev)
    vid = torch.arange(n + 1, device=dev)
    hub_caps = [overflow_cap(*hubs, parity, n, k) for parity in (0, 1)]
    check(sum(parts for _, parts in hub_caps) > 0,
          "plan_moves: no cap puts an R-MAT part's threshold in the count's "
          "overflow bin")
    for kind, (b_, g_, a_) in (("", (best, gain, assign)),
                               ("-planted", planted), ("-rmat-hubs", hubs)):
        a_loads = torch.bincount(a_[:n].long(), minlength=k)
        for parity in (0, 1):
            c_ = cap
            if kind == "-rmat-hubs":  # the other parity's, where none fits
                c_ = hub_caps[parity][0] or hub_caps[1 - parity][0]

            def kernel():
                return refine.plan_moves(b_, g_, a_, c_, parity, n, k,
                                         scratch)

            got = kernel()
            want = refine.plan_moves_plain(b_, g_, a_, c_, parity, n, k)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            name = f"n{n}-k{k}-parity{parity}{kind}"
            check(err == 0, f"plan_moves {name} disagrees with its plain "
                            f"version")
            moved = int((got != a_).sum())
            new_loads = torch.bincount(got[:n].long(), minlength=k)
            check((moved > 0 or kind) and bool(((new_loads <= c_) |
                                               (new_loads <= a_loads)).all()),
                  f"plan_moves {name}: no move, or a part grew past the cap")
            # the movers of each part against its head: the parts whose
            # movers the kernel had to select from, and those of them
            # whose head-th mover's gain lies in the count's overflow bin
            mover = (g_ > 0) & (vid < n) & (vid % 2 == parity)
            movers = torch.bincount(b_[mover].long(), minlength=k)
            big = torch.bincount(b_[mover & (g_ >= PLAN_BINS - 1)].long(),
                                 minlength=k)
            head = (c_ - a_loads).clamp(min=0)
            split = (movers > head) & (head > 0)
            # the library yardstick: the reference's lexsort as one stable
            # sort of 64-bit keys (part, then descending gain)
            keys = torch.where(mover, (b_.long() << 32)
                               | (2**31 - 1 - g_.long()), k << 32)[parity::2]
            rec = {"case": name, "n": n, "k": k, "cap": c_,
                   "parts_at_cap": int((a_loads >= c_).sum()),
                   "parts_selected": int(split.sum()),
                   "parts_overflow": int((split & (big >= head)).sum()),
                   "movers": int(mover.sum()), "moved": moved,
                   "max_abs_err": err, "ms": gs.time_ms(kernel),
                   "device": device_launches(kernel, f"plan_moves {name}",
                                             [COOPERATIVE]),
                   "plain_ms": gs.time_ms(lambda: refine.plan_moves_plain(
                       b_, g_, a_, c_, parity, n, k), iters=5),
                   "library_ms": gs.time_ms(
                       lambda: torch.sort(keys, stable=True), iters=5),
                   "bound_ms": gs.bound_ms(plan_bytes(mover, n)),
                   "bound_by": "bytes", "card": card}
            rec["device_launches"] = len(rec["device"]["api"])
            del keys
            print("plan_moves " + json.dumps(rec), flush=True)
            records["plan_moves"].append(rec)
    check(sum(r["parts_overflow"] for r in records["plan_moves"]
              if r["case"].endswith("-rmat-hubs")) > 0,
          "plan_moves: no R-MAT part's threshold in the overflow bin")
    del planted, hubs
    # the weighted planner, plain PyTorch on the card (no kernel of its
    # own): integer weights 1-3, whose float32 sums stay exact below 2^24,
    # against the same function on the CPU; bound: best, gain, assign and
    # w read, the assignment written, 20 B a row
    w = torch.randint(1, 4, (n + 1,), device=dev, generator=g).float()
    wcap = float(1.10 * float(w[:n].sum()) / k)
    got = refine.plan_moves_weighted(best, gain, assign, w, wcap, 0, n, k)
    want = refine.plan_moves_weighted(best.cpu(), gain.cpu(), assign.cpu(),
                                      w.cpu(), wcap, 0, n, k)
    err = int((got.cpu().long() - want.long()).abs().max())
    check(err == 0, "plan_moves_weighted on the card differs from the CPU")
    rec = {"case": f"n{n}-k{k}-weighted", "n": n, "k": k, "cap": wcap,
           "moved": int((got != assign).sum()), "max_abs_err": err,
           "ms": gs.time_ms(lambda: refine.plan_moves_weighted(
               best, gain, assign, w, wcap, 0, n, k), iters=5),
           "bound_ms": gs.bound_ms(20 * (n + 1)), "bound_by": "bytes",
           "card": card}
    print("plan_moves_weighted " + json.dumps(rec), flush=True)
    records["plan_moves_weighted"] = [rec]
    edges = refine_edge_cases(dev)
    print(f"refine-edges {edges} cases equal to the plain versions",
          flush=True)
    return records


def refine_parity(card, counters):
    """Phase 4f: refinement and the hierarchy, CUDA against the port's
    CPU run, at sbm-hash:16:16:0.05:16:1, k = 16 (chunk 2^17): flat
    ``partition(refine=4)`` (full histogram, spooled), and
    ``refine_assignment`` of its unrefined partition with 4 rounds blocked
    (a 1 MiB histogram budget, blocks of 2^14 rows), planned on the host
    (a 1 MiB plan budget) and with degree weights; then
    ``partition_hierarchical`` with [4, 4], balance 1.1 and a final
    refine of 2. Assignment, scores and every refine and hierarchy
    statistic equal."""
    import numpy as np

    import sheep_tpu_torch
    from sheep_tpu_torch.io.edgestream import open_input
    from sheep_tpu_torch.ops import refine

    spec, k = "sbm-hash:16:16:0.05:16:1", 16
    n = 1 << 16
    modes = {"blocked": dict(budget_bytes=1 << 20, min_block=1 << 14),
             "host_plan": dict(plan_budget_bytes=1 << 20),
             "weighted": {}}
    devices = ("cuda", "cpu")
    out = {}
    for dev in devices:
        for c in counters:
            c.reset_launches()
        t0 = time.perf_counter()
        flat = sheep_tpu_torch.partition(spec, k, device=dev,
                                          chunk_edges=1 << 17, refine=4)
        plain = sheep_tpu_torch.partition(spec, k, device=dev,
                                           chunk_edges=1 << 17)
        runs = {}
        with open_input(spec) as es:
            deg = np.zeros(n, np.int64)
            for c in es.chunks(1 << 22):
                deg += np.bincount(c.ravel(), minlength=n)[:n]
            for name, kw in modes.items():
                if name == "weighted":
                    kw = dict(weights=deg)
                runs[name] = refine.refine_assignment(
                    plain.assignment, es, n, k, rounds=4,
                    chunk_edges=1 << 17, device=dev, **kw)
        hier = sheep_tpu_torch.partition_hierarchical(
            spec, [4, 4], device=dev, balance=1.1, final_refine=2,
            chunk_edges=1 << 17)
        out[dev] = {"flat": flat, "runs": runs, "hier": hier,
                    "seconds": time.perf_counter() - t0,
                    "launches": dict(refine.LAUNCHES)}
    a, b = (out[d] for d in devices)
    what = f"{spec} k={k}"
    for key in ("edge_cut", "total_edges", "comm_volume", "balance"):
        check(getattr(a["flat"], key) == getattr(b["flat"], key),
              f"{what} refine=4: {key} differs")
        check(getattr(a["hier"], key) == getattr(b["hier"], key),
              f"{what} [4, 4]: {key} differs")
    check(np.array_equal(a["flat"].assignment, b["flat"].assignment),
          f"{what} refine=4: assignments differ")
    check(a["flat"].diagnostics["refine_spooled"] ==
          b["flat"].diagnostics["refine_spooled"],
          f"{what} refine=4: refine_spooled differs")
    for key in a["flat"].diagnostics:
        if key.startswith("refine_"):
            check(a["flat"].diagnostics[key] == b["flat"].diagnostics[key],
                  f"{what} refine=4: {key} differs")
    for name in modes:
        (ga, sa), (gb, sb) = a["runs"][name], b["runs"][name]
        check(np.array_equal(ga, gb) and sa == sb,
              f"{what} refine {name}: assignment or stats differ")
    check(a["runs"]["blocked"][1]["refine_hist_blocks"] > 1 and
          a["runs"]["host_plan"][1]["refine_host_plan"] == 1,
          f"{what}: the blocked or host-planned run was not")
    check(np.array_equal(a["hier"].assignment, b["hier"].assignment) and
          a["hier"].diagnostics == b["hier"].diagnostics,
          f"{what} [4, 4]: assignment or diagnostics differ")
    for name, launched in a["launches"].items():
        check(launched > 0, f"{what}: no {name} launch on CUDA")
    print("refine-parity " + json.dumps({
        "spec": spec, "k": k, "devices": list(devices),
        "flat": {key: getattr(a["flat"], key) for key in (
            "edge_cut", "total_edges", "comm_volume", "balance")},
        "flat_refine": {key: v for key, v in a["flat"].diagnostics.items()
                        if key.startswith("refine_")},
        "modes": {name: a["runs"][name][1] for name in modes},
        "hier": {"edge_cut": a["hier"].edge_cut,
                 "balance": a["hier"].balance,
                 "diagnostics": a["hier"].diagnostics},
        "seconds": {d: out[d]["seconds"] for d in devices},
        "launches": a["launches"], "card": card}), flush=True)


def hier_s22(card, counters):
    """Phase 5g: the port's CLI in-process, --input sbm-hash:22:64:0.05:16:42
    --k 64 --auto-recipe --json, on the card: the advisor must select
    [8, 8], a final refine of 10 and balance 1.05 with refine 8 a level;
    the result must equal the JAX package's (HIER22_*). Each call of the
    refinement is recorded (rows, k, seconds, passes, rounds, cuts), with
    each kernel's launches, the phase seconds and the peak device
    memory."""
    import io

    import torch

    from sheep_tpu_torch import cli
    from sheep_tpu_torch.ops import refine

    calls = []
    inner = refine.refine_assignment

    def recorded(assign, stream, n, k, **kw):
        before = refine.LAUNCHES["neighbor_hist"]
        chunks = -(-stream.num_edges_upper_bound //
                   stream.clamp_chunk_edges(kw.get("chunk_edges", 1 << 22)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, stats = inner(assign, stream, n, k, **kw)
        torch.cuda.synchronize()
        calls.append({"n": n, "k": k, "seconds": time.perf_counter() - t0,
                      "chunks_a_pass": chunks,
                      "passes": (refine.LAUNCHES["neighbor_hist"] - before)
                      / max(chunks, 1),
                      **{key[len("refine_"):]: stats[key] for key in stats}})
        return out, stats

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset_launches()
    out, err = io.StringIO(), io.StringIO()
    refine.refine_assignment = recorded
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(["--input", SBM22_SPEC, "--k", "64",
                           "--auto-recipe", "--json"])
    finally:
        refine.refine_assignment = inner
    wall = time.perf_counter() - t0
    launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    check(rc == 0, f"hier22: the CLI exited {rc}: {err.getvalue()[-2000:]}")
    check("recommended recipe: --k-levels 8,8 --final-refine 10 --balance "
          "1.05" in err.getvalue(),
          f"hier22: the advisor did not pick [8, 8] / 10 / 1.05: "
          f"{err.getvalue()[-2000:]}")
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    d = line["diagnostics"]
    check(line["backend"] == "torch:cuda+hier[8, 8]",
          f"hier22: backend {line['backend']}")
    got = (line["edge_cut"], line["total_edges"], line["balance"],
           line["comm_volume"])
    check(got == HIER22_SCORES, f"hier22: (cut, total, balance, cv) {got} "
                                f"!= JAX {HIER22_SCORES}")
    for key, want in HIER22_DIAGNOSTICS.items():
        check(d.get(key) == want, f"hier22: {key} {d.get(key)} != JAX "
                                  f"{want}")
    # refine 8 a level: level 0 at k = 8, eight level-1 parts; then the
    # final refine at k = 64, its rounds capped at 10
    check([c["k"] for c in calls] == [8] * 9 + [64],
          f"hier22: refinement calls at k {[c['k'] for c in calls]}")
    for name in refine.LAUNCHES:
        check(launches[name] > 0, f"hier22: no {name} launch")
    total = line["total_edges"]
    print("hier22 " + json.dumps({
        "argv": ["--input", SBM22_SPEC, "--k", "64", "--auto-recipe",
                 "--json"],
        "wall_s": wall, "phase_s": line["phase_times"],
        "edge_cut": line["edge_cut"], "cut_ratio": line["cut_ratio"],
        "cut_ratio_before_final_refine":
            d["refine_cut_before"] / max(total, 1),
        "cut_ratio_level0": d["cut_ratio_level0"],
        "cut_ratio_level1": d["cut_ratio_level1"],
        "balance": line["balance"], "comm_volume": line["comm_volume"],
        "refine_calls": calls,
        "refine_spooled": d.get("refine_spooled"),
        "launches": launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "card": card}), flush=True)
    return {"launches": launches, "calls": calls, "wall_s": wall,
            "phase_s": line["phase_times"]}


# recovery counters a fault leaves, which the CPU and the card must share
RECOVERY_KEYS = ("dispatch_retries", "spill_degrades",
                 "degraded_dispatch_batch", "degraded_inflight",
                 "degraded_h2d_ring", "device_loss_recoveries",
                 "device_rounds")
RESIDENCY_KEYS = ("spill_evictions", "spill_reloads", "spill_reload_bytes",
                  "spill_resident_bytes", "residency_hits",
                  "residency_boundary_evictions")


def _armed(env: dict):
    """A context that sets ``env`` (with the retry's backoff at 0) for
    one run, re-arms the fault injection and restores both after."""
    from sheep_tpu_torch.utils import fault

    @contextlib.contextmanager
    def ctx():
        full = {"SHEEP_RETRY_BASE_S": "0", **env}
        saved = {key: os.environ.get(key) for key in full}
        os.environ.update(full)
        fault.reset()
        try:
            yield
        finally:
            for key, value in saved.items():
                if value is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = value
            fault.reset()
    return ctx()


def _killed(run, point: str) -> None:
    """``run()`` under ``SHEEP_FAULT_INJECT=point``: it must raise the
    injected kill, and nothing else."""
    from sheep_tpu_torch.utils import fault

    fired = False
    with _armed({"SHEEP_FAULT_INJECT": point}):
        try:
            run()
        except fault.InjectedFault:
            fired = True
    check(fired, f"the injected kill at {point} did not fire")


def fault_parity(card):
    """Phase 4g: checkpoints, recovery and the residency tier, CUDA against
    the CPU at rmat-hash:16:16:7, k = 64, chunk 2^17 (8 chunks)."""
    import numpy as np
    import torch

    import sheep_tpu_torch
    from sheep_tpu_torch import hierarchy
    from sheep_tpu_torch.backends.torch_backend import TorchBackend
    from sheep_tpu_torch.io import formats, generators
    from sheep_tpu_torch.io.edgestream import open_input
    from sheep_tpu_torch.utils import checkpoint, fault, retry

    spec, k, cs = "rmat-hash:16:16:7", 64, 1 << 17
    drivers = {"batched": dict(dispatch_batch=2, inflight=2),
               "carry-tail": dict(dispatch_batch=1, inflight=1,
                                  carry_tail=True)}

    def run(device, opts, ck=None, resume=False, path=spec):
        with open_input(path) as s:
            return TorchBackend(device=device, chunk_edges=cs,
                                **opts).partition(
                s, k, checkpointer=ck, resume=resume, keep_tree=True)

    t0 = time.perf_counter()
    out = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        for name, opts in drivers.items():
            base = run("cuda", opts)
            for point in ("degrees:3", "build:5", "score:3"):
                dirs = {dev: os.path.join(tmp, f"{name}-{point}-{dev}")
                        for dev in ("cuda", "cpu")}
                for dev, d in dirs.items():
                    _killed(lambda: run(dev, opts,
                                        checkpoint.Checkpointer(d, every=2)),
                            point)
                got = {dev: checkpoint.Checkpointer(d).load()
                       for dev, d in dirs.items()}
                a, b = got["cuda"], got["cpu"]
                what = f"4g {name} killed at {point}"
                check(a is not None and a.phase == point.split(":")[0],
                      f"{what}: no checkpoint of the phase")
                check((a.phase, a.chunk_idx, a.meta) ==
                      (b.phase, b.chunk_idx, b.meta),
                      f"{what}: step or fingerprint differs on the CPU")
                check(sorted(a.arrays) == sorted(b.arrays) and all(
                    a.arrays[key].dtype == b.arrays[key].dtype and
                    np.array_equal(a.arrays[key], b.arrays[key])
                    for key in a.arrays), f"{what}: saved arrays differ")
                # the card resumes its own checkpoint and the CPU's
                for dev, d in dirs.items():
                    res = run("cuda", opts, checkpoint.Checkpointer(d),
                              resume=True)
                    same_result(res, base, f"{what}, resumed from the "
                                           f"{dev}'s step", rounds=False)
                out[f"{name} {point}"] = [a.phase, a.chunk_idx]
        # injected faults recovered in process, the same counters on both,
        # with the cache holding the whole stream on both (the CPU's is
        # off by default): out of memory spills it first
        opts = drivers["batched"]
        base = run("cuda", opts)
        stream_bytes = 8 * cs * 2 * 4
        for inject in ("oom@dispatch:2", "device@dispatch:2"):
            got = {}
            for dev in ("cuda", "cpu"):
                with _armed({"SHEEP_FAULT_INJECT": inject,
                             "SHEEP_CACHE_BYTES": str(stream_bytes)}):
                    got[dev] = run(dev, opts)
                same_result(got[dev], base, f"4g {inject} on {dev}",
                            rounds=False)
            a, b = (got[dev].diagnostics for dev in ("cuda", "cpu"))
            check(a.get("dispatch_retries", 0) >= 1,
                  f"4g {inject}: no retry")
            check(all(a.get(key) == b.get(key) for key in RECOVERY_KEYS),
                  f"4g {inject}: counters differ: "
                  f"{[(k, a.get(k), b.get(k)) for k in RECOVERY_KEYS]}")
            out[inject] = {key: a[key] for key in RECOVERY_KEYS if key in a}
        # which class a real out-of-memory error and an injected device
        # loss get on the card
        try:
            torch.empty(1 << 45, dtype=torch.uint8, device="cuda")
            real = None
        except torch.OutOfMemoryError as exc:
            real = (type(exc).__name__, retry.classify(exc))
        check(real is not None and real[1] == retry.RESOURCE,
              f"4g: a real out-of-memory error classifies as {real}")
        out["real_oom_class"] = real
        out["injected_device_loss_class"] = retry.classify(
            fault.InjectedDeviceLoss("x"))
        out["reinit_devices"] = retry.reinit_devices("cuda")
        check(out["reinit_devices"], "4g: the card did not answer the probe")
        # a quarter of the stream resident through a .bin32 file: the
        # same spill and reload counters on both, the partition unchanged
        path = os.path.join(tmp, "rmat16.bin32")
        formats.write_edges(path, generators.rmat_hash_range(16, 0, 16 << 16,
                                                             seed=7))
        quarter = stream_bytes // 4
        unconstrained = run("cuda", opts, path=path)
        got = {}
        for dev in ("cuda", "cpu"):
            with _armed({"SHEEP_CACHE_BYTES": str(quarter)}):
                got[dev] = run(dev, opts, path=path)
            same_result(got[dev], unconstrained, f"4g .bin32 under a quarter "
                                                 f"of the stream on {dev}")
        a, b = (got[dev].diagnostics for dev in ("cuda", "cpu"))
        check(a.get("spill_evictions", 0) > 0 and
              a.get("spill_reload_bytes", 0) > 0,
              "4g: the budget of a quarter spilled nothing")
        check(all(a.get(key) == b.get(key) for key in RESIDENCY_KEYS),
              f"4g: residency counters differ: "
              f"{[(key, a.get(key), b.get(key)) for key in RESIDENCY_KEYS]}")
        out["quarter_budget"] = {key: a[key] for key in RESIDENCY_KEYS
                                 if key in a}
        # the hierarchy killed after its second top-level part: resumed
        # from the level boundary, its spill shards reused
        hspec, kw = "sbm-hash:16:16:0.05:16:1", dict(refine=2,
                                                     chunk_edges=cs)
        whole = sheep_tpu_torch.partition_hierarchical(hspec, [4, 4],
                                                       device="cuda", **kw)
        ck = checkpoint.Checkpointer(os.path.join(tmp, "hier"), every=1)
        _killed(lambda: sheep_tpu_torch.partition_hierarchical(
            hspec, [4, 4], device="cuda", checkpointer=ck, **kw), "level:2")
        st = ck.load()
        check(st is not None and (st.phase, st.chunk_idx) == ("hier", 2),
              "4g hierarchy: no level-boundary step 2")
        spills = []
        spill = hierarchy._spill_intra
        hierarchy._spill_intra = \
            lambda *a, **kk: spills.append(1) or spill(*a, **kk)
        try:
            res = sheep_tpu_torch.partition_hierarchical(
                hspec, [4, 4], device="cuda", checkpointer=ck, resume=True,
                **kw)
        finally:
            hierarchy._spill_intra = spill
        check(not spills, "4g hierarchy: the resume spilled again")
        check(np.array_equal(res.assignment, whole.assignment) and all(
            getattr(res, key) == getattr(whole, key) for key in (
                "edge_cut", "total_edges", "comm_volume", "balance")),
              "4g hierarchy: the resumed result differs")
        check(os.listdir(ck.dir) == [], "4g hierarchy: left files behind")
    out["wall_s"] = time.perf_counter() - t0
    print("faults16 " + json.dumps(out), flush=True)


def _spec_bin32(spec: str, path: str, cs: int, dev: str = "cuda") -> int:
    """An rmat-hash spec as a .bin32 file (512 MiB at s22): its chunks of
    ``cs`` edges synthesized on the card by ``hash_chunk`` and written in
    order. Returns the number of chunks and of vertices (the file's
    highest id may fall short of the spec's)."""
    from sheep_tpu_torch.io.edgestream import open_input

    s = open_input(spec)
    with open(path, "wb") as f:
        for i in range(s.num_chunks(cs)):
            rows = min(cs, s.num_edges - i * cs)
            f.write(s.device_chunk(i, cs, s.num_vertices, dev)[:rows]
                    .cpu().numpy().astype("<u4").tobytes())
    return s.num_chunks(cs), s.num_vertices


def s22_real_oom(kw):
    """Phase 5h (b): a real out-of-memory error of the card under the
    degrade ladder. The limit (``torch.cuda.set_per_process_memory_fraction``)
    lies midway between the measured peaks of the auto dispatch (N = 16,
    D = 2: the 16 chunks one group) and of the rung that must fit (N = 8,
    D = 1), each measured here first with one chunk cached; the memory
    model's totals are printed beside them. Two runs under the limit:

    - ``default_budget``: the cache's budget from the card's memory, what a
      user gets. Each fault finds the cached chunks unleased, so each rung
      is a spill that halves a budget far above the 512 MiB in use, the
      next attempt caches the stream again, and the retries run out before
      a knob halves (ROADMAP Queue 3 item 8). The run either ends in that
      error (of class resource, after ``SHEEP_RETRY_MAX`` rungs that all
      spilled), which is recorded as the outcome, or fits and holds the
      JAX package's numbers; anything else fails the phase.
    - ``one_chunk``: ``SHEEP_CACHE_BYTES`` at one chunk (32 MiB), to show
      each rung: a spill, then the model halves D, then N. It must
      recover in process to the JAX package's numbers."""
    import gc

    import torch

    import sheep_tpu_torch
    from sheep_tpu_torch.utils import membudget, retry

    cs = kw["chunk_edges"]
    one_chunk = {"SHEEP_CACHE_BYTES": str(cs * 8)}
    check("SHEEP_CACHE_BYTES" not in os.environ,
          "s22 OOM: SHEEP_CACHE_BYTES is set; the default budget's run "
          "needs it unset")
    peaks = {}
    for batch, depth in ((0, 0), (8, 1)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with _armed(one_chunk):
            r = sheep_tpu_torch.partition(S22_SPEC, S22_K,
                                          dispatch_batch=batch,
                                          inflight=depth, **kw)
        s22_check(r, f"s22 N={batch} D={depth} unconstrained")
        d = r.diagnostics
        peaks[(int(d["dispatch_batch"]), int(d["inflight_depth"]))] = \
            torch.cuda.max_memory_allocated()
    (auto, auto_peak), (half, half_peak) = peaks.items()
    check(auto == (16, 2) and auto_peak > 1.1 * half_peak,
          f"s22 OOM: auto {auto} peaks {auto_peak} B, the halved one "
          f"{half_peak} B: no room for a limit between them")
    limit = (auto_peak + half_peak) // 2
    total = torch.cuda.mem_get_info()[1]
    model = {f"{b},{dd}": membudget.build_phase_bytes(
        1 << 22, cs, dispatch_batch=b, inflight=dd, donate=True)[
        "total_bytes"] for b, dd in (auto, half)}
    ladder = retry.degrade_dispatch

    def limited(env):
        rungs = []

        def recorded(n, chunk_edges, batch, inflight, donate, stats, *a,
                     **k):
            spills = stats.get("spill_degrades", 0)
            nxt = ladder(n, chunk_edges, batch, inflight, donate, stats, *a,
                         **k)
            rm = k.get("residency")
            rungs.append({"from": [batch, inflight],
                          "to": None if nxt is None else list(nxt[:2]),
                          "spill": stats.get("spill_degrades", 0) > spills,
                          "residency_budget": None if rm is None
                          else rm.budget})
            return nxt

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        retry.degrade_dispatch = recorded
        torch.cuda.set_per_process_memory_fraction(limit / total)
        res = error = None
        t0 = time.perf_counter()
        try:
            with _armed(env):
                res = sheep_tpu_torch.partition(S22_SPEC, S22_K, **kw)
        except Exception as exc:  # noqa: BLE001, judged by the caller
            # only its name and class: the exception's frames hold the
            # failed attempt's tensors
            error = {"type": type(exc).__name__,
                     "class": retry.classify(exc), "text": str(exc)[:300]}
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
            retry.degrade_dispatch = ladder
        run = {"wall_s": time.perf_counter() - t0, "rungs": rungs,
               "error": error,
               "peak_under_limit": torch.cuda.max_memory_allocated()}
        if res is not None:
            d = res.diagnostics
            run.update({k: d[k] for k in RECOVERY_KEYS if k in d})
            run.update(dispatch_batch=d["dispatch_batch"],
                       inflight=d["inflight_depth"],
                       phase_s=res.phase_times)
        gc.collect()
        torch.cuda.empty_cache()
        return res, run

    out = {"limit_bytes": limit, "fraction": limit / total,
           "peak_bytes": {f"{b},{dd}": p for (b, dd), p in peaks.items()},
           "model_bytes": model}
    res, run = limited({})
    if res is None:
        retries = retry.RetryPolicy().max_retries
        check(run["error"]["class"] == retry.RESOURCE
              and len(run["rungs"]) == retries
              and all(r["spill"] for r in run["rungs"]),
              f"s22 OOM at the default budget: not the ladder's known "
              f"fault (ROADMAP Queue 3 item 8): {run}")
        run["outcome"] = ("error: every rung spilled, the retries ran out "
                          "(ROADMAP Queue 3 item 8)")
    else:
        s22_check(res, "s22 at the default budget under the limit")
        run["outcome"] = "recovered"
    out["default_budget"] = run
    res, run = limited(one_chunk)
    check(res is not None, f"s22 OOM with one chunk cached: {run}")
    s22_check(res, "s22 recovered from a real OOM")
    check(run.get("dispatch_retries", 0) >= 1 and run["rungs"]
          and run["rungs"][0]["spill"] and run["dispatch_batch"] < auto[0],
          f"s22 OOM with one chunk cached: {run}")
    out["one_chunk"] = run
    print("s22-oom " + json.dumps(out), flush=True)
    return out


def s22_faults(card):
    """Phase 5h: rmat-hash:22:16:42, k = 64, chunk 2^22 (16 chunks): (a)
    killed at build:10 with a checkpoint every 4 chunks at N = 4, D = 2,
    then resumed; (b) a real out-of-memory error (:func:`s22_real_oom`);
    (c) a .bin32 of the graph with the default cache, with
    ``cache_chunks=False`` and with a 128 MiB budget. Every run holds the
    JAX package's cut, total and comm volume."""
    import torch

    import sheep_tpu_torch
    from sheep_tpu_torch.utils import checkpoint

    saves = []

    class Timed(checkpoint.Checkpointer):
        def save(self, phase, chunk_idx, arrays, meta=None):
            t0 = time.perf_counter()
            super().save(phase, chunk_idx, arrays, meta)
            saves.append({"phase": phase, "chunk": chunk_idx,
                          "seconds": time.perf_counter() - t0,
                          "npz_bytes": os.path.getsize(os.path.join(
                              self.dir, self._data_name(phase,
                                                        chunk_idx)))})

    cs = 1 << 22
    kw = dict(device="cuda", chunk_edges=cs)
    out = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) kill and resume
        ck = Timed(os.path.join(tmp, "ck"), every=4)
        opts = dict(dispatch_batch=4, inflight=2, **kw)
        t0 = time.perf_counter()
        _killed(lambda: sheep_tpu_torch.partition(
            S22_SPEC, S22_K, checkpointer=ck, **opts), "build:10")
        killed_s = time.perf_counter() - t0
        st = ck.load()
        check(st is not None and st.phase == "build" and st.chunk_idx > 0,
              f"s22 kill: resumes from {st and (st.phase, st.chunk_idx)}, "
              f"not a build step past chunk 0")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sheep_tpu_torch.partition(S22_SPEC, S22_K, checkpointer=ck,
                                        resume=True, **opts)
        resumed_s = time.perf_counter() - t0
        s22_check(res, "s22 resumed")
        out["kill"] = {"killed_at": "build:10", "every": 4,
                       "resumed_from": [st.phase, st.chunk_idx],
                       "saves": saves, "killed_run_s": killed_s,
                       "resumed_wall_s": resumed_s,
                       "resumed_phase_s": res.phase_times}
        out["oom"] = s22_real_oom(kw)
        # (c) the cache on a file: the degrees pass stages every chunk, the
        # build and the score read them from the card
        path = os.path.join(tmp, "rmat22.bin32")
        chunks, n = _spec_bin32(S22_SPEC, path, cs)
        chunk_bytes = cs * 8
        runs = {}
        for name, env, extra in (("cache", {}, {}),
                                 ("no_cache", {}, {"cache_chunks": False}),
                                 ("budget_128MiB",
                                  {"SHEEP_CACHE_BYTES": str(128 << 20)}, {})):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with _armed(env):
                r = sheep_tpu_torch.partition(path, S22_K, n_vertices=n,
                                              **kw, **extra)
            wall = time.perf_counter() - t0
            s22_check(r, f"s22 .bin32 {name}")
            d = r.diagnostics
            runs[name] = {"wall_s": wall, "phase_s": r.phase_times,
                          "h2d_staged_bytes": d.get("h2d_staged_bytes"),
                          **{key: d[key] for key in RESIDENCY_KEYS
                             if key in d},
                          "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        staged = {name: runs[name]["h2d_staged_bytes"] for name in runs}
        check(staged["cache"] == chunks * chunk_bytes,
              f"s22 .bin32 cached: {staged['cache']} B staged, not the "
              f"degrees pass's {chunks * chunk_bytes}")
        check(staged["no_cache"] == 3 * chunks * chunk_bytes,
              f"s22 .bin32 uncached: {staged['no_cache']} B staged")
        check(runs["budget_128MiB"].get("spill_evictions", 0) > 0 and
              runs["budget_128MiB"].get("spill_reload_bytes", 0) > 0 and
              runs["budget_128MiB"]["spill_resident_bytes"] <= 128 << 20,
              "s22 .bin32 at 128 MiB: no spill and reload")
        out["cache_runs"] = runs
    print("s22-faults " + json.dumps(out), flush=True)
    return out


# phase 5's build through the CLI (5i)
S22_CLI = ["--input", S22_SPEC, "--k", str(S22_K), "--chunk-edges",
           str(1 << 23), "--dispatch-batch", "8", "--inflight", "2",
           "--json"]
# the round's kernels as the profiler names them (5i)
ROUND_KERNELS = {"lift_stack": "lift_ladder", "gather_clip":
                 "gather_clip_kernel", "scatter_min": "scatter_min_kernel",
                 "climb_tail": "climb_tail_kernel"}


def _cli(args, timeout: int = 600) -> dict:
    """The port's CLI in a fresh process from the repo's root; its last
    stdout line, the JSON result."""
    root = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, "-m", "sheep_tpu_torch.cli", *args],
                       cwd=root, capture_output=True, text=True,
                       timeout=timeout)
    check(r.returncode == 0, f"cli {' '.join(args)}: exit {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def _span_tree(recs) -> dict:
    """The trace's spans by id, each with its children's ids."""
    spans = {}
    for r in recs:
        if r["event"] == "span_start":
            spans[r["id"]] = {"name": r["span"], "parent": r["parent"],
                              "end": None, "kids": []}
        elif r["event"] == "span_end":
            spans[r["id"]]["end"] = r
    for i, s in spans.items():
        if s["parent"] is not None:
            spans[s["parent"]]["kids"].append(i)
    return spans


def traced_s22(card, res, wall: float, peak: int) -> dict:
    """Phase 5i: phase 5's build traced. (a) In this process, at phase 5's
    settings, untraced, traced (``obs.tracing`` with a 0.25 s heartbeat),
    traced, untraced: build and wall seconds, each result phase 5's. (b)
    The port's CLI in a fresh process with --trace, --heartbeat-secs 0.25
    and --metrics-out: cut, comm volume, device rounds and host reads
    equal phase 5's (``res``); ``tools/trace_report.py --check`` passes;
    the span tree is run > partition > {degrees, sort, build > dispatch
    x (host reads + 1), split, score}, the dispatch spans' rounds sum to
    the device rounds; the last heartbeat is final, and its memory
    high-water at most the run's peak (--metrics-out's device_memory); the
    manifest's device and power limit are nvidia-smi's. (c) The CLI again
    with --profile-dir: the Chrome trace names the round's four kernels
    (the ladder, K1, scatter_min, climb_tail), their device ms summed."""
    import torch

    import sheep_tpu_torch
    from sheep_tpu_torch import obs

    d5 = res.diagnostics
    same = ("edge_cut", "comm_volume")
    out = {"untraced_wall_s": wall, "untraced_build_s":
           res.phase_times["build"], "untraced_peak_bytes": peak}
    # (a) in turns, in this process
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, traced in enumerate((False, True, True, False)):
            path = os.path.join(tmp, f"t{i}.jsonl")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (obs.tracing(path, heartbeat_secs=0.25,
                              device=torch.device("cuda")) if traced
                  else contextlib.nullcontext()):
                r = sheep_tpu_torch.partition(
                    S22_SPEC, S22_K, device="cuda", chunk_edges=1 << 23,
                    dispatch_batch=8)
            turn_wall = time.perf_counter() - t0
            for key in same:
                check(getattr(r, key) == getattr(res, key),
                      f"5i turn {i}: {key} differs from phase 5")
            for key in ("device_rounds", "host_syncs"):
                check(r.diagnostics[key] == d5[key],
                      f"5i turn {i}: {key} differs from phase 5")
            turns.append({"traced": traced, "wall_s": turn_wall,
                          "build_s": r.phase_times["build"]})
    out["turns"] = turns
    # (b) the CLI, traced, in a fresh process
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "t.jsonl")
        mpath = os.path.join(tmp, "m.jsonl")
        t0 = time.perf_counter()
        line = _cli(S22_CLI + ["--trace", trace, "--heartbeat-secs", "0.25",
                               "--metrics-out", mpath])
        out["cli_process_s"] = time.perf_counter() - t0
        dg = line["diagnostics"]
        for key in same:
            check(line[key] == getattr(res, key),
                  f"5i cli: {key} {line[key]} != phase 5's")
        for key in ("device_rounds", "host_syncs"):
            check(dg[key] == d5[key],
                  f"5i cli: {key} {dg[key]} != phase 5's {d5[key]}")
        root = os.path.dirname(os.path.abspath(__file__))
        rep = subprocess.run(
            [sys.executable, os.path.join(root, "tools", "trace_report.py"),
             "--check", trace], cwd=root, capture_output=True, text=True,
            timeout=300)
        check(rep.returncode == 0, f"5i: trace_report --check exit "
                                   f"{rep.returncode}: {rep.stderr[-2000:]}")
        with open(trace) as f:
            recs = [json.loads(x) for x in f]
        with open(mpath) as f:
            mrecs = [json.loads(x) for x in f]
    spans = _span_tree(recs)
    check(all(s["end"] is not None for s in spans.values()),
          "5i: a span was left open")
    names = lambda ids: [spans[i]["name"] for i in ids]  # noqa: E731
    roots = [i for i, s in spans.items() if s["parent"] is None]
    check(names(roots) == ["run"], f"5i: roots {names(roots)}")
    kids = spans[roots[0]]["kids"]
    check(names(kids) == ["partition"], f"5i: under run {names(kids)}")
    part = spans[kids[0]]["kids"]
    check(names(part) == ["degrees", "sort", "build", "split", "score"],
          f"5i: under partition {names(part)}")
    build = spans[part[2]]
    dispatch = [spans[i]["end"] for i in build["kids"]]
    check(dispatch and set(names(build["kids"])) == {"dispatch"},
          f"5i: under build {set(names(build['kids']))}")
    check(len(dispatch) == dg["host_syncs"] + 1,
          f"5i: {len(dispatch)} dispatch spans for {dg['host_syncs']} reads")
    rounds = sum(e.get("rounds", 0) for e in dispatch)
    check(rounds == dg["device_rounds"],
          f"5i: dispatch spans' rounds {rounds} != {dg['device_rounds']}")
    check(build["end"]["fixpoint_rounds"] == dg["device_rounds"],
          "5i: the build span's fixpoint_rounds")
    beats = [r for r in recs if r["event"] == "heartbeat"]
    check(beats and beats[-1].get("final") is True,
          "5i: no final heartbeat")
    mem = [b["memory"]["peak_bytes_in_use"] for b in beats if "memory" in b]
    run_peak = [r for r in mrecs if r["event"] == "device_memory"]
    check(mem and run_peak, "5i: no device memory in the heartbeats or the "
                            "metrics")
    run_peak = run_peak[0]["peak_bytes_in_use"]
    check(max(mem) <= run_peak, f"5i: heartbeat peak {max(mem)} over the "
                                f"run's {run_peak}")
    manifest = recs[0]
    check(manifest["event"] == "manifest", "5i: no manifest first")
    smi_name, smi_power = (x.strip() for x in card.rsplit(",", 1))
    dev = manifest["devices"][manifest.get("device_index", 0)]
    check(dev["name"] == smi_name and manifest["power_limit"] == smi_power,
          f"5i: manifest {dev['name']!r}, {manifest['power_limit']!r} "
          f"against nvidia-smi {card!r}")
    events = [r for r in recs if r["event"] not in
              ("span_start", "span_end", "heartbeat")]
    out.update({
        "cli_wall_s": line["wall_seconds"],
        "cli_build_s": line["phase_times"]["build"],
        "edge_cut": line["edge_cut"], "comm_volume": line["comm_volume"],
        "device_rounds": dg["device_rounds"], "host_syncs": dg["host_syncs"],
        "trace_report_check": rep.returncode, "spans": len(spans),
        "dispatch_spans": len(dispatch), "heartbeats": len(beats),
        "heartbeat_peak_bytes": max(mem), "run_peak_bytes": run_peak,
        "events": len(events),
        "event_names": sorted({r["event"] for r in events}),
        "manifest_device": dev["name"], "manifest_capability":
            dev["capability"], "manifest_power_limit":
            manifest["power_limit"]})
    # (c) the CLI under torch.profiler, in a fresh process: the cooperative
    # ladder's records survive there (PERF.md, section 7)
    with tempfile.TemporaryDirectory() as tmp:
        pdir = os.path.join(tmp, "prof")
        t0 = time.perf_counter()
        pline = _cli(S22_CLI + ["--profile-dir", pdir])
        out["profiled_process_s"] = time.perf_counter() - t0
        for key in same:
            check(pline[key] == getattr(res, key),
                  f"5i profiled: {key} differs from phase 5")
        traces = os.listdir(pdir)
        check(len(traces) == 1, f"5i profiled: {traces} in the directory")
        with open(os.path.join(pdir, traces[0])) as f:
            prof = json.load(f)["traceEvents"]
    kernel_us = {name: 0.0 for name in ROUND_KERNELS}
    kernel_n = {name: 0 for name in ROUND_KERNELS}
    for e in prof:
        if e.get("cat") != "kernel":
            continue
        for name, sym in ROUND_KERNELS.items():
            if sym in e.get("name", ""):
                kernel_us[name] += float(e.get("dur", 0.0))
                kernel_n[name] += 1
    for name in ROUND_KERNELS:
        check(kernel_n[name] > 0, f"5i profiled: no {ROUND_KERNELS[name]} "
                                  f"in the Chrome trace")
    out.update({"profiled_wall_s": pline["wall_seconds"],
                "profiled_build_s": pline["phase_times"]["build"],
                "profiled_kernel_ms": {k: v / 1e3
                                       for k, v in kernel_us.items()},
                "profiled_kernel_launches": kernel_n,
                "profiled_round_kernels_ms": sum(kernel_us.values()) / 1e3,
                "profile_events": len(prof), "card": card})
    print("s22-traced " + json.dumps(out), flush=True)
    return out


# 5j: the log's adds (epochs 1-4, a quarter of the spec's edges each) and
# epoch 6's, each an rmat-hash spec at the base's scale with one edge a
# vertex; epoch 5 tombstones n/16 base edges picked with DELTA_SEED
DELTA_ADDS, DELTA_MORE, DELTA_SEED = "rmat-hash:{}:1:7", "rmat-hash:{}:1:8", 13
# the kernels of the delta fold (the batched fixpoint's exact descent)
DELTA_KERNELS = ("gather_clip", "scatter_min", "lift_stack", "climb_tail",
                 "exec_finish")


def _spec_edges(spec: str, count: int, dev: str):
    """The first ``count`` edges of an rmat-hash spec as int64 host rows,
    made by ``hash_chunk`` on ``dev``."""
    from sheep_tpu_torch.io.edgestream import open_input

    s = open_input(spec)
    return s.device_chunk(0, count, s.num_vertices, dev)[:count].cpu() \
        .numpy().astype("int64")


def delta_log(base_path: str, log: str, scale: int, dev: str) -> dict:
    """Phase 5j's log over a .bin32 base, by the port's ``DeltaLogWriter``:
    epochs 1-4 add a quarter each of ``DELTA_ADDS`` at ``scale`` (2^scale
    edges), epoch 5 tombstones n/16 base edges picked with ``DELTA_SEED``,
    epoch 6 adds n/64 edges of ``DELTA_MORE``. Returns the arrays."""
    import numpy as np

    from sheep_tpu_torch.io.deltalog import DeltaLogWriter

    n = 1 << scale
    adds = _spec_edges(DELTA_ADDS.format(scale), n, dev)
    more = _spec_edges(DELTA_MORE.format(scale), n >> 6, dev)
    base = np.fromfile(base_path, "<u4").reshape(-1, 2).astype(np.int64)
    pick = np.random.default_rng(DELTA_SEED).choice(len(base), n >> 4,
                                                    replace=False)
    with DeltaLogWriter(log, base_spec=base_path) as w:
        for part in np.split(adds, 4):
            w.append(part)
        w.append_epoch(dels=base[pick])
        w.append(more)
    return {"base": base, "adds": adds, "pick": pick, "more": more}


def delta_replay(be, base_path: str, log: str, n: int, k: int,
                 counters=()) -> dict:
    """The log through the incremental path on ``be``'s device: the base
    build, epochs 1-4 unscored (each fold timed, its launches of
    ``counters`` and host reads counted), a refresh with the comm volume
    (the first full pass seeds the score cache: the survivor index's
    seconds and bytes), epoch 5 (the tombstones) scored under
    ``SHEEP_SCORE_AUDIT=1``, a full compaction and a refresh with the comm
    volume, epoch 6 scored under the audit. Returns each stage's result and
    table, and the timings."""
    import torch

    from sheep_tpu_torch import incremental as inc
    from sheep_tpu_torch.io.deltalog import DeltaLogReader
    from sheep_tpu_torch.io.edgestream import open_input

    cuda = be.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    seeded = {}

    class TimedIndex(inc._SurvivorIndex):
        def __init__(self, state):
            t0 = time.perf_counter()
            super().__init__(state)
            seeded["seconds"] = time.perf_counter() - t0
            seeded["bytes"] = os.path.getsize(self.path)

    out = {"stages": {}, "minp": {}}
    epochs = {ep: (a, d) for ep, a, d in DeltaLogReader(log).epochs()}
    t0 = time.perf_counter()
    state, base_res = inc.begin_incremental(open_input(base_path,
                                                       n_vertices=n), k,
                                            backend=be)
    out["begin_s"] = time.perf_counter() - t0
    out["begin_phase_s"] = base_res.phase_times
    for counter in counters:
        counter.reset_launches()
    folds = []
    for ep in (1, 2, 3, 4):
        syncs0 = state.stats.get("host_syncs", 0)
        rounds0 = state.stats.get("update_rounds", 0)
        sync()
        t0 = time.perf_counter()
        be.partition_update(state, adds=epochs[ep][0],
                            deletes=epochs[ep][1], epoch=ep, score=False)
        sync()
        folds.append({"epoch": ep, "edges": len(epochs[ep][0]),
                      "seconds": time.perf_counter() - t0,
                      "update_rounds": state.stats["update_rounds"] - rounds0,
                      # one stats read an execution, and the table's pull
                      "host_reads": state.stats["host_syncs"] - syncs0 + 1})
    out["folds"] = folds
    out["launches"] = {key: v for c in counters
                       for key, v in c.LAUNCHES.items()}
    index_cls, inc._SurvivorIndex = inc._SurvivorIndex, TimedIndex
    try:
        t0 = time.perf_counter()
        out["stages"]["epoch4"] = inc.refresh(be, state, comm_volume=True)
        out["refresh_s"] = time.perf_counter() - t0
    finally:
        inc._SurvivorIndex = index_cls
    out["index"] = dict(seeded)
    out["minp"]["epoch4"] = state.minp.copy()
    with _armed({"SHEEP_SCORE_AUDIT": "1"}):
        t0 = time.perf_counter()
        out["stages"]["epoch5"] = be.partition_update(
            state, adds=epochs[5][0], deletes=epochs[5][1], epoch=5,
            compact="never")
        out["epoch5_scored_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(inc.compact_state(be, state, mode="full") == "full",
          "5j: compaction did not run full")
    out["compact_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["stages"]["compacted"] = inc.refresh(be, state, comm_volume=True)
    out["compacted_refresh_s"] = time.perf_counter() - t0
    out["minp"]["compacted"] = state.minp.copy()
    with _armed({"SHEEP_SCORE_AUDIT": "1"}):
        rounds0 = state.stats["update_rounds"]
        t0 = time.perf_counter()
        out["stages"]["epoch6"] = be.partition_update(
            state, adds=epochs[6][0], epoch=6)
        out["epoch6_scored_s"] = time.perf_counter() - t0
        out["epoch6_rounds"] = state.stats["update_rounds"] - rounds0
    out["minp"]["epoch6"] = state.minp.copy()
    out["state"] = state
    return out


def _stage_line(res) -> dict:
    return {"edge_cut": res.edge_cut, "total_edges": res.total_edges,
            "comm_volume": res.comm_volume, "balance": res.balance}


def _tree_minp(res, n: int):
    import numpy as np

    from sheep_tpu_torch import incremental as inc

    return inc._minp_from_parent(res.tree["parent"],
                                 np.asarray(res.tree["pos"], "int64"), n)


def _same_stage(a, b, what: str) -> None:
    import numpy as np

    check(np.array_equal(a.assignment, b.assignment),
          f"{what}: assignments differ")
    for key in ("edge_cut", "total_edges", "comm_volume", "balance"):
        check(getattr(a, key) == getattr(b, key),
              f"{what}: {key} {getattr(a, key)} != {getattr(b, key)}")


def incremental_s22(card, counters, scale: int = 22,
                    dev: str = "cuda") -> dict:
    """Phase 5j (``s22-incremental``): incremental epochs on phase 5h(c)'s
    .bin32 of rmat-hash:22:16:42 at k = 64 (``delta_log``,
    ``delta_replay``): (a) epochs 1-4 and a refresh bit-identical to the
    one-shot ``partition("delta:LOG@4")`` (table, assignment, cut, total,
    comm volume); (b) epoch 5's tombstones and a full compaction equal to a
    clean build of the survivors; (c) epochs 5 and 6 scored under the
    audit; (d) at s16, the same replay on CUDA and on the CPU equal at
    every stage (:func:`incremental_s16`). ``scale`` and ``dev`` rehearse
    the phase on the CPU at a small scale (no launch is counted there)."""
    import numpy as np

    import sheep_tpu_torch
    from sheep_tpu_torch.backends.torch_backend import TorchBackend

    n, spec = 1 << scale, f"rmat-hash:{scale}:16:42"
    out = {"spec": spec, "k": S22_K, "card": card}
    with tempfile.TemporaryDirectory() as tmp:
        base_path = os.path.join(tmp, f"rmat{scale}.bin32")
        t0 = time.perf_counter()
        _spec_bin32(spec, base_path, 1 << 22, dev)
        log = os.path.join(tmp, "g.dlog")
        arrays = delta_log(base_path, log, scale, dev)
        out["inputs_s"] = time.perf_counter() - t0
        out["log_bytes"] = os.path.getsize(log)
        rep = delta_replay(TorchBackend(device=dev), base_path, log, n,
                           S22_K, counters)
        # (a) against the one-shot build of the log at epoch 4
        t0 = time.perf_counter()
        one = sheep_tpu_torch.partition(f"delta:{log}@4", S22_K,
                                        n_vertices=n, keep_tree=True,
                                        device=dev)
        one_s = time.perf_counter() - t0
        check(np.array_equal(rep["minp"]["epoch4"], _tree_minp(one, n)),
              "5j (a): the folded table differs from the one-shot build's")
        _same_stage(rep["stages"]["epoch4"], one, "5j (a) epoch 4")
        for name in DELTA_KERNELS:
            check(rep["launches"][name] > 0,
                  f"5j: no {name} launch on the delta path")
        # (b) against a clean build of the survivors: the base less the
        # tombstoned rows, and the adds
        keep = np.ones(len(arrays["base"]), bool)
        keep[arrays["pick"]] = False
        surv_path = os.path.join(tmp, "survivors.bin32")
        np.concatenate([arrays["base"][keep], arrays["adds"]]).astype(
            "<u4").tofile(surv_path)
        del keep
        t0 = time.perf_counter()
        clean = sheep_tpu_torch.partition(surv_path, S22_K, n_vertices=n,
                                          keep_tree=True, device=dev)
        clean_s = time.perf_counter() - t0
        os.remove(surv_path)
        check(np.array_equal(rep["minp"]["compacted"], _tree_minp(clean, n)),
              "5j (b): the compacted table differs from the clean build's")
        _same_stage(rep["stages"]["compacted"], clean, "5j (b) compacted")
        check(rep["stages"]["epoch5"].total_edges == clean.total_edges,
              "5j (c): epoch 5's stale score counts another multiset")
        state = rep.pop("state")
        out.update({
            "n_vertices": n, "base_edges": len(arrays["base"]),
            "epoch_adds": len(arrays["adds"]) // 4,
            "epoch5_tombstones": len(arrays["pick"]),
            "epoch6_adds": len(arrays["more"]),
            "begin_s": rep["begin_s"], "begin_phase_s": rep["begin_phase_s"],
            "folds": rep["folds"],
            "delta_launches": {name: rep["launches"][name]
                               for name in DELTA_KERNELS},
            "oneshot_s": one_s, "oneshot_phase_s": one.phase_times,
            "oneshot_device_rounds": one.diagnostics["device_rounds"],
            "refresh_s": rep["refresh_s"],
            "refresh_phase_s": rep["stages"]["epoch4"].phase_times,
            "index_seed_s": rep["index"].get("seconds"),
            "index_bytes": rep["index"].get("bytes"),
            "epoch5_scored_s": rep["epoch5_scored_s"],
            "compact_s": rep["compact_s"],
            "compacted_refresh_s": rep["compacted_refresh_s"],
            "clean_build_s": clean_s,
            "epoch6_scored_s": rep["epoch6_scored_s"],
            "epoch6_rounds": rep["epoch6_rounds"],
            "stages": {key: _stage_line(r)
                       for key, r in rep["stages"].items()},
            "score_full": state.stats.get("score_full"),
            "score_incremental": state.stats.get("score_incremental"),
            "update_rounds": state.stats["update_rounds"]})
        del state, rep, arrays, one, clean
    out["s16"] = incremental_s16(devs=(dev, "cpu"))
    print("s22-incremental " + json.dumps(out), flush=True)
    return out


def incremental_s16(scale: int = 16, devs=("cuda", "cpu")) -> dict:
    """Phase 5j (d): the replay of ``delta_replay`` at rmat-hash:16:16:42,
    k = 64, chunk 2^17, on CUDA and on the CPU: every stage's table,
    assignment and scores equal, and the folds' rounds and host reads."""
    import numpy as np

    from sheep_tpu_torch.backends.torch_backend import TorchBackend

    n, spec = 1 << scale, f"rmat-hash:{scale}:16:42"
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        base_path = os.path.join(tmp, f"rmat{scale}.bin32")
        _spec_bin32(spec, base_path, 1 << 17, devs[0])
        log = os.path.join(tmp, "g.dlog")
        delta_log(base_path, log, scale, devs[0])
        for dev in devs:
            t0 = time.perf_counter()
            runs.append(delta_replay(TorchBackend(device=dev,
                                                  chunk_edges=1 << 17),
                                     base_path, log, n, S22_K))
            runs[-1]["wall_s"] = time.perf_counter() - t0
    a, b = runs
    for key in a["minp"]:
        check(np.array_equal(a["minp"][key], b["minp"][key]),
              f"5j (d): the tables at {key} differ, CUDA against the CPU")
    for key in a["stages"]:
        _same_stage(a["stages"][key], b["stages"][key], f"5j (d) {key}")
    sa, sb = a["state"].stats, b["state"].stats
    for key in ("update_rounds", "host_syncs", "device_rounds",
                "score_full", "score_incremental"):
        check(sa.get(key) == sb.get(key),
              f"5j (d): {key} {sa.get(key)} != {sb.get(key)}")
    return {"spec": spec, "k": S22_K, "chunk_edges": 1 << 17,
            "wall_s": dict(zip(devs, (r["wall_s"] for r in runs))),
            "update_rounds": sa["update_rounds"],
            "host_syncs": sa["host_syncs"],
            "stages": {key: _stage_line(r) for key, r in a["stages"].items()}}


def lift_entries(head, cases, launches, forest) -> list:
    """The kernels-line entries of ``lift_stack`` and ``climb_tail``: each
    at ``head``, the phase 3c case at the main path's median depth and
    median live share, the other cases beside it (for ``lift_stack`` also
    the s22-forest case, ``forest``, with its stream floor); launches from
    the main path. ``lift_stack``'s times are of a ladder, one launch."""
    out = []
    for name, replaces, lib_key in (
            ("lift_stack", "sheep_tpu/ops/elim.py:295", "take_level_ms"),
            ("climb_tail", "sheep_tpu/ops/elim.py:128", None)):
        key = name.split("_")[0]
        out.append({
            "name": name, "route": "cuda",
            "source": "sheep_tpu_torch/csrc/lift.cu", "replaces": replaces,
            "also_replaces": ["sheep_tpu/ops/pallas_gather.py:70 (B1 in the "
                              + ("squaring)" if key == "lift" else
                                 "climb)")],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": head[f"{key}_ms"], "plain_ms": head[f"{key}_plain_ms"],
            "bound_ms": head[f"{key}_bound_ms"], "bound_by": "bytes",
            "library_ms": head[lib_key] if lib_key else None,
            "library_scope": "torch.take(t, t), one squaring level"
            if lib_key else None,
            "case": head["case"],
            "cases": {r["case"]: {"ms": r[f"{key}_ms"],
                                  "plain_ms": r[f"{key}_plain_ms"],
                                  "bound_ms": r[f"{key}_bound_ms"],
                                  "depth": r["depth"]}
                      for r in cases}})
    ladder = out[0]
    ladder["max_abs_err"] = max(ladder["max_abs_err"], forest["max_abs_err"])
    ladder["launches_a_ladder"] = len(forest["ladder_profile"]["api"])
    ladder["bound_scope"] = "P read once, t_1 .. t_{d-1} written: 4 T d bytes"
    ladder["cases"]["s22-forest"] = {
        k: forest[k] for k in ("lift_ms", "lift_plain_ms", "lift_bound_ms",
                               "take_level_ms", "floor_ms", "depth",
                               "levels_computed", "gather_bytes")}
    return out


def s24_build(card, counters) -> dict:
    """Phase 5k: ``partition("rmat-hash:24:16:42", 64)`` at the entry
    point's defaults (chunks made on the card), whose lifting stack (25
    levels of 2^24 + 1 entries, 1.68 GB) passes the table budget, so that
    every round takes the stream descent: the JAX package's cut, total
    and comm volume; no ``lift_stack`` launch and one ``stream_descent``
    launch a round enqueued, K1, ``scatter_min`` and ``climb_tail`` too;
    its seconds, rounds, executions, host reads, launches, peak memory,
    the rounds' live share and the depth of the forest's table (the
    plain ladder on ``forest_table``, as phase 5b); then ``stream_descent``
    on that table at the build's own shapes (L = 25, rows of C = 2^22
    slots, the median share and all live) exactly against its plain
    version, and the stream round on the same inputs (:func:`descents`)."""
    import statistics

    import torch

    import sheep_tpu_torch
    from sheep_tpu_torch.ops import lift

    n = 1 << 24
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset_launches()
    round_log: list = []
    t0 = time.perf_counter()
    res = sheep_tpu_torch.partition(S24_SPEC, 64, device="cuda",
                                    keep_tree=True, round_log=round_log)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    check(len(res.assignment) == n and int(res.assignment.min()) >= 0 and
          int(res.assignment.max()) < 64, "s24: bad parts")
    got = (res.edge_cut, res.total_edges, res.comm_volume)
    want = (S24_EDGE_CUT, S24_TOTAL_EDGES, S24_COMM_VOLUME)
    check(got == want, f"s24: (cut, total, cv) {got} != JAX {want}")
    d = res.diagnostics
    enqueued = int(d["rounds_enqueued"])
    check(launches["lift_stack"] == 0,
          f"s24: {launches['lift_stack']} lift_stack launches (exact "
          f"descent)")
    for name in ("stream_descent", "gather_clip", "scatter_min",
                 "climb_tail"):
        check(launches[name] == enqueued,
              f"s24: {name} {launches[name]} launches in {enqueued} rounds")
    check(d["host_syncs"] == d["batch_execs"],
          f"s24: {d['host_syncs']} host reads for {d['batch_execs']} "
          f"executions")
    rounds = int(d["device_rounds"])
    check(len(round_log) == rounds, "s24: the device round log missed rounds")
    slots = 1 << 22  # a round's row: one chunk
    P24 = forest_table(res, n)
    _, depth = lift.lift_stack_plain(P24, n.bit_length())
    share_med = statistics.median_low(r[1] for r in round_log) / slots
    rec = {"spec": S24_SPEC, "k": 64, "wall_s": wall,
           "build_s": res.phase_times["build"], "phase_s": res.phase_times,
           "edge_cut": res.edge_cut, "total_edges": res.total_edges,
           "comm_volume": res.comm_volume,
           "chunk_edges": 1 << 22, "dispatch_batch": d["dispatch_batch"],
           "inflight": d["inflight_depth"],
           "device_rounds": rounds, "rounds_enqueued": enqueued,
           "batch_execs": d["batch_execs"], "host_syncs": d["host_syncs"],
           "inflight_discards": d["inflight_discards"],
           "host_blocked_ms": d["host_blocked_ms"],
           "device_gap_ms": d["device_gap_ms"],
           "launches": launches, "peak_mem_bytes": peak,
           "live_share_median": share_med,
           "live_share_mean": d["live_sum"] / (rounds * slots),
           "depth_logged": d["depth_max"], "forest_depth": depth,
           "card": card}
    print("s24 " + json.dumps(rec), flush=True)
    rec["descents"] = descents(card, [
        (f"s24-forest-L25-live{share:.3g}", P24, n.bit_length(), share)
        for share in (share_med, 1.0)], C=slots)
    return rec


# 5l: the sharded build's runs, (label, dispatch batch, depth) on a mesh of
# SHARDS shards of the one card, and with more than one card visible on a
# mesh of every card, one shard a card
SHARDS = 4
SHARDED_RUNS = (("per-segment", 1, 1), ("batched", 4, 2))
# the kernels each sharded run must launch: every run the round's and the
# chunk synthesis; the per-segment fold also the warm segments' stream
# descent, the compactions and the jump-mode tail
SHARDED_PATH = ("gather_clip", "scatter_min", "lift_stack", "climb_tail",
                "exec_finish", "hash_chunk")
SHARDED_SEGMENT_PATH = ("stream_descent", "compact_live", "climb_jumps")


def sharded_s22(card, ref, counters) -> dict:
    """Phase 5l: phase 5's graph and k through the sharded build
    (``ShardedPipeline`` under ``TorchShardedBackend``) on a mesh of
    ``SHARDS`` shards of the one card (each shard's state on the card,
    the collectives device copies), per segment and batched, with
    ``dispatch_batch`` and ``inflight`` given (the auto rule sizes a card
    for one shard); then ``partition(..., backend="torch-sharded")`` on
    one shard at its defaults. With more than one card visible, also the
    same two runs on a mesh of every card, one shard a card (the
    collectives peer copies), and the entry point on every card at its
    defaults; each card must have held a shard's state. Each run's
    forest, assignment, cut, total, comm volume and balance must equal
    phase 5's (``ref``); its kernels' launches are counted from 0 around
    it. Returns {label: launches}."""
    import torch

    import sheep_tpu_torch
    from sheep_tpu_torch.backends.torch_sharded_backend import \
        TorchShardedBackend
    from sheep_tpu_torch.io.edgestream import open_input
    from sheep_tpu_torch.parallel.mesh import Mesh, shards_mesh

    def sharded(mesh, nb, depth):
        return lambda: TorchShardedBackend(
            mesh=mesh, dispatch_batch=nb, inflight=depth).partition(
                open_input(S22_SPEC), S22_K, keep_tree=True)

    one_card = Mesh([torch.device("cuda", 0)] * SHARDS)
    runs = [(label, one_card, sharded(one_card, nb, depth))
            for label, nb, depth in SHARDED_RUNS]
    runs.append(("public-d1", Mesh(["cuda:0"]),
                 lambda: sheep_tpu_torch.partition(
                     S22_SPEC, S22_K, backend="torch-sharded", n_devices=1,
                     keep_tree=True)))
    cards = torch.cuda.device_count()
    if cards > 1:
        every = shards_mesh()
        runs += [(f"cards{cards}-{label}", every, sharded(every, nb, depth))
                 for label, nb, depth in SHARDED_RUNS]
        runs.append((f"public-cards{cards}", every,
                     lambda: sheep_tpu_torch.partition(
                         S22_SPEC, S22_K, backend="torch-sharded",
                         keep_tree=True)))
    else:
        print("5l: one card visible: the layout of one shard a card runs "
              "with more than one (chip_smoke.py --sharded-cards)",
              flush=True)
    with open_input(S22_SPEC) as stream:
        chunks = stream.num_chunks(1 << 22)
    out = {}
    for label, mesh, run in runs:
        devices = mesh.distinct()
        for dev in devices:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        for c in counters:
            c.reset_launches()
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
        launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
        peaks = [torch.cuda.max_memory_allocated(dev) for dev in devices]
        what = f"s22 sharded {label}"
        same_result(res, ref, what, rounds=False)
        check(res.backend == "torch-sharded:cuda", f"{what}: backend "
                                                   f"{res.backend}")
        check(all(p > 0 for p in peaks),
              f"{what}: a card of the mesh held nothing ({peaks})")
        d = res.diagnostics
        path = SHARDED_PATH + (SHARDED_SEGMENT_PATH
                               if label.endswith("per-segment") else ())
        for name in path:
            check(launches[name] > 0, f"{what}: no {name} launch")
        # each pass synthesizes every chunk on its shard (no chunk cache)
        check(launches["hash_chunk"] == 3 * chunks,
              f"{what}: {launches['hash_chunk']} hash_chunk launches for "
              f"3 passes of {chunks} chunks")
        if d.get("batch_execs"):
            check(d["host_syncs"] == d["batch_execs"],
                  f"{what}: {d['host_syncs']} host reads for "
                  f"{d['batch_execs']} executions")
        rec = {"spec": S22_SPEC, "k": S22_K, "shards": len(mesh),
               "devices": [str(dev) for dev in devices],
               "dispatch_batch": d.get("dispatch_batch", 1),
               "inflight": d.get("inflight_depth", 1), "wall_s": wall,
               "phase_s": res.phase_times,
               "edges_per_s": res.total_edges / wall,
               "build_edges_per_s":
                   res.total_edges / res.phase_times["build+merge"],
               "edge_cut": res.edge_cut, "total_edges": res.total_edges,
               "comm_volume": res.comm_volume, "balance": res.balance,
               "merge_mode": d.get("merge_mode"),
               "merge_payload_bytes": d.get("merge_payload_bytes", 0),
               "device_rounds": d["device_rounds"],
               "host_syncs": d["host_syncs"],
               "batch_execs": d.get("batch_execs", 0),
               "inflight_discards": d.get("inflight_discards", 0),
               "host_blocked_ms": d.get("host_blocked_ms"),
               "launches": launches, "peak_mem_bytes": max(peaks),
               "peak_mem_bytes_by_device": peaks, "card": card}
        print("s22-sharded " + json.dumps(rec), flush=True)
        out[label] = launches
    return out


# 3h and 5m: the vertex-sharded build's routed round at bigv's s22 shapes:
# D shards on the one card, B rows a shard, Q requests a shard
BIGV_SHARDS = 4
BIGV_Q = 1 << 20
# 5m runs this graph on 4 shards of the card both ways: each round one
# CardRound, and each round through the collectives one card after
# another, the path of several cards; --sharded-cards runs it one shard a
# card, checked, after phase 5's graph for at most BIGV_CARDS_BUDGET_S:
# there the host's ~60 calls a routed lookup, card after card, bound the
# rounds so far below one card that s22's 16 batches do not fit a run
# (PERF.md section 5), so that run only reports its pace
BIGV_PATHS_SPEC = "rmat-hash:18:16:42"
BIGV_CARDS_BUDGET_S = 60.0
# the routed kernels of the path of several cards (and of the CPU), and
# of one card that holds every shard (CardRound: no owned_gather or
# routed_step in its rounds, but in the build's orient and score lookups)
BIGV_CARDS_KERNELS = ("owned_gather", "owned_scatter_min", "routed_step",
                      "routed_round_end")
BIGV_KERNELS = BIGV_CARDS_KERNELS + ("routed_climb", "routed_square")
BIGV_SOURCE = "sheep_tpu_torch/csrc/routed.cu"
# the JAX package's routed round (XLA under shard_map): the lookup's owner
# side, the scatter-min's, the requester's fold and round's end, the jump
# climb of the fold program and its routed squaring
BIGV_REPLACES = {"owned_gather": "sheep_tpu/parallel/bigv.py:150",
                 "owned_scatter_min": "sheep_tpu/parallel/bigv.py:164",
                 "routed_step": "sheep_tpu/parallel/bigv.py:161",
                 "routed_round_end": "sheep_tpu/parallel/bigv.py:263",
                 "routed_climb": "sheep_tpu/parallel/bigv.py:318",
                 "routed_square": "sheep_tpu/parallel/bigv.py:348"}
# the one PyTorch call that computes the same function, where there is one
# (the plain-min fold of the answers is ``torch.amin(dim=0)``, the
# squaring on one card ``torch.take(t, t)``)
BIGV_LIBRARY = {"routed_step": "torch.amin(rep, dim=0)",
                "routed_square": "torch.take(t.view(-1), t)"}
# the jumps of a tail round and the tail's width a shard (BigVPipeline's
# defaults), the levels of a lifting round at s22
BIGV_JUMPS = 128
BIGV_TAIL_Q = 1 << 13
BIGV_LEVELS = 23
# 5m's counters at s22 on 4 shards of the card, as recorded in PERF.md
# section 5 (the reference's cost model, so no redesign of a kernel may
# move them)
BIGV_S22_COUNTS = {"fixpoint_rounds": 14654, "host_syncs": 924,
                   "compactions": 64, "q_rounds": 285645824,
                   "collective_ops": 3699452,
                   "collective_bytes": 625095529472}


def _bigv_table(n: int, D: int, g):
    """Phase 3c's random position-space forest as a block-sharded (D, B)
    table, the rows past n the sentinel."""
    import torch

    B = -(-(n + 1) // D)
    t = torch.full((D * B,), n, dtype=torch.int32, device=g.device)
    t[:n + 1] = synthetic_forest(n, 0, g)
    return t.view(D, B)


def _bigv_requests(n: int, rows: int, D: int, W: int, share: float, g):
    """(D, W) requests: ``share`` of them uniform in [0, n), 1% of those
    past the table (>= rows), the rest at the sentinel row n."""
    import torch

    dev = g.device
    q = torch.randint(0, n, (D, W), device=dev, generator=g)
    q[torch.rand(D, W, device=dev, generator=g) < 0.01] = rows + 7
    q[torch.rand(D, W, device=dev, generator=g) >= share] = n
    return q.int()


def _exact(got, want, what: str) -> int:
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    check(err == 0, f"{what}: the kernel disagrees with its plain version")
    return err


def routed_kernels(card, n: int = 1 << 22, D: int = BIGV_SHARDS,
                   Q: int = BIGV_Q) -> dict:
    """Phase 3h: the routed round's kernels (``csrc/routed.cu``,
    ``ops/routed.py``) against their plain versions on the card, every
    output word equal, at bigv's s22 shapes (D shards on the card, n =
    2^22, B = ceil((n + 1) / D), Q requests a shard), one launch serving
    every shard: ``owned_gather`` at width Q with 100%, 10% and 1% of the
    requests live (the others at the sentinel row, 1% of the live ones
    past the table) and at the squaring width B (the table's own
    entries); ``owned_scatter_min`` with every request on one row (a
    star's hub) and on a random forest's slots; ``routed_step`` (the
    climb's rewrite, and the plain min of a squaring) and
    ``routed_round_end`` on the answers of those cases. Each timed beside
    its plain version (and the one library call where there is one), with
    its bytes bound: every input read once, every output written once,
    and the 32-byte table sectors the owned requests reach. Returns
    {kernel: [records]}."""
    import torch

    from sheep_tpu_torch.ops import routed
    from sheep_tpu_torch.tools import gather_smoke as gs

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(29)
    table = _bigv_table(n, D, g)
    B = table.shape[1]
    rows = D * B
    out = {name: [] for name in BIGV_KERNELS}

    def reached(q) -> int:
        ok = (q >= 0) & (q < rows)
        return 32 * sectors(q[ok].long())

    def record(kernel, case, err, ms, plain_ms, nbytes, **extra):
        rec = {"kernel": kernel, "case": case, "D": D, "B": B, "n": n,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "library_ms": extra.pop("library_ms", None),
               "library": BIGV_LIBRARY.get(kernel, "none"),
               "bound_ms": gs.bound_ms(nbytes), "bound_by": "bytes",
               "card": card, **extra}
        print("routed " + json.dumps(rec), flush=True)
        out[kernel].append(rec)
        return rec

    # owned_gather: lookups at width Q, the squaring at width B
    gathers = {}
    for case, q in [(f"Q-live{share:g}",
                     _bigv_requests(n, rows, D, Q, share, g))
                    for share in (1.0, 0.1, 0.01)] + [("B-square", table)]:
        got = routed.owned_gather(table, 0, q, n)
        want = routed.owned_answers_plain(table, 0, q, n)
        err = _exact(got, want, f"owned_gather {case}")
        W = q.shape[1]
        record("owned_gather", case, err,
               gs.time_ms(lambda: routed.owned_gather(table, 0, q, n)),
               gs.time_ms(lambda: routed.owned_answers_plain(table, 0, q, n),
                          iters=5),
               4 * D * W + 4 * D * D * W + reached(q), width=W,
               live=int((q < n).sum()))
        gathers[case] = (q, got)

    # owned_scatter_min: a star's hub, a random forest's slots
    hub = 12345
    star_lo = torch.full((D, Q), hub, dtype=torch.int32, device=dev)
    star_val = torch.randint(hub + 1, n + 1, (D, Q), device=dev,
                             generator=g, dtype=torch.int32)
    slots = [synthetic_slots(n, Q, 1.0, g) for _ in range(D)]
    f_lo = torch.stack([s[0] for s in slots])
    f_hi = torch.stack([s[1] for s in slots])
    scattered = {}
    for case, lo, val in (("star-hub", star_lo, star_val),
                          ("forest", f_lo, f_hi)):
        T, ref = table.clone(), table.clone()
        old, new = routed.owned_scatter_min(T, 0, lo, val, n)
        w_old, w_new = routed.owned_scatter_min_plain(ref, 0, lo, val, n)
        err = max(_exact(old, w_old, f"owned_scatter_min {case} old"),
                  _exact(new, w_new, f"owned_scatter_min {case} new"),
                  _exact(T, ref, f"owned_scatter_min {case} table"))
        live = val < n
        record("owned_scatter_min", case, err,
               inplace_ms(lambda: T.copy_(table), lambda: routed.
                          owned_scatter_min(T, 0, lo, val, n)),
               inplace_ms(lambda: ref.copy_(table), lambda: routed.
                          owned_scatter_min_plain(ref, 0, lo, val, n),
                          iters=3),
               4 * D * Q + 4 * int(live.sum()) + 2 * reached(lo)
               + 2 * 4 * D * D * Q, launches_a_call=3)
        scattered[case] = (lo, val, old, new)

    # routed_step: the climb's rewrite on the lookups' answers (owner
    # axis first: on one card the all-to-all's view is the answers
    # themselves), the plain min on the squaring's
    for case, (q, got) in gathers.items():
        W = q.shape[1]
        cur = q.clamp(0, n).contiguous()
        hi = (cur + 1 + torch.randint(0, 64, cur.shape, device=dev,
                                      generator=g, dtype=torch.int32)
              ).clamp(max=n)
        res = torch.empty_like(cur)
        squaring = case == "B-square"
        args = dict() if squaring else dict(hi=hi, cur=cur)
        routed.routed_step(got, res, **args)
        want, _ = routed.routed_step_plain(got, args.get("hi"),
                                           args.get("cur"))
        err = _exact(res, want, f"routed_step {case}")
        extra = {}
        if squaring:
            extra["library_ms"] = gs.time_ms(lambda: torch.amin(got, 0))
        record("routed_step", case, err,
               gs.time_ms(lambda: routed.routed_step(got, res, **args)),
               gs.time_ms(lambda: routed.routed_step_plain(
                   got, args.get("hi"), args.get("cur")), iters=5),
               4 * D * D * W + 4 * D * W * (1 if squaring else 3),
               width=W, mode="min" if squaring else "climb", **extra)

    # routed_round_end on the scatters' answers: the folded post-round
    # parent, the climb's first step, then the round's end with the
    # state's live words, each word against the plain version
    for case, (lo, val, old, new) in scattered.items():
        nw = routed.routed_fold_plain(new)
        cur = torch.where(nw < val, nw, lo).contiguous()
        lo0, hi0 = lo.clone(), val.clone()
        st = routed.new_state(D, dev)
        plo, phi = lo.clone(), val.clone()
        routed.routed_round_end(old, nw, cur, plo, phi, n, 0, st)
        want_lo, want_hi = routed.round_end_plain(
            routed.routed_fold_plain(old), nw, cur, lo0, hi0, n)
        err = max(_exact(plo, want_lo, f"routed_round_end {case} lo"),
                  _exact(phi, want_hi, f"routed_round_end {case} hi"),
                  _exact(st[routed.WORDS:],
                         (want_lo != n).sum(1, dtype=torch.int64),
                         f"routed_round_end {case} live words"))

        def reset():
            plo.copy_(lo0)
            phi.copy_(hi0)
            st.zero_()

        record("routed_round_end", case, err,
               inplace_ms(reset, lambda: routed.routed_round_end(
                   old, nw, cur, plo, phi, n, 0, st)),
               inplace_ms(reset, lambda: routed.round_end_plain(
                   routed.routed_fold_plain(old), nw, cur, lo0, hi0, n),
                   iters=5),
               # the old answers, nw, hi and cur read, lo and hi written
               # (FOLD reads no lo), the state's words
               4 * D * D * Q + 3 * 4 * D * Q + 2 * 4 * D * Q + 8 * D,
               live_out=int((want_lo != n).sum()))

    # routed_step's min on answer rows that start off 16 bytes (a view one
    # answer in: the scalar head, the vector body, the tail)
    q, got = gathers["B-square"]
    view = got[:, :, 1:]
    res = torch.empty((D, B - 1), dtype=torch.int32, device=dev)
    routed.routed_step(view, res)
    want, _ = routed.routed_step_plain(view)
    record("routed_step", "B-square-offset", _exact(
               res, want, "routed_step B-square-offset"),
           gs.time_ms(lambda: routed.routed_step(view, res)),
           gs.time_ms(lambda: routed.routed_step_plain(view), iters=5),
           4 * D * D * (B - 1) + 4 * D * (B - 1), width=B - 1, mode="min",
           library_ms=gs.time_ms(lambda: torch.amin(view, 0)))

    # the card forms (first 0, every shard on the card, so the owners'
    # folded answer to q is the table's entry at q)
    # a star's hub and a forest's slots at width Q (whose values seldom
    # lower a row), values 1-40 above lo (which lower most rows), and a
    # forest's slots at the tail's width
    near = (f_lo + torch.randint(1, 41, f_lo.shape, device=dev,
                                 generator=g, dtype=torch.int32)).clamp(
        max=n).masked_fill_(f_lo == n, n)
    tail = [synthetic_slots(n, BIGV_TAIL_Q, 1.0, g) for _ in range(D)]
    card_forms(card, table, (("star-hub", star_lo, star_val),
                             ("forest", f_lo, f_hi),
                             ("forest-lowering", f_lo, near),
                             ("forest-tail", torch.stack([s[0] for s in tail]),
                              torch.stack([s[1] for s in tail]))),
               record, reached)
    return out


def card_forms(card, table, scatters, record, reached,
               jumps: int = BIGV_JUMPS, TQ: int = BIGV_TAIL_Q,
               Q: int = BIGV_Q) -> None:
    """Phase 3h's card forms, each against its plain version, every output
    word equal: ``owned_scatter_min``'s card mode (one cooperative launch,
    the runtime's calls the witness) on ``scatters``' requests, beside the
    yardstick of three library calls (``torch.take``, ``scatter_reduce_``,
    ``torch.take``), with its bytes bound (lo and val read, the 32-byte
    sectors of the table that the requests reach read and those of the
    rows they lower written, the folded old written); ``routed_climb``
    over a tail round's whole jump climb (the round's first step and
    ``jumps - 1`` lookups of P, D x TQ slots) on the random and on a chain
    forest at 100%, 10% and 1% live, and the first launch of a lifting
    round (two steps, D x Q slots), with its bytes bound (16 bytes a slot
    and each sector of the table that a step loads, the steps up to the
    first that does not move) and, on the random forest, its chain bound
    (``chain_floor``'s launch floor on the tail's grid and the longest
    chain's dependent loads at the load latency of a random chase; on the
    chain forest consecutive parents share sectors, so its loads are
    faster than that latency and no chain bound is given);
    ``routed_square`` at width B on both forests, beside ``torch.take(t,
    t)``, bound by t read and out written."""
    import torch

    from sheep_tpu_torch.ops import routed
    from sheep_tpu_torch.tools import gather_smoke as gs

    dev = table.device
    D, B = table.shape
    n = int(table.view(-1)[-1])
    rows = D * B
    g = torch.Generator(device=dev).manual_seed(43)

    for case, lo, val in scatters:
        m = lo.numel()
        T, ref, lib = (table.clone() for _ in range(3))
        old = routed.owned_scatter_min(T, 0, lo, val, n, fold=True)
        w_old, _ = routed.owned_scatter_min_plain(ref, 0, lo, val, n,
                                                  fold=True)
        lo64, flat, v = lo.long().view(-1), lib.view(-1), val.view(-1)

        def yardstick():
            torch.take(flat, lo64)
            flat.scatter_reduce_(0, lo64, v, reduce="amin")

        yardstick()
        err = max(_exact(old, w_old, f"owned_scatter_min card-{case} old"),
                  _exact(T, ref, f"owned_scatter_min card-{case} table"),
                  _exact(lib, ref, f"the yardstick card-{case}"))
        lowered = (T.view(-1) != table.view(-1)).nonzero().view(-1)
        record("owned_scatter_min", f"card-{case}", err,
               inplace_ms(lambda: T.copy_(table), lambda: routed.
                          owned_scatter_min(T, 0, lo, val, n, fold=True)),
               inplace_ms(lambda: ref.copy_(table), lambda: routed.
                          owned_scatter_min_plain(ref, 0, lo, val, n,
                                                  fold=True), iters=3),
               8 * m + reached(lo) + 32 * sectors(lowered) + 4 * m,
               launches_a_call=1, mode="card",
               yardstick="torch.take + scatter_reduce_(amin)",
               yardstick_ms=inplace_ms(lambda: lib.copy_(table), yardstick),
               rows_lowered=int(lowered.numel()),
               device=device_launches(lambda: routed.owned_scatter_min(
                   T, 0, lo, val, n, fold=True),
                   f"owned_scatter_min card-{case}", [COOPERATIVE]))

    forests = {"random": table,
               "chain": _bigv_forest(n, D, synthetic_forest(n, n // 2, g))}
    yard = chain_floor(D * TQ, rows)
    cases = [(f"tail-{kind}-live{share:g}", kind, TQ, jumps, share)
             for kind in forests for share in (1.0, 0.1, 0.01)]
    cases.append(("lift-random-live1", "random", Q, 2, 1.0))
    for case, kind, W, steps, share in cases:
        P = forests[kind]
        slots = [synthetic_slots(n, W, share, g) for _ in range(D)]
        lo = torch.stack([s[0] for s in slots])
        hi = torch.stack([s[1] for s in slots])
        runs = [(P, steps)]
        out, new = torch.empty_like(lo), torch.empty_like(lo)
        routed.routed_climb(lo, hi, runs, n, out, new=new)
        want, first = routed.climb_runs_plain(lo, hi, runs, n)
        err = max(_exact(out, want, f"routed_climb {case}"),
                  _exact(new, first, f"routed_climb {case} new"))
        # the table entries the steps load: each slot's steps up to the
        # first that does not move it
        cur, h = lo.view(-1).clone(), hi.view(-1)
        going = torch.ones_like(cur, dtype=torch.bool)
        loads = torch.zeros_like(cur)
        reads = []
        for _ in range(steps):
            reads.append(cur[going])
            loads += going.int()
            cand = routed.take_plain(P, cur, n)
            going = going & (cand < h) & (cand != cur)
            cur = torch.where(going, cand, cur)
        chain_loads = 1 + int(loads.max())
        # the launch floor on the tail's grid: no more blocks than any
        # case's (the kernel's grid is at most one wave); the load latency
        # is a random chase's, so the chain bound holds on the random
        # forest only
        floor = yard["floor_ms"]
        chain = dict(chain_bound_ms=floor + chain_loads *
                     yard["load_latency_ms"], floor_ms=floor,
                     load_latency_ms=yard["load_latency_ms"]) \
            if kind == "random" else {}
        record("routed_climb", case, err,
               gs.time_ms(lambda: routed.routed_climb(
                   lo, hi, runs, n, out, new=new)),
               gs.time_ms(lambda: routed.climb_runs_plain(lo, hi, runs, n),
                          iters=3),
               16 * lo.numel() + 32 * sectors(torch.cat(reads).long()),
               width=W, steps=steps, live=int((lo != n).sum()),
               chain_loads=chain_loads,
               steps_loaded_mean=float(loads.float().mean()), **chain)

    for kind, t in forests.items():
        sq = torch.empty_like(t)
        routed.routed_square(t, n, sq)
        flat, t64 = t.view(-1), t.view(-1).long()
        record("routed_square", f"B-{kind}", _exact(
                   sq, routed.routed_square_plain(t, n),
                   f"routed_square {kind}"),
               gs.time_ms(lambda: routed.routed_square(t, n, sq)),
               gs.time_ms(lambda: routed.routed_square_plain(t, n), iters=5),
               8 * rows, width=B,
               library_ms=gs.time_ms(lambda: torch.take(flat, t64)))


def _bigv_forest(n: int, D: int, forest):
    """A position-space forest of n + 1 entries as a block-sharded (D, B)
    table, the rows past n the sentinel."""
    import torch

    B = -(-(n + 1) // D)
    t = torch.full((D * B,), n, dtype=torch.int32, device=forest.device)
    t[:n + 1] = forest
    return t.view(D, B)


def round_launches(D: int = BIGV_SHARDS, n: int = 1 << 22,
                   Q: int = BIGV_Q) -> dict:
    """The kernel launches of one lifting round (width Q, L = 23) and of
    one tail round (width 2^13, jumps 128) of the vertex-sharded fold on
    D shards of the card: a segment of two rounds less a segment of one,
    on a random forest with every slot live (no round stops). Each must
    be what ``CardRound.launches`` counts for its program
    (``routed.round_launches``), at most 5 a tail round and 3 + 2L a
    lifting round, and one round's runtime calls (``torch.profiler``) must
    be one cooperative launch (the scatter) and that many less one
    kernel launches."""
    import torch

    from sheep_tpu_torch.ops import routed
    from sheep_tpu_torch.parallel.bigv import BigVPipeline
    from sheep_tpu_torch.parallel.mesh import Mesh

    g = torch.Generator(device="cuda").manual_seed(31)
    # a chain through half the positions: a slot climbs a link a step, so
    # no round retires every slot
    table = _bigv_forest(n, D, synthetic_forest(n, n // 2, g))
    out = {}
    for label, W, lift in (("lift", Q, True),
                           ("tail", BigVPipeline.TAIL_Q, False)):
        counts = []
        for seg in (1, 2):
            pipe = BigVPipeline(n, W, Mesh(["cuda:0"] * D),
                                segment_rounds=seg)
            slots = [synthetic_slots(n, W, 1.0, g) for _ in range(D)]
            lo = torch.stack([s[0] for s in slots])
            hi = torch.stack([s[1] for s in slots])
            routed.reset_launches()
            r, live, _ = pipe.fold_segment([table.clone()], [lo], [hi],
                                           lift)
            check(r == seg and live > 0,
                  f"{label}: a segment of {seg} rounds ran {r}, live {live}")
            counts.append(dict(routed.LAUNCHES))
        got = {k: counts[1][k] - counts[0][k] for k in counts[0]}
        total = sum(got.values())
        bufs = [[torch.empty_like(table)] for _ in range(2)] if lift \
            else None
        P = table.clone()
        prog = [(step[0], *[t[0] for t in step[1:]])
                for step in pipe._program([P], bufs, None)]
        rnd = routed.CardRound(P, lo, hi, n, prog, routed.new_state(
            D, "cuda"), 16)
        check({k: v for k, v in got.items() if v} ==
              {k: v for k, v in rnd.launches.items() if v},
              f"{label} round: launches {got}, CardRound counts "
              f"{rnd.launches}")
        cap = 3 + 2 * pipe.lift_levels if lift else 5
        check(total <= cap, f"{label} round: {total} launches > {cap}")
        runtime = device_launches(rnd, f"{label} round",
                                  [COOPERATIVE] + ["cudaLaunchKernel"]
                                  * (total - 1))
        out[label] = dict(got, total=total, cap=cap,
                          runtime_calls=len(runtime["api"]))
    print("bigv-round-launches " + json.dumps(out), flush=True)
    return out


class _OutOfBudget(Exception):
    """A budgeted build stopped between two batches (``bigv_s22``); the
    build's retry takes it as fatal."""

    fault_class = "fatal"


def bigv_s22(card, ref, counters, mesh=None, label: str = "4-on-1",
             spec: str = S22_SPEC, card_rounds: bool = True,
             budget_s: float = 0.0) -> dict:
    """Phase 5m: phase 5's graph and k through the vertex-sharded build
    (``TorchBigVBackend`` at its defaults: chunk 2^20, jumps 128, 16 rounds
    a segment, auto L, no hoisted stack) on ``mesh`` (default: BIGV_SHARDS
    shards of the one card); the forest, assignment, cut, total, comm
    volume and balance equal to phase 5's (``ref``), every routed kernel
    launched. Prints its pass seconds, edges/s, rounds, host reads,
    compactions, collective counts, launches and peak memory a card.
    ``card_rounds=False`` drives a one-card mesh's rounds through the
    collectives and the wrappers card after card, as several cards do.
    A ``budget_s`` > 0 prints a line after each build batch (its seconds
    since the start and its rounds) and stops the build after the first
    batch that ends past it: the run then prints its pace as an
    ``s22-bigv-partial`` line and checks nothing more."""
    import torch

    from sheep_tpu_torch.backends.torch_bigv_backend import \
        TorchBigVBackend
    from sheep_tpu_torch.io.edgestream import open_input
    from sheep_tpu_torch.ops import routed
    from sheep_tpu_torch.parallel.mesh import Mesh

    if mesh is None:
        mesh = Mesh([torch.device("cuda", 0)] * BIGV_SHARDS)
    devices = mesh.distinct()
    for dev in devices:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    for c in (*counters, routed):
        c.reset_launches()
    be = TorchBigVBackend(mesh=mesh, hoist_bytes=0)
    make = be._pipe

    def pipe_of(n, cs):
        pipe = make(n, cs)
        pipe.card_rounds = pipe.card_rounds and card_rounds
        step = pipe.build_step

        def logged(*args, **kw):
            got = step(*args, **kw)
            batches.append(got[1])
            spent = time.perf_counter() - t0
            print(f"bigv {label}: batch {len(batches)} done at "
                  f"{spent:.2f}s, {got[1]} rounds", flush=True)
            if spent > budget_s:
                raise _OutOfBudget
            return got

        if budget_s > 0:
            pipe.build_step = logged
        return pipe

    be._pipe = pipe_of
    batches: list = []
    t0 = time.perf_counter()
    try:
        with open_input(spec) as stream:
            res = be.partition(stream, S22_K, keep_tree=True)
    except _OutOfBudget:
        rec = {"spec": spec, "k": S22_K, "shards": len(mesh),
               "devices": [str(dev) for dev in devices], "label": label,
               "budget_s": budget_s, "seconds": time.perf_counter() - t0,
               "batches_done": len(batches),
               "chunks_done": len(batches) * len(mesh),
               "rounds_by_batch": batches, "rounds": sum(batches),
               "card": card}
        print("s22-bigv-partial " + json.dumps(rec), flush=True)
        return rec
    wall = time.perf_counter() - t0
    launches = {k: v for c in (*counters, routed)
                for k, v in c.LAUNCHES.items()}
    peaks = [torch.cuda.max_memory_allocated(dev) for dev in devices]
    what = f"{spec} bigv {label}"
    same_result(res, ref, what, rounds=False)
    check(res.backend == "torch-bigv:cuda", f"{what}: backend {res.backend}")
    one_call = card_rounds and len(devices) == 1
    for name in BIGV_KERNELS if one_call else BIGV_CARDS_KERNELS:
        check(launches[name] > 0, f"{what}: no {name} launch")
    d = res.diagnostics
    if spec == S22_SPEC and len(mesh) == BIGV_SHARDS:
        for key, want in BIGV_S22_COUNTS.items():
            check(d.get(key, 0) == want,
                  f"{what}: {key} {d.get(key, 0)} != {want}")
    rec = {"spec": spec, "k": S22_K, "shards": len(mesh),
           "devices": [str(dev) for dev in devices], "label": label,
           "card_rounds": one_call,
           "wall_s": wall,
           "phase_s": res.phase_times,
           "edges_per_s": res.total_edges / wall,
           "build_edges_per_s": res.total_edges / res.phase_times["build"],
           "chunk_edges": d["chunk_edges_effective"],
           "fixpoint_rounds": d["fixpoint_rounds"],
           "host_syncs": d["host_syncs"],
           "compactions": d.get("compactions", 0),
           "collective_ops": d["collective_ops"],
           "collective_bytes": d["collective_bytes"],
           "q_rounds": d["q_rounds"],
           "launches": {k: launches[k] for k in BIGV_KERNELS
                        + ("compact_live", "hash_chunk")},
           "launches_total": sum(launches[k] for k in BIGV_KERNELS
                                 + ("compact_live",)),
           "peak_mem_bytes": max(peaks), "peak_mem_bytes_by_device": peaks,
           "card": card}
    print("s22-bigv " + json.dumps(rec), flush=True)
    return rec


def bigv_hoisted(card) -> dict:
    """Phase 5m's second run: the hoisted lifting stack (``hoist_bytes=1 <<
    30``: L - 1 levels built once a segment) on rmat-hash:20:16:42, k = 64,
    4 shards of the card, against the port's ``torch`` backend on the same
    graph on the card: forest, assignment and scores equal."""
    import torch

    import sheep_tpu_torch
    from sheep_tpu_torch.backends.torch_bigv_backend import \
        TorchBigVBackend
    from sheep_tpu_torch.io.edgestream import open_input
    from sheep_tpu_torch.parallel.mesh import Mesh

    spec = "rmat-hash:20:16:42"
    single = sheep_tpu_torch.partition(spec, 64, device="cuda",
                                       keep_tree=True)
    t0 = time.perf_counter()
    with open_input(spec) as stream:
        res = TorchBigVBackend(mesh=Mesh(["cuda:0"] * BIGV_SHARDS),
                               hoist_bytes=1 << 30).partition(
            stream, 64, keep_tree=True)
    wall = time.perf_counter() - t0
    same_result(res, single, f"{spec} bigv hoisted", rounds=False)
    d = res.diagnostics
    rec = {"spec": spec, "k": 64, "hoist_bytes": 1 << 30, "wall_s": wall,
           "phase_s": res.phase_times, "edge_cut": res.edge_cut,
           "fixpoint_rounds": d["fixpoint_rounds"],
           "host_syncs": d["host_syncs"],
           "collective_ops": d["collective_ops"],
           "collective_bytes": d["collective_bytes"], "card": card}
    print("s20-bigv-hoisted " + json.dumps(rec), flush=True)
    return rec

# 5n: multi-process runs on torch.distributed: RANKS processes started by
# the smoke (``python -m sheep_tpu_torch.tools.mp_rank``), each holding
# MP_SHARDS shards; on one card gloo with host staging (NCCL refuses two
# ranks on one card), with --sharded-cards NCCL one rank a card
MP_RANKS, MP_SHARDS = 2, 2
MP_TIMEOUT_S = 600


def multiprocess_runs(card, ref, small, transport: str = "gloo",
                      ranks: int = MP_RANKS, shards: int = MP_SHARDS,
                      s22_spec: str = S22_SPEC, device: str = "cuda") -> dict:
    """Phase 5n: ``ranks`` processes of the port's sharded builds, each
    with ``shards`` shards of its card (``local_card``), over the
    ``transport``: phase 5's graph through ``torch-sharded`` per segment
    and batched (equal to phase 5's ``ref``); ``BIGV_PATHS_SPEC`` through
    ``torch-bigv``, as plain text through ``torch-sharded`` (byte-range
    spans), and through ``torch-sharded`` killed at ``build:2`` on every
    rank and resumed from the ranks' checkpoints (each equal to the
    single-device ``small``). Every rank's forest and assignment digests,
    cut, total, comm volume and balance equal the reference's, and every
    rank's non-time diagnostics equal every other's. Then the same ranks
    through the CLI (``python -m sheep_tpu_torch`` and its three flags)
    on ``BIGV_PATHS_SPEC``: process 0's map and scores equal ``small``'s.
    One ``s22-multiprocess`` line a run; returns {label: its line}.
    ``device="cpu"`` rehearses the phase on CPU shards."""
    import shutil

    import numpy as np

    from sheep_tpu_torch.io import formats
    from sheep_tpu_torch.io.edgestream import open_input
    from sheep_tpu_torch.tools.mp_rank import digest

    scratch = tempfile.mkdtemp(prefix="sheep_5n_")
    try:
        text = os.path.join(scratch, "s18.edges")
        with open_input(BIGV_PATHS_SPEC) as stream:
            formats.write_edges(text, stream.read_all())
        ck = os.path.join(scratch, "ck")
        n18 = len(small.assignment)
        # chunks of n edges: 16 chunks, 4 batches of the 4 shards, so
        # that the kill at build:2 comes after the first checkpoint
        s18 = {"k": S22_K}
        fault_cs = n18
        runs = [
            {"label": "s22-per-segment", "spec": s22_spec, "k": S22_K},
            {"label": "s22-batched", "spec": s22_spec, "k": S22_K,
             "dispatch_batch": 4, "inflight": 2},
            {"label": "s18-bigv", "spec": BIGV_PATHS_SPEC,
             "backend": "torch-bigv", **s18},
            {"label": "s18-text", "spec": text, "n_vertices": n18, **s18},
            {"label": "s18-fault", "spec": BIGV_PATHS_SPEC,
             "chunk_edges": fault_cs, "checkpoint_dir": ck, "every": 4,
             "fault": "build:2", **s18},
            {"label": "s18-resume", "spec": BIGV_PATHS_SPEC,
             "chunk_edges": fault_cs, "checkpoint_dir": ck, "every": 4,
             "resume": True, **s18}]
        outs = [os.path.join(scratch, f"rank{r}.json")
                for r in range(ranks)]
        _run_ranks(ranks, scratch, "mp_rank", lambda rank, addr: [
            "-m", "sheep_tpu_torch.tools.mp_rank", "--coordinator", addr,
            "--num-processes", str(ranks), "--process-id", str(rank),
            "--dist-backend", transport, "--shards", str(shards),
            "--runs", json.dumps(runs), "--out", outs[rank],
            "--device", device])
        recs = [json.load(open(o)) for o in outs]
        want = {"s22": ref, "s18": small}
        got = {}
        for run in runs:
            label = run["label"]
            per = [r["runs"][label] for r in recs]
            what = f"5n {label} ({ranks} ranks over {transport})"
            if run.get("fault"):
                check(all(x["outcome"] == "fault" for x in per),
                      f"{what}: {[x['outcome'] for x in per]}")
                continue
            base = want[label.split("-")[0]]
            for rank, x in enumerate(per):
                where = f"{what}, rank {rank}"
                check(x["outcome"] == "ok", f"{where}: {x['outcome']}")
                check(x["parent_sha1"] == digest(base.tree["parent"]),
                      f"{where}: the forest differs")
                check(x["assignment_sha1"] == digest(base.assignment),
                      f"{where}: the assignment differs")
                for key in ("edge_cut", "total_edges", "comm_volume",
                            "balance"):
                    check(x[key] == getattr(base, key),
                          f"{where}: {key} {x[key]} != "
                          f"{getattr(base, key)}")
                check(x["diagnostics"] == per[0]["diagnostics"],
                      f"{where}: diagnostics differ from rank 0's")
                check(x["launches"] == per[0]["launches"],
                      f"{where}: launches differ from rank 0's")
                # every rank's shards went through the path's kernels,
                # each rank hashing its own chunks on its card (plain
                # text is read on the host: no hash_chunk there); CPU
                # shards launch none
                path = () if device == "cpu" else \
                    BIGV_CARDS_KERNELS + ("hash_chunk",) \
                    if run.get("backend") == "torch-bigv" else tuple(
                        k for k in SHARDED_PATH
                        if k != "hash_chunk" or label != "s18-text")
                for name in path:
                    check(x["launches"][name] > 0,
                          f"{where}: no {name} launch")
            d = per[0]["diagnostics"]
            line = {"run": label, "spec": run["spec"] if label != "s18-text"
                    else f"{BIGV_PATHS_SPEC} as text",
                    "backend": run.get("backend", "torch-sharded"),
                    "ranks": ranks, "shards_a_rank": shards,
                    "transport": transport,
                    "devices": sorted({r["device"] for r in recs}),
                    "wall_s": max(x["wall_s"] for x in per),
                    "phase_s": per[0]["phase_s"],
                    "edges_per_s": per[0]["total_edges"]
                    / max(x["wall_s"] for x in per),
                    "device_rounds": d.get("device_rounds"),
                    "host_syncs": d.get("host_syncs"),
                    "merge_mode": d.get("merge_mode"),
                    "merge_payload_bytes": d.get("merge_payload_bytes"),
                    "peak_mem_bytes_a_rank": [x["peak_mem_bytes"]
                                              for x in per],
                    "launches_a_rank": [x["launches"] for x in per],
                    "edge_cut": per[0]["edge_cut"], "card": card}
            print("s22-multiprocess " + json.dumps(line), flush=True)
            got[label] = line
        # the user's launch: the same ranks through the CLI (its bring-up,
        # its default backend torch-sharded, process 0 alone reporting and
        # writing the map), equal to the single-device s18
        parts = os.path.join(scratch, "s18-cli.parts")
        t0 = time.perf_counter()
        logs = _run_ranks(ranks, scratch, "cli", lambda rank, addr: [
            "-m", "sheep_tpu_torch", "--input", BIGV_PATHS_SPEC,
            "--k", str(S22_K), "--n-devices", str(ranks * shards),
            "--coordinator", addr, "--num-processes", str(ranks),
            "--process-id", str(rank), "--dist-backend", transport,
            "--device", device, "--json", "--output", parts])
        wall = time.perf_counter() - t0
        what = f"5n s18-cli ({ranks} ranks over {transport})"
        lines = [[ln for ln in lg.splitlines() if ln.startswith("{")]
                 for lg in logs]
        check(len(lines[0]) == 1 and not any(lines[1:]),
              f"{what}: not process 0 alone reported: {lines}")
        summary = json.loads(lines[0][0])
        check(summary["backend"].startswith("torch-sharded"),
              f"{what}: backend {summary['backend']}")
        check(np.array_equal(formats.read_partition(parts),
                             small.assignment),
              f"{what}: the map differs from the single-device s18's")
        for key in ("edge_cut", "total_edges", "comm_volume", "balance"):
            check(summary[key] == getattr(small, key),
                  f"{what}: {key} {summary[key]} != {getattr(small, key)}")
        line = {"run": "s18-cli", "spec": BIGV_PATHS_SPEC,
                "backend": summary["backend"], "ranks": ranks,
                "shards_a_rank": shards, "transport": transport,
                "wall_s": wall, "run_wall_s": summary["wall_seconds"],
                "phase_s": summary["phase_times"],
                "edge_cut": summary["edge_cut"], "card": card}
        print("s22-multiprocess " + json.dumps(line), flush=True)
        got["s18-cli"] = line
        return got
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def _run_ranks(ranks: int, scratch: str, tag: str, argv) -> list:
    """``ranks`` processes of ``python argv(rank, coordinator)``, each with
    its ``LOCAL_RANK`` and its log in ``scratch``, waited for within
    ``MP_TIMEOUT_S`` (every one killed past it); checks that each exits 0
    and returns each log."""
    logs, procs = [], []
    addr = f"127.0.0.1:{_free_port()}"
    for rank in range(ranks):
        logs.append(os.path.join(scratch, f"{tag}{rank}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable] + argv(rank, addr), stdout=log,
                stderr=subprocess.STDOUT,
                env={**os.environ, "LOCAL_RANK": str(rank)}))
    try:
        rcs = [p.wait(timeout=MP_TIMEOUT_S) for p in procs]
    except subprocess.TimeoutExpired:
        rcs = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = [open(lg).read() for lg in logs]
    tails = [t[-3000:] for t in texts]
    for rank, tail in enumerate(tails):
        print(f"5n {tag} rank {rank} log: " + " | ".join(
            ln for ln in tail.splitlines()
            if ln.endswith("s") and ": " in ln), flush=True)
    check(rcs is not None, f"5n {tag}: the ranks did not finish within "
                           f"{MP_TIMEOUT_S}s: {tails}")
    check(rcs == [0] * ranks, f"5n {tag}: rank exit codes {rcs}: {tails}")
    return texts


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def multiprocess_only() -> int:
    """``chip_smoke.py --multiprocess``: phase 5n alone, with the
    references it needs (phase 5's build and the single-device s18)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 2
    import sheep_tpu_torch
    from sheep_tpu_torch.ops import _build

    t_all = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    libs = _build.build_all()
    print(f"build: {sorted(libs)}", flush=True)
    ref = sheep_tpu_torch.partition(S22_SPEC, S22_K, device="cuda",
                                    chunk_edges=1 << 23, dispatch_batch=8,
                                    keep_tree=True)
    s22_check(ref, "s22")
    small = sheep_tpu_torch.partition(BIGV_PATHS_SPEC, S22_K, device="cuda",
                                      keep_tree=True)
    t0 = time.perf_counter()
    multiprocess_runs(card, ref, small)
    print(f"5n: {time.perf_counter() - t0:.1f}s", flush=True)
    print(f"card: {card}  total {time.perf_counter() - t_all:.1f}s",
          flush=True)
    print(json.dumps({"ok": True, "mode": "multiprocess", "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0



def sharded_cards() -> int:
    """``chip_smoke.py --sharded-cards``: phases 5l, 5m and 5n on a host
    with more than one card: the build, phase 5's single-device build as the
    reference, then every 5l run, those on a mesh of every card included,
    and the vertex-sharded build one shard a card: phase 5's graph within
    ``BIGV_CARDS_BUDGET_S`` (its pace), then ``BIGV_PATHS_SPEC`` checked;
    then 5n over NCCL, one process a card, one shard a process.
    Needs two cards or more; prints the 5l, 5m and 5n lines and
    {"ok": true, "mode": "sharded-cards", ...} last."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 2
    import sheep_tpu_torch
    from sheep_tpu_torch.ops import (_build, compact, fixpoint, gather, lift,
                                     refine, synth)

    t_all = time.perf_counter()
    cards = torch.cuda.device_count()
    check(cards > 1, f"--sharded-cards needs more than one card, have "
                     f"{cards}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    names = smi.stdout.strip().splitlines()
    card = names[0]
    print(f"cards: {names}", flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f}s",
          flush=True)
    # phase 5's build on the first card
    t0 = time.perf_counter()
    ref = sheep_tpu_torch.partition(S22_SPEC, S22_K, device="cuda",
                                    chunk_edges=1 << 23, dispatch_batch=8,
                                    keep_tree=True)
    s22_check(ref, "s22 D=2")
    print(f"s22 reference: {time.perf_counter() - t0:.2f}s", flush=True)
    t0 = time.perf_counter()
    sharded = sharded_s22(card, ref, (gather, lift, fixpoint, compact,
                                      synth, refine))
    print(f"5l: {time.perf_counter() - t0:.1f}s", flush=True)
    # 5m on every card, one shard a card: the routed round through the
    # collectives (peer copies); phase 5's graph for its pace within the
    # budget, then BIGV_PATHS_SPEC in full, equal to the torch backend
    t0 = time.perf_counter()
    from sheep_tpu_torch.parallel.mesh import shards_mesh

    counters = (gather, lift, fixpoint, compact, synth, refine)
    bigv_s22(card, ref, counters, mesh=shards_mesh(), label=f"cards{cards}",
             budget_s=BIGV_CARDS_BUDGET_S)
    small = sheep_tpu_torch.partition(BIGV_PATHS_SPEC, S22_K, device="cuda",
                                      keep_tree=True)
    bigv_s22(card, small, counters, mesh=shards_mesh(),
             label=f"cards{cards}", spec=BIGV_PATHS_SPEC)
    print(f"5m: {time.perf_counter() - t0:.1f}s", flush=True)
    # 5n over NCCL, one rank a card, one shard a rank
    t0 = time.perf_counter()
    multiprocess_runs(card, ref, small, transport="nccl", ranks=cards,
                      shards=1)
    print(f"5n: {time.perf_counter() - t0:.1f}s", flush=True)
    print(f"card: {card}  total {time.perf_counter() - t_all:.1f}s",
          flush=True)
    print(json.dumps({"ok": True, "mode": "sharded-cards",
                      "runs": sorted(sharded), "device": {
                          "platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": cards}}), flush=True)
    return 0


def s22_check(res, what: str) -> None:
    """The full-size result: valid parts and the JAX package's cut, total
    and comm volume."""
    check(len(res.assignment) == 1 << 22, f"{what}: assignment has the "
                                          f"wrong shape")
    check(int(res.assignment.min()) >= 0 and
          int(res.assignment.max()) < S22_K, f"{what}: part id out of range")
    check(res.edge_cut == S22_EDGE_CUT,
          f"{what}: edge_cut {res.edge_cut} != JAX {S22_EDGE_CUT}")
    check(res.total_edges == S22_TOTAL_EDGES,
          f"{what}: total_edges {res.total_edges} != JAX {S22_TOTAL_EDGES}")
    check(res.comm_volume == S22_COMM_VOLUME,
          f"{what}: comm_volume {res.comm_volume} != JAX {S22_COMM_VOLUME}")


def same_result(a, b, what: str, rounds: bool = True) -> None:
    """Equal forests, assignments and scores, and with ``rounds`` equal
    device rounds (which only runs at the same pipeline depth share: a
    deeper pipeline re-queues leftovers in another order)."""
    import numpy as np

    check(np.array_equal(a.tree["parent"], b.tree["parent"]),
          f"{what}: forests differ")
    check(np.array_equal(a.assignment, b.assignment),
          f"{what}: assignments differ")
    for key in ("edge_cut", "total_edges", "comm_volume", "balance"):
        check(getattr(a, key) == getattr(b, key), f"{what}: {key} differs")
    check(not rounds or
          a.diagnostics["device_rounds"] == b.diagnostics["device_rounds"],
          f"{what}: device_rounds differ")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 2
    import statistics

    import numpy as np

    import sheep_tpu_torch
    from sheep_tpu_torch.backends import torch_backend
    from sheep_tpu_torch.backends.torch_backend import LAUNCH_KEYS
    from sheep_tpu_torch.ops import (_build, compact, elim, fixpoint, gather,
                                     lift, refine, synth)

    counters = (gather, lift, fixpoint, compact, synth, refine)
    # kernel -> its launches' diagnostics key, for the kernels of the
    # batched driver's exact descent (not the stream descent, nor the
    # per-segment driver's own kernels)
    path_keys = {name: key for key, name in LAUNCH_KEYS.items()
                 if name not in ("stream_descent", "climb_jumps",
                                 "compact_live")}

    t_all = time.perf_counter()
    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f}s "
          f"({_build.build_dir()})", flush=True)

    # 3, 3b. the gather kernels against their plain versions, and the
    # probe tool
    cases, tool_launches = gathers(card)

    # 3c. the round's lifting kernels against their plain versions
    n22 = 1 << 22
    lift_cases = lifts(card, [
        (f"{kind}-live{share:g}", path, share)
        for kind, path in (("random", 0), ("chain", n22 // 2))
        for share in (1.0, 0.1, 0.01)])
    # 3d. the execution's kernels against their plain versions
    scatter_cases = scatters(card, (1.0, 0.01))
    rows_err = scatter_rows()
    exec_cases = exec_kernels(card)
    g = torch.Generator(device="cuda").manual_seed(13)
    descent_cases = descents(card, [
        (f"{kind}-L{L}-live{share:.3g}", synthetic_forest(n22, path, g), L,
         share)
        for kind, path in (("random", 0),
                           ("chain", chain_for_depth(23, n22)))
        for L in (23, 8) for share in (1.0, 0.01, 2.0 ** -20)])
    descent_stopped = stopped_descent(card)
    fused_compared = fused_rounds(card)
    # 3e. the per-segment driver's kernels against their plain versions
    compact_cases = compactions(card)
    jumps_cases = jump_climbs(card)
    # 3f. the chunk synthesis against its plain version
    synth_cases = hash_chunks(card)
    # 3g. the refinement's kernels against their plain versions
    refine_cases = refine_kernels(card)
    # 3h. the vertex-sharded build's routed kernels against their plain
    # versions
    routed_cases = routed_kernels(card)

    # 4. the port on CUDA (auto depth: 2) against the port on the CPU at
    # depths 1 (its auto) and 2
    spec16 = "rmat-hash:16:16:7"
    opts = dict(chunk_edges=1 << 17, dispatch_batch=3, keep_tree=True)
    t0 = time.perf_counter()
    on_gpu = sheep_tpu_torch.partition(spec16, 64, device="cuda", **opts)
    t_gpu = time.perf_counter() - t0
    check(on_gpu.diagnostics["inflight_depth"] == 2,
          "the CUDA run's auto depth is not 2")
    t0 = time.perf_counter()
    for depth in (1, 2):
        on_cpu = sheep_tpu_torch.partition(spec16, 64, device="cpu",
                                           inflight=depth, **opts)
        same_result(on_gpu, on_cpu, f"{spec16} cuda D=2, cpu D={depth}",
                    rounds=depth == 2)
    t_cpu = time.perf_counter() - t0
    for key in path_keys.values():
        check(on_gpu.diagnostics[key] > 0, f"the CUDA run has no {key}")
    print(f"parity {spec16} k=64: cuda D=2 == cpu D=1 == cpu D=2 (edge_cut "
          f"{on_gpu.edge_cut}, device_rounds "
          f"{on_gpu.diagnostics['device_rounds']:.0f}; wall cuda "
          f"{t_gpu:.2f}s, cpu both {t_cpu:.2f}s)", flush=True)
    # 4b. the stream descent (K1, scatter_min, stream_descent and
    # climb_tail a round), which the table budget keeps for larger
    # graphs, forced by a budget of 0
    spec14 = "rmat-hash:14:16:7"
    opts = dict(chunk_edges=1 << 15, dispatch_batch=3, keep_tree=True,
                inflight=2)
    budget, elim.EXACT_TABLE_BYTES = elim.EXACT_TABLE_BYTES, 0
    try:
        on_gpu = sheep_tpu_torch.partition(spec14, 16, device="cuda", **opts)
        on_cpu = sheep_tpu_torch.partition(spec14, 16, device="cpu", **opts)
    finally:
        elim.EXACT_TABLE_BYTES = budget
    same_result(on_gpu, on_cpu, f"{spec14} (stream descent)")
    dg = on_gpu.diagnostics
    stream_rounds = dg["rounds_enqueued"]
    # one cooperative launch of the descent a stream round (each call one
    # cudaLaunchCooperativeKernel: phase 3d's witness), K1 once a round
    check(stream_rounds > 0 and dg["lift_launches"] == 0 and
          dg["stream_descent_launches"] == stream_rounds and
          dg["gather_launches"] == stream_rounds and
          dg["scatter_launches"] == stream_rounds and
          dg["climb_launches"] == stream_rounds,
          f"the stream descent's CUDA run is not K1, scatter_min, "
          f"stream_descent and climb_tail once a round: "
          f"{ {k: dg[k] for k in LAUNCH_KEYS} } in {stream_rounds} rounds")
    stream_launches = dg["stream_descent_launches"]
    print(f"parity {spec14} k=16, stream descent: cuda == cpu (edge_cut "
          f"{on_gpu.edge_cut}, device_rounds {dg['device_rounds']:.0f}, "
          f"rounds enqueued {stream_rounds:.0f}, stream_descent and K1 "
          f"launches {stream_launches:.0f} each)", flush=True)
    # 4c. a file through the staged H2D ring: CUDA equals the CPU; the
    # same edges as text (the native parser; no newline after the last
    # line) give the same partition
    with tempfile.TemporaryDirectory() as tmp:
        from sheep_tpu_torch.io import formats, generators

        path = os.path.join(tmp, "rmat14.bin32")
        text = os.path.join(tmp, "rmat14.edges")
        edges = generators.rmat_hash_range(14, 0, 16 << 14, seed=5)
        formats.write_edges(path, edges)
        formats.write_edges(text, edges)
        with open(text, "rb+") as f:
            f.truncate(os.path.getsize(text) - 1)
        opts = dict(chunk_edges=1 << 15, dispatch_batch=3, keep_tree=True,
                    inflight=2, h2d_ring=2)
        on_gpu = sheep_tpu_torch.partition(path, 16, device="cuda", **opts)
        on_cpu = sheep_tpu_torch.partition(path, 16, device="cpu", **opts)
        t0 = time.perf_counter()
        on_text = sheep_tpu_torch.partition(text, 16, device="cuda", **opts)
        t_text = time.perf_counter() - t0
    same_result(on_gpu, on_cpu, "rmat14.bin32 through the ring")
    same_result(on_text, on_gpu, "rmat14.edges (text) against .bin32")
    check(on_text.total_edges == on_gpu.total_edges,
          "the text file lost edges")
    print(f"parity rmat14.edges k=16 (native text parser, no final "
          f"newline): == .bin32 on cuda (wall {t_text:.2f}s)", flush=True)
    dg = on_gpu.diagnostics
    check(dg["h2d_ring_depth"] == 2 and dg["h2d_staged_bytes"] > 0,
          "the file run did not stage through the ring")
    print(f"parity rmat14.bin32 k=16, h2d_ring 2: cuda == cpu (edge_cut "
          f"{on_gpu.edge_cut}, staged {dg['h2d_staged_bytes']:.0f} B, "
          f"h2d_blocked_ms {dg['h2d_blocked_ms']:.3f})", flush=True)

    # 4d. the per-segment driver, CUDA against the CPU
    jump_launches = per_segment(card, counters)
    # 4e. the planted-partition and replay inputs, partition_multi, .csr
    # and gzip text, CUDA against the CPU
    planted_parity(card, counters)
    # 4f. refinement and the hierarchy, CUDA against the CPU
    refine_parity(card, counters)
    # 4g. checkpoints, recovery and residency, CUDA against the CPU
    fault_parity(card)

    # 5. the full-size build on the card, through the user's entry point,
    # at the default depth; fold_segments_pipelined runs its dispatch loop
    # under torch.cuda's sync debug mode "error", so a stray synchronizing
    # op there raises
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counter in counters:
        counter.reset_launches()
    round_log: list = []
    t0 = time.perf_counter()
    res = sheep_tpu_torch.partition(S22_SPEC, S22_K, device="cuda",
                                    chunk_edges=1 << 23, dispatch_batch=8,
                                    round_log=round_log, keep_tree=True)
    wall = time.perf_counter() - t0
    launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated()
    check(torch.cuda.get_sync_debug_mode() == 0,
          "the pipelined fold left the sync debug mode on")
    s22_check(res, "s22 D=2")
    d = res.diagnostics
    check(d["inflight_depth"] == 2, "the s22 run's depth is not 2")
    rounds = int(d["device_rounds"])
    enqueued = int(d["rounds_enqueued"])
    for name, key in path_keys.items():
        check(launches[name] > 0, f"the main path launched no {name}")
        check(launches[name] == d[key],
              f"{name}: launch counter and diagnostics disagree")
    for name in ("gather_clip", "scatter_min", "lift_stack", "climb_tail"):
        check(launches[name] == enqueued,
              f"{name}: {launches[name]} launches in {enqueued} rounds")
    # each chunk synthesized once, by the degrees pass: the build and the
    # score read the chunks the cache keeps on the card
    check(launches["hash_chunk"] == 8,
          f"hash_chunk: {launches['hash_chunk']} launches for 8 chunks")
    check(d["residency_hits"] == 2 * 8,
          f"{d['residency_hits']} cached chunks served, not 16")
    # the round's end runs in climb_tail's last block: no launch of its own
    check("round_end" not in launches and
          "round_end_launches" not in d, "a stand-alone round_end ran")
    check(launches["exec_finish"] ==
          d["batch_execs"] + d["inflight_discards"],
          "exec_finish: not one launch an execution")
    check(d["host_syncs"] == d["batch_execs"],
          f"{d['host_syncs']} host reads for {d['batch_execs']} executions")
    check(len(round_log) == rounds, "the device round log missed rounds")
    slots = 1 << 23
    depth_med = statistics.median_low(r[0] for r in round_log)
    share_med = statistics.median_low(r[1] for r in round_log) / slots
    print("s22 " + json.dumps({
        "spec": S22_SPEC, "k": S22_K, "inflight": 2, "wall_s": wall,
        "phase_s": res.phase_times, "edge_cut": res.edge_cut,
        "total_edges": res.total_edges, "comm_volume": res.comm_volume,
        "balance": res.balance, "device_rounds": d["device_rounds"],
        "rounds_enqueued": enqueued, "host_syncs": d["host_syncs"],
        "batch_execs": d["batch_execs"],
        "inflight_discards": d["inflight_discards"],
        "host_blocked_ms": d["host_blocked_ms"],
        "device_gap_ms": d["device_gap_ms"],
        "launches": launches, "round_end_launches": 0,
        "hash_chunk_launches": launches["hash_chunk"],
        "peak_mem_bytes": peak,
        "live_share_mean": d["live_sum"] / (rounds * slots),
        "live_share_max": d["live_max"] / slots,
        "live_share_median": share_med,
        "depth_mean": d["depth_sum"] / rounds, "depth_max": d["depth_max"],
        "depth_median": depth_med,
        # levels a ladder computes, derived from each round's depth by
        # the rule that rows_written holds the kernel to in phases 3c and
        # 5b, max(d - 1, 1); the per-level ladder it replaced computed
        # min(d, L - 1)
        "ladder_levels_mean": statistics.mean(
            max(r[0] - 1, 1) for r in round_log),
        "ladder_levels_per_level_launch_mean": statistics.mean(
            min(r[0], 22) for r in round_log),
        "split": "native", "split_s": res.phase_times["split"],
        "card": card}), flush=True)

    # 5b. the lifting kernels and the scatter at the main path's median
    # round (phases 3c and 3d)
    main_case = lifts(card, [(f"main-d{depth_med}-live{share_med:.3g}",
                              chain_for_depth(depth_med, n22),
                              share_med)], fused=True)[0]
    main_scatter = scatters(card, (share_med,))[0]
    k1_case = k1_main(card, share_med)
    # ... and the ladder and the stream descent on the table of this
    # build's own forest
    forest_case = forest_ladder(card, res)
    P22 = forest_table(res, n22)
    forest_descents = descents(card, [
        (f"s22-forest-L{L}-live{share:.3g}", P22, L, share)
        for L in (23, 8) for share in (share_med, 1.0)])
    del P22

    # 5c. s22 at depths 1 and 3: the same partition
    for depth in (1, 3):
        t0 = time.perf_counter()
        other = sheep_tpu_torch.partition(S22_SPEC, S22_K, device="cuda",
                                          chunk_edges=1 << 23,
                                          dispatch_batch=8, inflight=depth)
        s22_check(other, f"s22 D={depth}")
        check(np.array_equal(other.assignment, res.assignment),
              f"s22 D={depth}: assignment differs from D=2")
        od = other.diagnostics
        check(od["host_syncs"] == od["batch_execs"],
              f"s22 D={depth}: {od['host_syncs']} host reads for "
              f"{od['batch_execs']} executions")
        print("s22-depth " + json.dumps({
            "inflight": depth, "wall_s": time.perf_counter() - t0,
            "phase_s": other.phase_times,
            "device_rounds": od["device_rounds"],
            "host_syncs": od["host_syncs"], "batch_execs": od["batch_execs"],
            "inflight_discards": od["inflight_discards"],
            "host_blocked_ms": od["host_blocked_ms"],
            "device_gap_ms": od["device_gap_ms"], "card": card}),
            flush=True)

    # 5d. the full-size build through the per-segment driver, at the
    # reference's default chunk (2^22)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counter in counters:
        counter.reset_launches()
    t0 = time.perf_counter()
    seg = sheep_tpu_torch.partition(S22_SPEC, S22_K, device="cuda",
                                    chunk_edges=1 << 22, dispatch_batch=1,
                                    inflight=1)
    seg_wall = time.perf_counter() - t0
    seg_launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    s22_check(seg, "s22 per segment")
    check(np.array_equal(seg.assignment, res.assignment),
          "s22 per segment: assignment differs from the batched build")
    sd = seg.diagnostics
    segments = sum(sd.get(k, 0) for k in ("warm_segments", "full_segments",
                                          "small_segments"))
    check(sd["host_syncs"] == segments,
          f"s22 per segment: {sd['host_syncs']} host reads for {segments} "
          f"segments")
    for name in ("gather_clip", "scatter_min", "climb_tail",
                 "stream_descent", "lift_stack", "compact_live"):
        check(seg_launches[name] > 0,
              f"s22 per segment: no {name} launch")
    auto_batch = torch_backend.resolve_dispatch_batch(
        0, 1 << 22, 1 << 22, "cuda", inflight=2, donate=True, h2d_ring=0)
    print("s22-per-segment " + json.dumps({
        "spec": S22_SPEC, "k": S22_K, "chunk_edges": 1 << 22,
        "dispatch_batch": 1, "inflight": 1, "wall_s": seg_wall,
        "phase_s": seg.phase_times, "edge_cut": seg.edge_cut,
        "total_edges": seg.total_edges, "comm_volume": seg.comm_volume,
        **{k: sd[k] for k in SEGMENT_COUNTERS if k in sd},
        **{k: sd[k] for k in sd if k.startswith("t_")},
        "host_blocked_ms": sd["host_blocked_ms"],
        "device_gap_ms": sd["device_gap_ms"],
        "fixpoint_rounds": sd["fixpoint_rounds"],
        "launches": seg_launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "auto_dispatch_batch": auto_batch,
        "device_memory_bytes": torch_backend.device_memory_bytes(
            torch.device("cuda")), "card": card}), flush=True)

    # 5e. the full-size build with the entry point's defaults: auto
    # dispatch batch and depth, the default chunk; its peak memory against
    # the model that sized N and the share of the card the model may use
    from sheep_tpu_torch.utils.membudget import build_phase_bytes

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dflt = sheep_tpu_torch.partition(S22_SPEC, S22_K, device="cuda")
    dflt_wall = time.perf_counter() - t0
    dflt_peak = torch.cuda.max_memory_allocated()
    s22_check(dflt, "s22 defaults")
    check(np.array_equal(dflt.assignment, res.assignment),
          "s22 defaults: assignment differs from the batched build")
    dd = dflt.diagnostics
    check(dd["dispatch_batch"] == auto_batch,
          f"s22 defaults: dispatch batch {dd['dispatch_batch']}, the auto "
          f"rule says {auto_batch}")
    check(dd["host_syncs"] == dd["batch_execs"],
          f"s22 defaults: {dd['host_syncs']} host reads for "
          f"{dd['batch_execs']} executions")
    # the model with the chunks the cache held
    model = build_phase_bytes(1 << 22, 1 << 22, dispatch_batch=auto_batch,
                              inflight=int(dd["inflight_depth"]),
                              donate=True,
                              resident_bytes=int(dd["spill_resident_bytes"]))
    allowed = int(0.9 * torch_backend.device_memory_bytes(
        torch.device("cuda")))
    check(dflt_peak <= allowed,
          f"s22 defaults: peak {dflt_peak} B over the model's allowance "
          f"{allowed} B")
    print("s22-defaults " + json.dumps({
        "spec": S22_SPEC, "k": S22_K, "chunk_edges": 1 << 22,
        "dispatch_batch": dd["dispatch_batch"],
        "inflight": dd["inflight_depth"], "wall_s": dflt_wall,
        "phase_s": dflt.phase_times, "edge_cut": dflt.edge_cut,
        "total_edges": dflt.total_edges, "comm_volume": dflt.comm_volume,
        "device_rounds": dd["device_rounds"], "host_syncs": dd["host_syncs"],
        "batch_execs": dd["batch_execs"],
        "inflight_discards": dd["inflight_discards"],
        "host_blocked_ms": dd["host_blocked_ms"],
        "device_gap_ms": dd["device_gap_ms"],
        "peak_mem_bytes": dflt_peak, "model_total_bytes":
            model["total_bytes"], "resident_bytes": model["resident_bytes"],
        "allowed_bytes": allowed,
        "card": card}), flush=True)

    # 5f. the planted partition at full size through partition_multi at
    # the entry point's defaults: one build, split at three k
    from sheep_tpu_torch.io.generators import SbmHashStream

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counter in counters:
        counter.reset_launches()
    t0 = time.perf_counter()
    multi = sheep_tpu_torch.partition_multi(SBM22_SPEC, SBM22_KS,
                                            device="cuda")
    sbm_wall = time.perf_counter() - t0
    sbm_launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    check([r.k for r in multi] == list(SBM22_KS), "sbm22: k order")
    for r in multi:
        want = SBM22_SCORES[r.k]
        check(len(r.assignment) == 1 << 22 and
              int(r.assignment.min()) >= 0 and
              int(r.assignment.max()) < r.k, f"sbm22 k={r.k}: bad parts")
        check((r.edge_cut, r.total_edges, r.comm_volume) == want,
              f"sbm22 k={r.k}: (cut, total, cv) "
              f"{(r.edge_cut, r.total_edges, r.comm_volume)} != JAX {want}")
    # 16 chunks of 2^22: the degrees pass (the build and the score read
    # the cache), and the further k's pass
    check(sbm_launches["hash_chunk"] == 2 * 16,
          f"sbm22: {sbm_launches['hash_chunk']} hash_chunk launches")
    for name in path_keys:
        check(sbm_launches[name] > 0, f"sbm22: no {name} launch")
    sbm = SbmHashStream(22, 64, 0.05, 16, 42)
    sd = multi[0].diagnostics
    print("sbm22 " + json.dumps({
        "spec": SBM22_SPEC, "ks": list(SBM22_KS), "wall_s": sbm_wall,
        "phase_s": multi[0].phase_times,
        "further_k_phase_s": {r.k: r.phase_times for r in multi[1:]},
        "edge_cut": {r.k: r.edge_cut for r in multi},
        "cut_ratio": {r.k: r.cut_ratio for r in multi},
        "planted_cut_ratio": {k: sbm.planted_cut_ratio(k) for k in SBM22_KS
                              if sbm.n_blocks % k == 0},
        "comm_volume": {r.k: r.comm_volume for r in multi},
        "balance": {r.k: r.balance for r in multi},
        "total_edges": multi[0].total_edges,
        "dispatch_batch": sd["dispatch_batch"],
        "inflight": sd["inflight_depth"],
        "device_rounds": sd["device_rounds"], "host_syncs": sd["host_syncs"],
        "hash_chunk_launches": sbm_launches["hash_chunk"],
        "launches": sbm_launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "card": card}), flush=True)

    # 5g. the planted graph at full size through the CLI with the quality
    # advisor's recipe: level 0, eight level-1 parts, the final refine
    hier = hier_s22(card, counters)
    # a pass of the final refine (k = 64, 16 chunks) against the kernels'
    # time in it at the phase 3g cases
    final = hier["calls"][-1]
    refine_head = {
        name: recs[0] if name.startswith("plan_moves") else
        next(r for r in recs if r["case"] in ("sbm-k64",
                                              f"rows{n22 + 1}-k64"))
        for name, recs in refine_cases.items()}
    pass_s = final["seconds"] / max(final["passes"], 1)
    kernels_s = (final["chunks_a_pass"] * refine_head["neighbor_hist"]["ms"]
                 + refine_head["hist_stats"]["ms"]
                 + refine_head["plan_moves"]["ms"]) / 1e3
    print("hier22-pass " + json.dumps({
        "final_refine_s": final["seconds"], "passes": final["passes"],
        "pass_s": pass_s, "kernels_s_a_pass": kernels_s,
        "kernels_share": kernels_s / pass_s, "card": card}), flush=True)

    # 5h. faults at full size: kill and resume, a real out-of-memory error,
    # the cache on a file
    s22_faults(card)
    # 5i. phase 5's build traced, in turns with untraced builds, through
    # the CLI with its trace, heartbeat and metrics, and profiled
    traced_s22(card, res, wall, peak)
    # 5j. incremental epochs at full size: the fold against the one-shot
    # delta: build, compaction against a clean build, audited scoring,
    # and CUDA against the CPU at s16
    incr = incremental_s22(card, counters)
    # 5k. R-MAT at scale 24 at the defaults: the batched build on the
    # stream descent
    s24 = s24_build(card, counters)
    # 5l. the sharded build: 4 shards on the card, per segment and
    # batched, and the entry point on one shard, each equal to phase 5
    t0 = time.perf_counter()
    sharded = sharded_s22(card, res, counters)
    print(f"5l: {time.perf_counter() - t0:.1f}s", flush=True)
    # 5m. the vertex-sharded build: 4 shards on the card at the backend's
    # defaults, equal to phase 5; a lifting and a tail round's launches;
    # the hoisted stack at s20 against the torch backend
    t0 = time.perf_counter()
    bigv = bigv_s22(card, res, counters)
    bigv["round_launches"] = round_launches()
    bigv_hoisted(card)
    # the one card's two round paths on one graph, against the torch
    # backend: one CardRound a round, and the collectives card after card
    small = sheep_tpu_torch.partition(BIGV_PATHS_SPEC, S22_K, device="cuda",
                                      keep_tree=True)
    for one_call in (True, False):
        bigv_s22(card, small, counters, spec=BIGV_PATHS_SPEC,
                 card_rounds=one_call,
                 label="4-on-1" if one_call else "4-on-1-collectives")
    print(f"5m: {time.perf_counter() - t0:.1f}s", flush=True)
    # 5n. two processes on the card (gloo with host staging), two shards
    # each: the s22 sharded build per segment and batched, s18 through
    # bigv, as text by byte spans, and killed then resumed
    t0 = time.perf_counter()
    multiprocess_runs(card, res, small)
    print(f"5n: {time.perf_counter() - t0:.1f}s", flush=True)

    # 6. every kernel: the launches are the main path's (phase 5); K2's
    # and K3's the probe tool's (phase 3b), stream_descent's the
    # per-segment build's warm segments (5d) with the stream descent's
    # batched builds (4b, 5k) beside them
    def entry(name, source, replaces, rec, launches, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec.get("bound_by", "bytes"),
                "library_ms": rec["library_ms"],
                "case": rec.get("form", rec.get("case")), **extra}

    def gather_cases(kernel):
        return {name: {k: r.get(k) for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "chain_bound_ms",
            "sector_bytes")}
            for name, r in cases.items() if r["kernel"] == kernel
            and r.get("form") not in ("P2_E_with_router",
                                      "P2_E_router_unroute")}

    def max_err(kernel):
        return max(r["max_abs_err"] for r in cases.values()
                   if r["kernel"] == kernel)

    square = cases["square"]
    fix_src = "sheep_tpu_torch/csrc/fixpoint.cu"
    all_descents = descent_cases + forest_descents + s24["descents"]
    kernels = [
        # at the main path's case (the read before the scatter); the
        # climb and squaring shapes it ran before the lifting kernels
        # beside it
        entry("gather_clip", "sheep_tpu_torch/csrc/gather.cu",
              "sheep_tpu/ops/pallas_gather.py:70", k1_case,
              launches["gather_clip"],
              also_replaces=["tools/pallas_smoke.py:166 (form D)"],
              climb_ms=cases["climb"]["ms"],
              climb_bound_ms=cases["climb"]["bound_ms"],
              square_ms=square["ms"], square_bound_ms=square["bound_ms"],
              tool_launches=tool_launches["K1"],
              cases_max_abs_err=max_err("K1")),
        # K2 at its bulk case, K3 at P2's kernel leg; the probe forms and
        # the redesign's cases beside them, each with its chain bound
        entry("take_rows", "sheep_tpu_torch/csrc/gather2d.cu",
              "tools/pallas_smoke.py:166", cases["K2-bulk"],
              tool_launches["K2"], cases_max_abs_err=max_err("K2"),
              chain_bound_ms=cases["K2-bulk"]["chain_bound_ms"],
              cases=gather_cases("K2")),
        entry("take_along", "sheep_tpu_torch/csrc/gather2d.cu",
              "tools/pallas_smoke.py:336", cases["P2_E_kernel_only"],
              tool_launches["K3"],
              also_replaces=["tools/pallas_smoke.py:166 (forms B, C, E)",
                             "tools/pallas_smoke.py:420"],
              chain_bound_ms=cases["P2_E_kernel_only"]["chain_bound_ms"],
              sector_bytes=cases["P2_E_kernel_only"]["sector_bytes"],
              cases_max_abs_err=max_err("K3"), cases=gather_cases("K3"))]
    # launches from the main path (phase 5), the per-segment build's (5d:
    # lift_stack once a stale segment, a warm segment none) beside them
    kernels += lift_entries(main_case, lift_cases + [main_case],
                            launches, forest_case)
    for k in kernels[-2:]:
        k["batched_launches"] = launches[k["name"]]
        k["per_segment_launches"] = seg_launches[k["name"]]
        k["also_replaces"].append("sheep_tpu/ops/elim.py:222 (B3, the "
                                  "stale round: the stack once a segment, "
                                  "the climb every round)")
    scatter_all = scatter_cases + [main_scatter]
    kernels += [
        entry("scatter_min", fix_src, "sheep_tpu/ops/elim.py:149",
              main_scatter, launches["scatter_min"],
              library_scope="torch.where dead-slot index + scatter_reduce_",
              cases={r["case"]: {k: r[k] for k in (
                  "ms", "plain_ms", "library_ms", "bound_ms", "live")}
                  for r in scatter_all},
              cases_max_abs_err=max([r["max_abs_err"] for r in scatter_all]
                                    + [rows_err])),
        # folded into climb_tail's last block: no launch of its own, its
        # time the fused pass's less the same pass's without it at the
        # main case, signed (within the noise it can fall below 0)
        entry("round_end", "sheep_tpu_torch/csrc/lift.cu",
              "sheep_tpu/ops/elim.py:467", {
                  "max_abs_err": main_case["fused_max_abs_err"],
                  "ms": main_case["fused_ms"] - main_case["unfused_ms"],
                  "plain_ms": main_case["round_end_plain_ms"],
                  "bound_ms": main_case["round_end_bound_ms"],
                  "library_ms": None, "case": main_case["case"]}, 0,
              folded_into="climb_tail",
              fused_climb_ms=main_case["fused_ms"],
              unfused_climb_ms=main_case["unfused_ms"],
              rounds_compared=fused_compared),
        entry("exec_finish", fix_src, "sheep_tpu/ops/elim.py:486",
              exec_cases["exec_finish"], launches["exec_finish"],
              cases={r["case"]: {k: r[k] for k in (
                  "ms", "plain_ms", "bound_ms")}
                  for r in exec_cases["exec_finish"]["cases"]}),
        # at the s22 forest's table at the main path's median share, L =
        # 23; launches on the per-segment build's warm segments (5d), the
        # forced stream descent's (4b) and the s24 build's (5k) beside
        # them; every phase 3d and 5b case beside it, and the stopped one
        entry("stream_descent", "sheep_tpu_torch/csrc/lift.cu",
              "sheep_tpu/ops/elim.py:166", forest_descents[0],
              seg_launches["stream_descent"],
              also_replaces=["sheep_tpu/ops/pallas_gather.py:70 (B1 in the "
                             "stream descent's climb and squaring)"],
              library_scope="torch.take(t, t), one squaring level",
              forced_stream_launches=stream_launches,
              s24_launches=s24["launches"]["stream_descent"],
              stopped_ms=descent_stopped["ms"],
              cases={r["case"]: {k: r[k] for k in (
                  "ms", "plain_ms", "library_ms", "bound_ms", "live",
                  "levels_squared", "round_ms")}
                  for r in all_descents},
              cases_max_abs_err=max(r["max_abs_err"] for r in
                                    all_descents)),
        # on the jump-mode fold of phase 4d (the s22 per-segment build
        # finishes its tails on the host before any small segment); the
        # chain bound (launch floor + the longest chain's loads at the
        # load latency) beside the bytes bound
        entry("climb_jumps", "sheep_tpu_torch/csrc/lift.cu",
              "sheep_tpu/ops/elim.py:359", jumps_cases[0],
              jump_launches["climb_jumps"],
              s22_launches=seg_launches["climb_jumps"],
              mode_of="climb_tail",
              **{k: jumps_cases[0][k] for k in (
                  "chain_bound_ms", "chain_loads", "floor_ms",
                  "load_latency_ms")},
              cases={r["case"]: {k: r[k] for k in (
                  "ms", "plain_ms", "bound_ms", "chain_bound_ms",
                  "chain_loads", "steps_loaded_mean")}
                  for r in jumps_cases},
              cases_max_abs_err=max(r["max_abs_err"] for r in jumps_cases)),
        # on the per-segment build (5d), at a 10% live share; the other
        # shares beside it
        entry("compact_live", "sheep_tpu_torch/csrc/compact.cu",
              "sheep_tpu/ops/elim.py:1055", compact_cases[1],
              seg_launches["compact_live"],
              library_scope="torch.unique of the packed keys + a masked "
                            "select of the live ones",
              device_launches_a_call=compact_cases[1]["device_launches"],
              cases={r["case"]: {k: r[k] for k in (
                  "ms", "plain_ms", "library_ms", "bound_ms",
                  "device_launches", "live", "size", "kept_dups_ms")}
                  for r in compact_cases},
              cases_max_abs_err=max(r["max_abs_err"]
                                    for r in compact_cases))]
    # the chunk synthesis, one entry a mode: R-MAT on the main path (5),
    # SBM on the planted build (5f); no library call computes the hash
    synth_src = "sheep_tpu_torch/csrc/synth.cu"
    for mode, head, launched, replaces, also in (
            ("rmat", "rmat-s22", launches["hash_chunk"],
             "sheep_tpu/io/generators.py:252",
             "sheep_tpu/io/generators.py:241 (_device_chunk_fn)"),
            ("sbm", "sbm-s22-b64", sbm_launches["hash_chunk"],
             "sheep_tpu/io/generators.py:551",
             "sheep_tpu/io/generators.py:542 (_sbm_device_chunk_fn)")):
        mode_cases = [r for r in synth_cases.values() if r["mode"] == mode]
        kernels.append(entry(
            f"hash_chunk<{mode}>", synth_src, replaces, synth_cases[head],
            launched, also_replaces=[also], replaces_kind="XLA program",
            ops_bound_ms=synth_cases[head]["ops_bound_ms"],
            bytes_bound_ms=synth_cases[head]["bytes_bound_ms"],
            sass_ops_per_row=synth_cases[head]["sass_ops_per_row"],
            cases={r["case"]: {k: r[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "count")}
                for r in mode_cases},
            cases_max_abs_err=max(r["max_abs_err"] for r in mode_cases)))
    # the refinement's kernels: launches on the hierarchy at full size (5g),
    # each at the phase 3g case of its final refine (k = 64); the
    # histogram's and the statistics' counts are wrapper calls, each of
    # which launches device_launches_a_call kernels (phase 3g's witness)
    refine_src = "sheep_tpu_torch/csrc/refine.cu"
    for name, replaces, also, scope in (
            ("neighbor_hist", "sheep_tpu/ops/refine.py:42",
             ["sheep_tpu/ops/refine.py:63 (neighbor_hist_block)"],
             "torch.bincount of the precomputed row * k + part keys"),
            ("hist_stats", "sheep_tpu/ops/refine.py:83", [],
             "torch.max(dim=1) + torch.gather"),
            ("plan_moves", "sheep_tpu/ops/refine.py:100", [],
             "torch.sort(stable=True) of the planner's 64-bit keys")):
        recs = refine_cases[name]
        head = refine_head[name]
        calls = hier["launches"][name]
        extra = {"calls": calls,
                 "device_launches_a_call": head["device_launches"],
                 "device_launches": calls * head["device_launches"]}
        keys = ("ms", "plain_ms", "library_ms", "bound_ms",
                "device_launches")
        kernels.append(entry(
            name, refine_src, replaces, head, calls,
            also_replaces=also, replaces_kind="XLA program",
            library_scope=scope, **extra,
            cases={r["case"]: {k: r[k] for k in keys} for r in recs},
            cases_max_abs_err=max(r["max_abs_err"] for r in recs)))
    # the delta fold's launches (5j, epochs 1-4) and the sharded builds'
    # (5l) beside the main path's
    for k in kernels:
        if k["name"] in DELTA_KERNELS:
            k["delta_path_launches"] = incr["delta_launches"][k["name"]]
        name = "hash_chunk" if k["name"] == "hash_chunk<rmat>" else k["name"]
        if name in SHARDED_PATH + SHARDED_SEGMENT_PATH:
            k["sharded_launches"] = {label: launched[name] for label,
                                     launched in sharded.items()}
    # the routed round (B14): launches from 5m, each at its head case of
    # 3h with the others beside it (the scatter's answers mode, that of
    # several cards, among them); the climb's chain bound and the
    # scatter's yardstick of three library calls beside the head's
    for name, head in (("owned_gather", "Q-live1"),
                       ("owned_scatter_min", "card-forest"),
                       ("routed_step", "B-square"),
                       ("routed_climb", "tail-random-live1"),
                       ("routed_square", "B-random"),
                       ("routed_round_end", "forest")):
        recs = routed_cases[name]
        rec = next(r for r in recs if r["case"] == head)
        kernels.append(entry(
            name, BIGV_SOURCE, BIGV_REPLACES[name], rec,
            bigv["launches"][name], replaces_kind="XLA program",
            library_scope=BIGV_LIBRARY.get(name, "none"),
            lift_round_launches=bigv["round_launches"]["lift"][name],
            tail_round_launches=bigv["round_launches"]["tail"][name],
            **{k: rec[k] for k in ("chain_bound_ms", "yardstick_ms")
               if k in rec},
            cases={r["case"]: {k: r.get(k) for k in (
                "ms", "plain_ms", "library_ms", "bound_ms",
                "chain_bound_ms", "yardstick_ms")}
                for r in recs},
            cases_max_abs_err=max(r["max_abs_err"] for r in recs)))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}  total {time.perf_counter() - t_all:.1f}s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(sharded_cards() if sys.argv[1:] == ["--sharded-cards"]
             else multiprocess_only() if sys.argv[1:] == ["--multiprocess"]
             else main())
