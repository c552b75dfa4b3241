#!/usr/bin/env python3
"""Smoke run of jepsen_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the Hopper kernels from ``jepsen_tpu_torch/ops/csrc``, holds each
against its plain torch version on the card (bit-equal: they are boolean
operators and integer scans), and drives the main paths through
``linearizable(accelerator="gpu")``, each with the launch counts set to 0
just before it and read just after:

* the 10k-op, 5-process, 5-value headline history: the ``torch-matrix``
  rung, through the chunk-product and combine kernels;
* its corrupted copy with ``explain`` off: the matrix rung leaves it to
  the ``torch-frontier`` rung, which settles it on the dense-table kernel
  with the CPU twin's failing op;
* the corrupted copy with ``explain`` on (the default): the matrix rung
  localizes the first anomaly on the card (a second chunk-product
  launch, the ``prefix_alive`` chain, the ``window_rescan`` of the first
  dead chunk) and settles it at ``torch-matrix`` with the same failing
  op; the witness shrink's rounds are rescans. Both forensics kernels are
  first held bit-equal to their plain versions on the cases of
  ``ops.forensics_compare``: seeded chunk products (C = 256 at MV = 256,
  512 and 1024, C = 16 at MV = 4096; a dead chunk early, late and none,
  and a dense frontier dying late, for each design of the chain: one
  warp, a cluster's ring, a cluster reading global memory), seeded
  rescan inputs (S up to 8, V up to 32, K up to 128: the warp path and
  the shared-memory path), and the corrupted headline's first dead chunk
  (found by the plain versions alone) for K = 1, 4 and 128 candidates;
  both add a row to the ``kernels`` line, with the design that ran
  (``path``);
* a 10k-op, 5-process history whose every write is a fresh value (more
  than 512 states, so the dense table is out of regime), valid and
  corrupted: the frontier rung on the sparse-frontier kernel;
* a history with S = 6 slots and V = 16 states (MV = 1024): the matrix
  rung's batched-product route above the kernels' MV = 512, one-shot and
  resumed over two quiescent segments;
* the Elle checks: ``list_append.check(accelerator="gpu")`` on bench.py's
  50k-txn list-append history, valid (settled by the φ screen, no
  launch), with 50 crossed pairs at the end, and with the pairs 900 txns
  apart (50 clusters of about 900 nodes: the cluster-screen kernel); the
  anomalous graph without φ (the global path: the trim kernel); and a
  10k-txn rw-register history with wr cycles, each against the port's
  cpu oracle. Both Elle kernels are first held against their plain
  versions on random graphs and clusters and on the main path's inputs
  (the trim also on a graph of 2^19 nodes and 2^20 edges, past the
  "auto" mode's TRIM_DEVICE_MIN_EDGES; the screen through its public
  wrapper and through the main path's host route, also on 5,000
  clusters, past the sort's shared-memory bins), each with its own count
  of its work held equal to the plain version's; one wide-window screen
  call is split into its upload, sort and offsets, peel and read-back;
* BASELINE config 3, ``independent.checker(linearizable(accelerator=
  "gpu"))``: 64 keys of 1k ops valid and with 8 keys corrupted (one
  key-batched dense launch), 16 fresh-value keys (one key-batched sparse
  launch), 1,024 keys of 500 ops, and the native lane against the Python
  twin;
* BASELINE config 4, ``set_full(accelerator="gpu")`` on bench.py's
  20,000-element history with a read every 50 adds (400 reads): valid,
  with planted loss and staleness (``linearizable=True``: invalid), and
  that copy with its times moved past 10^11 ns, each equal to the port's
  ``"cpu"`` walk key for key, with one launch of the set-classify kernel
  a check. The kernel is first held bit-equal to its plain version on
  seeded packed words at 1 x 1, 7 x 33, 400 x 20,000 and 2,048 x 262,144
  (reads x elements), at 400 x 20,000 with the read times drawn from 8
  values, at a tall, narrow 4,096 x 96, and on the main path's own
  inputs, as they are and with the reads listed last first;
* the multi-register slice (the multi-key-acid workload, K = 3 keys x
  V = 5 values, 216 states): ``independent.checker(compose({"linear":
  linearizable(model=MultiRegister(), accelerator="gpu")}))`` on 500
  keys of 20 txns on 10 processes each, valid and with 10 keys given an
  impossible read, each key's verdict and failing op equal to the port's
  ``accelerator="cpu"`` run, one frontier launch a key (dense table for
  S <= 9, sparse list for S = 10; no matrix launch); a 10k-txn history
  on 5 processes (the dense table's CTA path), its copy with two
  impossible reads (the kernel's death event equal to the twin's) and
  copies whose late writes crash to S = 10 (the sparse list); each
  frontier kernel and batched entry with the multi-register transition
  against its plain version on 1k-txn histories ((3, 5) dense CTA path,
  (2, 3) dense warp path, (3, 5) sparse list; B = 8), path counts
  included; and the (2, 3) shape (16 states) through ``torch-matrix``.
  Each frontier row of the ``kernels`` line gains a ``multi_register``
  entry (ms, launches on the 500-key check, bound);
* resumable long checks: the headline's shape at 700k ops (1,133,736
  events, past MATRIX_SEGMENT_EVENTS = 2^20) through ``linearizable(
  accelerator="gpu")``: the matrix chain's two segments (one chunk
  product and one combine launch each), its last carry bit-equal to a
  one-shot ``matrix_check_resume`` total, the verdict the twin's; a copy
  with a read answering 999 in the second segment (two segments, then a
  localization over the whole stream, chunks of T = 4,096 returns) and
  one with it in the first (one segment), each with the twin's failing
  op; the chain writing ``check.ckpt`` and resuming from it (one segment
  of two, the same carry), and the checker resuming a planted checkpoint
  through its test map and clearing it; ``segmented_check`` on the dense
  table (the long history) and the sparse list (100k fresh-value ops,
  segments of 2^16 events) against one launch on the whole stream, the
  frontier at the last cut and the final one equal; and the chain's
  carry at the first cut seeding the CPU twin, which finishes with the
  twin's verdict. The chunk product and combine rows gain
  ``launches_segmented``, the frontier rows ``segmented_ms``, the
  forensics rows the long localization's times.
* stored-run re-checks (``stored_recheck`` lines): in a temporary store,
  the port's ``write_history`` and ``write_columnar`` write the headline
  and its copy with two corrupted reads, bench.py's 50k-txn list-append
  history and its copy with 50 crossed pairs, and phase 12's long
  history; each is re-checked with ``check_stored(accelerator="gpu")``
  (median of 5, 3 for the long history) and must give its live check's
  verdict and failed op, or result map without ``builder``: the valid
  copies in the stored lane (``(stored)``, ``columnar-store``), the
  invalid ones through the jsonl. Each line has the store's write
  seconds, the sidecar load's, the launches and the profiler's kernels.
  The live 50k-txn check runs through the C parser and through the numpy
  front in turns, with equal result maps (``stored_recheck_fronts``: each
  one's ``build`` seconds). Every row of the ``kernels`` line gains
  ``launches_stored``.
* checking across devices (``mesh*`` lines), on ``Mesh([cuda:0] * 4)``:
  four shards on the one card, which check the sharded math and give no
  speed-up. The headline, its corrupted copy and phase 12's long history
  (its encoded stream, not encoded again) through ``matrix_check`` and
  ``matrix_check_resume`` with the mesh, and the long one through
  ``matrix_check_segmented`` with it: verdicts and bf16 carries bit-equal
  to one device's, a chunk-product and a combine launch a shard and a
  dispatch; config 3's corrupted 64 keys (a batched dense launch a
  shard for the 8 undecided keys), the 1,024 keys and 63 of them (a
  padding key) through ``batch_check(mesh=)``, key for key equal to one
  device's; ``checker_sharded: True`` (``auto_mesh`` given the card four
  times): the headline settles at ``torch-sharded-matrix``, its
  corrupted copy there with the unsharded check's failed op, and
  ``independent.checker`` on config 3 reports ``jitlin-gpu-sharded``;
  the sharded trim on phase 8's 50k-txn edges and the seeded 2^19-node,
  2^20-edge graph against its plain rounds on the card, on both routes:
  the one-card route (one ``scc_trim`` launch, no round launch) and the
  rounds driven without a reduce (``ops.scc.trim_rounds``: one partial
  launch a shard and one update a round), with placement and peel timed
  apart; ``trim_degrees.cu``'s two entries against their plain versions
  (two rows of the ``kernels`` line, each entry's profiler list one
  kernel and no memset); the routing: ``auto_mesh()``, the
  measured round trip, the "auto" lanes of config 3 and of 3 keys, and
  the 1,024-key batch's pipeline stats. Then two processes on the card
  (``distributed`` line; gloo, a ``file://`` init method, each child
  this script with ``--distributed-worker``): ``batch_check_distributed``
  on config 3 and ``trim_to_cycles_distributed`` on the 50k-txn edges,
  equal to one process's results. Every row of the ``kernels`` line
  gains ``launches_mesh``.
* the run's shared history IR and live checking (phase 16): the
  headline checked twice on one test map (one encode and no column
  build; the second check reads the IR's stream) against
  ``ir_enabled: False`` (``history_ir_shared``), the IR's canonical columns on the card and on
  ``Mesh([cuda:0] * 4)``, bit-equal to the host's, with a memo hit
  (``device_columns``), config 3 through the IR's ``subhistories``, key
  for key equal to the split path (``history_ir_config3``); then, from
  WALs written in parts and tailed by ``journal.WalTailer``: the
  headline and its corrupted copy in 10 polls through
  ``live.LinearLiveSession(accelerator="gpu")`` (``live_register``: one
  chunk-product and one combine launch a screened poll, the corrupted
  copy localized once on the card and latched, every poll's verdict
  the CPU twin's), config 3's corrupted copy in 4 polls through
  ``MultiKeyLinearSession`` (``live_independent``, equal to the batch
  check), the 50k-txn list-append histories in 5 polls through
  ``ElleSession`` (``live_elle``: ``finalize`` equal to
  ``list_append.check(accelerator="gpu")`` without ``builder``). Every row of the ``kernels`` line gains
  ``launches_live``.
* telemetry (phase 17, run between phases 13 and 14, which hand it the
  long history): a live ``telemetry.Registry`` and a
  ``trace.RunTracer`` (a Perfetto sink and a flight recorder in a
  temporary store directory) on the headline check (null and live in
  20 alternating pairs; the live registry's cost, the median of the
  pairs' ratios, must stay at or under 10 %), its corrupted copy with
  ``explain`` on, the long history's chain writing ``check.ckpt``
  and the check resuming from it, and config 3's 64 keys; each result
  map and each kernel's launches equal to the same check's with the null
  registry; the registry's counts (``checker_backend_total``,
  ``checker_resume_total{source="ckpt"}``,
  ``checker_ckpt_writes_total``, ``explain_total``,
  ``dispatch_batches_total``), the device memory high-water against the
  card's memory, ``trace.json`` strict JSON with the ``segment``,
  ``ckpt-write``, ``ckpt-resume``, ``explain`` and ``rung`` events, the
  flight recorder's dump holding its ring, and a
  ``telemetry.profiler_trace`` of one headline check naming the
  chunk-product and combine kernels. Every row of the ``kernels`` line
  gains ``launches_telemetry``.
* the live daemon over the native ingest spine (phase 18, after phase
  16): the headline, its corrupted copy and config 3 at 16 keys of
  1,000 ops, each appended to its run's ``history.wal.jsonl`` in a
  twentieth of the run a poll (1,000 ops for the headline, 1,600 for
  config 3) between polls of one ``live.LiveDaemon(store_root,
  accelerator="auto")``, then settled by ``run_until_idle`` once each
  ``history.jsonl`` lands (``daemon`` line: each poll's ms, the final
  statuses, the spine's fallback counts, the launches, and those of the
  config-3 run's own checks). Each run's final verdict must be the
  offline check's (the corrupted copy's first anomaly the CPU twin's
  failed op), no tracker may break, no frontier may bail out of the C,
  and the headline runs' checks must launch the chunk-product and
  combine kernels inside the polls. Config 3's keys stay below the
  screen's ``MATRIX_MIN_RETURNS`` (about 800 returns a key against
  2,000), so its run checks on the CPU frontier, in C.
  ``ingest_rates`` times the C spine against its Python twins: the WAL
  scan of 200,000 lines (``parse_wal_chunk`` against
  ``parse_wal_chunk_py``), the live register encode of the same ops,
  and the frontier closure of the headline's stream. Every row of the ``kernels`` line gains
  ``launches_daemon``.
* a suite's composed check (phase 19, ``suite_phase``, after phase 18):
  the host checkers and reports around the register check on the card,
  as ``suites.compose_test`` and the register workload compose them.
  19a: config 3's 64 keys of 1,000 ops with 8 corrupted, through
  ``compose({stats, exceptions, workload: independent.checker(compose(
  {linear: linearizable(accelerator="gpu"), timeline})), perf,
  clock})``; 19b: the corrupted headline through ``compose({stats,
  exceptions, workload: linearizable(accelerator="gpu"), perf,
  timeline})`` with ``explain`` on. Each run has a seeded nanosecond
  clock, a ``start``/``stop`` and a ``start-partition``/``stop-
  partition`` window with their ``faults.jsonl`` rows, and five
  ``check-offsets`` ops, and is held against the same composition with
  ``accelerator="cpu"``: verdicts, maps key by key and every file
  (timelines byte for byte, ``anomaly.json``, PNG pixels where
  ``matplotlib`` imports; without it the PNG reports must give the
  reference's "unknown" and ``plot`` None). The ``suite`` line has the
  host ms of each compose, of each part alone and of the 64 timeline
  pages, the files and the launches; every row of the ``kernels`` line
  gains ``launches_suite``.
* the run loop (phase 20, ``run_phase``, after phase 19): two whole
  test runs through the port's ``core.run`` over the dummy remote, the
  etcd suite's fake test map as ``compose_test`` builds it (nodes n1-n5,
  concurrency 5, ``NoopNet``, ``KVStore``, the register workload at its
  defaults, the partition, kill and pause packages at a 1 s interval,
  ``compose({stats, exceptions, workload, perf})``, a 10 s time limit,
  the generator's context and the nemesis draws seeded). 20a's client is
  the fake register client: valid, with the chunk product and the
  combine launched and no key left undecided by the matrix screen. 20b's
  is a stale-read double (one read in 500 answers with the key's
  previous value): invalid, with the undecided keys in one
  ``frontier_dense_batch`` launch. Each run's stored history is
  re-checked with ``accelerator="cpu"`` (verdict, invalid keys and every
  key's failed op equal), and its store must hold ``history.jsonl``,
  ``results.json``, ``test.json`` and a ``faults.jsonl`` whose windows
  all healed, and no WAL. The ``run`` line gives each run's ops, keys,
  ops/s of ``run_case``, the seconds of ``run_case``, ``analyze`` and
  the workload's check, the check's share of the run's wall, the files
  and the launches; every row of the ``kernels`` line gains
  ``launches_run``.
* the workloads (phase 21, ``workloads_phase``, after phase 20): the
  kits whose checks reach the card, each through ``core.run`` in the
  yugabyte suite's fake test map (``run_test_map`` with the kit's config
  keys and final generator; 5 nodes, and 3 for a second run of each acid
  kit, whose key groups are 2n threads wide; 5 threads for the rest; a 3
  s time limit; accelerator "gpu"), once with the honest fake client
  (valid) and once with a seeded double that breaks one answer in
  ``BREAK_EVERY`` (invalid): single-key-acid (phase 20b's stale read;
  the batched lane: the matrix screen, or one key-batched frontier
  launch for all keys when the batch's slots rule the screen out, as at
  5 nodes), multi-key-acid (a stale key in a read txn; a frontier launch
  a key, no dense-route key in the exact twin and, at 3 nodes, the
  broken run's keys settled on the dense table: ROADMAP Queue 3 item 4's
  repair), set-full (a lost add; one ``set_classify``), append (a read
  dropping the key's latest append) and wr (a stale read of a version
  whose successor a read-then-write txn showed), both with a
  ``cluster_screen`` launch in the invalid run. Each stored history is
  re-checked with ``accelerator="cpu"`` (the acid kits' verdicts,
  invalid keys and failed ops; set-full's map; the Elle kits' verdicts
  and anomaly types) and each store must be whole. The ``workloads``
  line gives each run's ops/s of ``run_case``, the check's seconds and
  share of the wall, the verdict and the launches; every row of the
  ``kernels`` line gains ``launches_workloads``, which ``launches_run``
  also counts. A ``total`` line after it gives the script's seconds.

Earlier phases keep their shapes, but for phase 9's 1,024 keys (500 ops
a key, half of bench.py's depth).
Every phase's line carries ``t_s``, the script's seconds so far.

Prints one JSON line per phase, then a ``kernels`` line, the card's name
and power limit, and as its last line ``{"ok": true, "device": {...}}``.
Any failure raises, so the exit code is not 0. Without a CUDA device it
exits 1 and prints no result.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

T_START = time.perf_counter()
N_OPS, N_PROCS, N_VALUES, SEED = 10_000, 5, 5, 42
# values drawn from a domain this wide make every write a fresh value
FRESH_VALUES = 10 ** 9
# H100 SXM published peaks (dense): int8 tensor rate, float32 rate outside
# the tensor cores (the rate used for the scans' 32-bit integer operations)
# and HBM bandwidth
PEAK_INT8_OPS = 1979e12
PEAK_BF16_OPS = 989e12
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12


def emit(obj) -> None:
    """Prints ``obj`` as one JSON line; a phase's line gains ``t_s``, the
    script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls, after
    one warm-up call, timed with CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_chunk_inputs(S, V, T, G, U, seed, kind="live"):
    """Seeded chunk-product inputs on the card; about a fifth of the
    steps are padding (valid = 0), slots cover 0 .. S-1, and the
    returning slot is pending, as in a real history (else the kill
    empties every product). ``kind`` reshapes them: "write" makes every
    slot pending at every valid step and every op a write (one all-ones
    transition row, the densest closure rows); "one_state" lets every op
    keep the state (for V = 1); "padding_chunk" makes chunk 0 all
    padding."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    pend = rng.random((T, G, S)) < 0.5
    slots = rng.integers(0, S, (T, G)).astype(np.int32)
    np.put_along_axis(pend, slots[..., None], True, axis=2)
    pend, ids, mtT, slots, valid = (
        pend, rng.integers(0, U, (T, G, S)).astype(np.int32),
        (rng.random((U, V, V)) < 0.3).astype(np.float32), slots,
        (rng.random((T, G)) < 0.8))
    if kind == "write":
        pend[:] = True
        mtT[:] = 0.0
        mtT[np.arange(U), np.arange(U) % V, :] = 1.0
    elif kind == "one_state":
        mtT[:] = 1.0
    elif kind == "padding_chunk":
        valid[:, 0] = False
    if T * G > 1 and slots.max() != S - 1:
        raise AssertionError("the slots must reach S - 1")
    return [torch.from_numpy(a).cuda()
            for a in (pend, ids, mtT, slots, valid)]


def check_chunk_product(name, S, V, T, G, U, seed, kind="live"):
    import torch
    from jepsen_tpu_torch.ops import matrix_kernels as mk
    args = random_chunk_inputs(S, V, T, G, U, seed, kind)
    got = mk.chunk_product(*args, S, V)
    ref = mk.chunk_product_torch(*args, S, V)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, ref))
    ones = int(ref.float().sum().item())
    emit({"phase": "chunk_product", "case": name, "kind": kind, "S": S,
          "V": V, "MV": (1 << S) * V, "T": T, "G": G, "U": U,
          "equal": equal, "ones": ones})
    if not equal:
        raise AssertionError(f"chunk_product {name} differs from plain")
    if ones == 0:
        raise AssertionError(f"chunk_product {name}: inputs test nothing")


# combine cases: (B, C, MV, density of P, P holds the identity, tot0 is
# the identity (else random), seed). C = 0, 1 and 2, odd C (a node is
# carried up the tree), B > 1, MV from 16 (one partly filled word) to
# 512, saturating and all-zero P.
COMBINE_CASES = [
    (1, 256, 256, 0.02, True, True, 5), (4, 8, 512, 0.02, True, False, 6),
    (2, 0, 64, 0.02, True, False, 7), (1, 1, 256, 0.02, True, False, 8),
    (1, 2, 256, 0.006, False, True, 9), (1, 37, 256, 0.006, False, False, 10),
    (1, 255, 256, 0.006, False, False, 11),
    (3, 16, 128, 0.012, False, False, 12), (2, 7, 16, 0.1, False, False, 13),
    (1, 9, 64, 0.025, False, False, 14), (2, 33, 128, 0.012, False, True, 15),
    (1, 37, 512, 0.003, False, True, 16), (1, 37, 256, 0.5, False, False, 17),
    (2, 8, 256, 0.0, False, False, 18)]


def check_combine(B, C, MV, density, p_eye, eye_start, seed):
    import numpy as np
    import torch
    from jepsen_tpu_torch.ops import matrix_kernels as mk
    rng = np.random.default_rng(seed)
    P = torch.from_numpy(rng.random((B, C, MV, MV)) < density).cuda()
    if p_eye:
        P = P | torch.eye(MV, dtype=torch.bool, device="cuda")
    if eye_start:
        tot0 = torch.eye(MV, device="cuda").expand(B, MV, MV)
    else:
        tot0 = torch.from_numpy(rng.random((B, MV, MV)) < 0.05).cuda()
    P, tot0 = P.to(torch.bfloat16), tot0.to(torch.bfloat16)
    got = mk.combine_product(P, tot0)
    ref = mk.combine_product_torch(P, tot0)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, ref))
    ones = int(ref.float().sum().item())
    emit({"phase": "combine_product", "B": B, "C": C, "MV": MV,
          "density": density, "equal": equal, "ones": ones})
    if not equal:
        raise AssertionError(f"combine_product {(B, C, MV)} differs")
    if (ones == 0) != (density == 0.0 and not p_eye and C > 0):
        raise AssertionError(f"combine_product {(B, C, MV)}: {ones} ones")


def crashed(history, every):
    """A copy in which every ``every``-th ok completion of a write or cas
    becomes info: a crashed op stays pending for good."""
    out, n = [], 0
    for op in history:
        op = dict(op)
        if op["type"] == "ok" and op["f"] != "read":
            n += 1
            if n % every == 0:
                op["type"] = "info"
        out.append(op)
    return out


def card_events(stream):
    """The stream's event columns as int32 tensors on the card."""
    import numpy as np
    import torch
    return [torch.as_tensor(np.asarray(x), dtype=torch.int32, device="cuda")
            for x in (stream.kind, stream.slot, stream.f, stream.a,
                      stream.b)]


def frontier_err(got, ref) -> float:
    """The largest absolute difference between a frontier kernel's
    results and its plain version's, over the four scalars and the final
    frontier (0 when bit-equal; inf when a dtype or shape differs)."""
    import torch
    err = 0.0
    for x, y in zip(got, ref):
        if x.dtype != y.dtype or x.shape != y.shape:
            return float("inf")
        if x.numel():
            err = max(err, float((x.to(torch.int64) - y.to(torch.int64))
                                 .abs().max().item()))
    return err


# frontier cases: (name, history maker, dense table, sparse Ks, start).
# The table is None (the dense kernel runs when the stream is in its
# regime) or (S, V), V None for the stream's bucket. The start is "init"
# (the initial frontier) or "unsorted" (a seeded list with duplicates and
# an invalid-mask entry, which the kernel's first pass takes on its CTA
# path). Each kernel picks its path by shape: the dense table by its rows
# (one word, V <= 32, and rows a lane x nibbles a row <= 16 on the warp
# path: S = 5 and S = 7 at V = 16; S = 8 and 12, and V = 256 or 512, on
# the CTA path), the sparse pass by its list and candidates (S = 12,
# K = 256 has passes of more than 64 candidates).
def frontier_cases():
    from jepsen_tpu_torch.histories import corrupt_reads, register_history
    return [
        ("valid_s5", lambda: register_history(1000, 5, 101, 5), None,
         (256, 16, 4), "init"),
        ("corrupted_s5", lambda: corrupt_reads(
            register_history(1000, 5, 102, 5), n=2, seed=1), None,
         (256, 16, 4), "init"),
        ("crashed", lambda: crashed(register_history(1000, 5, 103, 4), 150),
         None, (256, 16, 4), "init"),
        ("fresh_values", lambda: register_history(1000, 5, 107,
                                                  FRESH_VALUES), None,
         (256, 16, 4), "init"),
        ("s1", lambda: register_history(600, 1, 104, 6), None, (), "init"),
        ("s12", lambda: register_history(800, 12, 105, 4), (12, None),
         (256, 16), "init"),
        ("v256_s3", lambda: register_history(1000, 3, 106, 300), None, (),
         "init"),
        ("s6_v512", lambda: register_history(1000, 6, 108, 300), (6, 512),
         (), "init"),
        ("s7_v512", lambda: register_history(1000, 7, 109, 300), (7, 512),
         (), "init"),
        ("s7_v16", lambda: register_history(1000, 7, 111, 5), (7, 16), (),
         "init"),
        ("unsorted_start", lambda: register_history(1000, 5, 110, 5), None,
         (256, 16, 4), "unsorted"),
    ]


def unsorted_frontier(K: int, seed: int):
    """A seeded (mask, state) list of K pairs on the card, unsorted, with
    duplicates, one invalid-mask entry and one sentinel pair."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    mask = rng.integers(0, 4, K).astype(np.int64)
    state = rng.integers(0, 3, K).astype(np.int32)
    mask[::3], state[::3] = mask[0], state[0]
    mask[-1], state[-1] = 0xFFFFFFFF, 2
    if K > 2:
        mask[1], state[1] = 0xFFFFFFFF, 0x7FFFFFFF
    return (torch.from_numpy(mask).cuda().to(torch.uint32),
            torch.from_numpy(state).cuda())


def check_frontier(name, history, table, Ks, start):
    """The dense kernel (when the stream is in its regime, or at the
    table given) and the sparse kernel at each K, each against its plain
    version on the card, bit for bit; with each run's kernel time and the
    returns (dense) or closure passes (sparse) it ran on its warp path and
    in all, by its own count, held equal to the plain version's."""
    import torch
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    from jepsen_tpu_torch.ops.jitlin import _bucket, _dense_ok
    stream = encode_register_ops(history)
    ev = card_events(stream)
    S = max(1, stream.n_slots)
    runs = []
    if table is not None or _dense_ok(S, len(stream.intern)):
        St, V = table or (S, None)
        V = V or _bucket(len(stream.intern), floor=16)
        t0 = fk.init_table(St, V, 0, "cuda")
        runs.append(("frontier_dense", {"S": St, "V": V},
                     lambda: fk.frontier_dense(*ev, t0),
                     lambda work: fk.frontier_dense_torch(*ev, t0,
                                                          work=work)))
    for K in Ks:
        m0, s0 = (fk.init_frontier(K, 0, "cuda") if start == "init"
                  else unsorted_frontier(K, K))
        runs.append(("frontier_sparse", {"S": S, "K": K},
                     lambda m0=m0, s0=s0: fk.frontier_sparse(*ev, m0, s0, S),
                     lambda work, m0=m0, s0=s0: fk.frontier_sparse_torch(
                         *ev, m0, s0, S, work=work)))
    for phase, shape, kern, plain in runs:
        work = {}
        got = kern()
        warp, total = getattr(fk, phase).paths.tolist()
        ref = plain(work)
        torch.cuda.synchronize()
        err = frontier_err(got, ref)
        ms = cuda_ms(kern, 3)
        unit = "returns" if phase == "frontier_dense" else "passes"
        path = {unit: total, f"warp_{unit}": warp,
                f"warp_{unit[:-1]}_share": warp / max(1, total),
                "plain_work": work}
        emit({"phase": phase, "case": name, **shape, "start": start,
              "events": len(stream), "result": [int(x) for x in got[:4]],
              "equal": err == 0.0, "ms": ms, **path})
        if err != 0.0:
            raise AssertionError(f"{phase} {name} {shape} differs from plain")
        if [warp, total] != [work.get(f"warp_{unit}", 0), work.get(unit, 0)]:
            raise AssertionError(f"{phase} {name} {shape}: the kernel ran "
                                 f"{warp} of {total} {unit} on its warp "
                                 f"path, the plain version counts {work}")


def dense_scan_ops(stream, died: int, V: int, step_ops: int = 1) -> float:
    """32-bit word operations the dense kernel needs for ``stream`` up to
    the return ``died`` (-1: all): per return, the level-order closure ORs
    each row's W = ceil(V / 32) words once for each pending slot in its
    mask (npend * 2^(S-1) row-slot pairs over the 2^S rows) and the kill
    moves 2^(S-1) blocks; the out-of-range check steps every invoke over
    the V states, ``step_ops`` operations a step (1 for the CAS register,
    one a key for the multi-register map)."""
    import numpy as np
    from jepsen_tpu_torch.ops import jitlin
    kind = np.asarray(stream.kind)
    S = max(1, stream.n_slots)
    W = (V + 31) // 32
    ret_idx = np.nonzero(kind == 1)[0]
    r_pend = jitlin._returns_prepass(kind, stream.slot, stream.f, stream.a,
                                     stream.b)[1]
    upto = ret_idx <= died if died >= 0 else np.ones(len(ret_idx), bool)
    npend = r_pend[upto].sum(axis=1)
    half = 1 << (S - 1)
    return float(((npend + 1) * half * W).sum()
                 + (kind == 0).sum() * V * step_ops)


def reset_launches():
    from jepsen_tpu_torch.ops import forensics_kernels as fx
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    from jepsen_tpu_torch.ops import matrix_kernels as mk
    from jepsen_tpu_torch.ops import scc_kernels as sk
    from jepsen_tpu_torch.ops import setscan
    for fn in (mk.chunk_product, mk.combine_product, fk.frontier_dense,
               fk.frontier_sparse, fk.frontier_dense_batch,
               fk.frontier_sparse_batch, sk.cluster_screen, sk.scc_trim,
               setscan.set_classify, fx.prefix_alive, fx.window_rescan,
               sk.trim_partial_degrees, sk.trim_update):
        fn.launches = 0


def read_launches() -> dict:
    from jepsen_tpu_torch.ops import forensics_kernels as fx
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    from jepsen_tpu_torch.ops import matrix_kernels as mk
    from jepsen_tpu_torch.ops import scc_kernels as sk
    from jepsen_tpu_torch.ops import setscan
    return {"chunk_product": mk.chunk_product.launches,
            "combine_product": mk.combine_product.launches,
            "frontier_dense": fk.frontier_dense.launches,
            "frontier_sparse": fk.frontier_sparse.launches,
            "frontier_dense_batch": fk.frontier_dense_batch.launches,
            "frontier_sparse_batch": fk.frontier_sparse_batch.launches,
            "cluster_screen": sk.cluster_screen.launches,
            "scc_trim": sk.scc_trim.launches,
            "set_classify": setscan.set_classify.launches,
            "prefix_alive": fx.prefix_alive.launches,
            "window_rescan": fx.window_rescan.launches,
            "trim_partial_degrees": sk.trim_partial_degrees.launches,
            "trim_update": sk.trim_update.launches}


def device_kernels(fn, want: str = "", warm: bool = True, calls: int = 1):
    """[(kernel name, device us)] of the CUDA kernels and memsets that
    ``calls`` calls of ``fn()`` run, in launch order, from
    ``torch.profiler`` (after one warm-up call, unless ``warm`` is False);
    with ``want``, a trace that holds ``calls`` launches of a kernel whose
    name contains it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
        torch.cuda.synchronize()
    # the profiler now and then returns a trace without the device's
    # events, or without some of them (one launch of five): take the
    # calls again, up to five times
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        if evs and sum(want in e.name for e in evs) >= calls:
            break
    return [(e.name.replace("(anonymous namespace)::", "").split("(")[0]
             .removeprefix("void "), e.time_range.end - e.time_range.start)
            for e in evs]


def chunk_entry_call(fn, args, S, V):
    """A no-argument call of the chunk-product C entry ``fn`` on the
    operands the wrapper derives from ``args``: the kernel alone, with no
    range check or operand prep. Returns the output tensor."""
    import ctypes
    import torch
    from jepsen_tpu_torch.ops import matrix_kernels as mk
    T, G, _ = args[0].shape
    MV = (1 << S) * V
    tensors = (*mk.chunk_operands(*args, S, V),
               torch.empty((G, MV, MV), dtype=torch.bfloat16, device="cuda"))
    out = tensors[-1]

    def call():
        rc = fn(*(ctypes.c_void_p(t.data_ptr()) for t in tensors), T, G, S,
                V, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"chunk_product launch failed: {rc}")
        return out
    return call


# the Elle histories: bench.py's 50k-txn list-append shape, with 50
# crossed pairs for the anomalous copies
ELLE_TXNS, ELLE_PAIRS = 50_000, 50


def dep_edges(history):
    """The port's columnar graph of a list-append history: (n, src, dst)
    of its dependency (ww, wr, rw) edges."""
    from jepsen_tpu_torch.elle import columnar
    graph = columnar._build(history)[0]
    codes, src, dst = graph.cols
    dep = codes <= 2
    return graph.n, src[dep], dst[dep]


def trim_inputs(n, src, dst):
    """The trim wrapper's inputs on the card, bucketed and padded as
    ``ops.scc.trim_to_cycles`` hands them over."""
    import torch
    from jepsen_tpu_torch.ops import scc
    from jepsen_tpu_torch.ops.jitlin import _bucket
    (s, d), valid = scc._padded((src, dst), len(src))
    return [torch.from_numpy(x).cuda() for x in (s, d, valid)] + [
        _bucket(n, floor=64)]


def check_trim(case, src, dst, valid, n, max_iters=512):
    """The trim kernel against its plain version on the card: the mask,
    the step count and the kernel's work count (worklist items, row
    entries walked) against the plain version's, all equal. Returns (ms,
    plain_ms, steps, err, work)."""
    import torch
    from jepsen_tpu_torch.ops import scc_kernels as sk
    got, steps = sk.scc_trim(src, dst, valid, n, max_iters)
    items, walked = sk.scc_trim.work.tolist()
    torch.cuda.synchronize()
    work = {}
    t0 = time.perf_counter()
    ref, ref_steps = sk.scc_trim_torch(src, dst, valid, n, max_iters,
                                       work=work)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    equal = bool(torch.equal(got, ref)) and int(steps) == int(ref_steps)
    ms = cuda_ms(lambda: sk.scc_trim(src, dst, valid, n, max_iters), 5)
    emit({"phase": "scc_trim", "case": case, "nodes": n,
          "edges": int(valid.sum()), "steps": int(steps),
          "residue": int(got.sum()), "equal": equal, "ms": ms,
          "us_per_step": ms * 1e3 / max(1, int(steps)),
          "plain_ms": plain_ms, "launches_per_call": 1,
          "work_items": items, "work_walked": walked, "plain_work": work})
    if not equal:
        raise AssertionError(f"scc_trim {case} differs from plain")
    if [items, walked] != [work["items"], work["walked"]]:
        raise AssertionError(f"scc_trim {case}: the kernel counts "
                             f"{items, walked}, the plain version {work}")
    return ms, plain_ms, int(steps), 0.0, {"items": items,
                                           "walked": walked}


def screen_clusters(B, V, seed, cyclic):
    """``histories.chain_clusters`` on the card, as the screen wrapper
    takes them (the valid column all True)."""
    import torch
    from jepsen_tpu_torch.histories import chain_clusters
    cols = [torch.from_numpy(x).cuda()
            for x in chain_clusters(B, V, seed, cyclic)]
    return cols + [torch.ones(cols[0].numel(), dtype=torch.bool,
                              device="cuda")]


def check_screen(case, cid, src, dst, valid, B, V):
    """The screen kernel against its plain version on the card: the flags
    and the kernel's work count (nodes removed, edges their rows held)
    against the plain version's, equal. Returns (ms, plain_ms, err,
    flagged, work)."""
    import torch
    from jepsen_tpu_torch.ops import scc_kernels as sk
    got = sk.cluster_screen(cid, src, dst, valid, B, V)
    removed, walked = sk.cluster_screen.work.tolist()
    torch.cuda.synchronize()
    work = {}
    t0 = time.perf_counter()
    ref = sk.cluster_screen_torch(cid, src, dst, valid, B, V, work=work)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = float((got.to(torch.int32) - ref.to(torch.int32)).abs().max())
    ms = cuda_ms(lambda: sk.cluster_screen(cid, src, dst, valid, B, V), 10)
    flagged = int(got.sum())
    emit({"phase": "cluster_screen", "case": case, "B": B, "V": V,
          "edges": int(valid.sum()), "flagged": flagged,
          "equal": err == 0.0, "ms": ms, "plain_ms": plain_ms,
          "work_removed": removed, "work_walked": walked,
          "plain_work": work})
    if err != 0.0:
        raise AssertionError(f"cluster_screen {case} differs from plain")
    if [removed, walked] != [work["removed"], work["walked"]]:
        raise AssertionError(f"cluster_screen {case}: the kernel counts "
                             f"{removed, walked}, the plain version {work}")
    return ms, plain_ms, err, flagged, {"removed": removed,
                                        "walked": walked}


def check_screen_host(case, cid, src, dst, B, V, reps=20):
    """The screen's main-path route (``cluster_screen_host``: host arrays,
    one pinned upload, the C call with no valid column, one read-back)
    against the plain version on the card: the flags and the kernel's
    work count equal. Times the whole call on the host clock (median of
    ``reps``, in ms). Returns (ms, plain_ms, err, flagged, work)."""
    import numpy as np
    import torch
    from jepsen_tpu_torch.ops import scc_kernels as sk
    dev = torch.device("cuda")
    got = sk.cluster_screen_host(cid, src, dst, B, V, dev)
    removed, walked = sk.cluster_screen.work.tolist()
    cols = [torch.from_numpy(np.asarray(x, np.int32)).cuda()
            for x in (cid, src, dst)]
    valid = torch.ones(len(cid), dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    work = {}
    t0 = time.perf_counter()
    ref = sk.cluster_screen_torch(*cols, valid, B, V, work=work)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ref = ref.cpu().numpy()
    err = float(np.abs(got.astype(np.int32) - ref.astype(np.int32)).max())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sk.cluster_screen_host(cid, src, dst, B, V, dev)
        ts.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(ts)
    flagged = int(got.sum())
    emit({"phase": "cluster_screen_host", "case": case, "B": B, "V": V,
          "edges": len(cid), "flagged": flagged, "equal": err == 0.0,
          "ms": ms, "plain_ms": plain_ms, "work_removed": removed,
          "work_walked": walked, "plain_work": work})
    if err != 0.0:
        raise AssertionError(f"cluster_screen_host {case} differs from "
                             f"plain")
    if [removed, walked] != [work["removed"], work["walked"]]:
        raise AssertionError(f"cluster_screen_host {case}: the kernel "
                             f"counts {removed, walked}, the plain version "
                             f"{work}")
    return ms, plain_ms, err, flagged, {"removed": removed,
                                        "walked": walked}


def screen_split(cid, src, dst, B, V, reps=20):
    """One ``batch_cluster_screen`` call's phases on the card, from host
    arrays (the whole call is timed by :func:`check_screen_host`): the
    upload (pack into pinned memory, copy, synchronise), the C call's host
    time, the device time of its sort and
    offsets (the count-and-scan and scatter launches) and of the peel by
    the profiler, and the read-back. Host phases are medians of
    ``reps`` calls, in ms."""
    import torch
    from jepsen_tpu_torch.ops import scc_kernels as sk
    dev = torch.device("cuda")

    def upload():
        return sk.pinned_upload((cid, src, dst), dev)

    def med(fn):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    up_ms = med(lambda: (upload(), torch.cuda.synchronize()))
    on = upload()
    call_ms = med(lambda: sk._screen_launch(on[0], on[1], on[2], None, B,
                                            V))
    out = sk._screen_launch(on[0], on[1], on[2], None, B, V)
    read_ms = med(lambda: out.cpu())
    kerns = device_kernels(
        lambda: sk._screen_launch(on[0], on[1], on[2], None, B, V),
        "screen_count")
    sort_us = sum(us for k, us in kerns if k.startswith(
        ("screen_count", "screen_scan", "screen_scatter")))
    screen_us = sum(us for k, us in kerns if k.startswith("screen_peel"))
    return {"upload_ms": up_ms, "c_call_host_ms": call_ms,
            "sort_offsets_device_ms": sort_us / 1e3,
            "kernel_device_ms": screen_us / 1e3, "read_back_ms": read_ms,
            "device_kernels_us": kerns}


def without_builder(result: dict) -> dict:
    """A list-append result without the key naming its builder, which
    differs between the columnar path and the cpu oracle's."""
    return {k: v for k, v in result.items() if k != "builder"}


def elle_main_path(case, history, want_types, name, smi):
    """``list_append.check(accelerator="gpu")`` on ``history`` against
    the port's cpu oracle, its launches, the median of 5 checks, the
    phase split and the screen's device time. Returns the launches."""
    import torch
    from jepsen_tpu_torch.elle import columnar, list_append
    t0 = time.perf_counter()
    oracle = list_append.check(history, accelerator="cpu")
    cpu_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    got = list_append.check(history, accelerator="gpu")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    lc = read_launches()
    if without_builder(got) != oracle or got["anomaly-types"] != want_types:
        raise AssertionError(f"elle {case}: {got['anomaly-types']} vs "
                             f"{oracle['anomaly-types']}, maps equal: "
                             f"{without_builder(got) == oracle}")
    if (lc["cluster_screen"] > 0) != bool(want_types) or lc["scc_trim"]:
        raise AssertionError(f"elle {case}: launches {lc}")
    times, phases = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        out = list_append.check(history, accelerator="gpu")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        phases.append(dict(columnar.LAST_PHASE_SECONDS))
        if out["anomaly-types"] != want_types:
            raise AssertionError(f"elle {case}: timed check {out}")
    med = statistics.median(times)
    kerns = device_kernels(
        lambda: list_append.check(history, accelerator="gpu"))
    screen_ms = sum(us for k, us in kerns
                    if k.startswith("screen_")) / 1e3
    n_txns = got["txn-count"]
    emit({"phase": "elle_main_path", "case": case, "txns": n_txns,
          "edges": got["edge-count"], "valid": got["valid?"],
          "anomaly_types": got["anomaly-types"], "equals_cpu_oracle": True,
          "launches": lc, "first_check_s": first_s, "check_s": times,
          "median_check_s": med, "txns_per_sec": n_txns / med,
          "phase_seconds": phases, "cpu_oracle_s": cpu_s,
          "screen_device_ms": screen_ms,
          "device_busy_ms": sum(us for _, us in kerns) / 1e3,
          "card": name, "power": smi})
    return lc


def elle_phases(name, smi) -> list:
    """The Elle slice on the card: both kernels against their plain
    versions, then list_append.check on the valid, anomalous and
    wide-window 50k-txn histories, the global (trim) path, and a
    rw-register history, each against the port's cpu oracle. Returns the
    two kernels' entries of the kernels line."""
    import numpy as np
    import torch
    import jepsen_tpu_torch.elle as elle
    from jepsen_tpu_torch.convert import graph_from_numpy
    from jepsen_tpu_torch.elle import columnar, rw_register
    from jepsen_tpu_torch.histories import (chain_clusters, elle_history,
                                            random_trim_graph,
                                            rw_register_history)
    from jepsen_tpu_torch.ops import elle_compare as ec
    h_valid = elle_history(ELLE_TXNS)
    h_pairs = elle_history(ELLE_TXNS, crossed_pairs=ELLE_PAIRS)
    h_wide = elle_history(ELLE_TXNS, crossed_pairs=ELLE_PAIRS, wide=True)

    # 8a. the trim against its plain version; the last graph is past
    # TRIM_DEVICE_MIN_EDGES, where the "auto" mode sends a graph to the
    # device
    chain_n = 5000
    trims = {}
    LIVE_RUNS["elle_pairs_edges"] = dep_edges(h_pairs)
    for case, (n, src, dst) in (
            ("valid_50k_dep", dep_edges(h_valid)),
            ("pairs_50k_dep", LIVE_RUNS["elle_pairs_edges"]),
            ("random_64k_256k", random_trim_graph(16, 18, SEED)),
            ("chain_5000_capped", (chain_n, np.arange(chain_n - 1),
                                   np.arange(1, chain_n))),
            ("random_512k_1m", random_trim_graph(19, 20, SEED))):
        s, d, valid, nb = trim_inputs(n, src, dst)
        if case == "random_512k_1m" and \
                int(valid.sum()) < elle.TRIM_DEVICE_MIN_EDGES:
            raise AssertionError("the large trim case is below "
                                 "TRIM_DEVICE_MIN_EDGES")
        trims[case] = check_trim(case, s, d, valid, nb)

    # 8b. the screen against its plain version, through the public
    # wrapper (card columns and a valid column) and through the main
    # path's route (host arrays, no valid column): random clusters, and
    # the wide-window history's own (recorded from one check). B = 5000
    # is past the sort's kBins = 4096 clusters counted in shared memory,
    # so its count and scatter take the global-memory branch.
    for V, B in ((8, 512), (8, 5000), (64, 128), (256, 64), (1024, 16)):
        for cyclic in (False, True):
            cols = screen_clusters(B, V, SEED + V, cyclic)
            case = (f"random_v{V}_b{B}_"
                    f"{'cyclic' if cyclic else 'acyclic'}")
            _, _, _, flagged, _ = check_screen(case, *cols, B, V)
            _, _, _, flagged_host, _ = check_screen_host(
                case, *chain_clusters(B, V, SEED + V, cyclic), B, V)
            if flagged != flagged_host or \
                    flagged != (B // 2 if cyclic else 0):
                raise AssertionError(f"screen V={V} B={B}: {flagged} and "
                                     f"{flagged_host} flagged")
    from jepsen_tpu_torch.elle import list_append
    with ec.recorded() as rec:
        list_append.check(h_wide, accelerator="gpu")
    wide_calls = rec.calls["cluster_screen_host"]
    # the 50 clusters of about 900 nodes, chunked by SCREEN_MAX_ELEMS into
    # 32 + 18 at V = 1024
    if len(wide_calls) != -(-ELLE_PAIRS // 32) \
            or any(c[4] != 1024 for c in wide_calls):
        raise AssertionError(f"wide-window screen calls: "
                             f"{[c[3:5] for c in wide_calls]}")
    screen = {"ms": 0.0, "tensor_ms": 0.0, "plain_ms": 0.0, "err": 0.0,
              "bytes": 0.0, "ops": 0.0, "bytes_ref": 0.0, "ops_ref": 0.0,
              "clusters": 0, "removed": 0, "walked": 0, "split": []}
    for i, (cid, src, dst, B, V, _) in enumerate(wide_calls):
        case = f"wide_window_chunk{i}"
        cols = [torch.from_numpy(np.asarray(x, np.int32)).cuda()
                for x in (cid, src, dst)]
        valid = torch.ones(len(cid), dtype=torch.bool, device="cuda")
        t_ms, _, t_err, t_flagged, t_work = check_screen(case, *cols, valid,
                                                         B, V)
        ms, pms, err, flagged, work = check_screen_host(case, cid, src, dst,
                                                        B, V)
        if flagged != B or t_flagged != B or t_work != work:
            raise AssertionError(f"wide-window chunk {i}: {flagged} and "
                                 f"{t_flagged} of {B} clusters flagged, "
                                 f"work {work} and {t_work}")
        split = screen_split(cid, src, dst, B, V)
        split = {"call_ms": ms, **split}
        emit({"phase": "cluster_screen_split", "case": case,
              "B": B, "V": V, "edges": len(cid), **split})
        n_edges = len(cid)
        # the nodes the edges touch, each (cluster, local id) once
        nodes = len(np.unique(np.concatenate([
            np.asarray(cid, np.int64) * V + np.asarray(x, np.int64)
            for x in (src, dst)])))
        screen["ms"] += ms
        screen["tensor_ms"] += t_ms
        screen["plain_ms"] += pms
        screen["err"] = max(screen["err"], err, t_err)
        # the main path's route: edges in (cid, src, dst int32; no valid
        # column), a flag out; an operation an edge, a node and a row
        # entry the peel walks
        screen["bytes"] += 12.0 * n_edges + B
        screen["ops"] += float(n_edges + nodes + work["walked"])
        # the reference's work: a valid byte an edge, and B x V nodes
        screen["bytes_ref"] += 13.0 * n_edges + B
        screen["ops_ref"] += float(n_edges + B * V)
        screen["clusters"] += B
        screen["removed"] += work["removed"]
        screen["walked"] += work["walked"]
        screen["split"].append({k: v for k, v in split.items()
                                if k != "device_kernels_us"})

    # 8c. the main path: the valid, anomalous and wide-window histories
    elle_main_path("valid_50k", h_valid, [], name, smi)
    elle_main_path("pairs_at_end_50k", h_pairs, ["G1c", "realtime-cycle"],
                   name, smi)
    lc_wide = elle_main_path("wide_window_50k", h_wide,
                             ["G1c", "realtime-cycle"], name, smi)

    # 8d. the global path: the anomalous graph without φ takes the trim on
    # the card. The builders never void φ themselves (a completion pairs
    # with its process's latest invoke, so their sequential test cannot
    # fail), so φ is dropped from the built graph.
    graph = columnar._build(h_pairs)[0]
    graph.time_order = None
    graph_cpu = graph_from_numpy(graph.n, *graph.cols)
    t0 = time.perf_counter()
    oracle = elle.check_cycles(graph_cpu, accelerator="cpu")
    cpu_s = time.perf_counter() - t0
    reset_launches()
    with ec.recorded() as rec:
        t0 = time.perf_counter()
        got = elle.check_cycles(graph, accelerator="gpu")
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
    lc_global = read_launches()
    if got != oracle or sorted(got) != ["G1c", "realtime-cycle"] \
            or lc_global["scc_trim"] < 1 or lc_global["cluster_screen"]:
        raise AssertionError(f"global path: {sorted(got)} vs "
                             f"{sorted(oracle)}, launches {lc_global}")
    (ts, td, tv, tn, _), = rec.calls["scc_trim"]
    t_ms, t_pms, t_steps, t_err, t_work = check_trim("global_path_input", ts,
                                                     td, tv, tn)
    emit({"phase": "elle_global_path", "txns": graph.n,
          "edges": graph.edge_count(), "anomaly_types": sorted(got),
          "equals_cpu_oracle": True, "launches": lc_global,
          "check_s": gpu_s, "cpu_oracle_s": cpu_s, "trim_steps": t_steps,
          "card": name, "power": smi})

    # 8e. rw-register: a 10k-txn history with wr cycles
    h_rw = rw_register_history(10_000, crossed_pairs=5, seed=SEED)
    oracle = rw_register.check(h_rw, accelerator="cpu")
    reset_launches()
    t0 = time.perf_counter()
    got = rw_register.check(h_rw, accelerator="gpu")
    torch.cuda.synchronize()
    rw_s = time.perf_counter() - t0
    lc_rw = read_launches()
    if got != oracle or "G1c" not in got["anomaly-types"] \
            or lc_rw["cluster_screen"] < 1:
        raise AssertionError(f"rw-register: {got['anomaly-types']} vs "
                             f"{oracle['anomaly-types']}, launches {lc_rw}")
    emit({"phase": "elle_rw_register", "txns": got["txn-count"],
          "edges": got["edge-count"], "anomaly_types": got["anomaly-types"],
          "equals_cpu_oracle": True, "launches": lc_rw, "check_s": rw_s,
          "card": name, "power": smi})

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    n_edges = int(tv.sum())
    # the trim's needs: the edges in (src, dst int32 and the valid byte),
    # the mask out; an operation an edge, a node and a row entry walked
    t_bytes = 9.0 * n_edges + tn
    t_ops = float(n_edges + tn + t_work["walked"])
    # the reference's work: every edge and node in every step
    t_ops_ref = float(n_edges + tn) * t_steps
    s_bound, t_bound = (bound(screen["ops"], screen["bytes"]),
                        bound(t_ops, t_bytes))
    s_ref, t_ref = (bound(screen["ops_ref"], screen["bytes_ref"]),
                    bound(t_ops_ref, t_bytes))
    return [
        {"name": "cluster_screen", "route": "cuda",
         "source": "jepsen_tpu_torch/ops/csrc/cluster_screen.cu",
         "replaces": "jepsen_tpu/ops/scc.py:195",
         "launches": lc_wide["cluster_screen"],
         "max_abs_err": screen["err"], "equal": screen["err"] == 0.0,
         "ms": screen["ms"], "plain_ms": screen["plain_ms"],
         "bound_ms": s_bound[0], "bound_by": s_bound[1], "library_ms": None,
         "bound_operations": "int32_ops",
         "bound_ms_reference_work": s_ref[0],
         "bound_by_reference_work": s_ref[1],
         "ms_route": "cluster_screen_host, host clock, whole call",
         "tensor_wrapper_ms": screen["tensor_ms"],
         "clusters": screen["clusters"], "bytes": screen["bytes"],
         "int32_ops": screen["ops"], "work_removed": screen["removed"],
         "work_walked": screen["walked"],
         "split_per_call": screen["split"],
         "shape": "wide_window_50k: the check's screen calls, summed"},
        {"name": "scc_trim", "route": "cuda",
         "source": "jepsen_tpu_torch/ops/csrc/scc_trim.cu",
         "replaces": "jepsen_tpu/ops/scc.py:31",
         "launches": lc_global["scc_trim"], "max_abs_err": t_err,
         "equal": t_err == 0.0, "ms": t_ms, "plain_ms": t_pms,
         "bound_ms": t_bound[0], "bound_by": t_bound[1], "library_ms": None,
         "bound_operations": "int32_ops",
         "bound_ms_reference_work": t_ref[0],
         "bound_by_reference_work": t_ref[1],
         "steps": t_steps, "nodes": tn, "edges": n_edges, "bytes": t_bytes,
         "int32_ops": t_ops, "int32_ops_reference_work": t_ops_ref,
         "work_items": t_work["items"], "work_walked": t_work["walked"],
         "us_per_step": t_ms * 1e3 / max(1, t_steps),
         "other_cases_ms": {k: v[0] for k, v in trims.items()},
         "shape": "global path: pairs_at_end_50k's dependency edges"}]


# BASELINE config 3 (bench.py:438-440): keys of 1k ops, 5 processes and 5
# values (S = 5, V = 8, MV = 256), key k's history from seed 1000 + k; the
# invalid copy corrupts 2 reads in each of 8 keys. The sparse copy draws
# its values from 10^9 at 1.3k ops a key: past the dense table's 512
# states (1k ops give about 450), so the batch takes the sparse list.
IND_KEYS, IND_OPS, IND_BIG = 64, 1000, 1024
IND_BAD = tuple(range(3, 64, 8))
# the 1,024 keys run at half of bench.py's depth (500 ops a key), to keep
# the whole script in its time. The fresh-value keys keep theirs: at 1,300
# ops a key holds 555-601 states, past the dense table's 512, and 1,100
# ops would leave some below it (470-506); and the plain batched scan,
# most of their time, walks the longest key, so fewer keys save little
# (8 keys: 30.2 s against 32.0 s for 16, on two H100 hosts)
IND_BIG_OPS = 500
IND_SPARSE_KEYS, IND_SPARSE_OPS, IND_SPARSE_BAD = 16, 1300, (1, 6, 11, 13)


def sub_batches(n_keys: int) -> int:
    """The matrix dispatches ``matrix_check_batch`` makes for a batch of
    ``n_keys`` keys."""
    from jepsen_tpu_torch.ops import jitlin
    sub = (jitlin.MATRIX_SUB_KEYS if n_keys > jitlin.MATRIX_SUB_KEYS
           else jitlin.MATRIX_PIPELINE_KEYS)
    return 1 if n_keys <= sub else -(-n_keys // sub)


def same_map(what, got, want) -> None:
    """Raises unless two independent result maps agree on ``valid?``,
    ``failures``, ``count`` and every key's ``valid?``."""
    keys = sorted(want["results"])
    if (got["valid?"], got["failures"], got["count"], sorted(got["results"])
            ) != (want["valid?"], want["failures"], want["count"], keys) \
            or any(got["results"][k]["valid?"] != want["results"][k]["valid?"]
                   for k in keys):
        raise AssertionError(f"{what}: the result map differs from the "
                             f"oracle: {got['failures']} vs "
                             f"{want['failures']}")


def independent_split(h, lin, check_med, reps=5) -> dict:
    """Median host seconds of an independent check's parts, each ending
    in a sync: the split by key, the encode, the matrix screen (its
    sub-batches' prepass, grids, enqueue and one read-back in
    ``matrix_sub_batches``) and the key-batched scan of the keys it
    leaves undecided; ``merge_and_rest`` is what the check's median
    ``check_med`` leaves."""
    import torch
    from jepsen_tpu_torch import independent, parallel
    from jepsen_tpu_torch.ops import jitlin
    parts = {k: [] for k in ("split", "encode", "matrix", "scan")}
    for _ in range(reps):
        t0 = time.perf_counter()
        _, subs = independent.split_history(h)
        t1 = time.perf_counter()
        sts = [lin._encoding(sub)[0] for sub in subs.values()]
        t2 = time.perf_counter()
        n_states = max(len(st.intern) for st in sts)
        screen = jitlin.matrix_check_batch(sts, num_states=n_states)
        t3 = time.perf_counter()
        undecided = [sts[i] for i, r in enumerate(screen)
                     if not r[0] or r[2]]
        if undecided:
            parallel._scan_batch(undecided, lin.capacity,
                                 jitlin.JitLinKernel(), n_states)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[k].append(dt)
    med = {k: statistics.median(v) for k, v in parts.items()}
    med["merge_and_rest"] = check_med - sum(med.values())
    med["matrix_sub_batches"] = jitlin.last_phase_seconds()
    return med


def timed(fn, n):
    """(host seconds of each of ``n`` calls, each ending in a sync, the
    last call's value)."""
    import torch
    times, out = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, out


def batched_scan_row(kind, streams, n_states, K, launches, singles_reps=5):
    """The key-batched frontier entry ``kind`` on ``streams`` as the
    independent path hands them to it (the batch's S, its V from
    ``n_states``), against its plain version (every output and each key's
    path counts) and against the single-history kernel key by key; its
    kernels-line row."""
    import torch
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    from jepsen_tpu_torch.ops.jitlin import _bucket
    S = max(1, max(s.n_slots for s in streams))
    V = _bucket(n_states, floor=16)
    batch = fk.batch_events(streams, S, "cuda")
    dense = kind == "frontier_dense_batch"
    if dense:
        call = lambda: fk.frontier_dense_batch(batch, V)  # noqa: E731
        plain = lambda w: fk.frontier_dense_batch_torch(  # noqa: E731
            batch, V, work=w)
        unit = "returns"
    else:
        call = lambda: fk.frontier_sparse_batch(batch, K)  # noqa: E731
        plain = lambda w: fk.frontier_sparse_batch_torch(  # noqa: E731
            batch, K, work=w)
        unit = "passes"
    got = call()
    paths = getattr(fk, kind).paths.tolist()
    work = []
    t0 = time.perf_counter()
    ref = plain(work)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = frontier_err(got, ref)
    want_paths = [[w.get(f"warp_{unit}", 0), w.get(unit, 0)] for w in work]
    if err != 0.0 or paths != want_paths:
        raise AssertionError(f"{kind} differs from its plain version: err "
                             f"{err}, paths {paths} vs {want_paths}")
    rows = [[int(x[b]) for x in got] for b in range(len(streams))]
    # each key alone through the single-history kernel
    evs = [card_events(s) for s in streams]
    if dense:
        starts = [fk.init_table(S, V, 0, "cuda") for _ in streams]
        single = lambda i: fk.frontier_dense(  # noqa: E731
            *evs[i], starts[i])
    else:
        starts = [fk.init_frontier(K, 0, "cuda") for _ in streams]
        single = lambda i: fk.frontier_sparse(  # noqa: E731
            *evs[i], *starts[i], S)
    singles = [[int(x) for x in single(i)[:4]] for i in range(len(streams))]
    if singles != rows:
        raise AssertionError(f"{kind}: the batch's rows {rows} differ from "
                             f"the single kernel's {singles}")
    ms = cuda_ms(call, 20)
    singles_ms = cuda_ms(lambda: [single(i) for i in range(len(streams))],
                         singles_reps)
    prof = device_kernels(call, kind.removesuffix("_batch") + "_kernel")
    # the bound, summed over the keys as the single scans' is counted:
    # bytes = the events (20 bytes each), the offsets and the [B, 6]
    # results; operations = the dense closure's and kill's word
    # operations up to each key's death, or the sparse passes' candidates
    # plus n log2 n compares
    n_events = sum(len(s) for s in streams)
    nbytes = 20 * n_events + 4 * (len(streams) + 1) + 24 * len(streams)
    if dense:
        ops = sum(dense_scan_ops(s, r[1], V) for s, r in zip(streams, rows))
    else:
        ops = float(sum(w.get("compares", 0) + w.get("candidates", 0)
                        for w in work))
    t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
    total = sum(p[1] for p in paths)
    src = "frontier_dense.cu" if dense else "frontier_sparse.cu"
    return {"name": kind, "route": "cuda",
            "source": f"jepsen_tpu_torch/ops/csrc/{src}",
            "replaces": ("jepsen_tpu/ops/jitlin.py:249" if dense
                         else "jepsen_tpu/ops/jitlin.py:116"),
            "vmapped_at": ("jepsen_tpu/ops/jitlin.py:2012" if dense
                           else "jepsen_tpu/ops/jitlin.py:2023"),
            "launches": launches, "max_abs_err": err, "equal": True,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "bound_operations": "int32_word_ops",
            "launches_independent": launches, "keys": len(streams),
            "S": S, "V": V if dense else None, "K": None if dense else K,
            "events": n_events, "rows": rows, unit: total,
            f"warp_{unit}": sum(p[0] for p in paths),
            ("us_per_return_key_sum" if dense else "us_per_pass_key_sum"):
                ms * 1e3 / max(1, total),
            "single_launches_in_turn_ms": singles_ms,
            "batched_over_singles": ms / singles_ms,
            "device_ms": sum(us for n, us in prof
                             if n.startswith(kind.removesuffix("_batch")))
            / 1e3, "device_kernels_us": prof,
            "word_ops": ops, "bytes": nbytes}


def independent_phases(name, smi):
    """BASELINE config 3 on the card through
    ``independent.checker(linearizable(accelerator="gpu"))``: 64 keys
    valid and with 8 keys corrupted, 16 fresh-value keys (the sparse
    list), 1,024 keys of 500 ops (eight matrix sub-batches of 128), and
    the native lane against the Python twin. Returns the two batched entries'
    kernels-line rows and each kernel's launches in one valid 64-key
    check."""
    import numpy as np
    import torch
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linear_cpu import check_stream
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.histories import (corrupt_keys,
                                            independent_register_history)
    from jepsen_tpu_torch.native import check_stream_native
    from jepsen_tpu_torch.ops import jitlin
    from jepsen_tpu_torch.parallel import batch_check

    lin = linearizable(accelerator="gpu")
    chk = independent.checker(lin)
    oracle = independent.checker(linearizable(accelerator="cpu"))

    def streams_of(h):
        keys, subs = independent.split_history(h)
        return keys, [lin._encoding(subs[independent._freeze_key(k)])[0]
                      for k in keys]

    # 9a. the main path: 64 keys, valid
    h = independent_register_history(IND_KEYS, IND_OPS)
    t0 = time.perf_counter()
    want = oracle.check({}, h, {})
    oracle_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    got = chk.check({}, h, {})
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    same_map("independent_main_path", got, want)
    algs = {r["algorithm"] for r in got["results"].values()}
    if got["valid?"] is not True or algs != {"jitlin-gpu"}:
        raise AssertionError(f"independent_main_path: {got['valid?']}, {algs}")
    n_sub = sub_batches(IND_KEYS)
    if (launches["chunk_product"], launches["combine_product"]) != (
            n_sub, n_sub) \
            or any(launches[k] for k in launches if k.startswith("frontier")):
        raise AssertionError(f"independent_main_path launches: {launches}")
    check_s, _ = timed(lambda: chk.check({}, h, {}), 5)
    med = statistics.median(check_s)
    keys, streams = streams_of(h)
    med_split = independent_split(h, lin, med)
    busy = device_kernels(lambda: chk.check({}, h, {}), "chunk_product")
    busy_ms = sum(us for _, us in busy) / 1e3
    by_kernel = {}
    for kname, us in busy:
        by_kernel[kname] = by_kernel.get(kname, 0.0) + us
    emit({"phase": "independent_main_path", "keys": IND_KEYS,
          "ops_per_key": IND_OPS, "ops": IND_KEYS * IND_OPS,
          "events": sum(len(s) for s in streams),
          "S": max(s.n_slots for s in streams),
          "states": max(len(s.intern) for s in streams),
          "valid": got["valid?"], "count": got["count"],
          "launches_per_check": launches, "first_check_s": first_s,
          "check_s": check_s, "median_check_s": med,
          "ops_per_sec": IND_KEYS * IND_OPS / med,
          "median_split_s": med_split,
          "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / 1e3 / med,
          "device_us_by_kernel": sorted(by_kernel.items(),
                                        key=lambda kv: -kv[1])[:8],
          "cpu_oracle_check_s": oracle_s, "card": name, "power": smi})

    # 9b. 8 of the 64 keys corrupted: the screen leaves them undecided,
    # and one key-batched dense launch settles them
    hb = corrupt_keys(h, IND_BAD, n=2, seed=0)
    want_b = oracle.check({}, hb, {})
    reset_launches()
    got_b = chk.check({}, hb, {})
    torch.cuda.synchronize()
    launches_b = read_launches()
    same_map("independent_invalid", got_b, want_b)
    if got_b["failures"] != sorted(str(k) for k in IND_BAD):
        raise AssertionError(f"independent_invalid: {got_b['failures']}")
    if launches_b["frontier_dense_batch"] != 1 \
            or launches_b["chunk_product"] != n_sub \
            or any(launches_b[k] for k in ("frontier_dense", "frontier_sparse",
                                           "frontier_sparse_batch")):
        raise AssertionError(f"independent_invalid launches: {launches_b}")
    check_b, _ = timed(lambda: chk.check({}, hb, {}), 5)
    split_b = independent_split(hb, lin, statistics.median(check_b))
    busy_b = device_kernels(lambda: chk.check({}, hb, {}),
                            "frontier_dense_kernel")
    keys_b, streams_b = streams_of(hb)
    LIVE_RUNS["config3"] = (h, got, streams_b)
    n_states = max(len(s.intern) for s in streams_b)
    screen = jitlin.matrix_check_batch(streams_b, num_states=n_states)
    undecided = [i for i, r in enumerate(screen) if not r[0] or r[2]]
    if sorted(str(keys_b[i]) for i in undecided) != got_b["failures"]:
        raise AssertionError(f"independent_invalid: the screen left "
                             f"{undecided} undecided")
    bad_streams = [streams_b[i] for i in undecided]
    dense_row = batched_scan_row("frontier_dense_batch", bad_streams,
                                 n_states, None,
                                 launches_b["frontier_dense_batch"])
    for i, row in zip(undecided, dense_row["rows"]):
        res = got_b["results"][str(keys_b[i])]
        if row[0] != 0 or res["configs-max"] != row[3]:
            raise AssertionError(f"key {keys_b[i]}: batch row {row}, map "
                                 f"{res}")
    emit({"phase": "independent_invalid", "keys": IND_KEYS,
          "bad_keys": list(IND_BAD), "failures": got_b["failures"],
          "launches_per_check": launches_b, "check_s": check_b,
          "median_check_s": statistics.median(check_b),
          "median_split_s": split_b,
          "device_busy_ms": sum(us for _, us in busy_b) / 1e3,
          "frontier_device_ms": sum(us for n, us in busy_b
                                    if n.startswith("frontier")) / 1e3,
          "batched_rows": dense_row["rows"],
          "batched_launch_ms": dense_row["ms"],
          "single_launches_in_turn_ms":
              dense_row["single_launches_in_turn_ms"],
          "card": name, "power": smi})

    # 9c. fresh-value keys: past 512 states, one key-batched sparse launch
    hs = independent_register_history(IND_SPARSE_KEYS, IND_SPARSE_OPS,
                                      n_values=FRESH_VALUES)
    sparse_row = None
    for copy, hh in (("valid", hs), ("corrupted", corrupt_keys(
            hs, IND_SPARSE_BAD, n=2, seed=0))):
        want_s = oracle.check({}, hh, {})
        reset_launches()
        t0 = time.perf_counter()
        got_s = chk.check({}, hh, {})
        torch.cuda.synchronize()
        check_s_s = time.perf_counter() - t0
        lc = read_launches()
        same_map(f"independent_sparse {copy}", got_s, want_s)
        if lc["frontier_sparse_batch"] != 1 or any(
                lc[k] for k in lc if k != "frontier_sparse_batch"):
            raise AssertionError(f"independent_sparse {copy}: {lc}")
        if got_s["failures"] != (sorted(str(k) for k in IND_SPARSE_BAD)
                                 if copy == "corrupted" else []):
            raise AssertionError(f"independent_sparse {copy}: "
                                 f"{got_s['failures']}")
        _, sts = streams_of(hh)
        row = batched_scan_row("frontier_sparse_batch", sts,
                               max(len(s.intern) for s in sts), 256,
                               lc["frontier_sparse_batch"], singles_reps=2)
        if copy == "valid":
            sparse_row = row
        emit({"phase": "independent_sparse", "copy": copy,
              "keys": IND_SPARSE_KEYS, "ops_per_key": IND_SPARSE_OPS,
              "states": max(len(s.intern) for s in sts),
              "failures": got_s["failures"], "launches": lc,
              "check_s": check_s_s, "batched_rows": row["rows"],
              "batched_launch_ms": row["ms"],
              "single_launches_in_turn_ms":
                  row["single_launches_in_turn_ms"],
              "passes": row["passes"], "warp_passes": row["warp_passes"],
              "card": name, "power": smi})

    # 9d. 1,024 keys (bench.py's scaling point): eight matrix sub-batches
    # of 128, against the native lane
    hk = independent_register_history(IND_BIG, IND_BIG_OPS)
    t0 = time.perf_counter()
    _, streams_k = streams_of(hk)
    prep_s = time.perf_counter() - t0
    reset_launches()
    gpu_s, gpu = timed(lambda: batch_check(streams_k), 3)
    lk = read_launches()
    sub_k = jitlin.last_phase_seconds()
    cpu_s, cpu = timed(lambda: batch_check(streams_k, accelerator="cpu"), 2)
    LIVE_RUNS["config3_1024"] = (streams_k, gpu)
    if [r[0] for r in gpu] != [r[0] for r in cpu] or not all(
            r[0] for r in gpu):
        raise AssertionError("independent_1024: the card's verdicts differ "
                             "from the native lane's")
    if lk["chunk_product"] != 3 * sub_batches(IND_BIG) \
            or sub_k["sub_batches"] != sub_batches(IND_BIG):
        raise AssertionError(f"independent_1024: {lk}, {sub_k}")
    t0 = time.perf_counter()
    full = chk.check({}, hk, {})
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    if full["valid?"] is not True or full["count"] != IND_BIG:
        raise AssertionError("independent_1024: the check failed")
    emit({"phase": "independent_1024", "keys": IND_BIG,
          "ops": IND_BIG * IND_BIG_OPS, "ops_per_key": IND_BIG_OPS,
          "split_and_encode_s": prep_s,
          "gpu_batch_check_s": gpu_s,
          "median_gpu_batch_check_s": statistics.median(gpu_s),
          "gpu_ops_per_sec": IND_BIG * IND_BIG_OPS
          / statistics.median(gpu_s),
          "native_lane_s": cpu_s,
          "native_lane_ops_per_sec": IND_BIG * IND_BIG_OPS / min(cpu_s),
          "matrix_sub_batch_phases_s": sub_k,
          "launches_per_batch_check": {k: v / 3 for k, v in lk.items()},
          "full_check_s": full_s,
          "full_check_ops_per_sec": IND_BIG * IND_BIG_OPS / full_s,
          "card": name, "power": smi})

    # 9e. the native lane against the Python twin, key by key
    rates = {}
    for copy, hh in (("valid", h), ("corrupted", hb)):
        _, sts = streams_of(hh)
        t0 = time.perf_counter()
        nat = [check_stream_native(s) for s in sts]
        nat_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        twin = [check_stream(s) for s in sts]
        twin_s = time.perf_counter() - t0
        if [(r.valid, r.failed_event, r.configs_max) for r in nat] != [
                (r.valid, r.failed_event, r.configs_max) for r in twin]:
            raise AssertionError(f"native_lane {copy}: verdicts differ")
        rates[copy] = {"native_s": nat_s, "twin_s": twin_s,
                       "native_ops_per_sec": IND_KEYS * IND_OPS / nat_s,
                       "twin_ops_per_sec": IND_KEYS * IND_OPS / twin_s,
                       "invalid_keys": sum(r.valid is False for r in nat)}
    emit({"phase": "native_lane", "keys": IND_KEYS, "ops_per_key": IND_OPS,
          "one_thread": rates, "card": name, "power": smi})
    return [dense_row, sparse_row], launches


# the set-full slice (BASELINE config 4, bench.py:493-513): 20,000
# elements, a read of the whole set every 50 adds (400 reads); planted
# faults for the invalid copy; the kernel alone also at (1, 1), (7, 33)
# and a stress shape of 2,048 reads x 262,144 elements
SET_ELS, SET_READ_EVERY, SET_LOST, SET_STALE = 20_000, 50, 20, 20
SET_SHAPES = ((1, 1), (7, 33), (400, 20_000), (2048, 262_144))


def set_inputs(words, t_read, invoke_t, ok_t, has_ok):
    """Host classify inputs as card tensors, through the pinned buffer the
    set-full path uploads: ((words, t_read, invoke_t, ok_t, has_ok), the
    rows' order by read time, the milliseconds of that upload (CUDA
    events))."""
    from jepsen_tpu_torch.ops import setscan
    host, offs = setscan.pinned_inputs(words, t_read, invoke_t, ok_t, has_ok)
    up_ms = cuda_ms(lambda: host.to("cuda", non_blocking=True), 5)
    return (*setscan.card_views(host.to("cuda"), offs, len(t_read)), up_ms)


def check_set_classify(case, args, order, up_ms, E, plain_reps):
    """The kernel against its plain version on the card, bit-equal, and
    its times: through the wrapper (which sorts the rows on the card),
    the C entry alone (given the uploaded order), the plain version; the
    upload and the byte bound beside them."""
    import torch
    from jepsen_tpu_torch.ops import _build, setscan
    R, W = args[0].shape
    n = setscan.set_classify.launches
    got = setscan.set_classify(*args, E)
    launches = setscan.set_classify.launches - n
    want = setscan.classify_plain(*args, E)
    torch.cuda.synchronize()
    equal = all(torch.equal(x, y) for x, y in zip(got, want))
    stable = want[0] == setscan.STABLE
    err = ((got[2] - want[2]).abs()[stable].max().item()
           if bool(stable.any()) and torch.equal(got[0], want[0]) else 0.0)
    if not equal:
        raise AssertionError(f"set_classify {case} ({R} x {E}) differs from "
                             f"plain (latency err {err})")
    out = [torch.empty_like(x) for x in got]
    lib = _build.library("set_classify")

    words, t_read, invoke_t, ok_t, has_ok = args
    # the C entry's arguments, made once: a timed call is its launch alone
    entry_args = (*(x.data_ptr() for x in (
        words, t_read, order, invoke_t, ok_t, has_ok, *out)), R, W, E,
        torch.cuda.current_stream().cuda_stream)

    def entry():
        rc = lib.jt_set_classify(*entry_args)
        if rc != 0:
            raise RuntimeError(f"set_classify launch failed: {rc}")
    entry()
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(out, want)):
        raise AssertionError(f"set_classify {case}: the C entry differs")
    nbytes = setscan.kernel_bytes(R, E)
    row = {"R": R, "E": E, "words": R * W, "launches": launches,
           "equal": equal, "max_abs_err": err,
           "ms": cuda_ms(lambda: setscan.set_classify(*args, E), 20),
           "entry_ms": cuda_ms(entry, 50), "upload_ms": up_ms,
           "plain_ms": cuda_ms(lambda: setscan.classify_plain(*args, E),
                               plain_reps),
           "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES * 1e3,
           "codes": torch.bincount(want[0], minlength=3).tolist(),
           "stale": int(want[1].sum())}
    emit({"phase": "set_classify_kernel", "case": case, **row})
    return row


def set_full_phases(name, smi) -> dict:
    """BASELINE config 4 on the card: the set-classify kernel against its
    plain version at four shapes, with tied read times and at a tall,
    narrow shape, then ``set_full(accelerator="gpu")`` on config 4's
    history, valid, with planted loss and staleness (``linearizable=
    True``: invalid), and that copy with its times moved past 10^11 ns,
    each against the port's ``"cpu"`` walk; last the kernel on the main
    path's inputs, as they are and with the reads last first. Returns
    the kernels-line row and the launches of one valid check."""
    import torch
    from jepsen_tpu_torch.checker import set_full
    from jepsen_tpu_torch.histories import set_full_history
    from jepsen_tpu_torch.history_ir import views
    from jepsen_tpu_torch.ops import setscan
    from jepsen_tpu_torch.ops.set_compare import config4_inputs, random_inputs

    # 10a. the kernel alone: seeded random words (padding bits set too)
    # and float64 times of nanosecond size, unsorted; a third of the
    # elements without an add-ok, so the ascending scan runs; then the
    # read times drawn from 8 values (ties), and a tall, narrow shape
    # (3 words: a tile of one word, its 4,096 rows split over 512 threads)
    shapes = {}
    for case, R, E, inputs in (
            *((f"random_{R}x{E}", R, E, random_inputs(R, E, 100 + i))
              for i, (R, E) in enumerate(SET_SHAPES)),
            ("tied_400x20000", 400, 20_000,
             random_inputs(400, 20_000, 104, ties=8)),
            ("tall_4096x96", 4096, 96, random_inputs(4096, 96, 105))):
        shapes[case] = check_set_classify(
            case, *set_inputs(*inputs), E, 2 if R * E > 1 << 26 else 5)

    # 10b. the main path
    variants = (
        ("valid", False, set_full_history(SET_ELS, SET_READ_EVERY)),
        ("planted", True, set_full_history(
            SET_ELS, SET_READ_EVERY, n_lost=SET_LOST, n_stale=SET_STALE,
            seed=4)),
        ("planted_ns_past_1e11", True, set_full_history(
            SET_ELS, SET_READ_EVERY, n_lost=SET_LOST, n_stale=SET_STALE,
            seed=4, t0=10 ** 11)))
    main_launches = None
    for case, lin, h in variants:
        t0 = time.perf_counter()
        want = set_full(lin, "cpu").check({}, h, {})
        walk_s = time.perf_counter() - t0
        chk = set_full(lin, "gpu")
        reset_launches()
        t0 = time.perf_counter()
        got = chk.check({}, h, {})
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        lc = read_launches()
        if got != want:
            raise AssertionError(
                f"set_full {case}: the map differs from the walk on "
                f"{[k for k in want if got.get(k) != want[k]]}")
        if lc["set_classify"] != 1 or any(
                v for k, v in lc.items() if k != "set_classify"):
            raise AssertionError(f"set_full {case} launches: {lc}")
        expect = ((True, 0, 0) if case == "valid"
                  else (False, SET_LOST, SET_STALE))
        if (got["valid?"], got["lost-count"], got["stale-count"]) != expect:
            raise AssertionError(f"set_full {case}: {got['valid?']}, "
                                 f"{got['lost-count']} lost, "
                                 f"{got['stale-count']} stale")
        if main_launches is None:
            main_launches = lc
        # each timed check's own split: its encode timed inside it, the
        # classify's pack (host clock) and upload, kernel and read-back
        # (CUDA events)
        check_s, enc_s, phases = [], [], []
        columns = views.set_full_columns

        def timed_columns(hist):
            t0 = time.perf_counter()
            out = columns(hist)
            enc_s.append(time.perf_counter() - t0)
            return out
        views.set_full_columns = timed_columns
        try:
            for _ in range(5):
                t0 = time.perf_counter()
                chk.check({}, h, {})
                check_s.append(time.perf_counter() - t0)
                phases.append({"encode": enc_s[-1],
                               **setscan.last_phase_seconds()})
        finally:
            views.set_full_columns = columns
        for p, t in zip(phases, check_s):
            p["result_map_and_rest"] = t - sum(p.values())
        med = statistics.median(check_s)
        split = {k: statistics.median(p[k] for p in phases)
                 for k in phases[0]}
        device_s = split["upload"] + split["kernel"] + split["readback"]
        emit({"phase": "set_full_main_path", "case": case,
              "linearizable": lin, "ops": len(h), "elements": SET_ELS,
              "reads": SET_ELS // SET_READ_EVERY, "valid": got["valid?"],
              "lost": got["lost-count"], "stale": got["stale-count"],
              "launches": lc, "first_check_s": first_s, "check_s": check_s,
              "median_check_s": med, "elements_per_sec": SET_ELS / med,
              "median_split_s": split,
              "encode_share": split["encode"] / med,
              "device_busy_share": device_s / med,
              "cpu_walk_s": walk_s, "card": name, "power": smi})

    # the kernel at the main path's own inputs: config 4's valid history
    # (every add acknowledged, so no ascending scan)
    enc = views.set_full_columns(variants[0][2])
    E = len(enc["els"])
    args, order, up_ms = set_inputs(setscan.pack_member(enc["member"]),
                                    enc["read_t"], enc["invoke_t"],
                                    enc["ok_t"], enc["has_ok"])
    main = check_set_classify("main_path_inputs", args, order, up_ms, E, 5)
    main.update(launches=main_launches["set_classify"])
    # the same inputs with the reads listed last first
    shapes["main_path_reversed"] = check_set_classify(
        "main_path_reversed", *set_inputs(*config4_inputs(reverse=True)), E,
        5)
    return {"name": "set_classify", "route": "cuda",
            "source": "jepsen_tpu_torch/ops/csrc/set_classify.cu",
            "replaces": "jepsen_tpu/ops/setscan.py:69",
            "launches": main["launches"],
            "max_abs_err": max(r["max_abs_err"]
                               for r in (main, *shapes.values())),
            "equal": True, "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "entry_ms": main["entry_ms"],
            "upload_ms": main["upload_ms"], "R": main["R"], "E": E,
            "bytes": main["bytes"], "shapes": shapes}


# the multi-register slice (the multi-key-acid workload,
# jepsen_tpu/workloads/multi_key_acid.py; multi_key_acid.clj:40-41 and
# :59): 500 keys of 20 txns, each key on its own 10 processes (2n, n = 5
# nodes; 5 read, 5 write), K = 3 keys x V = 5 values (216 states); the
# invalid copy gives 10 keys an impossible read. The key count is the
# depth cut that keeps the whole script inside its time budget: on one
# H100 host 11a and 11b took 117 s of a 665 s run at 1,000 keys, and 85 s
# of a 679 s run at 650 keys on another. One 10k-txn history on 5
# processes at the same width (the dense table's CTA path), its copy with
# two impossible reads, and a copy whose last writes crash until S = 10
# (the sparse list). The kernels alone on 1k-txn histories: the plain
# versions loop over events in Python.
ACID_GROUPS, ACID_PER_GROUP, ACID_PROCS = 500, 20, 10
ACID_BAD = tuple(range(7, 500, 50))
MR_SHAPE, MR_TXNS, MR_KERNEL_TXNS = (3, 5), 10_000, 1000


def same_linear_maps(what, got, want) -> None:
    """Raises unless two independent result maps of a composed
    ``linear`` checker agree on ``valid?``, ``failures``, ``count`` and
    every key's ``valid?`` and ``failed-op``."""
    same_map(what, got, want)
    for k, r in want["results"].items():
        g = got["results"][k]["linear"]
        if (g["valid?"], g.get("failed-op")) != (
                r["linear"]["valid?"], r["linear"].get("failed-op")):
            raise AssertionError(f"{what}: key {k}: {g} vs {r['linear']}")


def c_entry_split(kind, stream, dims, model) -> dict:
    """This checkout's C entry of ``kind`` (``frontier_dense`` or
    ``frontier_sparse``) on ``stream`` at the table (S, V) or the list K
    ``dims``, with the multi-register ``model`` (keys, values) or the CAS
    register (None), timed by ``ops.frontier_compare.run_case``: its ms,
    its fixed part (the same call on an empty event stream), on the
    dense table the invokes alone, its work on the warp path and in all,
    and the us a unit of work (return or pass) past the fixed part. Each
    time is the mean of two timings of 5 back-to-back calls."""
    from jepsen_tpu_torch.ops import _build
    from jepsen_tpu_torch.ops.frontier_compare import run_case
    fn = getattr(_build.library(kind), _build.SIGNATURES[kind][0])
    row = run_case({("this", kind): fn}, kind, stream, dims, model, reps=5)
    unit, per = (("returns", "us_per_return") if kind == "frontier_dense"
                 else ("passes", "us_per_pass"))
    out = {f"{k}ms": sum(row[f"this_{k}ms"]) / 2
           for k in ("", "fixed_", "invokes_") if f"this_{k}ms" in row}
    out["c_entry_ms"] = out.pop("ms")
    out.update({unit: row["work"], f"warp_{unit}": row["warp_work"],
                per: (out["c_entry_ms"] - out["fixed_ms"]) * 1e3
                / max(1, row["work"]), "result": row["result"]})
    return out


def cas_same_shape(kind, case, S, width):
    """The CAS instantiation of ``kind`` on ``ops.frontier_compare``'s
    register-history case ``case`` at the table (S, V = width) or the
    list (S, K = width) of a multi-register row, split at its C entry by
    ``c_entry_split``: the path's own cost without the multi-register
    step."""
    from jepsen_tpu_torch.ops.frontier_compare import cases
    st = next(make() for c, k, make, _, model in cases()
              if (c, k) == (case, kind) and model is None)
    dims = (S, width) if kind == "frontier_dense" else width
    return {"case": case, "S": S, "width": width, "events": len(st),
            **c_entry_split(kind, st, dims, None)}


def multi_register_kernel_row(kind, name, stream, shape, K=None,
                              cas_case=None):
    """One frontier kernel (``frontier_dense`` or ``frontier_sparse``)
    with the multi-register transition on ``stream``, against its plain
    version on the card (every output and the path counts), timed; its
    bound counted from this run's work. ``ms`` is the wrapper's; the C
    entry's time splits into its fixed part and the rest a unit of work
    (``c_entry_split``), beside the CAS instantiation's at the same shape
    (``cas_same_shape`` of ``cas_case``)."""
    import torch
    from jepsen_tpu_torch.models import multi_register_spec
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    from jepsen_tpu_torch.ops.jitlin import _bucket
    step = multi_register_spec(*shape).step_ids
    ev = card_events(stream)
    S = max(1, stream.n_slots)
    if kind == "frontier_dense":
        V = _bucket(len(stream.intern), floor=16)
        t0 = fk.init_table(S, V, 0, "cuda")
        call = lambda: fk.frontier_dense(*ev, t0, step_ids=step)  # noqa: E731
        plain = lambda w: fk.frontier_dense_torch(  # noqa: E731
            *ev, t0, step_ids=step, work=w)
        unit = "returns"
    else:
        V = None
        m0, s0 = fk.init_frontier(K, 0, "cuda")
        call = lambda: fk.frontier_sparse(  # noqa: E731
            *ev, m0, s0, S, step_ids=step)
        plain = lambda w: fk.frontier_sparse_torch(  # noqa: E731
            *ev, m0, s0, S, step_ids=step, work=w)
        unit = "passes"
    got = call()
    warp, total = getattr(fk, kind).paths.tolist()
    work = {}
    t0_s = time.perf_counter()
    ref = plain(work)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0_s) * 1e3
    err = frontier_err(got, ref)
    if err != 0.0 or [warp, total] != [work.get(f"warp_{unit}", 0),
                                       work.get(unit, 0)]:
        raise AssertionError(f"{kind} {name}: multi-register kernel differs "
                             f"from plain: err {err}, paths {[warp, total]} "
                             f"vs {work}")
    ms = cuda_ms(call, 5)
    split = c_entry_split(kind, stream, (S, V) if V is not None else K, shape)
    if split.pop("result") != [int(x) for x in got[:4]]:
        raise AssertionError(f"{kind} {name}: the C entry differs from the "
                             f"wrapper")
    died = int(got[1])
    cas = cas_same_shape(kind, cas_case, S, V or K) if cas_case else None
    if kind == "frontier_dense":
        ops = dense_scan_ops(stream, died, V, step_ops=shape[0])
        nbytes = 20 * len(stream) + 2 * (1 << S) * V + 24
    else:
        ops = float(work.get("compares", 0) + work.get("candidates", 0))
        nbytes = 20 * len(stream) + 2 * K * 8 + 24
    t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
    return {"case": name, "shape": list(shape), "S": S, "V": V, "K": K,
            "dense_warp_path": (fk.dense_warp_path(S, V)
                                if V is not None else None),
            "events": len(stream), "result": [int(x) for x in got[:4]],
            "max_abs_err": err, "equal": True, "ms": ms,
            "c_entry": split, "cas_same_shape": cas,
            "plain_ms": plain_ms, unit: total, f"warp_{unit}": warp,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}


def multi_register_batch_row(kind, streams, K):
    """A key-batched frontier entry with the multi-register transition
    on ``streams`` (B = len(streams)) against its plain version on the
    card, timed."""
    import torch
    from jepsen_tpu_torch.models import multi_register_spec
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    step = multi_register_spec(*MR_SHAPE).step_ids
    S = max(1, max(s.n_slots for s in streams))
    batch = fk.batch_events(streams, S, "cuda")
    dense = kind == "frontier_dense_batch"
    cap = 256 if dense else K
    entry = fk.frontier_dense_batch if dense else fk.frontier_sparse_batch
    plain_fn = (fk.frontier_dense_batch_torch if dense
                else fk.frontier_sparse_batch_torch)
    got = entry(batch, cap, 0, step)
    paths = getattr(fk, kind).paths.tolist()
    work = []
    t0 = time.perf_counter()
    ref = plain_fn(batch, cap, 0, step, work)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = frontier_err(got, ref)
    unit = "returns" if dense else "passes"
    want = [[w.get(f"warp_{unit}", 0), w.get(unit, 0)] for w in work]
    if err != 0.0 or paths != want:
        raise AssertionError(f"{kind}: multi-register batch differs from "
                             f"plain: err {err}, paths {paths} vs {want}")
    ms = cuda_ms(lambda: entry(batch, cap, 0, step), 10)
    nbytes = 20 * sum(len(s) for s in streams) + 28 * len(streams) + 4
    if dense:
        ops = sum(dense_scan_ops(s, int(d), 256, step_ops=MR_SHAPE[0])
                  for s, d in zip(streams, got[1].tolist()))
    else:
        ops = float(sum(w.get("compares", 0) + w.get("candidates", 0)
                        for w in work))
    t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
    return {"keys": len(streams), "S": S, "V": 256 if dense else None,
            "K": None if dense else K, "max_abs_err": err, "equal": True,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "rows": [[int(x[b]) for x in got] for b in range(len(streams))],
            unit: sum(p[1] for p in paths)}


def multi_register_phases(name, smi) -> dict:
    """The multi-register slice on the card: the multi-key-acid checker
    through ``independent.checker(compose({"linear":
    linearizable(model=MultiRegister(), accelerator="gpu")}))`` (one
    frontier launch a key, valid and with 10 corrupted keys, each map
    equal to the port's ``accelerator="cpu"`` run), the 10k-txn history
    and its corrupted and sparse copies, each frontier kernel and batched
    entry with the multi-register transition against its plain version,
    and the (2, 3) shape through ``torch-matrix``. Returns the
    multi-register entries of the kernels line's frontier rows."""
    import numpy as np
    import torch
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker import compose
    from jepsen_tpu_torch.checker.linear_cpu import (
        check_stream, multi_register_step_py)
    from jepsen_tpu_torch.checker.linear_encode import (
        encode_multi_register_ops)
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.histories import (
        corrupt_txn_keys, corrupt_txn_reads, crash_late_writes,
        multi_key_acid_history, multi_register_history)
    from jepsen_tpu_torch.models import MultiRegister, multi_register_spec
    from jepsen_tpu_torch.ops.jitlin import JitLinKernel

    step_py = multi_register_step_py(*MR_SHAPE)
    spec = multi_register_spec(*MR_SHAPE)
    lin = linearizable(MultiRegister(), accelerator="gpu")
    chk = independent.checker(compose({"linear": lin}))
    oracle = independent.checker(compose({"linear": linearizable(
        MultiRegister(), accelerator="cpu")}))
    kernel = JitLinKernel(step_ids=spec.step_ids)

    def routes(h):
        _, subs = independent.split_history(h)
        sts = [encode_multi_register_ops(s) for s in subs.values()]
        return sts, [kernel.route(s.n_slots, len(s.intern)) for s in sts]

    def split(h, check_med):
        """Host seconds of the check's parts, one after another: the
        split by key, the encode, every key's frontier rung, and the twin
        for the keys the rung leaves unknown or invalid (their verdict,
        or the invalid ones' final configurations)."""
        t0 = time.perf_counter()
        _, subs = independent.split_history(h)
        t1 = time.perf_counter()
        sts = [lin._encoding(s)[0] for s in subs.values()]
        t2 = time.perf_counter()
        outs = [kernel.check(s) for s in sts]
        t3 = time.perf_counter()
        for s, o in zip(sts, outs):
            if not o[0]:
                check_stream(s, step=step_py)
        t4 = time.perf_counter()
        parts = dict(zip(("split", "encode", "rung", "twin"),
                         (t1 - t0, t2 - t1, t3 - t2, t4 - t3)))
        parts["threads_and_rest"] = check_med - sum(parts.values())
        return parts

    # 11a. the main path: 500 multi-key-acid keys, valid
    acid_t0 = time.perf_counter()
    h = multi_key_acid_history(ACID_GROUPS, ACID_PER_GROUP, ACID_PROCS)
    sts, rts = routes(h)
    n_dense, n_sparse = rts.count("dense"), rts.count("sparse")
    t0 = time.perf_counter()
    want = oracle.check({}, h, {})
    oracle_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    got = chk.check({}, h, {})
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    same_linear_maps("multi_key_acid", got, want)
    if got["valid?"] is not True:
        raise AssertionError(f"multi_key_acid: {got['valid?']}")
    if (launches["frontier_dense"], launches["frontier_sparse"]) != (
            n_dense, n_sparse) or n_dense + n_sparse != ACID_GROUPS \
            or any(v for k, v in launches.items()
                   if k not in ("frontier_dense", "frontier_sparse")):
        raise AssertionError(f"multi_key_acid launches {launches}, routes "
                             f"{n_dense} dense, {n_sparse} sparse")
    algs = {}
    for r in got["results"].values():
        a = r["linear"]["algorithm"]
        algs[a] = algs.get(a, 0) + 1
    # the first check is warm (the kernels ran in phases 9-10): it is the
    # first of the 3 timed checks, and the profiler takes no warm-up call
    more_s, _ = timed(lambda: chk.check({}, h, {}), 2)
    check_s = [first_s] + more_s
    med = statistics.median(check_s)
    med_split = split(h, med)
    busy = device_kernels(lambda: chk.check({}, h, {}), "frontier",
                          warm=False)
    busy_ms = sum(us for _, us in busy) / 1e3
    by_kernel = {}
    for kname, us in busy:
        by_kernel[kname] = by_kernel.get(kname, 0.0) + us
    emit({"phase": "multi_key_acid", "keys": ACID_GROUPS,
          "txns_per_key": ACID_PER_GROUP, "procs_per_key": ACID_PROCS,
          "shape": list(MR_SHAPE), "states": len(sts[0].intern),
          "txns": ACID_GROUPS * ACID_PER_GROUP,
          "events": sum(len(s) for s in sts),
          "slots_by_key": {str(S): sum(s.n_slots == S for s in sts)
                           for S in sorted({s.n_slots for s in sts})},
          "routes": {"dense": n_dense, "sparse": n_sparse},
          "algorithms": algs, "valid": got["valid?"],
          "launches_per_check": launches, "first_check_s": first_s,
          "check_s": check_s, "median_check_s": med,
          "txns_per_sec": ACID_GROUPS * ACID_PER_GROUP / med,
          "split_s": med_split, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / 1e3 / med,
          "device_us_by_kernel": sorted(by_kernel.items(),
                                        key=lambda kv: -kv[1])[:6],
          "cpu_oracle_check_s": oracle_s, "card": name, "power": smi})

    # 11b. 10 keys with an impossible read. The other keys' sub-histories
    # are 11a's, so the cpu oracle checks the 10 keys alone and takes 11a's
    # results for the rest
    hb = corrupt_txn_keys(h, ACID_BAD, n=1)
    from jepsen_tpu_torch.independent import is_tuple_value
    want_bad = oracle.check({}, [op for op in hb
                                 if is_tuple_value(op.get("value"))
                                 and op["value"][0] in ACID_BAD], {})
    want_b = {"valid?": False, "count": want["count"],
              "failures": want_bad["failures"],
              "results": {**want["results"], **want_bad["results"]}}
    reset_launches()
    t0 = time.perf_counter()
    got_b = chk.check({}, hb, {})
    torch.cuda.synchronize()
    check_b = time.perf_counter() - t0
    lb = read_launches()
    same_linear_maps("multi_key_acid_invalid", got_b, want_b)
    if got_b["failures"] != sorted(str(k) for k in ACID_BAD) \
            or lb["frontier_dense"] + lb["frontier_sparse"] != ACID_GROUPS:
        raise AssertionError(f"multi_key_acid_invalid: {got_b['failures']}"
                             f", {lb}")
    bad_algs = {}
    for k in got_b["failures"]:
        a = got_b["results"][k]["linear"]["algorithm"]
        bad_algs[a] = bad_algs.get(a, 0) + 1
    emit({"phase": "multi_key_acid_invalid", "bad_keys": list(ACID_BAD),
          "failures": got_b["failures"], "failure_algorithms": bad_algs,
          "launches": lb, "check_s": check_b,
          "acid_phase_s": time.perf_counter() - acid_t0,
          "card": name, "power": smi})

    # 11c. one 10k-txn history at the same width: the dense table's CTA
    # path; two impossible reads; a copy whose last writes crash (S = 10:
    # the sparse list)
    h10 = multi_register_history(MR_TXNS, 5, *MR_SHAPE, seed=SEED)
    copies = (("valid", h10), ("corrupted", corrupt_txn_reads(h10, 2)),
              ("sparse", crash_late_writes(h10)),
              ("sparse_corrupted", corrupt_txn_reads(crash_late_writes(h10),
                                                     2, seed=1)))
    long_rows = {}
    for copy, hh in copies:
        st = encode_multi_register_ops(hh)
        t0 = time.perf_counter()
        twin = check_stream(st, step=step_py)
        twin_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = linearizable(MultiRegister(), accelerator="cpu").check(
            {}, hh, {})
        cpu_s = time.perf_counter() - t0
        reset_launches()
        times, res = timed(lambda: lin.check({}, hh, {}), 3)
        lc = {k: v / 3 for k, v in read_launches().items()}
        rung_s, rung = timed(lambda: kernel.check(st), 3)
        route = kernel.route(st.n_slots, len(st.intern))
        # the dense table's death is exact even when its out-of-range
        # flag is set (only states past the map's 216 leave the table);
        # an overflowed list's is not
        if (res["valid?"], res.get("failed-op")) != (
                cpu["valid?"], cpu.get("failed-op")) \
                or res["valid?"] is not twin.valid \
                or res["valid?"] is ("corrupted" in copy) \
                or route != ("sparse" if copy.startswith("sparse")
                             else "dense") \
                or lc[f"frontier_{route}"] != 1 \
                or (not rung[0] and (route == "dense" or not rung[2])
                    and rung[1] != twin.failed_event):
            raise AssertionError(f"multi_register {copy}: {res} vs {cpu}, "
                                 f"twin {twin.valid} at "
                                 f"{twin.failed_event}, rung {rung}, {lc}")
        long_rows[copy] = st
        emit({"phase": "multi_register_long", "copy": copy,
              "txns": MR_TXNS, "procs": 5, "events": len(st),
              "slots": st.n_slots, "route": route,
              "algorithm": res["algorithm"], "valid": res["valid?"],
              "configs_max": res["configs-max"], "rung_result": list(rung),
              "twin_failed_event": twin.failed_event, "launches": lc,
              "check_s": times, "median_check_s": statistics.median(times),
              "median_rung_s": statistics.median(rung_s),
              "twin_s": twin_s, "cpu_check_s": cpu_s,
              "card": name, "power": smi})

    # 11d. each kernel with the multi-register transition against its
    # plain version, on 1k-txn histories: (3, 5) on the dense CTA path,
    # (2, 3) on the dense warp path, (3, 5) on the sparse list; the
    # batched entries at B = 8
    h1 = multi_register_history(MR_KERNEL_TXNS, 5, *MR_SHAPE, seed=SEED + 1)
    h23 = multi_register_history(MR_KERNEL_TXNS, 5, 2, 3, seed=SEED + 2)
    rows = {
        "dense_cta": multi_register_kernel_row(
            "frontier_dense", "dense_cta_3x5",
            encode_multi_register_ops(h1), MR_SHAPE, cas_case="cas_s5_v256"),
        "dense_cta_invalid": multi_register_kernel_row(
            "frontier_dense", "dense_cta_3x5_invalid",
            encode_multi_register_ops(corrupt_txn_reads(h1, 2)), MR_SHAPE),
        "dense_warp": multi_register_kernel_row(
            "frontier_dense", "dense_warp_2x3",
            encode_multi_register_ops(h23, 2, 3), (2, 3),
            cas_case="cas_s5_v16"),
        "sparse": multi_register_kernel_row(
            "frontier_sparse", "sparse_3x5_s10",
            encode_multi_register_ops(crash_late_writes(h1)), MR_SHAPE,
            K=256, cas_case="cas_s10_k256"),
        "sparse_s5": multi_register_kernel_row(
            "frontier_sparse", "sparse_3x5_s5",
            encode_multi_register_ops(h1), MR_SHAPE, K=256,
            cas_case="cas_s5_k256"),
    }
    if rows["dense_cta"]["dense_warp_path"] \
            or not rows["dense_warp"]["dense_warp_path"] \
            or rows["sparse"]["S"] < 10:
        raise AssertionError(f"multi-register kernel paths: {rows}")
    for key, row in rows.items():
        emit({"phase": "multi_register_kernel", "kernel": key, **row,
              "card": name, "power": smi})
    # batches as batch_check would route them: 8 keys in the dense
    # table's regime (S <= 9), and 8 keys with S up to 10 on the list
    hb8 = corrupt_txn_keys(multi_key_acid_history(24, seed=SEED), (2, 5))
    _, subs8 = independent.split_history(hb8)
    sts8 = [encode_multi_register_ops(s) for s in subs8.values()]
    batch_rows = {
        "frontier_dense_batch": multi_register_batch_row(
            "frontier_dense_batch", [s for s in sts8 if s.n_slots <= 9][:8],
            None),
        "frontier_sparse_batch": multi_register_batch_row(
            "frontier_sparse_batch", sts8[:8], 256)}
    for kind, row in batch_rows.items():
        emit({"phase": "multi_register_batch", "kernel": kind, **row,
              "card": name, "power": smi})

    # 11e. the (2, 3) shape (16 states) through torch-matrix
    hm = multi_register_history(2100, 3, 2, 3, seed=SEED + 3)
    stm = encode_multi_register_ops(hm, 2, 3)
    lin23 = linearizable(MultiRegister(), accelerator="gpu",
                         multi_shape=(2, 3))
    reset_launches()
    got_m = lin23.check({}, hm, {})
    torch.cuda.synchronize()
    lm = read_launches()
    twin_m = check_stream(stm, step=multi_register_step_py(2, 3))
    if got_m["algorithm"] != "torch-matrix" or got_m["valid?"] is not \
            twin_m.valid or min(lm["chunk_product"],
                                lm["combine_product"]) < 1 \
            or int((np.asarray(stm.kind) == 1).sum()) < 2000:
        raise AssertionError(f"multi_register (2, 3) matrix: {got_m}, {lm}")
    m_s, _ = timed(lambda: lin23.check({}, hm, {}), 3)
    emit({"phase": "multi_register_matrix_2x3", "txns": 2100,
          "returns": int((np.asarray(stm.kind) == 1).sum()),
          "slots": stm.n_slots, "states": len(stm.intern),
          "algorithm": got_m["algorithm"], "valid": got_m["valid?"],
          "launches": lm, "median_check_s": statistics.median(m_s),
          "card": name, "power": smi})

    st_main = long_rows["valid"]
    return {
        "frontier_dense": {
            **rows["dense_cta"], "launches": launches["frontier_dense"],
            "warp_2x3": rows["dense_warp"],
            "cta_3x5_invalid": rows["dense_cta_invalid"],
            "main_path": "multi_key_acid (500 keys, one launch a key)",
            "long_history_events": len(st_main)},
        "frontier_sparse": {
            **rows["sparse"], "launches": launches["frontier_sparse"],
            "s5": rows["sparse_s5"],
            "main_path": "multi_key_acid (500 keys, one launch a key)"},
        "frontier_dense_batch": {**batch_rows["frontier_dense_batch"],
                                 "launches": 0},
        "frontier_sparse_batch": {**batch_rows["frontier_sparse_batch"],
                                  "launches": 0},
    }


# the forensics slice's cases (``ops.forensics_compare``): prefix_alive
# on seeded products of every chain design, with a dead chunk early, late
# and none, and a dense frontier that dies late; window_rescan on seeded
# inputs of every S and V the matrix regime takes, both of its paths


def check_prefix_alive(C, MV, kill_at, dense, seed):
    import torch
    from jepsen_tpu_torch.ops import forensics_kernels as fx
    from jepsen_tpu_torch.ops.forensics_compare import (card_products,
                                                        first_dead)
    P = card_products(C, MV, seed, kill_at, dense)
    v0 = torch.zeros((MV,), dtype=torch.bool, device="cuda")
    v0[0] = True
    got = fx.prefix_alive(P, v0)
    want = fx.prefix_alive_torch(P, v0)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                              want[1]))
    dead = first_dead(want[0])
    row = {"phase": "prefix_alive_kernel", "C": C, "MV": MV,
           "kill_at": kill_at, "dense": dense, "first_dead": dead,
           "equal": equal, "path": fx.prefix_plan(C, MV),
           "ms": cuda_ms(lambda: fx.prefix_alive(P, v0), 5),
           "plain_ms": cuda_ms(lambda: fx.prefix_alive_torch(P, v0), 2)}
    emit(row)
    if not equal:
        raise AssertionError(f"prefix_alive C={C} MV={MV} differs from "
                             f"plain")
    if dead != (-1 if kill_at is None else kill_at):
        raise AssertionError(f"prefix_alive C={C} MV={MV}: dead at {dead}, "
                             f"planted {kill_at}")


def check_window_rescan(case, args, reps=20):
    """The rescan kernel against its plain version; returns the row."""
    import torch
    from jepsen_tpu_torch.ops import forensics_kernels as fx
    got = fx.window_rescan(*args)
    want = fx.window_rescan_torch(*args)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got[0], want[0])
                 and torch.equal(got[1], want[1]))
    K, T, S = args[0].shape
    row = {"phase": "window_rescan_kernel", "case": case, "K": K, "T": T,
           "S": S, "V": args[3].shape[1], "equal": equal,
           "path": rescan_path(S),
           "first": got[0][:8].tolist(),
           "inexact_any": bool(got[1].any().item()),
           "ms": cuda_ms(lambda: fx.window_rescan(*args), reps),
           "plain_ms": cuda_ms(lambda: fx.window_rescan_torch(*args), 2)}
    emit(row)
    if not equal:
        raise AssertionError(f"window_rescan {case} differs from plain")
    return row


def rescan_path(S) -> str:
    """The rescan kernel's path at S slots: a warp a candidate, or a CTA
    a candidate with the sets in shared memory."""
    from jepsen_tpu_torch.ops import forensics_kernels as fx
    return "warp" if S <= fx.RESCAN_WARP_MAX_SLOTS else "shared"


def rescan_ops(args, first) -> float:
    """The rescan's integer operations on these inputs: per candidate,
    the pending slots' oob test at every return, and at each valid
    return up to its death the closure's images (2^(S-1) masks hold each
    pending slot, V states an image) and the kill of the M masks."""
    import numpy as np
    pend, valid = (a.cpu().numpy() for a in args[:2])
    K, T, S = pend.shape
    V = args[3].shape[1]
    upto = np.arange(T)[None, :] <= np.where(first.cpu().numpy() < 0, T,
                                              first.cpu().numpy())[:, None]
    live = valid & upto
    npend = (pend & valid[..., None]).sum(axis=2)
    return float(K * T * S + ((npend * (1 << (S - 1)) * V + (1 << S))
                              * live).sum())


def forensics_phase(chk, bad, bad_stream, twin_bad, cpu_bad, got_bad, name,
                    smi) -> dict:
    """The corrupted headline with ``explain`` on: settled at
    ``torch-matrix`` with the twin's failing op, through one
    ``prefix_alive`` and at least one ``window_rescan`` launch and no
    frontier launch; then its split. Returns the launches."""
    import torch
    from jepsen_tpu_torch.checker.explain import explain_stream
    from jepsen_tpu_torch.checker.linear_cpu import check_stream
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    from jepsen_tpu_torch.ops import forensics_kernels as fx
    from jepsen_tpu_torch.ops import jitlin
    reset_launches()
    t0 = time.perf_counter()
    got = chk.check({}, bad, {})
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    if got["valid?"] is not False or got["algorithm"] != "torch-matrix" \
            or got.get("failed-op") != cpu_bad.get("failed-op") \
            or got.get("failed-op") != got_bad.get("failed-op") \
            or got.get("final-configs") != cpu_bad.get("final-configs"):
        raise AssertionError(f"forensics check: {got} vs {cpu_bad}")
    ex = got.get("explain") or {}
    if ex.get("backend") != "matrix-bisect" \
            or ex.get("first-anomaly-op") != twin_bad.failed_op_index:
        raise AssertionError(f"forensics explain: {ex}, twin op "
                             f"{twin_bad.failed_op_index}")
    if launches["prefix_alive"] != 1 or launches["window_rescan"] < 1 \
            or launches["frontier_dense"] != 0 \
            or launches["frontier_sparse"] != 0 \
            or launches["chunk_product"] != 2 \
            or launches["combine_product"] != 1:
        raise AssertionError(f"forensics path's launches: {launches}")
    # where the check's time goes: the encode, the matrix check, the
    # localization (grids, products, prefix chain, rescan: host seconds,
    # each ending in a read-back), the witness shrink on that
    # localization, and the twin's re-run for final-configs
    split = {k: [] for k in ("check", "encode", "matrix", "localize",
                             "shrink", "twin")}
    loc_parts, shrink = [], None
    for _ in range(5):
        for key, fn in (
                ("check", lambda: chk.check({}, bad, {})),
                ("encode", lambda: encode_register_ops(bad)),
                ("matrix", lambda: jitlin.matrix_check(bad_stream)),
                ("localize", lambda: jitlin.matrix_localize(bad_stream)),
                ("shrink", lambda: explain_stream(bad_stream, loc=loc)),
                ("twin", lambda: check_stream(bad_stream))):
            n_rescan = fx.window_rescan.launches
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            split[key].append(time.perf_counter() - t0)
            if key == "localize":
                loc = out
                loc_parts.append(jitlin.last_localize_seconds())
            elif key == "shrink":
                shrink = {"rounds": out["witness"]["rounds"],
                          "candidates": out["witness"]["candidates"],
                          "launches": fx.window_rescan.launches - n_rescan,
                          "witness_ops": len(out["witness"]["op_indices"]),
                          "window_op_count":
                              out["witness"]["window_op_count"],
                          "minimal": out["witness"]["minimal"]}
    # the default knobs stop at 16 witness ops; shrinking this window to 1
    # takes ddmin rounds, each one rescan launch of its candidates
    n_rescan = fx.window_rescan.launches
    t0 = time.perf_counter()
    out = explain_stream(bad_stream, loc=loc, max_witness_ops=1)
    torch.cuda.synchronize()
    shrink_to_1 = {"s": time.perf_counter() - t0,
                   "rounds": out["witness"]["rounds"],
                   "candidates": out["witness"]["candidates"],
                   "launches": fx.window_rescan.launches - n_rescan,
                   "witness_ops": len(out["witness"]["op_indices"]),
                   "minimal": out["witness"]["minimal"]}
    if shrink_to_1["launches"] != shrink_to_1["rounds"] \
            or shrink_to_1["rounds"] < 1:
        raise AssertionError(f"the shrink's rounds: {shrink_to_1}")
    by_name = {}
    for kname, us in device_kernels(lambda: chk.check({}, bad, {}),
                                    "window_rescan"):
        by_name[kname] = by_name.get(kname, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    med = statistics.median(split["check"])
    emit({"phase": "main_path_forensics", "ops": N_OPS,
          "events": len(bad_stream), "algorithm": got["algorithm"],
          "failed_op": got["failed-op"], "explain": ex,
          "launches": launches, "first_check_s": first_s,
          "check_s": split["check"], "median_check_s": med,
          "median_split_s": {k: statistics.median(v)
                             for k, v in split.items()},
          "median_localize_split_s": {
              k: statistics.median(p[k] for p in loc_parts)
              for k in loc_parts[0]},
          "localization": {"chunk": loc.chunk, "step": loc.step,
                           "n_chunks": loc.n_chunks,
                           "chunk_returns": loc.chunk_returns,
                           "failed_event": loc.failed_event},
          "shrink": shrink, "shrink_to_1_op": shrink_to_1,
          "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / 1e3 / med,
          "device_us_by_kernel": sorted(by_name.items(),
                                        key=lambda kv: -kv[1])[:10],
          "card": name, "power": smi})
    return launches


def forensics_rows(pc, launches, scan_bound, named_ms) -> list:
    """The kernels line's prefix_alive and window_rescan rows at the
    corrupted headline's shapes (``planted_chunk``; the rescan at the
    localization's K = 1), each against its plain version, with the C
    entry alone on the wrapper's operands (``entry_ms``) and the
    profiler's device time; the bounds count this run's data: the chunks up to
    the first dead one (each entry read once and compared, each packed
    word ANDed), and the rescan's inputs and its operations
    (``rescan_ops``), integer operations at the float32 rate."""
    import torch
    from jepsen_tpu_torch.ops import _build
    from jepsen_tpu_torch.ops import forensics_kernels as fx
    from jepsen_tpu_torch.ops.forensics_compare import (
        chunk_candidates, prefix_entry, rescan_caller)
    P, v0, MV, C = pc["P"], pc["v0"], pc["MV"], pc["C"]
    W = max(1, MV // 32)
    got = fx.prefix_alive(P, v0)
    want = fx.prefix_alive_torch(P, v0)
    err_pa = max(
        (got[0].int() - want[0].int()).abs().max().item(),
        (fx.unpack_bits(got[1], MV).int()
         - fx.unpack_bits(want[1], MV).int()).abs().max().item())
    pa_k = device_kernels(lambda: fx.prefix_alive(P, v0), "chain_kernel")
    # the C entries alone, on the operands their wrappers derive
    pa_entry, pa_out = prefix_entry(
        _build.library("prefix_alive").jt_prefix_alive, P, v0)
    pa_entry()
    if not (torch.equal(pa_out[0], want[0].to(torch.int32))
            and torch.equal(pa_out[1], want[1])):
        raise AssertionError("the prefix_alive entry differs from plain")
    c1 = pc["c_star"] + 1
    bnd_pa = scan_bound(c1 * (MV * MV + MV * W),
                        c1 * MV * MV * 2 + MV + C + (C + 1) * W * 4)
    args = chunk_candidates(pc, 1, 1)
    got_r = fx.window_rescan(*args)
    want_r = fx.window_rescan_torch(*args)
    err_r = max((got_r[0] - want_r[0]).abs().max().item(),
                (got_r[1].int() - want_r[1].int()).abs().max().item())
    wr_k = device_kernels(lambda: fx.window_rescan(*args),
                          "window_rescan_kernel")
    wr_entry, _, wr_out = rescan_caller(
        _build.library("window_rescan").jt_window_rescan, True, args)
    wr_entry()
    if not (torch.equal(wr_out[0], want_r[0])
            and torch.equal(wr_out[1].bool(), want_r[1])):
        raise AssertionError("the window_rescan entry differs from plain")
    ops_r = rescan_ops(args, want_r[0])
    bytes_r = (sum(a.numel() * a.element_size() for a in args)
               + 4 * 4 + 4)
    rows = []
    for kname, src, rep, err, ms, pms, bnd, extra in (
            ("prefix_alive", "jepsen_tpu_torch/ops/csrc/prefix_alive.cu",
             "jepsen_tpu/ops/jitlin.py:1623", err_pa,
             cuda_ms(lambda: fx.prefix_alive(P, v0), 20),
             cuda_ms(lambda: fx.prefix_alive_torch(P, v0), 3), bnd_pa,
             {"C": C, "MV": MV, "first_dead": pc["c_star"],
              "path": fx.prefix_plan(C, MV), "entry_ms": cuda_ms(pa_entry, 50),
              "device_ms": sum(us for k, us in pa_k if k.startswith(
                  ("pack_kernel", "warp_chain_kernel", "chain_kernel")))
              / 1e3,
              "device_kernels_us": pa_k, "bytes": c1 * MV * MV * 2}),
            ("window_rescan", "jepsen_tpu_torch/ops/csrc/window_rescan.cu",
             "jepsen_tpu/ops/jitlin.py:1640", err_r,
             cuda_ms(lambda: fx.window_rescan(*args), 50),
             cuda_ms(lambda: fx.window_rescan_torch(*args), 3),
             scan_bound(ops_r, bytes_r),
             {"K": 1, "T": pc["T"], "S": pc["S"], "V": pc["V"],
              "path": rescan_path(pc["S"]), "first": got_r[0].tolist(),
              "entry_ms": cuda_ms(wr_entry, 50),
              "device_ms": named_ms(wr_k, "window_rescan_kernel"),
              "device_kernels_us": wr_k, "int_ops": ops_r,
              "bytes": bytes_r})):
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[kname],
                     "max_abs_err": float(err), "equal": err == 0,
                     "ms": ms, "plain_ms": pms, "bound_ms": bnd[0],
                     "bound_by": bnd[1], "library_ms": None,
                     "bound_operations": "int32_ops", **extra})
        if err != 0:
            raise AssertionError(f"{kname} differs at the main path's shape")
    return rows


# ---------------------------------------------------------------------------
# 12. resumable long checks: the segmented chains and checkpoints
# ---------------------------------------------------------------------------

# the long history: the headline's shape (5 processes, 5 values) at 70x its
# depth, past MATRIX_SEGMENT_EVENTS = 2^20 events: two segments
LONG_OPS = 700_000
# the sparse list's long history (every write a fresh value) and its bound
LONG_SPARSE_OPS, LONG_SPARSE_SEGMENT = 100_000, 1 << 16


def corrupt_read_between(history, stream, lo: int, hi: int):
    """(a shallow copy of ``history`` whose first ok read returning at an
    event in [lo, hi) answers 999, that read's history index)."""
    import numpy as np
    rets = np.nonzero(stream.kind[lo:hi] == 1)[0] + lo
    for e in rets:
        i = int(stream.op_index[e])
        if history[i]["f"] == "read" and history[i]["type"] == "ok":
            bad = list(history)
            bad[i] = dict(history[i], value=999)
            return bad, i
    raise AssertionError(f"no ok read returns in events [{lo}, {hi})")


def segmented_phases(name, smi) -> dict:
    """Phase 12: the long history through the resumable chains on the
    card. Returns the kernels line's entries for this phase, by row."""
    import json
    import tempfile
    from pathlib import Path

    import torch
    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.checker import checkpoint as ck
    from jepsen_tpu_torch.checker.linear_cpu import (
        FrontierSession, cas_register_step_py, check_stream)
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.convert import frontier_from_numpy
    from jepsen_tpu_torch.histories import register_history
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    from jepsen_tpu_torch.ops import jitlin

    phase_t0 = time.perf_counter()
    t0 = time.perf_counter()
    h = register_history(LONG_OPS, n_procs=N_PROCS, seed=SEED,
                         n_values=N_VALUES)
    gen_s = time.perf_counter() - t0
    stream = encode_register_ops(h)
    n = len(stream)
    seg_max = jitlin.MATRIX_SEGMENT_EVENTS
    cuts = jitlin.quiescent_cuts(stream.kind, seg_max)
    if n <= seg_max or len(cuts) != 2:
        raise AssertionError(f"long history: {n} events, cuts {cuts}")
    cut = cuts[0]
    V = jitlin._bucket(len(stream.intern), floor=8)
    # the twin, through one session: its frontier at the cut, then the rest
    t0 = time.perf_counter()
    twin_fs = FrontierSession()
    twin_fs.absorb(stream, end=cut)
    at_cut = set(twin_fs.configs)
    snap_at_cut = twin_fs.snapshot()
    twin = twin_fs.absorb(stream, start=cut)
    twin_s = time.perf_counter() - t0
    if twin.valid is not True:
        raise AssertionError("the CPU twin rejects the long history")
    chk = linearizable(accelerator="gpu")

    # 12a. the main path: two chain segments, one chunk product and one
    # combine launch each
    reset_launches()
    t0 = time.perf_counter()
    res = chk.check({}, h, {})
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    if res["valid?"] is not True or res["algorithm"] != "torch-matrix":
        raise AssertionError(f"long check: {res}")
    if (launches["chunk_product"], launches["combine_product"]) != (2, 2) \
            or any(v for k, v in launches.items()
                   if k not in ("chunk_product", "combine_product")):
        raise AssertionError(f"long check's launches: {launches}")
    check_s, enc_s, segs, one_s = [], [], [], []
    for _ in range(3):
        t0 = time.perf_counter()
        chk.check({}, h, {})
        torch.cuda.synchronize()
        check_s.append(time.perf_counter() - t0)
        segs.append(jitlin.last_segment_seconds())
        t0 = time.perf_counter()
        encode_register_ops(h)
        enc_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        one = jitlin.matrix_check(stream)
        torch.cuda.synchronize()
        one_s.append(time.perf_counter() - t0)
        if one[:3] != (True, -1, False):
            raise AssertionError(f"one-shot matrix_check: {one}")
    carries = []
    chain = jitlin.matrix_check_segmented(stream, carry_sink=carries.append)
    _, _, total = jitlin.matrix_check_resume(
        stream, num_states=len(stream.intern), n_slots=stream.n_slots)
    if chain != (True, -1, False, 0) or len(carries) != 2 \
            or [c["events_done"] for c in carries] != cuts \
            or not torch.equal(carries[-1]["tot0"], total):
        raise AssertionError("the chain's final carry differs from the "
                             "one-shot total")
    # the check's device work is the chain's (the encode launches
    # nothing), so the profiler traces the chain alone
    by_name = {}
    for kname, us in device_kernels(
            lambda: jitlin.matrix_check_segmented(stream)):
        by_name[kname] = by_name.get(kname, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    med = statistics.median(check_s)
    LIVE_RUNS["long"] = (h, res, check_s)
    LIVE_RUNS["long_stream"] = stream
    prep = jitlin._returns_prepass(stream.kind, stream.slot, stream.f,
                                   stream.a, stream.b)
    plans = []
    for lo, hi in zip([0] + cuts[:-1], cuts):
        r = int((stream.kind[lo:hi] == 1).sum())
        plans.append(dict(zip(("C", "T"), jitlin._matrix_plan(
            1, prep[3], r, V)), returns=r, events=hi - lo))
    emit({"phase": "segmented_main_path", "ops": LONG_OPS, "events": n,
          "returns": int(len(prep[0])), "S": prep[3], "V": V, "cuts": cuts,
          "segment_plans": plans, "valid": res["valid?"],
          "algorithm": res["algorithm"], "twin_valid": twin.valid,
          "launches": launches, "generate_s": gen_s, "twin_s": twin_s,
          "first_check_s": first_s, "check_s": check_s,
          "median_check_s": med, "ops_per_sec": LONG_OPS / med,
          "median_encode_s": statistics.median(enc_s),
          "median_segment_s": [statistics.median(sg[i]["s"] for sg in segs)
                               for i in range(len(cuts))],
          "one_shot_matrix_check_s": one_s,
          "median_one_shot_matrix_check_s": statistics.median(one_s),
          "carry_equals_one_shot_total": True,
          "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / 1e3 / med,
          "device_us_by_kernel": sorted(by_name.items(),
                                        key=lambda kv: -kv[1])[:8],
          "card": name, "power": smi})

    # 12b. invalid copies: one read answering 999 in the second segment
    # (the chain runs both segments, then localizes over the whole stream)
    # and in the first (the chain stops after one)
    invalid = {}
    for copy, lo, hi in (("second_segment", cut + (n - cut) // 2, n),
                         ("first_segment", cut // 4, cut)):
        bad, bad_i = corrupt_read_between(h, stream, lo, hi)
        bad_stream = encode_register_ops(bad)
        t0 = time.perf_counter()
        if copy == "second_segment":
            # the columns up to the cut are the valid history's, so the
            # twin resumes from its session at the cut
            if ck.stream_prefix_hash(bad_stream, cut) != \
                    ck.stream_prefix_hash(stream, cut):
                raise AssertionError("the corrupted copy's prefix differs")
            tw = FrontierSession.restore(snap_at_cut).absorb(bad_stream,
                                                             start=cut)
        else:
            tw = check_stream(bad_stream)
        tw_s = time.perf_counter() - t0
        if tw.valid is not False or tw.failed_op_index != bad_i:
            raise AssertionError(f"{copy}: the twin's failure {tw}")
        reset_launches()
        t0 = time.perf_counter()
        got = chk.check({}, bad, {})
        torch.cuda.synchronize()
        got_s = time.perf_counter() - t0
        lc = read_launches()
        n_seg = len(jitlin.last_segment_seconds())
        want_seg = 2 if copy == "second_segment" else 1
        if got["valid?"] is not False or got["algorithm"] != "torch-matrix" \
                or got.get("failed-op") != bad[tw.failed_op_index] \
                or n_seg != want_seg \
                or lc["chunk_product"] != want_seg + 1 \
                or lc["combine_product"] != want_seg \
                or lc["prefix_alive"] != 1 or lc["window_rescan"] < 1 \
                or lc["frontier_dense"] or lc["frontier_sparse"]:
            raise AssertionError(f"{copy}: {got} with launches {lc}, "
                                 f"{n_seg} segments")
        # the localization again, alone: its split from the profiler's
        # warm-up call, its kernels' device time from the traced one
        locs = []

        def localize():
            locs.append((jitlin.matrix_localize(bad_stream),
                         jitlin.last_localize_seconds()))
        loc_k = device_kernels(localize, "window_rescan_kernel")
        loc, loc_split = locs[0]
        if loc.failed_event != tw.failed_event:
            raise AssertionError(f"{copy}: localized at {loc.failed_event}, "
                                 f"the twin at {tw.failed_event}")
        invalid[copy] = dict(
            loc_split=loc_split, T=loc.chunk_returns, C=loc.n_chunks,
            prefix_device_ms=sum(us for k, us in loc_k if k.startswith(
                ("pack_kernel", "warp_chain_kernel", "chain_kernel"))) / 1e3,
            rescan_device_ms=sum(us for k, us in loc_k if k.startswith(
                "window_rescan_kernel")) / 1e3)
        emit({"phase": "segmented_invalid", "copy": copy, "events":
              len(bad_stream), "corrupted_op": bad_i,
              "failed_op": got["failed-op"], "twin_failed_op_index":
              tw.failed_op_index, "twin_s": tw_s,
              "twin_resumed_at_cut": copy == "second_segment",
              "explain": got.get("explain"), "launches": lc,
              "chain_segments": n_seg, "check_s": got_s,
              "localization": {"chunk": loc.chunk, "step": loc.step,
                               "n_chunks": loc.n_chunks,
                               "chunk_returns": loc.chunk_returns,
                               "failed_event": loc.failed_event},
              "localize_split_s": loc_split,
              "localize_device_ms": {
                  "prefix_alive": invalid[copy]["prefix_device_ms"],
                  "window_rescan": invalid[copy]["rescan_device_ms"]},
              "card": name, "power": smi})

    # 12c. checkpoints: a chain that persists after each segment, the same
    # chain resumed from its check.ckpt (one segment of two), and the
    # checker resuming a planted checkpoint through its test map
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "chain" / ck.CKPT_NAME
        full_c = []
        t0 = time.perf_counter()
        full = jitlin.matrix_check_segmented(
            stream, carry_sink=full_c.append,
            ckpt=ck.CheckpointStore(path, interval_s=0.0, resume=False))
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        if not path.exists():
            raise AssertionError("the chain wrote no check.ckpt")
        doc = json.loads(path.read_text())
        if (doc["kind"], doc["events_done"], doc["segment"]) != \
                ("matrix", cut, 1):
            raise AssertionError(f"check.ckpt: {doc['kind']} at "
                                 f"{doc['events_done']}")
        res_c = []
        reset_launches()
        t0 = time.perf_counter()
        resumed = jitlin.matrix_check_segmented(
            stream, carry_sink=res_c.append,
            ckpt=ck.CheckpointStore(path, interval_s=None, resume=True))
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
        lc_res = read_launches()
        ran = jitlin.last_segment_seconds()
        if resumed != full or len(ran) != 1 or ran[0]["base"] != cut \
                or lc_res["chunk_product"] != 1 \
                or not torch.equal(res_c[-1]["tot0"], full_c[-1]["tot0"]):
            raise AssertionError(f"resumed chain: {resumed} vs {full}, "
                                 f"segments {ran}, launches {lc_res}")
        test = {"name": "chip-smoke", "start_time": "20261018T000000.000Z",
                "store_dir": d}
        planted = store.path(test, ck.CKPT_NAME)
        planted.parent.mkdir(parents=True)
        planted.write_text(path.read_text())
        reset_launches()
        t0 = time.perf_counter()
        out = chk.check(test, h, {})
        torch.cuda.synchronize()
        ckpt_check_s = time.perf_counter() - t0
        lc_chk = read_launches()
        if out != res or planted.exists() \
                or len(jitlin.last_segment_seconds()) != 1 \
                or lc_chk["chunk_product"] != 1:
            raise AssertionError(f"checker resume: {out}, launches "
                                 f"{lc_chk}, ckpt left: {planted.exists()}")
        emit({"phase": "segmented_resume", "events": n, "cut": cut,
              "ckpt_bytes": len(path.read_text()),
              "full_chain_s": full_s, "resumed_chain_s": resumed_s,
              "resumed_segments": len(ran), "launches_resumed": lc_res,
              "carry_equal": True, "checker_resumed_check_s": ckpt_check_s,
              "checker_full_median_check_s": med,
              "checker_launches": lc_chk, "ckpt_cleared": True,
              "card": name, "power": smi})

        # 12d. the frontier chain against one-shot scans: the dense table
        # on the long history, the sparse list on a fresh-value one; the
        # frontier the chain persists at its last cut equals the one-shot
        # scan's there, and the last segment from it ends on the one-shot
        # scan's final frontier
        fresh = register_history(LONG_SPARSE_OPS, n_procs=N_PROCS,
                                 seed=SEED, n_values=FRESH_VALUES)
        frontier_rows = {}
        kernel = jitlin.JitLinKernel()
        for kind, st, seg in (
                ("dense", stream, seg_max),
                ("sparse", encode_register_ops(fresh), LONG_SPARSE_SEGMENT)):
            wrapper = fk.frontier_dense if kind == "dense" \
                else fk.frontier_sparse
            S = max(1, st.n_slots)
            if kernel.route(S, len(st.intern)) != kind:
                raise AssertionError(f"{kind} chain took the other route")
            f_cuts = jitlin.quiescent_cuts(st.kind, seg)
            fpath = Path(d) / kind / ck.CKPT_NAME
            reset_launches()
            t0 = time.perf_counter()
            got = jitlin.segmented_check(st, max_segment=seg, kernel=kernel)
            torch.cuda.synchronize()
            seg_ms = (time.perf_counter() - t0) * 1e3
            seg_launches = wrapper.launches
            # again, persisting the frontier at every cut
            t0 = time.perf_counter()
            got_ck = jitlin.segmented_check(
                st, max_segment=seg, kernel=kernel,
                ckpt=ck.CheckpointStore(fpath, interval_s=0.0,
                                        resume=False))
            torch.cuda.synchronize()
            seg_ckpt_ms = (time.perf_counter() - t0) * 1e3

            def start():
                if kind == "dense":
                    return (fk.init_table(
                        S, jitlin._bucket(len(st.intern), floor=16), 0,
                        "cuda"),)
                return fk.init_frontier(256, 0, "cuda")

            def scan(lo, hi, carry):
                ev = card_events(jitlin._slice_stream(st, lo, hi))
                if kind == "dense":
                    return wrapper(*ev, *carry)
                return wrapper(*ev, *carry, S)

            def quad(out):
                return tuple(int(x) for x in out[:4])

            t0 = time.perf_counter()
            one = scan(0, len(st), start())
            torch.cuda.synchronize()
            one_ms = (time.perf_counter() - t0) * 1e3
            fdoc = json.loads(fpath.read_text())
            last = fdoc["events_done"]
            at_last = scan(0, last, start())
            saved = [ck.decode_array(a) for a in fdoc["carry"]["arrays"]]
            saved = [a.astype(ck.host_array(x).dtype)
                     for a, x in zip(saved, at_last[4:])]
            resumed_carry = frontier_from_numpy(*saved, device="cuda")
            if kind == "dense":
                resumed_carry = (resumed_carry,)
            tail = scan(last, len(st), resumed_carry)
            same_at_cut = frontier_err(resumed_carry, at_last[4:]) == 0.0
            same_final = frontier_err(tail[4:], one[4:]) == 0.0
            one_q = quad(one)
            if (int(got[0]), got[1], int(got[2]), got[3]) != one_q \
                    or got_ck != got or not same_at_cut or not same_final \
                    or seg_launches != len(f_cuts) or len(f_cuts) < 2:
                raise AssertionError(f"{kind} chain {got} vs one-shot "
                                     f"{one_q}; cuts {len(f_cuts)}, "
                                     f"launches {seg_launches}")
            frontier_rows[f"frontier_{kind}"] = {
                "segmented_ms": seg_ms, "segmented_ckpt_ms": seg_ckpt_ms,
                "segmented_one_shot_ms": one_ms,
                "launches_segmented": seg_launches,
                "segmented_events": len(st),
                "segmented_max_segment": seg}
            emit({"phase": "segmented_frontier", "kind": kind,
                  "events": len(st), "states": len(st.intern), "S": S,
                  "max_segment": seg, "cuts": f_cuts, "result": list(got),
                  "one_shot": list(one_q), "launches": seg_launches,
                  "frontier_at_last_cut_equal": same_at_cut,
                  "final_frontier_equal": same_final,
                  "segmented_ms": seg_ms, "segmented_ckpt_ms": seg_ckpt_ms,
                  "one_shot_ms": one_ms, "card": name, "power": smi})

    # 12e. the matrix carry's hand-off: the chain's carry at the first cut
    # seeds the exact CPU frontier, which absorbs the rest
    fs = ck.frontier_from_matrix_carry(carries[0], cas_register_step_py, 0)
    if fs is None or fs.configs != at_cut or fs.events_absorbed != cut:
        raise AssertionError("the carry's frontier is not the twin's at "
                             "the cut")
    t0 = time.perf_counter()
    hand = fs.absorb(stream, start=cut)
    hand_s = time.perf_counter() - t0
    if (hand.valid, hand.failed_event) != (twin.valid, twin.failed_event):
        raise AssertionError(f"hand-off: {hand} vs the twin's {twin}")
    emit({"phase": "matrix_carry_handoff", "cut": cut,
          "configs_at_cut": len(at_cut), "valid": hand.valid,
          "absorb_s": hand_s, "events_absorbed": n - cut,
          "phase_s": time.perf_counter() - phase_t0,
          "card": name, "power": smi})
    return {"chunk_product": {"launches_segmented":
                              launches["chunk_product"]},
            "combine_product": {"launches_segmented":
                                launches["combine_product"]},
            **frontier_rows,
            "prefix_alive": {"long_localize_device_ms": {
                c: v["prefix_device_ms"] for c, v in invalid.items()},
                "long_localize_host_ms": {
                c: v["loc_split"].get("prefix", 0.0) * 1e3
                for c, v in invalid.items()},
                "long_T": invalid["second_segment"]["T"]},
            "window_rescan": {"long_localize_device_ms": {
                c: v["rescan_device_ms"] for c, v in invalid.items()},
                "long_localize_host_ms": {
                c: v["loc_split"].get("rescan", 0.0) * 1e3
                for c, v in invalid.items()},
                "long_T": invalid["second_segment"]["T"]}}


# ---------------------------------------------------------------------------
# 13. stored-run re-checks: the history.npz sidecar and check_stored
# ---------------------------------------------------------------------------

#: what later phases reuse of earlier ones: phase 12's long history and
#: its live check (``long``: history, result, host seconds of each timed
#: check), which phase 13 re-checks from the store; for phase 14, the
#: anomalous 50k-txn history's dependency edges (``elle_pairs_edges``,
#: phase 8), config 3's valid history, its map and the corrupted copy's
#: streams (``config3``) and the 1,024 keys' streams and results
#: (``config3_1024``, phase 9), and the long history's encoded stream
#: (``long_stream``, phase 12). Phase 17, which runs right after phase 13,
#: takes the long history and reads its stream and config 3's valid
#: history before phase 14 takes them. Phase 13 makes its other
#: histories itself: with phase 8's 50k-txn Elle histories kept until
#: then, phases 9 and 10 ran 7-8 s slower in two runs on an H100 host
LIVE_RUNS: dict = {}

# the launches each stored re-check must show (at least): the register
# lane's matrix kernels, Elle's φ screen (the valid 50k-txn history
# settles without a launch); the invalid headline's stored lane settles
# on the frontier rung, and its jsonl fallback localizes with explain on
STORED_WANT = {
    "headline": {"chunk_product": 1, "combine_product": 1},
    "headline_corrupted": {"chunk_product": 2, "combine_product": 2,
                           "frontier_dense": 1, "prefix_alive": 1,
                           "window_rescan": 1},
    "elle_50k": {},
    "elle_50k_pairs": {"cluster_screen": 2},
    "long": {"chunk_product": 2, "combine_product": 2},
}


def stored_recheck_case(case, kind, history, valid, reps, store_dir, name,
                        smi, live=None) -> dict:
    """One history of phase 13: written with the port's ``write_history``
    and ``write_columnar``, then ``check_stored(accelerator="gpu")``
    against the live check (``live``: its (result, seconds) when an
    earlier phase ran it). A valid copy must settle in the stored lane,
    an invalid one in the jsonl fallback, with the live check's verdict
    and failed op (registers) or result map without ``builder`` (Elle).
    Returns the launches of the first stored re-check."""
    import torch
    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.checker.linearizable import (check_stored,
                                                       linearizable)
    from jepsen_tpu_torch.elle import list_append
    test = {"name": case, "start_time": "t0", "store_dir": store_dir,
            "history": history}
    t0 = time.perf_counter()
    store.write_history(test)
    t1 = time.perf_counter()
    store.write_columnar(test)
    write_s = {"history": t1 - t0, "columnar": time.perf_counter() - t1}
    if kind == "register":
        chk = linearizable(accelerator="gpu")
        live_fn = lambda: chk.check({}, history, {})  # noqa: E731
        stored_fn = lambda: check_stored(  # noqa: E731
            case, "t0", store_dir, accelerator="gpu")
        load_fn = lambda: store.load_linear_columns(  # noqa: E731
            case, "t0", store_dir)
    else:
        live_fn = lambda: list_append.check(  # noqa: E731
            history, accelerator="gpu")
        stored_fn = lambda: list_append.check_stored(  # noqa: E731
            case, "t0", store_dir, accelerator="gpu")
        load_fn = lambda: store.load_elle_columns(  # noqa: E731
            case, "t0", store_dir)
    if live is None:
        live_s, live_res = timed(live_fn, reps)
    else:
        live_res, live_s = live
    reset_launches()
    t0 = time.perf_counter()
    got = stored_fn()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    lc = read_launches()
    # the first re-check is warm (the live checks ran the same kernels):
    # it is the first of the timed ones
    more_s, _ = timed(stored_fn, reps - 1)
    stored_s = [first_s] + more_s
    load_s, cols = timed(load_fn, reps)
    if cols is None:
        raise AssertionError(f"stored {case}: the sidecar has no columns")
    if kind == "register":
        lane = "stored" if got["algorithm"].endswith("(stored)") \
            else "jsonl"
        same = (got["valid?"], got.get("failed-op")) == (
            live_res["valid?"], live_res.get("failed-op"))
    else:
        lane = {"columnar-store": "stored", "columnar": "jsonl"}.get(
            got.get("builder"))
        same = without_builder(got) == without_builder(live_res)
    short = {k: n for k, n in STORED_WANT[case].items() if lc[k] < n}
    if not same or got["valid?"] is not valid \
            or lane != ("stored" if valid else "jsonl") or short:
        raise AssertionError(f"stored {case}: {lane} lane, equal to the "
                             f"live check: {same}, valid {got['valid?']}, "
                             f"launches {lc}")
    kerns = device_kernels(stored_fn, warm=False)
    by_kernel = {}
    for kname, us in kerns:
        by_kernel[kname] = by_kernel.get(kname, 0.0) + us
    emit({"phase": "stored_recheck", "case": case, "kind": kind,
          "ops": len(history), "valid": got["valid?"], "lane": lane,
          "algorithm": got.get("algorithm"), "builder": got.get("builder"),
          "failed_op": got.get("failed-op"),
          "anomaly_types": got.get("anomaly-types"),
          "equals_live_check": True,
          "write_history_s": write_s["history"],
          "write_columnar_s": write_s["columnar"],
          "sidecar_bytes": (store.path(test, "history.npz")
                            .stat().st_size),
          "live_check_s": live_s,
          "median_live_check_s": statistics.median(live_s),
          "stored_check_s": stored_s,
          "median_stored_check_s": statistics.median(stored_s),
          "sidecar_load_s": load_s,
          "median_sidecar_load_s": statistics.median(load_s),
          "launches": lc, "device_kernels": sorted(
              by_kernel.items(), key=lambda kv: -kv[1])[:8],
          "device_busy_ms": sum(by_kernel.values()) / 1e3,
          "card": name, "power": smi})
    return lc


def stored_phases(name, smi) -> dict:
    """Phase 13: each history written to a temporary store and re-checked
    with ``check_stored(accelerator="gpu")`` against its live check: the
    headline and its two corrupted reads, bench.py's 50k-txn list-append
    history and its 50 crossed pairs, phase 12's long history (with its
    live checks from phase 12 when it ran); then the live 50k-txn check
    through the C front and through the numpy front. Returns the stored
    re-checks' launches by kernel."""
    import tempfile

    import torch
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.elle import columnar, list_append
    from jepsen_tpu_torch.histories import (corrupt_reads, elle_history,
                                            register_history)
    from jepsen_tpu_torch.native import columnar_c

    phase_t0 = time.perf_counter()
    headline = register_history(N_OPS, n_procs=N_PROCS, seed=SEED,
                                n_values=N_VALUES)

    if "long" not in LIVE_RUNS:
        h = register_history(LONG_OPS, n_procs=N_PROCS, seed=SEED,
                             n_values=N_VALUES)
        chk = linearizable(accelerator="gpu")
        check_s, res = timed(lambda: chk.check({}, h, {}), 3)
        LIVE_RUNS["long"] = (h, res, check_s)
    long_h, long_res, long_s = LIVE_RUNS["long"]
    h_valid = elle_history(ELLE_TXNS)
    cases = [
        ("headline", "register", headline, True, 5, None),
        ("headline_corrupted", "register",
         corrupt_reads(headline, n=2, seed=0), False, 5, None),
        ("elle_50k", "elle", h_valid, True, 5, None),
        ("elle_50k_pairs", "elle",
         elle_history(ELLE_TXNS, crossed_pairs=ELLE_PAIRS), False, 5,
         None),
        ("long", "register", long_h, True, 3, (long_res, long_s)),
    ]
    launches: dict = {}
    with tempfile.TemporaryDirectory() as d:
        for case, kind, h, valid, reps, live in cases:
            lc = stored_recheck_case(case, kind, h, valid, reps, d, name,
                                     smi, live)
            for k, v in lc.items():
                launches[k] = launches.get(k, 0) + v
    # the live 50k-txn check through both fronts of the graph build, in
    # turns: the C parser, then the numpy front (columnar._build_py)
    h = h_valid
    if columnar_c.mod().parse(h) is None:
        raise AssertionError("the C parser declines the 50k-txn history")
    c_build = columnar._build
    builds = {"c": [], "numpy": []}
    maps = {}
    for _ in range(3):
        for front, fn in (("c", c_build), ("numpy", columnar._build_py)):
            columnar._build = fn
            t0 = time.perf_counter()
            maps[front] = list_append.check(h, accelerator="gpu")
            torch.cuda.synchronize()
            builds[front].append((columnar.LAST_PHASE_SECONDS["build"],
                                  time.perf_counter() - t0))
    columnar._build = c_build
    if maps["c"] != maps["numpy"] or maps["c"]["valid?"] is not True:
        raise AssertionError("the C front's result map differs from the "
                             "numpy front's")
    emit({"phase": "stored_recheck_fronts", "txns": ELLE_TXNS,
          "maps_equal": True,
          "build_s": {k: [b for b, _ in v] for k, v in builds.items()},
          "check_s": {k: [c for _, c in v] for k, v in builds.items()},
          "median_build_s": {k: statistics.median(b for b, _ in v)
                             for k, v in builds.items()},
          "median_check_s": {k: statistics.median(c for _, c in v)
                             for k, v in builds.items()},
          "phase_s": time.perf_counter() - phase_t0,
          "card": name, "power": smi})
    return launches


# ---------------------------------------------------------------------------
# 14. checking across devices: the mesh on one card, and two processes
# ---------------------------------------------------------------------------

# four shards on the one card: the sharded math, bit-equal to one
# device's; their times are no speed-up (the shards run one after another)
MESH_WIDTH = 4
WORLD = 2


def mesh_case(case, single_fn, mesh_fn, same, expect, reps, name, smi,
              **extra) -> dict:
    """One mesh case: the mesh call's launches (its first call, counts
    set to 0 just before), which must equal ``expect`` on its kernels, its
    result against the single-device call's (``same(mesh_out,
    single_out)`` raises on a difference), and both timed in turns,
    ``reps`` each. Returns the launches."""
    import torch
    reset_launches()
    got = mesh_fn()
    torch.cuda.synchronize()
    launches = read_launches()
    if any(launches[k] != v for k, v in expect.items()):
        raise AssertionError(f"mesh {case}: launches {launches}, want "
                             f"{expect}")
    want = single_fn()
    same(got, want)
    t_single, t_mesh = [], []
    for _ in range(reps):
        for times, fn in ((t_single, single_fn), (t_mesh, mesh_fn)):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    emit({"phase": "mesh", "case": case, "mesh": f"cuda:0 x {MESH_WIDTH}",
          "equal": True, "launches": {k: v for k, v in launches.items()
                                      if v},
          "single_s": t_single, "mesh_s": t_mesh,
          "median_single_s": statistics.median(t_single),
          "median_mesh_s": statistics.median(t_mesh),
          "note": "shards on one card run in turn: no speed-up",
          **extra, "card": name, "power": smi})
    return launches


def plain_sharded_trim(n, src, dst, nd, max_iters=512):
    """The sharded trim's rounds with the plain degree pass and update
    (``index_add_``), on the card: its mask, and the rounds it ran."""
    import torch
    from jepsen_tpu_torch.ops import scc_kernels as sk
    shards = place_edges(nd, src, dst)
    active = torch.ones(n, dtype=torch.bool, device="cuda")
    bits = sk.pack_mask(active)
    deg = torch.zeros((2, n), dtype=torch.int32, device="cuda")
    flags = torch.zeros(2, dtype=torch.int32, device="cuda")
    rounds, changed = 0, True
    while changed and rounds < max_iters:
        for s, d, w in zip(*shards):
            sk.trim_partial_degrees_torch(s, d, w, active, bits, deg)
        changed = bool(sk.trim_update_torch(deg, None, active, bits, flags,
                                            rounds % 2).item())
        rounds += 1
    return active.cpu().numpy(), rounds


def place_edges(nd, src, dst):
    """The edges padded with weight-0 edges to a multiple of ``nd`` and
    split into ``nd`` contiguous shards on the card, as
    ``ops.scc.trim_to_cycles_sharded`` places them: [[src shards], [dst
    shards], [weight shards]]."""
    import numpy as np
    import torch
    E = len(src)
    z = np.zeros((-E) % nd, np.int32)
    cols = [torch.from_numpy(np.concatenate([np.asarray(c, np.int32), z]))
            .cuda() for c in (src, dst, np.ones(E, np.int32))]
    return [[x.contiguous() for x in c.chunk(nd)] for c in cols]


def trim_degrees_path() -> str:
    """The round kernels' design in this build: the grid
    ``csrc/trim_degrees.cu`` sets."""
    from jepsen_tpu_torch.ops import _build
    text = (_build.SRC_DIR / "trim_degrees.cu").read_text()
    per_sm = int(re.search(r"constexpr int kBlocksPerSm = (\d+);",
                           text).group(1))
    return (f"{per_sm} CTAs an SM, grid-stride; the mask read as packed "
            f"bits; an atomic an edge end; the flag stored once a CTA")


def trim_degrees_rows(n, src, dst, launches, stand_in, name, smi) -> list:
    """Both entries of ``trim_degrees.cu`` against their plain versions on
    the card, on one of four edge shards of the graph ``(n, src, dst)``
    with a seeded mask, bit-equal (the partial rows; the mask, its packed
    copy, the zeroed rows and the flags), then timed: the kernels line's
    rows. ``launches``: each entry's launches in phase 15's trims (the
    entry point that runs the rounds on this machine, both ranks);
    ``stand_in``: those of phase 14d's rounds on one card, standing in for
    a mesh of distinct cards. The partial accumulates into one row pair
    across the timed calls, as the shards of a round do; each timed update
    first restores its inputs (rows, mask, flags), whose copies' time is
    subtracted; ``launcher_ms`` times the calls as ``ops.scc.trim_rounds``
    makes them (checked once, then launched). The profiler's list of five
    calls of each entry must hold five launches of its kernel and nothing
    else (no memset); an empty trace fails the phase. The bound counts the
    bytes this shard's data needs: the degree pass reads every weight, the
    live edges' ends and the mask words they hit, and reads and writes
    each row entry it adds to once (it accumulates); the update reads the
    packed mask and the active nodes' rows, zeroes the nonzero entries,
    and writes the removed nodes' mask bytes, the changed mask words and
    the two flag slots."""
    import numpy as np
    import torch
    from jepsen_tpu_torch.ops import scc_kernels as sk
    rng = np.random.default_rng(SEED)
    E = len(src) // MESH_WIDTH
    s = torch.from_numpy(np.asarray(src[:E], np.int32)).cuda()
    d = torch.from_numpy(np.asarray(dst[:E], np.int32)).cuda()
    w = torch.from_numpy((rng.random(E) < 0.95).astype(np.int32)).cuda()
    act = torch.from_numpy(rng.random(n) < 0.7).cuda()
    bits = sk.pack_mask(act)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device="cuda")
    deg, ref = zeros(2, n), zeros(2, n)
    sk.trim_partial_degrees(s, d, w, act, bits, deg)
    sk.trim_partial_degrees_torch(s, d, w, act, bits, ref)
    err_d = (deg - ref).abs().max().item()
    snap = deg.clone()
    outs = []
    for update in (sk.trim_update, sk.trim_update_torch):
        st = (snap.clone(), act.clone(), bits.clone(), zeros(2))
        flag = update(st[0], None, st[1], st[2], st[3], 0)
        outs.append((*st, flag.clone()))
    err_u = max(int((a != b).sum()) for a, b in zip(*outs))
    if err_d or err_u:
        raise AssertionError(f"trim_degrees differs from plain: degrees "
                             f"{err_d}, update {err_u}")
    n_active = int(act.sum())
    removed = n_active - int(outs[0][1].sum())
    ms_d = cuda_ms(lambda: sk.trim_partial_degrees(s, d, w, act, bits, deg),
                   50)
    plain_d = cuda_ms(lambda: sk.trim_partial_degrees_torch(
        s, d, w, act, bits, ref), 20)
    ew = w * (act[s.long()] & act[d.long()]).to(torch.int32)
    idx = torch.cat([d.long(), s.long() + n])
    ewx = torch.cat([ew, ew])
    flat = torch.zeros(2 * n, dtype=torch.int32, device="cuda")
    lib_d = cuda_ms(lambda: flat.index_add_(0, idx, ewx), 50)
    dw, aw, bw, fw = snap.clone(), act.clone(), bits.clone(), zeros(2)

    def restore():
        dw.copy_(snap)
        aw.copy_(act)
        fw.zero_()

    def update_call(update):
        def call():
            restore()
            return update(dw, None, aw, bw, fw, 0)
        return call
    restore_ms = cuda_ms(restore, 200)
    ms_u = cuda_ms(update_call(sk.trim_update), 200) - restore_ms
    plain_u = cuda_ms(update_call(sk.trim_update_torch), 50) - restore_ms
    # the calls as the round loop makes them: checked once, then launched
    launch_d = sk.partial_degrees_launcher(s, d, w, act, bits, deg)
    launch_u = sk.update_launcher(dw, None, aw, bw, fw)
    launcher_d = cuda_ms(launch_d, 50)
    launcher_u = cuda_ms(lambda: (restore(), launch_u(0)), 200) - restore_ms
    own = {"trim_partial_degrees": "partial_degrees",
           "trim_update": "update_mask"}
    # each entry's launches alone: its one kernel a call, no memset
    alone = {"trim_partial_degrees": device_kernels(
                 lambda: sk.trim_partial_degrees(s, d, w, act, bits, deg),
                 own["trim_partial_degrees"], calls=5),
             "trim_update": device_kernels(
                 lambda: sk.trim_update(dw, None, aw, bw, fw, 1),
                 own["trim_update"], calls=5)}
    for kname, kernels in alone.items():
        if len(kernels) != 5 or any(own[kname] not in k
                                    for k, _ in kernels):
            raise AssertionError(f"{kname}: five calls' launches {kernels}")
    prof = {"trim_partial_degrees": alone["trim_partial_degrees"],
            "trim_update": [k for k in device_kernels(
                update_call(sk.trim_update), own["trim_update"], calls=5)
                if own["trim_update"] in k[0]]}
    live = w != 0
    both = live & act[s.long()] & act[d.long()]
    words = torch.unique(torch.cat([s[live], d[live]]) >> 5).numel()
    touched = torch.unique(d[both]).numel() + torch.unique(s[both]).numel()
    bytes_d = 4 * E + 8 * int(live.sum()) + 4 * words + 8 * touched
    changed_words = int((outs[0][2] != bits).sum())
    bytes_u = (4 * ((n + 31) // 32) + 8 * n_active + 4 * int((snap != 0)
               .sum()) + removed + 4 * changed_words + 8)
    path = trim_degrees_path()
    rows = []
    for kname, rep, err, ms, pms, lib, nbytes, extra in (
            ("trim_partial_degrees", "jepsen_tpu/ops/scc.py:164", err_d,
             ms_d, plain_d, lib_d, bytes_d,
             {"library_call": "one index_add_ of the masked weights into "
              "[2n] (the mask's gather outside it)",
              "launcher_ms": launcher_d, "edges_live": int(live.sum()),
              "mask_words_read": words, "row_entries_touched": touched}),
            ("trim_update", "jepsen_tpu/ops/scc.py:176", err_u,
             ms_u, plain_u, None, bytes_u,
             {"ms_note": "each call's restore of its inputs subtracted",
              "restore_ms": restore_ms, "nodes_active": n_active,
              "nodes_removed": removed, "mask_words_changed": changed_words,
              "launcher_ms": launcher_u})):
        dev_us = [us for k, us in prof[kname] if own[kname] in k]
        dev_ms = statistics.median(dev_us) / 1e3 if dev_us else None
        rows.append({"name": kname, "route": "cuda",
                     "source": "jepsen_tpu_torch/ops/csrc/trim_degrees.cu",
                     "replaces": rep, "launches": launches[kname],
                     "launches_from": "phase 15: trim_to_cycles_distributed, "
                                      "both ranks",
                     "max_abs_err": float(err), "equal": True, "ms": ms,
                     "plain_ms": pms, "bound_ms": nbytes / PEAK_BYTES * 1e3,
                     "bound_by": "bytes", "library_ms": lib,
                     "launches_rounds_stand_in": stand_in[kname],
                     "nodes": n, "edges_per_shard": E, "bytes": nbytes,
                     "path": path, "device_kernels_us": prof[kname],
                     "device_ms": dev_ms,
                     "launches_alone": [k for k, _ in alone[kname]],
                     **extra})
    emit({"phase": "trim_degrees_kernel", "nodes": n, "edges": E,
          "path": path,
          "rows": [{k: r[k] for k in ("name", "ms", "launcher_ms",
                                      "device_ms", "plain_ms", "library_ms",
                                      "bound_ms")}
                   for r in rows], "card": name, "power": smi})
    return rows


def mesh_phases(name, smi, history, bad, stream, bad_stream) -> tuple:
    """Phase 14 on one card with ``M4 = Mesh([cuda:0] * 4)``: the matrix
    check one-shot, resumed and chained on the headline, its corrupted
    copy and phase 12's long history; config 3's corrupted batch, the
    1,024-key batch and 63 of its keys (padded) through ``batch_check``;
    the checker's sharded rung (``checker_sharded: True``, ``auto_mesh``
    given the card four times) on the headline, its corrupted copy and
    config 3 through ``independent``; the sharded trim on phase 8's
    50k-txn edges and the seeded 2^19-node graph against its plain
    rounds, through the one-card route and through ``trim_rounds`` (on
    the mesh and on ``Mesh([cuda:0, cuda] * 2)``, the path of distinct
    cards); the routing (``auto_mesh``, the round trip, "auto" lanes, the
    pipelined batch's stats); then phase 15, two processes, and
    ``trim_degrees.cu`` against its plain version, its launches from
    phase 15's trims. Returns (the trim rows of the kernels line,
    launches of the mesh cases by kernel)."""
    import numpy as np
    import torch
    from jepsen_tpu_torch import independent, parallel
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.histories import random_trim_graph
    from jepsen_tpu_torch.ops import jitlin, scc
    from jepsen_tpu_torch.parallel import Mesh, batch_check, pipeline

    phase_t0 = time.perf_counter()
    m4 = Mesh([torch.device("cuda", 0)] * MESH_WIDTH)
    totals: dict = {}

    def add(lc):
        for k, v in lc.items():
            totals[k] = totals.get(k, 0) + v

    def same_tuple(got, want):
        if got != want:
            raise AssertionError(f"mesh {got} vs one device {want}")

    def same_resume(got, want):
        (a, i, t), (a0, i0, t0) = got, want
        if not (torch.equal(a, a0) and torch.equal(i, i0)
                and torch.equal(t, t0)):
            raise AssertionError("the mesh's carry differs from one "
                                 "device's")

    # 14a. one history's chunks over the mesh: a chunk product and a
    # combine launch a shard and a dispatch
    long_stream = LIVE_RUNS.pop("long_stream")
    per_shard = {"chunk_product": MESH_WIDTH, "combine_product": MESH_WIDTH}
    for case, st in (("headline", stream), ("headline_corrupted",
                                            bad_stream)):
        add(mesh_case(f"matrix_check_{case}",
                      lambda st=st: jitlin.matrix_check(st),
                      lambda st=st: jitlin.matrix_check(st, mesh=m4),
                      same_tuple, per_shard, 5, name, smi, events=len(st)))
    kw = dict(num_states=len(stream.intern), n_slots=stream.n_slots)
    add(mesh_case("matrix_check_resume_headline",
                  lambda: jitlin.matrix_check_resume(stream, **kw),
                  lambda: jitlin.matrix_check_resume(stream, mesh=m4, **kw),
                  same_resume, per_shard, 5, name, smi))
    add(mesh_case("matrix_check_long",
                  lambda: jitlin.matrix_check(long_stream),
                  lambda: jitlin.matrix_check(long_stream, mesh=m4),
                  same_tuple, per_shard, 1, name, smi,
                  events=len(long_stream)))

    def chain(mesh):
        carries = []
        out = jitlin.matrix_check_segmented(long_stream, mesh=mesh,
                                            carry_sink=carries.append)
        return out, [(c["events_done"], c["tot0"]) for c in carries]

    def same_chain(got, want):
        if got[0] != want[0] or len(got[1]) != len(want[1]) or any(
                e != e0 or not torch.equal(t, t0)
                for (e, t), (e0, t0) in zip(got[1], want[1])):
            raise AssertionError("the mesh's chain or carries differ")

    add(mesh_case("matrix_check_segmented_long", lambda: chain(None),
                  lambda: chain(m4), same_chain,
                  {k: 2 * v for k, v in per_shard.items()}, 1, name, smi,
                  events=len(long_stream)))

    # 14b. key batches over the mesh
    h3, map3, streams_b = LIVE_RUNS.pop("config3")
    streams_k, gpu_k = LIVE_RUNS.pop("config3_1024")
    # config 3's corrupted keys: the screen, then one batched dense launch
    # a shard for the 8 keys it leaves undecided
    for case, sts, scan in (("config3_corrupted", streams_b, MESH_WIDTH),
                            ("keys_1024", streams_k, 0),
                            ("keys_63", streams_k[:63], 0)):
        add(mesh_case(f"batch_check_{case}", lambda sts=sts: batch_check(sts),
                      lambda sts=sts: batch_check(sts, mesh=m4), same_tuple,
                      {**per_shard, "frontier_dense_batch": scan,
                       "frontier_sparse_batch": 0},
                      3 if len(sts) < 100 else 1, name, smi,
                      keys=len(sts), padded_keys=(-len(sts)) % MESH_WIDTH))
        if case == "keys_1024":
            # the single-device calls' last pipeline: 8 sub-batches
            stats_1024 = pipeline.last_stats()
    if [r[0] for r in gpu_k] != [True] * len(streams_k):
        raise AssertionError("keys_1024: phase 9's verdicts changed")

    # 14c. the checker's sharded rung: auto_mesh sees the card four times
    chk = linearizable(accelerator="gpu")
    one = chk.check({}, bad, {})
    devices = parallel.devices
    parallel.devices = lambda: list(m4.devices)
    try:
        opts = {"checker_sharded": True}
        reset_launches()
        res = chk.check({}, history, opts)
        torch.cuda.synchronize()
        lc_rung = read_launches()
        add(lc_rung)
        res_bad = chk.check({}, bad, opts)
        ind = independent.checker(chk).check({}, h3, opts)
    finally:
        parallel.devices = devices
    if res["valid?"] is not True \
            or res["algorithm"] != "torch-sharded-matrix":
        raise AssertionError(f"sharded rung, headline: {res}")
    if res_bad["algorithm"] != "torch-sharded-matrix" \
            or res_bad["valid?"] is not False \
            or res_bad.get("failed-op") != one.get("failed-op"):
        raise AssertionError(f"sharded rung, corrupted: {res_bad} vs {one}")
    same_map("independent_sharded", ind, map3)
    algs = {r["algorithm"] for r in ind["results"].values()}
    if algs != {"jitlin-gpu-sharded"}:
        raise AssertionError(f"independent_sharded: {algs}")
    emit({"phase": "mesh_checker", "headline": res["algorithm"],
          "headline_launches": {k: v for k, v in lc_rung.items() if v},
          "corrupted": res_bad["algorithm"],
          "failed_op": res_bad["failed-op"],
          "unsharded_failed_op": one["failed-op"],
          "independent_backends": sorted(algs), "card": name, "power": smi})

    # 14d. the edge-sharded trim on both routes: on one card the one-call
    # peel (one scc_trim launch, no round launch); the rounds driven on
    # the card without a reduce (one partial launch a shard and one update
    # a round), on m4 and on md = Mesh([cuda:0, cuda] * 2), whose two
    # entries of one card the rounds keep apart as they keep distinct
    # cards (the cuda shards' rows staged on cuda:0, added by the update)
    from jepsen_tpu_torch.ops import scc_kernels as sk
    md = Mesh([torch.device("cuda", 0), torch.device("cuda")]
              * (MESH_WIDTH // 2))
    round_launches = None
    elle_graph = LIVE_RUNS.pop("elle_pairs_edges")
    masks = {}

    def med3(fn):
        times, out = [], None
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times), times, out

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    for case, (n, src, dst) in (
            ("elle_50k_pairs", elle_graph),
            ("random_512k_1m", random_trim_graph(19, 20, SEED))):
        t0 = time.perf_counter()
        want, rounds = plain_sharded_trim(n, src, dst, MESH_WIDTH)
        plain_s = time.perf_counter() - t0
        masks[case] = want
        reset_launches()
        got = scc.trim_to_cycles_sharded(n, src, dst, m4)
        lc_one = read_launches()
        shards = place_edges(MESH_WIDTH, src, dst)
        lcs = {}
        for route, mesh in (("rounds", m4), ("rounds_distinct", md)):
            reset_launches()
            mask = scc.trim_rounds(mesh, n, *shards).cpu().numpy()
            lcs[route] = read_launches()
            if not np.array_equal(mask, want):
                raise AssertionError(f"sharded trim {case} ({route}): the "
                                     "mask differs from the plain rounds'")
            if (lcs[route]["scc_trim"], lcs[route]["trim_partial_degrees"],
                    lcs[route]["trim_update"]) != (0, MESH_WIDTH * rounds,
                                                   rounds):
                raise AssertionError(f"sharded trim {case}, {route}: "
                                     f"{lcs[route]}, {rounds} rounds")
        lc_rounds = lcs["rounds"]
        if round_launches is None:
            round_launches = lc_rounds
        if not np.array_equal(got, want):
            raise AssertionError(f"sharded trim {case} (one_card): the "
                                 "mask differs from the plain rounds'")
        if (lc_one["scc_trim"], lc_one["trim_partial_degrees"],
                lc_one["trim_update"]) != (1, 0, 0):
            raise AssertionError(f"sharded trim {case}, one card: {lc_one}")
        add(lc_one)
        for lc in lcs.values():
            add(lc)
        whole_s, whole_runs, _ = med3(
            lambda: scc.trim_to_cycles_sharded(n, src, dst, m4))
        place_s, _, shards = med3(lambda: place_edges(MESH_WIDTH, src, dst))
        peel_s, peel_runs, got = med3(
            lambda: scc.run_sharded_trim(m4, n, *shards).cpu().numpy())
        walked = int(sk.scc_trim.work[1])
        rpeel_s, rpeel_runs, got_rounds = med3(
            lambda: scc.trim_rounds(m4, n, *shards).cpu().numpy())
        dpeel_s, dpeel_runs, got_distinct = med3(
            lambda: scc.trim_rounds(md, n, *shards).cpu().numpy())
        if not all(np.array_equal(m, want)
                   for m in (got, got_rounds, got_distinct)):
            raise AssertionError(f"sharded trim {case}: a timed mask "
                                 "differs")
        # the bound: what the function needs, as the scc_trim row counts
        # it: each edge's 12 bytes (src, dst, weight) in and the mask out
        # once; an operation an edge, a node and a row entry walked. The
        # reference's rounds do every edge and node every round
        nbytes = 12 * len(src) + n
        b_ms, b_by = bound(float(len(src) + n + walked), nbytes)
        ref_ms, ref_by = bound(float(len(src) + n) * rounds,
                               rounds * (12 * len(src) + 2 * n))
        emit({"phase": "mesh_trim", "case": case, "nodes": n,
              "edges": len(src), "rounds": rounds,
              "residue": int(want.sum()), "equal": True,
              "launches_one_card": {k: v for k, v in lc_one.items() if v},
              "launches_rounds": {k: v for k, v in lc_rounds.items() if v},
              "launches_rounds_distinct": {
                  k: v for k, v in lcs["rounds_distinct"].items() if v},
              "mesh_s": whole_s, "mesh_runs_s": whole_runs,
              "place_s": place_s, "peel_s": peel_s,
              "peel_runs_s": peel_runs, "rounds_peel_s": rpeel_s,
              "rounds_peel_runs_s": rpeel_runs,
              "rounds_us_per_round": rpeel_s * 1e6 / rounds,
              "rounds_distinct_peel_s": dpeel_s,
              "rounds_distinct_peel_runs_s": dpeel_runs,
              "rounds_distinct_us_per_round": dpeel_s * 1e6 / rounds,
              "plain_rounds_s": plain_s, "bytes": nbytes,
              "row_entries_walked": walked, "bound_ms": b_ms,
              "bound_by": b_by, "bound_ms_reference_work": ref_ms,
              "bound_by_reference_work": ref_by,
              "note": "mesh_s: trim_to_cycles_sharded on one card "
                      "(trim_to_cycles: the upload and one scc_trim call); "
                      "peel_s: run_sharded_trim on placed shards (joined, "
                      "one scc_trim call, the mask read back); "
                      "rounds_peel_s: trim_rounds on the same shards on "
                      "m4; rounds_distinct_peel_s: on Mesh([cuda:0, cuda] "
                      "x 2), the rows of the cuda entries staged; medians "
                      "of 3",
              "card": name, "power": smi})
    n_r, src_r, dst_r = random_trim_graph(19, 20, SEED)

    # 14e. routing
    t0 = time.perf_counter()
    rtt = pipeline.measured_roundtrip_s()
    rtt_s = time.perf_counter() - t0
    lanes = {}
    for case, sts in (("config3_corrupted", streams_b),
                      ("keys_3", streams_b[:3])):
        batch_check(sts, accelerator="auto")
        lanes[case] = {"route": parallel.last_route(),
                       "events": sum(len(x) for x in sts)}
    stats = stats_1024
    emit({"phase": "mesh_routing", "auto_mesh": repr(parallel.auto_mesh()),
          "measured_roundtrip_s": rtt, "first_measure_s": rtt_s,
          "cpu_events_per_sec": pipeline.cpu_events_per_sec(),
          "device_events_per_sec": {k: pipeline.device_events_per_sec(k)
                                    for k in (1, MESH_WIDTH)},
          "auto_lanes": lanes, "pipelined_1024": stats,
          "card": name, "power": smi})
    if stats.get("batches") != sub_batches(len(streams_k)):
        raise AssertionError(f"the 1,024-key pipeline: {stats}")

    # 15. two processes on the card, gloo; their trims' launches are the
    # round kernels' launches on the kernels line
    rank_launches = distributed_phase(streams_b, batch_check(streams_b),
                                      elle_graph, masks["elle_50k_pairs"],
                                      name, smi)
    trim_rows = trim_degrees_rows(
        n_r, src_r, dst_r, {k: sum(lc.get(k, 0) for lc in rank_launches)
                            for k in ("trim_partial_degrees",
                                      "trim_update")},
        round_launches, name, smi)
    emit({"phase": "mesh_total", "seconds": time.perf_counter() - phase_t0,
          "card": name, "power": smi})
    return trim_rows, totals


def distributed_phase(streams, want_batch, graph, want_mask, name, smi):
    """Phase 15: ``batch_check_distributed`` on ``streams`` and
    ``trim_to_cycles_distributed`` on ``graph`` (its edges split in two
    halves) in a world of two processes on the one card (gloo, a
    ``file://`` init method), each child this script with
    ``--distributed-worker``; both must return the single-process results,
    and a child that fails fails the phase. Returns each rank's launches
    in its trim (the counts reset just before it, read just after)."""
    import os
    import pickle
    import subprocess
    import tempfile

    n, src, dst = graph
    half = (len(src) + 1) // 2
    with tempfile.TemporaryDirectory() as d:
        job = os.path.join(d, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump({"init": f"file://{d}/rendezvous", "world": WORLD,
                         "streams": streams, "n_nodes": n,
                         "edges": [(src[:half], dst[:half]),
                                   (src[half:], dst[half:])]}, f)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--distributed-worker", job, str(r)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall_s = time.perf_counter() - t0
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"distributed rank {r} failed:\n"
                                     f"{out[-3000:]}")
        res = []
        for r in range(WORLD):
            with open(f"{job}.{r}.out", "rb") as f:
                res.append(pickle.load(f))
    for r, out in enumerate(res):
        if out["batch"] != want_batch or not (out["mask"] == want_mask).all():
            raise AssertionError(f"distributed rank {r}: the results differ "
                                 "from the single process's")
    emit({"phase": "distributed", "world": WORLD, "backend":
          res[0]["backend"], "devices": [o["device"] for o in res],
          "keys": len(streams), "edges": len(src), "equal": True,
          "batch_s": [o["batch_s"] for o in res],
          "trim_s": [o["trim_s"] for o in res],
          "trim_reduce_s": [o["reduce_s"] for o in res],
          "launches": [o["launches"] for o in res],
          "batch_launches": [o["batch_launches"] for o in res],
          "wall_s": wall_s, "note": "two processes on one card: no "
          "speed-up; launches: each rank's trim alone",
          "card": name, "power": smi})
    return [o["launches"] for o in res]


def distributed_worker(job_path: str, rank: int) -> int:
    """One process of phase 15's world (``--distributed-worker JOB
    RANK``): joins it, runs both checks on its card, writes its results
    beside the job."""
    import pickle

    import torch
    from jepsen_tpu_torch.parallel import distributed
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    backend = distributed.initialize(job["init"], job["world"], rank)
    try:
        reset_launches()
        t0 = time.perf_counter()
        batch = distributed.batch_check_distributed(job["streams"])
        torch.cuda.synchronize()
        batch_launches = {k: v for k, v in read_launches().items() if v}
        src, dst = job["edges"][rank]
        reset_launches()
        t1 = time.perf_counter()
        mask = distributed.trim_to_cycles_distributed(job["n_nodes"], src,
                                                      dst)
        t2 = time.perf_counter()
        launches = {k: v for k, v in read_launches().items() if v}
        # the trim's all-reduces alone: one a round, of the same rows
        rows = torch.zeros((2, job["n_nodes"]), dtype=torch.int32,
                           device=distributed.global_mesh().devices[0])
        t3 = time.perf_counter()
        for _ in range(launches.get("trim_update", 0)):
            distributed._all_reduce(rows)
        out = {"backend": backend, "batch": batch, "mask": mask,
               "device": str(distributed.global_mesh().devices[0]),
               "batch_s": t1 - t0, "trim_s": t2 - t1,
               "reduce_s": time.perf_counter() - t3, "launches": launches,
               "batch_launches": batch_launches}
    finally:
        distributed.dist.destroy_process_group()
    with open(f"{job_path}.{rank}.out", "wb") as f:
        pickle.dump(out, f)
    return 0


# ---------------------------------------------------------------------------
# 16. the run's shared history IR, and live checking from a WAL
# ---------------------------------------------------------------------------

LIVE_POLLS = 10        # the headline tailed in 10 polls of 1,000 ops
LIVE_IND_POLLS = 4     # config 3's corrupted copy
LIVE_ELLE_POLLS = 5    # the 50k-txn list-append histories


def wal_polls(history, n_polls: int, path):
    """Appends ``history`` to a WAL at ``path`` in ``n_polls`` equal
    parts, polling a ``WalTailer`` after each; yields each poll's ops."""
    from jepsen_tpu_torch.journal import WalTailer
    tailer = WalTailer(path)
    size = -(-len(history) // n_polls)
    with open(path, "w") as f:
        for lo in range(0, len(history), size):
            f.write("".join(json.dumps(op) + "\n"
                            for op in history[lo:lo + size]))
            f.flush()
            yield tailer.poll()
    if tailer.finalize() or tailer.torn_skipped:
        raise AssertionError(f"{path}: the tailer left ops behind")


def add_launches(total: dict, lc: dict) -> None:
    for k, v in lc.items():
        total[k] = total.get(k, 0) + v


def live_session_run(sess, history, n_polls, path, total, twin=None):
    """Drives ``sess`` through ``history`` tailed from a WAL in
    ``n_polls`` polls: each poll's verdict, its host ms (ending in a
    sync) and the launches it made (counts reset just before the
    verdict and added to ``total``). ``twin``, a CPU session, takes the
    same polls. Returns (the polls' rows, sess.finalize(), the twin's
    verdicts and finalize or None)."""
    import torch
    rows, twin_v, seen = [], [], []
    for ops in wal_polls(history, n_polls, path):
        seen += ops
        sess.add_many(ops)
        reset_launches()
        t0 = time.perf_counter()
        v = sess.verdict()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        lc = read_launches()
        add_launches(total, lc)
        rows.append({**{k: v.get(k) for k in (
            "valid_so_far", "first_anomaly_op", "backend", "checked_ops",
            "anomaly_types")}, "ops": len(ops), "verdict_ms": ms,
                     "launches": {k: n for k, n in lc.items() if n}})
        if twin is not None:
            twin.add_many(ops)
            twin_v.append(twin.verdict())
    if seen != history:
        raise AssertionError(f"{path}: the WAL's ops differ from the "
                             f"history written")
    reset_launches()
    t0 = time.perf_counter()
    final = sess.finalize()
    torch.cuda.synchronize()
    rows.append({"finalize_ms": (time.perf_counter() - t0) * 1e3})
    add_launches(total, read_launches())
    return rows, final, (twin_v, twin.finalize()) if twin else None


def live_phases(name, smi, history, bad, twin_bad) -> dict:
    """Phase 16: the run's shared history IR (``history_ir.of``) and live
    checking from a WAL (``jepsen_tpu_torch.live``) on the card. Returns
    each kernel's launches in the live sessions' polls and finalizes."""
    import tempfile
    from pathlib import Path

    import torch
    from jepsen_tpu_torch import history_ir, independent
    from jepsen_tpu_torch.checker import linear_encode
    from jepsen_tpu_torch.checker import linearizable as lin_mod
    from jepsen_tpu_torch.elle import list_append
    from jepsen_tpu_torch.histories import (corrupt_keys, elle_history,
                                            independent_register_history)
    from jepsen_tpu_torch.history_ir import DeviceHistory, views
    from jepsen_tpu_torch.history_ir.ir import CANONICAL_COLUMNS
    from jepsen_tpu_torch.live import (ElleSession, LinearLiveSession,
                                       MultiKeyLinearSession)
    from jepsen_tpu_torch.parallel import Mesh
    phase_t0 = time.perf_counter()
    chk = lin_mod.linearizable(accelerator="gpu")
    common = {"card": name, "power": smi}

    # 16a. two checks on one test map: the first builds none of the IR's
    # columns, the second pays no encode; the same checks with
    # ir_enabled: False encode each time
    real_encode = linear_encode.encode_register_ops
    encodes = []

    def counted(*a, **k):
        encodes.append(1)
        return real_encode(*a, **k)
    parts = {k: [] for k in ("first_check", "second_check", "off_check",
                             "ir_build", "stream_view", "plain_encode")}
    for _ in range(5):
        test = {}
        encodes.clear()
        linear_encode.encode_register_ops = counted
        lin_mod.encode_register_ops = counted
        try:
            t0 = time.perf_counter()
            r1 = chk.check(test, history, {})
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            r2 = chk.check(test, history, {})
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            n_shared = len(encodes)
            r3 = chk.check({"ir_enabled": False}, history, {})
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            n_off = len(encodes) - n_shared
        finally:
            linear_encode.encode_register_ops = real_encode
            lin_mod.encode_register_ops = real_encode
        if not r1 == r2 == r3 or r1["valid?"] is not True \
                or r1["algorithm"] != "torch-matrix":
            raise AssertionError(f"history_ir_shared: {r1}, {r2}, {r3}")
        if (n_shared, n_off) != (1, 1):
            raise AssertionError(f"history_ir_shared: {n_shared} encodes "
                                 f"on one test map, {n_off} without the IR")
        if test["_history_ir"].columns_built():
            raise AssertionError("history_ir_shared: a check built the "
                                 "IR's columns")
        t4 = time.perf_counter()
        dh = DeviceHistory.from_ops(history)
        t5 = time.perf_counter()
        views.register_stream(dh)
        t6 = time.perf_counter()
        real_encode(history)
        t7 = time.perf_counter()
        for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t5 - t4,
                                 t6 - t5, t7 - t6)):
            parts[k].append(dt)
    med = {k: statistics.median(v) for k, v in parts.items()}
    emit({"phase": "history_ir_shared", "ops": N_OPS,
          "encodes_on_one_map": 1, "column_builds_in_checks": 0,
          "results_equal": True, "median_s": med,
          "first_over_off": med["first_check"] / med["off_check"],
          "s": parts, **common})

    # 16b. the headline IR's canonical columns on the card and on a mesh
    # of four entries of it
    ir = history_ir.of({}, history)
    host = {k: torch.from_numpy(getattr(ir, k)) for k in CANONICAL_COLUMNS}
    n = len(ir)
    placements, placed = {}, []
    for case, mesh in (("cuda", None),
                       ("mesh4", Mesh([torch.device("cuda", 0)] * 4))):
        t0 = time.perf_counter()
        cols, n_real = (ir.device_columns() if mesh is None
                        else ir.device_columns(mesh=mesh))
        torch.cuda.synchronize()
        place_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        again = (ir.device_columns() if mesh is None
                 else ir.device_columns(mesh=mesh))[0]
        memo_ms = (time.perf_counter() - t0) * 1e3
        if again is not cols or n_real != n:
            raise AssertionError(f"device_columns {case}: no memo hit")
        for k in CANONICAL_COLUMNS:
            if mesh is None:
                got, on = cols[k].cpu(), {cols[k].device.type}
            else:
                got = torch.cat([t.cpu() for t in cols[k]])
                on = {t.device.type for t in cols[k]}
                pad = (-1 if k in ("processes", "completion_of",
                                   "invocation_of") else 0)
                if len(cols[k]) != 4 or len(got) % 4 \
                        or not bool((got[n:] == pad).all()):
                    raise AssertionError(f"device_columns {case}: {k}'s "
                                         f"shards or padding")
                got = got[:n]
            if on != {"cuda"} or not torch.equal(got, host[k]):
                raise AssertionError(f"device_columns {case}: {k} differs "
                                     f"from the host column")
        placements[case] = {"place_ms": place_ms, "memo_ms": memo_ms,
                            "bit_equal": True, "memo_hit": True}
        placed.append(cols)
    other = ir.device_columns(mesh=Mesh(["cuda:0", "cuda"] * 2))[0]
    if any(other is cols for cols in placed):
        raise AssertionError("device_columns: a mesh over other device "
                             "names shared a placement")
    emit({"phase": "device_columns", "rows": n, "columns":
          len(CANONICAL_COLUMNS), "placements": placements, **common})

    # 16c. config 3 through the IR's subhistories, key for key equal to
    # the split path
    h3 = (LIVE_RUNS["config3"][0] if "config3" in LIVE_RUNS
          else independent_register_history(IND_KEYS, IND_OPS))
    ind = independent.checker(chk)
    times = {"ir_check": [], "off_check": [], "ir_build": [],
             "subhistories": [], "split_history": []}
    for _ in range(3):
        test = {}
        t0 = time.perf_counter()
        got = ind.check(test, h3, {})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = ind.check({"ir_enabled": False}, h3, {})
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        same_map("history_ir_config3", got, want)
        if ("subhistories",) not in test["_history_ir"].view_keys() \
                or test["_history_ir"].columns_built():
            raise AssertionError("history_ir_config3: no subhistories "
                                 "view, or the check built the columns")
        dh = DeviceHistory.from_ops(h3)
        t3 = time.perf_counter()
        keys, subs = views.subhistories(dh)
        t4 = time.perf_counter()
        keys2, subs2 = independent.split_history(h3)
        t5 = time.perf_counter()
        if keys != keys2 or subs != subs2:
            raise AssertionError("history_ir_config3: the views' split "
                                 "differs from split_history")
        for k, dt in zip(times, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                 t5 - t4)):
            times[k].append(dt)
    emit({"phase": "history_ir_config3", "keys": IND_KEYS, "ops_a_key":
          IND_OPS, "valid": got["valid?"], "equal_key_for_key": True,
          "median_s": {k: statistics.median(v) for k, v in times.items()},
          **common})

    launches_live: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # 16d. the headline and its corrupted copy tailed from a WAL in
        # 10 polls through the live register session on the card; the
        # copy also through its CPU twin, poll for poll
        failed = int(twin_bad.failed_op_index)
        for copy, hh in (("valid", history), ("corrupted", bad)):
            t0 = time.perf_counter()
            total: dict = {}
            twin = (LinearLiveSession(accelerator="cpu")
                    if copy == "corrupted" else None)
            rows, final, tw = live_session_run(
                LinearLiveSession(accelerator="gpu"), hh, LIVE_POLLS,
                tmp / f"register_{copy}.wal.jsonl", total, twin)
            wall_s = time.perf_counter() - t0
            add_launches(launches_live, total)
            polls = rows[:-1]
            latched = False
            for i, r in enumerate(polls):
                if copy == "valid" or r["checked_ops"] <= failed:
                    want = (True, None)
                else:
                    want = (False, failed)
                if (r["valid_so_far"], r["first_anomaly_op"]) != want or (
                        tw and (r["valid_so_far"], r["first_anomaly_op"]) !=
                        (tw[0][i]["valid_so_far"],
                         tw[0][i]["first_anomaly_op"])):
                    raise AssertionError(f"live_register {copy} poll {i}: "
                                         f"{r} against {want}")
                lc = r["launches"]
                if r["backend"] == "torch-matrix" and not latched:
                    # one chunk product and one combine a screen; the
                    # poll that latches localizes: one more chunk
                    # product and each forensics kernel once
                    latched = r["valid_so_far"] is False
                    want_lc = {"chunk_product": 1 + latched,
                               "combine_product": 1}
                    if latched:
                        want_lc.update(prefix_alive=1, window_rescan=1)
                    if lc != want_lc:
                        raise AssertionError(f"live_register {copy} poll "
                                             f"{i} launched {lc}, not "
                                             f"{want_lc}")
                elif lc:
                    raise AssertionError(f"live_register {copy} poll {i} "
                                         f"({r['backend']}) launched {lc}")
            if not any(r["backend"] == "torch-matrix" for r in polls):
                raise AssertionError(f"live_register {copy}: no poll was "
                                     f"screened on the card")
            want_forensics = 1 if copy == "corrupted" else 0
            if (total.get("prefix_alive", 0),
                    total.get("window_rescan", 0)) != (want_forensics,) * 2:
                raise AssertionError(f"live_register {copy}: forensics "
                                     f"launches {total}")
            if final["valid?"] is not (copy == "valid") or (
                    copy == "corrupted"
                    and (final.get("failed-op-index") != failed
                         or final != tw[1])):
                raise AssertionError(f"live_register {copy}: {final}")
            emit({"phase": "live_register", "copy": copy, "ops": N_OPS,
                  "polls": polls, "finalize_ms": rows[-1]["finalize_ms"],
                  "final": final, "twin_failed_op": failed
                  if copy == "corrupted" else None, "launches": total,
                  "median_screen_ms": statistics.median(
                      [r["verdict_ms"] for r in polls
                       if r["backend"] == "torch-matrix"]),
                  "wall_s": wall_s, **common})

        # 16e. config 3's corrupted copy through the multi-key session
        h3bad = corrupt_keys(h3, IND_BAD)
        t0 = time.perf_counter()
        total = {}
        rows, final, _ = live_session_run(
            MultiKeyLinearSession(accelerator="gpu"), h3bad, LIVE_IND_POLLS,
            tmp / "independent.wal.jsonl", total)
        wall_s = time.perf_counter() - t0
        add_launches(launches_live, total)
        batch = ind.check({}, h3bad, {})
        want_fail = sorted(str(k) for k in IND_BAD)
        if final["failures"] != batch["failures"] \
                or sorted(final["failures"]) != want_fail:
            raise AssertionError(f"live_independent: {final['failures']} "
                                 f"against {batch['failures']}")
        firsts = {}
        for k in want_fail:
            want_op = batch["results"][k].get("explain", {}).get(
                "first-anomaly-op")
            got_op = final["results"][k].get("failed-op-index")
            if want_op is not None and got_op != want_op:
                raise AssertionError(f"live_independent key {k}: failed op "
                                     f"{got_op} against {want_op}")
            firsts[k] = got_op
        emit({"phase": "live_independent", "keys": IND_KEYS, "ops_a_key":
              IND_OPS, "polls": rows[:-1], "finalize_ms":
              rows[-1]["finalize_ms"], "failures": final["failures"],
              "failed_ops": firsts, "launches": total, "wall_s": wall_s,
              **common})

        # 16f. bench.py's 50k-txn list-append history, valid and with 50
        # crossed pairs, through the Elle session; finalize equals the
        # batch check without ``builder`` (and its read-scan-keys)
        def core(r):
            return {k: v for k, v in r.items()
                    if k not in ("builder", "read-scan-keys")}
        for copy, pairs in (("valid", 0), ("pairs", ELLE_PAIRS)):
            hh = elle_history(ELLE_TXNS, crossed_pairs=pairs)
            t0 = time.perf_counter()
            total = {}
            rows, final, _ = live_session_run(
                ElleSession(accelerator="gpu"), hh, LIVE_ELLE_POLLS,
                tmp / f"elle_{copy}.wal.jsonl", total)
            wall_s = time.perf_counter() - t0
            add_launches(launches_live, total)
            t0 = time.perf_counter()
            batch = list_append.check(hh, accelerator="gpu")
            torch.cuda.synchronize()
            batch_s = time.perf_counter() - t0
            if core(final) != core(batch) \
                    or final["valid?"] is not (pairs == 0):
                raise AssertionError(f"live_elle {copy}: the session's map "
                                     f"differs from list_append.check's")
            emit({"phase": "live_elle", "copy": copy, "txns": ELLE_TXNS,
                  "polls": rows[:-1], "finalize_ms":
                  rows[-1]["finalize_ms"], "valid": final["valid?"],
                  "anomaly_types": final.get("anomaly-types"),
                  "launches": total, "batch_check_s": batch_s,
                  "wall_s": wall_s, **common})
    emit({"phase": "live_total", "seconds": time.perf_counter() - phase_t0,
          "launches_live": launches_live})
    return launches_live


# ---------------------------------------------------------------------------
# 18. the live daemon over the native ingest spine
# ---------------------------------------------------------------------------

DAEMON_POLLS = 20        # each run's WAL grows a twentieth a poll
DAEMON_KEYS = 16         # config 3 at its 1,000 ops a key (IND_OPS)
INGEST_OPS = 100_000     # the rates' history: 200,000 WAL lines
INGEST_REPS = 3


def median_s(fn) -> tuple:
    """(median seconds of ``INGEST_REPS`` calls of ``fn()``, its last
    result)."""
    times, out = timed(fn, INGEST_REPS)
    return statistics.median(times), out


def ingest_rates(name, smi, history) -> dict:
    """The C spine against its Python twins on the card's host, each the
    median of ``INGEST_REPS`` calls: the WAL scan of 200,000 lines, the
    live register encode of the same ops, and the frontier closure of
    the headline's stream (the twin's loop over the same columns as
    tuples, which the C declines)."""
    from types import SimpleNamespace

    from jepsen_tpu_torch.checker.linear_cpu import FrontierSession
    from jepsen_tpu_torch.histories import register_history
    from jepsen_tpu_torch.history import Intern
    from jepsen_tpu_torch.history_ir import ingest
    from jepsen_tpu_torch.history_ir.builder import LiveRegisterEncoder
    from jepsen_tpu_torch.journal import parse_wal_chunk_py
    h = register_history(INGEST_OPS, n_procs=N_PROCS, seed=SEED,
                         n_values=N_VALUES)
    wal = "".join(json.dumps(op) + "\n" for op in h).encode()
    c_scan_s, got = median_s(lambda: ingest.parse_wal_chunk(wal))
    py_scan_s, want = median_s(lambda: parse_wal_chunk_py(wal))
    if got[1:] != want[1:] or got[0] != want[0] or got[0] != h:
        raise AssertionError("ingest_rates: the C scan differs from "
                             "parse_wal_chunk_py")
    ops = got[0]

    def encode(twin: bool):
        # an encoder with its own encode_args is outside the C's regime:
        # add_many and encode_resolved run the Python loops
        enc = LiveRegisterEncoder(Intern())
        if twin:
            enc = LiveRegisterEncoder(Intern(), encode_args=enc.encode_args)
        enc.add_many(ops)
        enc.encode_resolved()
        return enc
    c_enc_s, enc = median_s(lambda: encode(False))
    py_enc_s, twin_enc = median_s(lambda: encode(True))
    cols = ("kind", "slot", "f", "a", "b", "op_index")
    if any(getattr(enc.stream, c) != getattr(twin_enc.stream, c)
           for c in cols) or enc._next != twin_enc._next:
        raise AssertionError("ingest_rates: the C encode differs from "
                             "the Python twin's")
    head = LiveRegisterEncoder(Intern())
    head.add_many(history)
    head.finalize()
    st = head.stream
    as_tuples = SimpleNamespace(intern=st.intern, **{
        c: tuple(getattr(st, c)) for c in cols})
    c_fr_s, fr = median_s(lambda: FrontierSession().absorb(st))
    py_fr_s, twin_fr = median_s(lambda: FrontierSession().absorb(as_tuples))
    if vars(fr) != vars(twin_fr) or fr.valid is not True:
        raise AssertionError(f"ingest_rates: frontier {fr} against "
                             f"{twin_fr}")
    n, ev = len(ops), len(st)
    row = {"phase": "ingest_rates", "wal_lines": n, "wal_bytes": len(wal),
           "headline_events": ev, "reps": INGEST_REPS,
           "scan_c_s": c_scan_s, "scan_python_s": py_scan_s,
           "scan_c_ops_per_s": n / c_scan_s,
           "scan_python_ops_per_s": n / py_scan_s,
           "encode_c_s": c_enc_s, "encode_python_s": py_enc_s,
           "encode_c_ops_per_s": n / c_enc_s,
           "encode_python_ops_per_s": n / py_enc_s,
           "frontier_c_s": c_fr_s, "frontier_python_s": py_fr_s,
           "frontier_c_events_per_s": ev / c_fr_s,
           "frontier_python_events_per_s": ev / py_fr_s,
           "card": name, "power": smi}
    emit(row)
    return row


def daemon_phase(name, smi, history, bad, twin_bad) -> dict:
    """Phase 18: three runs' WALs grow by a ``DAEMON_POLLS``-th of the
    run between polls of one ``LiveDaemon(store_root,
    accelerator="auto")`` (the headline, its corrupted copy, config 3 at
    ``DAEMON_KEYS`` keys of ``IND_OPS``), then each run's
    ``history.jsonl`` lands and ``run_until_idle`` settles them. Each
    final ``live-status.json`` must hold the offline check's verdict
    (and the corrupted copy's first anomaly), no tracker may break, no
    frontier may bail out of the C, and both Pallas ports must launch
    inside the headline runs' checks in the polls. The config-3 run's
    own launches are counted apart: its keys (about 800 returns each)
    are below ``MATRIX_MIN_RETURNS``, so it checks on the C frontier.
    Returns each kernel's launches in the daemon's polls and
    finalizes."""
    import tempfile
    from pathlib import Path

    import torch
    from jepsen_tpu_torch import independent, telemetry
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.histories import independent_register_history
    from jepsen_tpu_torch.live import (
        LiveDaemon, MultiKeyLinearSession, load_live_status)
    phase_t0 = time.perf_counter()
    common = {"card": name, "power": smi}
    h3 = independent_register_history(DAEMON_KEYS, IND_OPS)
    runs = {"headline": history, "corrupted": bad, "config3": h3}
    lin = linearizable(accelerator="gpu")
    offline = {"headline": lin.check({}, history, {}),
               "corrupted": lin.check({}, bad, {}),
               "config3": independent.checker(lin).check({}, h3, {})}
    first = twin_bad.failed_op_index
    if (offline["headline"]["valid?"], offline["corrupted"]["valid?"],
            offline["config3"]["valid?"]) != (True, False, True) or \
            offline["corrupted"]["explain"]["first-anomaly-op"] != first:
        raise AssertionError(f"daemon: the offline checks {offline}")
    reg = telemetry.Registry()
    with tempfile.TemporaryDirectory() as d, telemetry.use(reg):
        root = Path(d)
        dirs = {}
        for run in runs:
            dirs[run] = root / run / "20261018T000000.000"
            dirs[run].mkdir(parents=True)
            (dirs[run] / "history.wal.jsonl").touch()
        daemon = LiveDaemon(str(root), accelerator="auto", registry=reg)
        chunk = {run: -(-len(h) // DAEMON_POLLS) for run, h in runs.items()}
        # the config-3 run is the one multi-key session: count its own
        # checks' launches apart from the headline runs'
        own3 = dict.fromkeys(read_launches(), 0)
        verdict3 = MultiKeyLinearSession.verdict

        def counted(sess):
            before = read_launches()
            try:
                return verdict3(sess)
            finally:
                for k, n in read_launches().items():
                    own3[k] += n - before[k]
        MultiKeyLinearSession.verdict = counted
        reset_launches()
        poll_ms, broken = [], set()
        try:
            for p in range(DAEMON_POLLS):
                for run, h in runs.items():
                    with open(dirs[run] / "history.wal.jsonl", "a") as f:
                        f.write("".join(
                            json.dumps(op) + "\n" for op in
                            h[p * chunk[run]:(p + 1) * chunk[run]]))
                t0 = time.perf_counter()
                daemon.poll_once()
                torch.cuda.synchronize()
                poll_ms.append((time.perf_counter() - t0) * 1e3)
                broken |= {t.label for t in daemon.trackers.values()
                           if t.broken}
        finally:
            MultiKeyLinearSession.verdict = verdict3
        polled = read_launches()
        for run, h in runs.items():
            (dirs[run] / "history.jsonl").write_text(
                "".join(json.dumps(op) + "\n" for op in h))
        t0 = time.perf_counter()
        daemon.run_until_idle(timeout_s=600)
        torch.cuda.synchronize()
        idle_s = time.perf_counter() - t0
        launches = read_launches()
        finals = {run: load_live_status(dirs[run]) for run in runs}
        prom = (root / "live-metrics.prom").read_text()
    fallbacks = {r["labels"]["reason"]: r["value"] for r in reg.snapshot()
                 if r["name"] == "native_ingest_fallback_total"}
    row = {"phase": "daemon", "runs": {run: len(h)
                                       for run, h in runs.items()},
           "chunk": chunk, "polls": len(poll_ms),
           "median_poll_ms": statistics.median(poll_ms),
           "max_poll_ms": max(poll_ms), "poll_ms": poll_ms,
           "run_until_idle_s": idle_s,
           "final": {run: {k: st.get(k) for k in (
               "state", "valid_so_far", "first_anomaly_op", "backend",
               "ops_absorbed", "checked_ops", "polls", "error")}
               for run, st in finals.items()},
           "offline_first_anomaly_op": first,
           "fallbacks": fallbacks, "launches_in_polls": {
               k: n for k, n in polled.items() if n},
           "config3_launches_in_polls": {k: n for k, n in own3.items()
                                         if n},
           "launches": {k: n for k, n in launches.items() if n},
           "seconds": time.perf_counter() - phase_t0, **common}
    emit(row)
    want = {"headline": (True, None), "corrupted": (False, first),
            "config3": (True, None)}
    for run, st in finals.items():
        res = st.get("results") or {}
        if st["state"] != "final" or "error" in st or broken \
                or (st["valid_so_far"], st["first_anomaly_op"]) != want[run] \
                or res.get("valid?") is not offline[run]["valid?"] \
                or st["ops_absorbed"] != len(runs[run]):
            raise AssertionError(f"daemon {run}: {st} (broken: {broken})")
    if finals["corrupted"]["results"].get("failed-op-index") != first:
        raise AssertionError(f"daemon: {finals['corrupted']['results']}")
    if fallbacks.get("frontier-bail"):
        raise AssertionError(f"daemon: a frontier bailed out of the C: "
                             f"{fallbacks}")
    if not (polled["chunk_product"] - own3["chunk_product"]
            and polled["combine_product"] - own3["combine_product"]):
        raise AssertionError(f"daemon: the polls launched {polled}, the "
                             f"config-3 run's checks {own3}")
    if "live_verdict" not in prom:
        raise AssertionError("daemon: live-metrics.prom lacks live_verdict")
    ingest_rates(name, smi, history)
    return launches


# ---------------------------------------------------------------------------
# 19. a suite's composed check: the host checkers and reports around the
# register check on the card
# ---------------------------------------------------------------------------

SUITE_TS = "20261018T000000.000"
# the reports that draw a PNG, and the files they draw
SUITE_PNGS = ("latency-raw.png", "latency-quantiles.png", "rate.png",
              "clock-skew.png", "linear.png")


def suite_checker(run, accelerator, device=None):
    """A suite's composed check as ``suites.compose_test`` composes it
    (``jepsen_tpu/suites/__init__.py:53-61``) around run ``run``'s
    workload: 19a's is the register workload's lifted check
    (``workloads/register.py:58-62``), 19b's a linearizable check of the
    whole history, with the run timeline beside it."""
    from jepsen_tpu_torch import checker as c
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.models import CASRegister
    lin = linearizable(model=CASRegister(), accelerator=accelerator,
                       device=device)
    if run == "19a":
        return c.compose({
            "stats": c.stats(), "exceptions": c.unhandled_exceptions(),
            "workload": independent.checker(c.compose({
                "linear": lin, "timeline": c.timeline_html()})),
            "perf": c.perf(), "clock": c.clock_plot()})
    return c.compose({"stats": c.stats(),
                      "exceptions": c.unhandled_exceptions(),
                      "workload": lin, "perf": c.perf(),
                      "timeline": c.timeline_html()})


def suite_test_map(root, rows):
    """A run's test map whose store dir, under ``root``, holds the fault
    registry's ``rows`` (``faults.jsonl``); and the run's dir."""
    from pathlib import Path
    test = {"name": "suite", "start_time": SUITE_TS, "store_dir": str(root)}
    d = Path(root) / "suite" / SUITE_TS
    d.mkdir(parents=True)
    (d / "faults.jsonl").write_text("".join(json.dumps(r) + "\n"
                                            for r in rows))
    return test, d


def run_files(d) -> list:
    return sorted(str(p.relative_to(d)) for p in d.rglob("*")
                  if p.is_file() and p.name != "check.ckpt")


def same_run_files(what, got_d, want_d, pngs: bool) -> None:
    """Raises unless the card run's files are the cpu run's: every HTML
    page byte for byte, ``anomaly.json`` as JSON (without the forensics'
    wall time and backend), each PNG's pixels when ``pngs``. The cpu
    lane of a lifted check renders every invalid key's ``linear.png`` at
    the run's top (as the reference does) and the batched lane none, so
    that file is left out of the comparison."""
    files = [f for f in run_files(want_d) if f != "linear.png"]
    got_files = [f for f in run_files(got_d) if f != "linear.png"]
    if files != got_files:
        raise AssertionError(f"{what}: files {got_files} against {files}")
    for f in files:
        a, b = got_d / f, want_d / f
        if f.endswith(".png"):
            if pngs:
                import matplotlib.image as mpimg
                x, y = mpimg.imread(a), mpimg.imread(b)
                if x.shape != y.shape or (x != y).any():
                    raise AssertionError(f"{what}: {f}'s pixels differ")
        elif f.endswith("anomaly.json"):
            ja, jb = json.loads(a.read_text()), json.loads(b.read_text())
            for j in (ja, jb):
                j.pop("explain_latency_seconds")
                j.pop("backend")
            if ja != jb:
                raise AssertionError(f"{what}: {f} differs")
        elif a.read_bytes() != b.read_bytes():
            raise AssertionError(f"{what}: {f} differs")


def no_matplotlib(what, out, reports) -> None:
    """Raises unless each report of ``reports`` in ``out`` gave the
    reference's outcome without matplotlib: "unknown" with the import
    error (under each graph of ``perf``)."""
    for name in reports:
        sub = out[name]
        leaves = ([sub[k] for k in ("latency-graph", "rate-graph")]
                  if name == "perf" else [sub])
        if sub["valid?"] != "unknown" or any(
                "matplotlib" not in leaf.get("error", "")
                for leaf in leaves):
            raise AssertionError(f"{what}: {name} without matplotlib: "
                                 f"{sub}")


def suite_phase(name, smi, history, bad, device=None, keys=IND_KEYS,
                ops=IND_OPS, bad_keys=IND_BAD) -> dict:
    """Phase 19: a suite's composed check of two runs on the card, each
    held against the same composition with ``accelerator="cpu"`` on the
    card's host.

    * 19a: config 3's ``keys`` keys of ``ops`` ops, ``bad_keys``
      corrupted, the register workload's lifted check (the batched lane:
      the matrix screen and one key-batched frontier launch) with a
      timeline a key, stats, exceptions, perf and the clock plot;
    * 19b: the corrupted headline (``bad``) through the linearizable
      check with ``explain`` on (the matrix rung's localization on the
      card), stats, exceptions, perf and the run timeline.

    Each run is stamped with a seeded nanosecond clock, a partitioner's
    ``start``/``stop`` window, a ``start-partition``/``stop-partition``
    window (19b's over the first anomaly) whose inject and heal rows
    stand in the run's ``faults.jsonl``, and five ``check-offsets`` ops
    of five nodes. The verdicts, the workload's maps key by key, the
    stats, exceptions and clock maps and every file must equal the cpu
    run's; without ``matplotlib`` the PNG reports must give the
    reference's "unknown" and ``plot`` None. Returns each kernel's
    launches in the two composed checks on the card."""
    import importlib.util
    import tempfile

    import torch
    from jepsen_tpu_torch import checker as c
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.histories import (
        corrupt_keys, independent_register_history, stamp_times,
        with_nemesis)
    phase_t0 = time.perf_counter()
    mpl = importlib.util.find_spec("matplotlib") is not None
    cuda = device is None or str(device).startswith("cuda")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed_ms(fn):
        t0 = time.perf_counter()
        out = fn()
        sync()
        return (time.perf_counter() - t0) * 1e3, out

    h3 = corrupt_keys(independent_register_history(keys, ops), bad_keys,
                      n=2, seed=0)
    first_b = min(i for i, op in enumerate(bad) if op["value"] == 999)
    runs = {}
    for run, h, windows in (
            ("19a", h3, [(len(h3) // 6, len(h3) // 3, "start", "stop"),
                         (len(h3) // 2, 3 * len(h3) // 4,
                          "start-partition", "stop-partition")]),
            ("19b", bad, [(len(bad) // 10, len(bad) // 5, "start", "stop"),
                          (first_b - 500, first_b + 500,
                           "start-partition", "stop-partition")])):
        timed_h = stamp_times(h, seed=SEED)
        runs[run] = with_nemesis(
            timed_h, windows, seed=SEED,
            offsets_at=[len(h) * k // 5 for k in range(5)])
    rows_out = {}
    launches_suite = dict.fromkeys(read_launches(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        for run, (h, rows) in runs.items():
            test, d = suite_test_map(f"{tmp}/{run}-gpu", rows)
            cpu_test, cpu_d = suite_test_map(f"{tmp}/{run}-cpu", rows)
            reset_launches()
            compose_ms, got = timed_ms(lambda: suite_checker(
                run, "gpu", device).check(test, h, {}))
            launches = read_launches()
            for k, n in launches.items():
                launches_suite[k] += n
            cpu_ms, want = timed_ms(lambda: suite_checker(
                run, "cpu").check(cpu_test, h, {}))
            # each part alone, on a store dir of its own, as Compose
            # calls it
            suite = suite_checker(run, "gpu", device)
            part_ms = {}
            for part, chk in suite.checkers.items():
                t, _ = suite_test_map(f"{tmp}/{run}-{part}", rows)
                part_ms[part], _ = timed_ms(
                    lambda: c.check_safe(chk, t, h, {}))
            extra = {}
            if run == "19a":
                # the key split and the timelines alone: 64 pages
                t, td = suite_test_map(f"{tmp}/{run}-timelines", rows)
                extra["timelines_alone_ms"], _ = timed_ms(
                    lambda: independent.checker(c.timeline_html()).check(
                        t, h, {}))
                extra["timeline_pages"] = len(run_files(td)) - 1
            files = run_files(d)
            # the verdicts and maps against the cpu run
            what = f"suite {run}"
            if (got["valid?"], want["valid?"]) != (False, False):
                raise AssertionError(f"{what}: verdicts {got['valid?']} "
                                     f"and {want['valid?']}")
            for part in ("stats", "exceptions", "clock", "perf"):
                if part in got and got[part] != want[part]:
                    raise AssertionError(f"{what}: {part} {got[part]} "
                                         f"against {want[part]}")
            wl, wl_cpu = got["workload"], want["workload"]
            if run == "19a":
                if (wl["failures"], wl["count"]) != (
                        wl_cpu["failures"], wl_cpu["count"]) or \
                        wl["failures"] != sorted(str(k) for k in bad_keys):
                    raise AssertionError(f"{what}: failures "
                                         f"{wl['failures']}")
                for k, r in wl["results"].items():
                    lin, lin_cpu = r["linear"], wl_cpu["results"][k]["linear"]
                    ex, ex_cpu = lin.get("explain", {}), lin_cpu.get(
                        "explain", {})
                    if (r["valid?"], r["timeline"],
                            ex.get("first-anomaly-op"), ex.get("witness-ops"),
                            ex.get("artifacts")) != (
                            wl_cpu["results"][k]["valid?"],
                            wl_cpu["results"][k]["timeline"],
                            ex_cpu.get("first-anomaly-op"),
                            ex_cpu.get("witness-ops"),
                            ex_cpu.get("artifacts")):
                        raise AssertionError(f"{what}: key {k}: {r} "
                                             f"against {wl_cpu['results'][k]}")
                    if lin["algorithm"] != "jitlin-gpu":
                        raise AssertionError(f"{what}: the batched lane did "
                                             f"not take key {k}: {lin}")
                pages = [f for f in files if f.endswith("/timeline.html")]
                if len(pages) != keys or any(
                        f"independent/{k}/anomaly.json" not in files
                        for k in bad_keys):
                    raise AssertionError(f"{what}: files {files}")
            else:
                for key in ("valid?", "failed-op", "final-configs"):
                    if wl.get(key) != wl_cpu.get(key):
                        raise AssertionError(f"{what}: {key} differs")
                ex, ex_cpu = wl["explain"], wl_cpu["explain"]
                if (ex["first-anomaly-op"], ex["witness-ops"],
                        ex["artifacts"]) != (
                        ex_cpu["first-anomaly-op"], ex_cpu["witness-ops"],
                        ex_cpu["artifacts"]) \
                        or wl["algorithm"] != "torch-matrix" \
                        or got["timeline"] != {"valid?": True}:
                    raise AssertionError(f"{what}: {wl} against {wl_cpu}")
                anomaly = json.loads((d / "anomaly.json").read_text())
                if not any(w.get("overlaps_witness")
                           for w in anomaly["fault_windows"]):
                    raise AssertionError(f"{what}: no fault window over the "
                                         f"witness: {anomaly}")
                if cuda and not (launches["prefix_alive"]
                                 and launches["window_rescan"]):
                    raise AssertionError(f"{what}: launches {launches}")
            # a CPU rehearsal (``device="cpu"``) runs the plain versions
            if cuda and not (launches["chunk_product"]
                             and launches["combine_product"]):
                raise AssertionError(f"{what}: launches {launches}")
            same_run_files(what, d, cpu_d, mpl)
            reports = ("perf", "clock") if run == "19a" else ("perf",)
            want_pngs = ([p for p in SUITE_PNGS if p != "linear.png"]
                         if run == "19a" else SUITE_PNGS[:3] + ("linear.png",))
            if mpl:
                if any(got[r]["valid?"] is not True for r in reports) or \
                        any(p not in files for p in want_pngs):
                    raise AssertionError(f"{what}: reports {files}")
                if run == "19b" and wl["plot"] != str(d / "linear.png"):
                    raise AssertionError(f"{what}: plot {wl['plot']}")
            else:
                no_matplotlib(what, got, reports)
                if run == "19b" and (wl["plot"], wl_cpu["plot"]) != (
                        None, None):
                    raise AssertionError(f"{what}: plot {wl['plot']}")
            rows_out[run] = {
                "ops": len(h), "valid": got["valid?"],
                "verdicts": {part: r["valid?"] for part, r in got.items()
                             if part != "valid?"},
                "failures": wl.get("failures"),
                "first_anomaly_op": (
                    (wl.get("explain") or {}).get("first-anomaly-op")
                    if run == "19b" else
                    {k: r["linear"]["explain"]["first-anomaly-op"]
                     for k, r in wl["results"].items()
                     if "explain" in r["linear"]}),
                "algorithm": wl.get("algorithm"),
                "compose_ms": compose_ms, "cpu_compose_ms": cpu_ms,
                "part_ms": part_ms, **extra,
                "files": [f for f in files if "/" not in f],
                "key_files": len([f for f in files if "/" in f]),
                "launches": {k: n for k, n in launches.items() if n}}
    emit({"phase": "suite", "matplotlib": mpl, **rows_out,
          "launches_suite": {k: n for k, n in launches_suite.items() if n},
          "seconds": time.perf_counter() - phase_t0,
          "card": name, "power": smi})
    return launches_suite


# ---------------------------------------------------------------------------
# 20. the run loop: a whole test through core.run over the dummy remote
# ---------------------------------------------------------------------------

#: the README's quick start runs the etcd suite's fake test for 10 s
RUN_TIME_LIMIT = 10.0
#: one read in this many answers with the key's previous value in 20b
STALE_EVERY = 500
#: a stale answer waits for a read this long after its key's last write
STALE_AFTER_S = 0.001


def _seeded_double(base, seed: int, every: int | None):
    """A subclass of ``base`` (a ``KVClient``) whose instances share one
    lock, a generator seeded by ``seed`` and the counts of the answers it
    broke, and a ``prev`` map for the double's own bookkeeping: ``owe()``
    draws, one call in ``every`` (``BREAK_EVERY`` when None), whether an
    answer is owed, and ``paid()`` counts one broken answer in
    ``shared["broken"]``."""
    import random
    import threading
    every = every or BREAK_EVERY

    class Seeded(base):
        shared = {"lock": threading.Lock(), "rng": random.Random(seed),
                  "owed": 0, "broken": 0, "prev": {}}

        def owe(self) -> int:
            s = self.shared
            if s["rng"].randrange(every) == 0:
                s["owed"] += 1
            return s["owed"]

        def paid(self) -> None:
            self.shared["owed"] -= 1
            self.shared["broken"] += 1

    return Seeded


def _stale_client(kv, seed: int, every: int = STALE_EVERY):
    """Phase 20b's client: the fake register client, but one read in
    ``every`` (drawn from a generator seeded by ``seed`` and shared by
    the clients of one store) answers with a key's previous value. A
    drawn answer goes to the next read whose key's latest write returned
    at least ``STALE_AFTER_S`` before it and changed the value, so that
    the stale answer cannot be ordered before that write: with five
    threads on a key, a read that overlaps the write may see either
    value."""
    from jepsen_tpu_torch.fakes import KVClient

    class StaleKVClient(_seeded_double(KVClient, seed, every)):
        def invoke(self, test, op):
            f, v = op.get("f"), op.get("value")
            s = self.shared
            if f == "read":
                k = v[0]
                with s["lock"]:
                    owed = self.owe()
                    prev = s["prev"].get(k)
                    if owed and prev is not None \
                            and prev[0] != self.db.read(k) \
                            and time.monotonic() - prev[1] > STALE_AFTER_S:
                        self.paid()
                        return {**op, "type": "ok", "value": [k, prev[0]]}
                return super().invoke(test, op)
            if f in ("write", "cas"):
                with s["lock"]:
                    before = self.db.read(v[0])
                    out = super().invoke(test, op)
                    if out["type"] == "ok":
                        s["prev"][v[0]] = (before, time.monotonic())
                    return out
            return super().invoke(test, op)

    return StaleKVClient(kv)


#: the nemesis packages' interval in phases 20 and 21, as the suites'
NEMESIS_INTERVAL = 1.0

#: workload name -> (its kit, a module of jepsen_tpu_torch.workloads, and
#: the kit's keyword arguments): the etcd suite's register (phase 20) and
#: the yugabyte suite's YSQL kits whose checks reach the card (phase 21;
#: jepsen_tpu/suites/yugabyte.py:45-47), set-full the set kit with ``full``
WORKLOAD_KITS = {
    "register": ("register", {}),
    "single-key-acid": ("single_key_acid", {}),
    "multi-key-acid": ("multi_key_acid", {}),
    "set-full": ("set_workload", {"full": True}),
    "append": ("append", {}),
    "wr": ("wr", {}),
}


def workload_kit(workload: str, test: dict, accelerator: str,
                 device=None) -> dict:
    """The port's kit for ``workload`` (:data:`WORKLOAD_KITS`) over the
    test map ``test``."""
    import importlib
    module, kw = WORKLOAD_KITS[workload]
    return importlib.import_module(
        f"jepsen_tpu_torch.workloads.{module}").workload(
            test, accelerator=accelerator, device=device, **kw)


def run_test_map(store_dir: str, client_fn, time_limit: float,
                 accelerator: str, device=None, workload: str = "register",
                 concurrency: int = 5, nodes: int = 5) -> tuple:
    """A suite's fake test map (jepsen_tpu/suites/__init__.py:22-64
    ``compose_test`` and the fake branch of :67-186 ``build_suite_test``),
    over the port: ``nodes`` nodes (n1-n5), ``concurrency`` threads, the
    dummy remote, no OS, ``NoopNet``, the ``KVStore`` and a client over it
    (``client_fn(kv)``), the ``workload`` kit of :data:`WORKLOAD_KITS` at
    its defaults (the register workload: the etcd suite's), its config
    keys merged into the map, the partition, kill and pause packages at
    :data:`NEMESIS_INTERVAL`, the kit's final generator after the
    nemesis's, and ``compose({stats, exceptions, workload, perf})``.
    Returns the map and a dict the workload check's seconds land in."""
    from jepsen_tpu_torch import checker as c
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch.fakes import KVStore
    from jepsen_tpu_torch.nemesis import combined
    from jepsen_tpu_torch.net import NoopNet

    kv = KVStore()
    base = {"name": f"fake-{workload}",
            "nodes": [f"n{i}" for i in range(1, nodes + 1)],
            "concurrency": concurrency,
            "time_limit": time_limit, "ssh": {"dummy": True},
            "store_dir": store_dir, "db": kv, "client": client_fn(kv),
            "os": None, "net": NoopNet()}
    wl = workload_kit(workload, base, accelerator, device)
    pkg = combined.nemesis_package({"db": kv, "interval": NEMESIS_INTERVAL,
                                    "faults": {"partition", "kill", "pause"}})
    timing: dict = {}

    class TimedCheck(c.Checker):
        """The workload's checker, its seconds kept in ``timing``."""

        def check(self, test, history, opts):
            t0 = time.perf_counter()
            try:
                return wl["checker"].check(test, history, opts)
            finally:
                timing["check_s"] = time.perf_counter() - t0

    test = dict(base)
    for k, v in wl.items():
        if k not in ("generator", "checker", "final_generator") \
                and k not in test:
            test[k] = v
    phases = [gen.time_limit(time_limit, gen.any_gen(
                  gen.clients(wl["generator"]),
                  gen.nemesis_gen(pkg["generator"]))),
              gen.nemesis_gen(pkg["final_generator"])]
    if wl.get("final_generator") is not None:
        phases.append(gen.clients(wl["final_generator"]))
    test["generator"] = gen.phases(*phases)
    test["checker"] = c.compose({
        "stats": c.stats(ungated_fs=wl.get("stats_ungated_fs", ())),
        "exceptions": c.unhandled_exceptions(),
        "workload": TimedCheck(), "perf": c.perf()})
    test["nemesis"] = pkg["nemesis"]
    return test, timing


class _RunProbe:
    """Around one core.run: seeds the generator's context and the nemesis
    draws with ``seed``, times ``run_case`` and ``analyze``, counts the
    keys the batched lane hands to the key-batched frontier scan (the
    keys whose matrix verdict came back undecided), and sums the seconds
    of the linearizable check's exact twin in ``twin_s`` (summed over the
    keys, which run on several threads). Restores every name it replaced
    on exit."""

    def __init__(self, seed: int):
        self.seed = seed
        self.seconds: dict = {}
        self.undecided_keys = 0
        self.twin_s = 0.0

    def __enter__(self):
        import random

        import threading

        from jepsen_tpu_torch import core, parallel
        from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
        from jepsen_tpu_torch.generator import interpreter
        lin = LinearizableChecker
        self._saved = [(interpreter, "context", interpreter.context),
                       (core, "run_case", core.run_case),
                       (core, "analyze", core.analyze),
                       (parallel, "_scan_batch", parallel._scan_batch),
                       (lin, "_cpu_rung", lin.__dict__["_cpu_rung"])]
        self._state = random.getstate()
        random.seed(self.seed)
        ctx_fn, seed = interpreter.context, self.seed
        interpreter.context = lambda test, rng=None: ctx_fn(
            test, rng=random.Random(seed))

        def timed(key, fn):
            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    self.seconds[key] = time.perf_counter() - t0
            return wrapper

        core.run_case = timed("run_case_s", core.run_case)
        core.analyze = timed("analyze_s", core.analyze)
        scan = parallel._scan_batch

        def counted(streams, *a, **kw):
            self.undecided_keys += len(streams)
            return scan(streams, *a, **kw)

        parallel._scan_batch = counted
        twin, lock = lin._cpu_rung, threading.Lock()

        def twin_timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return twin(*a, **kw)
            finally:
                with lock:
                    self.twin_s += time.perf_counter() - t0

        lin._cpu_rung = staticmethod(twin_timed)
        return self

    def __exit__(self, *exc):
        import random
        for mod, attr, value in self._saved:
            setattr(mod, attr, value)
        random.setstate(self._state)
        return False


def run_verdicts(res: dict, history: list) -> tuple:
    """A lifted register check's verdict, its invalid keys and each key's
    (verdict, failed op's history index). A key the batched lane settled
    names its failed op by ``explain``'s ``first-anomaly-op``, a position
    in the key's sub-history."""
    from jepsen_tpu_torch import independent
    keys = {str(k): k for k in independent.history_keys(history)}
    per_key = {}
    for sk, r in (res.get("results") or {}).items():
        r = r.get("linear", r)
        op = r.get("failed-op")
        first = (r.get("explain") or {}).get("first-anomaly-op")
        if op is None and first is not None:
            op = independent.subhistory(keys[sk], history)[first]
        per_key[sk] = (r.get("valid?"),
                       None if op is None else op.get("index"))
    return res.get("valid?"), sorted(res.get("failures") or []), per_key


def run_store_files(what: str, d) -> tuple:
    """A whole run's store dir ``d``: its files, which must hold
    ``history.jsonl``, ``results.json``, ``test.json`` and a
    ``faults.jsonl`` whose windows (of the partition, kill and pause
    packages) all closed, and no WAL. Returns (files, windows, kinds)."""
    from jepsen_tpu_torch.nemesis import faults as faults_mod
    files = sorted(p.name for p in d.iterdir())
    need = {"history.jsonl", "results.json", "test.json", "faults.jsonl"}
    if not need <= set(files) or "history.wal.jsonl" in files:
        raise AssertionError(f"{what}: files {files}")
    windows = faults_mod.pair_rows(faults_mod.load_rows(d / "faults.jsonl"))
    kinds = sorted({w["kind"] for w in windows})
    if not windows or not set(kinds) <= {"net", "process", "pause"} \
            or not all(w["healed"] for w in windows):
        raise AssertionError(f"{what}: fault windows {windows}")
    return files, windows, kinds


def run_phase(name, smi, device=None, time_limit=RUN_TIME_LIMIT) -> dict:
    """Phase 20: whole test runs through the port's ``core.run`` on the
    card, the etcd suite's fake test map (:func:`run_test_map`) with the
    generator's context and the nemesis draws seeded by ``SEED``.

    * 20a: the fake register client. The workload's verdict must be
      valid, and the analysis must launch the chunk product and the
      combine; a frontier launch may come only with keys whose matrix
      verdict came back undecided (``undecided_keys``: the keys the
      batched lane hands to the frontier scan), and none are expected.
    * 20b: the stale-read double (:func:`_stale_client`). The verdict
      must be invalid with at least one invalid key, and the undecided
      keys take one ``frontier_dense_batch`` launch.

    Each run's stored history (``store.load_history``, indexed as
    ``analyze`` indexes it) is re-checked by the port with
    ``accelerator="cpu"``: the verdict, the invalid keys and each key's
    failed op must equal the card's. The store must hold
    ``history.jsonl``, ``results.json``, ``test.json`` and a
    ``faults.jsonl`` whose windows all closed, and no WAL. Returns each
    kernel's launches in the two runs."""
    import importlib.util
    import tempfile

    from jepsen_tpu_torch import core, independent, store
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.fakes import KVClient
    from jepsen_tpu_torch.history import index
    phase_t0 = time.perf_counter()
    mpl = importlib.util.find_spec("matplotlib") is not None
    cuda = device is None or str(device).startswith("cuda")
    out, launches_run = {}, dict.fromkeys(read_launches(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        for run, client_fn in (("20a", KVClient),
                               ("20b", lambda kv: _stale_client(kv, SEED))):
            test, timing = run_test_map(f"{tmp}/{run}", client_fn,
                                        time_limit, "gpu", device)
            what = f"run {run}"
            with _RunProbe(SEED) as probe:
                reset_launches()
                t0 = time.perf_counter()
                result = core.run(test)
                wall_s = time.perf_counter() - t0
                launches = read_launches()
            for k, n in launches.items():
                launches_run[k] += n
            res = result["results"]
            wl = res["workload"]
            history = result["history"]
            stored = index(store.load_history(
                result["name"], result["start_time"], f"{tmp}/{run}"))
            t0 = time.perf_counter()
            # no forensics: the cpu lane's failed-op is the comparison,
            # and a test map without store coordinates writes no artifact
            cpu = independent.checker(linearizable(
                accelerator="cpu")).check({}, stored, {"explain": False})
            cpu_s = time.perf_counter() - t0
            got, want = run_verdicts(wl, history), run_verdicts(cpu, stored)
            if got != want:
                bad = {k: (v, want[2].get(k)) for k, v in got[2].items()
                       if v != want[2].get(k)}
                raise AssertionError(f"{what}: the card's verdicts differ "
                                     f"from the cpu re-check: {got[:2]} "
                                     f"against {want[:2]}, keys {bad}")
            lin_algos = {r["linear"].get("algorithm")
                         for r in wl["results"].values()}
            # without matplotlib (the chip machine) perf gives the
            # reference's "unknown", and so does the composed verdict of
            # a valid run
            parts = {k: v["valid?"] for k, v in res.items()
                     if isinstance(v, dict)}
            if (parts["stats"], parts["exceptions"], parts["perf"]) != (
                    True, True, True if mpl else "unknown"):
                raise AssertionError(f"{what}: verdicts {parts}")
            if run == "20a":
                if wl["valid?"] is not True or wl["failures"] or \
                        res["valid?"] != (True if mpl else "unknown"):
                    raise AssertionError(f"{what}: not valid: {parts} "
                                         f"failures {wl['failures']}")
                # a frontier launch only for the keys the screen left
                # undecided (none are expected)
                scans = launches["frontier_dense_batch"] \
                    + launches["frontier_sparse_batch"]
                if cuda and (scans > 0) != (probe.undecided_keys > 0):
                    raise AssertionError(
                        f"{what}: {probe.undecided_keys} undecided keys, "
                        f"launches {launches}")
            else:
                if wl["valid?"] is not False or not wl["failures"] \
                        or res["valid?"] is not False:
                    raise AssertionError(
                        f"{what}: {broken_answers(test['client'])} stale "
                        f"reads gave {wl['valid?']} {wl['failures']}")
                if cuda and launches["frontier_dense_batch"] != 1:
                    raise AssertionError(f"{what}: launches {launches}")
            if cuda and not (launches["chunk_product"]
                             and launches["combine_product"]):
                raise AssertionError(f"{what}: launches {launches}")
            if lin_algos != {"jitlin-gpu"}:
                raise AssertionError(f"{what}: the batched lane did not "
                                     f"settle every key: {lin_algos}")
            d = store.test_dir(result)
            files, windows, kinds = run_store_files(what, d)
            secs = probe.seconds
            n_ops = sum(1 for op in history if op["process"] != "nemesis")
            out[run] = {
                "ops": len(history), "client_ops": n_ops,
                "keys": len(wl["results"]), "valid": res["valid?"],
                "verdicts": parts,
                "failures": wl["failures"],
                "failed_ops": {k: v[1] for k, v in got[2].items()
                               if v[0] is not True},
                "stale_reads": broken_answers(test["client"]),
                "undecided_keys": probe.undecided_keys,
                "ops_per_s": len(history) / secs["run_case_s"],
                "run_case_s": secs["run_case_s"],
                "analyze_s": secs["analyze_s"],
                "check_s": timing["check_s"], "wall_s": wall_s,
                "check_share": timing["check_s"] / wall_s,
                "cpu_recheck_s": cpu_s,
                "fault_windows": {k: sum(w["kind"] == k for w in windows)
                                  for k in kinds},
                "files": files,
                "key_files": sum(1 for _ in (d / "independent").rglob("*")
                                 if _.is_file()),
                "launches": {k: n for k, n in launches.items() if n}}
    emit({"phase": "run", "time_limit_s": time_limit, "matplotlib": mpl,
          **out,
          "launches_run": {k: n for k, n in launches_run.items() if n},
          "seconds": time.perf_counter() - phase_t0,
          "card": name, "power": smi})
    return launches_run


# ---------------------------------------------------------------------------
# 21. the workloads: the card-checked kits' whole runs through core.run
# ---------------------------------------------------------------------------

#: each phase-21 run's time limit: at 5 s the fourteen runs took 221 s
#: on one chip machine's host, which with the earlier phases leaves too
#: little of the script's 1,200 s on a slower host (set-full's history
#: grows as the square of the run: every read returns the whole set)
WORKLOADS_TIME_LIMIT = 3.0
#: one op in this many (drawn from a generator seeded by SEED) breaks the
#: workload's guarantee in phase 21's invalid runs
BREAK_EVERY = 200


def _stale_txn_client(kv, seed: int, every: int | None = None):
    """Multi-key-acid's broken client: the fake multi-register client, but
    one read txn in ``every`` answers one key with its value before that
    key's latest write, which changed it and returned at least
    ``STALE_AFTER_S`` before (a stale read of a multi-key snapshot)."""
    from jepsen_tpu_torch.fakes import KVClient

    class StaleTxnClient(_seeded_double(KVClient, seed, every)):
        def invoke(self, test, op):
            if op.get("f") != "txn":
                return super().invoke(test, op)
            group, mops = op["value"]
            s = self.shared
            with s["lock"]:
                if any(m[0] != "r" for m in mops):
                    before = {k: self.db.read((group, k)) for _, k, _ in mops}
                    out = super().invoke(test, op)
                    now = time.monotonic()
                    for k, v in before.items():
                        s["prev"][(group, k)] = (v, now)
                    return out
                owed = self.owe()
                out = super().invoke(test, op)
                for i, (_, k, v) in enumerate(out["value"][1] if owed
                                              else ()):
                    prev = s["prev"].get((group, k))
                    if prev is not None and prev[0] is not None \
                            and prev[0] != v \
                            and time.monotonic() - prev[1] > STALE_AFTER_S:
                        vals = list(out["value"][1])
                        vals[i] = ["r", k, prev[0]]
                        self.paid()
                        return {**out, "value": [group, vals]}
                return out

    return StaleTxnClient(kv)


def _lost_add_client(kv, seed: int, every: int | None = None):
    """Set-full's broken client: the fake set client, but one add in
    ``every`` is acknowledged and never stored (a lost add)."""
    from jepsen_tpu_torch.fakes import KVClient

    class LostAddClient(_seeded_double(KVClient, seed, every)):
        def invoke(self, test, op):
            if op.get("f") == "add":
                with self.shared["lock"]:
                    if self.owe():
                        self.paid()
                        return {**op, "type": "ok"}
            return super().invoke(test, op)

    return LostAddClient(kv)


def _stale_append_client(kv, seed: int, every: int | None = None):
    """Append's broken client: the fake list-append client, but one txn in
    ``every`` reads a key without its latest append, whose txn returned
    at least ``STALE_AFTER_S`` before (a read that drops an acknowledged
    append)."""
    from jepsen_tpu_torch.fakes import KVClient

    class DroppedAppendClient(_seeded_double(KVClient, seed, every)):
        def invoke(self, test, op):
            if op.get("f") != "txn":
                return super().invoke(test, op)
            s = self.shared
            written = {k for f, k, _ in op["value"] if f != "r"}
            with s["lock"]:
                owed = self.owe()
                before = {k: len(self.db.lists.get(k, ())) for k in written}
                out = super().invoke(test, op)
                now = time.monotonic()
                mops = list(out["value"])
                for i, (f, k, v) in enumerate(mops if owed else ()):
                    prev = s["prev"].get(k)
                    if f == "r" and k not in written and prev is not None \
                            and len(v) > prev[0] \
                            and now - prev[1] > STALE_AFTER_S:
                        mops[i] = ["r", k, v[:prev[0]]]
                        self.paid()
                        break
                for k, n in before.items():
                    s["prev"][k] = (n, now)
                return {**out, "value": mops}

    return DroppedAppendClient(kv, txn_style="append")


def _stale_wr_client(kv, seed: int, every: int | None = None):
    """Wr's broken client: the fake rw-register client, but one txn in
    ``every`` reads a key as the value it held before its latest
    read-then-write txn, which returned at least ``STALE_AFTER_S`` before
    (a stale read of a version whose successor that txn's trace shows:
    the reader precedes the writer by anti-dependency and follows it in
    real time, a cycle inside a short window)."""
    from jepsen_tpu_torch.fakes import KVClient

    class StaleWrClient(_seeded_double(KVClient, seed, every)):
        def invoke(self, test, op):
            if op.get("f") != "txn":
                return super().invoke(test, op)
            s = self.shared
            written = {k for f, k, _ in op["value"] if f != "r"}
            with s["lock"]:
                owed = self.owe()
                out = super().invoke(test, op)
                now = time.monotonic()
                mops = list(out["value"])
                for i, (f, k, v) in enumerate(mops if owed else ()):
                    prev = s["prev"].get(k)
                    if f == "r" and k not in written and prev is not None \
                            and prev[0] != v \
                            and now - prev[1] > STALE_AFTER_S:
                        mops[i] = ["r", k, prev[0]]
                        self.paid()
                        break
                # a key's first read before the txn writes it, then its
                # write: the read value's successor
                read, wrote = {}, set()
                for f, k, v in out["value"]:
                    if f == "r" and k not in read and k not in wrote:
                        read[k] = v
                    elif f == "w":
                        if read.get(k) is not None and k not in wrote:
                            s["prev"][k] = (read[k], now)
                        wrote.add(k)
                return {**out, "value": mops}

    return StaleWrClient(kv, txn_style="wr")


def _honest_client(workload: str):
    """The suite's fake client for ``workload`` (build_suite_test's fake
    branch: wr reads registers, the rest read lists or sets)."""
    from jepsen_tpu_torch.fakes import KVClient
    style = "wr" if workload == "wr" else "append"
    return lambda kv: KVClient(kv, txn_style=style)


#: phase 21's runs: workload, nodes, threads, the invalid run's double
#: and the kernels each of its runs must launch. The acid kits' key groups
#: are 2n threads wide (multi_key_acid.clj:59, single_key_acid.clj:33: at
#: the suites' 5 threads they emit no op), so a key holds up to 2n slots:
#: at 5 nodes 10, past the matrix screen's 8 and the dense table's 9; at 3
#: (yugabyte's smallest replication-factor-3 cluster) 6, within both
WORKLOAD_RUNS = (
    ("single-key-acid", 5, 10, lambda kv: _stale_client(
        kv, SEED, every=BREAK_EVERY), ()),
    ("single-key-acid", 3, 6, lambda kv: _stale_client(
        kv, SEED, every=BREAK_EVERY), ("chunk_product", "combine_product")),
    ("multi-key-acid", 5, 10, lambda kv: _stale_txn_client(kv, SEED), ()),
    ("multi-key-acid", 3, 6, lambda kv: _stale_txn_client(kv, SEED),
     ("frontier_dense",)),
    ("set-full", 5, 5, lambda kv: _lost_add_client(kv, SEED),
     ("set_classify",)),
    ("append", 5, 5, lambda kv: _stale_append_client(kv, SEED), ()),
    ("wr", 5, 5, lambda kv: _stale_wr_client(kv, SEED), ()),
)


#: the most of a multi-key-acid run's keys the exact twin may settle: at
#: 5 nodes a key holds 10 slots, the sparse list's K = 256 configurations
#: overflow for about a third of the keys (ROADMAP S7), and those keys go
#: to the twin; at 3 nodes every key is on the dense table and none may
TWIN_MAX_KEY_SHARE = 0.5


def broken_answers(client) -> int:
    """The answers a double broke (0 for the honest client)."""
    return getattr(client, "shared", {}).get("broken", 0)


def workload_verdicts(workload: str, res: dict, history: list) -> tuple:
    """What a phase-21 run's card check and its cpu re-check must agree
    on: a lifted kit's verdict, invalid keys and each key's failed op
    (:func:`run_verdicts`); set-full's whole result map; an Elle kit's
    verdict and anomaly types (the cycles it cites as witnesses may
    differ: the card's φ-cluster search and the cpu oracle's global
    Tarjan each report their first ten)."""
    if workload.endswith("-acid"):
        return run_verdicts(res, history)
    if workload == "set-full":
        return res
    return res["valid?"], res.get("anomaly-types")


def acid_keys(workload: str, history: list) -> dict:
    """Each acid key's (slots, frontier route "dense" or "sparse"):
    single-key-acid's register encoding, multi-key-acid's packed (3, 5)
    map of 216 states."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linear_encode import (
        encode_multi_register_ops, encode_register_ops)
    from jepsen_tpu_torch.models import multi_register_spec
    from jepsen_tpu_torch.ops.jitlin import JitLinKernel
    multi = workload == "multi-key-acid"
    kernel = JitLinKernel(step_ids=multi_register_spec(*MR_SHAPE).step_ids
                          if multi else None)
    keys, subs = independent.split_history(history)
    out = {}
    for k in keys:
        st = (encode_multi_register_ops(subs[k], *MR_SHAPE) if multi
              else encode_register_ops(subs[k]))
        out[str(k)] = (st.n_slots, kernel.route(st.n_slots, len(st.intern)))
    return out


def _run_kernels(workload: str, run: str, res: dict, launches: dict,
                 undecided: int, history: list) -> str | None:
    """Why a phase-21 run's launches do not show its check on the card,
    or None. Single-key-acid's keys all settle in the batched lane on the
    card: the matrix screen (chunk products and combines), then one
    key-batched frontier launch for the keys it leaves undecided; or, when
    the batch's slots or its element budget rule the screen out (the
    kit's 10 threads a key reach ``MATRIX_MAX_SLOTS``), one key-batched
    frontier launch for all. Multi-key-acid's keys take a frontier launch
    a key, and every key on the dense table's route settles there, none
    in the exact twin (ROADMAP Queue 3 item 4's repair); a sparse key
    whose K = 256 list overflows goes to the twin, as in phase 11, and
    those keys may be at most :data:`TWIN_MAX_KEY_SHARE` of the run's.
    Set-full launches the classify once; the Elle kits' invalid runs
    screen their φ clusters."""
    if workload == "single-key-acid":
        scans = launches["frontier_dense_batch"] \
            + launches["frontier_sparse_batch"]
        screened = launches["chunk_product"] > 0
        algos = {r["linear"].get("algorithm")
                 for r in res["results"].values()}
        if algos != {"jitlin-gpu"} or scans > 1 \
                or (scans == 1) != (undecided > 0) \
                or screened != (launches["combine_product"] > 0) \
                or not (screened or undecided == len(res["results"])):
            return f"{undecided} undecided keys, algorithms {algos}"
    elif workload == "multi-key-acid":
        keys = acid_keys(workload, history)
        in_twin = [k for k, r in res["results"].items()
                   if r["linear"].get("algorithm") == "jitlin-cpu(fallback)"]
        twin = [k for k in in_twin if keys[k][1] == "dense"]
        if len(in_twin) > TWIN_MAX_KEY_SHARE * len(keys):
            return (f"{len(in_twin)} of {len(keys)} keys in the twin, past "
                    f"{TWIN_MAX_KEY_SHARE}")
        n_dense = sum(r == "dense" for _, r in keys.values())
        # the broken run's impossible reads, on the dense route, settle
        # on the card: none of them in the twin, which took them all
        # before the repair
        settled = [k for k, r in res["results"].items()
                   if r["valid?"] is False and keys[k][1] == "dense"]
        if twin or launches["frontier_dense"] != n_dense \
                or launches["frontier_sparse"] != len(keys) - n_dense \
                or (run == "invalid" and n_dense == len(keys)
                    and not settled):
            return f"dense keys in the twin: {twin}"
    elif workload == "set-full":
        if launches["set_classify"] != 1:
            return "not one set_classify"
    elif run == "invalid" and not launches["cluster_screen"]:
        return "no cluster_screen"
    return None


def workloads_phase(name, smi, device=None,
                    time_limit=WORKLOADS_TIME_LIMIT) -> dict:
    """Phase 21: the card-checked workload kits through the port's
    ``core.run`` on the card, each in the yugabyte suite's fake test map
    (:func:`run_test_map`, ``accelerator="gpu"``; set-full is the set kit
    with ``full``) with the generator's context and the nemesis draws
    seeded by ``SEED``, twice: with the honest fake client (the verdict
    must be valid) and with a double that breaks the kit's guarantee
    (:data:`WORKLOAD_RUNS`; the verdict must be invalid).

    Each run's stored history is re-checked by the port with
    ``accelerator="cpu"`` (:func:`workload_verdicts` must agree), its
    store must be whole (:func:`run_store_files`), and its launches must
    show the check on the card (:func:`_run_kernels`). Prints the
    ``workloads`` line (each run's ops a second of ``run_case``, the
    check's seconds and share of the wall, the verdict and launches) and
    returns each kernel's launches over the ten runs."""
    import importlib.util
    import tempfile

    from jepsen_tpu_torch import core, store
    from jepsen_tpu_torch.history import index
    phase_t0 = time.perf_counter()
    mpl = importlib.util.find_spec("matplotlib") is not None
    cuda = device is None or str(device).startswith("cuda")
    out, launches_all = {}, dict.fromkeys(read_launches(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        for workload, nodes, threads, broken, must in WORKLOAD_RUNS:
            for run, client_fn in (("valid", _honest_client(workload)),
                                   ("invalid", broken)):
                what = f"workload {workload} n{nodes} {run}"
                d0 = f"{tmp}/{workload}-{nodes}-{run}"
                test, timing = run_test_map(d0, client_fn, time_limit,
                                            "gpu", device, workload,
                                            threads, nodes=nodes)
                with _RunProbe(SEED) as probe:
                    reset_launches()
                    t0 = time.perf_counter()
                    result = core.run(test)
                    wall_s = time.perf_counter() - t0
                    launches = read_launches()
                for k, n in launches.items():
                    launches_all[k] += n
                res = result["results"]
                wl = res["workload"]
                stored = index(store.load_history(
                    result["name"], result["start_time"], d0))
                cpu_chk = workload_kit(workload, test, "cpu",
                                       "cpu")["checker"]
                if workload.endswith("-acid"):
                    # the lifted linear check alone: a map without store
                    # coordinates renders no timeline
                    cpu_chk = type(cpu_chk)(cpu_chk.checker.checkers["linear"])
                t0 = time.perf_counter()
                # no forensics: the cpu lane's failed-op is the comparison
                cpu = cpu_chk.check(None, stored, {"explain": False})
                cpu_s = time.perf_counter() - t0
                got = workload_verdicts(workload, wl, result["history"])
                want = workload_verdicts(workload, cpu, stored)
                if got != want:
                    raise AssertionError(f"{what}: the card's verdicts "
                                         f"differ from the cpu re-check")
                if wl["valid?"] is not (run == "valid"):
                    raise AssertionError(
                        f"{what}: {wl['valid?']}, "
                        f"{getattr(test['client'], 'shared', {})}")
                parts = {k: v["valid?"] for k, v in res.items()
                         if isinstance(v, dict)}
                if (parts["stats"], parts["exceptions"], parts["perf"]) != (
                        True, True, True if mpl else "unknown"):
                    raise AssertionError(f"{what}: verdicts {parts}")
                why = cuda and (_run_kernels(workload, run, wl, launches,
                                             probe.undecided_keys,
                                             result["history"])
                                or [k for k in must if not launches[k]])
                if why:
                    raise AssertionError(f"{what}: {why}: {launches}")
                files, windows, kinds = run_store_files(
                    what, store.test_dir(result))
                secs = probe.seconds
                history = result["history"]
                row = {
                    "nodes": nodes, "threads": threads,
                    "ops": len(history),
                    "client_ops": sum(op["process"] != "nemesis"
                                      for op in history),
                    "valid": wl["valid?"], "composed_valid": res["valid?"],
                    "anomalies": (sorted(wl.get("anomaly-types") or [])
                                  or wl.get("failures")
                                  or [k for k in ("lost", "stale")
                                      if wl.get(f"{k}-count")]),
                    "broken_answers": broken_answers(test["client"]),
                    "undecided_keys": probe.undecided_keys,
                    "ops_per_s": len(history) / secs["run_case_s"],
                    "run_case_s": secs["run_case_s"],
                    "analyze_s": secs["analyze_s"],
                    "check_s": timing["check_s"], "wall_s": wall_s,
                    "check_share": timing["check_s"] / wall_s,
                    "cpu_recheck_s": cpu_s,
                    "fault_windows": {k: sum(w["kind"] == k
                                             for w in windows)
                                      for k in kinds},
                    "files": len(files),
                    "launches": {k: n for k, n in launches.items() if n}}
                if workload.endswith("-acid"):
                    keys = acid_keys(workload, history)
                    algos: dict = {}
                    for k, r in wl["results"].items():
                        a = f"{keys[k][1]} {r['linear'].get('algorithm')}"
                        if r["valid?"] is not True:
                            a += " invalid"
                        algos[a] = algos.get(a, 0) + 1
                    row["routes_algorithms"] = algos
                    row["max_slots"] = max(s for s, _ in keys.values())
                    n_twin = sum(r["linear"].get("algorithm")
                                 == "jitlin-cpu(fallback)"
                                 for r in wl["results"].values())
                    row["twin_keys"] = n_twin
                    row["twin_key_share"] = n_twin / len(keys)
                    row["twin_s"] = probe.twin_s
                out[f"{workload} n{nodes} {run}"] = row
    emit({"phase": "workloads", "time_limit_s": time_limit,
          "matplotlib": mpl, "runs": out,
          "launches_workloads": {k: n for k, n in launches_all.items()
                                 if n},
          "seconds": time.perf_counter() - phase_t0,
          "card": name, "power": smi})
    return launches_all


# ---------------------------------------------------------------------------
# 17. telemetry: the registry, the run tracer and the profiler on the card
# ---------------------------------------------------------------------------

#: the names of the combine's CUDA kernels (ops/csrc/chunk_combine.cu)
COMBINE_KERNELS = ("pack_flat_kernel", "pack_rows_kernel",
                   "tree_level_kernel")
#: timed pairs of headline checks, null and live registry, in phase 17:
#: a headline check's host time spreads over 10-20 ms between calls on
#: one host, so medians of 5 pairs cannot resolve a cost of a few percent
TELEMETRY_PAIRS = 20
#: the most the live registry and tracer may add to a headline check: the
#: median over TELEMETRY_PAIRS of the live check's time over the null
#: one's, less 1
TELEMETRY_MAX_OVERHEAD = 0.10


def instrument_us(chk, stream, reps: int = 200) -> dict:
    """Host microseconds a call of each instrumented step, with the null
    registry and tracer and with live ones (a registry of its own and a
    tracer with a flight recorder): the checker's ``_record_metrics`` for
    a ``torch-matrix`` verdict on ``stream`` (with the card's allocator
    high-water), a one-dispatch ``DispatchPipeline`` on the card (its
    event and fetch included), a rung's slice, and
    ``device_memory_peak_bytes`` alone, beside
    ``torch.cuda.max_memory_allocated``, which reads the same value
    through the allocator's flattened stats."""
    import torch
    from jepsen_tpu_torch import telemetry, trace
    from jepsen_tpu_torch.checker.linear_cpu import LinearResult
    from jepsen_tpu_torch.checker.linearizable import _Rung
    from jepsen_tpu_torch.parallel.pipeline import DispatchPipeline
    from jepsen_tpu_torch.trace.flight import FlightRecorder
    res = LinearResult(valid=True, algorithm="torch-matrix")
    one = torch.zeros(1, device="cuda")

    def pipeline():
        p = DispatchPipeline(depth=2, name="matrix", device="cuda")
        p.submit(lambda: (), lambda: one + 1)
        p.results()

    def rung():
        with _Rung("torch-matrix") as r:
            r.settled = True

    steps = {"record_metrics": lambda: chk._record_metrics(
                 res, 0.04, len(stream)),
             "dispatch_pipeline": pipeline, "rung_span": rung,
             "device_memory_peak_bytes":
                 lambda: telemetry.device_memory_peak_bytes("cuda"),
             "max_memory_allocated":
                 lambda: torch.cuda.max_memory_allocated("cuda")}
    if telemetry.device_memory_peak_bytes("cuda") != \
            torch.cuda.max_memory_allocated("cuda"):
        raise AssertionError("telemetry: the allocator's peak differs "
                             "from max_memory_allocated")
    out = {}
    for live in (False, True):
        reg = telemetry.Registry() if live else telemetry.NULL
        tracer = (trace.RunTracer(flight=FlightRecorder(4096)) if live
                  else trace.NULL_TRACER)
        with telemetry.use(reg), trace.use(tracer):
            for key, fn in steps.items():
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                out.setdefault(key, {})["live" if live else "null"] = (
                    time.perf_counter() - t0) / reps * 1e6
    return out


def telemetry_phase(name, smi, history, bad, device=None) -> dict:
    """Phase 17: the telemetry registry and the run tracer on the card's
    check path. A live ``telemetry.Registry`` and a ``trace.RunTracer``
    (a Perfetto sink and a flight recorder in a temporary store
    directory) watch the headline check, its corrupted copy with
    ``explain`` on, the long history's segmented chain writing
    ``check.ckpt`` and the check that resumes from it, and config 3's key
    batch; each runs with the null registry too, and its result map and
    launches must be the same. Runs right after phase 13: it takes the
    long history from LIVE_RUNS, and leaves the long stream and config 3
    to phase 14. Returns each kernel's launches in the live checks."""
    import tempfile
    from pathlib import Path

    import torch
    from jepsen_tpu_torch import independent, telemetry, trace
    from jepsen_tpu_torch.checker import checkpoint as ck
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.ops import jitlin
    from jepsen_tpu_torch.trace.flight import FlightRecorder
    from jepsen_tpu_torch.trace.perfetto import PerfettoSink

    phase_t0 = time.perf_counter()
    long_h = LIVE_RUNS.pop("long")[0]
    long_stream = LIVE_RUNS["long_stream"]
    h3 = LIVE_RUNS["config3"][0]
    chk = linearizable(accelerator="gpu", device=device)
    ind = independent.checker(chk)
    reg = telemetry.Registry()
    live_launches: dict = {}
    common = {"card": name, "power": smi}

    def run(fn, tracer):
        """``fn()`` with the null registry and tracer (``tracer`` None) or
        with the live ones: (its value, its launches, host seconds to a
        sync)."""
        reset_launches()
        t0 = time.perf_counter()
        if tracer is None:
            out = fn()
            torch.cuda.synchronize()
        else:
            with telemetry.use(reg), trace.use(tracer):
                out = fn()
                torch.cuda.synchronize()
        s = time.perf_counter() - t0
        lc = read_launches()
        if tracer is not None:
            add_launches(live_launches, lc)
        return out, lc, s

    def same(what, got, null):
        """The live run's result and launches equal the null one's."""
        if got[0] != null[0] or got[1] != null[1]:
            raise AssertionError(f"telemetry {what}: the live run differs "
                                 f"from the null one: {got[:2]} vs "
                                 f"{null[:2]}")

    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        tracer = trace.RunTracer(
            perfetto=PerfettoSink(d / trace.TRACE_NAME),
            flight=FlightRecorder(trace.DEFAULT_FLIGHT_EVENTS))
        # 17a. the headline, null and live in turns (a first pair, then
        # TELEMETRY_PAIRS timed pairs, which of the two goes first
        # alternating)
        times = {"null": [], "live": []}
        for i in range(TELEMETRY_PAIRS + 1):
            if i % 2:
                got = run(lambda: chk.check({}, history, {}), tracer)
                null = run(lambda: chk.check({}, history, {}), None)
            else:
                null = run(lambda: chk.check({}, history, {}), None)
                got = run(lambda: chk.check({}, history, {}), tracer)
            same("headline", got, null)
            if got[0]["algorithm"] != "torch-matrix" or min(
                    got[1]["chunk_product"], got[1]["combine_product"]) < 1:
                raise AssertionError(f"telemetry headline: {got[:2]}")
            if i:
                times["null"].append(null[2])
                times["live"].append(got[2])
        n_headline = TELEMETRY_PAIRS + 1
        # 17b. the corrupted headline with explain on: localized on the
        # card, explained
        null_b = run(lambda: chk.check({}, bad, {}), None)
        got_b = run(lambda: chk.check({}, bad, {}), tracer)
        same("headline_corrupted", got_b, null_b)
        if got_b[0]["algorithm"] != "torch-matrix" \
                or got_b[0]["valid?"] is not False \
                or "explain" not in got_b[0] \
                or min(got_b[1]["prefix_alive"],
                       got_b[1]["window_rescan"]) < 1:
            raise AssertionError(f"telemetry headline_corrupted: "
                                 f"{got_b[1]}, {got_b[0].get('explain')}")

        # 17c. the long history: the chain writes check.ckpt at each cut
        # but its last; the check with the same store resumes at the
        # last write, runs the last segment and clears it
        n_cuts = len(jitlin.quiescent_cuts(long_stream.kind,
                                           jitlin.MATRIX_SEGMENT_EVENTS))
        def long_run(where):
            test = {"name": "telemetry_long",
                    "start_time": "20261018T000000.000Z",
                    "store_dir": str(d / where),
                    "check_ckpt_interval": 1e-9}
            path = d / where / test["name"] / test["start_time"] / \
                ck.CKPT_NAME
            store = ck.CheckpointStore(path, interval_s=1e-9)
            chain = jitlin.matrix_check_segmented(long_stream, ckpt=store,
                                                  device=device)
            if not path.exists():
                raise AssertionError("telemetry long: the chain left no "
                                     "check.ckpt")
            out = chk.check(test, long_h, {})
            if path.exists():
                raise AssertionError("telemetry long: the settled check "
                                     "left its check.ckpt")
            return chain, store.writes, out

        null_l = run(lambda: long_run("null"), None)
        got_l = run(lambda: long_run("live"), tracer)
        same("long", got_l, null_l)
        if got_l[0][2]["valid?"] is not True \
                or got_l[0][2]["algorithm"] != "torch-matrix" \
                or got_l[0][1] != n_cuts - 1 or n_cuts < 2:
            raise AssertionError(f"telemetry long: {got_l[0]}, {n_cuts} "
                                 f"cuts")
        # 17d. config 3's 64 keys through the dispatch pipeline
        null_k = run(lambda: ind.check({}, h3, {}), None)
        got_k = run(lambda: ind.check({}, h3, {}), tracer)
        same("config3", got_k, null_k)
        same_map("telemetry config3", got_k[0], null_k[0])
        tracer.close()
        # the flight recorder's dump: a header, then its ring
        flight_path = d / trace.FLIGHT_NAME
        if not tracer.dump_flight(flight_path, "telemetry"):
            raise AssertionError("telemetry: the flight dump failed")
        flight_rows = [json.loads(ln) for ln in
                       flight_path.read_text().splitlines()]
        if flight_rows[0]["retained"] != tracer.flight.recorded \
                or [r.get("name") for r in flight_rows[1:]] != [
                    e.get("name") for e in tracer.flight.snapshot()]:
            raise AssertionError("telemetry: the flight dump is not the "
                                 "ring")
        trace_path = d / trace.TRACE_NAME
        with open(trace_path, encoding="utf-8") as f:
            events = json.load(f)            # strict JSON after close()
        reg.export(d)
        prom = (d / "metrics.prom").read_text()
        trace_bytes = trace_path.stat().st_size

        # 17e. a profiler trace of one headline check names both kernels
        # (retaken, as device_kernels does, when it comes back short)
        for attempt in range(5):
            prof_dir = d / f"profile{attempt}"
            with telemetry.profiler_trace(prof_dir):
                chk.check({}, history, {})
                torch.cuda.synchronize()
            prof = (prof_dir / telemetry.PROFILE_NAME).read_text()
            if "chunk_product_kernel" in prof and any(
                    k in prof for k in COMBINE_KERNELS):
                break
        else:
            raise AssertionError("telemetry: the profiler's trace names "
                                 "no chunk-product or combine kernel")
        prof_bytes = len(prof)

    # the counts the live checks must show
    def value(family, **labels):
        return reg.counter(family, labels=tuple(labels)).value(**labels)

    want = {
        ("checker_backend_total", "torch-matrix"): n_headline + 2,
        ("checker_resume_total", "ckpt"): 1,
        ("checker_ckpt_writes_total", None): n_cuts - 1,
        ("explain_total", "matrix-bisect"): 1,
        ("dispatch_batches_total", "matrix"):
            n_headline + 1 + sub_batches(IND_KEYS),
    }
    got_counts = {
        ("checker_backend_total", "torch-matrix"):
            value("checker_backend_total", backend="torch-matrix"),
        ("checker_resume_total", "ckpt"):
            value("checker_resume_total", source="ckpt"),
        ("checker_ckpt_writes_total", None):
            value("checker_ckpt_writes_total"),
        ("explain_total", "matrix-bisect"):
            value("explain_total", backend="matrix-bisect"),
        ("dispatch_batches_total", "matrix"):
            value("dispatch_batches_total", queue="matrix"),
    }
    if got_counts != want:
        raise AssertionError(f"telemetry counts: {got_counts} vs {want}")
    mem = reg.gauge("checker_device_memory_peak_bytes").value()
    total_mem = torch.cuda.get_device_properties(0).total_memory
    if not 0 < mem <= total_mem:
        raise AssertionError(f"telemetry: device memory peak {mem} of "
                             f"{total_mem}")
    names = {e.get("name") for e in events}
    need = {"segment", "ckpt-write", "ckpt-resume", "explain", "rung"}
    if not need <= names:
        raise AssertionError(f"telemetry: trace.json lacks "
                             f"{sorted(need - names)}")
    by_name = {}
    for e in events:
        if e.get("ph") != "M":
            by_name[e["name"]] = by_name.get(e["name"], 0) + 1
    med_null = statistics.median(times["null"])
    med_live = statistics.median(times["live"])
    # each pair's live time over its null time: the pairs run back to back,
    # so the host's drift over the phase cancels
    overhead = statistics.median(
        live / null for live, null in zip(times["live"], times["null"])) - 1
    emit({"phase": "telemetry", "headline_null_s": times["null"],
          "headline_live_s": times["live"],
          "median_headline_null_s": med_null,
          "median_headline_live_s": med_live,
          "live_overhead_frac_of_medians": med_live / med_null - 1.0,
          "live_overhead_frac": overhead,
          "max_overhead_frac": TELEMETRY_MAX_OVERHEAD,
          "instrument_us": instrument_us(chk, encode_register_ops(history)),
          "counts": {f"{k[0]}{{{k[1] or ''}}}": v
                     for k, v in got_counts.items()},
          "device_memory_peak_bytes": mem, "total_memory": total_mem,
          "trace_events": by_name, "trace_bytes": trace_bytes,
          "flight_recorded": tracer.flight.recorded,
          "profile_bytes": prof_bytes, "profile_attempts": attempt + 1,
          "launches_live": live_launches,
          "seconds": time.perf_counter() - phase_t0, **common})
    emit({"phase": "telemetry_prom",
          "checker_families": [ln for ln in prom.splitlines()
                               if ln.split("{")[0].split(" ")[0]
                               .startswith("checker_")
                               or ln.startswith(("# HELP checker_",
                                                 "# TYPE checker_"))],
          **common})
    if overhead > TELEMETRY_MAX_OVERHEAD:
        raise AssertionError(f"telemetry: the live registry and tracer add "
                             f"{overhead:.2%} to a headline check, past "
                             f"{TELEMETRY_MAX_OVERHEAD:.0%}")
    return live_launches


def nvidia_smi(query: str) -> str:
    """The first card's ``nvidia-smi --query-gpu=<query>`` line."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def level_pass_words(pend, ids, mtT, slots, valid, S, V) -> float:
    """Shared-memory words the chunk-product kernel reads for these
    inputs: per valid return, (1 + sources) * W for each row its level
    passes rewrite (level popcount(a & pm) >= 1; sources = the set bits
    of mt_s[w] summed over the slots s in pm & a) and W for each of the
    MV / 2 kill pairs, with W = MV / 32 words a row."""
    import torch
    M, MV = 1 << S, (1 << S) * V
    W = max(1, MV // 32)
    dev = pend.device
    abits = ((torch.arange(M, device=dev)[:, None]
              >> torch.arange(S, device=dev)) & 1).float()      # [M, S]
    pf = (pend > 0).float()                                     # [T, G, S]
    cnt = (mtT > 0).sum(dim=2).float()[ids.long()]              # [T, G, S, V]
    level = torch.einsum("tgs,ms->tgm", pf, abits)
    sources = torch.einsum("tgs,ms,tgsv->tgmv", pf, abits, cnt)
    rows = ((1 + sources) * (level >= 1)[..., None]).sum(dim=(2, 3))
    return float(((rows + MV // 2) * W * (valid > 0)).sum().item())


def headline_inputs(stream):
    """The chunk-product and combine inputs the main path builds for
    ``stream`` (one key), on the card."""
    import numpy as np
    from jepsen_tpu_torch.models import cas_register_spec
    from jepsen_tpu_torch.ops import jitlin
    V = jitlin._bucket(len(stream.intern), floor=8)
    prep = jitlin._returns_prepass(stream.kind, stream.slot, stream.f,
                                   stream.a, stream.b)
    S, R = prep[3], prep[0].shape[0]
    C, T = jitlin._matrix_plan(1, S, R, V)
    (pend, ids, slots, valid), uops = jitlin._matrix_grids(
        [prep], S, V, 1, C, T, "cuda")
    math = jitlin._kernel_math(S, V, cas_register_spec().step_ids, C,
                               pend.device)
    mt, _ = math.uop_tables(uops)
    mtT = mt.transpose(1, 2).contiguous()
    return dict(S=S, V=V, C=C, T=T, MV=math.MV, n_sq=math.n_sq,
                args=(pend, ids, mtT, slots, valid),
                pend_np=np.asarray(prep[1]))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from jepsen_tpu_torch.checker.linear_cpu import check_stream
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.histories import corrupt_reads, register_history
    from jepsen_tpu_torch.ops import _build
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    from jepsen_tpu_torch.ops import jitlin
    from jepsen_tpu_torch.ops import matrix_kernels as mk
    from jepsen_tpu_torch.ops.jitlin import JitLinKernel, matrix_check

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    emit({"phase": "device", "name": name, "count":
          torch.cuda.device_count(), "nvidia_smi": smi,
          "max_sm_mhz": max_sm_mhz, "sms": n_sm,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    # the compiler's resource report, each kernel's registers and spills
    # after its name; a spill in a frontier scan fails the run
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Compiling entry" in ln]
             for k, v in _build.ptxas_report.items()}
    spills = {k: [ln for ln in lines
                  if any(int(x) for x in re.findall(r"(\d+) bytes spill", ln))]
              for k, lines in ptxas.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "spills": spills, "ptxas": ptxas})
    if spills.get("frontier_dense") or spills.get("frontier_sparse"):
        raise AssertionError(f"a frontier scan spills registers: {spills}")

    # 3-4. each kernel against its plain version
    check_chunk_product("mv64", 3, 8, 64, 64, 16, 1)
    check_chunk_product("mv256_headline_plan", 5, 8, 64, 256, 64, 2)
    check_chunk_product("mv512", 6, 8, 16, 64, 32, 3)
    check_chunk_product("mv512_s8", 8, 2, 16, 32, 16, 4)
    check_chunk_product("write_all_pending", 5, 8, 32, 64, 8, 5, "write")
    check_chunk_product("s1", 1, 8, 64, 32, 4, 6)
    check_chunk_product("v1_s8", 8, 1, 16, 16, 8, 7, "one_state")
    check_chunk_product("v32_s4", 4, 32, 8, 16, 16, 8)
    check_chunk_product("padding_chunk", 5, 8, 32, 16, 16, 9,
                        "padding_chunk")
    check_chunk_product("g1_t1", 5, 8, 1, 1, 8, 11)
    # V is a template parameter of the kernel: with the cases above, one
    # case for each V it takes (1, 2, 4, 8, 16, 32); V = 16 is the main
    # path's for 9-16 distinct values
    check_chunk_product("v16_s5", 5, 16, 16, 64, 32, 12)
    check_chunk_product("v4_s6", 6, 4, 32, 64, 16, 13)
    for case in COMBINE_CASES:
        check_combine(*case)
    # the frontier kernels: valid, corrupted and crashed histories, S from
    # 1 to 12 and V from 16 to 512 for the dense table (both paths), K =
    # 256, 16 and 4 for the sparse list (16 and 4 overflow; both paths),
    # from the initial frontier and from an unsorted one
    for case, make, table, Ks, start in frontier_cases():
        check_frontier(case, make(), table, Ks, start)
    # the forensics kernels: prefix_alive on seeded products with a dead
    # chunk early, late and none; window_rescan on seeded inputs of every
    # S and V the matrix regime takes, then on the corrupted headline's
    # first dead chunk (derived with the plain versions alone) for K = 1,
    # 4 and 128 candidates, the first keeping every op
    from jepsen_tpu_torch.ops.forensics_compare import (
        PREFIX_CASES, RESCAN_CASES, chunk_candidates, planted_chunk,
        random_rescan_inputs)
    for C_p, MV_p, kill, dense in PREFIX_CASES:
        check_prefix_alive(C_p, MV_p, kill, dense, MV_p + (kill or 0))
    for case in RESCAN_CASES:
        check_window_rescan(f"random_k{case[0]}_s{case[2]}_v{case[3]}",
                            random_rescan_inputs(*case))
    history = register_history(N_OPS, n_procs=N_PROCS, seed=SEED,
                               n_values=N_VALUES)
    stream = encode_register_ops(history)
    bad = corrupt_reads(history, n=2, seed=0)
    bad_stream = encode_register_ops(bad)
    twin_bad = check_stream(bad_stream)
    pc = planted_chunk(bad_stream)
    r_star = int(np.searchsorted(np.nonzero(bad_stream.kind == 1)[0],
                                 twin_bad.failed_event))
    if divmod(r_star, pc["T"])[0] != pc["c_star"]:
        raise AssertionError(f"the plain chain's first dead chunk "
                             f"{pc['c_star']} is not the twin's return "
                             f"{r_star} (T = {pc['T']})")
    t_star = r_star % pc["T"]
    for K in (1, 4, 128):
        row = check_window_rescan(f"headline_chunk_k{K}",
                                  chunk_candidates(pc, K, K))
        if row["first"][0] != t_star:
            raise AssertionError(f"the rescan's first dead return "
                                 f"{row['first'][0]} is not the twin's "
                                 f"{t_star}")

    # 5. the main path
    twin = check_stream(stream)
    if twin.valid is not True:
        raise AssertionError("the CPU twin rejects the headline history")
    chk = linearizable(accelerator="gpu")
    reset_launches()
    t0 = time.perf_counter()
    res = chk.check({}, history, {})
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    if res["valid?"] is not True or res["algorithm"] != "torch-matrix":
        raise AssertionError(f"headline check: {res}")
    if min(launches["chunk_product"], launches["combine_product"]) < 1:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = chk.check({}, history, {})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if out["valid?"] is not True:
            raise AssertionError(f"timed check: {out}")
    med = statistics.median(times)
    # where the check's time goes: the host encode, and the matrix
    # check (prepass, grids, copies in, both kernels, verdict read back)
    enc_s, mc_s = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        encode_register_ops(history)
        enc_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        matrix_check(stream)
        torch.cuda.synchronize()
        mc_s.append(time.perf_counter() - t0)
    # device time of one check, by kernel (the profiler's own cost is in
    # its wall time, so the busy share is taken against median_check_s)
    by_name = {}
    for kname, us in device_kernels(lambda: chk.check({}, history, {})):
        by_name[kname] = by_name.get(kname, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    emit({"phase": "main_path", "ops": N_OPS, "events": len(stream),
          "valid": res["valid?"], "algorithm": res["algorithm"],
          "launches": launches, "first_check_s": first_s,
          "check_s": times, "median_check_s": med,
          "ops_per_sec": N_OPS / med,
          "median_encode_s": statistics.median(enc_s),
          "median_matrix_check_s": statistics.median(mc_s),
          "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / 1e3 / med,
          "device_us_by_kernel": sorted(by_name.items(),
                                        key=lambda kv: -kv[1])[:8],
          "card": name, "power": smi})

    # 5b. the main path, invalid, with explain off: the corrupted
    # headline settles on the frontier rung's dense table (S = 5, V = 16),
    # the reference's demote path
    no_explain = {"explain": False}
    t0 = time.perf_counter()
    cpu_bad = linearizable(accelerator="cpu").check({}, bad, no_explain)
    cpu_bad_s = time.perf_counter() - t0
    reset_launches()
    got_bad = chk.check({}, bad, no_explain)
    torch.cuda.synchronize()
    launches_bad = read_launches()
    if got_bad["valid?"] is not False \
            or got_bad["algorithm"] != "torch-frontier" \
            or got_bad.get("failed-op") != cpu_bad.get("failed-op"):
        raise AssertionError(f"corrupted history: {got_bad} vs {cpu_bad}")
    if launches_bad["frontier_dense"] != 1 \
            or launches_bad["frontier_sparse"] != 0 \
            or min(launches_bad["chunk_product"],
                   launches_bad["combine_product"]) < 1:
        raise AssertionError(f"invalid path's launches: {launches_bad}")
    # where an invalid check's time goes: the encode, the matrix rung,
    # the frontier rung (upload, kernel, verdict read back), and the CPU
    # twin's re-run that recovers the dying configurations
    split = {"check": [], "encode": [], "matrix": [], "rung": [],
             "twin": []}
    kernel = JitLinKernel()
    for _ in range(5):
        for key, fn in (
                ("check", lambda: chk.check({}, bad, no_explain)),
                ("encode", lambda: encode_register_ops(bad)),
                ("matrix", lambda: matrix_check(bad_stream)),
                ("rung", lambda: kernel.check(bad_stream)),
                ("twin", lambda: check_stream(bad_stream))):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            split[key].append(time.perf_counter() - t0)
            if key == "rung":
                rung = out
    bad_busy_ms = sum(us for _, us in device_kernels(
        lambda: chk.check({}, bad, no_explain))) / 1e3
    bad_times, rung_times = split["check"], split["rung"]
    emit({"phase": "main_path_invalid", "ops": N_OPS,
          "events": len(bad_stream), "algorithm": got_bad["algorithm"],
          "failed_op": got_bad["failed-op"], "cpu_failed_op":
          cpu_bad["failed-op"], "configs_max": got_bad["configs-max"],
          "rung_result": list(rung), "launches": launches_bad,
          "check_s": bad_times, "median_check_s":
          statistics.median(bad_times), "rung_s": rung_times,
          "median_rung_s": statistics.median(rung_times),
          "median_split_s": {k: statistics.median(v)
                             for k, v in split.items()},
          "device_busy_ms": bad_busy_ms, "device_busy_share":
          bad_busy_ms / 1e3 / statistics.median(bad_times),
          "cpu_check_s": cpu_bad_s, "card": name, "power": smi})

    # 5b'. the main path, invalid, with explain on (the default): the
    # matrix rung localizes the first anomaly on the card (a second
    # chunk-product launch, the frontier chain, the guilty chunk's
    # rescan) and settles the check; the witness shrink's rounds are
    # rescans
    forensics = forensics_phase(chk, bad, bad_stream, twin_bad, cpu_bad,
                                got_bad, name, smi)

    # 5c. the sparse regime at full size: every write a fresh value
    fresh_runs = {}
    fresh = register_history(N_OPS, n_procs=N_PROCS, seed=SEED,
                             n_values=FRESH_VALUES)
    for copy, hh in (("valid", fresh),
                     ("corrupted", corrupt_reads(fresh, n=2, seed=0))):
        st = encode_register_ops(hh)
        t0 = time.perf_counter()
        cpu = linearizable(accelerator="cpu").check({}, hh, {})
        cpu_s = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        got = chk.check({}, hh, {})
        torch.cuda.synchronize()
        check_s = time.perf_counter() - t0
        lc = read_launches()
        rung = kernel.check(st)
        if got["algorithm"] != "torch-frontier" \
                or got["valid?"] != cpu["valid?"] \
                or got.get("failed-op") != cpu.get("failed-op") \
                or got["valid?"] is not (copy == "valid"):
            raise AssertionError(f"fresh-value {copy}: {got} vs {cpu}")
        if lc["frontier_sparse"] != 1 or lc["frontier_dense"] != 0 \
                or rung[2]:
            raise AssertionError(f"fresh-value {copy}: launches {lc}, "
                                 f"rung {rung} (overflow?)")
        fresh_runs[copy] = (st, lc)
        emit({"phase": "main_path_sparse", "copy": copy, "ops": N_OPS,
              "events": len(st), "states": len(st.intern),
              "slots": st.n_slots, "algorithm": got["algorithm"],
              "valid": got["valid?"], "failed_op": got.get("failed-op"),
              "configs_max": got["configs-max"], "rung_result":
              list(rung), "launches": lc, "check_s": check_s,
              "cpu_check_s": cpu_s, "card": name, "power": smi})

    # 5d. the matrix rung above MV = 512: S = 6, V = 16, MV = 1024
    h6 = register_history(3000, n_procs=6, seed=SEED, n_values=12)
    st6 = encode_register_ops(h6)
    V6 = jitlin._bucket(len(st6.intern), floor=8)
    if (st6.n_slots, V6) != (6, 16):
        raise AssertionError(f"MV = 1024 history: S={st6.n_slots}, V={V6}")
    reset_launches()
    got6 = chk.check({}, h6, {})
    torch.cuda.synchronize()
    lc6 = read_launches()
    if got6["algorithm"] != "torch-matrix" \
            or got6["valid?"] is not check_stream(st6).valid \
            or jitlin.last_dispatch_info()["products"] != "scan" \
            or any(lc6.values()):
        raise AssertionError(f"MV = 1024 check: {got6}, {lc6}")
    mc6 = []
    for _ in range(3):
        t0 = time.perf_counter()
        matrix_check(st6)
        torch.cuda.synchronize()
        mc6.append(time.perf_counter() - t0)
    # the scan route's device time, and its bound: the bf16 operations of
    # its batched products (per valid return n_sq squarings and the kill
    # product, then the C - 1 tree products and the product onto tot0),
    # or the bytes of the [C, MV, MV] bf16 chunk products written and
    # read once
    scan_k = device_kernels(lambda: matrix_check(st6))
    scan_device_ms = sum(us for _, us in scan_k) / 1e3
    prep6 = jitlin._returns_prepass(st6.kind, st6.slot, st6.f, st6.a,
                                    st6.b)
    C6, T6 = jitlin._matrix_plan(1, 6, prep6[0].shape[0], 16)
    n_products = (int((st6.kind == 1).sum()) * (jitlin._n_squarings(6) + 1)
                  + C6)
    scan_ops = n_products * 2.0 * 1024 ** 3
    scan_bytes = 2.0 * C6 * 1024 * 1024 * 2
    scan_bound_ms = max(scan_ops / PEAK_BF16_OPS, scan_bytes / PEAK_BYTES) \
        * 1e3
    # the last quiescent point at or before the stream's middle
    cut = jitlin.quiescent_cuts(st6.kind, len(st6) // 2)[0]
    if not 0 < cut < len(st6):
        raise AssertionError(f"MV = 1024 history: no quiescent cut ({cut})")
    kw = dict(num_states=len(st6.intern), n_slots=st6.n_slots)
    a1, _, t1 = jitlin.matrix_check_resume(jitlin._slice_stream(st6, 0, cut),
                                           **kw)
    a2, i2, t2 = jitlin.matrix_check_resume(
        jitlin._slice_stream(st6, cut, len(st6)), tot0=t1, **kw)
    a_one, i_one, t_one = jitlin.matrix_check_resume(st6, **kw)
    torch.cuda.synchronize()
    if not torch.equal(t2, t_one) or bool(a2[0]) is not bool(a_one[0]) \
            or bool(a_one[0]) is not True or bool(i2[0]):
        raise AssertionError("MV = 1024 resume differs from one-shot")
    emit({"phase": "matrix_mv1024", "S": 6, "V": 16, "MV": 1024,
          "events": len(st6), "returns": int((st6.kind == 1).sum()),
          "algorithm": got6["algorithm"], "valid": got6["valid?"],
          "dispatch": jitlin.last_dispatch_info(), "launches": lc6,
          "matrix_check_s": mc6, "median_matrix_check_s":
          statistics.median(mc6), "resume_cut": cut,
          "resume_equals_one_shot": True, "C": C6, "T": T6,
          "scan_device_ms": scan_device_ms, "scan_products": n_products,
          "scan_bf16_ops": scan_ops, "scan_bytes": scan_bytes,
          "scan_bound_ms": scan_bound_ms,
          "scan_bound_by": ("operations" if scan_ops / PEAK_BF16_OPS
                            >= scan_bytes / PEAK_BYTES else "bytes"),
          "card": name, "power": smi})

    # 6. each kernel at the main path's shapes
    hd = headline_inputs(stream)
    S, V, C, T, MV = hd["S"], hd["V"], hd["C"], hd["T"], hd["MV"]
    args = hd["args"]
    kern_P = mk.chunk_product(*args, S, V)
    plain_P = mk.chunk_product_torch(*args, S, V)
    err_p = (kern_P.float() - plain_P.float()).abs().max().item()
    entry = chunk_entry_call(_build.library("chunk_product")
                             .jt_chunk_product, args, S, V)
    if not torch.equal(entry(), plain_P):
        raise AssertionError("the chunk-product entry differs from plain")
    # ms: the wrapper with its operand prep and range check, as the main
    # path calls it and as the combine is timed; entry_ms: the kernel
    # alone (C entry on the wrapper's operands)
    ms_p = cuda_ms(lambda: mk.chunk_product(*args, S, V), 20)
    entry_ms_p = cuda_ms(entry, 50)
    plain_ms_p = cuda_ms(lambda: mk.chunk_product_torch(*args, S, V), 3)
    prod_k = device_kernels(entry)
    prod_us = sum(us for k, us in prod_k
                  if k.startswith("chunk_product_kernel"))
    if prod_us <= 0:
        raise AssertionError(f"the profiler saw no chunk product: {prod_k}")
    # the dense-product model (dense_bound_ms): each valid return runs
    # the squarings its pending count needs plus one compose product, at
    # the int8 tensor rate
    npend = hd["pend_np"].sum(axis=1)
    sq = sum((npend > (1 << q)).astype(int) for q in range(hd["n_sq"]))
    ops_p = float(((sq + 1) * 2.0 * MV ** 3).sum())
    bytes_p = (sum(a.numel() * a.element_size() for a in args)
               + C * MV * MV * 2)
    # this design's bound: the bytes, or the shared-memory words its level
    # and kill passes read at 32 words a clock per SM
    words_p = level_pass_words(*args, S, V)
    t_bytes_p = bytes_p / PEAK_BYTES
    t_words_p = words_p / (n_sm * 32 * max_sm_mhz * 1e6)
    P4 = kern_P.reshape(1, C, MV, MV)
    tot0 = torch.eye(MV, dtype=torch.bfloat16, device="cuda")[None]
    kern_t = mk.combine_product(P4, tot0)
    plain_t = mk.combine_product_torch(P4, tot0)
    err_c = (kern_t.float() - plain_t.float()).abs().max().item()
    ms_c = cuda_ms(lambda: mk.combine_product(P4, tot0), 20)
    plain_ms_c = cuda_ms(lambda: mk.combine_product_torch(P4, tot0), 3)
    ops_c = C * 2.0 * MV ** 3
    bytes_c = (C + 2) * MV * MV * 2

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    kernels = []
    for kname, src, rep, err, ms, pms, (b_ms, b_by) in (
            ("chunk_product", "jepsen_tpu_torch/ops/csrc/chunk_product.cu",
             "jepsen_tpu/ops/pallas_matrix.py:464", err_p, ms_p,
             plain_ms_p,
             (max(t_bytes_p, t_words_p) * 1e3,
              "bytes" if t_bytes_p >= t_words_p else "operations")),
            ("combine_product",
             "jepsen_tpu_torch/ops/csrc/chunk_combine.cu",
             "jepsen_tpu/ops/pallas_matrix.py:824", err_c, ms_c,
             plain_ms_c, bound(ops_c, bytes_c))):
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[kname],
                        "max_abs_err": err, "equal": err == 0.0,
                        "ms": ms, "plain_ms": pms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None})
        if err != 0.0:
            raise AssertionError(f"{kname} differs at the headline shape")
    # the chunk product's operations term counts shared-memory word reads
    # (at 32 words a clock per SM), not int8 tensor operations
    kernels[0].update(entry_ms=entry_ms_p, device_ms=prod_us / 1e3,
                      dense_bound_ms=bound(ops_p, bytes_p)[0],
                      bound_operations="shared_words",
                      shared_words=words_p,
                      shared_words_ms=t_words_p * 1e3)
    kernels[1].update(bound_operations="int8_ops")
    # the combine's CUDA launches and device time, from the profiler, and
    # the density of P, which its time depends on (products run over set
    # bits)
    comb_k = device_kernels(lambda: mk.combine_product(P4, tot0))
    if not comb_k:
        raise AssertionError("the profiler saw no combine kernel")
    kernels[1].update(cuda_launches_per_call=len(comb_k),
                      device_ms=sum(us for _, us in comb_k) / 1e3,
                      p_ones_frac=kern_P.float().mean().item())
    # 7. the frontier kernels at the main paths' shapes: the dense table on
    # the corrupted headline, the sparse list on the fresh-value history
    ev_bad = card_events(bad_stream)
    Sb = max(1, bad_stream.n_slots)
    Vb = jitlin._bucket(len(bad_stream.intern), floor=16)
    tb = fk.init_table(Sb, Vb, 0, "cuda")
    kern_d = fk.frontier_dense(*ev_bad, tb)
    warp_d, returns_d = fk.frontier_dense.paths.tolist()
    work_d = {}
    t0 = time.perf_counter()
    plain_d = fk.frontier_dense_torch(*ev_bad, tb, work=work_d)
    torch.cuda.synchronize()
    plain_ms_d = (time.perf_counter() - t0) * 1e3
    err_d = frontier_err(kern_d, plain_d)
    if [warp_d, returns_d] != [work_d["warp_returns"], work_d["returns"]]:
        raise AssertionError(f"frontier_dense ran {warp_d} of {returns_d} "
                             f"returns on its warp path, the plain version "
                             f"counts {work_d}")
    ms_d = cuda_ms(lambda: fk.frontier_dense(*ev_bad, tb), 20)
    died_d = int(kern_d[1])
    ev_ok = card_events(stream)
    t_ok = fk.init_table(max(1, stream.n_slots), Vb, 0, "cuda")
    ms_d_full = cuda_ms(lambda: fk.frontier_dense(*ev_ok, t_ok), 5)
    returns_full = fk.frontier_dense.paths.tolist()[1]
    dense_k = device_kernels(lambda: fk.frontier_dense(*ev_bad, tb),
                             "frontier_dense_kernel")
    ops_d = dense_scan_ops(bad_stream, died_d, Vb)
    bytes_d = 5 * 4 * len(bad_stream) + 2 * tb.numel() + 16
    st_f = fresh_runs["valid"][0]
    ev_f = card_events(st_f)
    Sf = max(1, st_f.n_slots)
    m0, s0 = fk.init_frontier(256, 0, "cuda")
    kern_s = fk.frontier_sparse(*ev_f, m0, s0, Sf)
    warp_s, passes_s = fk.frontier_sparse.paths.tolist()
    work = {}
    t0 = time.perf_counter()
    plain_s = fk.frontier_sparse_torch(*ev_f, m0, s0, Sf, work=work)
    torch.cuda.synchronize()
    plain_ms_s = (time.perf_counter() - t0) * 1e3
    err_s = frontier_err(kern_s, plain_s)
    if [warp_s, passes_s] != [work["warp_passes"], work["passes"]]:
        raise AssertionError(f"frontier_sparse ran {warp_s} of {passes_s} "
                             f"passes on its warp path, the plain version "
                             f"counts {work}")
    ms_s = cuda_ms(lambda: fk.frontier_sparse(*ev_f, m0, s0, Sf), 5)
    sparse_k = device_kernels(lambda: fk.frontier_sparse(*ev_f, m0, s0, Sf),
                              "frontier_sparse_kernel")
    ops_s = float(work["compares"] + work["candidates"])
    bytes_s = 5 * 4 * len(st_f) + 2 * 256 * 8 + 16

    def named_ms(kern, name):
        """The device ms of the profiled kernels called ``name`` (None
        when the trace lacks them: not measured)."""
        us = [u for n, u in kern if n.startswith(name)]
        return sum(us) / 1e3 if us else None

    def scan_bound(ops, nbytes):
        t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    for kname, src, rep, err, ms, pms, bnd, lc, extra in (
            ("frontier_dense", "jepsen_tpu_torch/ops/csrc/frontier_dense.cu",
             "jepsen_tpu/ops/jitlin.py:249", err_d, ms_d, plain_ms_d,
             scan_bound(ops_d, bytes_d), launches_bad["frontier_dense"],
             {"S": Sb, "V": Vb, "events": len(bad_stream), "died": died_d,
              "returns": returns_d, "warp_returns": warp_d,
              "us_per_return": ms_d * 1e3 / returns_d,
              "warp_return_share": warp_d / returns_d,
              "ms_valid_full_scan": ms_d_full,
              "us_per_return_valid_full_scan":
                  ms_d_full * 1e3 / returns_full,
              "device_ms": named_ms(dense_k, "frontier_dense_kernel"),
              "device_kernels_us": dense_k,
              "word_ops": ops_d, "bytes": bytes_d}),
            ("frontier_sparse",
             "jepsen_tpu_torch/ops/csrc/frontier_sparse.cu",
             "jepsen_tpu/ops/jitlin.py:116", err_s, ms_s, plain_ms_s,
             scan_bound(ops_s, bytes_s),
             fresh_runs["valid"][1]["frontier_sparse"],
             {"S": Sf, "K": 256, "events": len(st_f), "work": work,
              "passes": passes_s, "warp_passes": warp_s,
              "us_per_pass": ms_s * 1e3 / passes_s,
              "warp_pass_share": warp_s / passes_s,
              "device_ms": named_ms(sparse_k, "frontier_sparse_kernel"),
              "device_kernels_us": sparse_k,
              "bytes": bytes_s})):
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": rep, "launches": lc,
                        "max_abs_err": err, "equal": err == 0.0,
                        "ms": ms, "plain_ms": pms, "bound_ms": bnd[0],
                        "bound_by": bnd[1], "library_ms": None,
                        "bound_operations": "int32_word_ops", **extra})
        if err != 0.0:
            raise AssertionError(f"{kname} differs at the main path's shape")
    # 7b. the forensics kernels at the main path's shapes: prefix_alive
    # on the corrupted headline's chunk products, window_rescan on its
    # first dead chunk for the first shrink round's K = 4 candidates
    kernels += forensics_rows(pc, forensics, scan_bound, named_ms)
    # 8. the Elle slice: list-append and rw-register checks through the
    # cluster screen and the trim
    kernels += elle_phases(name, smi)
    # 9. the independent slice: BASELINE config 3 through the key-batched
    # matrix screen and frontier launches, and the native lane
    ind_rows, ind_launches = independent_phases(name, smi)
    for row in kernels:
        row["launches_independent"] = ind_launches.get(row["name"], 0)
    kernels += ind_rows
    # 10. the set-full slice: BASELINE config 4 through the set-classify
    # kernel
    set_row = set_full_phases(name, smi)
    set_row["launches_independent"] = ind_launches.get("set_classify", 0)
    kernels.append(set_row)
    # 11. the multi-register slice: multi-key-acid through both frontier
    # kernels with the multi-register transition; each frontier row gains
    # its multi-register entry
    mr = multi_register_phases(name, smi)
    for row in kernels:
        if row["name"] in mr:
            row["multi_register"] = mr[row["name"]]
    # 12. resumable long checks: the 1,133,736-event history through the
    # segmented matrix chain, its invalid copies, the checkpoint resume,
    # the frontier chain and the carry's hand-off to the CPU twin
    sg = segmented_phases(name, smi)
    for row in kernels:
        row.update(sg.get(row["name"], {}))
    # 13. stored-run re-checks: each history through the port's store and
    # check_stored against its live check; each row gains the launches of
    # the stored re-checks
    stored = stored_phases(name, smi)
    for row in kernels:
        row["launches_stored"] = stored.get(row["name"], 0)
    # 17. telemetry, run here to take the long history phase 13 hands on:
    # a live registry and run tracer on the headline, its corrupted copy,
    # the long history's checkpointed chain and resume and config 3's
    # batch, each against the null registry; each row gains the live
    # checks' launches
    tel = telemetry_phase(name, smi, history, bad)
    # 14-15. checking across devices: four shards on the card, then two
    # processes; each row gains the launches of the mesh cases
    trim_rows, meshed = mesh_phases(name, smi, history, bad, stream,
                                    bad_stream)
    for row in kernels:
        row["launches_mesh"] = meshed.get(row["name"], 0)
    for row in trim_rows:
        row.update(launches_independent=0, launches_stored=0,
                   launches_mesh=meshed.get(row["name"], 0))
    for row in kernels:
        row["launches_telemetry"] = tel.get(row["name"], 0)
    kernels += trim_rows
    # 16. the run's shared history IR and live checking: two checks on
    # one test map, the IR's columns on the card, config 3's split, the
    # live register, multi-key and Elle sessions tailing WALs; each row
    # gains the live sessions' launches
    live = live_phases(name, smi, history, bad, twin_bad)
    for row in kernels:
        row["launches_live"] = live.get(row["name"], 0)
    # 18. the live daemon over the native ingest spine: three runs' WALs
    # tailed, checked and settled; each row gains the daemon's launches
    tailed = daemon_phase(name, smi, history, bad, twin_bad)
    for row in kernels:
        row["launches_daemon"] = tailed.get(row["name"], 0)
    # 19. a suite's composed check: config 3's corrupted copy and the
    # corrupted headline through the host checkers and reports around the
    # register check on the card, each against its cpu run; each row gains
    # the two composed checks' launches
    composed = suite_phase(name, smi, history, bad)
    for row in kernels:
        row["launches_suite"] = composed.get(row["name"], 0)
    # 20. the run loop: two whole fake-register test runs through core.run,
    # each re-checked on the cpu; each row gains the two runs' launches
    ran = run_phase(name, smi)
    # 21. the workloads: single- and multi-key-acid, set-full, append and
    # wr through core.run, each valid and broken, each re-checked on the
    # cpu; each row gains their launches, in launches_run beside phase 20's
    kits = workloads_phase(name, smi)
    for row in kernels:
        row["launches_workloads"] = kits.get(row["name"], 0)
        row["launches_run"] = ran.get(row["name"], 0) + row[
            "launches_workloads"]
    emit({"phase": "headline_shapes", "S": S, "V": V, "MV": MV, "C": C,
          "T": T, "valid_returns": int(len(npend)),
          "chunk_product_ops": ops_p, "chunk_product_bytes": bytes_p,
          "chunk_product_shared_words": words_p,
          "chunk_product_bytes_ms": t_bytes_p * 1e3,
          "chunk_product_words_ms": t_words_p * 1e3,
          "chunk_product_device_us": prod_us,
          "chunk_product_kernels_us": prod_k,
          "combine_ops": ops_c, "combine_bytes": bytes_c,
          "combine_kernels_us": comb_k})
    emit({"kernels": kernels})
    emit({"phase": "total", "seconds": time.perf_counter() - T_START})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--distributed-worker"]:
        sys.exit(distributed_worker(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
