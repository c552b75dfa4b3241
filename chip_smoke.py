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
  launch), 1,024 keys, and the native lane against the Python twin;
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
  linearizable(model=MultiRegister(), accelerator="gpu")}))`` on 1,000
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
  entry (ms, launches on the 1,000-key check, bound);
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

Earlier phases keep their shapes.

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
               setscan.set_classify, fx.prefix_alive, fx.window_rescan):
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
            "window_rescan": fx.window_rescan.launches}


def device_kernels(fn, want: str = ""):
    """[(kernel name, device us)] of the CUDA kernels that one call of
    ``fn()`` runs, in launch order, from ``torch.profiler`` (after one
    warm-up call); with ``want``, a trace that holds a kernel whose name
    contains it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # the profiler now and then returns a trace without the device's
    # events, or without some of them: take the call again, up to three
    # times
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        if evs and any(want in e.name for e in evs):
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
    for case, (n, src, dst) in (
            ("valid_50k_dep", dep_edges(h_valid)),
            ("pairs_50k_dep", dep_edges(h_pairs)),
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
    list), 1,024 keys (eight matrix sub-batches of 128), and the native
    lane against the Python twin. Returns the two batched entries'
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
    hk = independent_register_history(IND_BIG, IND_OPS)
    t0 = time.perf_counter()
    _, streams_k = streams_of(hk)
    prep_s = time.perf_counter() - t0
    reset_launches()
    gpu_s, gpu = timed(lambda: batch_check(streams_k), 3)
    lk = read_launches()
    sub_k = jitlin.last_phase_seconds()
    cpu_s, cpu = timed(lambda: batch_check(streams_k, accelerator="cpu"), 2)
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
          "ops": IND_BIG * IND_OPS, "split_and_encode_s": prep_s,
          "gpu_batch_check_s": gpu_s,
          "median_gpu_batch_check_s": statistics.median(gpu_s),
          "gpu_ops_per_sec": IND_BIG * IND_OPS / statistics.median(gpu_s),
          "native_lane_s": cpu_s,
          "native_lane_ops_per_sec": IND_BIG * IND_OPS / min(cpu_s),
          "matrix_sub_batch_phases_s": sub_k,
          "launches_per_batch_check": {k: v / 3 for k, v in lk.items()},
          "full_check_s": full_s,
          "full_check_ops_per_sec": IND_BIG * IND_OPS / full_s,
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
# :59): 1,000 keys of 20 txns, each key on its own 10 processes (2n, n = 5
# nodes; 5 read, 5 write), K = 3 keys x V = 5 values (216 states); the
# invalid copy gives 10 keys an impossible read. One 10k-txn history on 5
# processes at the same width (the dense table's CTA path), its copy with
# two impossible reads, and a copy whose last writes crash until S = 10
# (the sparse list). The kernels alone on 1k-txn histories: the plain
# versions loop over events in Python.
ACID_GROUPS, ACID_PER_GROUP, ACID_PROCS = 1000, 20, 10
ACID_BAD = tuple(range(7, 1000, 100))
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

    def split(h, check_med, reps):
        """Median host seconds of the check's parts, one after another:
        the split by key, the encode, every key's frontier rung, and the
        twin for the keys the rung leaves unknown or invalid (their
        verdict, or the invalid ones' final configurations)."""
        parts = {k: [] for k in ("split", "encode", "rung", "twin")}
        for _ in range(reps):
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
            for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                parts[k].append(dt)
        med = {k: statistics.median(v) for k, v in parts.items()}
        med["threads_and_rest"] = check_med - sum(med.values())
        return med

    # 11a. the main path: 1,000 multi-key-acid keys, valid
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
    check_s, _ = timed(lambda: chk.check({}, h, {}), 3)
    med = statistics.median(check_s)
    med_split = split(h, med, reps=1)
    busy = device_kernels(lambda: chk.check({}, h, {}), "frontier")
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
          "median_split_s": med_split, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / 1e3 / med,
          "device_us_by_kernel": sorted(by_kernel.items(),
                                        key=lambda kv: -kv[1])[:6],
          "cpu_oracle_check_s": oracle_s, "card": name, "power": smi})

    # 11b. 10 keys with an impossible read
    hb = corrupt_txn_keys(h, ACID_BAD, n=1)
    want_b = oracle.check({}, hb, {})
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
          "median_split_s": split(hb, check_b, reps=1),
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
            "main_path": "multi_key_acid (1,000 keys, one launch a key)",
            "long_history_events": len(st_main)},
        "frontier_sparse": {
            **rows["sparse"], "launches": launches["frontier_sparse"],
            "s5": rows["sparse_s5"],
            "main_path": "multi_key_acid (1,000 keys, one launch a key)"},
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
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
