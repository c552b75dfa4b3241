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
* its corrupted copy: the matrix rung leaves it to the ``torch-frontier``
  rung, which settles it on the dense-table kernel with the CPU twin's
  failing op;
* a 10k-op, 5-process history whose every write is a fresh value (more
  than 512 states, so the dense table is out of regime), valid and
  corrupted: the frontier rung on the sparse-frontier kernel;
* a history with S = 6 slots and V = 16 states (MV = 1024): the matrix
  rung's batched-product route above the kernels' MV = 512, one-shot and
  resumed over two quiescent segments.

Prints one JSON line per phase, then a ``kernels`` line, the card's name
and power limit, and as its last line ``{"ok": true, "device": {...}}``.
Any failure raises, so the exit code is not 0. Without a CUDA device it
exits 1 and prints no result.
"""
from __future__ import annotations

import json
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


# frontier cases: (name, history maker, table S or None, sparse Ks)
def frontier_cases():
    from jepsen_tpu_torch.histories import corrupt_reads, register_history
    return [
        ("valid_s5", lambda: register_history(1000, 5, 101, 5), None,
         (256, 16, 4)),
        ("corrupted_s5", lambda: corrupt_reads(
            register_history(1000, 5, 102, 5), n=2, seed=1), None,
         (256, 16, 4)),
        ("crashed", lambda: crashed(register_history(1000, 5, 103, 4), 150),
         None, (256, 16, 4)),
        ("fresh_values", lambda: register_history(1000, 5, 107,
                                                  FRESH_VALUES), None,
         (256, 16, 4)),
        ("s1", lambda: register_history(600, 1, 104, 6), None, ()),
        ("s12", lambda: register_history(800, 12, 105, 4), 12, ()),
        ("v256_s3", lambda: register_history(1000, 3, 106, 300), None, ()),
    ]


def check_frontier(name, history, S_table, Ks):
    """The dense kernel (when the stream is in its regime) and the sparse
    kernel at each K, each against its plain version on the card, bit for
    bit."""
    import torch
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    from jepsen_tpu_torch.ops.jitlin import _bucket, _dense_ok
    stream = encode_register_ops(history)
    ev = card_events(stream)
    S = max(1, stream.n_slots)
    runs = []
    if S_table is not None or _dense_ok(S, len(stream.intern)):
        St = S_table or S
        V = _bucket(len(stream.intern), floor=16)
        t0 = fk.init_table(St, V, 0, "cuda")
        runs.append(("frontier_dense", {"S": St, "V": V},
                     lambda: fk.frontier_dense(*ev, t0),
                     lambda: fk.frontier_dense_torch(*ev, t0)))
    for K in Ks:
        m0, s0 = fk.init_frontier(K, 0, "cuda")
        runs.append(("frontier_sparse", {"S": S, "K": K},
                     lambda m0=m0, s0=s0: fk.frontier_sparse(*ev, m0, s0, S),
                     lambda m0=m0, s0=s0: fk.frontier_sparse_torch(
                         *ev, m0, s0, S)))
    for phase, shape, kern, plain in runs:
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err = frontier_err(got, ref)
        emit({"phase": phase, "case": name, **shape, "events": len(stream),
              "result": [int(x) for x in got[:4]], "equal": err == 0.0})
        if err != 0.0:
            raise AssertionError(f"{phase} {name} {shape} differs from plain")


def dense_scan_ops(stream, died: int, V: int) -> float:
    """32-bit word operations the dense kernel needs for ``stream`` up to
    the return ``died`` (-1: all): per return, the level-order closure ORs
    each row's W = ceil(V / 32) words once for each pending slot in its
    mask (npend * 2^(S-1) row-slot pairs over the 2^S rows) and the kill
    moves 2^(S-1) blocks; the out-of-range check steps every invoke over
    the V states."""
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
                 + (kind == 0).sum() * V)


def quiescent_cut(stream) -> int:
    """The quiescent point (no op pending) nearest the stream's middle."""
    import numpy as np
    kind = np.asarray(stream.kind)
    pending = np.cumsum(np.where(kind == 0, 1, np.where(kind == 1, -1, 0)))
    quiet = np.nonzero(pending == 0)[0] + 1
    quiet = quiet[quiet < len(kind)]
    return int(quiet[np.argmin(np.abs(quiet - len(kind) // 2))])


def slice_stream(stream, lo: int, hi: int):
    from jepsen_tpu_torch.checker.linear_encode import EventStream
    return EventStream(kind=stream.kind[lo:hi], slot=stream.slot[lo:hi],
                       f=stream.f[lo:hi], a=stream.a[lo:hi],
                       b=stream.b[lo:hi], op_index=stream.op_index[lo:hi],
                       n_slots=stream.n_slots, n_ops=stream.n_ops,
                       intern=stream.intern)


def reset_launches():
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    from jepsen_tpu_torch.ops import matrix_kernels as mk
    for fn in (mk.chunk_product, mk.combine_product, fk.frontier_dense,
               fk.frontier_sparse):
        fn.launches = 0


def read_launches() -> dict:
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    from jepsen_tpu_torch.ops import matrix_kernels as mk
    return {"chunk_product": mk.chunk_product.launches,
            "combine_product": mk.combine_product.launches,
            "frontier_dense": fk.frontier_dense.launches,
            "frontier_sparse": fk.frontier_sparse.launches}


def device_kernels(fn):
    """[(kernel name, device us)] of the CUDA kernels that one call of
    ``fn()`` runs, in launch order, from ``torch.profiler`` (after one
    warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
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
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, v in _build.ptxas_report.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})

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
    # 1 to 12 and V from 16 to 512 (fresh_values) for the dense table,
    # K = 256, 16 and 4 for the sparse list (16 and 4 overflow)
    for case, make, S_table, Ks in frontier_cases():
        check_frontier(case, make(), S_table, Ks)

    # 5. the main path
    history = register_history(N_OPS, n_procs=N_PROCS, seed=SEED,
                               n_values=N_VALUES)
    stream = encode_register_ops(history)
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

    # 5b. the main path, invalid: the corrupted headline settles on the
    # frontier rung's dense table (S = 5, V = 16)
    bad = corrupt_reads(history, n=2, seed=0)
    bad_stream = encode_register_ops(bad)
    t0 = time.perf_counter()
    cpu_bad = linearizable(accelerator="cpu").check({}, bad, {})
    cpu_bad_s = time.perf_counter() - t0
    reset_launches()
    got_bad = chk.check({}, bad, {})
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
                ("check", lambda: chk.check({}, bad, {})),
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
    bad_busy_ms = sum(
        us for _, us in device_kernels(lambda: chk.check({}, bad, {}))) / 1e3
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
    cut = quiescent_cut(st6)
    kw = dict(num_states=len(st6.intern), n_slots=st6.n_slots)
    a1, _, t1 = jitlin.matrix_check_resume(slice_stream(st6, 0, cut), **kw)
    a2, i2, t2 = jitlin.matrix_check_resume(
        slice_stream(st6, cut, len(st6)), tot0=t1, **kw)
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
          "resume_equals_one_shot": True, "card": name, "power": smi})

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
    t0 = time.perf_counter()
    plain_d = fk.frontier_dense_torch(*ev_bad, tb)
    torch.cuda.synchronize()
    plain_ms_d = (time.perf_counter() - t0) * 1e3
    err_d = frontier_err(kern_d, plain_d)
    ms_d = cuda_ms(lambda: fk.frontier_dense(*ev_bad, tb), 20)
    died_d = int(kern_d[1])
    ev_ok = card_events(stream)
    t_ok = fk.init_table(max(1, stream.n_slots), Vb, 0, "cuda")
    ms_d_full = cuda_ms(lambda: fk.frontier_dense(*ev_ok, t_ok), 5)
    dense_k = device_kernels(lambda: fk.frontier_dense(*ev_bad, tb))
    ops_d = dense_scan_ops(bad_stream, died_d, Vb)
    bytes_d = 5 * 4 * len(bad_stream) + 2 * tb.numel() + 16
    st_f = fresh_runs["valid"][0]
    ev_f = card_events(st_f)
    Sf = max(1, st_f.n_slots)
    m0, s0 = fk.init_frontier(256, 0, "cuda")
    kern_s = fk.frontier_sparse(*ev_f, m0, s0, Sf)
    work = {}
    t0 = time.perf_counter()
    plain_s = fk.frontier_sparse_torch(*ev_f, m0, s0, Sf, work=work)
    torch.cuda.synchronize()
    plain_ms_s = (time.perf_counter() - t0) * 1e3
    err_s = frontier_err(kern_s, plain_s)
    ms_s = cuda_ms(lambda: fk.frontier_sparse(*ev_f, m0, s0, Sf), 5)
    sparse_k = device_kernels(lambda: fk.frontier_sparse(*ev_f, m0, s0, Sf))
    ops_s = float(work["compares"] + work["candidates"])
    bytes_s = 5 * 4 * len(st_f) + 2 * 256 * 8 + 16

    def scan_bound(ops, nbytes):
        t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    for kname, src, rep, err, ms, pms, bnd, lc, extra in (
            ("frontier_dense", "jepsen_tpu_torch/ops/csrc/frontier_dense.cu",
             "jepsen_tpu/ops/jitlin.py:249", err_d, ms_d, plain_ms_d,
             scan_bound(ops_d, bytes_d), launches_bad["frontier_dense"],
             {"S": Sb, "V": Vb, "events": len(bad_stream), "died": died_d,
              "ms_valid_full_scan": ms_d_full,
              "device_ms": sum(us for _, us in dense_k) / 1e3,
              "word_ops": ops_d, "bytes": bytes_d}),
            ("frontier_sparse",
             "jepsen_tpu_torch/ops/csrc/frontier_sparse.cu",
             "jepsen_tpu/ops/jitlin.py:116", err_s, ms_s, plain_ms_s,
             scan_bound(ops_s, bytes_s),
             fresh_runs["valid"][1]["frontier_sparse"],
             {"S": Sf, "K": 256, "events": len(st_f), "work": work,
              "device_ms": sum(us for _, us in sparse_k) / 1e3,
              "bytes": bytes_s})):
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": rep, "launches": lc,
                        "max_abs_err": err, "equal": err == 0.0,
                        "ms": ms, "plain_ms": pms, "bound_ms": bnd[0],
                        "bound_by": bnd[1], "library_ms": None,
                        "bound_operations": "int32_word_ops", **extra})
        if err != 0.0:
            raise AssertionError(f"{kname} differs at the main path's shape")
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
