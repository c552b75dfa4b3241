"""Times this checkout's forensics kernels against another checkout's, on
one CUDA card.

    python3 -m jepsen_tpu_torch.ops.forensics_compare OTHER_ROOT

OTHER_ROOT is the root of another checkout of the repo (for example an
earlier commit unpacked by ``git archive`` into a directory that
``.gitignore`` lists). ``prefix_alive.cu`` and ``window_rescan.cu`` are
built from both checkouts with ``_build.NVCC_FLAGS`` (four ``nvcc``,
started together, into ``jepsen_tpu_torch/_build/compare``), and each C
entry is called directly:

* ``prefix_alive`` at every :data:`PREFIX_CASES` case (seeded products
  with a dead chunk early, late and none, and a dense frontier that dies
  late) and at the corrupted headline's chain (:func:`planted_chunk`);
* ``window_rescan`` at every :data:`RESCAN_CASES` case and on the
  corrupted headline's first dead chunk with K = 1, 4 and 128
  candidates (:func:`chunk_candidates`).

A build whose ``jt_window_rescan`` takes the derived masks (``pm``,
``rs``: the design before the kernel took the raw grids) is called
through that signature on the operands its wrapper derived
(:func:`earlier_rescan_operands`). For each case both builds' outputs
must equal each other and the plain version's bit for bit; then each C
entry is timed by CUDA events over back-to-back calls in the order
other, this, this, other (``*_entry_ms``), and by the profiler's device
time (``*_device_ms``); each rescan case also times each build behind
its own wrapper's steps (``*_wrapper_ms``: the earlier design's range
check with its read-back and its operand derivation; this design's
``RescanChunk`` and masks). One ``ptxas`` line a build gives the
compiler's resource report; the last line is the card's name and power
limit as ``nvidia-smi`` prints them. Exits 1 without a CUDA device.

The cases and the input makers are ``chip_smoke.py``'s too.
"""
from __future__ import annotations

import ctypes
import json
import re
import sys
from pathlib import Path

from jepsen_tpu_torch.ops.compare_common import (
    build, card_line, device_ms, in_turns)

NAMES = ("prefix_alive", "window_rescan")
PEAK_BYTES = 3.35e12
# the corrupted headline of chip_smoke.py: 10k ops, 5 processes, 5
# values, seed 42, two reads corrupted (S = 5, V = 8, MV = 256)
HEADLINE = dict(n_ops=10_000, n_procs=5, n_values=5, seed=42)
# prefix_alive: (C, MV, kill_at or None, dense frontier). Seeded products
# at the headline's MV = 256 and at MV = 512 with C = 256 chunks, at the
# scan route's MV = 1024 (C = 256) and MV = 4096 (C = 16: its plan's
# element budget), each with a dead chunk early (3), late (C - 3) and
# none; and with a dense frontier (every product half ones) that dies
# late, at MV = 512, 1024 and 4096: one case for each of the chain's
# designs (the shared-memory ring, one CTA or a cluster)
PREFIX_CASES = tuple(
    [(C, MV, kill, False) for C, MV in ((256, 256), (256, 512), (256, 1024),
                                         (16, 4096))
     for kill in (None, 3, C - 3)]
    + [(256, 512, 253, True), (256, 1024, 253, True), (16, 4096, 13, True)])
# window_rescan: (K, T, S, V, U, seed), seeded inputs of every S and V
# the matrix regime takes; S <= 5 takes the warp path, S = 6-8 the
# shared-memory path; T = 100 runs past one staged tile of returns
RESCAN_CASES = ((4, 24, 3, 5, 16, 2), (5, 12, 5, 16, 16, 3),
                (3, 8, 8, 2, 4, 4), (4, 8, 8, 16, 32, 8),
                (128, 64, 5, 8, 64, 7), (8, 16, 1, 8, 8, 9),
                (64, 32, 4, 16, 32, 10), (16, 24, 6, 16, 32, 11),
                (8, 16, 7, 8, 16, 12), (8, 16, 8, 16, 64, 13),
                (4, 100, 5, 8, 32, 14))
_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entry before the kernel took the raw grids: pm, rs, ids, nxt,
# oob, v, first, inexact, K, T, S, V, stream
DERIVED_MASKS = ("jt_window_rescan", [_P] * 8 + [_I] * 4 + [_P])


def takes_grids(root) -> bool:
    """Whether the checkout's ``jt_window_rescan`` takes the raw grids
    (``pend``, ``valid``) rather than the derived masks."""
    src = (Path(root) / "jepsen_tpu_torch" / "ops" / "csrc" /
           "window_rescan.cu").read_text()
    m = re.search(r'jt_window_rescan\(([^)]*)\)', src)
    return bool(m and "pend" in m.group(1))


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def card_products(C, MV, seed, kill_at, dense=False):
    """Seeded 0/1 chunk products on the card (bf16): every third chunk
    the identity, the rest sparse (about two entries a row) keeping most
    of the diagonal; ``dense``: every chunk half ones. Chunk ``kill_at``
    is all zero."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    eye = torch.eye(MV, dtype=torch.bool, device="cuda")
    P = torch.empty((C, MV, MV), dtype=torch.bfloat16, device="cuda")
    for c in range(C):
        if dense:
            P[c] = torch.rand((MV, MV), generator=g, device="cuda") < 0.5
            continue
        if c % 3 == 0:
            P[c] = eye
            continue
        m = torch.rand((MV, MV), generator=g, device="cuda") < 2.0 / MV
        keep = torch.rand((MV,), generator=g, device="cuda") < 0.8
        P[c] = m | (eye & keep[:, None])
    if kill_at is not None:
        P[kill_at] = 0
    return P


def first_dead(alive) -> int:
    """The first False of a bool tensor, -1 when there is none."""
    a = alive.cpu().numpy()
    return -1 if a.all() else int((~a).argmax())


def random_rescan_inputs(K, T, S, V, U, seed):
    """Seeded window_rescan inputs on the card: sparse transitions (a
    tenth of the ops oob), pending sets with the returning slot pending,
    a fifth of the returns invalid, a start of a few configurations."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    MV = (1 << S) * V
    pend = rng.random((K, T, S)) < 0.6
    slots = rng.integers(0, S, T).astype(np.int32)
    pend[:, np.arange(T), slots] = True
    v = np.zeros(MV, bool)
    v[rng.choice(MV, size=max(1, MV // 16), replace=False)] = True
    v[rng.integers(V)] = True
    return [torch.from_numpy(a).cuda() for a in (
        pend, rng.random((K, T)) < 0.8,
        rng.integers(0, U, (T, S)).astype(np.int32),
        (rng.random((U, V, V)) < 1.5 / V).astype(np.float32),
        rng.random(U) < 0.1, slots, v)]


def headline_stream():
    """The corrupted headline's encoded stream."""
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    from jepsen_tpu_torch.histories import corrupt_reads, register_history
    h = register_history(HEADLINE["n_ops"], n_procs=HEADLINE["n_procs"],
                         seed=HEADLINE["seed"],
                         n_values=HEADLINE["n_values"])
    return encode_register_ops(corrupt_reads(h, n=2, seed=0))


def planted_chunk(stream):
    """The corrupted headline's forensics inputs, derived on the card
    with the plain versions alone: the chunk products
    (``chunk_product_torch``), the frontier chain (``prefix_alive_torch``)
    and the first dead chunk's grids, tables and entry frontier."""
    import torch
    from jepsen_tpu_torch.models import cas_register_spec
    from jepsen_tpu_torch.ops import forensics_kernels as fx
    from jepsen_tpu_torch.ops import jitlin
    from jepsen_tpu_torch.ops import matrix_kernels as mk
    V = jitlin._bucket(len(stream.intern), floor=8)
    prep = jitlin._returns_prepass(stream.kind, stream.slot, stream.f,
                                   stream.a, stream.b)
    S, R = prep[3], prep[0].shape[0]
    C, T = jitlin._matrix_plan(1, S, R, V)
    grids, uops = jitlin._matrix_grids([prep], S, V, 1, C, T, "cuda")
    mt, oob = jitlin._kernel_math(S, V, cas_register_spec().step_ids, 1,
                                  "cuda").uop_tables(uops)
    mtT = mt.transpose(1, 2).contiguous()
    P = mk.chunk_product_torch(grids[0], grids[1], mtT, grids[2], grids[3],
                               S, V)
    MV = (1 << S) * V
    v0 = torch.zeros((MV,), dtype=torch.bool, device="cuda")
    v0[0] = True
    alive, w = fx.prefix_alive_torch(P, v0)
    c_star = first_dead(alive)
    pend, ids, slots, valid = (g[:, c_star] for g in grids)
    return dict(S=S, V=V, MV=MV, C=C, T=T, c_star=c_star, P=P, v0=v0,
                pend=pend, ids=ids, slots=slots, valid=valid, mtT=mtT,
                oob=oob, v_start=fx.unpack_bits(w[c_star], MV))


def chunk_candidates(pc, K, seed):
    """window_rescan's arguments for K candidates over the planted chunk:
    the first keeps every op, the rest drop a fifth of the pending ops
    and of the returns."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    T, S = pc["pend"].shape
    pend = pc["pend"][None] & (torch.rand((K, T, S), generator=g,
                                          device="cuda") < 0.8)
    valid = pc["valid"][None] & (torch.rand((K, T), generator=g,
                                            device="cuda") < 0.8)
    pend[0], valid[0] = pc["pend"], pc["valid"]
    return [pend.contiguous(), valid.contiguous(), pc["ids"].contiguous(),
            pc["mtT"], pc["oob"], pc["slots"].contiguous(), pc["v_start"]]


# ---------------------------------------------------------------------------
# the C entries
# ---------------------------------------------------------------------------

def prefix_path(fn, C, MV) -> dict:
    """The chain's design that a ``jt_prefix_alive`` build takes at (C,
    MV), from its ``jt_prefix_alive_plan`` (``forensics_kernels.
    prefix_plan``); a build without one chains on one CTA."""
    from jepsen_tpu_torch.ops import forensics_kernels as fx
    try:
        plan = ctypes.CDLL(str(fn.lib_path)).jt_prefix_alive_plan
    except AttributeError:
        return {"design": "one_cta"}
    return fx.prefix_plan(C, MV, plan)


def prefix_entry(fn, P, v0):
    """A no-argument call of a ``jt_prefix_alive`` build on the operands
    its wrapper derives (the launches alone), and its outputs (alive
    [C] int32, w [C + 1, W]); both designs take the same operands."""
    import torch
    from jepsen_tpu_torch.ops import forensics_kernels as fx
    C, MV, _ = P.shape
    W = max(1, MV // 32)
    tensors = (P.to(torch.bfloat16).contiguous(),
               fx.pack_bits(v0).contiguous(),
               torch.empty((C,), dtype=torch.int32, device="cuda"),
               torch.empty((C + 1, W), dtype=torch.int32, device="cuda"),
               torch.empty((C * MV * W,), dtype=torch.int32, device="cuda"))
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(*(t.data_ptr() for t in tensors), C, MV, stream)
        if rc != 0:
            raise RuntimeError(f"prefix_alive launch failed: {rc}")
    return call, (tensors[2], tensors[3])


def earlier_rescan_operands(pend, valid, ids, mtT, oob, slots, v):
    """The operands that the wrapper of the design before the kernel took
    the raw grids derived for its C entry (its ``rescan_operands``): the
    pending bits of a valid return [K, T] (0 for an invalid one), its
    returning slot [K, T] (-1 for an invalid one), the op ids [T, S],
    each op's transition rows nxt[u, v] = {w : v -> w} [U, V], the oob
    flags [U] and the start vector as a state set a mask [M]."""
    import torch
    K, T, S = pend.shape
    V = mtT.shape[1]
    dev = pend.device
    val = valid > 0
    bits = torch.arange(S, dtype=torch.int32, device=dev)
    pm = (((pend > 0) & val[..., None]).to(torch.int32) << bits).sum(
        dim=2, dtype=torch.int32)
    rs = torch.where(val, slots.to(torch.int32)[None].expand(K, T),
                     torch.full((K, T), -1, dtype=torch.int32, device=dev))
    vbits = torch.arange(V, dtype=torch.int64, device=dev)
    nxt = ((mtT > 0).to(torch.int64) << vbits[None, :, None]).sum(dim=1)
    vset = ((v.reshape(-1, V) > 0).to(torch.int64) << vbits).sum(dim=1)

    def as_i32(x):
        return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)

    return (pm.contiguous(), rs.contiguous(),
            ids.to(torch.int32).contiguous(), as_i32(nxt).contiguous(),
            (oob > 0).to(torch.int32).contiguous(), as_i32(vset).contiguous())


def rescan_caller(fn, grids: bool, args):
    """(entry, wrapper, outputs) of a ``jt_window_rescan`` build on the
    rescan arguments ``args`` (``window_rescan``'s): ``entry()`` launches
    on operands derived once, ``wrapper()`` derives them as that design's
    wrapper does and launches; the outputs are (first [K] int32, inexact
    [K]) of the last call."""
    import torch
    from jepsen_tpu_torch.ops import forensics_kernels as fx
    pend, valid, ids, mtT, oob, slots, v = args
    K, T, S = pend.shape
    V, U = mtT.shape[1], mtT.shape[0]
    first = torch.empty((K,), dtype=torch.int32, device="cuda")
    inexact = torch.empty((K,), dtype=torch.int32 if not grids
                          else torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    if grids:
        def operands():
            chunk = fx.RescanChunk(ids, mtT, oob, slots, v)
            return fx.rescan_entry_operands(pend, valid, chunk)
        tail = (K, T, S, V, U)
    else:
        def operands():
            val = valid > 0
            if bool((((ids < 0) | (ids >= U)).any()
                     | (val & ((slots < 0) | (slots >= S))[None]).any())
                    .item()):
                raise ValueError("an op id or slot out of range")
            return earlier_rescan_operands(*args)
        tail = (K, T, S, V)
    fixed = operands()

    def launch(tensors):
        rc = fn(*(t.data_ptr() for t in tensors), first.data_ptr(),
                inexact.data_ptr(), *tail, stream)
        if rc != 0:
            raise RuntimeError(f"window_rescan launch failed: {rc}")

    def wrapper():
        launch(operands())
        return first, (inexact.view(torch.bool) if grids
                       else inexact.to(torch.bool))
    return (lambda: launch(fixed)), wrapper, (first, inexact)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def prefix_row(entries, P, v0, reps: int) -> dict:
    import torch
    from jepsen_tpu_torch.ops import forensics_kernels as fx
    C, MV, _ = P.shape
    calls = {label: prefix_entry(fn, P, v0)
             for (label, name), fn in entries.items()
             if name == "prefix_alive"}
    want = fx.prefix_alive_torch(P, v0)
    for label, (call, (alive, w)) in calls.items():
        call()
        torch.cuda.synchronize()
        if not (torch.equal(alive.bool(), want[0])
                and torch.equal(w, want[1])):
            raise AssertionError(f"{label} prefix_alive (C = {C}, MV = "
                                 f"{MV}) differs from the plain version")
    dead = first_dead(want[0])
    c1 = C if dead < 0 else dead + 1
    nbytes = c1 * MV * MV * 2 + C * 4 + (C + 1) * max(1, MV // 32) * 4
    row = {"C": C, "MV": MV, "first_dead": dead, "bytes": nbytes,
           "bound_ms": nbytes / PEAK_BYTES * 1e3}
    times = in_turns(lambda label: calls[label][0](), calls, reps)
    for label, (call, _) in calls.items():
        row[f"{label}_path"] = prefix_path(entries[label, "prefix_alive"],
                                           C, MV)
        row[f"{label}_entry_ms"] = times[label]
        row[f"{label}_device_ms"] = device_ms(call, ("pack", "chain"))
    return row


def rescan_row(entries, grids, args, reps: int) -> dict:
    import torch
    from jepsen_tpu_torch.ops import forensics_kernels as fx
    K, T, S = args[0].shape
    calls = {label: rescan_caller(fn, grids[label], args)
             for (label, name), fn in entries.items()
             if name == "window_rescan"}
    want = fx.window_rescan_torch(*args)
    for label, (entry, wrapper, (first, inexact)) in calls.items():
        for how in (entry, wrapper):
            how()
            torch.cuda.synchronize()
            if not (torch.equal(first, want[0])
                    and torch.equal(inexact.bool(), want[1])):
                raise AssertionError(f"{label} window_rescan (K = {K}, "
                                     f"T = {T}, S = {S}) differs from the "
                                     f"plain version")
    row = {"K": K, "T": T, "S": S, "V": args[3].shape[1],
           "first": want[0][:8].tolist()}
    for label in calls:
        row[f"{label}_path"] = (
            "cta" if not grids[label]
            else "warp" if S <= fx.RESCAN_WARP_MAX_SLOTS else "shared")
    for kind, pick in (("entry", 0), ("wrapper", 1)):
        times = in_turns(lambda label: calls[label][pick](), calls, reps)
        for label in calls:
            row[f"{label}_{kind}_ms"] = times[label]
    for label, (entry, _, _) in calls.items():
        row[f"{label}_device_ms"] = device_ms(entry, "rescan")
    return row


def main(argv) -> int:
    import torch
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("forensics_compare: no CUDA device", file=sys.stderr)
        return 1
    from jepsen_tpu_torch.ops import _build
    out_dir = _build.BUILD_DIR / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    roots = {"other": argv[0], "this": Path(__file__).resolve().parents[2]}
    grids = {label: takes_grids(root) for label, root in roots.items()}
    entries = build(roots, out_dir, NAMES, {
        (label, "window_rescan"): DERIVED_MASKS
        for label, new in grids.items() if not new})
    for (label, name), fn in sorted(entries.items()):
        print(json.dumps({"ptxas": label, "library": name,
                          "report": fn.ptxas}), flush=True)
    for C, MV, kill, dense in PREFIX_CASES:
        P = card_products(C, MV, MV + (kill or 0), kill, dense)
        v0 = torch.zeros((MV,), dtype=torch.bool, device="cuda")
        v0[0] = True
        row = prefix_row(entries, P, v0, reps=5 if MV >= 1024 else 20)
        print(json.dumps({"case": f"prefix_c{C}_mv{MV}_kill{kill}"
                                  f"{'_dense' if dense else ''}",
                          "kill_at": kill, "dense": dense, **row}),
              flush=True)
        del P
    pc = planted_chunk(headline_stream())
    row = prefix_row(entries, pc["P"], pc["v0"], reps=50)
    print(json.dumps({"case": "prefix_headline", **row}), flush=True)
    for case in RESCAN_CASES:
        row = rescan_row(entries, grids, random_rescan_inputs(*case), 50)
        print(json.dumps({"case": f"rescan_k{case[0]}_t{case[1]}_s{case[2]}"
                                  f"_v{case[3]}", **row}), flush=True)
    for K in (1, 4, 128):
        row = rescan_row(entries, grids, chunk_candidates(pc, K, K), 50)
        print(json.dumps({"case": f"rescan_headline_k{K}", **row}),
              flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
