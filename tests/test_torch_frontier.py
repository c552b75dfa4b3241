"""jepsen_tpu_torch.ops.frontier_kernels on the CPU: the plain versions
of the dense-table and sparse-frontier scans against the JAX package's
builders (``_build_dense_step``, ``_build_step``, jitted on the CPU
backend) and against numpy replays of the CUDA kernels' own algorithms.
Every result is an integer, a flag or a 0/1 frontier, so the tolerance
is zero: every comparison is exact equality, overflow included.

The CUDA kernels themselves run only on the card: the ``cuda``-marked
tests and ``chip_smoke.py`` hold them against these plain versions
there."""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.histories import (
    corrupt_reads, corrupt_txn_reads, crash_late_writes,
    multi_register_history, register_history,
)

SENT_MASK, SENT_STATE = 0xFFFFFFFF, 0x7FFFFFFF


def _crashed(history, every):
    out, n = [], 0
    for op in history:
        op = dict(op)
        if op["type"] == "ok" and op["f"] != "read":
            n += 1
            if n % every == 0:
                op["type"] = "info"
        out.append(op)
    return out


def _events_of(history):
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    st = encode_register_ops(history)
    return ([np.asarray(x, np.int32) for x in
             (st.kind, st.slot, st.f, st.a, st.b)],
            max(1, st.n_slots), len(st.intern))


def _invokes_across_chunk(ev, chunk=512):
    """``ev`` with no-op events put in before the last two invokes in a
    row that start below event chunk - 1, so that they sit at events
    chunk - 1 and chunk: the kernels stage 512 events at a time, and the
    next chunk is staged while the lanes have just read an invoke of the
    last one."""
    kind = ev[0]
    i = max(i for i in range(1, min(len(kind), chunk))
            if kind[i - 1] == 0 and kind[i] == 0)
    pad = chunk - i
    return [np.concatenate([x[:i - 1], np.full(pad, 2 if j == 0 else 0,
                                               np.int32), x[i - 1:]])
            for j, x in enumerate(ev)]


def _across_chunk_case(history):
    """(events, S) of ``history`` with invokes across the chunks."""
    ev, S, _ = _events_of(history)
    return _invokes_across_chunk(ev), S


def _synthetic(n_events, S, n_values, seed, p_none=0.4):
    """A seeded event stream with exactly S slots: the first S events
    invoke every slot, then invokes on free slots and returns of pending
    ones; reads of None (a = 0) with probability ``p_none``. Ops still
    pending at the end stay open."""
    rng = np.random.default_rng(seed)
    cols = [[] for _ in range(5)]
    free, pending = list(range(S)), []

    def invoke():
        s = free.pop(int(rng.integers(len(free))))
        pending.append(s)
        f = int(rng.integers(3))
        a = 0 if f == 0 and rng.random() < p_none else int(
            rng.integers(n_values))
        for col, x in zip(cols, (0, s, f, a, int(rng.integers(n_values)))):
            col.append(x)

    for _ in range(S):
        invoke()
    while len(cols[0]) < n_events:
        if free and (not pending or rng.random() < 0.5):
            invoke()
        else:
            s = pending.pop(int(rng.integers(len(pending))))
            free.append(s)
            for col, x in zip(cols, (1, s, 0, 0, 0)):
                col.append(x)
    return [np.asarray(c, np.int32) for c in cols]


# ---------------------------------------------------------------------------
# numpy replays of the kernels' algorithms
# ---------------------------------------------------------------------------

def _cas_step(state, f, a, b):
    from jepsen_tpu_torch.checker.linear_cpu import cas_register_step_py
    return cas_register_step_py(state, f, a, b)


def _dense_replay(ev, table0):
    """csrc/frontier_dense.cu in numpy: the out-of-range flag of every
    invoke up front; per return one level-order pass (rows by
    popcount(r & pm), each row ORs in the next-state images of the rows
    r ^ 2^t of the level below), the kill by row pairs, and a stop at the
    return where the table empties."""
    kind, slot, f, a, b = ev
    M, V = table0.shape
    S = M.bit_length() - 1
    inexact = False
    for e in np.nonzero(kind == 0)[0]:
        for v in range(V):
            st, ok = _cas_step(v, int(f[e]), int(a[e]), int(b[e]))
            inexact |= ok and not 0 <= st < V
    T = table0.copy()
    nxt = np.full((S, V), -1)
    pm, alive, died, peak = 0, True, -1, 1
    for e in range(len(kind)):
        s = int(slot[e])
        if kind[e] == 0:
            for v in range(V):
                st, ok = _cas_step(v, int(f[e]), int(a[e]), int(b[e]))
                nxt[s, v] = st if ok and 0 <= st < V else -1
            pm |= 1 << s
        elif kind[e] == 1:
            rows = np.arange(M)
            level = np.asarray([bin(r & pm).count("1") for r in rows])
            for p in range(1, bin(pm).count("1") + 1):
                for t in range(S):
                    rt = rows[(level == p) & ((rows & pm) >> t & 1 == 1)]
                    img = np.zeros((V, V), bool)   # v -> nxt[t, v]
                    img[np.nonzero(nxt[t] >= 0)[0], nxt[t][nxt[t] >= 0]] = 1
                    T[rt] |= (T[rt ^ (1 << t)].astype(np.int64)
                              @ img.astype(np.int64)) > 0
            peak = max(peak, int(T.sum()))
            T2 = np.zeros_like(T)
            for r in range(M):
                if not r >> s & 1:
                    T2[r] = T[r | (1 << s)]
            T = T2
            pm &= ~(1 << s)
            if not T.any():
                alive, died = False, e
                T[:] = False
                break
    return alive, died, inexact, peak, T


def _key(mask, state):
    return (int(mask) << 32) | ((int(state) ^ 0x80000000) & 0xFFFFFFFF)


def _sparse_replay(ev, mask0, state0, S):
    """csrc/frontier_sparse.cu in numpy: pairs as 64-bit keys; a pass
    sorts only the candidates that exist (the list's keys and the valid
    expansions) and keeps the first K distinct; the kill is a stable
    compaction with the returning bit cleared, no sort."""
    kind, slot, f, a, b = ev
    K = len(mask0)
    sent = _key(SENT_MASK, SENT_STATE)
    F = [_key(m, s) for m, s in zip(mask0, state0)]
    cur = np.zeros((3, S), np.int64)
    pm, alive, died, overflow, peak = 0, True, -1, False, 1
    for e in range(len(kind)):
        s = int(slot[e])
        if kind[e] == 0:
            cur[:, s] = f[e], a[e], b[e]
            pm |= 1 << s
            continue
        if kind[e] != 1:
            continue
        count = sum(k >> 32 != SENT_MASK for k in F)
        for _ in range(S):
            cand = [k for k in F if k != sent]
            for k in F:
                m, st = k >> 32, (k & 0xFFFFFFFF) ^ 0x80000000
                st = st - (1 << 32) if st >= 1 << 31 else st
                if k == sent or m == SENT_MASK:
                    continue
                for t in range(S):
                    if pm >> t & 1 and not m >> t & 1:
                        st2, ok = _cas_step(st, *(int(x) for x in cur[:, t]))
                        if ok:
                            cand.append(_key(m | (1 << t), st2))
            distinct = sorted(set(cand) - {sent})
            if len(distinct) > K and distinct[K] >> 32 != SENT_MASK:
                overflow = True
            F = distinct[:K] + [sent] * max(0, K - len(distinct))
            c2 = sum(k >> 32 != SENT_MASK for k in F)
            grew = c2 > count
            count = c2
            if not grew:
                break
        peak = max(peak, count)
        kept = [k - (1 << (32 + s)) for k in F
                if k >> 32 != SENT_MASK and k >> (32 + s) & 1]
        F = kept + [sent] * (K - len(kept))
        pm &= ~(1 << s)
        if not kept:
            alive, died = False, e
            break
    mask = np.asarray([k >> 32 for k in F], np.uint32)
    state = np.asarray([((k & 0xFFFFFFFF) ^ 0x80000000) for k in F],
                       np.uint32).view(np.int32)
    return alive, died, overflow, peak, mask, state


def _dense_warp_replay(ev, table0):
    """csrc/frontier_dense.cu's warp path in numpy: per return npend
    rounds, round p ORing into the rows of level popcount(r & pm) = p the
    images under nxt_t of their rows r ^ 2^t (level p - 1, final), with
    no order table; then the kill by row pairs, its population and
    emptiness."""
    kind, slot, f, a, b = ev
    M, V = table0.shape
    S = M.bit_length() - 1
    inexact = False
    for e in np.nonzero(kind == 0)[0]:
        for v in range(V):
            st, ok = _cas_step(v, int(f[e]), int(a[e]), int(b[e]))
            inexact |= ok and not 0 <= st < V
    T = table0.copy()
    nxt = np.full((S, V), -1)
    rows = np.arange(M)
    popc = np.asarray([bin(r).count("1") for r in range(M)])
    pm, alive, died, peak = 0, True, -1, 1
    for e in range(len(kind)):
        s = int(slot[e])
        if kind[e] == 0:
            for v in range(V):
                st, ok = _cas_step(v, int(f[e]), int(a[e]), int(b[e]))
                nxt[s, v] = st if ok and 0 <= st < V else -1
            pm |= 1 << s
            continue
        if kind[e] != 1:
            continue
        level = popc[rows & pm]
        for p in range(1, popc[pm] + 1):
            at = rows[level == p]
            for t in range(S):
                if pm >> t & 1:
                    rt = at[at >> t & 1 == 1]
                    src = T[rt ^ (1 << t)]
                    for v in np.nonzero(nxt[t] >= 0)[0]:
                        T[rt, nxt[t, v]] |= src[:, v]
        lo = rows[rows >> s & 1 == 0]
        pop = int(T.sum())
        any_left = bool(T[lo | (1 << s)].any())
        T[lo] = T[lo | (1 << s)]
        T[lo | (1 << s)] = False
        peak = max(peak, pop)
        pm &= ~(1 << s)
        if not any_left:
            alive, died = False, e
            break
    return alive, died, inexact, peak, T


def _key_state(k):
    st = (k & 0xFFFFFFFF) ^ 0x80000000
    return st - (1 << 32) if st >= 1 << 31 else st


def _expansion_runs(keys, pm, cur):
    """The expansions of a sorted, distinct list by each pending slot t in
    ascending order, one run a slot, in the list's order (the kernel's
    candidates beside the list's own keys)."""
    runs = []
    for t in range(32):
        if not pm >> t & 1:
            continue
        run = []
        for k in keys:
            m = k >> 32
            if m == SENT_MASK or m >> t & 1:
                continue
            st2, ok = _cas_step(_key_state(k), *(int(x) for x in cur[:, t]))
            c = _key(m | (1 << t), st2)
            if ok and c != _key(SENT_MASK, SENT_STATE):
                run.append(c)
        runs.append(run)
    return runs


def _dedup_adjacent(run):
    return [k for i, k in enumerate(run) if i == 0 or k != run[i - 1]]


def _sparse_pass_model(keys, pm, cur, K):
    """One closure pass of csrc/frontier_sparse.cu from a sorted, distinct
    list (sentinels left out), sized by the list: its keys and one run of
    expansions a pending slot, each run sorted once adjacent duplicates go
    (the CAS register), merged with duplicates removed, the first K kept.
    Returns (kept keys, valid kept, overflow, candidates)."""
    import heapq
    runs = [list(keys)] + _expansion_runs(keys, pm, cur)
    n = sum(len(r) for r in runs)
    merged = _dedup_adjacent(list(heapq.merge(
        *(_dedup_adjacent(r) for r in runs))))
    kept = merged[:K]
    overflow = len(merged) > K and merged[K] >> 32 != SENT_MASK
    return kept, sum(k >> 32 != SENT_MASK for k in kept), overflow, n


def _sparse_kernel_model(ev, mask0, state0, S):
    """csrc/frontier_sparse.cu's control in numpy: the scan's first pass
    from the list as given (its CTA path: a sort of the raw list and its
    expansions), then passes sized by the live list (`len` keys), each on
    the warp path when len <= 64 and it has at most 64 candidates, and the
    kill as an in-place stable compaction. Returns the results and the
    number of warp-path passes."""
    kind, slot, f, a, b = ev
    K = len(mask0)
    sent = _key(SENT_MASK, SENT_STATE)
    F = [_key(m, s) for m, s in zip(mask0, state0)]
    cur = np.zeros((3, S), np.int64)
    pm, alive, died, overflow, peak = 0, True, -1, False, 1
    given, warp_passes = True, 0
    for e in range(len(kind)):
        s = int(slot[e])
        if kind[e] == 0:
            cur[:, s] = f[e], a[e], b[e]
            pm |= 1 << s
            continue
        if kind[e] != 1:
            continue
        count = sum(k >> 32 != SENT_MASK for k in F)
        for _ in range(S):
            if given:   # the raw list: every non-sentinel entry, any order
                raw = [k for k in F if k != sent]
                cand = raw + [c for run in _expansion_runs(raw, pm, cur)
                              for c in run]
                distinct = sorted(set(cand))
                kept = distinct[:K]
                ovf = len(distinct) > K and distinct[K] >> 32 != SENT_MASK
                c2 = sum(k >> 32 != SENT_MASK for k in kept)
                given = False
            else:
                live = F[:F.index(sent)] if sent in F else F
                kept, c2, ovf, n = _sparse_pass_model(live, pm, cur, K)
                warp_passes += len(live) <= 64 and n <= 64
            F = kept + [sent] * (K - len(kept))
            overflow |= ovf
            grew = c2 > count
            count = c2
            if not grew:
                break
        peak = max(peak, count)
        kept = [k - (1 << (32 + s)) for k in F
                if k >> 32 != SENT_MASK and k >> (32 + s) & 1]
        F = kept + [sent] * (K - len(kept))
        pm &= ~(1 << s)
        if not kept:
            alive, died = False, e
            break
    mask = np.asarray([k >> 32 for k in F], np.uint32)
    state = np.asarray([((k & 0xFFFFFFFF) ^ 0x80000000) for k in F],
                       np.uint32).view(np.int32)
    return (alive, died, overflow, peak, mask, state), warp_passes


# ---------------------------------------------------------------------------
# the JAX builders and the port's plain versions
# ---------------------------------------------------------------------------

def _jax_dense(ev, table0):
    import jax
    from jepsen_tpu.models import cas_register_spec
    from jepsen_tpu.ops.jitlin import _build_dense_step
    M, V = table0.shape
    run = _build_dense_step(M.bit_length() - 1, V,
                            cas_register_spec().step_ids, 0)
    alive, died, inexact, peak, table = jax.jit(run.resume)(*ev, table0)
    return (bool(alive), int(died), bool(inexact), int(peak),
            np.asarray(table))


def _jax_sparse(ev, mask0, state0, S):
    import jax
    from jepsen_tpu.models import cas_register_spec
    from jepsen_tpu.ops.jitlin import _build_step
    run = _build_step(S, len(mask0), cas_register_spec().step_ids, 0)
    alive, died, ovf, peak, mask, state = jax.jit(run.resume)(
        *ev, mask0, state0)
    return (bool(alive), int(died), bool(ovf), int(peak),
            np.asarray(mask), np.asarray(state))


def _port_dense(ev, table0):
    from jepsen_tpu_torch.ops.frontier_kernels import frontier_dense
    alive, died, inexact, peak, table = frontier_dense(
        *(torch.from_numpy(x) for x in ev), torch.from_numpy(table0))
    assert table.dtype == torch.bool and table.shape == table0.shape
    return (bool(alive), int(died), bool(inexact), int(peak),
            table.numpy())


def _port_sparse(ev, mask0, state0, S):
    from jepsen_tpu_torch.convert import frontier_from_numpy
    from jepsen_tpu_torch.ops.frontier_kernels import frontier_sparse
    m0, s0 = frontier_from_numpy(mask0, state0, device="cpu")
    alive, died, ovf, peak, mask, state = frontier_sparse(
        *(torch.from_numpy(x) for x in ev), m0, s0, S)
    assert mask.dtype == torch.uint32 and state.dtype == torch.int32
    return (bool(alive), int(died), bool(ovf), int(peak),
            mask.to(torch.int64).numpy().astype(np.uint32), state.numpy())


def _same(x, y):
    assert x[:4] == y[:4]
    for p, q in zip(x[4:], y[4:]):
        assert p.dtype == q.dtype and np.array_equal(p, q)


def _init_table(S, V):
    t = np.zeros((1 << S, V), bool)
    t[0, 0] = True
    return t


def _init_frontier(K):
    mask = np.full(K, SENT_MASK, np.uint32)
    state = np.full(K, SENT_STATE, np.int32)
    mask[0], state[0] = 0, 0
    return mask, state


def _history_case(h):
    ev, S, nst = _events_of(h)
    from jepsen_tpu_torch.ops.jitlin import _bucket
    return ev, S, _bucket(nst, floor=16)


DENSE_CASES = {
    "valid": lambda: _history_case(
        register_history(150, n_procs=3, seed=1, n_values=5)),
    "invalid": lambda: _history_case(corrupt_reads(
        register_history(150, n_procs=4, seed=2, n_values=5), n=2, seed=1)),
    "crashed": lambda: _history_case(_crashed(
        register_history(160, n_procs=4, seed=3, n_values=4), 12)),
    "s1": lambda: _history_case(
        register_history(100, n_procs=1, seed=4, n_values=6)),
    # the table's corners: S = 12 and V = 512 (wider than the states)
    "s12": lambda: (_history_case(
        register_history(200, n_procs=12, seed=5, n_values=4))[0], 12, 16),
    "v512": lambda: (_history_case(
        register_history(300, n_procs=3, seed=6, n_values=300))[0], 3, 512),
}


@functools.lru_cache(maxsize=None)
def _jax_dense_case(case):
    """JAX's result on DENSE_CASES[case] from the initial table, computed
    once for the tests that hold the port and the replays to it."""
    ev, S, V = DENSE_CASES[case]()
    return _jax_dense(ev, _init_table(S, V))


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_matches_jax_and_replay(case):
    ev, S, V = DENSE_CASES[case]()
    t0 = _init_table(S, V)
    ref = _jax_dense_case(case)
    got = _port_dense(ev, t0)
    _same(got, ref)
    _same(_dense_replay(ev, t0), ref)
    assert ref[0] is (case != "invalid")
    assert ref[3] > 1


def test_dense_inexact_after_death():
    """The out-of-range flag is folded in at every invoke, also after the
    frontier died: a write of a value id >= V after the death makes the
    verdict inexact in both packages."""
    V = 16
    # read 3 of an initial state 0: dies at the return (event 1); then a
    # write of id 100 (>= V) and its return
    ev = [np.asarray(x, np.int32) for x in
          ([0, 1, 0, 1], [0, 0, 0, 0], [0, 0, 1, 0], [3, 0, 100, 0],
           [0, 0, 0, 0])]
    t0 = _init_table(1, V)
    ref = _jax_dense(ev, t0)
    assert ref[:4] == (False, 1, True, 1)
    _same(_port_dense(ev, t0), ref)
    _same(_dense_replay(ev, t0), ref)
    # without the late write: exact
    ev2 = [x[:2] for x in ev]
    assert _jax_dense(ev2, t0)[:4] == _port_dense(ev2, t0)[:4] == (
        False, 1, False, 1)


SPARSE_CASES = {
    "valid": lambda: _history_case(
        register_history(150, n_procs=4, seed=7, n_values=6)),
    "invalid": lambda: _history_case(corrupt_reads(
        register_history(150, n_procs=3, seed=8, n_values=5), n=2, seed=2)),
    "crashed": lambda: _history_case(_crashed(
        register_history(160, n_procs=5, seed=9, n_values=4), 25)),
    "fresh_values": lambda: _history_case(
        register_history(150, n_procs=4, seed=10, n_values=10 ** 9)),
}


@pytest.mark.parametrize("K", [256, 16, 4])
@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_sparse_matches_jax_and_replay(case, K):
    ev, S, _ = SPARSE_CASES[case]()
    m0, s0 = _init_frontier(K)
    ref = _jax_sparse(ev, m0, s0, S)
    _same(_port_sparse(ev, m0, s0, S), ref)
    _same(_sparse_replay(ev, m0, s0, S), ref)
    if K == 256:
        assert ref[0] is (case != "invalid")
        # the crashed history keeps more than 256 configurations alive
        assert ref[2] is (case == "crashed")
    if K == 4:
        assert ref[2]   # more than 4 distinct configurations: overflow


def test_sparse_overflow_under_truncation_many_slots():
    """Twelve slots at K = 16: the passes truncate, so a level-order or
    in-place closure would keep another set; the port keeps the
    reference's."""
    ev = _synthetic(160, 12, 5, seed=11, p_none=0.7)
    m0, s0 = _init_frontier(16)
    ref = _jax_sparse(ev, m0, s0, 12)
    assert ref[2]
    _same(_port_sparse(ev, m0, s0, 12), ref)
    _same(_sparse_replay(ev, m0, s0, 12), ref)


@pytest.mark.parametrize("rep", ["dense", "sparse"])
def test_resume_from_jax_carry(rep):
    """Segment 1 in JAX, segment 2 resumed by the port from JAX's carry
    (``convert.frontier_from_numpy``): the same results and frontier as
    JAX resuming itself, and the port's own segment-1 frontier equals
    JAX's."""
    from jepsen_tpu.ops.jitlin import quiescent_cuts
    from jepsen_tpu_torch.convert import frontier_from_numpy
    from jepsen_tpu_torch.ops.frontier_kernels import (
        frontier_dense, frontier_sparse)

    h = register_history(120, n_procs=3, seed=12, n_values=5)
    ev, S, V = _history_case(h)
    cut = quiescent_cuts(ev[0], len(ev[0]) // 2)[0]
    assert 0 < cut < len(ev[0])
    seg1, seg2 = [x[:cut] for x in ev], [x[cut:] for x in ev]
    if rep == "dense":
        t0 = _init_table(S, V)
        c1 = _jax_dense(seg1, t0)
        _same(_port_dense(seg1, t0), c1)
        ref = _jax_dense(seg2, c1[4])
        out = frontier_dense(*(torch.from_numpy(x) for x in seg2),
                             frontier_from_numpy(c1[4], device="cpu"))
        got = (bool(out[0]), int(out[1]), bool(out[2]), int(out[3]),
               out[4].numpy())
    else:
        m0, s0 = _init_frontier(16)
        c1 = _jax_sparse(seg1, m0, s0, S)
        _same(_port_sparse(seg1, m0, s0, S), c1)
        ref = _jax_sparse(seg2, c1[4], c1[5], S)
        out = frontier_sparse(*(torch.from_numpy(x) for x in seg2),
                              *frontier_from_numpy(c1[4], c1[5],
                                                   device="cpu"), S)
        got = (bool(out[0]), int(out[1]), bool(out[2]), int(out[3]),
               out[4].to(torch.int64).numpy().astype(np.uint32),
               out[5].numpy())
    _same(got, ref)
    assert ref[0] is True


def test_frontier_from_numpy_rejects_bad_carries():
    from jepsen_tpu_torch.convert import frontier_from_numpy
    with pytest.raises(ValueError):
        frontier_from_numpy(np.zeros((3, 16), bool), device="cpu")
    with pytest.raises(ValueError):
        frontier_from_numpy(np.zeros(4, np.uint32), np.zeros(5, np.int32),
                            device="cpu")


def test_gates_and_verdict_match_jax():
    from jepsen_tpu.ops import jitlin as ref
    from jepsen_tpu_torch.ops import jitlin

    for S in range(0, 15):
        for n in (None, 1, 15, 16, 17, 100, 300, 512, 513):
            assert jitlin._dense_ok(S, n) == ref._dense_ok(S, n), (S, n)
            want = "dense" if ref._dense_ok(S, n) else "sparse"
            assert jitlin.JitLinKernel(device="cpu").route(S, n) == want
    for alive in (True, False):
        for ovf in (True, False):
            assert jitlin.verdict(alive, ovf) == ref.verdict(alive, ovf)


@pytest.mark.parametrize("case", ["valid", "invalid", "crashed"])
def test_jitlin_kernel_check_matches_jax(case):
    """``JitLinKernel.check`` (the rung's scan, K = 256) equals the JAX
    package's ``JitLinKernel.check`` on the CPU backend."""
    from jepsen_tpu.checker.linear_encode import encode_register_ops as enc
    from jepsen_tpu.ops.jitlin import JitLinKernel as RefKernel
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    from jepsen_tpu_torch.ops.jitlin import JitLinKernel

    h = {"valid": register_history(200, n_procs=4, seed=13, n_values=5),
         "invalid": corrupt_reads(register_history(
             200, n_procs=3, seed=14, n_values=10 ** 9), n=2, seed=3),
         "crashed": _crashed(register_history(
             200, n_procs=5, seed=15, n_values=4), 30)}[case]
    ref = RefKernel().check(enc(h))
    got = JitLinKernel(device="cpu").check(encode_register_ops(h))
    assert got == ref
    assert got[0] is (case != "invalid")


def test_sparse_takes_at_most_32_slots():
    """Masks are uint32: the sparse scan raises past 32 slots (plain
    version and kernel alike), and the checker leaves such a history to
    the CPU twin."""
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.ops.frontier_kernels import (
        frontier_sparse, init_frontier)

    ev = [torch.zeros(1, dtype=torch.int32)] * 5
    with pytest.raises(ValueError, match="32"):
        frontier_sparse(*ev, *init_frontier(16, 0), n_slots=33)
    # 33 crashed CAS ops that never apply hold 33 slots open
    h = []
    for p in range(33):
        h.append({"type": "invoke", "process": p, "f": "cas",
                  "value": [999, 1]})
    for p in range(33):
        h.append({"type": "info", "process": p, "f": "cas",
                  "value": [999, 1]})
    h += [{"type": "invoke", "process": 40, "f": "read", "value": None},
          {"type": "ok", "process": 40, "f": "read", "value": None}]
    got = linearizable(accelerator="gpu", device="cpu").check({}, h, {})
    assert got["valid?"] is True and got["algorithm"] == "jitlin-cpu"


# ---------------------------------------------------------------------------
# the redesigned kernels' algorithms: passes sized by the live list, runs
# merged with dedup, the dense closure in rounds by level
# ---------------------------------------------------------------------------

def _random_pass(rng, S, K):
    """A seeded sorted, distinct list of 1 .. K keys over S slots (a few
    masks with several signed states each, as a frontier holds them; at
    S = 32 an invalid-mask key may close it), the pending slots and one
    random CAS op a slot: reads (a = 0 reads None), writes and CAS."""
    n = int(rng.integers(1, K + 1))
    masks = rng.integers(0, 1 << S, 6, dtype=np.uint64)
    keys = {_key(int(rng.choice(masks)), int(rng.integers(-2, 6)))
            for _ in range(n)}
    if S == 32 and rng.random() < 0.5:
        keys.add(_key(SENT_MASK, int(rng.integers(-2, 6))))
    keys = sorted(keys)[:K]
    pm = int(rng.integers(0, 1 << S))
    cur = np.stack([rng.integers(0, 3, S), rng.integers(0, 5, S),
                    rng.integers(0, 5, S)]).astype(np.int64)
    return keys, pm, cur


def _pass_by_dedup_compact(keys, pm, cur, S, K):
    """The same pass as the port's copy of the reference's closure body
    (jepsen_tpu/ops/jitlin.py:144-163): the K x S expansion grid beside
    the list, then ``_dedup_compact`` (:129-140)."""
    from jepsen_tpu_torch.models import _cas_step_ids
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    sent = _key(SENT_MASK, SENT_STATE)
    padded = keys + [sent] * (K - len(keys))
    mask = torch.tensor([k >> 32 for k in padded], dtype=torch.int64)
    state = torch.tensor([_key_state(k) for k in padded], dtype=torch.int32)
    bits = 1 << torch.arange(S, dtype=torch.int64)
    pend = torch.tensor([pm >> t & 1 for t in range(S)], dtype=torch.bool)
    c = torch.from_numpy(cur).to(torch.int32)
    can = ((mask != SENT_MASK)[:, None] & pend[None, :]
           & ((mask[:, None] & bits[None, :]) == 0))
    st2, ok = _cas_step_ids(state[:, None], c[0][None, :], c[1][None, :],
                            c[2][None, :])
    new = torch.where(can & ok, fk._pack(mask[:, None] | bits[None, :], st2),
                      fk.SENTINEL_KEY)
    kept, ovf = fk._dedup_compact(
        torch.cat([fk._pack(mask, state), new.reshape(-1)]), K)
    m, st = fk._unpack(kept)
    return [_key(int(x), int(y)) for x, y in zip(m, st)
            if (int(x), int(y)) != (SENT_MASK, SENT_STATE)], bool(ovf)


@pytest.mark.parametrize("S", [1, 5, 12, 32])
@pytest.mark.parametrize("K", [4, 16, 256])
def test_sparse_pass_model_matches_dedup_compact(K, S):
    """The kernel's pass (runs sized by the list, merged with dedup, the
    first K distinct, overflow from the (K+1)-th) equals the reference's
    dedup_compact of the full candidate grid on random sorted, distinct
    lists and random CAS ops."""
    rng = np.random.default_rng(1000 * K + S)
    for _ in range(12):
        keys, pm, cur = _random_pass(rng, S, K)
        kept, count, ovf, n = _sparse_pass_model(keys, pm, cur, K)
        ref, ref_ovf = _pass_by_dedup_compact(keys, pm, cur, S, K)
        assert (kept, ovf) == (ref, ref_ovf)
        assert count == sum(k >> 32 != SENT_MASK for k in ref)
        assert n >= len(keys) and len(kept) >= len(keys)


@pytest.mark.parametrize("S", [1, 5, 12, 32])
def test_cas_expansion_runs_sorted_after_dedup(S):
    """For the CAS register, each slot's expansions of a sorted, distinct
    list come out sorted, strictly once adjacent duplicates go (a write
    sends a mask's states to one), so a pass is a merge of 1 + npend
    sorted runs."""
    rng = np.random.default_rng(77 + S)
    seen_dup = False
    for _ in range(40):
        keys, pm, cur = _random_pass(rng, S, 64)
        cur[0, rng.random(S) < 0.4] = 1   # more writes: duplicate states
        for run in _expansion_runs(keys, pm, cur):
            d = _dedup_adjacent(run)
            assert all(x < y for x, y in zip(d, d[1:]))
            assert len(set(run)) == len(d)
            seen_dup |= len(d) < len(run)
    assert seen_dup or S == 1


@pytest.mark.parametrize("S", [5, 12, 32])
@pytest.mark.parametrize("K", [4, 16, 256])
def test_sparse_pass_model_matches_jax_one_pass(K, S):
    """The pass model against JAX's ``_build_step`` capped at one closure
    pass: every key holds a marker slot m (never pending), so the return
    of m keeps every key of the pass, clears m and leaves the order; OR-ing
    m back gives the pass's list, its overflow and (as peak) its count."""
    import jax
    from jepsen_tpu.models import cas_register_spec
    from jepsen_tpu.ops.jitlin import _build_step
    run = jax.jit(_build_step(S, K, cas_register_spec().step_ids, 0,
                              max_closure_iters=1).resume)
    rng = np.random.default_rng(10 * K + S)
    m_bit = 1 << (S - 1)
    sent = _key(SENT_MASK, SENT_STATE)
    for _ in range(4):
        keys, pm, cur = _random_pass(rng, S - 1, K)
        keys = sorted({k | (m_bit << 32) if k >> 32 != SENT_MASK else k
                       for k in keys})[:K]
        pm &= m_bit - 1
        pend = [t for t in range(S - 1) if pm >> t & 1]
        cols = [[0] * len(pend) + [1], pend + [S - 1],
                [int(cur[0, t]) for t in pend] + [0],
                [int(cur[1, t]) for t in pend] + [0],
                [int(cur[2, t]) for t in pend] + [0]]
        ev = [np.asarray(c, np.int32) for c in cols]
        padded = keys + [sent] * (K - len(keys))
        m0 = np.asarray([k >> 32 for k in padded], np.uint32)
        s0 = np.asarray([_key_state(k) for k in padded], np.int32)
        alive, died, ovf, peak, mask, state = run(*ev, m0, s0)
        got = [_key(int(m) | m_bit, int(s)) for m, s in
               zip(np.asarray(mask), np.asarray(state))
               if int(m) != SENT_MASK]
        full = np.zeros((3, S), np.int64)
        full[:, :S - 1] = cur
        kept, count, model_ovf, _ = _sparse_pass_model(keys, pm, full, K)
        valid = [k for k in kept if k >> 32 != SENT_MASK]
        assert got == valid and bool(ovf) == model_ovf
        assert int(peak) == max(1, count)


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_warp_replay_matches_jax_and_replay(case):
    ev, S, V = DENSE_CASES[case]()
    t0 = _init_table(S, V)
    got = _dense_warp_replay(ev, t0)
    _same(got, _jax_dense_case(case))
    _same(got, _dense_replay(ev, t0))


@pytest.mark.parametrize("K", [256, 16, 4])
@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_sparse_kernel_model_matches_jax_and_counts(case, K):
    """The kernel's control (the given list's first pass, then passes
    sized by the live list, warp or CTA by size, the in-place kill)
    matches JAX, and its warp-path passes are the ones the plain version
    counts in ``work``."""
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    ev, S, _ = SPARSE_CASES[case]()
    m0, s0 = _init_frontier(K)
    got, warp = _sparse_kernel_model(ev, m0, s0, S)
    _same(got, _jax_sparse(ev, m0, s0, S))
    work = {}
    fk.frontier_sparse_torch(*(torch.from_numpy(x) for x in ev),
                             *fk.init_frontier(K, 0), S, work=work)
    assert work["warp_passes"] == warp
    assert 0 < warp <= work["passes"]


def _unsorted_start(K, seed):
    """A seeded given list: unsorted, with duplicates, an invalid-mask
    entry and a sentinel pair."""
    rng = np.random.default_rng(seed)
    mask = rng.integers(0, 4, K).astype(np.uint32)
    state = rng.integers(0, 3, K).astype(np.int32)
    mask[::3], state[::3] = mask[0], state[0]
    mask[-1], state[-1] = SENT_MASK, 2
    mask[1], state[1] = SENT_MASK, SENT_STATE
    return mask, state


@pytest.mark.parametrize("K", [256, 16, 4])
def test_sparse_unsorted_start_matches_jax(K):
    """From an unsorted list with duplicates the first pass sorts the raw
    list, as the reference does: the kernel model, the replay and the
    port's plain version all equal JAX."""
    ev = _synthetic(120, 5, 4, seed=40 + K, p_none=0.5)
    m0, s0 = _unsorted_start(K, K)
    ref = _jax_sparse(ev, m0, s0, 5)
    _same(_sparse_kernel_model(ev, m0, s0, 5)[0], ref)
    _same(_sparse_replay(ev, m0, s0, 5), ref)
    _same(_port_sparse(ev, m0, s0, 5), ref)


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_plain_counts_returns_by_path(case):
    """The plain version counts the returns it closes, up to the one where
    the table empties, and those the kernel closes on its warp path: all
    or none of them, by the table's shape."""
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    ev, S, V = DENSE_CASES[case]()
    work = {}
    got = fk.frontier_dense_torch(*(torch.from_numpy(x) for x in ev),
                                  torch.from_numpy(_init_table(S, V)),
                                  work=work)
    died = int(got[1])
    upto = ev[0][:died + 1] if died >= 0 else ev[0]
    assert work["returns"] == int((upto == 1).sum()) > 0
    assert work["warp_returns"] == work["returns"] * fk.dense_warp_path(S, V)


def test_invokes_across_chunk_change_only_event_indices():
    """No-op events put in before a run of invokes at the kernels' chunk
    boundary shift ``died`` and nothing else, in JAX and in the port's
    plain versions (the stream the card tests give both kernels)."""
    ev, S, V = _history_case(
        register_history(400, n_procs=5, seed=30, n_values=5))
    padded = _invokes_across_chunk(ev)
    assert padded[0][511] == padded[0][512] == 0
    assert len(padded[0]) > len(ev[0])
    t0 = _init_table(S, V)
    got = _port_dense(padded, t0)
    _same(got, _jax_dense(padded, t0))
    _same(got, _jax_dense(ev, t0))
    assert got[0] is True
    m0, s0 = _init_frontier(16)
    got = _port_sparse(padded, m0, s0, S)
    _same(got, _jax_sparse(padded, m0, s0, S))
    _same(got, _jax_sparse(ev, m0, s0, S))


@pytest.fixture
def cuda_device():
    """The CUDA device; skips where there is none (decided here, never
    at import, so every test worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_kernel_matches_plain_on_card(cuda_device, case):
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    ev, S, V = DENSE_CASES[case]()
    ev = [torch.from_numpy(x).to(cuda_device) for x in ev]
    t0 = torch.from_numpy(_init_table(S, V)).to(cuda_device)
    n = fk.frontier_dense.launches
    got = fk.frontier_dense(*ev, t0)
    work = {}
    ref = fk.frontier_dense_torch(*ev, t0, work=work)
    assert fk.frontier_dense.launches == n + 1
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    assert fk.frontier_dense.paths.tolist() == [work["warp_returns"],
                                                work["returns"]]


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 16, 4])
@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_sparse_kernel_matches_plain_on_card(cuda_device, case, K):
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    ev, S, _ = SPARSE_CASES[case]()
    ev = [torch.from_numpy(x).to(cuda_device) for x in ev]
    m0, s0 = fk.init_frontier(K, 0, cuda_device)
    n = fk.frontier_sparse.launches
    got = fk.frontier_sparse(*ev, m0, s0, S)
    work = {}
    ref = fk.frontier_sparse_torch(*ev, m0, s0, S, work=work)
    assert fk.frontier_sparse.launches == n + 1
    for x, y in zip(got, ref):
        assert torch.equal(x.to(torch.int64), y.to(torch.int64))
    assert fk.frontier_sparse.paths.tolist() == [work["warp_passes"],
                                                 work["passes"]]


def _mr_events(history, shape=(3, 5)):
    """The multi-register stream of ``history`` at ``shape``: (events, S)."""
    from jepsen_tpu_torch.checker.linear_encode import (
        encode_multi_register_ops)
    st = encode_multi_register_ops(history, *shape)
    return ([np.asarray(x, np.int32) for x in
             (st.kind, st.slot, st.f, st.a, st.b)], st.n_slots)


# the kernels' paths by shape: (table S, V, history, warp path?), and for
# the multi-register model (table S, V, (events, S), warp path?, (keys,
# values))
DENSE_PATH_CASES = {
    "warp_s5_v16": lambda: (5, 16, register_history(
        400, n_procs=5, seed=20, n_values=5), True),
    "warp_s6_v32": lambda: (6, 32, register_history(
        300, n_procs=6, seed=27, n_values=20), True),
    "warp_s7_v16": lambda: (7, 16, register_history(
        300, n_procs=7, seed=28, n_values=6), True),
    "cta_s7_v32": lambda: (7, 32, register_history(
        300, n_procs=7, seed=29, n_values=20), False),
    "cta_s6_v512": lambda: (6, 512, register_history(
        300, n_procs=6, seed=21, n_values=300), False),
    "cta_s12_v16": lambda: (12, 16, register_history(
        300, n_procs=12, seed=22, n_values=4), False),
    "cta_s7_v512": lambda: (7, 512, register_history(
        300, n_procs=7, seed=23, n_values=300), False),
    # invokes at events 511 and 512, across the staged chunks
    "warp_s5_v16_across_chunk": lambda: (5, 16, register_history(
        400, n_procs=5, seed=30, n_values=5), True),
    "cta_s6_v512_across_chunk": lambda: (6, 512, register_history(
        400, n_procs=6, seed=31, n_values=300), False),
    # the multi-register model on each path: (2, 3) fills 16 states (one
    # nibble table of rows a lane: S = 5 and 7), and 32 with 16 padding
    # states that the out-of-range flag steps; (3, 5) takes 216 of 256
    "mr_warp_2x3_s5": lambda: (5, 16, _mr_events(multi_register_history(
        300, 5, 2, 3, seed=40), (2, 3)), True, (2, 3)),
    "mr_warp_2x3_s7": lambda: (7, 16, _mr_events(multi_register_history(
        200, 7, 2, 3, seed=41), (2, 3)), True, (2, 3)),
    "mr_warp_2x3_s6_v32": lambda: (6, 32, _mr_events(multi_register_history(
        200, 6, 2, 3, seed=42), (2, 3)), True, (2, 3)),
    "mr_cta_2x3_s7_v32": lambda: (7, 32, _mr_events(multi_register_history(
        200, 7, 2, 3, seed=43), (2, 3)), False, (2, 3)),
    "mr_cta_3x5_s5": lambda: (5, 256, _mr_events(corrupt_txn_reads(
        multi_register_history(300, 5, seed=44), 2, seed=1)), False,
        (3, 5)),
    "mr_cta_3x5_s9": lambda: (9, 256, _mr_events(multi_register_history(
        120, 9, seed=45)), False, (3, 5)),
    "mr_cta_3x5_v512": lambda: (6, 512, _mr_events(multi_register_history(
        200, 6, seed=46)), False, (3, 5)),
    "mr_warp_2x3_s5_across_chunk": lambda: (5, 16, _mr_events(
        multi_register_history(400, 5, 2, 3, seed=47), (2, 3)), True,
        (2, 3)),
    "mr_cta_3x5_s5_across_chunk": lambda: (5, 256, _mr_events(
        multi_register_history(400, 5, seed=48)), False, (3, 5)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DENSE_PATH_CASES))
def test_dense_kernel_paths_match_plain_on_card(cuda_device, case):
    """Each dense path bit-equal to the plain version: the warp path
    (one-word rows, V <= 32, with rows a lane x nibbles a row <= 16: 1, 2
    and 4 rows a lane, 4 and 8 nibbles) and the CTA path (V > 32, or more
    rows), with the CAS register and with the multi-register model."""
    from jepsen_tpu_torch.models import multi_register_spec
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    S, V, h, warp, *shape = DENSE_PATH_CASES[case]()
    assert fk.dense_warp_path(S, V) is warp
    step = multi_register_spec(*shape[0]).step_ids if shape else None
    ev = h[0] if shape else _events_of(h)[0]
    if shape:
        assert h[1] <= S
    if case.endswith("_across_chunk"):
        ev = _invokes_across_chunk(ev)
    ev = [torch.from_numpy(x).to(cuda_device) for x in ev]
    t0 = torch.from_numpy(_init_table(S, V)).to(cuda_device)
    got = fk.frontier_dense(*ev, t0, step_ids=step)
    work = {}
    ref = fk.frontier_dense_torch(*ev, t0, step_ids=step, work=work)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    # the path the kernel took, by its own count
    warp_returns, returns = fk.frontier_dense.paths.tolist()
    assert returns == work["returns"] > 0
    assert warp_returns == (returns if warp else 0)


SPARSE_PATH_CASES = {
    # nearly every pass on the warp path
    "warp_fresh_values": lambda: (_events_of(register_history(
        400, n_procs=5, seed=24, n_values=10 ** 9))[:2], 256, False),
    # passes of more than 64 candidates: the CTA path
    "cta_s12": lambda: ((_synthetic(200, 12, 3, seed=21, p_none=0.9), 12),
                        256, False),
    "overflow_k4": lambda: (_events_of(register_history(
        300, n_procs=5, seed=25, n_values=5))[:2], 4, False),
    "unsorted_start": lambda: ((_synthetic(200, 5, 4, seed=26,
                                           p_none=0.5), 5), 16, True),
    # invokes at events 511 and 512, across the staged chunks
    "warp_across_chunk": lambda: (_across_chunk_case(register_history(
        400, n_procs=5, seed=32, n_values=10 ** 9)), 256, False),
    # the multi-register model: lists of more than 64 pairs at S = 5, the
    # K = 256 overflow at S = 10, invokes across the chunks
    "mr_list_over_64": lambda: (_mr_events(multi_register_history(
        200, 5, seed=50)), 256, False, (3, 5)),
    "mr_overflow_s10_k256": lambda: (_mr_events(crash_late_writes(
        multi_register_history(300, 5, seed=51))), 256, False, (3, 5)),
    "mr_across_chunk": lambda: ((lambda ev: (_invokes_across_chunk(ev[0]),
                                             ev[1]))(_mr_events(
        multi_register_history(400, 5, seed=52))), 256, False, (3, 5)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SPARSE_PATH_CASES))
def test_sparse_kernel_paths_match_plain_on_card(cuda_device, case):
    """Each sparse path bit-equal to the plain version: a history that
    stays on the warp path, one whose passes exceed 64 candidates, the
    K = 4 overflow and an unsorted given list with duplicates; with the
    multi-register model, lists over 64 pairs and the K = 256 overflow
    at S = 10."""
    from jepsen_tpu_torch.models import multi_register_spec
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    (ev, S), K, unsorted, *shape = SPARSE_PATH_CASES[case]()
    step = multi_register_spec(*shape[0]).step_ids if shape else None
    m0, s0 = _unsorted_start(K, K) if unsorted else _init_frontier(K)
    work = {}
    ref = fk.frontier_sparse_torch(*(torch.from_numpy(x) for x in ev),
                                   *(torch.from_numpy(x.astype(np.int64))
                                     .to(torch.uint32) if x.dtype == np.uint32
                                     else torch.from_numpy(x)
                                     for x in (m0, s0)), S, step_ids=step,
                                   work=work)
    ev = [torch.from_numpy(x).to(cuda_device) for x in ev]
    got = fk.frontier_sparse(
        *ev, torch.from_numpy(m0.astype(np.int64)).to(cuda_device)
        .to(torch.uint32), torch.from_numpy(s0).to(cuda_device), S,
        step_ids=step)
    for x, y in zip(got, ref):
        assert torch.equal(x.cpu().to(torch.int64), y.to(torch.int64))
    # the path each pass took, by the kernel's own count
    assert fk.frontier_sparse.paths.tolist() == [work["warp_passes"],
                                                 work["passes"]]
    if case == "warp_fresh_values":
        assert work["warp_passes"] > 0.8 * work["passes"]
    if case in ("cta_s12", "mr_list_over_64"):
        assert work["warp_passes"] < work["passes"]
    if case == "mr_overflow_s10_k256":
        assert S >= 10 and bool(ref[2])
    if case == "overflow_k4":
        assert bool(ref[2])


@pytest.mark.cuda
def test_kernels_launch_from_threads_at_mixed_sizes(cuda_device):
    """Both frontier kernels launched from eight threads at once, 160
    launches a thread, each kernel at several shared-memory sizes (the
    multi-register dense table at S = 5, 6 and 9, the CAS list at K = 4,
    16 and 256), as the per-key checks of ``independent`` launch them:
    every launch succeeds and equals the same launch made alone. A
    launch that lowered a kernel's shared-memory limit to its own need
    would fail another thread's larger launch in between."""
    from concurrent.futures import ThreadPoolExecutor

    from jepsen_tpu_torch.models import multi_register_spec
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    step = multi_register_spec(3, 5).step_ids
    calls = []
    for case in ("mr_cta_3x5_s5", "mr_cta_3x5_s9", "mr_cta_3x5_v512"):
        S, V, (ev, _), _, _ = DENSE_PATH_CASES[case]()
        ev = [torch.from_numpy(x).to(cuda_device) for x in ev]
        t0 = torch.from_numpy(_init_table(S, V)).to(cuda_device)
        calls.append(functools.partial(fk.frontier_dense, *ev, t0,
                                       step_ids=step))
    ev, S, _ = SPARSE_CASES[sorted(SPARSE_CASES)[0]]()
    ev = [torch.from_numpy(x).to(cuda_device) for x in ev]
    for K in (4, 16, 256):
        m0, s0 = fk.init_frontier(K, 0, cuda_device)
        calls.append(functools.partial(fk.frontier_sparse, *ev, m0, s0, S))
    want = [[x.cpu() for x in call()] for call in calls]

    def run(t):
        out = []
        for i in range(160):
            j = (t + i) % len(calls)
            out.append((j, [x.cpu() for x in calls[j]()]))
        return out

    with ThreadPoolExecutor(max_workers=8) as pool:
        for out in pool.map(run, range(8)):
            for j, got in out:
                for x, y in zip(got, want[j]):
                    assert torch.equal(x, y)
