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

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.histories import corrupt_reads, register_history

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


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_matches_jax_and_replay(case):
    ev, S, V = DENSE_CASES[case]()
    t0 = _init_table(S, V)
    ref = _jax_dense(ev, t0)
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
    ref = fk.frontier_dense_torch(*ev, t0)
    assert fk.frontier_dense.launches == n + 1
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


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
    ref = fk.frontier_sparse_torch(*ev, m0, s0, S)
    assert fk.frontier_sparse.launches == n + 1
    for x, y in zip(got, ref):
        assert torch.equal(x.to(torch.int64), y.to(torch.int64))
