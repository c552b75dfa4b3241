"""The edge-sharded trim's round (``ops/scc_kernels.py``
``trim_partial_degrees`` and ``trim_update``, ``csrc/trim_degrees.cu``)
and its two routes (``ops/scc.py``): the plain versions' accumulate-and-
zero contracts against a numpy replay of the reference's rounds on the
CPU, flag slots and packed mask included; the one-call peel
(``scc_kernels.scc_trim``) against the reference's rounds at every cap
from 0 to the uncapped round count, and 512, on seeded graphs with long
chains, self-loops, duplicate edges and weight-0 padding (E a multiple of
4 and not): the identity that lets a one-card mesh peel in one call; and
(``cuda``-marked, on the card) both C entries against their plain
versions, bit-equal, with both routes on ``Mesh([cuda] * 3)`` against the
same on ``Mesh(["cpu"] * 3)``. The rounds also run on a mesh of distinct
devices (``Mesh(["cpu", "cpu:0"] * 2)``; on the card ``Mesh([cuda:0,
cuda] * 2)``, two entries of one card that the rounds keep apart), with
and without a reduce. The file imports no JAX, so the card's lane
collects it where JAX is missing (tests/test_torch_mesh.py holds the same
identity against the JAX package)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.ops import scc_kernels as sk

# (nodes, edges, share of weight-0 padding edges, share of active nodes)
CASES = [(1, 0, 0.0, 1.0), (7, 5, 0.0, 1.0), (97, 513, 0.1, 0.8),
         (4096, 20_000, 0.0, 0.5), (1 << 19, 1 << 18, 0.05, 0.9)]
# (seed, nodes, chain length, random edges, edge count mod 4)
GRAPHS = [(1, 150, 18, 120, 0), (2, 150, 18, 121, 1), (3, 200, 24, 260, 2),
          (4, 90, 30, 40, 3), (5, 300, 12, 500, 0), (6, 64, 20, 0, 1)]


def _inputs(n, E, pad, share, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, E).astype(np.int32)
    dst = rng.integers(0, n, E).astype(np.int32)
    if E:
        src[::7] = dst[::7]          # self-loops
    w = (rng.random(E) >= pad).astype(np.int32)
    active = rng.random(n) < share
    return src, dst, w, active


def _replay(src, dst, w, active, n):
    """The round as the reference computes it, edge by edge."""
    deg = np.zeros((2, n), np.int64)
    for s, d, we in zip(src, dst, w):
        if we and active[s] and active[d]:
            deg[0, d] += we
            deg[1, s] += we
    new = active & (deg[0] > 0) & (deg[1] > 0)
    return deg, new


def _packed(active):
    n = len(active)
    bits = np.zeros(((n + 31) // 32) * 32, np.uint64)
    bits[:n] = active
    words = (bits.reshape(-1, 32) << np.arange(32, dtype=np.uint64)).sum(1)
    return words.astype(np.uint32).view(np.int32)


def trim_graph(seed, n, chain, extra, mod):
    """A seeded graph: a 5-cycle with a chain of ``chain`` nodes running
    into it and another leaving it, a self-loop fed by a chain, duplicate
    edges, ``extra`` random edges among the other nodes; trimmed so
    E % 4 == mod."""
    rng = np.random.default_rng(seed)
    src, dst = [0, 1, 2, 3, 4], [1, 2, 3, 4, 0]
    into = list(range(5, 5 + chain))
    src += into
    dst += into[1:] + [0]
    out = list(range(5 + chain, 5 + 2 * chain))
    src += [2] + out[:-1]
    dst += out
    loop = 5 + 2 * chain
    src += [loop, loop - 1, loop]
    dst += [loop, loop, loop]
    src += list(rng.integers(loop + 1, n, extra))
    dst += list(rng.integers(loop + 1, n, extra))
    dup = rng.integers(0, len(src), 8)
    src += [src[i] for i in dup]
    dst += [dst[i] for i in dup]
    E = len(src) - (len(src) - mod) % 4
    return (n, np.asarray(src[:E], np.int32), np.asarray(dst[:E], np.int32))


def reference_rounds(n, src, dst, max_iters):
    """The reference's sharded rounds (jepsen_tpu/ops/scc.py:160-184) in
    numpy: (mask, rounds)."""
    active = np.ones(n, bool)
    it, changed = 0, True
    while changed and it < max_iters:
        live = active[src] & active[dst]
        indeg = np.bincount(dst[live], minlength=n)
        outdeg = np.bincount(src[live], minlength=n)
        new = active & (indeg > 0) & (outdeg > 0)
        changed = bool((new != active).any())
        active = new
        it += 1
    return active, it


def caps_of(graph):
    """Every cap from 0 to the graph's uncapped round count, and 512."""
    n, src, dst = graph
    return list(range(reference_rounds(n, src, dst, 512)[1] + 1)) + [512]


def _shards(src, dst, nd, device="cpu"):
    E = len(src)
    z = np.zeros((-E) % nd, np.int32)
    cols = [np.concatenate([np.asarray(c, np.int32), z])
            for c in (src, dst, np.ones(E, np.int32))]
    return [[torch.from_numpy(b.copy()).to(device) for b in np.split(c, nd)]
            for c in cols]


@pytest.mark.parametrize("case", CASES[:4])
def test_plain_round_matches_replay(case):
    """Three rounds of the plain versions on one mask: two shards add into
    one row pair (nothing zeroed between them), the update zeroes it,
    rewrites the packed copy and sets the round's flag slot and clears
    the other."""
    n, E, pad, share = case
    src, dst, w, active = _inputs(n, E, pad, share, seed=n + E)
    half = E // 2
    act = torch.from_numpy(active.copy())
    bits = torch.from_numpy(_packed(active))
    deg = torch.zeros((2, n), dtype=torch.int32)
    flags = torch.tensor([0, 7], dtype=torch.int32)
    want_act = active.copy()
    for r in range(3):
        for lo, hi in ((0, half), (half, E)):
            out = sk.trim_partial_degrees(
                *(torch.from_numpy(x[lo:hi].copy()) for x in (src, dst, w)),
                act, bits, deg)
            assert out is deg
        want_deg, want_new = _replay(src, dst, w, want_act, n)
        np.testing.assert_array_equal(deg.numpy(), want_deg)
        slot = r % 2
        flag = sk.trim_update(deg, None, act, bits, flags, slot)
        changed = int((want_new != want_act).any())
        assert flag.tolist() == [changed]
        assert flags.tolist()[1 - slot] == 0
        np.testing.assert_array_equal(act.numpy(), want_new)
        np.testing.assert_array_equal(bits.numpy(), _packed(want_new))
        assert not deg.any()
        flags[slot] = 0
        want_act = want_new


@pytest.mark.parametrize("k", [1, 3])
def test_plain_update_adds_other_devices_rows(k):
    """``trim_update`` with ``others``: the first device's rows plus k
    other row pairs decide the mask, as one pass over all the edges."""
    n, E = 97, 600
    src, dst, w, active = _inputs(n, E, 0.1, 0.8, seed=k)
    cuts = np.linspace(0, E, k + 2).astype(int)
    rows = []
    act = torch.from_numpy(active.copy())
    bits = torch.from_numpy(_packed(active))
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        rows.append(sk.trim_partial_degrees(
            *(torch.from_numpy(x[lo:hi].copy()) for x in (src, dst, w)),
            act, bits, torch.zeros((2, n), dtype=torch.int32)))
    others = torch.stack(rows[1:])
    kept = others.clone()
    flags = torch.zeros(2, dtype=torch.int32)
    flag = sk.trim_update(rows[0], others, act, bits, flags, 1)
    _, want = _replay(src, dst, w, active, n)
    np.testing.assert_array_equal(act.numpy(), want)
    assert flag.tolist() == [int((want != active).any())]
    assert not rows[0].any() and torch.equal(others, kept)


def test_pack_mask_matches_numpy():
    rng = np.random.default_rng(0)
    for n in (1, 31, 32, 33, 1000):
        a = rng.random(n) < 0.5
        np.testing.assert_array_equal(
            sk.pack_mask(torch.from_numpy(a)).numpy(), _packed(a))


@pytest.mark.parametrize("graph", GRAPHS)
def test_one_call_peel_equals_rounds_at_every_cap(graph):
    """``scc_trim``'s plain version (the peel a one-card mesh runs) and the
    sharded rounds (``trim_rounds`` on ``Mesh(["cpu"] * 4)``, weight-0
    padding when E % 4 != 0) against the reference's rounds in numpy: the
    same mask at every cap from 0 to the uncapped round count and at 512,
    and ``scc_trim``'s step count equal to the rounds run."""
    from jepsen_tpu_torch.ops.scc import trim_rounds
    from jepsen_tpu_torch.parallel import Mesh
    n, src, dst = trim_graph(*graph)
    assert len(src) % 4 == graph[4]
    caps = caps_of((n, src, dst))
    assert len(caps) > graph[2]
    cols = [torch.from_numpy(x) for x in (src, dst)]
    valid = torch.ones(len(src), dtype=torch.bool)
    shards = _shards(src, dst, 4)
    for cap in caps:
        want, rounds = reference_rounds(n, src, dst, cap)
        mask, steps = sk.scc_trim_torch(*cols, valid, n, cap)
        np.testing.assert_array_equal(mask.numpy(), want, err_msg=str(cap))
        assert int(steps) == rounds
        got = trim_rounds(Mesh(["cpu"] * 4), n, *shards, max_iters=cap)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(cap))
    # the chains peel and the cycle and the self-loop stay
    full = reference_rounds(n, src, dst, 512)[0]
    loop = 5 + 2 * graph[2]
    assert full[:5].all() and full[loop]


@pytest.mark.parametrize("width", [1, 4])
def test_routes_on_cpu_meshes(width):
    """``run_sharded_trim`` on a one-card CPU mesh (one ``scc_trim`` call)
    and with a ``reduce`` (the rounds) give the same mask at caps 0, 2, 7
    and 512."""
    from jepsen_tpu_torch.ops.scc import run_sharded_trim
    from jepsen_tpu_torch.parallel import Mesh
    n, src, dst = trim_graph(*GRAPHS[1])
    mesh = Mesh(["cpu"] * width)
    shards = _shards(src, dst, width)
    seen = []
    for cap in (0, 2, 7, 512):
        want = reference_rounds(n, src, dst, cap)[0]
        one = run_sharded_trim(mesh, n, *shards, max_iters=cap)
        rounds = run_sharded_trim(mesh, n, *shards, max_iters=cap,
                                  reduce=seen.append)
        np.testing.assert_array_equal(one.numpy(), want)
        np.testing.assert_array_equal(rounds.numpy(), want)
    assert len(seen) == sum(min(c, reference_rounds(n, src, dst, 512)[1])
                            for c in (0, 2, 7, 512))


@pytest.mark.parametrize("reduce", [False, True])
@pytest.mark.parametrize("graph", GRAPHS[2:4])
def test_distinct_device_rounds_at_every_cap(graph, reduce, monkeypatch):
    """``trim_rounds`` on a mesh of distinct devices, ``Mesh(["cpu",
    "cpu:0"] * 2)``, against the reference's rounds in numpy at every cap
    from 0 to the uncapped round count and at 512: without a reduce the
    ``cpu:0`` rows reach the update staged (its ``others``), with one
    they join the first device's rows before it (``others`` None) and the
    reduce runs once a round."""
    from jepsen_tpu_torch.ops.scc import trim_rounds
    from jepsen_tpu_torch.parallel import Mesh
    n, src, dst = trim_graph(*graph)
    shards = _shards(src, dst, 4)
    mesh = Mesh(["cpu", "cpu:0"] * 2)
    staged = []
    launcher = sk.update_launcher

    def spy(deg, others, *rest):
        staged.append(None if others is None else tuple(others.shape))
        return launcher(deg, others, *rest)
    monkeypatch.setattr(sk, "update_launcher", spy)
    for cap in caps_of((n, src, dst)):
        want, rounds = reference_rounds(n, src, dst, cap)
        seen = []
        got = trim_rounds(mesh, n, *shards, max_iters=cap,
                          reduce=seen.append if reduce else None)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(cap))
        assert len(seen) == (rounds if reduce else 0)
    assert set(staged) == {None if reduce else (1, 2, n)}


@pytest.fixture
def cuda_device():
    """The CUDA device; skips where there is none (decided here, never
    at import, so every test worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernel_round_matches_plain_on_card(cuda_device, case):
    """Both C entries against their plain versions over three rounds: two
    shards accumulate, then the update with one other device's rows, the
    flag slots alternating; one launch a call."""
    n, E, pad, share = case
    src, dst, w, active = _inputs(n, E, pad, share, seed=n + E)
    cols = [torch.from_numpy(x).to(cuda_device) for x in (src, dst, w)]
    half = E // 2
    state = {}
    for where in ("kernel", "plain"):
        act = torch.from_numpy(active.copy()).to(cuda_device)
        state[where] = (act, sk.pack_mask(act),
                        torch.zeros((2, n), dtype=torch.int32,
                                    device=cuda_device),
                        torch.zeros((1, 2, n), dtype=torch.int32,
                                    device=cuda_device),
                        torch.zeros(2, dtype=torch.int32, device=cuda_device))
    for r in range(3):
        got = {}
        for where, part, update in (
                ("kernel", sk.trim_partial_degrees, sk.trim_update),
                ("plain", sk.trim_partial_degrees_torch,
                 sk.trim_update_torch)):
            act, bits, deg, other, flags = state[where]
            before = (sk.trim_partial_degrees.launches,
                      sk.trim_update.launches)
            other.zero_()
            part(*(c[:half] for c in cols), act, bits, deg)
            part(*(c[half:] for c in cols), act, bits, other[0])
            part(*(c[half:] for c in cols), act, bits, deg)
            sums = deg.clone()
            flag = update(deg, other, act, bits, flags, r % 2)
            if where == "kernel":
                assert (sk.trim_partial_degrees.launches,
                        sk.trim_update.launches) == (before[0] + 3,
                                                     before[1] + 1)
            got[where] = (sums, act.clone(), bits.clone(), deg.clone(),
                          flags.clone(), flag.clone())
        for a, b in zip(got["kernel"], got["plain"]):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_sharded_trim_on_card_matches_cpu_mesh(cuda_device):
    """Both routes on the card against the CPU mesh: the one-card route
    of ``trim_to_cycles_sharded`` and ``run_sharded_trim`` (one
    ``scc_trim`` launch, no round launch) and ``trim_rounds`` (one partial
    launch a shard and one update a round)."""
    from jepsen_tpu_torch.ops.scc import (
        run_sharded_trim, trim_rounds, trim_to_cycles_sharded)
    from jepsen_tpu_torch.parallel import Mesh
    rng = np.random.default_rng(3)
    n = 5000
    src = rng.integers(0, n, 12_001)
    dst = rng.integers(0, n, 12_001)
    mesh = Mesh([cuda_device] * 3)
    shards = _shards(src, dst, 3, cuda_device)
    for cap in (512, 4):
        want = trim_to_cycles_sharded(n, src, dst, Mesh(["cpu"] * 3),
                                      max_iters=cap)
        before = (sk.scc_trim.launches, sk.trim_partial_degrees.launches,
                  sk.trim_update.launches)
        got = trim_to_cycles_sharded(n, src, dst, mesh, max_iters=cap)
        np.testing.assert_array_equal(got, want)
        got = run_sharded_trim(mesh, n, *shards, max_iters=cap)
        np.testing.assert_array_equal(got.cpu().numpy(), want)
        assert (sk.scc_trim.launches, sk.trim_partial_degrees.launches,
                sk.trim_update.launches) == (before[0] + 2, before[1],
                                             before[2])
        got = trim_rounds(mesh, n, *shards, max_iters=cap)
        np.testing.assert_array_equal(got.cpu().numpy(), want)
        rounds = reference_rounds(n, np.asarray(src), np.asarray(dst),
                                  cap)[1]
        assert sk.trim_partial_degrees.launches == before[1] + 3 * rounds
        assert sk.trim_update.launches == before[2] + rounds


@pytest.mark.cuda
@pytest.mark.parametrize("reduce", [False, True])
def test_distinct_device_rounds_on_card(cuda_device, reduce):
    """``trim_rounds`` on ``Mesh([cuda:0, cuda] * 2)``: ``cuda`` and
    ``cuda:0`` are distinct devices to the rounds, so the ``cuda`` shards
    add into their own rows, staged on the first device each round and
    added by the update's kernel (or, with a reduce, before it); the mask
    against the reference's rounds at caps 0, 3 and 512, with one partial
    launch a shard and one update a round."""
    from jepsen_tpu_torch.ops.scc import trim_rounds
    from jepsen_tpu_torch.parallel import Mesh
    first = torch.device("cuda", torch.cuda.current_device())
    mesh = Mesh([first, cuda_device] * 2)
    rng = np.random.default_rng(5)
    n = 5000
    src = rng.integers(0, n, 12_002).astype(np.int32)
    dst = rng.integers(0, n, 12_002).astype(np.int32)
    shards = _shards(src, dst, 4, cuda_device)
    for cap in (0, 3, 512):
        want, rounds = reference_rounds(n, src, dst, cap)
        before = (sk.trim_partial_degrees.launches, sk.trim_update.launches)
        seen = []
        got = trim_rounds(mesh, n, *shards, max_iters=cap,
                          reduce=seen.append if reduce else None)
        np.testing.assert_array_equal(got.cpu().numpy(), want)
        assert (sk.trim_partial_degrees.launches - before[0],
                sk.trim_update.launches - before[1]) == (4 * rounds, rounds)
        assert len(seen) == (rounds if reduce else 0)
