"""The port's Elle cycle core (jepsen_tpu_torch.ops.scc and scc_kernels)
against jepsen_tpu.ops.scc, at tolerance zero: every result is a boolean
mask, a step count or an edge list.

The same seeded numpy graphs go to the JAX functions (their ``jax.jit``
programs on the CPU) and to the port on ``device="cpu"``, where the
kernels' wrappers run their plain torch versions. Numpy replays of the two
kernels' algorithms (the stamped trim step, the Kahn peel) are held
against the plain versions. The CUDA kernels themselves run only on the
card: the ``cuda``-marked tests hold each against its plain version there.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from jepsen_tpu.ops import scc as ref_scc
from jepsen_tpu_torch.ops import scc, scc_kernels


def random_graph(n, e, seed, back=0.05):
    """A seeded graph on n nodes: mostly forward edges (acyclic), with a
    ``back`` share of edges pointing backwards (cycles)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n, e)
    b = rng.integers(0, n, e)
    fwd = rng.random(e) >= back
    src = np.where(fwd, np.minimum(a, b), np.maximum(a, b)).astype(np.int32)
    dst = np.where(fwd, np.maximum(a, b), np.minimum(a, b)).astype(np.int32)
    keep = src != dst
    return src[keep], dst[keep]


def chain(n, cycle_at_end=False):
    src = np.arange(n - 1, dtype=np.int32)
    dst = src + 1
    if cycle_at_end:
        src = np.append(src, n - 1).astype(np.int32)
        dst = np.append(dst, n - 2).astype(np.int32)
    return src, dst


# (name, n, (src, dst), max_iters)
TRIM_CASES = [
    ("random_acyclic", 200, random_graph(200, 600, 1, back=0.0), 512),
    ("random_cyclic", 200, random_graph(200, 600, 2), 512),
    ("sparse_cyclic", 300, random_graph(300, 320, 3, back=0.2), 512),
    ("duplicates", 50, (np.array([0, 0, 1, 1, 2], np.int32),
                        np.array([1, 1, 0, 2, 3], np.int32)), 512),
    ("self_loop", 70, (np.array([5, 5, 6], np.int32),
                       np.array([5, 6, 7], np.int32)), 512),
    # a chain needs about n / 2 steps: these stop at the cap
    ("chain_capped", 1200, chain(1200), 512),
    ("chain_cap_8", 40, chain(40, cycle_at_end=True), 8),
    ("chain_converges", 40, chain(40, cycle_at_end=True), 512),
]


def trim_steps_replay(n, src, dst, max_iters):
    """The reference kernel's loop in numpy, with the kernel's stamps:
    an active edge stamps its ends with the step number, and a node
    stays iff both its stamps are this step's."""
    active = np.ones(n, bool)
    stamp_in = np.zeros(n, np.int64)
    stamp_out = np.zeros(n, np.int64)
    steps, changed = 0, True
    while changed and steps < max_iters:
        stamp = steps + 1
        ea = active[src] & active[dst]
        stamp_in[dst[ea]] = stamp
        stamp_out[src[ea]] = stamp
        new = active & (stamp_in == stamp) & (stamp_out == stamp)
        changed = bool((new != active).any())
        active = new
        steps += 1
    return active, steps


@pytest.mark.parametrize("case", TRIM_CASES, ids=lambda c: c[0])
def test_trim_matches_jax(case):
    _, n, (src, dst), max_iters = case
    want = ref_scc.trim_to_cycles(n, src, dst, max_iters=max_iters)
    got = scc.trim_to_cycles(n, src, dst, max_iters=max_iters, device="cpu")
    assert got.dtype == bool and got.shape == (n,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", TRIM_CASES, ids=lambda c: c[0])
def test_trim_plain_matches_stamp_replay(case):
    _, n, (src, dst), max_iters = case
    before = scc_kernels.scc_trim.launches
    mask, steps = scc_kernels.scc_trim(
        torch.from_numpy(src), torch.from_numpy(dst),
        torch.ones(len(src), dtype=torch.bool), n, max_iters)
    assert scc_kernels.scc_trim.launches == before  # the CPU runs no kernel
    want, want_steps = trim_steps_replay(n, src, dst, max_iters)
    np.testing.assert_array_equal(mask.numpy(), want)
    assert int(steps) == want_steps
    if case[0].startswith("chain_cap"):
        assert want_steps == max_iters and want.sum() > 2


def test_trim_padding_and_has_cycle():
    src, dst = random_graph(100, 300, 4)
    for s, d in ((src, dst), chain(30)):
        assert scc.has_cycle(100, s, d, device="cpu") == \
            ref_scc.has_cycle(100, s, d)
    assert not scc.trim_to_cycles(5, np.zeros(0, np.int32),
                                  np.zeros(0, np.int32), device="cpu").any()
    with pytest.raises(ValueError):
        scc.trim_to_cycles(4, np.array([0, 4]), np.array([1, 0]),
                           device="cpu")


def random_clusters(B, V, e_per, seed, cyclic_share=0.5):
    """Seeded clusters of V local nodes: forward edges, plus one backward
    edge in about ``cyclic_share`` of the clusters (and a self-loop in
    one); rows interleaved, not sorted by cluster."""
    rng = np.random.default_rng(seed)
    cid, src, dst = [], [], []
    for b in range(B):
        a = rng.integers(0, V, e_per)
        c = rng.integers(0, V, e_per)
        lo, hi = np.minimum(a, c), np.maximum(a, c)
        keep = lo != hi
        cid += [b] * int(keep.sum())
        src += lo[keep].tolist()
        dst += hi[keep].tolist()
        if rng.random() < cyclic_share:
            cid.append(b)
            src.append(int(hi[keep][0]))
            dst.append(int(lo[keep][0]))
    cid.append(B - 1)
    src.append(0)
    dst.append(0)
    perm = rng.permutation(len(cid))
    return tuple(np.asarray(x, np.int32)[perm] for x in (cid, src, dst))


# (B, max_local, edges per cluster, seed): buckets V = 8 .. 64
SCREEN_CASES = [(5, 3, 4, 2), (12, 8, 10, 2), (9, 20, 40, 3),
                (16, 33, 60, 4), (7, 64, 150, 5), (1, 64, 400, 6)]


@pytest.mark.parametrize("case", SCREEN_CASES, ids=str)
def test_screen_matches_jax(case):
    B, V, e, seed = case
    cid, src, dst = random_clusters(B, V, e, seed)
    want = ref_scc.batch_cluster_screen(cid, src, dst, B, V)
    got = scc.batch_cluster_screen(cid, src, dst, B, V, device="cpu")
    assert got.dtype == bool and got.shape == (B,)
    np.testing.assert_array_equal(got, want)
    assert want.any() and (B == 1 or not want.all())


def test_screen_long_cycle_matches_jax():
    """A 64-node ring needs every one of the closure's squarings (and
    the Kahn peel every round); a 64-node chain beside it is acyclic."""
    ring = np.arange(64, dtype=np.int32)
    cid = np.repeat(np.asarray([0, 1], np.int32), [64, 63])
    src = np.concatenate([ring, ring[:-1]])
    dst = np.concatenate([(ring + 1) % 64, ring[1:]]).astype(np.int32)
    want = ref_scc.batch_cluster_screen(cid, src, dst, 2, 64)
    got = scc.batch_cluster_screen(cid, src, dst, 2, 64, device="cpu")
    assert got.tolist() == want.tolist() == [True, False]
    np.testing.assert_array_equal(got, kahn_replay(cid, src, dst, 2, 64))


def test_screen_chunked_over_budget(monkeypatch):
    """Past SCREEN_MAX_ELEMS the cluster axis is chunked; both packages
    under the same small limit."""
    cid, src, dst = random_clusters(21, 16, 20, 7)
    monkeypatch.setattr(ref_scc, "SCREEN_MAX_ELEMS", 16 * 16 * 4)
    monkeypatch.setattr(scc, "SCREEN_MAX_ELEMS", 16 * 16 * 4)
    before = scc_kernels.cluster_screen.launches
    want = ref_scc.batch_cluster_screen(cid, src, dst, 21, 16)
    got = scc.batch_cluster_screen(cid, src, dst, 21, 16, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert scc_kernels.cluster_screen.launches == before


def test_screen_edge_cases():
    z = np.zeros(0, np.int32)
    assert scc.batch_cluster_screen(z, z, z, 0, 4, device="cpu").shape == (0,)
    assert scc.batch_cluster_screen(z, z, z, 2, 4,
                                    device="cpu").tolist() == [False, False]
    cid = np.asarray([0, 0, 0, 1, 1, 2], np.int32)
    src = np.asarray([0, 1, 2, 0, 1, 0], np.int32)
    dst = np.asarray([1, 2, 0, 1, 2, 0], np.int32)
    assert scc.batch_cluster_screen(cid, src, dst, 3, 3,
                                    device="cpu").tolist() == [True, False,
                                                               True]
    with pytest.raises(ValueError):
        scc.batch_cluster_screen(cid, src, dst + 8, 3, 3, device="cpu")
    with pytest.raises(ValueError):
        scc.batch_cluster_screen(cid + 3, src, dst, 3, 3, device="cpu")


def kahn_replay(cid, src, dst, B, V):
    """The screen kernel's algorithm in numpy: per cluster, the edges as
    a deduplicated bit matrix, in-degrees from its set bits, then peel
    in-degree-0 nodes until none is left to peel; a cycle iff a node
    remains."""
    out = np.zeros(B, bool)
    for b in range(B):
        adj = np.zeros((V, V), bool)
        m = cid == b
        adj[src[m], dst[m]] = True
        indeg = adj.sum(axis=0)
        removed = np.zeros(V, bool)
        while True:
            peel = ~removed & (indeg == 0)
            if not peel.any():
                break
            removed |= peel
            indeg = indeg - adj[peel].sum(axis=0)
        out[b] = not removed.all()
    return out


@pytest.mark.parametrize("case", SCREEN_CASES, ids=str)
def test_screen_plain_matches_kahn_replay(case):
    B, V, e, seed = case
    cid, src, dst = random_clusters(B, V, e, seed)
    flags = scc_kernels.cluster_screen(
        *(torch.from_numpy(x) for x in (cid, src, dst)),
        torch.ones(len(cid), dtype=torch.bool), B, V)
    np.testing.assert_array_equal(flags.numpy(),
                                  kahn_replay(cid, src, dst, B, V))


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_tarjan_and_cycle_search_match_jax(seed):
    n = 60
    src, dst = random_graph(n, 150, seed, back=0.1)
    edges = list(zip(src.tolist(), dst.tolist()))
    sccs = scc.tarjan_scc(n, edges)
    assert sccs == ref_scc.tarjan_scc(n, edges) and sccs
    rng = np.random.default_rng(seed)
    typed = [(s, d, ("ww", "wr", "rw")[int(t)])
             for (s, d), t in zip(edges, rng.integers(0, 3, len(edges)))]
    for comp in sccs:
        for pref in (None, "rw"):
            assert scc.find_cycle_in_scc(comp, typed, pref) == \
                ref_scc.find_cycle_in_scc(comp, typed, pref)


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (on the card only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build with nvcc and "
                    "run on the card only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRIM_CASES, ids=lambda c: c[0])
def test_trim_kernel_matches_plain_on_card(cuda_device, case):
    _, n, (src, dst), max_iters = case
    args = [torch.from_numpy(x).to(cuda_device) for x in (src, dst)]
    valid = torch.ones(len(src), dtype=torch.bool, device=cuda_device)
    before = scc_kernels.scc_trim.launches
    got, steps = scc_kernels.scc_trim(*args, valid, n, max_iters)
    want, want_steps = scc_kernels.scc_trim_torch(*args, valid, n, max_iters)
    torch.cuda.synchronize()
    assert scc_kernels.scc_trim.launches == before + 1
    assert torch.equal(got, want) and int(steps) == int(want_steps)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCREEN_CASES + [(40, 1024, 3000, 8)],
                         ids=str)
def test_screen_kernel_matches_plain_on_card(cuda_device, case):
    B, V, e, seed = case
    cols = [torch.from_numpy(x).to(cuda_device)
            for x in random_clusters(B, V, e, seed)]
    valid = torch.ones(cols[0].numel(), dtype=torch.bool, device=cuda_device)
    before = scc_kernels.cluster_screen.launches
    got = scc_kernels.cluster_screen(*cols, valid, B, V)
    want = scc_kernels.cluster_screen_torch(*cols, valid, B, V)
    torch.cuda.synchronize()
    assert scc_kernels.cluster_screen.launches == before + 1
    assert torch.equal(got, want)
