"""The edge-sharded trim's round (``ops/scc_kernels.py``
``trim_partial_degrees`` and ``trim_update``, ``csrc/trim_degrees.cu``):
the plain versions against a numpy replay of the round on the CPU, and
(``cuda``-marked, on the card) the kernel against its plain version,
bit-equal, with the sharded trim on ``Mesh([cuda] * 3)`` against the same
on ``Mesh(["cpu"] * 3)``. The file imports no JAX, so the card's lane
collects it where JAX is missing."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.ops import scc_kernels as sk

# (nodes, edges, share of weight-0 padding edges, share of active nodes)
CASES = [(1, 0, 0.0, 1.0), (7, 5, 0.0, 1.0), (97, 513, 0.1, 0.8),
         (4096, 20_000, 0.0, 0.5), (1 << 19, 1 << 18, 0.05, 0.9)]


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


@pytest.mark.parametrize("case", CASES[:4])
def test_plain_round_matches_replay(case):
    n, E, pad, share = case
    src, dst, w, active = _inputs(n, E, pad, share, seed=n + E)
    deg = sk.trim_partial_degrees(
        *(torch.from_numpy(x) for x in (src, dst, w, active)), n)
    want_deg, want_new = _replay(src, dst, w, active, n)
    np.testing.assert_array_equal(deg.numpy(), want_deg)
    act = torch.from_numpy(active.copy())
    changed = sk.trim_update(deg, act)
    np.testing.assert_array_equal(act.numpy(), want_new)
    assert changed.tolist() == [int((want_new != active).any())]


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
    n, E, pad, share = case
    cols = [torch.from_numpy(x).to(cuda_device)
            for x in _inputs(n, E, pad, share, seed=n + E)]
    before = sk.trim_partial_degrees.launches
    deg = sk.trim_partial_degrees(*cols, n)
    ref = sk.trim_partial_degrees_torch(*cols, n)
    assert sk.trim_partial_degrees.launches == before + 1
    assert torch.equal(deg, ref)
    a1, a2 = cols[3].clone(), cols[3].clone()
    c1, c2 = sk.trim_update(deg, a1), sk.trim_update_torch(ref, a2)
    assert torch.equal(a1, a2) and c1.tolist() == c2.tolist()


@pytest.mark.cuda
def test_sharded_trim_on_card_matches_cpu_mesh(cuda_device):
    from jepsen_tpu_torch.ops.scc import trim_to_cycles_sharded
    from jepsen_tpu_torch.parallel import Mesh
    rng = np.random.default_rng(3)
    n = 5000
    src = rng.integers(0, n, 12_001)
    dst = rng.integers(0, n, 12_001)
    for cap in (512, 4):
        got = trim_to_cycles_sharded(n, src, dst, Mesh([cuda_device] * 3),
                                     max_iters=cap)
        want = trim_to_cycles_sharded(n, src, dst, Mesh(["cpu"] * 3),
                                      max_iters=cap)
        np.testing.assert_array_equal(got, want)
