"""The forensics kernels' plain versions (``jepsen_tpu_torch/ops/
forensics_kernels.py``) against the JAX package's
``_build_forensics_kernel`` (jepsen_tpu/ops/jitlin.py:1584), and the
kernels' steps (``csrc/forensics.cuh``) built with ``g++``.

* ``prefix_alive_torch`` against the reference's ``prefix_alive``: the
  same ``alive`` and, for every chunk c, the frontier at its entry equal
  to ``prefix[c - 1] @ v0 > 0`` — on seeded 0/1 products with identity
  chunks, a chunk that kills everything, and a ``v0`` from a carry, at
  MV = 16, 64, 256 and 1024.
* ``window_rescan_torch`` against the reference's ``vec_batch`` on the
  grids of a planted anomaly's chunk, for K = 1, 4 and 37 seeded
  pend/valid masks, with an op whose transition leaves the state range
  (oob) and a fully masked candidate: the same ``first`` and ``inexact``.
* The header's steps, walked in the kernels' order by a ``g++`` program
  (the pack of bf16 entries, the chain over 32 packed words at a time,
  the closure level by level, the kill), against the plain versions on
  seeded inputs, through the wrappers' own operand preparation.
* On the card (``cuda``), both kernels against their plain versions.

Every value is boolean: tolerance zero. The JAX package is imported
inside the CPU tests only, so the card's tests run without it."""
from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.ops import forensics_kernels as fx

HEADER = (Path(__file__).resolve().parents[1] / "jepsen_tpu_torch" / "ops"
          / "csrc" / "forensics.cuh")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _products(C, MV, seed, kill_at=None):
    """Seeded 0/1 chunk products: every third chunk the identity, the
    rest sparse (about two entries a row) with the identity's diagonal
    kept in most rows, and chunk ``kill_at`` all zero."""
    rng = np.random.default_rng(seed)
    P = (rng.random((C, MV, MV)) < 2.0 / MV).astype(np.float32)
    keep = rng.random((C, MV)) < 0.8
    idx = np.arange(MV)
    P[:, idx, idx] = np.maximum(P[:, idx, idx], keep)
    P[::3] = np.eye(MV, dtype=np.float32)
    if kill_at is not None:
        P[kill_at] = 0.0
    return P


def _v0(MV, seed, carry):
    """The initial state's one-hot vector, or a carry's column: a
    seeded 0/1 [MV, MV] product's column 0."""
    if not carry:
        v = np.zeros(MV, np.float32)
        v[0] = 1.0
        return v
    rng = np.random.default_rng(seed + 1000)
    tot0 = (rng.random((MV, MV)) < 4.0 / MV).astype(np.float32)
    tot0[0, 0] = 1.0
    return tot0[:, 0].copy()


def _ref_prefix(S, V, P, v0):
    """The reference's (alive, frontier after every chunk)."""
    import jax.numpy as jnp
    from jepsen_tpu.models import cas_register_spec
    from jepsen_tpu.ops import jitlin as rj
    C = P.shape[0]
    fk = rj._build_forensics_kernel(S, V, cas_register_spec().step_ids, 1, C)
    alive, prefix = fk.prefix_alive(jnp.asarray(P, jnp.bfloat16),
                                    jnp.asarray(v0, jnp.bfloat16))
    prefix = np.asarray(prefix, np.float32)
    after = (np.einsum("cij,j->ci", prefix, v0) > 0)
    return np.asarray(alive), after


# (S, V, C): MV = 16, 64, 256, 1024
PREFIX_SHAPES = [(1, 8, 24), (3, 8, 16), (5, 8, 12), (6, 16, 4)]


@pytest.mark.parametrize("S,V,C", PREFIX_SHAPES,
                         ids=[f"mv{(1 << s) * v}" for s, v, _ in PREFIX_SHAPES])
@pytest.mark.parametrize("case", ["live", "kill_late", "kill_first",
                                  "carry"])
def test_prefix_alive_matches_jax(S, V, C, case):
    MV = (1 << S) * V
    kill_at = {"kill_late": C - 2, "kill_first": 0}.get(case)
    P = _products(C, MV, seed=S * 7 + C, kill_at=kill_at)
    v0 = _v0(MV, S, carry=case == "carry")
    want_alive, after = _ref_prefix(S, V, P, v0)
    alive, w = fx.prefix_alive_torch(torch.from_numpy(P),
                                     torch.from_numpy(v0))
    assert np.array_equal(alive.numpy(), want_alive)
    front = fx.unpack_bits(w, MV).numpy()
    assert np.array_equal(front[0], v0 > 0)
    assert np.array_equal(front[1:], after)
    if case.startswith("kill"):
        c_star = int(np.argmax(~want_alive))
        assert c_star == kill_at and not want_alive[c_star:].any()
    # the plain version through the wrapper: CPU tensors take it
    a2, w2 = fx.prefix_alive(torch.from_numpy(P).to(torch.bfloat16),
                             torch.from_numpy(v0))
    assert torch.equal(a2, alive) and torch.equal(w2, w)


def test_pack_bits_round_trip():
    rng = np.random.default_rng(5)
    for MV in (8, 16, 32, 40, 64, 1024):
        x = torch.from_numpy(rng.random((3, MV)) < 0.3)
        w = fx.pack_bits(x)
        assert w.dtype == torch.int32 and w.shape == (3, (MV + 31) // 32)
        assert torch.equal(fx.unpack_bits(w, MV), x)
    # bit 31 of a word: the int32 holds the uint32's bits
    x = torch.zeros(32, dtype=torch.bool)
    x[31] = True
    assert fx.pack_bits(x).item() == -(1 << 31)


def _planted():
    """A concurrent register history (4 processes, 5 values: S = 4,
    V = 8, MV = 128) with two corrupted reads, encoded by both packages,
    and the reference's localization of it."""
    from jepsen_tpu.checker.linear_encode import (
        encode_register_ops as ref_enc)
    from jepsen_tpu.ops import jitlin as rj
    from jepsen_tpu_torch.histories import corrupt_reads, register_history
    h = corrupt_reads(register_history(2400, n_procs=4, seed=7, n_values=5),
                      n=2, seed=3)
    loc = rj.matrix_localize(ref_enc(h))
    assert loc is not None and loc.window_pend.shape[1] == 4
    return loc


def _masks(loc, K, seed):
    """K seeded candidates over the chunk's grids: the first keeps
    everything, one drops every return, the rest drop a fifth of the
    pending ops and of the returns."""
    rng = np.random.default_rng(seed)
    base_pend = np.asarray(loc.window_pend, bool)
    base_valid = np.asarray(loc.window_valid, bool)
    T, S = base_pend.shape
    pend = base_pend[None] & (rng.random((K, T, S)) < 0.8)
    valid = base_valid[None] & (rng.random((K, T)) < 0.8)
    pend[0], valid[0] = base_pend, base_valid
    if K > 1:
        valid[K - 1] = False
    return np.ascontiguousarray(pend), np.ascontiguousarray(valid)


def _port_tables(loc, uops):
    from jepsen_tpu_torch.models import cas_register_spec
    from jepsen_tpu_torch.ops.jitlin import _kernel_math
    V = len(np.asarray(loc.v_start)) >> loc.window_pend.shape[1]
    math = _kernel_math(loc.window_pend.shape[1], V,
                        cas_register_spec().step_ids, 1, "cpu")
    mt, oob = math.uop_tables(torch.from_numpy(np.asarray(uops, np.int32)))
    return mt.transpose(1, 2).contiguous(), oob


@pytest.mark.parametrize("K", [1, 4, 37])
@pytest.mark.parametrize("oob_op", [False, True])
def test_window_rescan_matches_jax(K, oob_op):
    loc = _planted()
    uops = np.asarray(loc.uops, np.int32).copy()
    ids = np.asarray(loc.window_ids, np.int32)
    slots = np.asarray(loc.window_slots, np.int32)
    if oob_op:
        # one pending op of the chunk becomes a write of a value id past
        # the state range: its transition leaves [0, V)
        t, s = np.argwhere(np.asarray(loc.window_pend))[3]
        V = len(np.asarray(loc.v_start)) >> ids.shape[1]
        uops[ids[t, s]] = (1, V + 2, 0)
    pend, valid = _masks(loc, K, seed=K)
    first_r, inex_r = loc.kernel.vec_batch(pend, valid, ids, uops, slots,
                                           loc.v_start)
    mtT, oob = _port_tables(loc, uops)
    v = torch.from_numpy(np.asarray(loc.v_start, np.float32))
    first, inexact = fx.window_rescan_torch(
        torch.from_numpy(pend), torch.from_numpy(valid),
        torch.from_numpy(ids), mtT, oob, torch.from_numpy(slots), v)
    assert np.array_equal(first.numpy(), np.asarray(first_r))
    assert np.array_equal(inexact.numpy(), np.asarray(inex_r))
    if not oob_op:
        assert int(first[0]) == loc.step      # keep-all: the anomaly
    if K > 1:
        assert int(first[K - 1]) == -1        # every return masked
    assert bool(inexact.any()) is oob_op
    got = fx.window_rescan(torch.from_numpy(pend), torch.from_numpy(valid),
                           torch.from_numpy(ids), mtT, oob,
                           torch.from_numpy(slots), v)
    assert torch.equal(got[0], first) and torch.equal(got[1], inexact)


# ---------------------------------------------------------------------------
# the header, built with g++
# ---------------------------------------------------------------------------

HARNESS_CPP = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "forensics.cuh"

// stdin: a mode, then
//   0 (prefix_alive): C MV, the C*MV*MV bf16 bit patterns, the W words
//     of v0; stdout: alive[C], then the (C + 1) * W frontier words;
//   1 (window_rescan): K T S V U, pm[K*T], rs[K*T], ids[T*S], nxt[U*V],
//     oob[U], v[M]; stdout: first[k] inexact[k] a line.
// Each walks its kernel's steps in the kernel's order.
static long long num() {
  long long v;
  if (std::scanf("%lld", &v) != 1) std::exit(2);
  return v;
}
static void prefix() {
  const int C = num(), MV = num();
  const int W = MV >= 32 ? MV / 32 : 1;
  const int n = MV * W;
  std::vector<uint16_t> P((size_t)C * MV * MV);
  for (auto& x : P) x = (uint16_t)num();
  std::vector<uint32_t> w(W), out((size_t)(C + 1) * W, 0u);
  for (auto& x : w) x = (uint32_t)num();
  // the pack: bit j % 32 of word j / 32 of row i
  std::vector<uint32_t> pk((size_t)C * n, 0u);
  for (int c = 0; c < C; ++c)
    for (int i = 0; i < MV; ++i)
      for (int j = 0; j < MV; ++j)
        if (fx_bf16_pos(P[((size_t)c * MV + i) * MV + j]))
          pk[(size_t)c * n + i * W + j / 32] |= 1u << (j % 32);
  std::vector<int> alive(C, 0);
  for (int j = 0; j < W; ++j) out[j] = w[j];
  for (int c = 0; c < C; ++c) {
    std::vector<uint32_t> nw(W, 0u);
    for (int q0 = 0; q0 < n; q0 += 32) {  // one warp's 32 words
      uint32_t hits = 0;
      for (int lane = 0; lane < 32; ++lane) {
        const int q = q0 + lane;
        if (q < n && w[q & (W - 1)] != 0 &&
            fx_hit(pk[(size_t)c * n + q], w.data(), q, W))
          hits |= 1u << lane;
      }
      if (hits) {
        const int row0 = q0 / W;
        nw[row0 >> 5] |= fx_segment_bits(hits, W) << (row0 & 31);
      }
    }
    int any = 0;
    for (int j = 0; j < W; ++j) {
      w[j] = nw[j];
      out[(size_t)(c + 1) * W + j] = nw[j];
      any |= nw[j] != 0;
    }
    alive[c] = any;
    if (!any) break;
  }
  for (int c = 0; c < C; ++c) std::printf("%d ", alive[c]);
  std::printf("\n");
  for (auto x : out) std::printf("%u ", x);
  std::printf("\n");
}
static void rescan() {
  const int K = num(), T = num(), S = num(), V = num(), U = num();
  const int M = 1 << S;
  std::vector<uint32_t> pm((size_t)K * T), nxt((size_t)U * V), v(M);
  std::vector<int> rs((size_t)K * T), ids((size_t)T * S), oob(U);
  for (auto& x : pm) x = (uint32_t)num();
  for (auto& x : rs) x = (int)num();
  for (auto& x : ids) x = (int)num();
  for (auto& x : nxt) x = (uint32_t)num();
  for (auto& x : oob) x = (int)num();
  for (auto& x : v) x = (uint32_t)num();
  for (int k = 0; k < K; ++k) {
    std::vector<uint32_t> set(v), op_nxt((size_t)S * V);
    int any = 0;
    for (int m = 0; m < M; ++m) any |= set[m] != 0;
    int dead_at = any ? -1 : 0;
    int inex = 0;
    for (int t = 0; t < T; ++t) {
      const uint32_t p = pm[(size_t)k * T + t];
      const int r = rs[(size_t)k * T + t];
      for (int s = 0; s < S; ++s)
        if (((p >> s) & 1u) && oob[ids[t * S + s]]) inex = 1;
      if (r < 0 || dead_at >= 0) continue;
      for (int q = 0; q < S * V; ++q) {
        const int s = q / V;
        op_nxt[q] = ((p >> s) & 1u) ? nxt[(size_t)ids[t * S + s] * V + q - s * V]
                                    : 0u;
      }
      for (int l = 1; l <= S; ++l)
        for (int m = 0; m < M; ++m)
          if (fx_popc((uint32_t)m) == l && ((uint32_t)m & p))
            set[m] = fx_close(set.data(), m, p, op_nxt.data(), V);
      std::vector<uint32_t> nv(M);
      any = 0;
      for (int m = 0; m < M; ++m) {
        nv[m] = fx_kill(set.data(), m, r);
        any |= nv[m] != 0;
      }
      set = nv;
      if (!any) dead_at = t;
    }
    std::printf("%d %d\n", dead_at, inex);
  }
}
int main() {
  if (num() == 0)
    prefix();
  else
    rescan();
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """The header built by g++ (CUDA's qualifiers defined away) into a
    program that walks both kernels' steps."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    d = tmp_path_factory.mktemp("forensics")
    (d / "harness.cpp").write_text(HARNESS_CPP)
    exe = d / "harness"
    subprocess.run(["g++", "-std=c++17", "-O2", "-Wall", "-Werror",
                    "-D__device__=", "-D__forceinline__=inline", "-I",
                    str(HEADER.parent), "-o", str(exe),
                    str(d / "harness.cpp")], check=True,
                   capture_output=True, text=True)
    return exe


def _run(exe, parts):
    out = subprocess.run([str(exe)], input="\n".join(parts) + "\n",
                         capture_output=True, text=True, check=True)
    return out.stdout.splitlines()


def _u32(t: torch.Tensor) -> str:
    return " ".join(str(int(x) & 0xFFFFFFFF) for x in t.reshape(-1).tolist())


# (C, MV, seed): one word below MV = 32, rows of 2 and 16 words, a row
# over two warps' words at MV = 2048
HARNESS_PREFIX = [(9, 8, 1), (7, 16, 2), (12, 64, 3), (6, 512, 4),
                  (3, 2048, 5)]


@pytest.mark.parametrize("C,MV,seed", HARNESS_PREFIX,
                         ids=[f"mv{c[1]}" for c in HARNESS_PREFIX])
@pytest.mark.parametrize("kill", [False, True])
def test_prefix_header_matches_plain(harness, C, MV, seed, kill):
    """The pack (bf16 entries: negative, zero, -0 and NaN count as 0)
    and the chain, against prefix_alive_torch."""
    P = torch.from_numpy(_products(C, MV, seed, C // 2 if kill else None))
    rng = np.random.default_rng(seed)
    noise = torch.from_numpy(rng.choice(
        np.array([-1.0, -0.0, np.nan, 0.5], np.float32), (C, MV, MV)))
    Pb = torch.where(torch.from_numpy(rng.random((C, MV, MV)) < 0.05),
                     noise, P * torch.from_numpy(rng.choice(
                         np.array([1.0, 3.0], np.float32), (C, MV, MV))))
    if kill:
        # the dead chunk holds no positive entry, but -1, -0 and NaN
        Pb[C // 2] = torch.from_numpy(rng.choice(
            np.array([-1.0, -0.0, np.nan, 0.0], np.float32), (MV, MV)))
    Pb = Pb.to(torch.bfloat16)
    v0 = torch.from_numpy(_v0(MV, seed, carry=True))
    lines = _run(harness, ["0", f"{C} {MV}",
                           " ".join(str(int(x) & 0xFFFF) for x in
                                    Pb.view(torch.int16).reshape(-1).tolist()),
                           _u32(fx.pack_bits(v0))])
    alive, w = fx.prefix_alive_torch(Pb, v0)
    assert [int(x) for x in lines[0].split()] == alive.to(torch.int32).tolist()
    assert [int(x) for x in lines[1].split()] == [
        int(x) & 0xFFFFFFFF for x in w.reshape(-1).tolist()]
    assert bool(alive.all()) is not kill


def _random_rescan(K, T, S, V, U, seed):
    """Seeded window_rescan inputs of any (S, V): sparse random
    transitions (a few oob ops), pending sets, returning slots among the
    pending, a fifth of the returns invalid, a start of a few
    configurations."""
    rng = np.random.default_rng(seed)
    MV = (1 << S) * V
    mtT = torch.from_numpy((rng.random((U, V, V)) < 1.5 / V).astype(
        np.float32))
    oob = torch.from_numpy(rng.random(U) < 0.1)
    pend = rng.random((K, T, S)) < 0.6
    slots = rng.integers(0, S, T).astype(np.int32)
    pend[:, np.arange(T), slots] = True
    valid = rng.random((K, T)) < 0.8
    ids = rng.integers(0, U, (T, S)).astype(np.int32)
    v = np.zeros(MV, np.float32)
    v[rng.choice(MV, size=max(1, MV // 16), replace=False)] = 1.0
    v[rng.integers(V)] = 1.0   # mask 0, a state
    return (torch.from_numpy(pend), torch.from_numpy(valid),
            torch.from_numpy(ids), mtT, oob, torch.from_numpy(slots),
            torch.from_numpy(v))


# (K, T, S, V, U, seed)
HARNESS_RESCAN = [(3, 16, 1, 8, 8, 1), (4, 24, 3, 5, 16, 2),
                  (5, 12, 5, 16, 16, 3), (3, 8, 8, 2, 4, 4),
                  (2, 10, 2, 32, 8, 5), (6, 32, 4, 8, 32, 6)]


@pytest.mark.parametrize("K,T,S,V,U,seed", HARNESS_RESCAN,
                         ids=[f"s{c[2]}v{c[3]}" for c in HARNESS_RESCAN])
def test_rescan_header_matches_plain(harness, K, T, S, V, U, seed):
    """The closure level by level and the kill, on the operands the
    wrapper derives (rescan_operands), against window_rescan_torch."""
    args = _random_rescan(K, T, S, V, U, seed)
    pm, rs, ids, nxt, oob, vset = fx.rescan_operands(*args)
    lines = _run(harness, ["1", f"{K} {T} {S} {V} {U}", _u32(pm),
                           " ".join(map(str, rs.reshape(-1).tolist())),
                           " ".join(map(str, ids.reshape(-1).tolist())),
                           _u32(nxt), " ".join(map(str, oob.tolist())),
                           _u32(vset)])
    first, inexact = fx.window_rescan_torch(*args)
    got = np.array([[int(x) for x in ln.split()] for ln in lines])
    assert np.array_equal(got[:, 0], first.numpy())
    assert np.array_equal(got[:, 1], inexact.numpy().astype(int))


def test_rescan_header_empty_start(harness):
    """A start with no configuration is dead before the first return,
    whatever the returns are (the reference's first = 0)."""
    args = list(_random_rescan(3, 6, 2, 8, 4, 9))
    args[6] = torch.zeros_like(args[6])
    args[1][:, 0] = False   # the first return masked out
    first, _ = fx.window_rescan_torch(*args)
    assert first.tolist() == [0, 0, 0]
    pm, rs, ids, nxt, oob, vset = fx.rescan_operands(*args)
    lines = _run(harness, ["1", "3 6 2 8 4", _u32(pm),
                           " ".join(map(str, rs.reshape(-1).tolist())),
                           " ".join(map(str, ids.reshape(-1).tolist())),
                           _u32(nxt), " ".join(map(str, oob.tolist())),
                           _u32(vset)])
    assert [int(ln.split()[0]) for ln in lines] == [0, 0, 0]


# ---------------------------------------------------------------------------
# the wrappers' checks
# ---------------------------------------------------------------------------

def test_wrappers_refuse_other_devices():
    P = torch.zeros((2, 16, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fx.prefix_alive(P, torch.zeros(16, device="meta"))
    args = [a.to("meta") for a in _random_rescan(2, 4, 2, 4, 4, 1)]
    with pytest.raises(ValueError, match="unsupported device"):
        fx.window_rescan(*args)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The CUDA device; skips where there is none (decided here, never
    at import, so every test worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("C,MV", [(256, 256), (256, 512), (16, 1024),
                                  (16, 4096), (9, 8), (7, 16)])
@pytest.mark.parametrize("kill", [None, 0, -1])
def test_prefix_alive_kernel_on_card(cuda_device, C, MV, kill):
    P = torch.from_numpy(_products(
        C, MV, MV + C, None if kill is None else kill % C))
    P = P.to(torch.bfloat16).to(cuda_device)
    v0 = torch.from_numpy(_v0(MV, 3, carry=True)).to(cuda_device)
    n = fx.prefix_alive.launches
    got = fx.prefix_alive(P, v0)
    assert fx.prefix_alive.launches == n + 1
    want = fx.prefix_alive_torch(P, v0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("K,T,S,V,U,seed", HARNESS_RESCAN + [
    (128, 64, 5, 8, 64, 7), (16, 16, 8, 16, 32, 8)])
def test_window_rescan_kernel_on_card(cuda_device, K, T, S, V, U, seed):
    args = [a.to(cuda_device) for a in _random_rescan(K, T, S, V, U, seed)]
    n = fx.window_rescan.launches
    got = fx.window_rescan(*args)
    assert fx.window_rescan.launches == n + 1
    want = fx.window_rescan_torch(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
