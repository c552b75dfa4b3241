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
    V = len(loc.v_start) >> loc.window_pend.shape[1]
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
//   0 (the transposed pack): C MV, the C*MV*MV bf16 bit patterns;
//     stdout: the C*MV*W words of packedT;
//   2 (the cluster chain, MV >= 1024): C MV nc threads, the C*MV*W
//     words of packedT, the W words of v0; stdout: alive[C], then the
//     (C + 1) * W frontier words;
//   1 (window_rescan): K T S V U shared, pend[K*T*S], valid[K*T],
//     ids[T*S], slots[T], nxt[U*V], oob[U], vw[ceil(2^S V / 32)];
//     stdout: first[k] inexact[k] a line (shared = 1 takes the
//     shared-memory path at any S);
//   3 (a return's masks): K T S, pend[K*T*S], valid[K*T], slots[T];
//     stdout: pm rs ok a line for each (k, t);
//   4 (the one-warp chain): C MV, packedT and v0 as in mode 2; stdout
//     as mode 2.
// Each walks its kernel's steps in the kernel's order: a warp's 32
// lanes, its shuffles and ballots as loops over lanes.
static long long num() {
  long long v;
  if (std::scanf("%lld", &v) != 1) std::exit(2);
  return v;
}
static int words(int MV) { return MV >= 32 ? MV / 32 : 1; }

static void pack() {
  const int C = num(), MV = num(), W = words(MV);
  std::vector<uint16_t> P((size_t)C * MV * MV);
  for (auto& x : P) x = (uint16_t)num();
  std::vector<uint32_t> ws((size_t)C * MV * W, 0u);
  for (int c = 0; c < C; ++c) {
    const uint16_t* Pc = P.data() + (size_t)c * MV * MV;
    if (MV < 32) {  // pack_small_kernel: a thread a column
      for (int j = 0; j < MV; ++j)
        for (int i = 0; i < MV; ++i)
          if (fx_bf16_pos(Pc[(size_t)i * MV + j]))
            ws[(size_t)c * MV + j] |= 1u << i;
      continue;
    }
    const int ncols = MV < 256 ? MV : 256;
    for (int kt = 0; kt < W; ++kt)
      for (int j0 = 0; j0 < MV; j0 += 256) {  // one CTA
        uint32_t rw[32][8] = {{0}};
        for (int row = 0; row < 32; ++row)  // warp row / 4, load row % 4
          for (int l = 0; 8 * l < ncols; ++l) {
            const uint16_t* e = Pc + (size_t)(kt * 32 + row) * MV + j0 + 8 * l;
            uint32_t h[4];
            for (int q = 0; q < 4; ++q)
              h[q] = (uint32_t)e[2 * q] | (uint32_t)e[2 * q + 1] << 16;
            // the group's xor shuffles OR the four lanes' bytes
            rw[row][l >> 2] |= fx_pos_bits8(h[0], h[1], h[2], h[3])
                               << (8 * (l & 3));
          }
        for (int q = 0; 32 * q < ncols; ++q) {  // warp q's transpose
          uint32_t x[32];
          for (int l = 0; l < 32; ++l) x[l] = rw[l][q];
          for (int j = 16; j > 0; j >>= 1) {
            uint32_t y[32];
            for (int l = 0; l < 32; ++l)
              y[l] = fx_transpose_step(x[l], x[l ^ j], l, j);
            for (int l = 0; l < 32; ++l) x[l] = y[l];
          }
          for (int l = 0; l < 32; ++l)
            ws[((size_t)c * MV + j0 + 32 * q + l) * W + kt] = x[l];
        }
      }
  }
  for (auto x : ws) std::printf("%u ", x);
  std::printf("\n");
}

static void chain() {
  const int C = num(), MV = num(), nc = num(), T = num();
  const int W = words(MV), mvc = MV / nc, G = T / W;
  const int cols = mvc / G > 0 ? mvc / G : 1;
  const int nslot = G;
  std::vector<uint32_t> pk((size_t)C * MV * W), v0(W);
  for (auto& x : pk) x = (uint32_t)num();
  for (auto& x : v0) x = (uint32_t)num();
  // per CTA: slots [2][nslot][W]; the cluster's partials [2][nc][W]
  std::vector<uint32_t> red((size_t)nc * 2 * nslot * W, 0u);
  std::vector<uint32_t> xred((size_t)2 * nc * W, 0u);
  const int npre = nc > 1 ? nc : nslot;
  auto prev_of = [&](int r, int par) -> const uint32_t* {
    return nc > 1 ? xred.data() + (size_t)par * nc * W
                  : red.data() + ((size_t)r * 2 + par) * nslot * W;
  };
  for (int k = 0; k < W; ++k) {  // v0 in slot 0 of parity 1
    if (nc > 1)
      xred[(size_t)nc * W + k] = v0[k];
    else
      red[(size_t)nslot * W + k] = v0[k];
  }
  std::vector<uint32_t> out((size_t)(C + 1) * W, 0u);
  std::vector<int> alive(C, 0);
  for (int k = 0; k < W; ++k) out[k] = v0[k];
  for (int c = 0; c < C; ++c) {
    const int par = c & 1;
    int any = 0;
    for (int r = 0; r < nc; ++r) {
      const uint32_t* prev = prev_of(r, par ^ 1);
      const uint32_t* chunk = pk.data() + (size_t)c * MV * W +
                              (size_t)r * mvc * W;
      uint32_t* now = red.data() + ((size_t)r * 2 + par) * nslot * W;
      for (int i = 0; i < nslot * W; ++i) now[i] = 0u;
      for (int tid = 0; tid < T; ++tid) {
        const int k = tid & (W - 1);
        const int base = (tid / W) * cols;
        const int per_word = cols < 32 ? cols : 32;
        uint32_t acc = 0;
        if (base < mvc)
          for (int i0 = 0; i0 < cols; i0 += per_word) {
            const int j = base + i0;
            const int gj = r * mvc + j;
            const uint32_t fw = fx_front_word(prev, npre, W, gj >> 5);
            acc |= fx_live_or(chunk + (size_t)j * W + k, fw >> (gj & 31),
                              per_word, W);
          }
        any |= acc != 0u;
        now[(tid / W) * W + k] |= acc;
      }
    }
    if (nc > 1)
      for (int r = 0; r < nc; ++r)
        for (int k = 0; k < W; ++k)
          xred[((size_t)par * nc + r) * W + k] = fx_front_word(
              red.data() + ((size_t)r * 2 + par) * nslot * W, nslot, W, k);
    const uint32_t* now = prev_of(0, par);
    for (int k = 0; k < W; ++k)
      out[(size_t)(c + 1) * W + k] = fx_front_word(now, npre, W, k);
    alive[c] = any;
    if (!any) break;
  }
  for (int c = 0; c < C; ++c) std::printf("%d ", alive[c]);
  std::printf("\n");
  for (auto x : out) std::printf("%u ", x);
  std::printf("\n");
}

// warp_chain_kernel (MV <= 512): lane l owns kVW words (h = l % kLPC) of
// the columns l / kLPC + kCPI i, and the warp's OR of the lanes that own
// a word (a redux) gives every lane the new frontier
static void warp_chain() {
  const int C = num(), MV = num(), W = words(MV);
  const int VW = W < 4 ? W : 4, LPC = W / VW, CPI = 32 / LPC;
  const int NI = (MV + CPI - 1) / CPI;
  std::vector<uint32_t> pk((size_t)C * MV * W), f(W);
  for (auto& x : pk) x = (uint32_t)num();
  for (auto& x : f) x = (uint32_t)num();
  std::vector<uint32_t> out((size_t)(C + 1) * W, 0u);
  std::vector<int> alive(C, 0);
  for (int k = 0; k < W; ++k) out[k] = f[k];
  for (int c = 0; c < C; ++c) {
    std::vector<uint32_t> nf(W, 0u);
    for (int lane = 0; lane < 32; ++lane) {
      const int h = lane % LPC, col = lane / LPC;
      for (int i = 0; i < NI; ++i) {
        const int j = i * CPI + col;
        if (j < MV && ((f[(i * CPI) >> 5] >> (((i * CPI) & 31) + col)) & 1u))
          for (int q = 0; q < VW; ++q)
            nf[h * VW + q] |= pk[((size_t)c * MV + j) * W + h * VW + q];
      }
    }
    uint32_t any = 0;
    for (int w = 0; w < W; ++w) {
      f[w] = nf[w];
      out[(size_t)(c + 1) * W + w] = nf[w];
      any |= nf[w];
    }
    alive[c] = any != 0u;
    if (!any) break;
  }
  for (int c = 0; c < C; ++c) std::printf("%d ", alive[c]);
  std::printf("\n");
  for (auto x : out) std::printf("%u ", x);
  std::printf("\n");
}

static const int kTile = 32;  // csrc/window_rescan.cu

static void rescan() {
  const int K = num(), T = num(), S = num(), V = num(), U = num();
  const bool shared = num() != 0 || S > 5;
  const int M = 1 << S, NW = (M * V + 31) / 32;
  std::vector<uint8_t> pend((size_t)K * T * S), valid((size_t)K * T);
  std::vector<int> ids((size_t)T * S), slots(T), oob(U);
  std::vector<uint32_t> nxt((size_t)U * V), vw(NW);
  for (auto& x : pend) x = (uint8_t)num();
  for (auto& x : valid) x = (uint8_t)num();
  for (auto& x : ids) x = (int)num();
  for (auto& x : slots) x = (int)num();
  for (auto& x : nxt) x = (uint32_t)num();
  for (auto& x : oob) x = (int)num();
  for (auto& x : vw) x = (uint32_t)num();
  for (int k = 0; k < K; ++k) {
    std::vector<uint32_t> set(32 > M ? 32 : M, 0u);
    int any = 0;
    for (int m = 0; m < M; ++m) {
      set[m] = fx_start_set(vw.data(), m, V);
      any |= set[m] != 0;
    }
    int dead_at = any ? -1 : 0, inex = 0, bad = 0, bad_id = 0;
    for (int t0 = 0; t0 < T; t0 += kTile) {
      const int n = T - t0 < kTile ? T - t0 : kTile;
      // staging: the op ids (checked), the masks, the op words
      std::vector<int> sid((size_t)n * S);
      std::vector<uint32_t> pm(n), oobm(n, 0u), opw((size_t)n * S * V);
      std::vector<int> rs(n);
      for (int q = 0; q < n * S; ++q) {
        const int u = ids[(size_t)t0 * S + q];
        const bool ok = u >= 0 && u < U;
        bad_id |= !ok;
        sid[q] = ok ? u : 0;
      }
      for (int t = 0; t < n; ++t) {
        const size_t kt = (size_t)k * T + t0 + t;
        if (!fx_return_masks(pend.data() + kt * S, S, valid[kt] != 0,
                             slots[t0 + t], &pm[t], &rs[t])) {
          bad = 1;
          pm[t] = 0;
          rs[t] = -1;
        }
      }
      for (int q = 0; q < n * S * V; ++q)
        opw[q] = nxt[(size_t)sid[q / V] * V + q % V];
      for (int t = 0; t < n; ++t)
        for (int s = 0; s < S; ++s)
          if (oob[sid[t * S + s]]) oobm[t] |= 1u << s;
      for (int t = 0; t < n; ++t) {
        const uint32_t p = pm[t];
        const int r = rs[t];
        inex |= (p & oobm[t]) != 0u;
        if (r < 0 || dead_at >= 0) continue;
        const uint32_t* op_t = opw.data() + (size_t)t * S * V;
        const int levels = fx_popc(p);
        if (!shared) {  // the warp path: lane m holds set[m]
          for (int l = 1; l <= levels; ++l) {
            std::vector<uint32_t> acc(set);
            for (int s = 0; s < S; ++s) {
              if (!((p >> s) & 1u)) continue;
              for (int m = 0; m < 32; ++m) {
                const uint32_t src = set[m ^ (1 << s)];
                const uint32_t* op_s = op_t + s * V;
                acc[m] |= V == 8    ? fx_lane_pull_k<8>(m, p, l, s, src, op_s)
                          : V == 16 ? fx_lane_pull_k<16>(m, p, l, s, src, op_s)
                                    : fx_lane_pull(m, p, l, s, src, op_s, V);
              }
            }
            set = acc;
          }
          std::vector<uint32_t> nv(32);
          any = 0;
          for (int m = 0; m < 32; ++m) {
            nv[m] = fx_lane_kill(m, r, set[m | (1 << r)]);
            any |= nv[m] != 0u;
          }
          set = nv;
        } else {  // a thread a mask, a barrier a level
          for (int l = 1; l <= levels; ++l)
            for (int m = 0; m < M; ++m)
              if (fx_popc((uint32_t)m & p) == l)
                set[m] = fx_close(set.data(), m, p, op_t, V);
          std::vector<uint32_t> nv(M);
          any = 0;
          for (int m = 0; m < M; ++m) {
            nv[m] = fx_kill(set.data(), m, r);
            any |= nv[m] != 0u;
          }
          for (int m = 0; m < M; ++m) set[m] = nv[m];
        }
        if (!any) dead_at = t0 + t;
      }
    }
    std::printf("%d %d\n", (bad || bad_id) ? -2 : dead_at, inex);
  }
}

static void masks() {
  const int K = num(), T = num(), S = num();
  std::vector<uint8_t> pend((size_t)K * T * S), valid((size_t)K * T);
  std::vector<int> slots(T);
  for (auto& x : pend) x = (uint8_t)num();
  for (auto& x : valid) x = (uint8_t)num();
  for (auto& x : slots) x = (int)num();
  for (int k = 0; k < K; ++k)
    for (int t = 0; t < T; ++t) {
      const size_t kt = (size_t)k * T + t;
      uint32_t pm;
      int rs;
      const bool ok = fx_return_masks(pend.data() + kt * S, S,
                                      valid[kt] != 0, slots[t], &pm, &rs);
      std::printf("%u %d %d\n", pm, rs, ok ? 1 : 0);
    }
}

int main() {
  switch (num()) {
    case 0: pack(); break;
    case 1: rescan(); break;
    case 2: chain(); break;
    case 4: warp_chain(); break;
    default: masks(); break;
  }
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


def _plan_threads(MV, nc):
    """The chain's threads a CTA at (MV, nc), as csrc/prefix_alive.cu's
    ``plan_at`` picks them (a column slice's words / 16, in [32, 1024])."""
    W = max(1, MV // 32)
    return min(1024, max(32, (MV // nc) * W // 16))


def _bf16_bits(Pb: torch.Tensor) -> str:
    return " ".join(str(int(x) & 0xFFFF)
                    for x in Pb.view(torch.int16).reshape(-1).tolist())


def _transposed(P: np.ndarray) -> np.ndarray:
    """[C, MV, MV] 0/1 -> the pack's [C, MV, W] uint32 words: word k of
    column j holds rows 32 k ... 32 k + 31 (bit b: P[c, 32 k + b, j])."""
    C, MV, _ = P.shape
    W = max(1, MV // 32)
    bits = np.zeros((C, MV, W * 32), np.uint64)
    bits[:, :, :MV] = np.transpose(P > 0, (0, 2, 1))
    bits = bits.reshape(C, MV, W, 32)
    return (bits << np.arange(32, dtype=np.uint64)).sum(axis=3).astype(
        np.uint32)


def _noisy_bf16(P, rng):
    """P's 0/1 entries as bf16 with noise that must count as 0 (negative,
    -0, NaN) or 1 (0.5, 3)."""
    C, MV, _ = P.shape
    noise = torch.from_numpy(rng.choice(
        np.array([-1.0, -0.0, np.nan, 0.5], np.float32), (C, MV, MV)))
    Pt = torch.from_numpy(P)
    return torch.where(torch.from_numpy(rng.random((C, MV, MV)) < 0.05),
                       noise, Pt * torch.from_numpy(rng.choice(
                           np.array([1.0, 3.0], np.float32), (C, MV, MV)))
                       ).to(torch.bfloat16)


# (C, MV, seed): one word below MV = 32, rows of 2 and 16 words, a row
# over two warps' words at MV = 2048
HARNESS_PREFIX = [(9, 8, 1), (7, 16, 2), (12, 64, 3), (6, 512, 4),
                  (3, 2048, 5)]


@pytest.mark.parametrize("C,MV,seed", HARNESS_PREFIX,
                         ids=[f"mv{c[1]}" for c in HARNESS_PREFIX])
@pytest.mark.parametrize("kill", [False, True])
def test_prefix_header_matches_plain(harness, C, MV, seed, kill):
    """The transposed pack (bf16 entries: negative, zero, -0 and NaN
    count as 0) and the chain on one CTA (the kernel's thread shape at
    MV; one CTA a chunk), against prefix_alive_torch."""
    rng = np.random.default_rng(seed)
    P = _products(C, MV, seed, C // 2 if kill else None)
    Pb = _noisy_bf16(P, rng)
    if kill:
        # the dead chunk holds no positive entry, but -1, -0 and NaN
        Pb[C // 2] = torch.from_numpy(rng.choice(
            np.array([-1.0, -0.0, np.nan, 0.0], np.float32),
            (MV, MV))).to(torch.bfloat16)
    v0 = torch.from_numpy(_v0(MV, seed, carry=True))
    packed = _run(harness, ["0", f"{C} {MV}", _bf16_bits(Pb)])[0]
    lines = _run(harness, ["2", f"{C} {MV} 1 {_plan_threads(MV, 1)}",
                           packed, _u32(fx.pack_bits(v0))])
    alive, w = fx.prefix_alive_torch(Pb, v0)
    assert [int(x) for x in lines[0].split()] == alive.to(torch.int32).tolist()
    assert [int(x) for x in lines[1].split()] == [
        int(x) & 0xFFFFFFFF for x in w.reshape(-1).tolist()]
    assert bool(alive.all()) is not kill


@pytest.mark.parametrize("C,MV,seed", [(2, 8, 6), (3, 16, 7), (2, 32, 8),
                                       (2, 64, 9), (2, 128, 10),
                                       (1, 256, 11)],
                         ids=["mv8", "mv16", "mv32", "mv64", "mv128",
                              "mv256"])
def test_transposed_pack_layout(harness, C, MV, seed):
    """The pack writes column j's rows as W words, bit b of word k set
    when entry (32 k + b, j) counts as 1: the warp's 16-byte loads, the
    rows' words by shuffles and the 32 ballots, walked lane by lane."""
    rng = np.random.default_rng(seed)
    P = (rng.random((C, MV, MV)) < 0.3).astype(np.float32)
    Pb = _noisy_bf16(P, rng)
    got = np.array([int(x) for x in _run(
        harness, ["0", f"{C} {MV}", _bf16_bits(Pb)])[0].split()],
        np.uint64).astype(np.uint32)
    want = _transposed((Pb.to(torch.float32) > 0).numpy())
    assert np.array_equal(got, want.reshape(-1))


def _chain_products(C, MV, seed, kind):
    """0/1 products for the chain: ``sparse`` (the identity's diagonal
    thinned, half an entry a row more: from one configuration the
    frontier stays a few), ``dense`` (half ones: the frontier fills), ``dies``
    (dense, then chunk C - 2 keeps rows but no column of the frontier)."""
    rng = np.random.default_rng(seed)
    if kind == "sparse":
        P = (rng.random((C, MV, MV)) < 0.5 / MV).astype(np.float32)
        idx = np.arange(MV)
        P[:, idx, idx] = rng.random((C, MV)) < 0.97
        return P
    P = (rng.random((C, MV, MV)) < 0.5).astype(np.float32)
    if kind == "dies":
        P[C - 2] = 0.0
    return P


# (MV, CTAs a cluster, threads a CTA): the cluster design's plans (MV =
# 1024: 4 CTAs of 512 threads; 2048: 16 of 512), the plans it halves to
# when the card holds no such cluster (2 CTAs of 256 and one CTA of 1024
# at MV = 1024; 8 of 1024 at MV = 2048), and one CTA of 256 threads, 128
# columns (four frontier words) a thread
CHAIN_SHAPES = [(1024, 4, 512), (1024, 2, 256), (1024, 1, 1024),
                (2048, 16, 512), (2048, 8, 1024), (1024, 1, 256)]


@pytest.mark.parametrize("MV,nc,threads", CHAIN_SHAPES,
                         ids=[f"mv{m}_nc{n}_t{t}" for m, n, t in
                              CHAIN_SHAPES])
@pytest.mark.parametrize("kind", ["sparse", "dense", "dies"])
def test_live_column_chain(harness, MV, nc, threads, kind):
    """The cluster design's step as the kernel's threads take it: each
    thread's columns and the frontier word that holds their bits, the OR
    of the live columns' words, the partial frontiers (a group's of W
    threads) and across a cluster's CTAs, double-buffered by chunk;
    against prefix_alive_torch."""
    C = 6
    P = _chain_products(C, MV, MV + nc + threads, kind)
    v0 = torch.from_numpy(_v0(MV, MV, carry=kind != "sparse"))
    packed = " ".join(map(str, _transposed(P).reshape(-1).tolist()))
    lines = _run(harness, ["2", f"{C} {MV} {nc} {threads}", packed,
                           _u32(fx.pack_bits(v0))])
    alive, w = fx.prefix_alive_torch(torch.from_numpy(P), v0)
    assert [int(x) for x in lines[0].split()] == alive.to(torch.int32).tolist()
    assert [int(x) for x in lines[1].split()] == [
        int(x) & 0xFFFFFFFF for x in w.reshape(-1).tolist()]
    front = fx.unpack_bits(w, MV)
    if kind == "dies":
        assert alive.tolist() == [True] * (C - 2) + [False] * 2
    elif kind == "dense":
        assert bool(alive.all()) and front[3:].all()
    else:
        assert bool(alive[0]) and 0 < int(front[1].sum()) < MV


@pytest.mark.parametrize("MV", [8, 16, 32, 64, 128, 256, 512])
@pytest.mark.parametrize("kind", ["sparse", "dense", "dies"])
def test_warp_chain(harness, MV, kind):
    """The one-warp chain (MV <= 512) as its lanes take it: kVW-word
    vectors of the live columns, the lanes that own a word ORed into
    every lane's frontier; against prefix_alive_torch."""
    C = 6
    P = _chain_products(C, MV, MV + 7, kind)
    v0 = torch.from_numpy(_v0(MV, MV, carry=kind != "sparse"))
    packed = " ".join(map(str, _transposed(P).reshape(-1).tolist()))
    lines = _run(harness, ["4", f"{C} {MV}", packed, _u32(fx.pack_bits(v0))])
    alive, w = fx.prefix_alive_torch(torch.from_numpy(P), v0)
    assert [int(x) for x in lines[0].split()] == alive.to(torch.int32).tolist()
    assert [int(x) for x in lines[1].split()] == [
        int(x) & 0xFFFFFFFF for x in w.reshape(-1).tolist()]


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


def _ints(t: torch.Tensor) -> str:
    return " ".join(map(str, t.reshape(-1).to(torch.int64).tolist()))


def _rescan_lines(harness, args, shared=False):
    """The harness's rescan on ``window_rescan``'s arguments, in the
    kernel's operand forms: the raw grids as bytes, the op words
    (``RescanChunk``'s ``pack_bits`` of the table) and the packed
    start. Returns [(first, inexact)]."""
    pend, valid, ids, mtT, oob, slots, v = args
    K, T, S = pend.shape
    U, V = mtT.shape[0], mtT.shape[1]
    nxt = fx.pack_bits(mtT.transpose(1, 2))[..., 0]
    lines = _run(harness, ["1", f"{K} {T} {S} {V} {U} {int(shared)}",
                           _ints(pend > 0), _ints(valid > 0), _ints(ids),
                           _ints(slots), _u32(nxt), _ints(oob > 0),
                           _u32(fx.pack_bits(v))])
    return np.array([[int(x) for x in ln.split()] for ln in lines])


# (K, T, S, V, U, seed): S = 1 to 5 take the warp path, 6 to 8 the
# shared-memory one; V = 5 straddles the start's words; T = 70 runs over
# three staged tiles of returns
HARNESS_RESCAN = [(3, 16, 1, 8, 8, 1), (4, 24, 3, 5, 16, 2),
                  (5, 12, 5, 16, 16, 3), (3, 8, 8, 2, 4, 4),
                  (2, 10, 2, 32, 8, 5), (6, 32, 4, 8, 32, 6),
                  (4, 70, 5, 8, 32, 7), (3, 20, 6, 16, 16, 8),
                  (3, 12, 7, 8, 16, 9)]


@pytest.mark.parametrize("K,T,S,V,U,seed", HARNESS_RESCAN,
                         ids=[f"s{c[2]}v{c[3]}" for c in HARNESS_RESCAN])
def test_rescan_header_matches_plain(harness, K, T, S, V, U, seed):
    """The staging of the raw grids, the closure (the warp path's
    shuffled pulls for S <= 5, the shared-memory levels above) and the
    kill, against window_rescan_torch."""
    args = _random_rescan(K, T, S, V, U, seed)
    got = _rescan_lines(harness, args)
    first, inexact = fx.window_rescan_torch(*args)
    assert np.array_equal(got[:, 0], first.numpy())
    assert np.array_equal(got[:, 1], inexact.numpy().astype(int))


@pytest.mark.parametrize("S", [1, 2, 3, 4, 5])
def test_rescan_warp_path_matches_shared_path(harness, S):
    """For S <= 5 both paths' closures, the warp's shuffles (a lane a
    mask) and the shared-memory levels (a thread a mask), give the same
    results, and the plain version's."""
    args = _random_rescan(8, 40, S, 8, 24, 20 + S)
    warp = _rescan_lines(harness, args)
    shared = _rescan_lines(harness, args, shared=True)
    first, inexact = fx.window_rescan_torch(*args)
    assert np.array_equal(warp, shared)
    assert np.array_equal(warp[:, 0], first.numpy())
    assert np.array_equal(warp[:, 1], inexact.numpy().astype(int))


def test_rescan_header_empty_start(harness):
    """A start with no configuration is dead before the first return,
    whatever the returns are (the reference's first = 0)."""
    args = list(_random_rescan(3, 6, 2, 8, 4, 9))
    args[6] = torch.zeros_like(args[6])
    args[1][:, 0] = False   # the first return masked out
    first, _ = fx.window_rescan_torch(*args)
    assert first.tolist() == [0, 0, 0]
    assert _rescan_lines(harness, args)[:, 0].tolist() == [0, 0, 0]


def test_rescan_return_masks(harness):
    """The kernel's own derivation of a return's masks from the raw
    grids: the pending bits of a valid return (0 for an invalid one),
    its slot (-1 for an invalid one), and a valid return's slot outside
    [0, S) flagged, an invalid one's not."""
    rng = np.random.default_rng(31)
    K, T, S = 5, 23, 6
    pend = rng.random((K, T, S)) < 0.5
    valid = rng.random((K, T)) < 0.7
    slots = rng.integers(-2, S + 2, T)
    lines = _run(harness, ["3", f"{K} {T} {S}", _ints(torch.from_numpy(pend)),
                           _ints(torch.from_numpy(valid)),
                           " ".join(map(str, slots.tolist()))])
    got = np.array([[int(x) for x in ln.split()] for ln in lines]).reshape(
        K, T, 3)
    pm = np.where(valid, (pend << np.arange(S)).sum(axis=2), 0)
    rs = np.where(valid, slots[None], -1)
    ok = ~valid | ((slots >= 0) & (slots < S))[None]
    assert np.array_equal(got[..., 0], pm)
    assert np.array_equal(got[..., 1], rs)
    assert np.array_equal(got[..., 2], ok.astype(int))


def test_rescan_out_of_range_marks_first(harness):
    """An op id out of range marks every candidate; a valid return's slot
    out of range marks its candidate (first = RESCAN_BAD); a bad slot on
    an invalid return is not read."""
    args = list(_random_rescan(3, 12, 3, 8, 8, 40))
    ids = args[2].clone()
    ids[5, 1] = 8
    got = _rescan_lines(harness, [*args[:2], ids, *args[3:]])
    assert got[:, 0].tolist() == [fx.RESCAN_BAD] * 3
    valid = args[1].clone()
    valid[:, 4] = torch.tensor([True, False, True])
    slots = args[5].clone()
    slots[4] = 3
    got = _rescan_lines(harness, [args[0], valid, args[2], args[3], args[4],
                                  slots, args[6]])
    # candidate 1 never reads return 4's slot
    want, _ = fx.window_rescan_torch(args[0], valid, *args[2:])
    assert got[0, 0] == got[2, 0] == fx.RESCAN_BAD
    assert got[1, 0] == int(want[1])


# ---------------------------------------------------------------------------
# the wrappers' checks
# ---------------------------------------------------------------------------

def test_rescan_wrapper_refuses_out_of_range():
    """On the CPU the wrapper checks the op ids and the valid returns'
    slots itself and raises; a bad slot on an invalid return is fine."""
    args = list(_random_rescan(2, 9, 3, 8, 8, 41))
    for i, bad in ((2, lambda x: x.__setitem__((3, 0), 8)),
                   (2, lambda x: x.__setitem__((0, 2), -1)),
                   (5, lambda x: x.__setitem__(6, 3))):
        a = [x.clone() for x in args]
        a[1][:, 6] = True
        bad(a[i])
        with pytest.raises(ValueError, match="out of range"):
            fx.window_rescan(*a)
    a = [x.clone() for x in args]
    a[1][:, 6] = False
    want = fx.window_rescan(*a)
    a[5][6] = 3
    got = fx.window_rescan(*a)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_read_first_raises_on_the_mark():
    first = torch.tensor([3, fx.RESCAN_BAD, -1], dtype=torch.int32)
    with pytest.raises(ValueError, match="out of range"):
        fx.read_first(first)
    assert fx.read_first(first[[0, 2]]).tolist() == [3, -1]


def _shrink_round(device):
    """A planted anomaly (the port's localization on ``device``), and a
    shrink round's K seeded candidate masks over its chunk."""
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    from jepsen_tpu_torch.histories import corrupt_reads, register_history
    from jepsen_tpu_torch.ops import jitlin
    h = corrupt_reads(register_history(2400, n_procs=4, seed=7, n_values=5),
                      n=2, seed=3)
    stream = encode_register_ops(h)
    loc = jitlin.matrix_localize(stream, device=device)
    assert loc is not None
    return stream, loc, _masks(loc, 9, seed=5)


def _check_shrink_round(device):
    from jepsen_tpu_torch.ops import jitlin
    stream, loc, (pend, valid) = _shrink_round(device)
    fresh = jitlin.matrix_localize(stream, device=device)
    first = jitlin.matrix_window_rescan(loc, pend, valid)
    # the round over the cached chunk operands, over a fresh
    # localization's, and the plain version on the host grids
    assert np.array_equal(first, jitlin.matrix_window_rescan(fresh, pend,
                                                             valid))
    mtT, oob = _port_tables(loc, loc.uops)
    want, _ = fx.window_rescan_torch(
        torch.from_numpy(pend), torch.from_numpy(valid),
        torch.from_numpy(np.asarray(loc.window_ids)), mtT, oob,
        torch.from_numpy(np.asarray(loc.window_slots)),
        loc.v_start.cpu().to(torch.float32))
    assert np.array_equal(first, want.numpy())
    assert int(first[0]) == loc.step == fresh.step
    assert int(first[-1]) == -1
    # a second round over the same localization
    assert np.array_equal(jitlin.matrix_window_rescan(loc, pend[:3],
                                                      valid[:3]), first[:3])


def test_shrink_round_over_cached_localization():
    """A shrink round over a localization's cached chunk operands gives
    what the same round over a fresh ``matrix_localize`` gives, and the
    plain version's first on the host grids; the keep-all candidate
    dies at the localized return."""
    _check_shrink_round("cpu")


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
                                  (16, 4096), (9, 8), (7, 16), (12, 32),
                                  (10, 64), (8, 128), (6, 2048)])
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
    (128, 64, 5, 8, 64, 7), (16, 16, 8, 16, 32, 8), (300, 40, 4, 16, 32, 9),
    (20, 33, 6, 16, 32, 10)])
def test_window_rescan_kernel_on_card(cuda_device, K, T, S, V, U, seed):
    args = [a.to(cuda_device) for a in _random_rescan(K, T, S, V, U, seed)]
    n = fx.window_rescan.launches
    got = fx.window_rescan(*args)
    assert fx.window_rescan.launches == n + 1
    want = fx.window_rescan_torch(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_rescan_out_of_range_raises_on_card(cuda_device):
    """The kernel marks an op id out of range (every candidate) and a
    valid return's slot out of range (its candidate); read_first raises
    on the mark."""
    args = [a.to(cuda_device) for a in _random_rescan(3, 12, 3, 8, 8, 40)]
    ids = args[2].clone()
    ids[5, 1] = 8
    first, _ = fx.window_rescan(*args[:2], ids, *args[3:])
    assert first.tolist() == [fx.RESCAN_BAD] * 3
    with pytest.raises(ValueError, match="out of range"):
        fx.read_first(first)
    valid = args[1].clone()
    valid[:, 4] = torch.tensor([True, False, True], device=cuda_device)
    slots = args[5].clone()
    slots[4] = -1
    first, _ = fx.window_rescan(args[0], valid, args[2], args[3], args[4],
                                slots, args[6])
    want, _ = fx.window_rescan_torch(args[0], valid, *args[2:])
    assert first.tolist()[0] == first.tolist()[2] == fx.RESCAN_BAD
    assert int(first[1]) == int(want[1])


@pytest.mark.cuda
def test_shrink_round_over_cached_localization_on_card(cuda_device):
    _check_shrink_round("cuda")
