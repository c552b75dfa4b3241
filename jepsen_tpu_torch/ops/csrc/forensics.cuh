// The per-thread steps of the two forensics kernels (prefix_alive.cu,
// window_rescan.cu).
//
// A configuration is (mask, state), index mask * V + state, as in
// ops/jitlin.py. Both kernels keep a frontier of configurations as bits:
//
// - prefix_alive: the [MV] frontier packed 32 indices a word (W = MV / 32
//   words, one word below MV = 32; bit i % 32 of word i / 32). The pack
//   writes each chunk product transposed: column j's MV rows as W words
//   (packedT[c][j][k] bit b: P[c][32 k + b][j] > 0), so that the new
//   frontier is the OR of the words of the frontier's live columns;
// - window_rescan: one V-bit state set a mask (V <= 32), so that the
//   closure under the pending ops and the kill of the returning slot
//   work on whole masks.
//
// This header also builds without CUDA (g++, with __device__ and
// __forceinline__ defined away), as the CPU tests build it: they walk
// these steps in the kernels' order and hold the result against the
// plain torch versions in ops/forensics_kernels.py.
#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

namespace {

__device__ __forceinline__ int fx_popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// index of the lowest set bit of x != 0
__device__ __forceinline__ int fx_low(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __ffs(x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

// the n low bits (1 <= n <= 32)
__device__ __forceinline__ uint32_t fx_low_mask(int n) {
  return n >= 32 ? 0xFFFFFFFFu : (1u << n) - 1u;
}

// A bf16 entry counts as 1 when it is > 0 and not NaN.
__device__ __forceinline__ bool fx_bf16_pos(uint16_t h) {
  return !(h & 0x8000u) && h != 0 && h <= 0x7F80u;
}

// ---------------------------------------------------------------------------
// prefix_alive: the transposed pack and one chain step
// ---------------------------------------------------------------------------

// Eight bf16 entries of one 16-byte load (four words, the lower half of
// a word first) -> bit e set when entry e counts as 1.
__device__ __forceinline__ uint32_t fx_pos_bits8(uint32_t x, uint32_t y,
                                                 uint32_t z, uint32_t w) {
  const uint32_t h[4] = {x, y, z, w};
  uint32_t bits = 0;
  for (int i = 0; i < 4; ++i) {
    if (fx_bf16_pos((uint16_t)(h[i] & 0xFFFFu))) bits |= 1u << (2 * i);
    if (fx_bf16_pos((uint16_t)(h[i] >> 16))) bits |= 2u << (2 * i);
  }
  return bits;
}

// One round (j = 16, 8, 4, 2, 1) of the 32 x 32 bit transpose across a
// warp: lane l holds x, y is lane l ^ j's x; the rounds swap the
// off-diagonal j x j blocks, so that from lane r holding row r (bit c:
// entry (r, c)) lane c ends holding column c (bit r: entry (r, c)).
__device__ __forceinline__ uint32_t fx_transpose_step(uint32_t x,
                                                      uint32_t y, int lane,
                                                      int j) {
  const uint32_t m = j == 16  ? 0x0000FFFFu
                     : j == 8 ? 0x00FF00FFu
                     : j == 4 ? 0x0F0F0F0Fu
                     : j == 2 ? 0x33333333u
                              : 0x55555555u;
  return (lane & j) ? (x & ~m) | ((y >> j) & m) : (x & m) | ((y << j) & ~m);
}

// The frontier word `word` as the OR of n partial frontiers of `stride`
// words each (a chain step's reduction slots).
__device__ __forceinline__ uint32_t fx_front_word(const uint32_t* slots,
                                                  int n, int stride,
                                                  int word) {
  uint32_t x = 0;
  for (int i = 0; i < n; ++i) x |= slots[i * stride + word];
  return x;
}

// Word k of the new frontier from n <= 32 contiguous columns of a
// transposed chunk, col pointing at the first column's word k (a column
// W words): the OR of the words of the columns i whose bit i of `bits`
// (the frontier word, shifted to the first column) is set. The loads are
// independent, so a thread has them in flight together.
__device__ __forceinline__ uint32_t fx_live_or(const uint32_t* col,
                                               uint32_t bits, int n, int W) {
  uint32_t acc = 0;
#ifdef __CUDACC__
#pragma unroll 8
#endif
  for (int i = 0; i < n; ++i)
    if ((bits >> i) & 1u) acc |= col[(size_t)i * W];
  return acc;
}

// ---------------------------------------------------------------------------
// window_rescan: one return's operator on a frontier of state sets
// ---------------------------------------------------------------------------

// One candidate's masks at one return from the raw grids: *pm the
// pending slots of a valid return (pend_t[s] != 0: bit s), 0 for an
// invalid one; *rs its returning slot, -1 for an invalid one. False when
// a valid return's slot is outside [0, S).
__device__ __forceinline__ bool fx_return_masks(const uint8_t* pend_t,
                                                int S, bool valid, int slot,
                                                uint32_t* pm, int* rs) {
  if (!valid) {
    *pm = 0u;
    *rs = -1;
    return true;
  }
  uint32_t p = 0;
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int s = 0; s < 8; ++s)  // S <= 8: the loads in flight together
    if (s < S && pend_t[s]) p |= 1u << s;
  *pm = p;
  *rs = slot;
  return slot >= 0 && slot < S;
}

// Mask m's state set from the packed frontier vw: the V bits from
// configuration m V on (they may straddle two words when V does not
// divide 32).
__device__ __forceinline__ uint32_t fx_start_set(const uint32_t* vw, int m,
                                                 int V) {
  const int b = m * V;
  const int sh = b & 31;
  uint32_t x = vw[b >> 5] >> sh;
  if (sh + V > 32) x |= vw[(b >> 5) + 1] << (32 - sh);
  return x & fx_low_mask(V);
}

// The states that one op takes the states of `set` (V bits) to: nxt[v]
// holds the states w with v -> w (transitions leaving [0, V) are
// dropped). The loads of a block of 8 states are independent, so they
// are in flight together rather than one a dependent step.
__device__ __forceinline__ uint32_t fx_image(uint32_t set,
                                             const uint32_t* nxt, int V) {
  uint32_t out = 0;
  for (int v0 = 0; v0 < V && (set >> v0) != 0u; v0 += 8) {
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int i = 0; i < 8; ++i)
      if ((set >> (v0 + i)) & 1u) out |= nxt[v0 + i];
  }
  return out;
}

// Mask m's states after the closure under the pending slots `pm`,
// pulled from the masks one linearization below it: set[m] and, for
// each pending slot s in m, the image of set[m ^ (1 << s)] under slot
// s's op (op_nxt + s * V). Taken in order of popcount(m & pm) (a
// mask's level), every mask it pulls from is final when m is pulled, so
// one pass over the levels 1 ... popcount(pm) reaches the fixed point of
// (I + L)^(2^n_sq). The shared-memory path's step: a thread a mask, the
// sets in shared memory.
__device__ __forceinline__ uint32_t fx_close(const uint32_t* set, int m,
                                             uint32_t pm,
                                             const uint32_t* op_nxt,
                                             int V) {
  uint32_t acc = set[m];
  uint32_t b = (uint32_t)m & pm;
  while (b) {
    const int s = fx_low(b);
    b &= b - 1;
    acc |= fx_image(set[m ^ (1 << s)], op_nxt + s * V, V);
  }
  return acc;
}

// The warp path's step of the same closure: lane m holds set[m] in a
// register; at level l, for each pending slot s, every lane takes
// src = set[m ^ (1 << s)] by a shuffle, and a lane of level l
// (popcount(m & pm) = l) whose mask holds s ORs in src's image under
// slot s's op (op_s). Lanes past the masks hold 0 and pull only from
// such lanes.
__device__ __forceinline__ uint32_t fx_lane_pull(int m, uint32_t pm, int l,
                                                 int s, uint32_t src,
                                                 const uint32_t* op_s,
                                                 int V) {
  return (fx_popc((uint32_t)m & pm) == l && ((m >> s) & 1))
             ? fx_image(src, op_s, V) : 0u;
}

// fx_image and fx_lane_pull at a V known when compiling (kV): every
// state's word is loaded and masked by its bit, with no branch, so the
// loads do not wait for the set (a warp's lanes read the same words).
template <int kV>
__device__ __forceinline__ uint32_t fx_image_k(uint32_t set,
                                               const uint32_t* nxt) {
  uint32_t out = 0;
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int v = 0; v < kV; ++v) out |= nxt[v] & (0u - ((set >> v) & 1u));
  return out;
}
template <int kV>
__device__ __forceinline__ uint32_t fx_lane_pull_k(int m, uint32_t pm, int l,
                                                   int s, uint32_t src,
                                                   const uint32_t* op_s) {
  const bool on = fx_popc((uint32_t)m & pm) == l && ((m >> s) & 1);
  return fx_image_k<kV>(src, op_s) & (on ? 0xFFFFFFFFu : 0u);
}

// Mask m's states after the return of slot r kills every configuration
// that did not linearize it: none when r is in m, else the closed states
// of m | 1 << r (jitlin.receiver_kill_tables); `src` is that mask's set
// (the warp path shuffles it from lane m | 1 << r).
__device__ __forceinline__ uint32_t fx_lane_kill(int m, int r,
                                                 uint32_t src) {
  return ((m >> r) & 1) ? 0u : src;
}
__device__ __forceinline__ uint32_t fx_kill(const uint32_t* clos, int m,
                                            int r) {
  return fx_lane_kill(m, r, clos[m | (1 << r)]);
}

}  // namespace
