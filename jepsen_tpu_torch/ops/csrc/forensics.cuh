// The per-thread steps of the two forensics kernels (prefix_alive.cu,
// window_rescan.cu).
//
// A configuration is (mask, state), index mask * V + state, as in
// ops/jitlin.py. Both kernels keep a frontier of configurations as bits:
//
// - prefix_alive: the [MV] frontier packed 32 indices a word (W = MV / 32
//   words, one word below MV = 32), the layout of a packed [MV, W] row of
//   a chunk product; a row's new bit is whether (row & w) has a set bit
//   in any word;
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

// A bf16 entry counts as 1 when it is > 0 and not NaN.
__device__ __forceinline__ bool fx_bf16_pos(uint16_t h) {
  return !(h & 0x8000u) && h != 0 && h <= 0x7F80u;
}

// ---------------------------------------------------------------------------
// prefix_alive: one frontier step over a packed chunk product
// ---------------------------------------------------------------------------

// Does packed word q (row q / W, columns 32 (q % W) ...) of a chunk
// product meet the frontier w? W is a power of two.
__device__ __forceinline__ bool fx_hit(uint32_t word, const uint32_t* w,
                                       int q, int W) {
  const uint32_t wj = w[q & (W - 1)];
  return wj != 0 && (word & wj) != 0;
}

// The new frontier bits that the 32 packed words q0 ... q0 + 31 (q0 a
// multiple of 32) give, from `hits` (bit l: word q0 + l met the
// frontier), to be ORed into frontier word (q0 / W) >> 5 shifted left by
// (q0 / W) & 31. Below W = 32 the words hold 32 / W whole rows; from
// W = 32 up they are part of one row.
__device__ __forceinline__ uint32_t fx_segment_bits(uint32_t hits, int W) {
  if (W >= 32) return hits != 0u ? 1u : 0u;
  const uint32_t row = (1u << W) - 1u;
  uint32_t bits = 0;
  for (int j = 0; j < 32 / W; ++j)
    if ((hits >> (j * W)) & row) bits |= 1u << j;
  return bits;
}

// ---------------------------------------------------------------------------
// window_rescan: one return's operator on a frontier of state sets
// ---------------------------------------------------------------------------

// The states that one op takes the states of `set` to: nxt[v] holds the
// states w with v -> w (transitions leaving [0, V) are dropped).
__device__ __forceinline__ uint32_t fx_image(uint32_t set,
                                             const uint32_t* nxt) {
  uint32_t out = 0;
  while (set) {
    out |= nxt[fx_low(set)];
    set &= set - 1;
  }
  return out;
}

// Mask m's states after the closure under the pending slots `pm`,
// pulled from the masks one linearization below it: set[m] and, for
// each pending slot s in m, the image of set[m ^ (1 << s)] under slot
// s's op (op_nxt + s * V). Taken in order of popcount(m), every mask
// below m is final when m is pulled, so one pass over the levels 1 ... S
// reaches the fixed point of (I + L)^(2^n_sq).
__device__ __forceinline__ uint32_t fx_close(const uint32_t* set, int m,
                                             uint32_t pm,
                                             const uint32_t* op_nxt,
                                             int V) {
  uint32_t acc = set[m];
  uint32_t b = (uint32_t)m & pm;
  while (b) {
    const int s = fx_low(b);
    b &= b - 1;
    acc |= fx_image(set[m ^ (1 << s)], op_nxt + s * V);
  }
  return acc;
}

// Mask m's states after the return of slot r kills every configuration
// that did not linearize it: none when r is in m, else the closed states
// of m | 1 << r (jitlin.receiver_kill_tables).
__device__ __forceinline__ uint32_t fx_kill(const uint32_t* clos, int m,
                                            int r) {
  return ((m >> r) & 1) ? 0u : clos[m | (1 << r)];
}

}  // namespace
