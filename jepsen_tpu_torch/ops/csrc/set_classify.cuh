// The per-word scans of the set-full classify (set_classify.cu).
//
// For an element with read times t_r over the reads r holding it or not:
//
//   first_seen = min { t_r : bit set }      known = has_ok ? ok_t : first_seen
//   P          = max { t_r : bit set }      A     = max { t_r : bit clear }
//   any_later  = max_r t_r >= known
//   lp = P >= known ? P : -inf              la    = A >= known ? A : -inf
//
// which is what jepsen_tpu/ops/setscan.py:72-104 computes with the
// `t >= known` filter inside its reductions: a maximum over the rows
// read at or after known is the global maximum when that is at least
// known, and is empty otherwise. Visiting the rows in time order (the
// ranks of `order`, the row indices sorted by read time), each of the
// three is a first hit: first_seen is the first rank going up whose row
// holds the bit, P the first going down, A the first going down whose
// row lacks it. A thread owns one 32-bit word (32 elements) of a range
// of ranks:
//
// - group_or: the bits some row of the range holds, and those some row
//   lacks (live bits only: padding bits past E are masked out);
// - a range wins a bit for P (for A) when no higher range holds (lacks)
//   it, and for first_seen when no lower range holds it, so that a bit
//   has at most one winner a quantity, whose first hit is the global one;
// - scan_down, scan_up: the winner walks its range in time order and
//   reports each row that is the first hit of some of the bits it won,
//   with those bits, and stops when it has found them all;
// - hit_rank, rank_time, finish: an element's code, stale flag and
//   latency from its three hits' times, the plain version's arithmetic
//   (one float64 subtraction).
//
// Ties in time need no care: any row of the first hit's rank has the
// time the reduction gives. This header also builds without CUDA (g++,
// with __device__ and __forceinline__ defined away), as the CPU tests
// build it.
#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kStable = 0, kLost = 1, kNeverRead = 2;

// The live bits of word w: elements 32 w + j < E.
__device__ __forceinline__ uint32_t live_bits(long long w, long long E) {
  const long long rem = E - 32 * w;
  return rem >= 32 ? 0xffffffffu : rem <= 0 ? 0u : (1u << rem) - 1u;
}

// Over ranks [k0, k1): the live bits some row holds (*held) and lacks
// (*lacked). The ranks' rows are fetched 8 at a time, then their words,
// so that the loads of a block are in flight together.
__device__ __forceinline__ void group_or(const uint32_t* __restrict__ words,
                                        const int32_t* __restrict__ order,
                                        size_t W, size_t w, int k0, int k1,
                                        uint32_t live, uint32_t* held,
                                        uint32_t* lacked) {
  uint32_t h = 0, l = ~0u;
  for (int k = k0; k < k1; k += 8) {
    int r[8];
    uint32_t x[8];
    for (int j = 0; j < 8; ++j) r[j] = k + j < k1 ? order[k + j] : -1;
    for (int j = 0; j < 8; ++j)
      x[j] = r[j] >= 0 ? words[(size_t)r[j] * W + w] : 0u;
    for (int j = 0; j < 8; ++j) {
      h |= x[j];
      if (r[j] >= 0) l &= x[j];
    }
  }
  *held = h & live;
  *lacked = k0 < k1 ? ~l & live : 0u;
}

// Going down from rank k1 - 1 to k0: hit(1, m, k) for the bits m of
// want_p that the row at rank k is the first to hold, hit(2, m, k) for
// the bits of want_a it is the first to lack. Each bit asked for is held
// (lacked) by some row of the range, so the walk ends inside it. Rows
// are fetched 8 at a time, as in group_or.
template <class Hit>
__device__ __forceinline__ void scan_down(const uint32_t* __restrict__ words,
                                         const int32_t* __restrict__ order,
                                         size_t W, size_t w, int k0, int k1,
                                         uint32_t want_p, uint32_t want_a,
                                         Hit hit) {
  for (int k = k1 - 1; k >= k0 && (want_p | want_a); k -= 8) {
    int r[8];
    uint32_t x[8];
    for (int j = 0; j < 8; ++j) r[j] = k - j >= k0 ? order[k - j] : -1;
    for (int j = 0; j < 8; ++j)
      x[j] = r[j] >= 0 ? words[(size_t)r[j] * W + w] : 0u;
    for (int j = 0; j < 8 && r[j] >= 0; ++j) {
      const uint32_t hp = x[j] & want_p, ha = ~x[j] & want_a;
      if (hp) {
        want_p &= ~hp;
        hit(1, hp, k - j);
      }
      if (ha) {
        want_a &= ~ha;
        hit(2, ha, k - j);
      }
    }
  }
}

// Going up from rank k0 to k1 - 1: hit(0, m, k) for the bits m of want
// that the row at rank k is the first to hold.
template <class Hit>
__device__ __forceinline__ void scan_up(const uint32_t* __restrict__ words,
                                       const int32_t* __restrict__ order,
                                       size_t W, size_t w, int k0, int k1,
                                       uint32_t want, Hit hit) {
  for (int k = k0; k < k1 && want; k += 8) {
    int r[8];
    uint32_t x[8];
    for (int j = 0; j < 8; ++j) r[j] = k + j < k1 ? order[k + j] : -1;
    for (int j = 0; j < 8; ++j)
      x[j] = r[j] >= 0 ? words[(size_t)r[j] * W + w] : 0u;
    for (int j = 0; j < 8 && r[j] >= 0; ++j) {
      const uint32_t h = x[j] & want;
      if (h) {
        want &= ~h;
        hit(0, h, k + j);
      }
    }
  }
}

// A word's hits of one quantity are a list of (bits, rank) entries, one
// a hit row, each bit in one entry at most: the rank of the entry that
// holds bit b, or `none`.
// Entries are read 4 at a time.
__device__ __forceinline__ int hit_rank(const uint32_t* bits,
                                       const int32_t* rank, int n, int b,
                                       int none) {
  for (int i = 0; i < n; i += 4) {
    uint32_t m[4];
    for (int j = 0; j < 4; ++j) m[j] = i + j < n ? bits[i + j] : 0u;
    for (int j = 0; j < 4; ++j)
      if ((m[j] >> b) & 1u) return rank[i + j];
  }
  return none;
}

// The read time at rank k, or `none` for a rank outside [0, R).
__device__ __forceinline__ double rank_time(const double* __restrict__ t_read,
                                           const int32_t* __restrict__ order,
                                           int k, int R, double none) {
  return k >= 0 && k < R ? t_read[order[k]] : none;
}

// One element's verdict from its first_seen, P and A times (+inf, -inf
// and -inf where no row holds or lacks it) and the latest read time.
__device__ __forceinline__ void finish(double first, double p, double a,
                                       double t_max, bool hok, double ok_t,
                                       double invoke_t, int32_t* code,
                                       uint8_t* stale, double* latency) {
  const double known = hok ? ok_t : first;
  const bool any_later = t_max >= known;
  const double lp = p >= known ? p : -INFINITY;
  const double la = a >= known ? a : -INFINITY;
  const bool has_present = lp > -INFINITY;
  const bool has_absent = la > -INFINITY;
  const bool lost = has_absent && (!has_present || la > lp);
  const bool never_read = known >= INFINITY || !any_later;
  const int c = never_read ? kNeverRead : (lost ? kLost : kStable);
  *code = c;
  // absent after known but present again later
  *stale = (c == kStable && has_absent) ? 1 : 0;
  const double d = (has_absent ? la : known) - invoke_t;
  *latency = d > 0.0 ? d : 0.0;
}

}  // namespace
