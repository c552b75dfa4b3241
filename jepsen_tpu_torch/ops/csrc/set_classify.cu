// Set-full classify (BASELINE config 4) for Hopper (sm_90a).
//
// Replaces jepsen_tpu/ops/setscan.py:69 _build_classify, with the bit
// unpack that classify_elements runs on the device before it (:131-141):
// each element's verdict (stable, lost, never-read), whether a read saw
// it stale, and its visibility latency, from masked min/max reductions
// over the reads x elements membership matrix.
//
// Bound: bytes. The function reads the packed matrix (4 R W bytes), the
// read times (8 R) and the element columns (8 + 8 + 1 bytes an element)
// once and writes 13 bytes an element. Giving each element its own
// thread over every row costs a float64 compare and select a cell, more
// than the bytes allow; this design works on whole words instead.
//
// Design (set_classify.cuh): the three reductions are first hits in time
// order, so a thread that owns a 32-bit word finds all 32 elements' hits
// with a few bit operations a row. A CTA of 16 warps takes a tile of Wt
// consecutive words (Wt a power of two <= 32, the largest that still
// gives every SM a tile: 32 at 2,048 x 262,144, 4 at config 4's 625
// words) and splits the R ranks into 512 / Wt contiguous ranges, one a
// thread: lane j of a warp takes word j mod Wt, and the warp's lanes
// 32 / Wt ranges, so that a warp reads Wt consecutive words of 32 / Wt
// rows (a 128-byte segment of one row at Wt = 32).
// 1. Each thread ORs its range's words and their complements (8 rows'
//    loads in flight at a time): the bits some row holds and lacks.
// 2. Shuffles over the warp and a pass over the 16 warps' totals in
//    shared memory give each range the bits it wins: P and A from the
//    highest range that holds (lacks) a bit, first_seen from the lowest
//    that holds it, for the bits without an add-ok only.
// 3. Each winner walks its range in time order, 8 rows' loads at a
//    time, until it has found the bits it won, and appends an entry
//    (bits, rank) to its word's list in shared memory for each row that
//    is the first hit of some of them: a few entries, where a write a
//    bit would leave a winner that holds all 32 bits looping over them
//    while the CTA waits.
// 4. The CTA finishes its tile's elements, all threads at once: each
//    finds its element's entry in its word's three lists, their ranks'
//    read times, the latest read time and the element columns;
//    coalesced writes.
// One launch a call, no scratch in device memory. Times are float64
// with +-inf as the empty min and max; the rows need not be sorted: the
// C entry takes their order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "set_classify.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
// a thread's share of a 32-word tile: words (of a warp) and elements
constexpr int kPer = 32 / kWarps;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads, 2)
set_classify_kernel(const uint32_t* __restrict__ words,
                    const double* __restrict__ t_read,
                    const int32_t* __restrict__ order,
                    const double* __restrict__ invoke_t,
                    const double* __restrict__ ok_t,
                    const uint8_t* __restrict__ has_ok,
                    int32_t* __restrict__ code, uint8_t* __restrict__ stale,
                    double* __restrict__ latency, int R, int W, int E,
                    int lw) {
  // the tile's hits of first_seen, P and A: for quantity q and word
  // w - w0, s_hits[q][w - w0] entries (bits, the rank of their first hit)
  __shared__ uint32_t s_hit_bits[3][32][32];
  __shared__ int32_t s_hit_rank[3][32][32];
  __shared__ int32_t s_hits[3][32];
  // each warp's held and lacked bits a word of the tile
  __shared__ uint32_t s_tot[2][kWarps][32];
  // the tile's bits without an add-ok
  __shared__ uint32_t s_need[32];
  __shared__ double s_t_max;
  const int Wt = 1 << lw, n = 32 << lw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wl = lane & (Wt - 1);
  const int G = kWarps << (5 - lw);
  const int g = (warp << (5 - lw)) + (lane >> lw);
  const long long w0 = (long long)blockIdx.x << lw;
  const long long w = w0 + wl;
  const int L = (R + G - 1) / G;
  const int k0 = min(R, g * L), k1 = min(R, k0 + L);

  if (threadIdx.x < 3 * 32) s_hits[threadIdx.x >> 5][threadIdx.x & 31] = 0;
  // loads whose results wait for the scans: the add-oks of the words
  // warp + j kWarps, and the columns of this thread's elements of the
  // tile, i + j kThreads
  bool no_ok[kPer], hok[kPer] = {};
  double ok_v[kPer] = {}, inv_v[kPer] = {};
  for (int j = 0; j < kPer; ++j) {
    const long long e = (w0 + warp + j * kWarps) * 32 + lane;
    no_ok[j] = warp + j * kWarps < Wt && e < E && has_ok[e] == 0;
    const int i = threadIdx.x + j * kThreads;
    const long long f = w0 * 32 + i;
    if (i < n && f < E) {
      hok[j] = has_ok[f] != 0;
      ok_v[j] = ok_t[f];
      inv_v[j] = invoke_t[f];
    }
  }
  // the latest read time: one thread's load a CTA (every thread of every
  // CTA loading the same address queues them all on one line)
  if (threadIdx.x == 0) s_t_max = t_read[order[R - 1]];

  // 1. the bits some row of the range holds and lacks
  const uint32_t live = live_bits(w, E);
  uint32_t held = 0, lacked = 0;
  if (live) group_or(words, order, W, w, k0, k1, live, &held, &lacked);

  // 2. the bits the ranges above (hi) and below (lo) this one hold or
  // lack: inclusive suffix and prefix ORs over the warp's lanes of the
  // same word, then the other warps' totals
  uint32_t hi_h = 0, hi_l = 0, lo_h = 0, tot_h = held, tot_l = lacked;
  if (Wt < 32) {
    uint32_t ph = held;
    for (int d = Wt; d < 32; d <<= 1) {
      const uint32_t a = __shfl_down_sync(kFull, tot_h, d);
      const uint32_t b = __shfl_down_sync(kFull, tot_l, d);
      const uint32_t c = __shfl_up_sync(kFull, ph, d);
      if (lane + d < 32) {
        tot_h |= a;
        tot_l |= b;
      }
      if (lane >= d) ph |= c;
    }
    hi_h = __shfl_down_sync(kFull, tot_h, Wt);
    hi_l = __shfl_down_sync(kFull, tot_l, Wt);
    lo_h = __shfl_up_sync(kFull, ph, Wt);
    if (lane + Wt >= 32) hi_h = hi_l = 0;
    if (lane < Wt) lo_h = 0;
  }
  // lane wl < Wt holds the lowest range of word wl: the warp's total
  if (lane < Wt) {
    s_tot[0][warp][lane] = tot_h;
    s_tot[1][warp][lane] = tot_l;
  }
  for (int j = 0; j < kPer; ++j) {
    const unsigned m = __ballot_sync(kFull, no_ok[j]);
    if (lane == 0 && warp + j * kWarps < Wt) s_need[warp + j * kWarps] = m;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const uint32_t th = s_tot[0][i][wl], tl = s_tot[1][i][wl];
    hi_h |= i > warp ? th : 0u;
    hi_l |= i > warp ? tl : 0u;
    lo_h |= i < warp ? th : 0u;
  }
  const uint32_t win_p = held & ~hi_h, win_a = lacked & ~hi_l;
  const uint32_t win_f = held & s_need[wl] & ~lo_h;

  // 3. the winners' first hits, an entry a hit row
  const auto hit = [&](int q, uint32_t bits, int k) {
    const int i = atomicAdd(&s_hits[q][wl], 1);
    s_hit_bits[q][wl][i] = bits;
    s_hit_rank[q][wl][i] = k;
  };
  if (win_p | win_a)
    scan_down(words, order, W, w, k0, k1, win_p, win_a, hit);
  if (win_f) scan_up(words, order, W, w, k0, k1, win_f, hit);
  __syncthreads();

  // 4. the tile's elements
  const double t_max = s_t_max;
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const long long e = w0 * 32 + i;
    if (i >= n || e >= E) break;
    const int v = i >> 5, b = i & 31;
    int k[3];
    for (int q = 0; q < 3; ++q)
      k[q] = hit_rank(s_hit_bits[q][v], s_hit_rank[q][v], s_hits[q][v], b,
                      q == 0 ? R : -1);
    finish(rank_time(t_read, order, k[0], R, INFINITY),
           rank_time(t_read, order, k[1], R, -INFINITY),
           rank_time(t_read, order, k[2], R, -INFINITY), t_max,
           hok[j], ok_v[j], inv_v[j], code + e, stale + e, latency + e);
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

}  // namespace

// words uint32 [R, W] (bit j of word w: element 32 w + j), t_read f64
// [R], order int32 [R] (the rows' indices sorted by t_read), invoke_t and
// ok_t f64 [E], has_ok uint8 [E] -> code int32 [E], stale uint8 [E],
// latency f64 [E]. W = ceil(E / 32), R >= 1. Enqueues one launch on
// `stream`; returns its cudaGetLastError().
extern "C" int jt_set_classify(const void* words, const void* t_read,
                               const void* order, const void* invoke_t,
                               const void* ok_t, const void* has_ok,
                               void* code, void* stale, void* latency, int R,
                               int W, int E, void* stream) {
  if (E <= 0 || W <= 0 || R <= 0) return 0;
  static const int n_sm = sm_count();
  // the widest tile that still gives every SM one
  int lw = 5;
  while (lw > 0 && ((W + (1 << lw) - 1) >> lw) < n_sm) --lw;
  const int blocks = (W + (1 << lw) - 1) >> lw;
  set_classify_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const double*)t_read, (const int32_t*)order,
      (const double*)invoke_t, (const double*)ok_t, (const uint8_t*)has_ok,
      (int32_t*)code, (uint8_t*)stale, (double*)latency, R, W, E, lw);
  return (int)cudaGetLastError();
}
