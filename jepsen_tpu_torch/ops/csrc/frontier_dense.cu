// Dense-table frontier scan for Hopper (sm_90a).
//
// Replaces the XLA program jepsen_tpu/ops/jitlin.py `_build_dense_step`
// (:249-377; its lax.scan over events, closure :287-306, step :308-336),
// the `jitlin-device` rung's exact frontier when 2^S masks x V states is
// small (`_dense_ok`: S <= 12, V <= 512, S * 2^S * V <= 2^21).
//
// What it computes, for one history, from the table T0[2^S][V]: events in
// order; an invoke of slot s sets s's transition v -> nxt_s[v] (-1 where
// the op does not apply) and marks s pending; a return of slot s closes T
// under "linearize a pending slot t not in the mask" (row r | 2^t gets the
// image under nxt_t of row r), keeps the rows that hold bit s with the bit
// cleared, and counts the closed table's population into peak. alive and
// died follow the table's emptiness; inexact is set when a transition of
// any invoke leaves [0, V). Results: alive, died, inexact, peak and the
// final table, bit for bit those of the reference's `run.resume`; and the
// returns the scan closed on the warp path and in all (the path taken,
// which the caller holds against the plain version's count).
//
// What bounds it. The work is tiny (one table of at most 16 KB, a few
// words a row) and serial: every return depends on the one before, and a
// return is npend level rounds and a kill, each ordered after the last.
// The bytes (events in, table in and out) take microseconds at 3.35 TB/s,
// and the operations far less; what bounds it is latency, the chain of
// dependent steps a return takes.
//
// Design. One CTA per history, the event loop inside it, so a check is one
// launch, and a batch of keys is one launch too: one CTA a key (grid = B),
// each reading its key's events [off[b], off[b + 1]) of one upload and
// writing its own row of results, with `died` the index in the key's own
// stream (the reference vmaps the scan over keys, jitlin.py:2012). A batch
// builds each key's initial table, (mask 0, init_state) alone, in the
// kernel and writes no final table; the single-history entry is the same
// kernel at B = 1 with the table given and written back (the resume form).
// A key whose table empties ends its CTA's loop alone: every branch that
// stops a loop is uniform over the CTA (the warp path's warp 0 leaves its
// loop while the other warps wait at the barrier after it; the CTA path's
// `alive` comes from __syncthreads_or), so no thread leaves before a
// barrier its other warps still reach. The warp path's CTAs use little
// shared memory (the events' stage and the nibble tables, about 16 KB), so
// several keys share an SM. The transition is the launch's model
// (frontier_model.cuh): the CAS register's or the multi-register map's,
// whose (keys, values), digit powers and their reciprocals come with the
// launch; the kernel is instantiated for each (kModel). Every transition
// the kernel takes goes through the model's step (model_steps), so one
// step serves both paths' tables and the out-of-range flag (the warp
// path steps a lane's 4 states of an invoke together); a multi-register
// table is bucketed past the (V + 1)^K map states (216 to 256 at 3 x 5),
// and the flag, like the reference's, also covers the states past them,
// which no history reaches: a step keeps the map's states in the map, so
// the flag steps those padding states alone (first_leaving_state) and is
// still the reference's, bit for bit. The closure runs level by
// level: a row's level is popcount(r & pm), and the rows of level p read
// only rows r ^ 2^t of level p - 1, already final; a path of the closure
// adds at most npend bits, so this is the reference's fixpoint. The kill
// moves row r | 2^s onto row r and zeroes it, counting the population on
// the way. The whole CTA unpacks the table and computes the out-of-range
// flag of every invoke up front (it depends only on each invoke's (f, a, b)
// and V); the loop stops at the return where the table empties (after it
// the table stays empty and no count changes). Two paths, chosen by shape:
// - Warp path (one-word rows and at most kWarpCost = 16 for rows a lane x
//   nibbles a row: S <= 7 at V <= 16, S <= 6 at V <= 32; the main path's
//   S = 5, V = 16). Warp 0 runs the event loop alone, no CTA barrier orders
//   a return, and the table lives in its registers (warp_scan_rows); an
//   image is an OR of per-nibble tables built at the invoke, so no
//   level-order table and no bit-serial chain.
// - CTA path (V > 32, or more rows): the table bit-packed in shared memory
//   ([2^S][W] words, W = ceil(V / 32)), the invoke's next-state vector
//   nxt_s (the reference's one-hot [V, V] matrix in V words), the rows
//   ordered by level at each return (one position per row from a binomial
//   table), the threads taking the (row, source word) items of a level and
//   ORing the image bits with shared-memory atomics, a barrier after each
//   level. Here each barrier orders enough work: with rows of many words
//   one warp alone was slower, and past the warp path's bound its serial
//   rounds cost more than the barriers (timed on the card; PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "frontier_model.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 12;
constexpr int kBinomN = kMaxSlots + 1;
constexpr int kEvChunk = 512;  // events staged in shared memory at a time
// the warp path's tables: rows a lane x nibbles a row at most this (the
// closure's loads a source and round); past it the CTA path is faster
constexpr int kWarpCost = 16;
constexpr int kInvoke = 0, kReturn = 1;
constexpr unsigned kFull = 0xffffffffu;

// nxt[v] of an invoke's op: its next state, -1 where the op does not apply
// or the state leaves [0, V)
template <int kModel>
__device__ __forceinline__ int next_state(const Model& m, int v, int f, int a,
                                          int b, int V) {
  bool ok;
  const int st = model_step<kModel>(m, v, f, a, b, &ok);
  return (ok && st >= 0 && st < V) ? st : -1;
}

// copied from chunk_product.cu: position of mask a when the masks are
// ordered by level popcount(a & pm), then by the colex rank of a's pending
// bits, then by its other bits
__device__ __forceinline__ int level_order_pos(int a, int pm, int S,
                                               const int* binom) {
  int l = 0, np = 0, nf = 0, xr = 0, y = 0;
  for (int b = 0; b < S; ++b) {
    const int bit = (a >> b) & 1;
    if ((pm >> b) & 1) {
      if (bit) xr += binom[np * kBinomN + ++l];
      ++np;
    } else {
      y |= bit << nf++;
    }
  }
  int off = 0;
  for (int q = 0; q < l; ++q) off += binom[np * kBinomN + q];
  return ((off + xr) << nf) | y;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// The kill of slot s by items (pair, word) it = start, start + stride, ...:
// row r <- row r | 2^s for r without bit s, row r | 2^s <- 0. Returns the
// population the items held and whether any moved row was not empty.
__device__ __forceinline__ int kill_items(uint32_t* T, int s, int M, int W,
                                          int start, int stride, bool* any) {
  int pop = 0;
  for (int it = start; it < (M >> 1) * W; it += stride) {
    const int q = it / W, j = it - (it / W) * W;
    const int lo = ((q >> s) << (s + 1)) | (q & ((1 << s) - 1));
    const int hi = lo | (1 << s);
    const uint32_t x = T[hi * W + j];
    pop += __popc(x) + __popc(T[lo * W + j]);
    *any |= x != 0u;
    T[lo * W + j] = x;
    T[hi * W + j] = 0u;
  }
  return pop;
}

// Stages events [e0, e0 + n) into ev ([5][kEvChunk]) by threads
// first .. first + nthr - 1.
__device__ __forceinline__ void stage_events(
    int* ev, const int* kind, const int* slot, const int* fv, const int* av,
    const int* bv, int e0, int n, int first, int nthr) {
  for (int k = first; k < n; k += nthr) {
    ev[k] = kind[e0 + k];
    ev[kEvChunk + k] = slot[e0 + k];
    ev[2 * kEvChunk + k] = fv[e0 + k];
    ev[3 * kEvChunk + k] = av[e0 + k];
    ev[4 * kEvChunk + k] = bv[e0 + k];
  }
}

// The warp path for one-word rows (V <= 32), run by warp 0 alone: row
// r = lane + 32 i lives in the lane's register x[i] (kRows = max(1, 2^S /
// 32) rows a lane; lanes past 2^S hold empty rows that stay empty). Round p
// of the closure ORs into the rows of level p the images of their rows
// r ^ 2^t: a __shfl_xor_sync for t < 5, the register x[i ^ 2^(t-5)]
// otherwise (t and i unrolled, so every index is known to the compiler).
// An image is an OR of per-nibble tables (nib[t][j][n]: the states that
// the nibble n at bits 4j .. 4j + 3 steps to under t's op), built at the
// invoke, so a source costs kNib = ceil(V / 4) (4 or 8) loads that do not
// wait on each other; the round takes no branch on the data. The kill moves
// registers or shuffles; __reduce_add_sync counts the population and
// __any_sync tells emptiness. Returns with x written back to T.
template <int kRows, int kNib, int kModel>
__device__ __forceinline__ void warp_scan_rows(const int* kind, const int* slot,
                               const int* fv, const int* av, const int* bv,
                               uint32_t* T, uint32_t* nib, int* ev, int E,
                               int S, int V, const Model& md, int lane,
                               bool* alive_out,
                               int* died_out, int* peak_out,
                               int* returns_out) {
  // the slots a table of 32 * kRows rows can have: S itself past 32 rows
  constexpr int kSlots = 5 + (kRows >= 2) + (kRows >= 4);
  const int M = 1 << S;
  uint32_t x[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    x[i] = lane + 32 * i < M ? T[lane + 32 * i] : 0u;
  int pm = 0, died = -1, peak = 1, returns = 0;
  bool alive = true;
  for (int e = 0; e < E && alive; ++e) {
    const int k = e % kEvChunk;
    if (k == 0) {
      __syncwarp();  // every lane is done with the last chunk's events
      stage_events(ev, kind, slot, fv, av, bv, e, min(kEvChunk, E - e), lane,
                   32);
      __syncwarp();
    }
    const int kd = ev[k], s = ev[kEvChunk + k];
    if (kd == kInvoke) {
      const int f = ev[2 * kEvChunk + k], a = ev[3 * kEvChunk + k],
                b = ev[4 * kEvChunk + k];
      // lane takes nibble j = lane / 4 (states 4j .. 4j + 3; none past V)
      // and the 4 nibble values n = 4 (lane % 4) .. + 3; the 4 states
      // step together (one decode of the op, 4 chains interleaved)
      const int j = lane >> 2;
      const int v4[4] = {4 * j, 4 * j + 1, 4 * j + 2, 4 * j + 3};
      int st[4];
      bool ok[4];
      model_steps<kModel, 4>(md, v4, f, a, b, st, ok);
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = v4[i] < V && ok[i] && st[i] >= 0 && st[i] < V ? 1u << st[i]
                                                             : 0u;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int n = 4 * (lane & 3) + m;
        nib[s * 128 + j * 16 + n] = ((n & 1) ? w[0] : 0u) |
                                    ((n & 2) ? w[1] : 0u) |
                                    ((n & 4) ? w[2] : 0u) |
                                    ((n & 8) ? w[3] : 0u);
      }
      pm |= 1 << s;
      continue;
    }
    if (kd != kReturn) continue;
    __syncwarp();  // the invokes' tables
    const int npend = __popc(pm);
    for (int p = 1; p <= npend; ++p) {
      // a round's sources are the rows as it starts (rows of level p read
      // rows of level p - 1), so the slots' shuffles and loads do not wait
      // on each other; nor does any branch on a slot or on the data
      uint32_t acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0u;
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        const bool on = t < S && ((pm >> t) & 1);
        const uint32_t* nt = nib + t * 128;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const uint32_t y =
              t < 5 ? __shfl_xor_sync(kFull, x[i], 1 << (t < 5 ? t : 0))
                    : x[i ^ ((t < 5 ? 0 : 1 << (t - 5)) & (kRows - 1))];
          const int r = lane + 32 * i;
          // kNib independent loads (a nibble past V is 0: empty image)
          uint32_t img = 0u;
#pragma unroll
          for (int j = 0; j < kNib; ++j)
            img |= nt[j * 16 + ((y >> (4 * j)) & 15)];
          acc[i] |= (on && __popc(r & pm) == p && ((r >> t) & 1)) ? img : 0u;
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) x[i] |= acc[i];
    }
    __syncwarp();  // every lane has read the tables a later invoke rewrites
    ++returns;
    // kill: row r <- row r | 2^s for r without bit s, row r | 2^s <- 0
    int pop = 0;
#pragma unroll
    for (int i = 0; i < kRows; ++i) pop += __popc(x[i]);
    pop = __reduce_add_sync(kFull, pop);
    if (s < 5) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const uint32_t y = __shfl_xor_sync(kFull, x[i], 1 << s);
        x[i] = ((lane >> s) & 1) ? 0u : y;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        if (s - 5 != q || (1 << q) >= kRows) continue;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (i & (1 << q)) continue;
          x[i] = x[i | (1 << q)];
          x[i | (1 << q)] = 0u;
        }
      }
    }
    bool any = false;
#pragma unroll
    for (int i = 0; i < kRows; ++i) any |= x[i] != 0u;
    peak = max(peak, pop);
    pm &= ~(1 << s);
    if (!__any_sync(kFull, any)) {
      died = e;
      alive = false;
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (lane + 32 * i < M) T[lane + 32 * i] = x[i];
  *alive_out = alive;
  *died_out = died;
  *peak_out = peak;
  *returns_out = returns;
}

// kRows > 0: the warp path with kRows rows a lane and rows of kNib
// nibbles; kRows == 0: the CTA path. kModel: the transition.
template <int kRows, int kNib, int kModel>
__global__ void __launch_bounds__(kThreads, 1)
frontier_dense_kernel(const int* __restrict__ kind,
                      const int* __restrict__ slot,
                      const int* __restrict__ fv, const int* __restrict__ av,
                      const int* __restrict__ bv,
                      // [B + 1] key b's events are [off[b], off[b + 1]);
                      // null: one key, events [0, E)
                      const int* __restrict__ off,
                      // [M, V] 0/1; null: (mask 0, init_state) alone
                      const uint8_t* __restrict__ table0,
                      uint8_t* __restrict__ table_out,  // [M, V] 0/1 or null
                      // [B][6] alive, died, inexact, peak, returns closed
                      // on the warp path, returns closed
                      int* __restrict__ out,
                      int E, int S, int V, int init_state,
                      const Model model) {
  extern __shared__ uint32_t smem[];
  if (off != nullptr) {
    const int e0 = off[blockIdx.x];
    E = off[blockIdx.x + 1] - e0;
    kind += e0;
    slot += e0;
    fv += e0;
    av += e0;
    bv += e0;
  }
  out += 6 * blockIdx.x;
  const int M = 1 << S;
  const int W = (V + 31) >> 5;  // words a row
  const int tid = threadIdx.x, lane = tid & 31;
  constexpr bool kWarp = kRows > 0;
  uint32_t* T = smem;                          // [M][W]
  int* ev = (int*)(T + M * W);                 // [5][kEvChunk]
  int* nxt = ev + 5 * kEvChunk;                // [S][V]; warp path:
  uint32_t* nib = (uint32_t*)nxt;              // [kMaxSlots][8][16] images
  int* cnt = nxt + (kWarp ? kMaxSlots * 128 : S * V);  // CTA path: [2]
  int* binom = cnt + 2;                        // CTA path: [kBinomN]^2
  uint16_t* ord = (uint16_t*)(binom + kBinomN * kBinomN);  // CTA path: [M]

  for (int e = tid; e < M * W; e += kThreads) {
    const int r = e / W, j = e - (e / W) * W;
    uint32_t w = 0u;
    if (table0 == nullptr) {
      // row 0 is word-row 0: the initial state's word
      if (e == (init_state >> 5)) w = 1u << (init_state & 31);
    } else {
      for (int q = 0; q < 32 && j * 32 + q < V; ++q)
        w |= (table0[(size_t)r * V + j * 32 + q] != 0) ? 1u << q : 0u;
    }
    T[e] = w;
  }
  if (!kWarp)
    for (int e = tid; e < S * V; e += kThreads) nxt[e] = -1;
  if (!kWarp) {
    for (int q = tid; q < kBinomN * kBinomN; q += kThreads) {
      const int nn = q / kBinomN, kk = q % kBinomN;
      int r = 1;
      for (int i = 0; i < kk; ++i) r = r * (nn - i) / (i + 1);  // 0 if kk > nn
      binom[q] = r;
    }
    if (tid < 2) cnt[tid] = 0;
  }
  // inexact: an invoke's transition leaves [0, V) for some state; only
  // the states from first_leaving_state on can (frontier_model.cuh)
  bool oob = false;
  const int v_leave = first_leaving_state<kModel>(model, V);
  for (int e = tid; e < E; e += kThreads) {
    if (kind[e] != kInvoke) continue;
    const int f = fv[e], a = av[e], b = bv[e];
    for (int v = v_leave; v < V && !oob; ++v) {
      bool ok;
      const int st = model_step<kModel>(model, v, f, a, b, &ok);
      oob = ok && (st < 0 || st >= V);
    }
  }
  const int inexact = __syncthreads_or(oob);

  int died = -1, peak = 1, returns = 0;
  bool alive = true;
  if (kWarp) {
    // warp 0 runs the event loop; the others wait at the barrier below
    if (tid < 32)
      warp_scan_rows<(kWarp ? kRows : 1), kNib, kModel>(
          kind, slot, fv, av, bv, T, nib, ev, E, S, V, model, lane, &alive,
          &died, &peak, &returns);
    __syncthreads();
  } else {
    int pm = 0, par = 0;
    for (int e0 = 0; e0 < E && alive; e0 += kEvChunk) {
      const int n = min(kEvChunk, E - e0);
      __syncthreads();  // every thread is done with the last chunk's events
      stage_events(ev, kind, slot, fv, av, bv, e0, n, tid, kThreads);
      __syncthreads();
      for (int k = 0; k < n; ++k) {
        const int kd = ev[k], s = ev[kEvChunk + k];
        if (kd == kInvoke) {
          const int f = ev[2 * kEvChunk + k], a = ev[3 * kEvChunk + k],
                    b = ev[4 * kEvChunk + k];
          for (int v = tid; v < V; v += kThreads)
            nxt[s * V + v] = next_state<kModel>(model, v, f, a, b, V);
          pm |= 1 << s;
          continue;
        }
        if (kd != kReturn) continue;
        __syncthreads();  // nxt of the invokes since the last return
        for (int r = tid; r < M; r += kThreads)
          ord[level_order_pos(r, pm, S, binom)] = (uint16_t)r;
        __syncthreads();
        // closure, level by level: rows of level p read rows of level p - 1
        const int npend = __popc(pm), nf = S - npend;
        int first = 1 << nf;  // level-0 rows come first and keep their bits
        for (int p = 1; p <= npend; ++p) {
          const int count = binom[npend * kBinomN + p] << nf;
          for (int it = tid; it < count * W; it += kThreads) {
            const int r = ord[first + it / W];
            const int j = it - (it / W) * W;
            for (int m = r & pm; m; m &= m - 1) {
              const int t = __ffs(m) - 1;
              // one source word j of row r ^ 2^t
              uint32_t src = T[(r ^ (1 << t)) * W + j];
              const int* nx = nxt + t * V + j * 32;
              while (src) {
                const int q = __ffs((int)src) - 1;
                src &= src - 1;
                const int w = nx[q];
                if (w >= 0) atomicOr(&T[r * W + (w >> 5)], 1u << (w & 31));
              }
            }
          }
          first += count;
          __syncthreads();
        }
        // kill, counting the closed table's population
        bool any = false;
        const int pop = warp_sum(kill_items(T, s, M, W, tid, kThreads, &any));
        if (lane == 0) atomicAdd(&cnt[par], pop);
        const bool now_alive = __syncthreads_or(any);
        peak = max(peak, cnt[par]);
        // the other parity's counter is next read after two more barriers
        if (tid == 0) cnt[par ^ 1] = 0;
        par ^= 1;
        pm &= ~(1 << s);
        ++returns;
        if (!now_alive) {
          died = e0 + k;
          alive = false;
          break;
        }
      }
    }
    __syncthreads();
  }
  if (table_out != nullptr) {
    for (int e = tid; e < M * V; e += kThreads) {
      const int r = e / V, v = e - (e / V) * V;
      table_out[e] = (uint8_t)((T[r * W + (v >> 5)] >> (v & 31)) & 1u);
    }
  }
  if (tid == 0) {  // thread 0 is lane 0 of the warp that ran the warp path
    out[0] = alive ? 1 : 0;
    out[1] = died;
    out[2] = inexact ? 1 : 0;
    out[3] = peak;
    out[4] = kWarp ? returns : 0;
    out[5] = returns;
  }
}

typedef void (*DenseKernel)(const int*, const int*, const int*, const int*,
                            const int*, const int*, const uint8_t*, uint8_t*,
                            int*, int, int, int, int, const Model);

// The instantiation for model kModel, rows rows a lane (0: the CTA path)
// and rows of nib nibbles.
template <int kModel>
DenseKernel pick_kernel(int rows, int nib) {
  if (nib == 4) {
    return rows == 1   ? frontier_dense_kernel<1, 4, kModel>
           : rows == 2 ? frontier_dense_kernel<2, 4, kModel>
           : rows == 4 ? frontier_dense_kernel<4, 4, kModel>
                       : frontier_dense_kernel<0, 0, kModel>;
  }
  return rows == 1   ? frontier_dense_kernel<1, 8, kModel>
         : rows == 2 ? frontier_dense_kernel<2, 8, kModel>
                     : frontier_dense_kernel<0, 0, kModel>;
}

// Launches the scan of B keys (off given) or of one history (off null,
// its E events), one CTA a key.
int launch(const void* kind, const void* slot, const void* f, const void* a,
           const void* b, const void* off, const void* table0,
           void* table_out, void* out, int B, int E, int S, int V,
           int init_state, int code, int nk, int nv, void* stream) {
  Model model;
  if (S < 1 || S > kMaxSlots || V < 1 || B < 1 || init_state < 0 ||
      init_state >= V || !make_model(code, nk, nv, &model))
    return (int)cudaErrorInvalidValue;
  const size_t M = (size_t)1 << S, words = M * ((V + 31) / 32);
  // the warp path: one-word rows, kWarpCost bounding rows a lane x nibbles
  const int nib = V <= 16 ? 4 : 8;
  const int rows = V <= 32 && (M > 32 ? (int)M / 32 : 1) * nib <= kWarpCost
                       ? (M > 32 ? (int)M / 32 : 1)
                       : 0;
  size_t smem =
      (words + 5 * kEvChunk + (rows ? kMaxSlots * 128 : (size_t)S * V) + 2) *
      sizeof(int);
  if (!rows)
    smem += kBinomN * kBinomN * sizeof(int) + M * sizeof(uint16_t);
  const DenseKernel kernel = code == kMultiRegister
                                 ? pick_kernel<kMultiRegister>(rows, nib)
                                 : pick_kernel<kCas>(rows, nib);
  const cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)kind, (const int*)slot, (const int*)f, (const int*)a,
      (const int*)b, (const int*)off, (const uint8_t*)table0,
      (uint8_t*)table_out, (int*)out, E, S, V, init_state, model);
  return (int)cudaGetLastError();
}

}  // namespace

// One history from the table table0, the final table into table_out, its
// results into out[0, 6); the transition is the model (code, nk, nv) of
// frontier_model.cuh.
extern "C" int jt_frontier_dense(void* kind, void* slot, void* f, void* a,
                                 void* b, void* table0, void* table_out,
                                 void* out, int E, int S, int V, int code,
                                 int nk, int nv, void* stream) {
  return launch(kind, slot, f, a, b, nullptr, table0, table_out, out, 1, E,
                S, V, 0, code, nk, nv, stream);
}

// B keys, key k's events [off[k], off[k + 1]) of the columns, each from
// (mask 0, init_state) alone; key k's results into out[6k, 6k + 6).
extern "C" int jt_frontier_dense_batch(void* kind, void* slot, void* f,
                                       void* a, void* b, void* off, void* out,
                                       int B, int S, int V, int init_state,
                                       int code, int nk, int nv,
                                       void* stream) {
  return launch(kind, slot, f, a, b, off, nullptr, nullptr, out, B, 0, S, V,
                init_state, code, nk, nv, stream);
}
