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
// final table, bit for bit those of the reference's `run.resume`.
//
// What bounds it. The work is tiny (one table of at most 16 KB, a few
// words a row) and serial: every return depends on the one before, and a
// return is npend level passes and a kill, each ordered after the last.
// The bytes (events in, table in and out) take microseconds at 3.35 TB/s,
// and the operations far less; what bounds it is latency, the chain of
// barriers of one CTA, about npend + 4 of them a return.
//
// Design. One CTA per history, the event loop inside it, so a check is one
// launch. The table lives bit-packed in shared memory ([2^S][W] words,
// W = ceil(V / 32)). The transition is the CAS register's, a __device__
// copy of `_cas_step_ids` (jepsen_tpu_torch/models): at an invoke thread v
// computes nxt_s[v], a next-state vector that is the reference's one-hot
// [V, V] matrix in V words. The closure is a single level-order pass, as
// in chunk_product.cu: the rows are ordered by level popcount(r & pm) (the
// order is rebuilt at each return, one position per row from a binomial
// table), and the rows of level p read only rows of level p - 1, already
// final; a path of the closure adds at most npend bits, so this is the
// reference's fixpoint. The threads take (row, source word) items of a
// level and OR the image bits of the source words into the row with
// shared-memory atomics. The kill moves block r | 2^s onto block r and
// zeroes it, one thread a pair, counting the population on the way.
// Invokes need no barrier: the next return's first barrier orders them.
// The out-of-range flag depends only on each invoke's (f, a, b) and V, so
// it is computed for all invokes at once before the loop, and the loop
// stops at the return where the table empties (after it the table stays
// empty and no count changes).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 12;
constexpr int kBinomN = kMaxSlots + 1;
constexpr int kEvChunk = 512;  // events staged in shared memory at a time
constexpr int kInvoke = 0, kReturn = 1;

// copied from jepsen_tpu_torch/models/__init__.py _cas_step_ids: read v ok
// iff v == state or v == 0 (None); write v -> v; cas (a, b) ok iff
// state == a, -> b; any other f never applies
__device__ __forceinline__ int cas_step(int state, int f, int a, int b,
                                        bool* ok) {
  const bool is_read = f == 0, is_write = f == 1, is_cas = f == 2;
  const bool k = (is_read && (a == 0 || a == state)) || is_write ||
                 (is_cas && state == a);
  *ok = k;
  return is_write ? a : ((is_cas && k) ? b : state);
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
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kThreads)
frontier_dense_kernel(const int* __restrict__ kind,
                      const int* __restrict__ slot,
                      const int* __restrict__ fv, const int* __restrict__ av,
                      const int* __restrict__ bv,
                      const uint8_t* __restrict__ table0,  // [M, V] 0/1
                      uint8_t* __restrict__ table_out,     // [M, V] 0/1
                      int* __restrict__ out,  // alive, died, inexact, peak
                      int E, int S, int V) {
  extern __shared__ uint32_t smem[];
  const int M = 1 << S;
  const int W = (V + 31) >> 5;  // words a row
  const int tid = threadIdx.x;
  uint32_t* T = smem;                          // [M][W]
  int* nxt = (int*)(T + M * W);                // [S][V]
  int* binom = nxt + S * V;                    // [kBinomN][kBinomN]
  int* ev = binom + kBinomN * kBinomN;         // [5][kEvChunk]
  int* cnt = ev + 5 * kEvChunk;                // [2] population, by parity
  uint16_t* ord = (uint16_t*)(cnt + 2);        // [M] level order

  for (int e = tid; e < M * W; e += kThreads) {
    const int r = e / W, j = e - (e / W) * W;
    uint32_t w = 0u;
    for (int q = 0; q < 32 && j * 32 + q < V; ++q)
      w |= (table0[(size_t)r * V + j * 32 + q] != 0) ? 1u << q : 0u;
    T[e] = w;
  }
  for (int e = tid; e < S * V; e += kThreads) nxt[e] = -1;
  for (int q = tid; q < kBinomN * kBinomN; q += kThreads) {
    const int nn = q / kBinomN, kk = q % kBinomN;
    int r = 1;
    for (int i = 0; i < kk; ++i) r = r * (nn - i) / (i + 1);  // 0 if kk > nn
    binom[q] = r;
  }
  if (tid < 2) cnt[tid] = 0;
  // inexact: an invoke's transition leaves [0, V) for some state
  bool oob = false;
  for (int e = tid; e < E; e += kThreads) {
    if (kind[e] != kInvoke) continue;
    const int f = fv[e], a = av[e], b = bv[e];
    for (int v = 0; v < V && !oob; ++v) {
      bool ok;
      const int st = cas_step(v, f, a, b, &ok);
      oob = ok && (st < 0 || st >= V);
    }
  }
  const int inexact = __syncthreads_or(oob);

  int pm = 0, died = -1, peak = 1, par = 0;
  bool alive = true;
  for (int e0 = 0; e0 < E && alive; e0 += kEvChunk) {
    const int n = min(kEvChunk, E - e0);
    __syncthreads();  // every thread is done with the last chunk's events
    for (int k = tid; k < n; k += kThreads) {
      ev[k] = kind[e0 + k];
      ev[kEvChunk + k] = slot[e0 + k];
      ev[2 * kEvChunk + k] = fv[e0 + k];
      ev[3 * kEvChunk + k] = av[e0 + k];
      ev[4 * kEvChunk + k] = bv[e0 + k];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const int kd = ev[k], s = ev[kEvChunk + k];
      if (kd == kInvoke) {
        const int f = ev[2 * kEvChunk + k], a = ev[3 * kEvChunk + k],
                  b = ev[4 * kEvChunk + k];
        for (int v = tid; v < V; v += kThreads) {
          bool ok;
          const int st = cas_step(v, f, a, b, &ok);
          nxt[s * V + v] = (ok && st >= 0 && st < V) ? st : -1;
        }
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
          int m = r & pm;
          while (m) {
            const int t = __ffs(m) - 1;
            m &= m - 1;
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
      // kill: row r <- row r | 2^s for r without bit s, row r | 2^s <- 0,
      // counting the closed table's population
      int pop = 0;
      bool any = false;
      for (int it = tid; it < (M >> 1) * W; it += kThreads) {
        const int q = it / W, j = it - (it / W) * W;
        const int lo = ((q >> s) << (s + 1)) | (q & ((1 << s) - 1));
        const int hi = lo | (1 << s);
        const uint32_t x = T[hi * W + j];
        pop += __popc(x) + __popc(T[lo * W + j]);
        any |= x != 0u;
        T[lo * W + j] = x;
        T[hi * W + j] = 0u;
      }
      pop = warp_sum(pop);
      if ((tid & 31) == 0) atomicAdd(&cnt[par], pop);
      const bool now_alive = __syncthreads_or(any);
      peak = max(peak, cnt[par]);
      // the other parity's counter is next read after two more barriers
      if (tid == 0) cnt[par ^ 1] = 0;
      par ^= 1;
      pm &= ~(1 << s);
      if (!now_alive) {
        died = e0 + k;
        alive = false;
        break;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < M * V; e += kThreads) {
    const int r = e / V, v = e - (e / V) * V;
    table_out[e] = (uint8_t)((T[r * W + (v >> 5)] >> (v & 31)) & 1u);
  }
  if (tid == 0) {
    out[0] = alive ? 1 : 0;
    out[1] = died;
    out[2] = inexact ? 1 : 0;
    out[3] = peak;
  }
}

}  // namespace

extern "C" int jt_frontier_dense(void* kind, void* slot, void* f, void* a,
                                 void* b, void* table0, void* table_out,
                                 void* out, int E, int S, int V,
                                 void* stream) {
  if (S < 1 || S > kMaxSlots || V < 1) return (int)cudaErrorInvalidValue;
  const int M = 1 << S;
  const size_t smem = ((size_t)M * ((V + 31) / 32) + (size_t)S * V +
                       kBinomN * kBinomN + 5 * kEvChunk + 2) *
                          sizeof(int) +
                      (size_t)M * sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      frontier_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  frontier_dense_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)kind, (const int*)slot, (const int*)f, (const int*)a,
      (const int*)b, (const uint8_t*)table0, (uint8_t*)table_out, (int*)out,
      E, S, V);
  return (int)cudaGetLastError();
}
