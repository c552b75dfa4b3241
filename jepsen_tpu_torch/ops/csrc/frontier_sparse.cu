// Sparse-frontier scan for Hopper (sm_90a).
//
// Replaces the XLA program jepsen_tpu/ops/jitlin.py `_build_step`
// (:116-246; dedup_compact :129-140, closure :142-171, step :173-206), the
// `jitlin-device` rung's frontier when the dense table is out of regime:
// a capacity-K list of (uint32 mask, int32 state) configurations.
//
// What it computes, for one history, from the list (mask0, state0): events
// in order; an invoke of slot s sets s's op (f, a, b) and marks s pending;
// a return of slot s first runs the closure passes, then the kill. A pass
// expands every valid entry (mask != 0xFFFFFFFF) by every pending slot t
// not in its mask whose op applies to its state, into (mask | 2^t, state'),
// and keeps the K lexicographically smallest distinct pairs of the entries
// and their expansions (mask unsigned, then state signed; the sentinel
// pair (0xFFFFFFFF, 0x7FFFFFFF) last), setting overflow when a (K+1)-th
// distinct pair with a valid mask exists. Passes stop when the count of
// valid entries does not grow, or after S. The kill keeps the entries
// holding bit s, with the bit cleared. peak is the largest count a
// closure ended with. Results: alive, died, overflow, peak and the final
// list, bit for bit those of the reference's `run.resume`.
//
// What bounds it. The data is small (events in, 2 KB of list in and out at
// K = 256) and the work serial: each pass depends on the one before and
// each return on the last, and a pass is a sort with a barrier at each of
// its log2(n)(log2(n) + 1) / 2 steps. So latency bounds it, the chain of
// barriers of one CTA, far from the byte or operation bound.
//
// Design. One CTA per history, the event loop inside it, so a check is one
// launch. A pair is one 64-bit key, mask << 32 | (state ^ 2^31), which
// orders as the reference's two-key sort and makes the sentinel pair the
// largest key. The list stays sorted and distinct in shared memory. A pass
// gathers the list's keys and the valid expansions into a candidate buffer
// in shared memory (at most K * (S + 1) keys; the transition is a
// __device__ copy of the CAS register's `_cas_step_ids`), sorts only the
// candidates that exist, rounded up to a power of two (a bitonic sort; one
// warp with __syncwarp when there are at most 64), and keeps the first K
// distinct keys by a block-wide prefix count: the same K pairs as the
// reference's sort of all K * (S + 1) slots, since both keep the K
// smallest distinct pairs. The kill needs no sort: clearing one bit in the
// masks that hold it keeps their order and their distinctness, so it is a
// stable compaction. After the frontier empties nothing changes any more
// (an empty list has no candidates), so the loop stops there.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 32;
constexpr int kEvChunk = 512;  // events staged in shared memory at a time
constexpr int kInvoke = 0, kReturn = 1;
constexpr u64 kSentinel = ~0ull;  // (0xFFFFFFFF, 0x7FFFFFFF)
constexpr uint32_t kSentinelMask = 0xFFFFFFFFu;

__device__ __forceinline__ u64 pack(uint32_t mask, int state) {
  return ((u64)mask << 32) | (u64)((uint32_t)state ^ 0x80000000u);
}
__device__ __forceinline__ uint32_t key_mask(u64 k) {
  return (uint32_t)(k >> 32);
}
__device__ __forceinline__ int key_state(u64 k) {
  return (int)((uint32_t)k ^ 0x80000000u);
}

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

// Ascending bitonic sort of c[0, n), n a power of two, by the threads
// lane0 .. lane0 + nthr - 1 of the CTA; `warp_only` syncs with __syncwarp.
__device__ __forceinline__ void bitonic(u64* c, int n, int idx, int nthr,
                                        bool warp_only) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = idx; i < (n >> 1); i += nthr) {
        const int lo = ((i / j) * 2 * j) + (i % j);
        const int hi = lo + j;
        const u64 x = c[lo], y = c[hi];
        if ((x > y) == ((lo & k) == 0)) {
          c[lo] = y;
          c[hi] = x;
        }
      }
      if (warp_only) __syncwarp(); else __syncthreads();
    }
  }
}

// Block-wide exclusive prefix sum of one int a thread; also returns the
// total. Ends with a barrier; `scratch` holds kWarps + 1 ints.
__device__ __forceinline__ int block_scan(int x, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int t = scratch[w];
      scratch[w] = run;
      run += t;
    }
    scratch[kWarps] = run;
  }
  __syncthreads();
  *total = scratch[kWarps];
  const int out = scratch[warp] + incl - x;
  __syncthreads();  // scratch is free again
  return out;
}

__global__ void __launch_bounds__(kThreads)
frontier_sparse_kernel(const int* __restrict__ kind,
                       const int* __restrict__ slot,
                       const int* __restrict__ fv, const int* __restrict__ av,
                       const int* __restrict__ bv,
                       const uint32_t* __restrict__ mask0,
                       const int* __restrict__ state0,
                       uint32_t* __restrict__ mask_out,
                       int* __restrict__ state_out,
                       int* __restrict__ out,  // alive, died, overflow, peak
                       int E, int S, int K, int cap) {
  extern __shared__ u64 smem64[];
  const int tid = threadIdx.x;
  u64* F = smem64;                      // [K] the list, sorted, distinct
  u64* C = F + K;                       // [cap] candidates
  int* ev = (int*)(C + cap);            // [5][kEvChunk]
  int* cur = ev + 5 * kEvChunk;         // [3][kMaxSlots] open ops f, a, b
  int* scratch = cur + 3 * kMaxSlots;   // [kWarps + 1]
  int* nc = scratch + kWarps + 1;       // [1] candidate count

  // the list as given (the first closure pass sorts and dedups it)
  for (int i = tid; i < K; i += kThreads) F[i] = pack(mask0[i], state0[i]);
  for (int i = tid; i < 3 * kMaxSlots; i += kThreads) cur[i] = 0;

  int pm = 0, died = -1, peak = 1;
  bool alive = true, overflow = false;
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
        if (tid == 0) {
          cur[s] = ev[2 * kEvChunk + k];
          cur[kMaxSlots + s] = ev[3 * kEvChunk + k];
          cur[2 * kMaxSlots + s] = ev[4 * kEvChunk + k];
        }
        pm |= 1 << s;
        continue;
      }
      if (kd != kReturn) continue;
      __syncthreads();  // the last kill's list and the invokes' ops
      // --- closure passes -------------------------------------------------
      int loc = 0;
      for (int i = tid; i < K; i += kThreads)
        loc += key_mask(F[i]) != kSentinelMask;
      int count;
      block_scan(loc, scratch, &count);
      for (int pass = 0; pass < S; ++pass) {
        if (tid == 0) *nc = 0;
        __syncthreads();
        // the list's keys, then each valid entry's expansions
        for (int i = tid; i < K * (S + 1); i += kThreads) {
          const int ki = i / (S + 1), t = i - ki * (S + 1) - 1;
          const u64 key = F[ki];
          if (key == kSentinel) continue;
          u64 cand = key;
          if (t >= 0) {
            const uint32_t m = key_mask(key);
            if (m == kSentinelMask || !((pm >> t) & 1) || ((m >> t) & 1u))
              continue;
            bool ok;
            const int st = cas_step(key_state(key), cur[t], cur[kMaxSlots + t],
                                    cur[2 * kMaxSlots + t], &ok);
            if (!ok) continue;
            cand = pack(m | (1u << t), st);
            if (cand == kSentinel) continue;
          }
          C[atomicAdd(nc, 1)] = cand;
        }
        __syncthreads();
        const int ncand = *nc;
        int n2 = 1;
        while (n2 < ncand) n2 <<= 1;
        for (int i = ncand + tid; i < n2; i += kThreads) C[i] = kSentinel;
        __syncthreads();
        if (n2 <= 64) {
          if (tid < 32) bitonic(C, n2, tid, 32, true);
          __syncthreads();
        } else {
          bitonic(C, n2, tid, kThreads, false);
        }
        // keep the first K distinct keys: thread tid takes a contiguous
        // run of the sorted candidates
        const int per = (n2 + kThreads - 1) / kThreads;
        const int lo = min(n2, tid * per), hi = min(n2, lo + per);
        int d = 0;
        for (int i = lo; i < hi; ++i)
          d += C[i] != kSentinel && (i == 0 || C[i] != C[i - 1]);
        int distinct;
        int pos = block_scan(d, scratch, &distinct);
        int c2 = 0;
        bool ovf = false;
        for (int i = lo; i < hi; ++i) {
          if (C[i] == kSentinel || (i > 0 && C[i] == C[i - 1])) continue;
          if (pos < K) {
            F[pos] = C[i];
            c2 += key_mask(C[i]) != kSentinelMask;
          } else if (pos == K) {
            ovf = key_mask(C[i]) != kSentinelMask;
          }
          ++pos;
        }
        for (int i = distinct + tid; i < K; i += kThreads) F[i] = kSentinel;
        overflow |= __syncthreads_or(ovf);
        int total;
        block_scan(c2, scratch, &total);
        const bool grew = total > count;
        count = total;
        if (!grew) break;
      }
      peak = max(peak, count);
      // --- kill: keep entries holding bit s, clearing it; order and
      // distinctness survive, so a stable compaction is enough -------------
      const int per = (K + kThreads - 1) / kThreads;
      const int lo = min(K, tid * per), hi = min(K, lo + per);
      int keep = 0;
      for (int i = lo; i < hi; ++i) {
        const uint32_t m = key_mask(F[i]);
        keep += m != kSentinelMask && ((m >> s) & 1u);
      }
      int kept;
      int pos = block_scan(keep, scratch, &kept);
      for (int i = lo; i < hi; ++i) {
        const u64 key = F[i];
        const uint32_t m = key_mask(key);
        if (m != kSentinelMask && ((m >> s) & 1u))
          C[pos++] = key - ((u64)1 << (32 + s));
      }
      __syncthreads();
      for (int i = tid; i < K; i += kThreads)
        F[i] = i < kept ? C[i] : kSentinel;
      pm &= ~(1 << s);
      if (kept == 0) {
        died = e0 + k;
        alive = false;
        break;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < K; i += kThreads) {
    mask_out[i] = key_mask(F[i]);
    state_out[i] = key_state(F[i]);
  }
  if (tid == 0) {
    out[0] = alive ? 1 : 0;
    out[1] = died;
    out[2] = overflow ? 1 : 0;
    out[3] = peak;
  }
}

}  // namespace

extern "C" int jt_frontier_sparse(void* kind, void* slot, void* f, void* a,
                                  void* b, void* mask0, void* state0,
                                  void* mask_out, void* state_out, void* out,
                                  int E, int S, int K, void* stream) {
  if (S < 1 || S > kMaxSlots || K < 1 || K * (S + 1) > (1 << 14))
    return (int)cudaErrorInvalidValue;
  int cap = 1;
  while (cap < K * (S + 1)) cap <<= 1;
  const size_t smem = ((size_t)K + cap) * sizeof(u64) +
                      (5 * kEvChunk + 3 * kMaxSlots + kWarps + 2) *
                          sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      frontier_sparse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  frontier_sparse_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)kind, (const int*)slot, (const int*)f, (const int*)a,
      (const int*)b, (const uint32_t*)mask0, (const int*)state0,
      (uint32_t*)mask_out, (int*)state_out, (int*)out, E, S, K, cap);
  return (int)cudaGetLastError();
}
