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
// list, bit for bit those of the reference's `run.resume`; and the closure
// passes run on the warp path and in all (the path taken, which the
// caller holds against the plain version's count).
//
// What bounds it. The data is small (events in, 2 KB of list in and out at
// K = 256) and the work serial: each pass depends on the one before and
// each return on the last. So latency bounds it, far from the byte or
// operation bound; what sets the time is the length of the dependent chain
// a pass and a return take, and in a CTA every barrier adds to that chain.
//
// Design. One CTA per history, the event loop inside it, so a check is one
// launch, and a batch of keys is one launch too: one CTA a key (grid = B),
// each reading its key's events [off[b], off[b + 1]) of one upload and
// writing its own row of results, with `died` the index in the key's own
// stream (the reference vmaps the scan over keys, jitlin.py:2023). A batch
// builds each key's initial list, (0, init_state) then sentinels, in the
// kernel and writes no final list; the single-history entry is the same
// kernel at B = 1 with the list given and written back (the resume form).
// A key whose list empties ends its CTA alone: warp 0 then hands the CTA
// the end command at the named barrier every thread of the CTA waits on,
// so all of them leave together. A pair is one 64-bit key, mask << 32 | (state ^ 2^31), which
// orders as the reference's two-key sort and makes the sentinel pair the
// largest key. After the first closure pass the list in shared memory is
// sorted and distinct, valid keys first, and `len` entries long (sentinels
// after); every loop runs over the live list, not over K. Warp 0 runs the
// event loop alone; the other warps wait on a named barrier and join only
// for a CTA-path pass.
// - Warp path (the common case): the list holds at most kWarpList = 64 keys
//   (two a lane) and the pass at most kWarpCand = 64 candidates. Each lane
//   counts its keys' expansions, a warp prefix count places them, and the
//   warp's sum is the exact candidate count. The pass then runs in one warp
//   with no CTA barrier and no block scan: a rank sort (a key's place is
//   the number of smaller keys plus the equal ones before it, every lane
//   reading every candidate by broadcast loads that do not wait on each
//   other; a shuffle bitonic sort's chain of dependent steps took longer),
//   duplicates found against the neighbour (__shfl_up_sync), the first K
//   distinct kept by ballot and popcount, overflow from the (K+1)-th
//   distinct key, and growth from the popcount of the valid ones.
// - CTA path (a longer list or more candidates, and the first pass after a
//   given list, which may be unsorted or hold duplicates; the reference
//   counts that raw list before the pass): all threads gather the list's
//   keys and the expansions a sorted list does not already hold (a held
//   one adds no distinct key, and near a closure's end most are held),
//   placed by one block prefix count, sort them (rounded up to a power
//   of two, at least 64; a
//   bitonic sort whose steps within 64 keys run in registers, one warp a
//   block, so only the steps across blocks take a barrier each) and keep
//   the first K distinct by a second block prefix count.
// - The kill is warp 0's alone at any length: clearing one bit in the masks
//   that hold it keeps their order and distinctness, so it is a stable
//   compaction in place, 32 keys a ballot.
// The transition is the launch's model (frontier_model.cuh): the CAS
// register's or the multi-register map's, whose (keys, values) and digit
// powers come with the launch; the kernel is instantiated for each
// (kModel), and `expand` (a CTA pass's candidate) and `expand2` (a warp
// pass's two keys a lane, stepped together) alone step it. For the CAS
// register the expansions of a sorted, distinct list by one slot are
// themselves sorted once adjacent duplicates go (adding bit t keeps the
// order of masks that lack it; within a mask a read keeps the states'
// order, a write sends all to `a`, a CAS passes one state), so the CTA
// path's sort could become a merge of 1 + npend runs. A multi-register
// write loses that property: it sends s to s - d SB^k + w SB^k, which at
// K = 2, SB = 6 takes states 5 and 6 to 17 and 12 under "write key 1 :=
// 2". Neither path relies on it: the warp path ranks every candidate
// against every other, and the CTA path sorts them all, so the pass is the
// same for any model. After the frontier empties nothing changes any more,
// so the loop stops.
#include <cuda_runtime.h>
#include <stdint.h>

#include "frontier_model.cuh"
#include "smem_limit.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 32;
constexpr int kEvChunk = 512;  // events staged in shared memory at a time
constexpr int kWarpList = 64;  // the warp path's largest list (2 a lane)
constexpr int kWarpCand = 64;  // and its largest pass (2 candidates a lane)
constexpr int kInvoke = 0, kReturn = 1;
constexpr u64 kSentinel = ~0ull;  // (0xFFFFFFFF, 0x7FFFFFFF)
constexpr uint32_t kSentinelMask = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xffffffffu;
// warp 0's command to the CTA at the hand-off barrier
constexpr int kCmdPass = 1, kCmdEnd = 2;

__device__ __forceinline__ u64 pack(uint32_t mask, int state) {
  return ((u64)mask << 32) | (u64)((uint32_t)state ^ 0x80000000u);
}
__device__ __forceinline__ uint32_t key_mask(u64 k) {
  return (uint32_t)(k >> 32);
}
__device__ __forceinline__ int key_state(u64 k) {
  return (int)((uint32_t)k ^ 0x80000000u);
}

// The expansion of key by slot t under the op (f, a, b) of the model md,
// or kSentinel when there is none: an invalid or sentinel key, t already
// in its mask, an op that does not apply, or an expansion that equals the
// sentinel.
template <int kModel>
__device__ __forceinline__ u64 expand(const Model& md, u64 key, int t, int f,
                                      int a, int b) {
  const uint32_t m = key_mask(key), bit = 1u << t;
  if (m == kSentinelMask || (m & bit)) return kSentinel;
  bool ok;
  const int st = model_step<kModel>(md, key_state(key), f, a, b, &ok);
  return ok ? pack(m | bit, st) : kSentinel;
}

// The expansions of two keys by slot t, their steps taken together (one
// decode of the op, two chains interleaved).
template <int kModel>
__device__ __forceinline__ void expand2(const Model& md, u64 k0, u64 k1,
                                        int t, int f, int a, int b, u64* c0,
                                        u64* c1) {
  const int st[2] = {key_state(k0), key_state(k1)};
  int nx[2];
  bool ok[2];
  model_steps<kModel, 2>(md, st, f, a, b, nx, ok);
  const uint32_t bit = 1u << t, m0 = key_mask(k0), m1 = key_mask(k1);
  *c0 = m0 != kSentinelMask && !(m0 & bit) && ok[0] ? pack(m0 | bit, nx[0])
                                                     : kSentinel;
  *c1 = m1 != kSentinelMask && !(m1 & bit) && ok[1] ? pack(m1 | bit, nx[1])
                                                     : kSentinel;
}

// Whether key is among the sorted keys F[0, len).
__device__ __forceinline__ bool in_sorted(const u64* F, int len, u64 key) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (F[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo < len && F[lo] == key;
}

__device__ __forceinline__ void named_barrier() {
  asm volatile("bar.sync 1, %0;" ::"r"(kThreads) : "memory");
}

// the lanes below `lane` (0 <= lane <= 32) as a mask
__device__ __forceinline__ unsigned lanes_below(int lane) {
  return lane >= 32 ? ~0u : (1u << lane) - 1u;
}

// Steps of the bitonic stages k = k_lo .. k_hi (powers of two <= 64) on 64
// keys in registers: the lane holds elements i0 = base + lane (x0) and
// i0 + 32 (x1), base a multiple of 64; each stage k runs its steps
// j = min(k / 2, 32) .. 1, ascending where (i & k) == 0.
__device__ __forceinline__ void bitonic_regs(u64& x0, u64& x1, int i0,
                                             int k_lo, int k_hi, int lane) {
#pragma unroll
  for (int k = 2; k <= 64; k <<= 1) {
    if (k < k_lo) continue;
    if (k > k_hi) break;
    const bool asc0 = (i0 & k) == 0, asc1 = ((i0 + 32) & k) == 0;
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 32) {  // k == 64: element i0 against i0 + 32, one direction
        const u64 lo = min(x0, x1), hi = max(x0, x1);
        x0 = asc0 ? lo : hi;
        x1 = asc0 ? hi : lo;
        continue;
      }
      const bool lower = (lane & j) == 0;
      const u64 y0 = __shfl_xor_sync(kFull, x0, j);
      const u64 y1 = __shfl_xor_sync(kFull, x1, j);
      x0 = (lower == asc0) ? min(x0, y0) : max(x0, y0);
      x1 = (lower == asc1) ? min(x1, y1) : max(x1, y1);
    }
  }
}

// Ascending bitonic sort of c[0, n) by the whole CTA, n a power of two and
// at least 64: each warp sorts 64-key blocks in registers, and of each
// later stage k the steps j >= 64 go through shared memory, a barrier
// each, the steps j < 64 through registers again, one barrier for them.
__device__ void block_sort(u64* c, int n, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  auto in_regs = [&](int k_lo, int k_hi) {
    for (int base = warp * 64; base < n; base += kWarps * 64) {
      u64 x0 = c[base + lane], x1 = c[base + 32 + lane];
      bitonic_regs(x0, x1, base + lane, k_lo, k_hi, lane);
      c[base + lane] = x0;
      c[base + 32 + lane] = x1;
    }
    __syncthreads();
  };
  in_regs(2, 64);
  for (int k = 128; k <= n; k <<= 1) {
    for (int j = k >> 1; j >= 64; j >>= 1) {
      for (int i = tid; i < (n >> 1); i += kThreads) {
        const int lo = ((i / j) * 2 * j) + (i % j);
        const int hi = lo + j;
        const u64 x = c[lo], y = c[hi];
        if ((x > y) == ((lo & k) == 0)) {
          c[lo] = y;
          c[hi] = x;
        }
      }
      __syncthreads();
    }
    // the steps j = 32 .. 1 of stage k are stage 64's steps, in the
    // direction (i & k) gives the whole block: passed as bit 6 of i0
    for (int base = warp * 64; base < n; base += kWarps * 64) {
      u64 x0 = c[base + lane], x1 = c[base + 32 + lane];
      bitonic_regs(x0, x1, ((base & k) ? 64 : 0) + lane, 64, 64, lane);
      c[base + lane] = x0;
      c[base + 32 + lane] = x1;
    }
    __syncthreads();
  }
}

// Block-wide exclusive prefix sum of one int a thread; also returns the
// total. Ends with a barrier; `scratch` holds kWarps + 1 ints.
__device__ __forceinline__ int block_scan(int x, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
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

// What warp 0 hands the CTA for one pass, and what the pass hands back.
struct PassArgs {
  int cmd;
  int n_in;   // entries of F to expand (K for a given, raw list)
  int given;  // the list as given: unsorted, maybe with duplicates
  int npend;
  int pslot[kMaxSlots];  // the pending slots, ascending
  int len;    // in: n_in; out: distinct keys kept
  int count;  // in: the valid keys before the pass; out: valid keys kept
  int ovf;    // out: a (K+1)-th distinct valid key existed
};

// One closure pass by the whole CTA: the n_in entries of F and their
// expansions into C (placed by a block prefix count), sorted, and the
// first K distinct back into F.
template <int kModel>
__device__ void cta_pass(u64* F, u64* C, const int* cur, PassArgs* A,
                         int* scratch, int K, const Model& md) {
  const int tid = threadIdx.x;
  const int n_in = A->n_in, np1 = A->npend + 1;
  const int items = n_in * np1;
  // item i is entry i / np1, itself (i % np1 == 0) or its expansion by
  // the (i % np1 - 1)-th pending slot; a thread takes a contiguous run
  const int per = (items + kThreads - 1) / kThreads;
  const int lo = min(items, tid * per), hi = min(items, lo + per);
  auto cand = [&](int i) -> u64 {
    const int ki = i / np1, ti = i - ki * np1;
    const u64 key = F[ki];
    if (ti == 0 || key == kSentinel) return key;
    const int t = A->pslot[ti - 1];
    return expand<kModel>(md, key, t, cur[t], cur[kMaxSlots + t],
                  cur[2 * kMaxSlots + t]);
  };
  // An expansion that a sorted list already holds adds nothing to the
  // pass's distinct keys (the list's own keys are candidates), so it is
  // not sorted: bit i - lo of keep marks the candidates that are (per <=
  // 64: items <= K (S + 1) <= 2^14). A sorted list's pass that keeps no
  // expansion changes nothing (A->len and A->count stay as warp 0 set
  // them).
  unsigned long long keep = 0;
  int mine = 0;
  bool fresh = false;
  for (int i = lo; i < hi; ++i) {
    const u64 c = cand(i);
    const bool expansion = i % np1 != 0;
    if (c == kSentinel ||
        (expansion && !A->given && in_sorted(F, n_in, c)))
      continue;
    keep |= 1ull << (i - lo);
    ++mine;
    fresh = fresh || expansion;
  }
  fresh = fresh || A->given;
  int n;
  int pos = block_scan(mine, scratch, &n);
  for (int i = lo; i < hi; ++i)
    if ((keep >> (i - lo)) & 1ull) C[pos++] = cand(i);
  int n2 = kWarpCand;
  while (n2 < n) n2 <<= 1;
  for (int i = n + tid; i < n2; i += kThreads) C[i] = kSentinel;
  if (!__syncthreads_or(fresh)) return;
  block_sort(C, n2, tid);
  // the first K distinct keys; one scan counts the distinct keys (low 16
  // bits) and the distinct valid ones (high 16 bits): n2 <= 2^14
  const int per2 = (n2 + kThreads - 1) / kThreads;
  const int lo2 = min(n2, tid * per2), hi2 = min(n2, lo2 + per2);
  int d = 0;
  for (int i = lo2; i < hi2; ++i) {
    if (C[i] == kSentinel || (i > 0 && C[i] == C[i - 1])) continue;
    d += 1 + ((key_mask(C[i]) != kSentinelMask) << 16);
  }
  int both;
  int at = block_scan(d, scratch, &both) & 0xFFFF;
  for (int i = lo2; i < hi2; ++i) {
    if (C[i] == kSentinel || (i > 0 && C[i] == C[i - 1])) continue;
    if (at < K) F[at] = C[i];
    else if (at == K && key_mask(C[i]) != kSentinelMask) A->ovf = 1;
    ++at;
  }
  const int distinct = both & 0xFFFF, kept = min(distinct, K);
  // a given list may shrink; a sorted one never does (its keys are
  // candidates)
  for (int i = kept + tid; i < n_in; i += kThreads) F[i] = kSentinel;
  if (tid == 0) {
    A->len = kept;
    A->count = min(both >> 16, K);
  }
  __syncthreads();
}

// One closure pass by warp 0, when the list (len <= 64) has at most
// kWarpCand candidates. Returns false, with nothing changed, when it has
// more. C[0, 64) stages the candidates, C[64, 128) their sorted order.
template <int kModel>
__device__ __forceinline__ bool warp_pass(u64* F, u64* C, const int* cur,
                                          uint32_t pm, int len, int K,
                                          const Model& md, int lane,
                                          int* len_out, int* count_out,
                                          bool* ovf_out) {
  const unsigned lt = lanes_below(lane);
  const bool two_keys = len > 32;
  const u64 k0 = lane < len ? F[lane] : kSentinel;
  const u64 k1 = two_keys && lane + 32 < len ? F[lane + 32] : kSentinel;
  // the list's keys are candidates 0 .. len - 1; the expansions follow,
  // slot by slot, placed by ballot (expanding several slots at once
  // measured slower: a pass has about 3 pending slots)
  int n = len;
  for (uint32_t rem = pm; rem; rem &= rem - 1) {
    const int t = __ffs(rem) - 1;
    const int f = cur[t], a = cur[kMaxSlots + t], b = cur[2 * kMaxSlots + t];
    u64 c0, c1;
    expand2<kModel>(md, k0, k1, t, f, a, b, &c0, &c1);
    const unsigned b0 = __ballot_sync(kFull, c0 != kSentinel);
    const int p0 = n + __popc(b0 & lt);
    if (c0 != kSentinel && p0 < kWarpCand) C[p0] = c0;
    n += __popc(b0);
    if (two_keys) {
      const unsigned b1 = __ballot_sync(kFull, c1 != kSentinel);
      const int p1 = n + __popc(b1 & lt);
      if (c1 != kSentinel && p1 < kWarpCand) C[p1] = c1;
      n += __popc(b1);
    }
  }
  if (n > kWarpCand) return false;
  if (lane < len) C[lane] = k0;
  if (lane + 32 < len) C[lane + 32] = k1;
  // the sorted order, sentinels where no key lands
  C[kWarpCand + lane] = kSentinel;
  C[kWarpCand + 32 + lane] = kSentinel;
  __syncwarp();
  // with one candidate a lane, __match_any_sync finds the equal ones: an
  // expansion is in the list when a lane below len holds it, and of equal
  // keys the lowest lane is the first
  const bool two = n > 32;
  const u64 y0 = lane < n ? C[lane] : kSentinel;
  const u64 y1 = lane + 32 < n ? C[lane + 32] : kSentinel;
  const unsigned same = two ? 0u : __match_any_sync(kFull, y0);
  // a pass whose expansions all lie in the list changes nothing: the list
  // is its result, with the same count and no overflow
  bool fresh = false;
  if (two) {
    for (int i = len + lane; i < n; i += 32)
      fresh |= !in_sorted(F, len, C[i]);
  } else {
    fresh = lane >= len && lane < n && !(same & lanes_below(len));
  }
  if (!__any_sync(kFull, fresh)) {
    *len_out = len;
    *count_out =
        __popc(__ballot_sync(kFull, key_mask(k0) != kSentinelMask &&
                                        lane < len)) +
        __popc(__ballot_sync(kFull, key_mask(k1) != kSentinelMask &&
                                        lane + 32 < len));
    *ovf_out = false;
    return true;
  }
  // rank sort: a key lands at the number of smaller keys; of equal keys
  // only the first writes, and the slots left empty hold sentinels. Every
  // lane reads every candidate (broadcast loads that do not wait on each
  // other).
  int r0 = 0, r1 = 0;
  bool dup0 = false, dup1 = false;
  if (two) {
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const u64 c = C[i];
      r0 += c < y0;
      r1 += c < y1;
      dup0 |= c == y0 && i < lane;
      dup1 |= c == y1 && i < lane + 32;
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < n; ++i) r0 += C[i] < y0;
    dup0 = lane != __ffs(same) - 1;
  }
  if (lane < n && !dup0) C[kWarpCand + r0] = y0;
  if (lane + 32 < n && !dup1) C[kWarpCand + r1] = y1;
  __syncwarp();
  const u64 x0 = C[kWarpCand + lane], x1 = C[kWarpCand + 32 + lane];
  // the distinct keys are the slots that hold one, in order
  const bool d0 = x0 != kSentinel, d1 = two && x1 != kSentinel;
  const unsigned b0 = __ballot_sync(kFull, d0), b1 = __ballot_sync(kFull, d1);
  const bool v0 = d0 && key_mask(x0) != kSentinelMask,
             v1 = d1 && key_mask(x1) != kSentinelMask;
  const int dv = __popc(__ballot_sync(kFull, v0)) +
                 (two ? __popc(__ballot_sync(kFull, v1)) : 0);
  const int q0 = __popc(b0 & lt), q1 = __popc(b0) + __popc(b1 & lt);
  const int distinct = __popc(b0) + __popc(b1);
  // a sorted list's keys are all candidates, so the kept list is at least
  // len long and overwrites every old entry
  if (d0 && q0 < K) F[q0] = x0;
  if (d1 && q1 < K) F[q1] = x1;
  *ovf_out = __any_sync(kFull, (v0 && q0 == K) || (v1 && q1 == K));
  *len_out = min(distinct, K);
  *count_out = min(dv, K);
  __syncwarp();
  return true;
}

// The kill by warp 0: keep the entries of F[0, len) holding bit s, with
// the bit cleared, compacted in place 32 at a time; returns their number.
__device__ __forceinline__ int warp_kill(u64* F, int len, int s, int lane) {
  const unsigned lt = lanes_below(lane);
  int kept = 0;
  for (int i0 = 0; i0 < len; i0 += 32) {
    const int i = i0 + lane;
    const u64 key = i < len ? F[i] : kSentinel;
    const uint32_t m = key_mask(key);
    const bool keep = m != kSentinelMask && ((m >> s) & 1u);
    const unsigned b = __ballot_sync(kFull, keep);
    __syncwarp();  // this chunk is read; writes land below kept + 32 <= i0 + 32
    if (keep) F[kept + __popc(b & lt)] = key - ((u64)1 << (32 + s));
    kept += __popc(b);
  }
  for (int i = kept + lane; i < len; i += 32) F[i] = kSentinel;
  __syncwarp();
  return kept;
}

template <int kModel>
__global__ void __launch_bounds__(kThreads, 1)
frontier_sparse_kernel(const int* __restrict__ kind,
                       const int* __restrict__ slot,
                       const int* __restrict__ fv, const int* __restrict__ av,
                       const int* __restrict__ bv,
                       // [B + 1] key b's events are [off[b], off[b + 1]);
                       // null: one key, events [0, E)
                       const int* __restrict__ off,
                       // [K] each; null: (0, init_state) then sentinels
                       const uint32_t* __restrict__ mask0,
                       const int* __restrict__ state0,
                       uint32_t* __restrict__ mask_out,  // [K] or null
                       int* __restrict__ state_out,      // [K] or null
                       // [B][6] alive, died, overflow, peak, closure
                       // passes on the warp path, closure passes
                       int* __restrict__ out,
                       int E, int S, int K, int cap, int init_state,
                       const Model model) {
  extern __shared__ u64 smem64[];
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
  __shared__ PassArgs A;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  u64* F = smem64;                      // [K] the list
  u64* C = F + K;                       // [cap] candidates
  int* ev = (int*)(C + cap);            // [5][kEvChunk], warp 0's
  int* cur = ev + 5 * kEvChunk;         // [3][kMaxSlots] open ops f, a, b
  int* scratch = cur + 3 * kMaxSlots;   // [kWarps + 1]

  // the list as given (the first closure pass sorts and dedups it)
  for (int i = tid; i < K; i += kThreads)
    F[i] = mask0 != nullptr ? pack(mask0[i], state0[i])
           : i == 0         ? pack(0u, init_state)
                            : kSentinel;
  for (int i = tid; i < 3 * kMaxSlots; i += kThreads) cur[i] = 0;
  __syncthreads();

  // warp 0's scan state (uniform over its lanes)
  enum { kEvents, kClosure, kAfterCta, kKill };
  int phase = kEvents, e = 0, s = 0, pass = 0, len = K, count = 0;
  int died = -1, peak = 1, warp_passes = 0, passes = 0;
  uint32_t pm = 0;
  bool alive = true, overflow = false, sorted = false;
  for (;;) {
    if (warp == 0) {
      // the event loop, until the scan ends or a pass needs the CTA
      for (;;) {
        if (phase == kAfterCta) {
          len = A.len;
          overflow |= A.ovf != 0;
          const bool grew = A.count > count;
          count = A.count;
          phase = (grew && ++pass < S) ? kClosure : kKill;
        }
        if (phase == kEvents) {
          if (!alive || e >= E) {
            if (lane == 0) A.cmd = kCmdEnd;
            break;
          }
          const int k = e % kEvChunk;
          if (k == 0) {
            const int n = min(kEvChunk, E - e);
            __syncwarp();  // every lane is done with the last chunk's events
            for (int i = lane; i < n; i += 32) {
              ev[i] = kind[e + i];
              ev[kEvChunk + i] = slot[e + i];
              ev[2 * kEvChunk + i] = fv[e + i];
              ev[3 * kEvChunk + i] = av[e + i];
              ev[4 * kEvChunk + i] = bv[e + i];
            }
            __syncwarp();
          }
          const int kd = ev[k], sl = ev[kEvChunk + k];
          if (kd == kInvoke) {
            if (lane == 0) {
              cur[sl] = ev[2 * kEvChunk + k];
              cur[kMaxSlots + sl] = ev[3 * kEvChunk + k];
              cur[2 * kMaxSlots + sl] = ev[4 * kEvChunk + k];
            }
            pm |= 1u << sl;
            ++e;
            continue;
          }
          if (kd != kReturn) {
            ++e;
            continue;
          }
          __syncwarp();  // the invokes' ops
          s = sl;
          pass = 0;
          if (sorted) {
            count = len;  // after a kill every entry is valid
          } else {  // the reference counts the given list as it is
            int c = 0;
            for (int i = lane; i < K; i += 32)
              c += key_mask(F[i]) != kSentinelMask;
            count = __reduce_add_sync(kFull, c);
          }
          phase = kClosure;
        }
        if (phase == kClosure) {
          if (sorted && len <= kWarpList) {
            int len2, c2;
            bool ovf;
            if (warp_pass<kModel>(F, C, cur, pm, len, K, model, lane, &len2,
                                  &c2, &ovf)) {
              ++warp_passes;
              ++passes;
              len = len2;
              overflow |= ovf;
              const bool grew = c2 > count;
              count = c2;
              phase = (grew && ++pass < S) ? kClosure : kKill;
              continue;
            }
          }
          // hand the pass to the CTA
          __syncwarp();  // every lane has read the last pass's results
          if (lane < S && ((pm >> lane) & 1u))
            A.pslot[__popc(pm & lanes_below(lane))] = lane;
          if (lane == 0) {
            A.cmd = kCmdPass;
            A.n_in = sorted ? len : K;
            A.given = !sorted;
            A.len = A.n_in;
            A.count = count;
            A.npend = __popc(pm);
            A.ovf = 0;
          }
          sorted = true;
          ++passes;
          phase = kAfterCta;
          break;
        }
        if (phase == kKill) {
          peak = max(peak, count);
          len = warp_kill(F, len, s, lane);
          pm &= ~(1u << s);
          if (len == 0) {
            died = e;
            alive = false;
          }
          ++e;
          phase = kEvents;
        }
      }
    }
    named_barrier();  // warp 0's command and its list
    if (A.cmd == kCmdEnd) break;
    cta_pass<kModel>(F, C, cur, &A, scratch, K, model);
  }
  if (mask_out != nullptr) {
    for (int i = tid; i < K; i += kThreads) {
      mask_out[i] = key_mask(F[i]);
      state_out[i] = key_state(F[i]);
    }
  }
  if (tid == 0) {
    out[0] = alive ? 1 : 0;
    out[1] = died;
    out[2] = overflow ? 1 : 0;
    out[3] = peak;
    out[4] = warp_passes;
    out[5] = passes;
  }
}

// Launches the scan of B keys (off given) or of one history (off null,
// its E events), one CTA a key.
int launch(const void* kind, const void* slot, const void* f, const void* a,
           const void* b, const void* off, const void* mask0,
           const void* state0, void* mask_out, void* state_out, void* out,
           int B, int E, int S, int K, int init_state, int code, int nk,
           int nv, void* stream) {
  Model model;
  if (S < 1 || S > kMaxSlots || K < 1 || K * (S + 1) > (1 << 14) || B < 1 ||
      !make_model(code, nk, nv, &model))
    return (int)cudaErrorInvalidValue;
  int cap = 2 * kWarpCand;  // the warp path's staging and sorted order
  while (cap < K * (S + 1)) cap <<= 1;
  const size_t smem = ((size_t)K + cap) * sizeof(u64) +
                      (5 * kEvChunk + 3 * kMaxSlots + kWarps + 1) *
                          sizeof(int);
  const auto kernel = code == kMultiRegister
                          ? frontier_sparse_kernel<kMultiRegister>
                          : frontier_sparse_kernel<kCas>;
  const cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)kind, (const int*)slot, (const int*)f, (const int*)a,
      (const int*)b, (const int*)off, (const uint32_t*)mask0,
      (const int*)state0, (uint32_t*)mask_out, (int*)state_out, (int*)out, E,
      S, K, cap, init_state, model);
  return (int)cudaGetLastError();
}

}  // namespace

// One history from the list (mask0, state0), the final list into
// (mask_out, state_out), its results into out[0, 6); the transition is the
// model (code, nk, nv) of frontier_model.cuh.
extern "C" int jt_frontier_sparse(void* kind, void* slot, void* f, void* a,
                                  void* b, void* mask0, void* state0,
                                  void* mask_out, void* state_out, void* out,
                                  int E, int S, int K, int code, int nk,
                                  int nv, void* stream) {
  return launch(kind, slot, f, a, b, nullptr, mask0, state0, mask_out,
                state_out, out, 1, E, S, K, 0, code, nk, nv, stream);
}

// B keys, key k's events [off[k], off[k + 1]) of the columns, each from
// (0, init_state) then sentinels; key k's results into out[6k, 6k + 6).
extern "C" int jt_frontier_sparse_batch(void* kind, void* slot, void* f,
                                        void* a, void* b, void* off,
                                        void* out, int B, int S, int K,
                                        int init_state, int code, int nk,
                                        int nv, void* stream) {
  return launch(kind, slot, f, a, b, off, nullptr, nullptr, nullptr, nullptr,
                out, B, 0, S, K, init_state, code, nk, nv, stream);
}
