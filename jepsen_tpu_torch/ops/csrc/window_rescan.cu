// Per-return rescan of one chunk on a frontier vector, for Hopper
// (sm_90a).
//
// Replaces `vec_batch` of jepsen_tpu/ops/jitlin.py:1640-1665 (inside
// `_build_forensics_kernel`, :1584), an XLA program: `_vec_scan` vmapped
// over K candidates, each applying the chunk's T return operators of
// `_kernel_math.make_step` to a [MV] frontier vector (a k = 1 matrix
// riding the [MV, MV] product). `matrix_localize` runs it on the guilty
// chunk to find the return at which the frontier dies, and the witness
// shrink (checker/explain.py ddmin) on a round's candidates, each a copy
// of the chunk with some ops masked out.
//
// What it computes, for candidate k: from v, for each return t in order,
// - when valid[k, t] is false the frontier is unchanged (make_step's
//   torch.where(val, A, eye): no closure either);
// - else the closure under the pending slots pend[k, t]: for every live
//   (mask m, state v) and pending slot s not in m, (m | 1 << s, w) for
//   every w with v -> w under slot s's op ids[t, s];
// - then the kill of the returning slot r = slots[t]: new[m] = 0 when r
//   is in m, else clos[m | 1 << r];
// first[k] = the first t after which no configuration is alive (-1 if
// none), inexact[k] = OR over all T returns of oob[ids[t, s]] for the
// pending slots of the valid returns (the reference keeps scanning after
// the death, and so does this kernel for this flag). An op id outside
// [0, U), or a valid return's slot outside [0, S), makes first[k] = -2
// (kRescanBad) for the candidates it reaches, and the wrapper's reader
// raises on it; the kernel indexes with neither.
//
// Inputs, on the card and contiguous: pend [K, T, S] and valid [K, T]
// bytes 0/1 (the raw grids), ids [T, S] int32, slots [T] int32, nxt
// [U, V] words (bit w of nxt[u, v]: v -> w under op u), oob [U] bytes,
// vw [ceil(MV / 32)] the packed start frontier (bit i: configuration i =
// mask * V + state); first [K] int32, inexact [K] bytes out. M = 2^S <=
// 256, V <= 32.
//
// What bounds it: the work is data-dependent and tiny next to a launch
// (per candidate and live valid return, M masks times the pending slots
// times the states of a set), and the bytes are the K [T, S] masks: the
// time is the latency of the staging loads and of the T dependent steps.
// What the design does about it:
// - staging: a tile of up to kTile returns at a time, the loads of the
//   CTA's candidates' masks, the tile's op ids and slots in flight
//   together, then the op words those ids select and their oob bits,
//   all into shared memory (two dependent round trips a tile, shared by
//   every candidate of the CTA); the tile's returns then run from shared
//   memory;
// - the warp path (S <= kWarpMaxSlots, M <= 32): one warp a candidate,
//   lane m holding mask m's state set in a register; the closure's pulls
//   are shuffles and no barrier separates its levels (a level is the
//   pending slots a mask holds: popcount(pm) levels a return); at V = 8
//   and 16 an image is branch-free, its op words broadcast loads that
//   need not wait for the set; a CTA takes kMinWarps to kMaxWarps
//   candidates, as few as fill every SM (the warps past K only stage);
// - the shared-memory path (S = 6-8): one CTA a candidate and a thread a
//   mask, the sets in shared memory, a barrier a level.
// A dead frontier skips the closure and the kill and only ORs the
// inexact flag.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W, ops/forensics_compare against
// the first design, one CTA a candidate, in one run): on the corrupted
// headline's first dead chunk (T = 32, S = 5, V = 8) the C entry takes
// 0.0194 ms at K = 1 (0.0380) and 0.0231 at K = 128 (0.0541), 0.03 % of
// its 0.0000053 ms bound: a launch, two staging round trips and the 13
// returns up to the death, each a dependent chain of shuffles and
// images, set it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "forensics.cuh"

namespace {

constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kTile = 32;
constexpr int kMaxSlots = 8;
constexpr int kMaxV = 32;
constexpr int kMaxMasks = 1 << kMaxSlots;
constexpr int kWarpMaxSlots = 5;
constexpr int kMaxWarps = 8;
constexpr int kRescanBad = -2;
// the loads a thread has in flight while staging
constexpr int kBatch = 16;
// warps a CTA on the warp path at least: the idle ones help to stage
constexpr int kMinWarps = 4;

struct RescanArgs {
  const uint8_t* pend;
  const uint8_t* valid;
  const int32_t* ids;
  const int32_t* slots;
  const uint32_t* nxt;
  const uint8_t* oob;
  const uint32_t* vw;
  int32_t* first;
  uint8_t* inexact;
  int K, T, S, V, U;
};

struct Staged {
  uint32_t opw[kTile * kMaxSlots * kMaxV];  // [t][s][v]
  int32_t sid[kTile * kMaxSlots];           // [t][s]
  uint32_t oobm[kTile];                     // bit s: oob[ids[t, s]]
  uint32_t pm[kMaxWarps][kTile];            // a candidate's pending bits
  int32_t rs[kMaxWarps][kTile];             // its returning slot or -1
  int bad[kMaxWarps];                       // a slot out of range
  int bad_id;                               // an op id out of range
};

// Stages returns t0 ... t0 + n - 1 for the CTA's ncand candidates from
// k0 on (all threads; ends with a barrier). A thread loads kBatch items
// before it stores any, so that its loads are in flight together.
__device__ __forceinline__ void stage_tile(const RescanArgs& a, Staged& st,
                                           int t0, int n, int k0,
                                           int ncand) {
  const int S = a.S, V = a.V;
  const int nb = blockDim.x;
  for (int q0 = threadIdx.x; q0 < n * S; q0 += kBatch * nb) {
    int u[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      u[b] = q0 + b * nb < n * S ? a.ids[(size_t)t0 * S + q0 + b * nb] : 0;
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (q0 + b * nb >= n * S) break;
      const bool ok = u[b] >= 0 && u[b] < a.U;
      if (!ok) st.bad_id = 1;
      st.sid[q0 + b * nb] = ok ? u[b] : 0;
    }
  }
  for (int q = threadIdx.x; q < ncand * n; q += blockDim.x) {
    const int cl = q / n, t = q - cl * n;
    const int k = k0 + cl;
    uint32_t p = 0;
    int r = -1;
    if (k < a.K) {
      const size_t kt = (size_t)k * a.T + t0 + t;
      if (!fx_return_masks(a.pend + kt * S, S, a.valid[kt] != 0,
                           a.slots[t0 + t], &p, &r)) {
        st.bad[cl] = 1;
        p = 0;
        r = -1;
      }
    }
    st.pm[cl][t] = p;
    st.rs[cl][t] = r;
  }
  __syncthreads();
  const int nw = n * S * V;
  for (int q0 = threadIdx.x; q0 < nw; q0 += kBatch * nb) {
    uint32_t x[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int q = q0 + b * nb;
      const int ts = q / V;
      x[b] = q < nw ? a.nxt[(size_t)st.sid[ts] * V + (q - ts * V)] : 0u;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (q0 + b * nb < nw) st.opw[q0 + b * nb] = x[b];
  }
  for (int t = threadIdx.x; t < n; t += nb) {
    uint8_t o[kMaxSlots];
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s)
      o[s] = s < S ? a.oob[st.sid[t * S + s]] : 0;
    uint32_t m = 0;
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s)
      if (o[s]) m |= 1u << s;
    st.oobm[t] = m;
  }
  __syncthreads();
}

// kV: V when compiled for it (8 or 16, the matrix regime's), else 0
template <bool kWarp, int kV>
__global__ void __launch_bounds__(kMaxMasks)
window_rescan_kernel(const RescanArgs a) {
  __shared__ Staged st;
  __shared__ uint32_t set[kMaxMasks];  // the shared-memory path's sets
  const int S = a.S, V = a.V, M = 1 << S;
  const int lane = threadIdx.x & 31;
  const int ncand = kWarp ? (int)(blockDim.x >> 5) : 1;
  const int cl = kWarp ? (int)(threadIdx.x >> 5) : 0;
  const int k0 = blockIdx.x * ncand;
  const int k = k0 + cl;
  const int m = kWarp ? lane : (int)threadIdx.x;
  if (threadIdx.x == 0) st.bad_id = 0;
  if (threadIdx.x < kMaxWarps) st.bad[threadIdx.x] = 0;
  // mask m's states; an empty start is dead before the first return
  uint32_t mine = m < M ? fx_start_set(a.vw, m, V) : 0u;
  int dead_at;
  if (kWarp) {
    dead_at = __any_sync(kFull, mine != 0u) ? -1 : 0;
  } else {
    if (m < M) set[m] = mine;
    dead_at = __syncthreads_or(mine != 0u) ? -1 : 0;
  }
  bool inex = false;
  for (int t0 = 0; t0 < a.T; t0 += kTile) {
    const int n = a.T - t0 < kTile ? a.T - t0 : kTile;
    __syncthreads();  // the last tile's words are consumed
    stage_tile(a, st, t0, n, k0, ncand);
    for (int t = 0; t < n; ++t) {
      const uint32_t p = st.pm[cl][t];
      const int r = st.rs[cl][t];
      inex |= (p & st.oobm[t]) != 0u;
      if (r < 0 || dead_at >= 0) continue;  // the same for the candidate
      const uint32_t* op_t = st.opw + t * S * V;
      const int levels = fx_popc(p);
      if (kWarp) {
        for (int l = 1; l <= levels; ++l) {
          // every pending slot's shuffle first, then the images
          uint32_t src[kWarpMaxSlots];
#pragma unroll
          for (int s = 0; s < kWarpMaxSlots; ++s)
            src[s] = __shfl_sync(kFull, mine, lane ^ (1 << s));
          uint32_t acc = mine;
#pragma unroll
          for (int s = 0; s < kWarpMaxSlots; ++s)
            if (s < S && ((p >> s) & 1u))
              acc |= kV ? fx_lane_pull_k<kV>(m, p, l, s, src[s], op_t + s * kV)
                        : fx_lane_pull(m, p, l, s, src[s], op_t + s * V, V);
          mine = acc;
        }
        mine = fx_lane_kill(m, r, __shfl_sync(kFull, mine, lane | (1 << r)));
        if (!__any_sync(kFull, mine != 0u)) dead_at = t0 + t;
      } else {
        for (int l = 1; l <= levels; ++l) {
          if (m < M && fx_popc((uint32_t)m & p) == l)
            set[m] = fx_close(set, m, p, op_t, V);
          __syncthreads();
        }
        const uint32_t nv = m < M ? fx_kill(set, m, r) : 0u;
        __syncthreads();
        if (m < M) set[m] = nv;
        if (!__syncthreads_or(nv != 0u)) dead_at = t0 + t;
      }
    }
  }
  __syncthreads();  // the flags of the last tile
  if ((kWarp ? lane : (int)threadIdx.x) == 0 && k < a.K) {
    a.first[k] = (st.bad_id || st.bad[cl]) ? kRescanBad : dead_at;
    a.inexact[k] = inex ? 1 : 0;
  }
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n < 1) n = 1;
  }
  return n;
}

}  // namespace

// The arrays above; K >= 1, T >= 1, 1 <= S <= 8, 1 <= V <= 32, U >= 1.
// Enqueues one launch on `stream` and returns cudaGetLastError(): for
// S <= 5 warps of one candidate each, as many a CTA (up to 8) as leave
// no SM idle; for S = 6-8 one CTA of 2^S threads a candidate.
extern "C" int jt_window_rescan(void* pend, void* valid, void* ids,
                                void* slots, void* nxt, void* oob, void* vw,
                                void* first, void* inexact, int K, int T,
                                int S, int V, int U, void* stream) {
  const RescanArgs args{(const uint8_t*)pend, (const uint8_t*)valid,
                        (const int32_t*)ids, (const int32_t*)slots,
                        (const uint32_t*)nxt, (const uint8_t*)oob,
                        (const uint32_t*)vw, (int32_t*)first,
                        (uint8_t*)inexact, K, T, S, V, U};
  const cudaStream_t st = (cudaStream_t)stream;
  if (S <= kWarpMaxSlots) {
    int per = (K + sm_count() - 1) / sm_count();
    per = per < kMinWarps ? kMinWarps : (per > kMaxWarps ? kMaxWarps : per);
    const dim3 grid((K + per - 1) / per), block(32 * per);
    if (V == 8)
      window_rescan_kernel<true, 8><<<grid, block, 0, st>>>(args);
    else if (V == 16)
      window_rescan_kernel<true, 16><<<grid, block, 0, st>>>(args);
    else
      window_rescan_kernel<true, 0><<<grid, block, 0, st>>>(args);
  } else {
    window_rescan_kernel<false, 0><<<K, 1 << S, 0, st>>>(args);
  }
  return (int)cudaGetLastError();
}
