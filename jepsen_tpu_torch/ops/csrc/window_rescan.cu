// Per-return rescan of one chunk on a frontier vector, for Hopper
// (sm_90a), one candidate a CTA.
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
// - else the closure under the pending slots pm[k, t]: for every live
//   (mask m, state v) and pending slot s not in m, (m | 1 << s, w) for
//   every w with v -> w under slot s's op ids[t, s];
// - then the kill of the returning slot r: new[m] = 0 when r is in m,
//   else clos[m | 1 << r];
// first[k] = the first t after which no configuration is alive (-1 if
// none), inexact[k] = OR over all T returns of oob[ids[t, s]] for the
// pending slots of the valid returns (the reference keeps scanning after
// the death, and so does this kernel for this flag).
//
// Inputs as the wrapper (ops/forensics_kernels.py) derives them: pm
// [K, T] int32 pending bits, 0 for an invalid return; rs [K, T] int32
// the returning slot, -1 for an invalid return; ids [T, S] int32; nxt
// [U, V] words (bit w of nxt[u, v]: v -> w under op u); oob [U] int32;
// v [M] words, mask m's V-bit state set. M = 2^S <= 256, V <= 32.
//
// What bounds it: the work is data-dependent and tiny next to a launch
// (per candidate and live valid return, M masks times the pending slots
// times the states of a set), and the bytes are the K [T] masks. What
// the design does about it: one CTA a candidate and one thread a mask,
// the state sets in shared memory, the closure pulled level by level (a
// mask's predecessors, one bit fewer, are final when it is pulled: S
// barriers a return); the pending ops' transition rows are staged in
// shared memory once a return. A dead frontier skips the closure and
// the kill and only ORs the inexact flag.
#include <cuda_runtime.h>
#include <stdint.h>

#include "forensics.cuh"

namespace {

constexpr int kMaxMasks = 256;  // S <= 8
constexpr int kMaxOpWords = 8 * 32;  // S * V

__global__ void __launch_bounds__(kMaxMasks)
window_rescan_kernel(const int32_t* __restrict__ pm,
                     const int32_t* __restrict__ rs,
                     const int32_t* __restrict__ ids,
                     const uint32_t* __restrict__ nxt,
                     const int32_t* __restrict__ oob,
                     const uint32_t* __restrict__ v,
                     int32_t* __restrict__ first,
                     int32_t* __restrict__ inexact, int T, int S, int V,
                     int M) {
  __shared__ uint32_t set[kMaxMasks];
  __shared__ uint32_t op_nxt[kMaxOpWords];
  const int k = blockIdx.x;
  const int m = threadIdx.x;
  const int32_t* pm_k = pm + (size_t)k * T;
  const int32_t* rs_k = rs + (size_t)k * T;
  if (m < M) set[m] = v[m];
  // an empty start is dead before the first return
  int dead_at = __syncthreads_or(m < M && v[m] != 0u) ? -1 : 0;
  bool inex = false;
  for (int t = 0; t < T; ++t) {
    const uint32_t p = (uint32_t)pm_k[t];
    const int r = rs_k[t];
    if (m < S && ((p >> m) & 1u) && oob[ids[t * S + m]]) inex = true;
    if (r < 0 || dead_at >= 0) continue;  // the same for every thread
    for (int q = threadIdx.x; q < S * V; q += blockDim.x) {
      const int s = q / V;
      op_nxt[q] = ((p >> s) & 1u)
                      ? nxt[(size_t)ids[t * S + s] * V + (q - s * V)]
                      : 0u;
    }
    __syncthreads();
    for (int l = 1; l <= S; ++l) {
      if (m < M && fx_popc((uint32_t)m) == l && ((uint32_t)m & p))
        set[m] = fx_close(set, m, p, op_nxt, V);
      __syncthreads();
    }
    const uint32_t nv = m < M ? fx_kill(set, m, r) : 0u;
    __syncthreads();
    if (m < M) set[m] = nv;
    if (!__syncthreads_or(nv != 0u)) dead_at = t;
  }
  const int any_inex = __syncthreads_or(inex);
  if (threadIdx.x == 0) {
    first[k] = dead_at;
    inexact[k] = any_inex;
  }
}

}  // namespace

// The arrays above, on the card and contiguous; K >= 1, T >= 1,
// 1 <= S <= 8, M = 2^S, 1 <= V <= 32. Enqueues one launch of K CTAs on
// `stream` and returns cudaGetLastError().
extern "C" int jt_window_rescan(void* pm, void* rs, void* ids, void* nxt,
                                void* oob, void* v, void* first,
                                void* inexact, int K, int T, int S, int V,
                                void* stream) {
  const int M = 1 << S;
  const int threads = M < 32 ? 32 : M;
  window_rescan_kernel<<<K, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pm, (const int32_t*)rs, (const int32_t*)ids,
      (const uint32_t*)nxt, (const int32_t*)oob, (const uint32_t*)v,
      (int32_t*)first, (int32_t*)inexact, T, S, V, M);
  return (int)cudaGetLastError();
}
