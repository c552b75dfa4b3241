// 2-core peel (trim) of a dependency graph for Hopper (sm_90a).
//
// Replaces the XLA program jepsen_tpu/ops/scc.py `_trim_kernel` (:31-68),
// the device half of the Elle check's global path (trim, then exact host
// Tarjan on the residue).
//
// What it computes, for one graph of n nodes and E edges src[e] -> dst[e]
// (valid[e] masks padding): from all nodes active, while the last step
// changed something and fewer than max_iters steps ran, one step keeps a
// node when some active edge enters it and some active edge leaves it; an
// edge is active when it is valid and both its ends are active. Results:
// the active mask after the last step and the number of steps, bit for bit
// those of the reference's while_loop. Every cycle lies in the mask; a
// mask capped by max_iters may also hold acyclic chains, and the caller's
// exact pass only keeps the mask's edges, so the cap must match exactly.
//
// What bounds it. A step reads every edge (9 bytes: two ids and the valid
// byte) and touches every node: one pass over E + n items, so a step
// takes a few microseconds at 3.35 TB/s for 100k edges, and the 32-bit
// operations about as long at 67 T/s. Steps are serial (each reads the
// mask the one before wrote), and a graph of long chains needs up to
// max_iters of them. So the floor is steps x (one pass over E + n), and
// on small graphs the grid barriers between passes, not the bytes, set
// the time.
//
// Design. One cooperative launch runs every step, so the host reads back
// nothing between steps: the grid (all blocks resident, as the
// cooperative launch guarantees) meets at a grid barrier after the edge
// pass and after the node pass. The reference's in- and out-degree
// segment sums are only tested for > 0, so the edge pass does not count:
// an active edge stamps its ends with the step number (stamp_in[dst],
// stamp_out[src]; racing stores write the same value, and no stamp array
// is cleared between steps). The node pass keeps node v iff both stamps
// equal this step. Whether anything changed goes to one of three flags,
// used in rotation: flag t % 3 is written in step t's node pass and read
// after the following barrier; flag (t + 1) % 3 is cleared in step t's
// edge pass, two barriers after every thread read it in step t - 2. Loads
// of the mask, the stamps and the flags bypass L1 (__ldcg), which does
// not see other SMs' stores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
// blocks per SM at most: fewer blocks make each grid barrier cheaper
constexpr int kBlocksPerSm = 2;

// The grid barrier: bar[0] counts the blocks that arrived, bar[1] is the
// generation, bumped by the last block to arrive. Valid only when every
// block is resident, as a cooperative launch guarantees.
__device__ __forceinline__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* vbar = bar;
    const unsigned int gen = vbar[1];
    __threadfence();
    if (atomicAdd(&bar[0], 1u) == gridDim.x - 1) {
      atomicExch(&bar[0], 0u);
      __threadfence();
      atomicAdd(&bar[1], 1u);
    } else {
      while (vbar[1] == gen) {
        __nanosleep(32);
      }
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    scc_trim_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                    const uint8_t* __restrict__ valid, uint8_t* active,
                    int* stamp_in, int* stamp_out, int* flags,
                    unsigned int* bar, int E, int n, int max_iters) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nth = gridDim.x * blockDim.x;
  for (int v = tid; v < n; v += nth) active[v] = 1;
  grid_barrier(bar);
  int steps = 0;
  bool changed = true;
  while (changed && steps < max_iters) {
    const int stamp = steps + 1;
    if (tid == 0) flags[(steps + 1) % 3] = 0;
    for (int e = tid; e < E; e += nth) {
      if (!valid[e]) continue;
      const int s = src[e], d = dst[e];
      if ((unsigned)s >= (unsigned)n || (unsigned)d >= (unsigned)n) continue;
      if (__ldcg(active + s) && __ldcg(active + d)) {
        stamp_in[d] = stamp;
        stamp_out[s] = stamp;
      }
    }
    grid_barrier(bar);
    bool mine = false;
    for (int v = tid; v < n; v += nth) {
      if (__ldcg(active + v) && (__ldcg(stamp_in + v) != stamp ||
                                 __ldcg(stamp_out + v) != stamp)) {
        active[v] = 0;
        mine = true;
      }
    }
    if (mine) flags[steps % 3] = 1;
    grid_barrier(bar);
    changed = __ldcg(flags + steps % 3) != 0;
    ++steps;
  }
  if (tid == 0) flags[3] = steps;
}

}  // namespace

// flags: int[8] zeroed by the caller: [0, 3) the changed flags, [3] the
// steps (out), [4, 6) the grid barrier. stamps: int[2n] zeroed by the
// caller. active: uint8[n] (out).
extern "C" int jt_scc_trim(void* src, void* dst, void* valid, void* active,
                           void* stamps, void* flags, int E, int n,
                           int max_iters, void* stream) {
  if (n < 1 || E < 0 || max_iters < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                      scc_trim_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int work = E > n ? E : n;
  int grid = (work + kThreads - 1) / kThreads;
  const int resident = sms * (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm);
  if (grid > resident) grid = resident;
  if (grid < 1) grid = 1;
  const int* s = (const int*)src;
  const int* d = (const int*)dst;
  const uint8_t* ok = (const uint8_t*)valid;
  uint8_t* act = (uint8_t*)active;
  int* st_in = (int*)stamps;
  int* st_out = st_in + n;
  int* fl = (int*)flags;
  unsigned int* bar = (unsigned int*)(fl + 4);
  void* args[] = {&s, &d, &ok, &act, &st_in, &st_out, &fl, &bar, &E, &n,
                  &max_iters};
  err = cudaLaunchCooperativeKernel((const void*)scc_trim_kernel, dim3(grid),
                                    dim3(kThreads), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
