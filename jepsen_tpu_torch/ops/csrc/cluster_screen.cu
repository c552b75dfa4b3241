// Per-cluster cycle screen of the Elle check for Hopper (sm_90a).
//
// Replaces the XLA program jepsen_tpu/ops/scc.py `_screen_kernel`
// (:195-238), the device half of the Elle check's phi-interval path: the
// host cuts the dependency graph into small clusters that hold every
// cycle, and this screen settles, for all of them at once, whether each
// holds a cycle; only flagged clusters get the exact typed search.
//
// What it computes: out[b] = 1 iff the edges of cluster b (src -> dst in
// local ids [0, V), valid ones only) close a directed cycle. The
// reference scatters a bf16 [B, V, V] adjacency and squares it
// ceil(log2 V) times on the MXU, then reads the closure's diagonal; the
// answer is exact either way, so this matches it bit for bit.
//
// What bounds it. The bytes are the edges (12 bytes each: two ids and the
// valid byte, plus the sort the wrapper does) and one flag a cluster, and
// the operations about one per edge and one per node: a few microseconds
// for the 50 clusters of 3,400 edges a screen call sees on a wide-window
// history. What sets the time is the chain of rounds below, a CTA barrier
// each, at most about one per node on the longest path of an acyclic
// cluster, and a dense [V, V] bf16 layout (2 bytes a bit) would move 16
// times the bytes of the bits for nothing.
//
// Design. One CTA per cluster; the wrapper sorts the edges by cluster and
// hands each CTA its range. The adjacency is bit-packed in shared memory
// (V rows of W = ceil(V / 32) words, 128 KB at V = 1024, so dynamic shared
// memory after cudaFuncSetAttribute), built with atomicOr from the edge
// range, which drops duplicate edges as the reference's scatter-max does.
// In-degrees count the set bits. Then a Kahn peel: in each round every
// thread removes its nodes whose in-degree is 0 and decrements the
// in-degree of each node their row points at (shared atomics). A node
// reaching 0 during a round may be removed in that round or the next,
// and removal order does not change what remains: the nodes that are left
// when a round removes nothing are exactly those a cycle reaches, so the
// cluster has a cycle iff any node is left (a self-loop keeps its node's
// in-degree above 0). The round's progress flag rotates
// over three words, so one barrier a round suffices: flag r % 3 is set in
// round r and read after its barrier, and flag (r + 1) % 3 is cleared in
// round r, a barrier after every thread read it in round r - 2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxV = 1024;
constexpr int kRemoved = -1;

__global__ void cluster_screen_kernel(const int* __restrict__ src,
                                      const int* __restrict__ dst,
                                      const uint8_t* __restrict__ valid,
                                      const int* __restrict__ offs,
                                      uint8_t* __restrict__ out, int V) {
  extern __shared__ uint32_t smem[];
  const int W = (V + 31) / 32;
  uint32_t* adj = smem;                                 // [V][W]
  int* indeg = reinterpret_cast<int*>(adj + V * W);     // [V]
  int* flag = indeg + V;                                // [3]
  volatile int* vindeg = indeg;
  volatile int* vflag = flag;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int b = blockIdx.x;

  for (int i = tid; i < V * W; i += nth) adj[i] = 0u;
  for (int v = tid; v < V; v += nth) indeg[v] = 0;
  if (tid < 3) flag[tid] = 0;
  __syncthreads();
  const int e1 = offs[b + 1];
  for (int e = offs[b] + tid; e < e1; e += nth) {
    if (!valid[e]) continue;
    const int s = src[e], d = dst[e];
    if ((unsigned)s >= (unsigned)V || (unsigned)d >= (unsigned)V) continue;
    atomicOr(&adj[s * W + (d >> 5)], 1u << (d & 31));
  }
  __syncthreads();
  for (int i = tid; i < V * W; i += nth) {
    uint32_t bits = adj[i];
    const int base = (i % W) * 32;
    while (bits) {
      atomicAdd(&indeg[base + __ffs(bits) - 1], 1);
      bits &= bits - 1;
    }
  }
  __syncthreads();

  for (int round = 0;; ++round) {
    if (tid == 0) vflag[(round + 1) % 3] = 0;
    bool mine = false;
    for (int v = tid; v < V; v += nth) {
      if (vindeg[v] != 0) continue;  // kRemoved, or edges still enter v
      vindeg[v] = kRemoved;
      mine = true;
      for (int w = 0; w < W; ++w) {
        uint32_t bits = adj[v * W + w];
        while (bits) {
          atomicSub(&indeg[w * 32 + __ffs(bits) - 1], 1);
          bits &= bits - 1;
        }
      }
    }
    if (mine) vflag[round % 3] = 1;
    __syncthreads();
    if (!vflag[round % 3]) break;
  }

  bool left = false;
  for (int v = tid; v < V; v += nth) left |= vindeg[v] != kRemoved;
  left = __syncthreads_or(left);
  if (tid == 0) out[b] = left ? 1 : 0;
}

}  // namespace

// offs: int[B + 1], cluster b's edges are [offs[b], offs[b + 1]) of the
// edge columns; out: uint8[B].
extern "C" int jt_cluster_screen(void* src, void* dst, void* valid,
                                 void* offs, void* out, int B, int V,
                                 void* stream) {
  if (B < 1 || V < 1 || V > kMaxV) return (int)cudaErrorInvalidValue;
  const int W = (V + 31) / 32;
  const size_t smem = ((size_t)V * W + V + 3) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      cluster_screen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = V >= 512 ? 1024 : 256;
  cluster_screen_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const int*)src, (const int*)dst, (const uint8_t*)valid,
      (const int*)offs, (uint8_t*)out, V);
  return (int)cudaGetLastError();
}
