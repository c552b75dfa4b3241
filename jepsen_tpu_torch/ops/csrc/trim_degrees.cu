// One round of the edge-sharded 2-core trim for Hopper (sm_90a): a
// shard's partial in/out degrees, and the activity mask's update.
//
// Replaces the body of the XLA program jepsen_tpu/ops/scc.py
// `run_sharded_trim` (:146-186): the `segment_sum` pair of each shard
// (:164-167) and the mask update after the `psum` (:176-177). The caller
// (ops/scc.py `run_sharded_trim`) keeps the reference's synchronous rounds
// and cap: per round, every shard's partials, their sum on the mesh's
// first device (or an all_reduce across processes), then the update, until
// nothing changed or max_iters rounds ran. So the residue is the
// reference's bit for bit; it may differ from scc_trim.cu's worklist
// residue only when capped, since that kernel counts its steps otherwise.
//
// jt_trim_partial_degrees: out_in[v] = sum of w[e] over the edges e with
// dst[e] = v whose two ends are active, out_out[v] the same by src[e]. A
// thread an edge (grid-stride), an atomicAdd of w into both rows; a weight
// of 0 (the padding edges) skips the edge before reading the mask.
// jt_trim_update: active[v] &= in[v] > 0 && out[v] > 0, and changed[0] = 1
// when some node left (every remover stores the same 1).
//
// What bounds it: bytes. A round reads each edge's 12 bytes once and the
// mask, and writes the degree rows; the atomics land in L2 at the sizes
// the Elle graphs have (a 2^20-node mask and its degree rows are 9 MB).
// Both entries zero their outputs with cudaMemsetAsync first, enqueue one
// launch each, never synchronise, and return the first CUDA error.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;

__global__ void partial_degrees(const int* __restrict__ src,
                                const int* __restrict__ dst,
                                const int* __restrict__ w,
                                const uint8_t* __restrict__ active,
                                int n_edges, int* __restrict__ deg_in,
                                int* __restrict__ deg_out) {
  const int stride = gridDim.x * blockDim.x;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n_edges;
       e += stride) {
    const int we = w[e];
    if (we == 0) continue;
    const int s = src[e];
    const int d = dst[e];
    if (active[s] && active[d]) {
      atomicAdd(deg_in + d, we);
      atomicAdd(deg_out + s, we);
    }
  }
}

__global__ void update_mask(const int* __restrict__ deg_in,
                            const int* __restrict__ deg_out,
                            uint8_t* __restrict__ active, int n_nodes,
                            int* __restrict__ changed) {
  const int stride = gridDim.x * blockDim.x;
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < n_nodes;
       v += stride) {
    if (active[v] && (deg_in[v] <= 0 || deg_out[v] <= 0)) {
      active[v] = 0;
      *changed = 1;
    }
  }
}

int blocks_for(int n) {
  int b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return b > kMaxBlocks ? kMaxBlocks : b;
}

}  // namespace

extern "C" int jt_trim_partial_degrees(void* src, void* dst, void* w,
                                       void* active, int n_edges,
                                       int n_nodes, void* out_in,
                                       void* out_out, void* stream) {
  if (n_edges < 0 || n_nodes < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int* din = (int*)out_in;
  int* dout = (int*)out_out;
  cudaError_t err = cudaMemsetAsync(din, 0, sizeof(int) * n_nodes, st);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(dout, 0, sizeof(int) * n_nodes, st);
  }
  if (err != cudaSuccess) return (int)err;
  if (n_edges > 0) {
    partial_degrees<<<blocks_for(n_edges), kThreads, 0, st>>>(
        (const int*)src, (const int*)dst, (const int*)w,
        (const uint8_t*)active, n_edges, din, dout);
  }
  return (int)cudaGetLastError();
}

extern "C" int jt_trim_update(void* deg_in, void* deg_out, void* active,
                              int n_nodes, void* changed, void* stream) {
  if (n_nodes < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  update_mask<<<blocks_for(n_nodes), kThreads, 0, st>>>(
      (const int*)deg_in, (const int*)deg_out, (uint8_t*)active, n_nodes,
      (int*)changed);
  return (int)cudaGetLastError();
}
