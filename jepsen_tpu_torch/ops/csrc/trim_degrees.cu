// One round of the edge-sharded 2-core trim for Hopper (sm_90a): a
// shard's partial in/out degrees, and the activity mask's update.
//
// Replaces the body of the XLA program jepsen_tpu/ops/scc.py
// `run_sharded_trim` (:146-186): the `segment_sum` pair of each shard
// (:164-167) and the mask update after the `psum` (:176-177). The caller
// (ops/scc.py `trim_rounds`) keeps the reference's synchronous rounds and
// cap: per round, every shard's partials, the other devices' rows copied
// to the mesh's first device (or the sum all-reduced across processes),
// then the update, until nothing changed or max_iters rounds ran. So the
// residue is the reference's bit for bit. A mesh whose shards all lie on
// one card, with no reduction across processes, never comes here: the
// rounds then compute exactly scc_trim.cu's peel over the union of the
// shards' edges (the same mask and step count at every cap, shown by
// tests/test_torch_trim_degrees.py), so ops/scc.py runs that in one call.
//
// Contracts (n nodes, W = ceil(n / 32) mask words):
// jt_trim_partial_degrees(src, dst, w, bits, E, n, deg, stream):
//   deg is int32 [2, n], row 0 the in-degrees and row 1 the out-degrees.
//   For each edge e with w[e] != 0 whose two ends are active, adds w[e] to
//   deg[0][dst[e]] and to deg[1][src[e]]. It accumulates: nothing is
//   zeroed, so the shards on one device add into one row pair. bits is
//   int32 [W], the active mask packed (bit v & 31 of word v >> 5), as
//   jt_trim_update leaves it.
// jt_trim_update(deg, others, k, active, bits, n, flags, slot, stream):
//   with others int32 [k, 2, n] (the other devices' rows, already on this
//   device; NULL when k = 0) and active uint8 [n]: a node v stays active
//   when deg[.][v] plus the k others' rows are > 0 in both rows. Clears
//   active[v] of the nodes that leave, rewrites bits, zeroes deg for the
//   next round (the rows of inactive nodes are 0 on entry, as the degree
//   pass leaves them; others are not zeroed: the next round's copies
//   overwrite them), sets flags[slot] = 1 when some node left
//   (flags[slot] must be 0 on entry) and clears flags[slot ^ 1] for the
//   next round. slot is 0 or 1.
// Both enqueue one launch and no memset, never synchronise, and return
// the first CUDA error.
//
// What bounds it: bytes. A round reads each edge's 12 bytes once and the
// mask, and adds into the degree rows; the atomics land in L2 at the sizes
// the Elle graphs have (a 2^20-node mask and its degree rows are 9 MB).
// The first design zeroed both rows and the flag with three memsets a
// round and took a fresh row pair a shard; here the rows live across
// rounds and the update, which reads them anyway, zeroes them. Both
// kernels run kBlocksPerSm CTAs an SM over a grid-stride loop
// (combine_sweep.py --degrees times other counts). The update stores the
// flag once a CTA: stores to the one flag word queue in L2 (at 2^19 nodes
// and a thread a node, 14 us with a store a warp, 6.3 with a store a
// CTA). The degree pass reads the mask as the packed bits that the update
// writes with one ballot a warp (64 KB at 2^19 nodes, held in L1).
// Measured before this design settled (PERF.md §6): on a 2^18-edge shard
// of the 2^19-node graph the degree pass took 6.1 us so, 7.4 reading the
// mask's bytes, 15 with the bits staged in shared memory and 11 with
// warp-aggregated atomics (__match_any_sync, then __reduce_add_sync;
// slower on the Elle edges too); the update 4.5 us.
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool is_active(const uint32_t* __restrict__ bits,
                                          int v) {
  return (__ldg(bits + (v >> 5)) >> (v & 31)) & 1u;
}

__global__ void __launch_bounds__(kThreads)
    partial_degrees(const int* __restrict__ src, const int* __restrict__ dst,
                    const int* __restrict__ w,
                    const uint32_t* __restrict__ bits, int n_edges,
                    int* __restrict__ deg_in, int* __restrict__ deg_out) {
  const int stride = gridDim.x * blockDim.x;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n_edges;
       e += stride) {
    const int we = w[e];
    if (we == 0) continue;
    const int s = src[e];
    const int d = dst[e];
    if (is_active(bits, s) && is_active(bits, d)) {
      atomicAdd(deg_in + d, we);
      atomicAdd(deg_out + s, we);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    update_mask(int* __restrict__ deg, const int* __restrict__ others,
                int n_others, uint8_t* __restrict__ active,
                uint32_t* __restrict__ bits, int n, int* __restrict__ flags,
                int slot) {
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && threadIdx.x == 0) flags[slot ^ 1] = 0;
  const int stride = gridDim.x * blockDim.x;
  bool left = false;
  // a warp-uniform trip count, a word of the mask a warp
  for (int base = blockIdx.x * blockDim.x + (threadIdx.x - lane); base < n;
       base += stride) {
    const int v = base + lane;
    bool keep = false;
    if (v < n && active[v]) {
      int din = deg[v];
      int dout = deg[(size_t)n + v];
      if (din != 0) deg[v] = 0;
      if (dout != 0) deg[(size_t)n + v] = 0;
      for (int j = 0; j < n_others; ++j) {
        const int* o = others + (size_t)j * 2 * n;
        din += o[v];
        dout += o[(size_t)n + v];
      }
      keep = din > 0 && dout > 0;
      if (!keep) {
        active[v] = 0;
        left = true;
      }
    }
    const unsigned word = __ballot_sync(kFull, keep);
    if (lane == 0) bits[base >> 5] = word;
  }
  if (__syncthreads_or(left) && threadIdx.x == 0) flags[slot] = 1;
}

// The SM count, once per device and process.
cudaError_t sm_count(int* sms) {
  static std::mutex mu;
  static int counts[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (counts[dev] == 0) {
    err = cudaDeviceGetAttribute(&counts[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = counts[dev];
  return cudaSuccess;
}

int grid_for(int items, int sms) {
  const int b = (items + kThreads - 1) / kThreads;
  return b < sms * kBlocksPerSm ? b : sms * kBlocksPerSm;
}

}  // namespace

extern "C" int jt_trim_partial_degrees(void* src, void* dst, void* w,
                                       void* bits, int n_edges, int n_nodes,
                                       void* deg, void* stream) {
  if (n_edges < 0 || n_nodes < 1 || n_nodes >= (1 << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_edges == 0) return (int)cudaSuccess;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  int* din = (int*)deg;
  partial_degrees<<<grid_for(n_edges, sms), kThreads, 0,
                    (cudaStream_t)stream>>>(
      (const int*)src, (const int*)dst, (const int*)w, (const uint32_t*)bits,
      n_edges, din, din + n_nodes);
  return (int)cudaGetLastError();
}

extern "C" int jt_trim_update(void* deg, void* others, int n_others,
                              void* active, void* bits, int n_nodes,
                              void* flags, int slot, void* stream) {
  if (n_nodes < 1 || n_nodes >= (1 << 30) || n_others < 0 ||
      (n_others > 0 && others == nullptr) || (slot != 0 && slot != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  update_mask<<<grid_for(n_nodes, sms), kThreads, 0, (cudaStream_t)stream>>>(
      (int*)deg, (const int*)others, n_others, (uint8_t*)active,
      (uint32_t*)bits, n_nodes, (int*)flags, slot);
  return (int)cudaGetLastError();
}
