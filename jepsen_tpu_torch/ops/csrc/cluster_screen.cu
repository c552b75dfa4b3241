// Per-cluster cycle screen of the Elle check for Hopper (sm_90a).
//
// Replaces the XLA program jepsen_tpu/ops/scc.py `_screen_kernel`
// (:195-238), the device half of the Elle check's phi-interval path: the
// host cuts the dependency graph into small clusters that hold every
// cycle, and this screen settles, for all of them at once, whether each
// holds a cycle; only flagged clusters get the exact typed search.
//
// What it computes: out[b] = 1 iff the edges of cluster b (cid[e] == b,
// src -> dst in local ids [0, V), valid ones only) close a directed cycle.
// The reference scatters a bf16 [B, V, V] adjacency and squares it
// ceil(log2 V) times on the MXU, then reads the closure's diagonal; the
// answer is exact either way, so this matches it bit for bit.
//
// What bounds it. The bytes are the edges (13 bytes each: three ids and
// the valid byte) and one flag a cluster, and the operations about one per
// edge and one per node: a few microseconds for the 50 clusters of 3,400
// edges a screen call sees on a wide-window history. Two things cost more
// than these bytes: host work around a call (a sort, gathers and offsets
// built by separate torch calls take about 0.3 ms against 0.02 ms of
// device time), and a Kahn peel by rounds, which scans all V nodes
// between CTA barriers, one round per node on the longest path (V rounds
// on a chain). So the edges are sorted on the device inside one C call,
// and the peel works from a worklist.
//
// Design. One C call a screen call, which enqueues three launches on the
// edges as given (in any order) and touches no host state after the
// first call (the shared-memory attribute is set once per device):
//  1. screen_count_scan (one CTA): counts each cluster's edges in shared
//     memory (B <= kBins), the lanes of a warp that share a cluster with
//     one atomic (per-edge atomics on a global counter would queue 3,400
//     on each of 32 words on a wide-window call), and turns the counts
//     into each cluster's offset.
//  2. screen_scatter (grid): a counting sort of the edges by cluster into
//     one int32 each, src | dst << 16 (-1 for an id out of range): each
//     CTA counts its edges, reserves each cluster's range with one
//     atomic, and places its edges with shared atomics.
//  3. screen_peel: one CTA per cluster. The adjacency is bit-packed in
//     shared memory (V rows of W = ceil(V / 32) words, 128 KB at
//     V = 1024), built with atomicOr from the cluster's edge range; the
//     edge whose bit was not yet set adds 1 to its dst's in-degree, so
//     duplicates count once, as in the reference's scatter-max. Then a
//     Kahn peel on a worklist: a queue in shared memory holds the nodes
//     whose in-degree is 0 (each node enters it at most once, so V slots
//     suffice), but a node with no edge at all (the padding up to V) is
//     counted as removed and never queued. kPeelWarps warps take nodes
//     from the queue; for each node the whole warp reads its row, one
//     word a lane, and decrements the targets' in-degrees with shared
//     atomics. When the node frees exactly one target, the warp goes on
//     with it at once (a chain costs a row read, an atomic and a ballot a
//     node, with no queue traffic); when it frees more, it pushes them (a
//     ballot, a warp scan of the counts, one atomicAdd on the tail). The
//     order of removals does not change what is left (a node is removed
//     iff no cycle reaches it), so the peel has no CTA barrier per round.
//     The cluster has a cycle iff fewer than V nodes were removed (a
//     self-loop keeps its node's in-degree above 0).
//
// Termination, race-free. A warp claims queue index i (atomicAdd on head)
// and waits until slot i holds a node (slots start at -1; a pusher
// reserves slots on the tail, then writes them). A warp that finishes a
// queued node, and the chain of nodes it went on with, writes its pushes,
// __syncwarp()s, fences, and only then adds 1 to done. So tail - done
// counts the queued nodes not yet finished, and a waiter that reads done
// and then tail (a fence between) and sees them equal saw a moment with
// no node pending: no push can follow, the tail is final, and if
// i >= tail slot i stays empty and the warp leaves. If i < tail the slot
// was reserved and its write is on its way: the warp waits on. Every index
// below the final tail is claimed by one warp and finished, so every warp
// leaves.
//
// The kernel reports its work: work[0] the nodes removed over all
// clusters, work[1] the distinct edges their rows held; a numpy replay of
// the peel gives the same counts.
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kMaxV = 1024;
// warps that run the peel (the others only build the adjacency)
constexpr int kPeelWarps = 4;
// a waiting warp's pause between looks at its queue slot
constexpr int kSpinNs = 64;
// clusters a CTA of the sort counts in shared memory
constexpr int kBins = 4096;
// edges a CTA of the sort takes at least
constexpr int kEdgesPerCta = 2048;
constexpr int kEdgeThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
// edges a lane of the count loads before it counts them
constexpr int kCountItems = 8;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

size_t screen_smem(int V) {
  const int W = (V + 31) / 32;
  return ((size_t)V * W + 2 * (size_t)V + W) * sizeof(int);
}

__device__ __forceinline__ bool edge_valid(const uint8_t* valid, int e) {
  return valid == nullptr || valid[e];
}

// The cluster of edge e, or -1 when e is invalid or its cluster is out of
// range.
__device__ __forceinline__ int edge_cluster(const int* cid,
                                            const uint8_t* valid, int e,
                                            int B) {
  if (!edge_valid(valid, e)) return -1;
  const int c = cid[e];
  return (unsigned)c < (unsigned)B ? c : -1;
}

// One CTA: counts the edges of each cluster (in shared memory when
// B <= kBins, else in offs; the lanes of a warp with one cluster add
// together, kCountItems loads in flight a lane), then offs[0, B] become
// the counts' exclusive prefix sums, copied to cursor[0, B), and the work
// is cleared.
__global__ void __launch_bounds__(kScanThreads)
    screen_count_scan(const int* __restrict__ cid,
                      const uint8_t* __restrict__ valid, int* work,
                      int* offs, int* cursor, int E, int B) {
  __shared__ int hist[kBins];
  __shared__ int warp_sum[kScanThreads / 32];
  __shared__ int carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* counts = B <= kBins ? hist : offs;
  for (int c = tid; c < B; c += kScanThreads) counts[c] = 0;
  if (tid < 2) work[tid] = 0;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int e0 = warp * 32 * kCountItems; e0 < E;
       e0 += kScanThreads * kCountItems) {
    int c[kCountItems];
#pragma unroll
    for (int k = 0; k < kCountItems; ++k) {
      const int e = e0 + k * 32 + lane;
      c[k] = e < E ? edge_cluster(cid, valid, e, B) : -1;
    }
#pragma unroll
    for (int k = 0; k < kCountItems; ++k) {
      const unsigned peers = __match_any_sync(kFull, c[k]);
      if (c[k] >= 0 && lane == __ffs(peers) - 1) {
        atomicAdd(counts + c[k], __popc(peers));
      }
    }
  }
  __syncthreads();
  const int items = B + 1;
  for (int base = 0; base < items; base += kScanThreads * kScanItems) {
    const int i0 = base + tid * kScanItems;
    int x[kScanItems];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      x[k] = i0 + k < B ? counts[i0 + k] : 0;
      sum += x[k];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = warp_sum[lane];
      int wi = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, wi, o);
        if (lane >= o) wi += y;
      }
      warp_sum[lane] = wi - w;
    }
    __syncthreads();
    int run = carry + warp_sum[warp] + incl - sum;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int i = i0 + k;
      if (i < items) {
        offs[i] = run;
        if (i < B) cursor[i] = run;
      }
      run += x[k];
    }
    __syncthreads();  // every thread has read carry, warp_sum and counts
    if (tid == kScanThreads - 1) carry = run;
    __syncthreads();
  }
}

__device__ __forceinline__ int pack_edge(const int* src, const int* dst,
                                         int e, int V) {
  const int s = src[e], d = dst[e];
  const bool in = (unsigned)s < (unsigned)V && (unsigned)d < (unsigned)V;
  return in ? (s | (d << 16)) : -1;
}

__global__ void screen_scatter(const int* __restrict__ cid,
                               const int* __restrict__ src,
                               const int* __restrict__ dst,
                               const uint8_t* __restrict__ valid,
                               int* cursor, int* packed, int E, int B,
                               int V) {
  __shared__ int base[kBins];
  const int e0 = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  if (B > kBins) {
    for (int e = e0; e < E; e += stride) {
      const int c = edge_cluster(cid, valid, e, B);
      if (c >= 0) packed[atomicAdd(cursor + c, 1)] = pack_edge(src, dst, e, V);
    }
    return;
  }
  for (int c = threadIdx.x; c < B; c += blockDim.x) base[c] = 0;
  __syncthreads();
  for (int e = e0; e < E; e += stride) {
    const int c = edge_cluster(cid, valid, e, B);
    if (c >= 0) atomicAdd(base + c, 1);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < B; c += blockDim.x) {
    if (base[c]) base[c] = atomicAdd(cursor + c, base[c]);
  }
  __syncthreads();
  for (int e = e0; e < E; e += stride) {
    const int c = edge_cluster(cid, valid, e, B);
    if (c >= 0) packed[atomicAdd(base + c, 1)] = pack_edge(src, dst, e, V);
  }
}

__global__ void __launch_bounds__(1024)
    screen_peel(const int* __restrict__ packed, const int* __restrict__ offs,
                uint8_t* __restrict__ out, int* work, int V) {
  extern __shared__ uint32_t smem[];
  // head: the next queue index to claim; tail: the slots reserved; done:
  // the queued nodes finished; extra: the nodes removed without a slot
  __shared__ int head, tail, done, extra;
  const int W = (V + 31) / 32;
  uint32_t* adj = smem;                                // [V][W]
  int* indeg = reinterpret_cast<int*>(adj + V * W);    // [V]
  int* queue = indeg + V;                              // [V]
  uint32_t* has_out = reinterpret_cast<uint32_t*>(queue + V);  // [W]
  volatile int* vqueue = queue;
  volatile int* vtail = &tail;
  volatile int* vdone = &done;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;

  for (int i = tid; i < V * W; i += nth) adj[i] = 0u;
  for (int v = tid; v < V; v += nth) {
    indeg[v] = 0;
    queue[v] = -1;
  }
  for (int w = tid; w < W; w += nth) has_out[w] = 0u;
  if (tid == 0) {
    head = 0;
    tail = 0;
    done = 0;
    extra = 0;
  }
  __syncthreads();
  const int e1 = offs[b + 1];
  for (int e = offs[b] + tid; e < e1; e += nth) {
    const int p = packed[e];
    if (p < 0) continue;
    const int s = p & 0xffff, d = p >> 16;
    const uint32_t bit = 1u << (d & 31);
    if (!(atomicOr(&adj[s * W + (d >> 5)], bit) & bit)) {
      atomicAdd(&indeg[d], 1);
      atomicOr(&has_out[s >> 5], 1u << (s & 31));
    }
  }
  __syncthreads();
  // the first nodes: those no edge enters; those no edge touches at all
  // are removed here
  for (int v0 = warp * 32; v0 < V; v0 += nth) {
    const int v = v0 + lane;
    const bool zero_in = v < V && indeg[v] == 0;
    const bool lone = zero_in && !((has_out[v >> 5] >> (v & 31)) & 1u);
    const unsigned m = __ballot_sync(kFull, zero_in && !lone);
    const unsigned l = __ballot_sync(kFull, lone);
    int base = 0;
    if (lane == 0) {
      if (m) base = atomicAdd(&tail, __popc(m));
      if (l) atomicAdd(&extra, __popc(l));
    }
    base = __shfl_sync(kFull, base, 0);
    if (zero_in && !lone) queue[base + __popc(m & ((1u << lane) - 1u))] = v;
  }
  __syncthreads();

  int walked = 0, chained = 0;
  if (warp < kPeelWarps) {
    for (;;) {
      int v = -1;
      if (lane == 0) {
        const int i = atomicAdd(&head, 1);
        while (i < V) {
          v = vqueue[i];
          if (v >= 0) break;
          const int d = *vdone;
          __threadfence_block();
          const int t = *vtail;
          if (d == t && i >= t) break;  // no node pending: slot i stays empty
          __nanosleep(kSpinNs);
        }
      }
      v = __shfl_sync(kFull, v, 0);
      if (v < 0) break;
      for (;;) {  // v, then the one node it frees, and so on
        const uint32_t row = lane < W ? adj[v * W + lane] : 0u;
        walked += __popc(row);
        uint32_t bits = row, zero = 0u;
        while (bits) {
          const int j = __ffs(bits) - 1;
          bits &= bits - 1u;
          if (atomicSub(&indeg[lane * 32 + j], 1) == 1) zero |= 1u << j;
        }
        const int c = __popc(zero);
        const int total = __reduce_add_sync(kFull, c);
        if (total == 1) {
          const int from = __ffs(__ballot_sync(kFull, c > 0)) - 1;
          v = __shfl_sync(kFull, lane * 32 + __ffs(zero) - 1, from);
          ++chained;
          continue;
        }
        if (total > 1) {
          int incl = c;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += y;
          }
          int at = 0;
          if (lane == 31) at = atomicAdd(&tail, incl);
          at = __shfl_sync(kFull, at, 31) + incl - c;
          while (zero) {
            const int j = __ffs(zero) - 1;
            zero &= zero - 1u;
            vqueue[at++] = lane * 32 + j;
          }
        }
        break;
      }
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        atomicAdd(&done, 1);
      }
    }
    if (lane == 0 && chained) atomicAdd(&extra, chained);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    walked += __shfl_down_sync(kFull, walked, o);
  }
  if (lane == 0 && walked) atomicAdd(work + 1, walked);
  __syncthreads();
  if (tid == 0) {
    const int removed = tail + extra;
    out[b] = removed < V ? 1 : 0;
    atomicAdd(work, removed);
  }
}

struct Device {
  int sms = 0;
  cudaError_t err = cudaSuccess;
};

// Once per device and process: the SM count, and the peel's dynamic
// shared memory raised to what V = kMaxV needs.
Device device_setup() {
  static std::mutex mu;
  static Device devices[kMaxDevices];
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return Device{0, err};
  if (dev >= kMaxDevices) return Device{0, cudaErrorInvalidDevice};
  std::lock_guard<std::mutex> lock(mu);
  if (ready[dev]) return devices[dev];
  Device d;
  d.err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                 dev);
  if (d.err == cudaSuccess) {
    d.err = cudaFuncSetAttribute(screen_peel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)screen_smem(kMaxV));
  }
  devices[dev] = d;
  ready[dev] = true;
  return d;
}

}  // namespace

// The edges in any order; valid may be null (all valid). scratch:
// int32[2B + E + 3], not cleared by the caller: [0, 2) the work (out:
// nodes removed, row bits walked), then the offsets [B + 1], the cursors
// [B] and the sorted edges [E]. out: uint8[B].
extern "C" int jt_cluster_screen(void* cid, void* src, void* dst,
                                 void* valid, void* out, void* scratch,
                                 int E, int B, int V, void* stream) {
  if (B < 1 || V < 1 || V > kMaxV || E < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Device dev = device_setup();
  if (dev.err != cudaSuccess) return (int)dev.err;
  cudaStream_t st = (cudaStream_t)stream;
  const int* c = (const int*)cid;
  const int* s = (const int*)src;
  const int* d = (const int*)dst;
  const uint8_t* ok = (const uint8_t*)valid;
  int* work = (int*)scratch;
  int* offs = work + 2;
  int* cursor = offs + B + 1;
  int* packed = cursor + B;
  int grid = (E + kEdgesPerCta - 1) / kEdgesPerCta;
  if (grid > 8 * dev.sms) grid = 8 * dev.sms;
  screen_count_scan<<<1, kScanThreads, 0, st>>>(c, ok, work, offs, cursor,
                                                E, B);
  if (E > 0) {
    screen_scatter<<<grid, kEdgeThreads, 0, st>>>(c, s, d, ok, cursor,
                                                  packed, E, B, V);
  }
  const int threads = V >= 512 ? 1024 : 256;
  screen_peel<<<B, threads, screen_smem(V), st>>>(packed, offs,
                                                  (uint8_t*)out, work, V);
  return (int)cudaGetLastError();
}
