// 2-core peel (trim) of a dependency graph for Hopper (sm_90a).
//
// Replaces the XLA program jepsen_tpu/ops/scc.py `_trim_kernel` (:31-68),
// the device half of the Elle check's global path (trim, then exact host
// Tarjan on the residue).
//
// What it computes, for one graph of n nodes and E edges src[e] -> dst[e]
// (valid[e] masks padding): from all nodes active, while the last step
// changed something and fewer than max_iters steps ran, one step removes
// every active node whose count of active in-edges or of active out-edges,
// taken at the start of the step, is 0; an edge is active when it is valid
// and both its ends are active (duplicates count with their multiplicity,
// a self-loop keeps its node, and the step that removes nothing counts).
// Results: the active mask after the last step and the number of steps,
// bit for bit those of the reference's while_loop. Every cycle lies in the
// mask; a mask capped by max_iters may also hold acyclic chains, and the
// caller's exact pass only keeps the mask's edges, so the cap must match.
//
// What bounds it. The work is one pass over the edges and nodes: each
// node leaves once and each edge is decremented from each end at most
// once, O(E + n) in all (the reference re-reads every edge in every step,
// steps x (E + n)). What sets the time is the chain of steps: a graph of
// long chains needs up to max_iters of them, each some dependent L2 round
// trips and a barrier. A grid barrier costs more than such a step: a
// trim that met as one cooperative grid at two grid barriers a step took
// 7.9 us a step, and this worklist peel run on the whole grid still pays
// about 2 us a step for its one grid barrier, while more SMs do not
// shorten a step of a few hundred nodes (combine_sweep.py --trim;
// PERF.md §6). So a step runs in one CTA, and only a step of at least
// kGridMinItems nodes, of which a graph has at most n / kGridMinItems,
// takes the whole grid.
//
// Design. Five launches, all enqueued by one C call:
//  1. trim_count (grid): each valid edge adds 1 to its dst's in-degree
//     and its src's out-degree, kept together in one 64-bit word per node
//     (in-degree low, out-degree high), so one atomic on the word sees
//     both and tells when the node first has a zero half.
//  2. trim_place (grid): each CTA scans its nodes' in- plus out-degrees
//     and takes their rows' room from one counter with one atomic (rows
//     need not lie in node order); it marks its nodes active and queues
//     those with a zero half (the first step's removals) the same way.
//  3. trim_fill (grid): a counting sort of the valid edges into one row a
//     node holding both directions, each entry a neighbour w and a bit:
//     v -> w (then w's in-degree drops when v leaves) or w -> v (w's
//     out-degree drops).
//  4. trim_records (grid): each node's 16-byte record: its row's bounds
//     and first two entries.
//  5. trim_peel_cta, or trim_peel_grid past kOneCtaMaxNodes nodes or
//     kOneCtaMaxEdges edge slots (a first step of a few hundred thousand
//     row entries takes one CTA about 0.5 ms):
//     level-synchronous worklist steps. Step t handles the nodes queued
//     during step t - 1: it clears each one's mask byte and applies its
//     row to its neighbours' degree words; the atomic that first leaves a
//     word with a zero half queues that node, once, for step t + 1 (a node
//     reaching 0 during step t is removed in step t + 1, never in step t,
//     so the capped mask and the step count are the reference's). Step
//     t + 1's queue follows step t's in one array of n ids. Each step's
//     push count has its own counter, in rotation over three: counter
//     t % 3 is written in step t and read after its barrier; counter
//     (t + 1) % 3 is cleared in step t, a barrier after every thread read
//     it in step t - 2. So a step costs one barrier. At the cap, nodes
//     still queued stay active. The threads of a warp that push together
//     reserve their slots with one atomic.
//     In one CTA, the next step's first kRing nodes go to shared memory
//     (two buffers, by the step's parity) with their records, which the
//     pushing thread loaded beside the atomic on the node's degrees: a
//     node of at most two entries then costs its step one L2 round trip
//     (the atomics, with the neighbours' records) and the barrier.
//     trim_peel_grid runs the steps of at least kGridMinItems nodes on
//     the whole (cooperative) grid, meeting at a grid barrier; at the
//     first smaller step every CTA but the first leaves, and that one
//     runs the rest as trim_peel_cta does. The 50k-txn global path
//     (65,536 nodes, 131,072 edge slots) takes trim_peel_cta: no grid
//     barrier at all.
// The per-node state (the degree word, the record, the queue slot) lives
// in global memory, in L2 at these sizes (about 21 MB at 2^19 nodes and
// 2^20 edges). One thread removes one node, kBatch atomics in flight; a
// hub's long row is walked by its one thread.
//
// The kernel reports its work: flags[3] the steps, flags[4] the worklist
// items it processed (the removed nodes), flags[5] the row entries it
// walked (the removed nodes' valid in- plus out-degrees); a numpy replay
// of the algorithm gives the same counts.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 1024;
// graphs of up to this many nodes and edge slots peel in one CTA
constexpr int kOneCtaMaxNodes = 1 << 17;
constexpr int kOneCtaMaxEdges = 1 << 17;
// past it, steps of at least this many nodes run on the whole grid
constexpr int kGridMinItems = 1024;
// nodes of the next step kept in shared memory, with their records
constexpr int kRing = 1024;
constexpr int kEdgeThreads = 256;
// row entries a peel thread decrements before it reads their results
constexpr int kBatch = 4;
constexpr int kMaxDevices = 64;

constexpr u64 kIn = 1ull;          // one in-edge: the word's low half
constexpr u64 kOut = 1ull << 32;   // one out-edge: the word's high half

// ctl: int[8] zeroed by the C entry: [0, 3) the steps' push counters,
// [3, 5) the grid barrier, [5] the rows' room taken, [6] the first step's
// queue length.
constexpr int kRowRoom = 5;
constexpr int kFirstQueue = 6;

__device__ __forceinline__ bool zero_half(u64 x) {
  return (uint32_t)x == 0u || (uint32_t)(x >> 32) == 0u;
}

// the degree an entry subtracts: an in-edge for v -> w, an out-edge for
// w -> v
__device__ __forceinline__ u64 entry_one(int x) {
  return (x & 1) ? kOut : kIn;
}

// Reserves one slot of *counter for each converged thread that calls it,
// with one atomic for them all (a queue's tail takes up to 242,158 pushes
// in one step on the graphs measured). Returns the caller's slot.
__device__ __forceinline__ int claim(int* counter) {
  cg::coalesced_group g = cg::coalesced_threads();
  int at = 0;
  if (g.thread_rank() == 0) at = atomicAdd(counter, (int)g.size());
  return g.shfl(at, 0) + (int)g.thread_rank();
}

__device__ __forceinline__ bool edge_ok(const int* src, const int* dst,
                                        const uint8_t* valid, int e, int n,
                                        int* s, int* d) {
  if (!valid[e]) return false;
  *s = src[e];
  *d = dst[e];
  return (unsigned)*s < (unsigned)n && (unsigned)*d < (unsigned)n;
}

__global__ void trim_count(const int* __restrict__ src,
                           const int* __restrict__ dst,
                           const uint8_t* __restrict__ valid, u64* deg,
                           int E, int n) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < E;
       e += gridDim.x * blockDim.x) {
    int s, d;
    if (!edge_ok(src, dst, valid, e, n, &s, &d)) continue;
    atomicAdd(deg + d, kIn);
    atomicAdd(deg + s, kOut);
  }
}

// One node a thread: rec[v].x = rec[v].y = the end of v's row (rows
// placed CTA by CTA from ctl[kRowRoom]), v active, v queued when its word
// has a zero half (at order[ctl[kFirstQueue]++]), flags[5] cleared. Each
// CTA takes its room and its queue slots with one atomic each: a scan of
// (degree << 11 | queued) over the CTA (at most 1024 nodes queued).
__global__ void __launch_bounds__(kThreads)
    trim_place(const u64* __restrict__ deg, int4* rec, int* order,
               uint8_t* active, int* ctl, int* flags, int n) {
  __shared__ u64 warp_sum[kThreads / 32];
  __shared__ int base[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int v = blockIdx.x * kThreads + tid;
  const u64 w = v < n ? deg[v] : 0ull;
  const bool queued = v < n && zero_half(w);
  const u64 key =
      ((u64)((uint32_t)w + (uint32_t)(w >> 32)) << 11) | (queued ? 1u : 0u);
  u64 incl = key;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const u64 y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const u64 s = lane < kThreads / 32 ? warp_sum[lane] : 0ull;
    u64 si = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const u64 y = __shfl_up_sync(0xffffffffu, si, o);
      if (lane >= o) si += y;
    }
    if (lane < kThreads / 32) warp_sum[lane] = si - s;
    if (lane == 31) {
      base[0] = atomicAdd(ctl + kRowRoom, (int)(si >> 11));
      base[1] = atomicAdd(ctl + kFirstQueue, (int)(si & 2047u));
    }
  }
  __syncthreads();
  incl += warp_sum[warp];
  if (v < n) {
    const int end = base[0] + (int)(incl >> 11);
    rec[v] = make_int4(end, end, -1, -1);
    active[v] = 1;
    if (queued) order[base[1] + (int)(incl & 2047u) - 1] = v;
  }
  if (v == 0) flags[5] = 0;
}

// Counting sort of the valid edges into rows: afterwards rec[v].x (v's
// row's end before) is the start of v's row and rec[v].y its end. An
// entry is w << 1 for an edge v -> w, w << 1 | 1 for w -> v.
__global__ void trim_fill(const int* __restrict__ src,
                          const int* __restrict__ dst,
                          const uint8_t* __restrict__ valid, int4* rec,
                          int* adj, int E, int n) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < E;
       e += gridDim.x * blockDim.x) {
    int s, d;
    if (!edge_ok(src, dst, valid, e, n, &s, &d)) continue;
    adj[atomicSub(&rec[s].x, 1) - 1] = d << 1;
    adj[atomicSub(&rec[d].x, 1) - 1] = (s << 1) | 1;
  }
}

// rec[v].z, rec[v].w = the first two entries of v's row (-1 past its end).
__global__ void trim_records(int4* rec, const int* __restrict__ adj, int n) {
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < n;
       v += gridDim.x * blockDim.x) {
    int4 r = rec[v];
    r.z = r.x < r.y ? adj[r.x] : -1;
    r.w = r.x + 1 < r.y ? adj[r.x + 1] : -1;
    rec[v] = r;
  }
}

// Subtracts entries x[0, kBatch) (-1: none) from the neighbours' degree
// words and pushes each neighbour whose word this first leaves with a
// zero half, with its record when kCarry.
template <bool kCarry, typename Push>
__device__ __forceinline__ void apply(const int (&x)[kBatch],
                                      const int4* __restrict__ rec,
                                      u64* deg, Push push) {
  u64 old[kBatch];
  int4 r[kBatch];
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    if (x[k] >= 0) {
      old[k] = atomicAdd(deg + (x[k] >> 1), 0ull - entry_one(x[k]));
      if (kCarry) r[k] = __ldg(rec + (x[k] >> 1));
    }
  }
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    if (x[k] >= 0 && !zero_half(old[k]) &&
        zero_half(old[k] - entry_one(x[k]))) {
      push(x[k] >> 1, kCarry ? r[k] : int4{});
    }
  }
}

// Removes node v of record r: clears its mask byte and applies its row's
// entries (the first two from the record). Returns the entries walked.
template <bool kCarry, typename Push>
__device__ __forceinline__ int remove_node(int v, int4 r,
                                           const int4* __restrict__ rec,
                                           const int* __restrict__ adj,
                                           u64* deg, uint8_t* active,
                                           Push push) {
  active[v] = 0;
  int x[kBatch];
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    x[k] = k == 0 ? r.z : k == 1 ? r.w
                  : r.x + k < r.y ? __ldg(adj + r.x + k) : -1;
  }
  apply<kCarry>(x, rec, deg, push);
  for (int p = r.x + kBatch; p < r.y; p += kBatch) {
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      x[k] = p + k < r.y ? __ldg(adj + p + k) : -1;
    }
    apply<kCarry>(x, rec, deg, push);
  }
  return r.y - r.x;
}

// Adds the thread's walked entries to flags[5]; the first thread of the
// first CTA writes the steps and the items processed.
__device__ __forceinline__ void report(int walked, int steps, int items,
                                       int* flags) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    walked += __shfl_down_sync(0xffffffffu, walked, o);
  }
  if ((threadIdx.x & 31) == 0 && walked) atomicAdd(flags + 5, walked);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    flags[3] = steps;
    flags[4] = items;
  }
}

// The steps from (head, tail, steps) on, in this CTA alone.
__device__ __forceinline__ void cta_steps(int head, int tail, int steps,
                                          int max_iters, int walked,
                                          const int4* __restrict__ rec,
                                          const int* __restrict__ adj,
                                          u64* deg, int* order,
                                          uint8_t* active, int* flags) {
  __shared__ int pushed[3];
  __shared__ int ring_v[2][kRing];
  __shared__ int4 ring_r[2][kRing];
  const int tid = threadIdx.x;
  if (tid < 3) pushed[tid] = 0;
  __syncthreads();
  bool in_ring = false;  // whether this step's first nodes are in the ring
  while (steps < max_iters) {
    ++steps;
    if (head == tail) break;  // this step removes nothing: it counts
    int* slot = pushed + steps % 3;
    const int cur = (steps - 1) & 1, next = steps & 1;
    const int base = tail;
    auto push = [&](int w, int4 rw) {
      const int k = claim(slot);
      if (k < kRing) {
        ring_v[next][k] = w;
        ring_r[next][k] = rw;
      } else {
        __stcg(order + base + k, w);
      }
    };
    for (int i = head + tid; i < tail; i += kThreads) {
      const int k = i - head;
      int v;
      int4 r;
      if (in_ring && k < kRing) {
        v = ring_v[cur][k];
        r = ring_r[cur][k];
      } else {
        v = __ldcg(order + i);
        r = __ldg(rec + v);
      }
      walked += remove_node<true>(v, r, rec, adj, deg, active, push);
    }
    if (tid == 0) pushed[(steps + 1) % 3] = 0;
    __syncthreads();
    head = tail;
    tail += pushed[steps % 3];
    in_ring = true;
  }
  report(walked, steps, head, flags);
}

__global__ void __launch_bounds__(kThreads, 1)
    trim_peel_cta(const int4* __restrict__ rec, const int* __restrict__ adj,
                  u64* deg, int* order, uint8_t* active, int* flags,
                  const int* __restrict__ ctl, int max_iters) {
  cta_steps(0, ctl[kFirstQueue], 0, max_iters, 0, rec, adj, deg, order,
            active, flags);
}

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

__global__ void __launch_bounds__(kThreads, 1)
    trim_peel_grid(const int4* __restrict__ rec, const int* __restrict__ adj,
                   u64* deg, int* order, uint8_t* active, int* flags,
                   int* ctl, int max_iters) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int nth = gridDim.x * kThreads;
  int head = 0, tail = ctl[kFirstQueue], steps = 0, walked = 0;
  while (steps < max_iters && tail - head >= kGridMinItems) {
    ++steps;
    int* slot = ctl + steps % 3;
    const int base = tail;
    auto push = [&](int w, int4) {
      __stcg(order + base + claim(slot), w);
    };
    for (int i = head + g; i < tail; i += nth) {
      const int v = __ldcg(order + i);
      walked += remove_node<false>(v, __ldg(rec + v), rec, adj, deg, active,
                                   push);
    }
    if (g == 0) ctl[(steps + 1) % 3] = 0;
    grid_barrier(reinterpret_cast<unsigned int*>(ctl + 3));
    head = tail;
    tail += __ldcg(ctl + steps % 3);
  }
  if (blockIdx.x != 0) {
    report(walked, steps, head, flags);
    return;
  }
  cta_steps(head, tail, steps, max_iters, walked, rec, adj, deg, order,
            active, flags);
}

struct Device {
  int sms = 0;
  int grid = 0;  // resident CTAs of trim_peel_grid
  cudaError_t err = cudaSuccess;
};

// Once per device and process: the SM count and how many CTAs of the grid
// peel stay resident.
Device device_setup() {
  static std::mutex mu;
  static Device devices[kMaxDevices];
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return Device{0, 0, err};
  if (dev >= kMaxDevices) return Device{0, 0, cudaErrorInvalidDevice};
  std::lock_guard<std::mutex> lock(mu);
  if (ready[dev]) return devices[dev];
  Device d;
  int per_sm = 0;
  d.err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                 dev);
  if (d.err == cudaSuccess) {
    d.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, trim_peel_grid, kThreads, 0);
  }
  d.grid = d.sms * per_sm;
  if (d.err == cudaSuccess && d.grid < 1) {
    d.err = cudaErrorLaunchOutOfResources;
  }
  devices[dev] = d;
  ready[dev] = true;
  return d;
}

}  // namespace

// scratch: int32[7n + 2E + 8] (the records [4n], the degree words [2n],
// the control words [8], the entries [2E], the queue [n]), not cleared by
// the caller; flags: int32[8] (out): [3] the steps, [4] the worklist
// items, [5] the row entries walked. active: uint8[n] (out).
extern "C" int jt_scc_trim(void* src, void* dst, void* valid, void* active,
                           void* scratch, void* flags, int E, int n,
                           int max_iters, void* stream) {
  if (n < 1 || n >= (1 << 30) || E < 0 || max_iters < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Device dev = device_setup();
  if (dev.err != cudaSuccess) return (int)dev.err;
  cudaStream_t st = (cudaStream_t)stream;
  const int* s = (const int*)src;
  const int* d = (const int*)dst;
  const uint8_t* ok = (const uint8_t*)valid;
  uint8_t* act = (uint8_t*)active;
  int* fl = (int*)flags;
  int4* rec = (int4*)scratch;
  u64* deg = (u64*)(rec + n);
  int* ctl = (int*)(deg + n);
  int* adj = ctl + 8;
  int* order = adj + 2 * (size_t)E;
  cudaError_t err =
      cudaMemsetAsync(deg, 0, sizeof(u64) * n + 8 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  int grid = (E + kEdgeThreads - 1) / kEdgeThreads;
  if (grid > 8 * dev.sms) grid = 8 * dev.sms;
  const int node_grid = (n + kThreads - 1) / kThreads;
  if (E > 0) trim_count<<<grid, kEdgeThreads, 0, st>>>(s, d, ok, deg, E, n);
  trim_place<<<node_grid, kThreads, 0, st>>>(deg, rec, order, act, ctl, fl,
                                             n);
  if (E > 0) {
    trim_fill<<<grid, kEdgeThreads, 0, st>>>(s, d, ok, rec, adj, E, n);
  }
  trim_records<<<node_grid, kThreads, 0, st>>>(rec, adj, n);
  const int4* crec = rec;
  const int* cadj = adj;
  if (n <= kOneCtaMaxNodes && E <= kOneCtaMaxEdges) {
    trim_peel_cta<<<1, kThreads, 0, st>>>(crec, cadj, deg, order, act, fl,
                                          ctl, max_iters);
  } else {
    void* args[] = {&crec, &cadj, &deg, &order, &act, &fl, &ctl,
                    &max_iters};
    err = cudaLaunchCooperativeKernel((const void*)trim_peel_grid,
                                      dim3(dev.grid), dim3(kThreads), args,
                                      0, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
