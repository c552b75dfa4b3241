// First dead prefix of a chain of chunk products, for Hopper (sm_90a).
//
// Replaces `prefix_alive` of jepsen_tpu/ops/jitlin.py:1623-1636 (inside
// `_build_forensics_kernel`, :1584), an XLA program: an associative scan
// of the C chunk products into prefix products, then each prefix applied
// to the initial frontier v0. Its only reader, `matrix_localize`
// (jitlin.py:1755-1775), takes from it the first chunk c* whose prefix
// leaves no configuration alive and the frontier at that chunk's entry,
// prefix[c* - 1] @ v0. A prefix's frontier is the same boolean vector
// under any association, so this kernel chains the frontier instead:
// w_0 = v0, w_{c+1} = (P[c] @ w_c > 0), alive[c] = any(w_{c+1}). That is
// C matrix-vector steps in place of O(C) [MV, MV] products, and alive and
// w_{c*} are bit-equal to the reference's.
//
// What it computes: P [C, MV, MV] bf16 (an entry counts as 1 when > 0),
// v0 [W] packed words -> alive [C] int32 0/1 and w [C + 1, W] packed
// words (W = MV / 32, one word below MV = 32; bit j of word i is
// configuration 32 i + j). MV is a power of two, 8 <= MV <= 4096.
//
// What bounds it: the bytes of the chunks up to the first dead one, C'
// MV^2 bf16 (21.2 MB at the corrupted headline's C' = 162 of C = 256,
// MV = 256: 6.3 us at 3.35 TB/s), since a chain that knew where it dies
// would read no further; a step is MV^2 / 32 word ORs at most, few next
// to the bytes. This design's pack still reads all C chunks (33.5 MB at
// the headline, 1.6x the bound's bytes): the chain learns where the
// frontier dies only by walking it, and a pack that ran behind the chain
// would put the reads back on its critical path. The chain is a
// dependent sequence of C steps, so past the pack its time is C times a
// step's latency, which the design keeps short:
//
// 1. Pack (one launch over every SM): each chunk becomes its transposed
//    bit matrix [MV, W] in a workspace, column j's MV rows as W words
//    (bit b of word k: P[c][32 k + b][j] > 0). A CTA takes 32 rows by up
//    to 256 columns: its loads read whole 512-byte row runs, 16 bytes a
//    lane (P just written by the chunk product is in L2 up to MV =
//    256), the rows' words meet in shared memory, and a warp transposes
//    each 32 x 32 bit block by five shuffle rounds.
// 2. Chain: the new frontier is the OR of the words of the frontier's
//    live columns, and the packed words do not depend on the frontier,
//    so they are fetched ahead of the step:
//    - up to MV = 512 (warp_chain_kernel) one warp chains: a lane keeps
//      the whole frontier in registers and ORs 4-word vectors of its
//      live columns, and one warp reduction (redux) a word gives every
//      lane the new frontier, with no CTA barrier; a second warp keeps
//      a ring of up to kMaxStages shared-memory stages full (one bulk
//      asynchronous copy, `cp.async.bulk` completing on an mbarrier, a
//      chunk), each stage passing between the warps by full and empty
//      mbarriers. It is launched while the pack runs (a programmatic
//      dependent launch), so that its launch and prologue overlap the
//      pack, and waits for the pack's words;
//    - above, the columns are split over a thread-block cluster (4 CTAs
//      at MV = 1024, 16 at 2048 and 4096; fewer where the card cannot
//      hold such a cluster), each CTA's threads ORing their live
//      columns (a group of W threads, a lane a word) into partial
//      frontiers that meet in shared memory, double-buffered by the
//      chunk's parity, and across the cluster through distributed shared
//      memory: a CTA barrier (`__syncthreads_or`, which also gives
//      `alive`) and a cluster barrier a chunk. A CTA's slice of a chunk
//      comes from a ring like the warp's up to 32 KB (MV <= 2048); at MV
//      = 4096 (128 KB a CTA) its threads read their live columns' words
//      from global memory, a warp 32 consecutive words of one column.
//    Once the frontier is 0 it stays 0: the rest of `alive` and `w` are
//    written 0 without reading more chunks.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W, ops/forensics_compare against
// the first design in one run): at the corrupted headline the C entry
// takes 0.0751 ms, 8.4 % of its 0.00634 ms bound (the first design
// 0.2638 ms, 2.4 %): the pack about 11 us, the chain 0.38 us a chunk, a
// step's latency (the first design's 1.55 us). At MV = 4096, C = 16:
// 0.3169 ms, 51 % of its 0.160 ms bound (4.654 ms); MV = 1024, C = 256:
// 0.7749 ms, 21 % (5.799 ms).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "forensics.cuh"
#include "smem_limit.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kPackWarps = 8;
constexpr int kPackThreads = kPackWarps * 32;
constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 16;
constexpr int kMaxStages = 8;
// a CTA's slice of a packed chunk up to which it takes the ring, and the
// ring's room
constexpr long kSliceBytes = 32768;
constexpr long kRingBytes = 192 * 1024;
// the columns a thread ORs a step, as the thread count allows
constexpr int kColsPerThread = 16;
// MV up to which one warp chains (warp_chain_kernel), and where its ring
// starts in shared memory (past the full and empty mbarriers and flags)
constexpr int kWarpMaxMV = 512;
constexpr int kRingOffset = 256;

// ---------------------------------------------------------------------------
// the pack
// ---------------------------------------------------------------------------

// MV >= 32. Block (chunk c, row tile kt of 32 rows, block cb of up to
// 256 columns). Warp w reads rows 4 w ... 4 w + 3 of the tile, a row's
// 256 columns (512 bytes) a load instruction, 16 bytes a lane; the
// lanes of a 32-column group OR their bytes into the row's word of the
// group by two xor shuffles. Then warp q takes group q's 32 row words
// and transposes them by five shuffle rounds (fx_transpose_step): lane
// l ends holding column 32 q + l's word kt.
__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const uint16_t* __restrict__ P, uint32_t* __restrict__ ws,
            int MV, int W, int cblocks) {
  __shared__ uint32_t rw[32][kPackWarps + 1];  // [row][column group]
  // the chain may launch now: its prologue overlaps the pack
  asm volatile("griddepcontrol.launch_dependents;");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cb = blockIdx.x % cblocks;
  const int kt = (blockIdx.x / cblocks) % W;
  const int c = blockIdx.x / cblocks / W;
  const int ncols = MV < 256 ? MV : 256;  // this block's columns
  const int j0 = cb * 256;
  if (8 * lane < ncols) {
    const uint16_t* base = P + (size_t)c * MV * MV +
                           (size_t)(kt * 32 + 4 * warp) * MV + j0 + 8 * lane;
    uint4 x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      x[r] = __ldg(reinterpret_cast<const uint4*>(base + (size_t)r * MV));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t b = fx_pos_bits8(x[r].x, x[r].y, x[r].z, x[r].w)
                   << (8 * (lane & 3));
      b |= __shfl_xor_sync(0xFFFFFFFFu >> (32 - ncols / 8), b, 1);
      b |= __shfl_xor_sync(0xFFFFFFFFu >> (32 - ncols / 8), b, 2);
      if ((lane & 3) == 0) rw[4 * warp + r][lane >> 2] = b;
    }
  }
  __syncthreads();
  if (32 * warp < ncols) {
    uint32_t col = rw[lane][warp];  // row lane's bits of group warp
#pragma unroll
    for (int j = 16; j > 0; j >>= 1)
      col = fx_transpose_step(col, __shfl_xor_sync(kFull, col, j), lane, j);
    ws[((size_t)c * MV + j0 + 32 * warp + lane) * W + kt] = col;
  }
}

// MV < 32 (MV = 8, 16): one word a column, one thread a column.
__global__ void __launch_bounds__(256)
pack_small_kernel(const uint16_t* __restrict__ P, uint32_t* __restrict__ ws,
                  int C, int MV) {
  asm volatile("griddepcontrol.launch_dependents;");
  const int o = blockIdx.x * blockDim.x + threadIdx.x;  // chunk * MV + col
  if (o >= C * MV) return;
  const int c = o / MV, j = o - c * MV;
  uint32_t w = 0;
  for (int i = 0; i < MV; ++i)
    if (fx_bf16_pos(P[((size_t)c * MV + i) * MV + j])) w |= 1u << i;
  ws[o] = w;
}

// ---------------------------------------------------------------------------
// the chain
// ---------------------------------------------------------------------------

struct Plan {
  int nc;       // CTAs a cluster
  int stages;   // ring stages a CTA (0: the words from global memory)
  int threads;  // a CTA
  int cols;     // columns a thread ORs a step
  int nslot;    // partial frontiers a CTA writes a step
  int smem;     // dynamic shared bytes a CTA
};

__host__ __device__ inline int words_of(int MV) {
  return MV >= 32 ? MV >> 5 : 1;
}

// the plan at cluster size nc (a power of two); up to kWarpMaxMV one
// warp chains (nslot = 0)
inline Plan plan_at(int C, int MV, int nc) {
  const int W = words_of(MV);
  const long slice = (long)MV * W * 4 / nc;
  Plan p{};
  if (MV <= kWarpMaxMV) {
    long s = kRingBytes / slice;
    s = s > kMaxStages ? kMaxStages : s;
    p.nc = 1;
    p.stages = (int)(s > C ? C : s);
    p.threads = 64;
    p.cols = (MV + 31) / 32 * (W < 4 ? 1 : W / 4);  // a lane's loads
    p.nslot = 0;
    p.smem = kRingOffset + (int)(p.stages * slice);
    return p;
  }
  p.nc = nc;
  p.stages = 0;
  if (slice <= kSliceBytes) {
    long s = kRingBytes / slice;
    if (s > kMaxStages) s = kMaxStages;
    if (s > C) s = C;
    p.stages = (int)s;
  }
  const int mvc = MV / nc;
  int t = (int)((long)mvc * W / kColsPerThread);
  t = t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
  p.threads = t;
  const int G = t / W;
  p.cols = mvc / G > 0 ? mvc / G : 1;
  p.nslot = G;
  p.smem = kMaxStages * 8 + (int)(p.stages * slice) +
           2 * p.nslot * W * 4 + (nc > 1 ? 2 * nc * (W + 1) * 4 : 0);
  return p;
}

struct ChainArgs {
  const uint32_t* pk;
  const uint32_t* v0;
  int32_t* alive;
  uint32_t* wout;
  int C, MV, W, mvc, cols, nslot, stages, nc;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0u;
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// a barrier of the first n threads (whole warps) under id
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// one bulk copy of `bytes` (a multiple of 16) from global src to shared
// dst, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// MV <= 512, one CTA of two warps: warp 0 chains, warp 1 (lane 0) keeps
// the ring of stages full. Lane l of warp 0 keeps the whole frontier in
// registers (f[W]) and owns kVW words (h = l % kLPC) of the columns
// l / kLPC + kCPI i: it ORs their kVW-word vectors where the column is
// live, and W warp reductions (redux) give every lane the new frontier. No CTA barrier: the stages pass between
// the warps by the full and empty mbarriers.
template <int MV>
__global__ void __launch_bounds__(64)
warp_chain_kernel(const ChainArgs a) {
  constexpr int W = MV >= 32 ? MV / 32 : 1;
  constexpr int kVW = W < 4 ? W : 4;  // words a load
  constexpr int kLPC = W / kVW;       // lanes a column
  constexpr int kCPI = 32 / kLPC;     // columns a load instruction
  constexpr int kNI = (MV + kCPI - 1) / kCPI;
  using Vec = typename std::conditional<
      kVW == 4, uint4,
      typename std::conditional<kVW == 2, uint2, uint32_t>::type>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  volatile int* flags = reinterpret_cast<volatile int*>(empty + kMaxStages);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + kRingOffset);
  const int C = a.C, stages = a.stages;
  const int lane = threadIdx.x & 31;
  constexpr uint32_t kChunkWords = (uint32_t)MV * W;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s);
      mbar_init(empty + s);
    }
    flags[0] = 0;  // the consumer's stop: the first chunk it leaves
    flags[1] = 0;  // the chunks the producer issued
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 32) {  // the producer
    if (lane == 0) {
      // the pack's words are complete and visible
      asm volatile("griddepcontrol.wait;" ::: "memory");
      int i = 0;
      for (; i < stages; ++i)
        bulk_load(ring + i * kChunkWords, a.pk + (size_t)i * kChunkWords,
                  kChunkWords * 4, full + i);
      for (; i < C; ++i) {
        const int s = i % stages;
        // the consumer's release of chunk i - stages, unless it stopped
        bool stop = false;
        while (!mbar_test(empty + s, (uint32_t)(((i - stages) / stages) & 1)))
          if (flags[0]) {
            stop = true;
            break;
          }
        if (stop) break;
        bulk_load(ring + s * kChunkWords, a.pk + (size_t)i * kChunkWords,
                  kChunkWords * 4, full + s);
      }
      flags[1] = i;
    }
    __syncwarp();
    named_sync(1, 64);
    return;
  }
  const int h = lane % kLPC;
  const int col = lane / kLPC;
  uint32_t f[W];
#pragma unroll
  for (int w = 0; w < W; ++w) f[w] = a.v0[w];
  if (lane < W) a.wout[lane] = a.v0[lane];
  int c = 0;
  for (; c < C; ++c) {
    const int s = c % stages;
    mbar_wait(full + s, (uint32_t)((c / stages) & 1));
    const uint32_t* chunk = ring + s * kChunkWords + h * kVW;
    uint32_t acc[kVW];
#pragma unroll
    for (int q = 0; q < kVW; ++q) acc[q] = 0u;
#pragma unroll
    for (int i = 0; i < kNI; ++i) {
      const int j = i * kCPI + col;  // the column
      if (j < MV && ((f[(i * kCPI) >> 5] >> (((i * kCPI) & 31) + col)) & 1u)) {
        const Vec x = *reinterpret_cast<const Vec*>(chunk + j * W);
        const uint32_t* xv = reinterpret_cast<const uint32_t*>(&x);
#pragma unroll
        for (int q = 0; q < kVW; ++q) acc[q] |= xv[q];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);  // the stage is read
    // word w of the new frontier: the warp's OR (one redux each) of the
    // lanes that own it; every lane gets every word
    uint32_t any = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      f[w] = __reduce_or_sync(kFull, h == w / kVW ? acc[w % kVW] : 0u);
      any |= f[w];
    }
    if (lane < W) {
      uint32_t mine = 0;
#pragma unroll
      for (int w = 0; w < W; ++w)
        if (w == lane) mine = f[w];
      a.wout[(size_t)(c + 1) * W + lane] = mine;
    }
    if (lane == 0) a.alive[c] = any != 0u;
    if (!any) break;
  }
  if (lane == 0) flags[0] = c + 1 > C ? C : c + 1;
  named_sync(1, 64);
  // no copy may land in the shared memory of a CTA that has left
  if (lane == 0)
    for (int i = c + 1; i < flags[1]; ++i)
      mbar_wait(full + i % stages, (uint32_t)((i / stages) & 1));
  for (int i = lane; i < C - 1 - c; i += 32) a.alive[c + 1 + i] = 0;
  for (int i = lane; i < (C - 1 - c) * W; i += 32)
    a.wout[(size_t)(c + 2) * W + i] = 0u;
}

// MV > kWarpMaxMV: a CTA of a cluster's slice of the columns.
template <bool kRing>
__global__ void __launch_bounds__(kMaxThreads)
chain_kernel(const ChainArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int W = a.W, C = a.C, nc = a.nc, nslot = a.nslot;
  const int tid = threadIdx.x;
  const int k = tid & (W - 1);
  const size_t slice_words = (size_t)a.mvc * W;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + kMaxStages * 8);
  uint32_t* red = ring + (kRing ? a.stages * slice_words : 0);
  uint32_t* xred = red + 2 * nslot * W;  // [2][nc][W] (nc > 1)
  uint32_t* xflag = xred + 2 * nc * W;   // [2][nc]
  const int rank = nc > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const uint32_t* src = a.pk + (size_t)rank * slice_words;

  // this thread's columns (within the CTA's slice): a group of W
  // threads (W >= 32: MV >= 1024) takes cols contiguous columns, a lane
  // a word of each, 32 columns (a frontier word) at a time
  const int base = (tid / W) * a.cols;
  const int per_word = a.cols < 32 ? a.cols : 32;
  const bool has_cols = base < a.mvc;

  // the frontier before chunk 0: v0 in slot 0 of parity 1
  uint32_t* pre = nc > 1 ? xred + nc * W : red + nslot * W;
  const int npre = nc > 1 ? nc : nslot;
  for (int i = tid; i < npre * W; i += blockDim.x)
    pre[i] = i < W ? a.v0[i] : 0u;
  if (rank == 0 && tid < W) a.wout[tid] = a.v0[tid];
  int issued = 0;
  if (kRing && tid == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(full + s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (kRing && tid == 0)
    for (; issued < a.stages; ++issued)
      bulk_load(ring + issued * slice_words,
                src + (size_t)issued * a.MV * W,
                (uint32_t)(slice_words * 4), full + issued);
  if (nc > 1) cg::this_cluster().sync();

  int c = 0;
  for (; c < C; ++c) {
    const int par = c & 1;
    const uint32_t* prev = nc > 1 ? xred + (par ^ 1) * nc * W
                                  : red + (par ^ 1) * nslot * W;
    const uint32_t* chunk;
    int stage = 0;
    if (kRing) {
      stage = c % a.stages;
      mbar_wait(full + stage, (uint32_t)((c / a.stages) & 1));
      chunk = ring + stage * slice_words;
    } else {
      chunk = src + (size_t)c * a.MV * W;
    }
    uint32_t acc = 0;
    if (has_cols)
      for (int i0 = 0; i0 < a.cols; i0 += per_word) {
        const int j = base + i0;
        const int gj = rank * a.mvc + j;
        const uint32_t fw = fx_front_word(prev, npre, W, gj >> 5);
        acc |= fx_live_or(chunk + (size_t)j * W + k, fw >> (gj & 31),
                          per_word, W);
      }
    red[(par * nslot + tid / W) * W + k] = acc;
    int any = __syncthreads_or(acc != 0u);
    if (kRing && tid == 0 && issued < C) {
      // every thread has left this stage (the barrier above)
      bulk_load(ring + stage * slice_words, src + (size_t)issued * a.MV * W,
                (uint32_t)(slice_words * 4), full + stage);
      ++issued;
    }
    const uint32_t* now = red + par * nslot * W;
    if (nc > 1) {
      cg::cluster_group cl = cg::this_cluster();
      if (tid < W) {
        const uint32_t x = fx_front_word(now, nslot, W, tid);
        for (int r = 0; r < nc; ++r)
          *cl.map_shared_rank(xred + (par * nc + rank) * W + tid, r) = x;
      }
      if (tid == 0)
        for (int r = 0; r < nc; ++r)
          *cl.map_shared_rank(xflag + par * nc + rank, r) = (uint32_t)any;
      cl.sync();
      any = 0;
      for (int r = 0; r < nc; ++r) any |= (int)xflag[par * nc + r];
      now = xred + par * nc * W;
    }
    if (rank == 0 && tid < W)
      a.wout[(size_t)(c + 1) * W + tid] = fx_front_word(now, npre, W, tid);
    if (rank == 0 && tid == 0) a.alive[c] = any != 0;
    if (!any) break;
  }
  // the frontier died at chunk c (c = C: it never did): every later
  // prefix is dead too
  if (rank == 0) {
    for (int i = tid; i < C - 1 - c; i += blockDim.x) a.alive[c + 1 + i] = 0;
    for (long long i = tid; i < (long long)(C - 1 - c) * W; i += blockDim.x)
      a.wout[(size_t)(c + 2) * W + i] = 0u;
  }
  // no copy may land in the shared memory of a CTA that has left
  if (kRing && tid == 0)
    for (int i = c + 1; i < issued; ++i)
      mbar_wait(full + i % a.stages, (uint32_t)((i / a.stages) & 1));
}

// the cluster size that a launch takes at MV: the plan's, halved while
// the card cannot hold one such cluster (kept a power of two)
int cluster_at(int MV) {
  static int cached[13] = {0};
  int lg = 0;
  while ((1 << lg) < MV) ++lg;
  const int W = words_of(MV);
  int nc = 1;
  while (nc < kMaxCluster && (long)MV * W * 4 / nc > kSliceBytes) nc *= 2;
  if (nc == 1) return 1;
  if (cached[lg]) return cached[lg];
  for (; nc > 1; nc >>= 1) {
    const Plan p = plan_at(1 << 30, MV, nc);  // the most stages
    auto kern = p.stages ? chain_kernel<true> : chain_kernel<false>;
    allow_smem((const void*)kern, p.smem);
    cudaFuncSetAttribute(kern,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = nc;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(nc);
    cfg.blockDim = dim3(p.threads);
    cfg.dynamicSmemBytes = p.smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, (void*)kern, &cfg) ==
            cudaSuccess &&
        n >= 1)
      break;
    cudaGetLastError();  // a refused size is not the caller's error
  }
  cached[lg] = nc;
  return nc;
}

Plan plan_for(int C, int MV) {
  return plan_at(C, MV, cluster_at(MV));
}

}  // namespace

// The launch plan of the chain at (C, MV): plan[0 ... 5] = CTAs a
// cluster, ring stages a CTA (0: the words from global memory), threads
// a CTA, columns a thread, partial frontiers a CTA and dynamic shared
// bytes a CTA. Returns cudaGetLastError().
extern "C" int jt_prefix_alive_plan(int C, int MV, void* plan) {
  const Plan p = plan_for(C, MV);
  int32_t* out = (int32_t*)plan;
  out[0] = p.nc;
  out[1] = p.stages;
  out[2] = p.threads;
  out[3] = p.cols;
  out[4] = p.nslot;
  out[5] = p.smem;
  return (int)cudaGetLastError();
}

// P [C, MV, MV] bf16, 16-byte aligned; v0 [W] words; alive [C] int32;
// w [C + 1, W] words; ws [C, MV, W] words of workspace. MV is a power of
// two, 8 <= MV <= 4096, C >= 1. Enqueues the pack and the chain on
// `stream` and returns the first non-zero cudaGetLastError().
extern "C" int jt_prefix_alive(void* P, void* v0, void* alive, void* w,
                               void* ws, int C, int MV, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int W = words_of(MV);
  const uint16_t* Pp = (const uint16_t*)P;
  uint32_t* wsp = (uint32_t*)ws;
  if (MV >= 32) {
    const int cblocks = MV > 256 ? MV / 256 : 1;
    pack_kernel<<<C * W * cblocks, kPackThreads, 0, st>>>(Pp, wsp, MV, W,
                                                          cblocks);
  } else {
    pack_small_kernel<<<(C * MV + 255) / 256, 256, 0, st>>>(Pp, wsp, C, MV);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Plan p = plan_for(C, MV);
  const ChainArgs args{wsp, (const uint32_t*)v0, (int32_t*)alive,
                       (uint32_t*)w, C, MV, W, MV / p.nc, p.cols, p.nslot,
                       p.stages, p.nc};
  void (*kern)(ChainArgs);
  switch (MV) {
    case 8: kern = warp_chain_kernel<8>; break;
    case 16: kern = warp_chain_kernel<16>; break;
    case 32: kern = warp_chain_kernel<32>; break;
    case 64: kern = warp_chain_kernel<64>; break;
    case 128: kern = warp_chain_kernel<128>; break;
    case 256: kern = warp_chain_kernel<256>; break;
    case 512: kern = warp_chain_kernel<512>; break;
    default: kern = p.stages ? chain_kernel<true> : chain_kernel<false>;
  }
  err = allow_smem((const void*)kern, p.smem);
  if (err != cudaSuccess) return (int)err;
  // the warp design is launched while the pack runs (programmatic
  // dependent launch: its one small CTA takes one SM from the pack) and
  // waits for the pack's words (griddepcontrol.wait); a cluster, which
  // would take up to 16 SMs from the pack, launches after it
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  if (p.nslot == 0) {
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
  } else {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.nc;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
  }
  cfg.gridDim = dim3(p.nc);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = p.nslot == 0 || p.nc > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
