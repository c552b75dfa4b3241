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
// What bounds it: the bytes of the chunks it must read, C' MV^2 bf16 for
// the C' chunks up to the first dead one (134 MB at C = 256, MV = 512:
// 40 us at 3.35 TB/s); a step is MV^2 / 32 word ANDs, few next to the
// bytes. What the design does about it:
//
// 1. Pack (one launch over every SM): each chunk becomes bit-packed rows
//    [MV, W] in a workspace, 16 bytes of bf16 a lane, as chunk_combine.cu
//    packs its leaves (copied here; that file is unchanged). This is the
//    only pass that reads P, and it reads all C chunks.
// 2. Chain (one CTA of 1024 threads): the frontier lives in shared memory
//    (W <= 128 words); for each chunk the warps walk its packed words,
//    32 a warp at a time, and a word whose frontier word is 0 is not
//    read. A warp's hits are a ballot; lane 0 ORs the rows they set into
//    the new frontier with one shared atomic. A barrier ends each chunk.
//    Once the frontier is 0 it stays 0: the rest of `alive` and `w` are
//    written 0 without reading more chunks.
//
// A simple first design: the chain runs on one SM, from the packed
// chunks that the pack has just left in L2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "forensics.cuh"

namespace {

constexpr int kPackThreads = 256;
constexpr int kPackWarps = kPackThreads / 32;
constexpr int kPackUnroll = 4;
constexpr int kChainThreads = 1024;
constexpr int kMaxWords = 128;  // W at MV = 4096

__device__ __forceinline__ uint32_t pos_bits(uint32_t two) {
  return (fx_bf16_pos((uint16_t)(two & 0xFFFFu)) ? 1u : 0u) |
         (fx_bf16_pos((uint16_t)(two >> 16)) ? 2u : 0u);
}

// MV % 32 == 0: a packed [MV, W] chunk is its entries as one flat bit
// string, so a warp packs a run of 256 contiguous entries (512 bytes)
// into 8 words. Grid (chunk, block of runs within the chunk).
__global__ void __launch_bounds__(kPackThreads)
pack_flat_kernel(const uint16_t* __restrict__ P, uint32_t* __restrict__ ws,
                 int MV) {
  const int lane = threadIdx.x & 31;
  const size_t mat = (size_t)MV * MV;
  const int runs = (int)(mat >> 8);
  const uint4* src =
      reinterpret_cast<const uint4*>(P + (size_t)blockIdx.x * mat);
  uint32_t* dst = ws + (size_t)blockIdx.x * (mat >> 5);
  const int r0 = blockIdx.y * kPackWarps * kPackUnroll + (threadIdx.x >> 5);
  uint4 x[kPackUnroll];
#pragma unroll
  for (int u = 0; u < kPackUnroll; ++u) {
    const int r = r0 + u * kPackWarps;
    if (r < runs) x[u] = __ldg(src + (r << 5) + lane);
  }
#pragma unroll
  for (int u = 0; u < kPackUnroll; ++u) {
    const int r = r0 + u * kPackWarps;
    if (r < runs) {  // the same for every lane of the warp
      uint32_t w = pos_bits(x[u].x) | pos_bits(x[u].y) << 2 |
                   pos_bits(x[u].z) << 4 | pos_bits(x[u].w) << 6;
      w <<= (lane & 3) << 3;
      w |= __shfl_xor_sync(0xFFFFFFFFu, w, 1);
      w |= __shfl_xor_sync(0xFFFFFFFFu, w, 2);
      if ((lane & 3) == 0) dst[(r << 3) + (lane >> 2)] = w;
    }
  }
}

// MV < 32 (MV = 8, 16): one word a row, one thread a row.
__global__ void __launch_bounds__(kPackThreads)
pack_rows_kernel(const uint16_t* __restrict__ P, uint32_t* __restrict__ ws,
                 int C, int MV) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;  // chunk * MV + row
  if (o >= C * MV) return;
  const uint16_t* row = P + (size_t)o * MV;
  uint32_t w = 0;
  for (int l = 0; l < MV; ++l)
    if (fx_bf16_pos(row[l])) w |= 1u << l;
  ws[o] = w;
}

__global__ void __launch_bounds__(kChainThreads)
chain_kernel(const uint32_t* __restrict__ pk, const uint32_t* __restrict__ v0,
             int32_t* __restrict__ alive, uint32_t* __restrict__ wout, int C,
             int MV, int W) {
  __shared__ uint32_t w[kMaxWords];
  __shared__ uint32_t nw[kMaxWords];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int n = MV * W;
  if (tid < W) {
    w[tid] = v0[tid];
    nw[tid] = 0;
    wout[tid] = v0[tid];
  }
  __syncthreads();
  int c = 0;
  for (; c < C; ++c) {
    const uint32_t* pc = pk + (size_t)c * n;
    for (int q0 = warp << 5; q0 < n; q0 += nwarps << 5) {
      const int q = q0 + lane;
      const bool hit = q < n && w[q & (W - 1)] != 0 &&
                       fx_hit(__ldg(pc + q), w, q, W);
      const uint32_t hits = __ballot_sync(0xFFFFFFFFu, hit);
      if (lane == 0 && hits) {
        const int row0 = q0 / W;
        atomicOr(&nw[row0 >> 5], fx_segment_bits(hits, W) << (row0 & 31));
      }
    }
    __syncthreads();
    const uint32_t x = tid < W ? nw[tid] : 0u;
    const int any = __syncthreads_or(x != 0u);
    if (tid < W) {
      w[tid] = x;
      nw[tid] = 0;
      wout[(size_t)(c + 1) * W + tid] = x;
    }
    if (tid == 0) alive[c] = any;
    __syncthreads();
    if (!any) break;
  }
  // the frontier died at chunk c (c = C: it never did): every later
  // prefix is dead too
  for (int i = tid; i < C - 1 - c; i += blockDim.x) alive[c + 1 + i] = 0;
  for (long long i = tid; i < (long long)(C - 1 - c) * W; i += blockDim.x)
    wout[(size_t)(c + 2) * W + i] = 0u;
}

}  // namespace

// P [C, MV, MV] bf16, 16-byte aligned; v0 [W] words; alive [C] int32;
// w [C + 1, W] words; ws [C, MV, W] words of workspace. MV is a power of
// two, 8 <= MV <= 4096, C >= 1. Enqueues the pack and the chain on
// `stream` and returns the first non-zero cudaGetLastError().
extern "C" int jt_prefix_alive(void* P, void* v0, void* alive, void* w,
                               void* ws, int C, int MV, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int W = MV >= 32 ? MV >> 5 : 1;
  const uint16_t* Pp = (const uint16_t*)P;
  uint32_t* wsp = (uint32_t*)ws;
  if (MV >= 32) {
    const int runs = MV * MV >> 8;
    const int per_block = kPackWarps * kPackUnroll;
    const dim3 grid(C, (runs + per_block - 1) / per_block);
    pack_flat_kernel<<<grid, kPackThreads, 0, st>>>(Pp, wsp, MV);
  } else {
    const int rows = C * MV;
    pack_rows_kernel<<<(rows + kPackThreads - 1) / kPackThreads,
                       kPackThreads, 0, st>>>(Pp, wsp, C, MV);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chain_kernel<<<1, kChainThreads, 0, st>>>(
      wsp, (const uint32_t*)v0, (int32_t*)alive, (uint32_t*)w, C, MV, W);
  return (int)cudaGetLastError();
}
