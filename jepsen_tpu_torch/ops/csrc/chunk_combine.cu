// Chunk-product combine for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel jepsen_tpu/ops/pallas_matrix.py
// `_build_combine` (pl.pallas_call at :824, body :805-818).
//
// What it computes, per key b: total[b] = P[b, C-1] . ... . P[b, 0] .
// tot0[b], thresholded > 0 after every product, written as bf16 0/1
// [B, MV, MV]. An entry counts as 1 when its bf16 value is > 0 (not NaN).
//
// What bounds it. The B*(C+2)*MV^2 bf16 entries read once and written
// once: 33.5 MB at the headline (B = 1, C = 256, MV = 256), about 10 us at
// 3.35 TB/s. Counted as dense products the chain is B*C*2*MV^3 operations
// (8.6e9, about 4 us at the int8 tensor rate); bit-packed, at most 134 M
// word-ORs, fewer over the set bits of sparse rows. The TPU kernel
// streamed the chain in order because its grid runs on one core; run that
// way here, one SM does C products in sequence while 131 idle.
//
// What the design does about it. The boolean product is exact under any
// association, so the chain becomes a tree of products spread over every
// SM:
//
// 1. Pack (one launch over the whole grid): every tot0[b] and P[b, c]
//    becomes bit-packed rows [MV, W] (W = MV / 32 words, one partly
//    filled word below MV = 32) in a workspace, leaf order tot0[b],
//    P[b, 0], ..., P[b, C-1]. Each lane reads 16 bytes of a warp's 512
//    contiguous bytes; four lanes OR their bytes into one word. This is the
//    only pass that reads P.
// 2. Tree (one launch per level): node j of level l+1 is the product of up
//    to kFanIn consecutive level-l nodes, the latest on the left; a last
//    group of one node is carried up. Each product is split by rows across
//    at least two CTAs, with the rows per CTA chosen per level so that
//    every level, down to the last single product, puts kCtasPerSm CTAs per
//    SM in flight where the rows allow. A CTA copies its right operands
//    into shared memory (8 KB each at MV = 256, 32 KB at 512); a warp
//    carries one row through them, out[j] = OR over the set bits k of the
//    row of right[k, j]. The warp's lanes split the row's bits and each ORs
//    16 bytes of right rows at a time; warp shuffles OR the partial words.
//    Levels ping-pong between two workspace buffers: a level never writes
//    the nodes it reads.
// 3. The last level writes bf16 0x3F80 / 0 straight to `out`.
//
// What bounds the design is the chain of levels, not arithmetic: each
// level is a launch that fills shared memory with its right operands
// before any row is multiplied, a floor of 3-5 us on an H100. A fan-in of
// 4 takes ceil(log4(C+1)) levels (5 at the headline, against 9 for
// pairs) for the same C products, and measured faster than fan-ins of 2
// and 8. Rows with many set bits cost more: the OR work then bounds the
// first levels. The tensor cores are not used: the bit-packed work is a
// few us over 132 SMs, and int8 operands would not fit a CTA at MV = 512.
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPackUnroll = 4;
constexpr int kFanIn = 4;
constexpr int kCtasPerSm = 4;

__device__ __forceinline__ bool bf16_pos(uint16_t h) {
  return !(h & 0x8000u) && h != 0 && h <= 0x7F80u;  // > 0, not NaN
}

__device__ __forceinline__ uint32_t pos_bits(uint32_t two) {
  return (bf16_pos((uint16_t)(two & 0xFFFFu)) ? 1u : 0u) |
         (bf16_pos((uint16_t)(two >> 16)) ? 2u : 0u);
}

// leaf g = b * (C + 1) + m: tot0[b] for m = 0, else P[b, m - 1]
__device__ __forceinline__ const uint16_t* leaf(const uint16_t* P,
                                                const uint16_t* tot0,
                                                unsigned g, int C,
                                                size_t mat) {
  const unsigned b = g / (unsigned)(C + 1);
  const unsigned m = g - b * (unsigned)(C + 1);
  return m == 0 ? tot0 + b * mat : P + ((size_t)b * C + m - 1) * mat;
}

// MV % 32 == 0: a packed [MV, W] matrix is the matrix's entries as one
// flat bit string, so a warp packs a run of 256 contiguous entries (512
// bytes) into 8 words. Grid (leaf, block of runs within the leaf).
__global__ void __launch_bounds__(kThreads)
pack_flat_kernel(const uint16_t* __restrict__ P,
                 const uint16_t* __restrict__ tot0,
                 uint32_t* __restrict__ ws, int C, int MV) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const size_t mat = (size_t)MV * MV;
  const int runs = (int)(mat >> 8);
  const uint4* src = reinterpret_cast<const uint4*>(
      leaf(P, tot0, blockIdx.x, C, mat));
  uint32_t* dst = ws + (size_t)blockIdx.x * (mat >> 5);
  const int r0 = blockIdx.y * kWarps * kPackUnroll + (threadIdx.x >> 5);
  uint4 x[kPackUnroll];
#pragma unroll
  for (int u = 0; u < kPackUnroll; ++u) {
    const int r = r0 + u * kWarps;
    if (r < runs) x[u] = __ldg(src + (r << 5) + lane);
  }
#pragma unroll
  for (int u = 0; u < kPackUnroll; ++u) {
    const int r = r0 + u * kWarps;
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

// MV % 32 != 0 (only small MV): one thread per packed word, padding bits
// zero. Grid (leaf, block of words within the leaf).
__global__ void __launch_bounds__(kThreads)
pack_rows_kernel(const uint16_t* __restrict__ P,
                 const uint16_t* __restrict__ tot0,
                 uint32_t* __restrict__ ws, int C, int MV, int W) {
  const int n = MV * W;
  const int o = blockIdx.y * blockDim.x + threadIdx.x;
  if (o >= n) return;
  const int i = o / W;
  const int j = o - i * W;
  const uint16_t* row = leaf(P, tot0, blockIdx.x, C, (size_t)MV * MV) +
                        (size_t)i * MV + (j << 5);
  const int len = min(32, MV - (j << 5));
  uint32_t w = 0;
  for (int l = 0; l < len; ++l)
    if (bf16_pos(row[l])) w |= 1u << l;
  ws[(size_t)blockIdx.x * n + o] = w;
}

// Copies `count` words (a multiple of 4, 16-byte aligned at both ends)
// from global to shared memory, 16 bytes a thread.
__device__ __forceinline__ void load_words(uint32_t* dst,
                                           const uint32_t* __restrict__ src,
                                           int count) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  for (int q = threadIdx.x; q < (count >> 2); q += blockDim.x)
    d4[q] = __ldg(s4 + q);
}

// acc |= the VW words at p (16, 8 or 4 bytes, aligned)
template <int VW>
__device__ __forceinline__ void or_words(uint32_t (&acc)[VW],
                                         const uint32_t* p) {
  if constexpr (VW == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    acc[0] |= v.x; acc[1] |= v.y; acc[2] |= v.z; acc[3] |= v.w;
  } else if constexpr (VW == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    acc[0] |= v.x; acc[1] |= v.y;
  } else {
    acc[0] |= *p;
  }
}

// One level of the tree. CTA (b, j, blk) computes rows [blk * R,
// blk * R + R) of node j of key b: the product of src nodes first + m - 1
// (left) down to first (right), first = kFanIn * j; with m = 1 it carries
// the node up.
// Lane (jq, s) of a warp owns words [jq * VW, jq * VW + VW) of the row and
// bits [s * per, s * per + per) of the row it multiplies. kFinal writes
// bf16 to out, else packed words to dst.
template <bool kFinal, int VW>
__global__ void __launch_bounds__(kThreads)
tree_level_kernel(const uint32_t* __restrict__ src,
                  uint32_t* __restrict__ dst, uint16_t* __restrict__ out,
                  int n_in, int n_out, int MV, int R, int nblk,
                  int ks_log) {
  extern __shared__ uint4 smem4[];
  const int W = (MV + 31) >> 5;
  const int n = MV * W;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int blk = (int)(blockIdx.x % nblk);
  const unsigned node = blockIdx.x / nblk;  // b * n_out + j
  const unsigned b = node / n_out;
  const int j = (int)(node - b * n_out);
  const int first = kFanIn * j;
  const int m = min(kFanIn, n_in - first);
  const uint32_t* in_b = src + (size_t)b * n_in * n;
  // shared memory: right operands in the order they are applied, then one
  // row buffer per warp
  uint32_t* rights = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* row = rights + (size_t)(m - 1) * n + warp * W;
  for (int f = 0; f < m - 1; ++f)
    load_words(rights + (size_t)f * n, in_b + (size_t)(first + m - 2 - f) * n,
               n);
  __syncthreads();

  const int ks = 1 << ks_log;
  const int s = lane & (ks - 1);
  const int jq = lane >> ks_log;
  const int per = max(1, MV >> ks_log);
  const int k0 = s * per;
  const int k1 = min(MV, k0 + per);
  const uint32_t* lead = in_b + (size_t)(first + m - 1) * n;
  const int r_end = min(MV, blk * R + R);
  for (int i = blk * R + warp; i < r_end; i += kWarps) {
    for (int w = lane; w < W; w += 32) row[w] = __ldg(lead + i * W + w);
    __syncwarp();
    for (int f = 0; f < m - 1; ++f) {
      const uint32_t* rt = rights + (size_t)f * n + jq * VW;
      uint32_t acc[VW] = {};
      // per is a power of two: whole words from bit 0, or one aligned
      // piece of a word
      for (int k = k0; k < k1; k += 32) {
        uint32_t x = row[k >> 5] >> (k & 31);
        if (k1 - k < 32) x &= (1u << (k1 - k)) - 1;
        while (x) {
          const int kk = k + __ffs(x) - 1;
          x &= x - 1;
          or_words<VW>(acc, rt + kk * W);
        }
      }
#pragma unroll
      for (int v = 0; v < VW; ++v)
        for (int mm = 1; mm < ks; mm <<= 1)
          acc[v] |= __shfl_xor_sync(0xFFFFFFFFu, acc[v], mm);
      __syncwarp();  // every lane has read the row
      if (s == 0)
#pragma unroll
        for (int v = 0; v < VW; ++v) row[jq * VW + v] = acc[v];
      __syncwarp();
    }
    if (kFinal) {
      uint16_t* ob = out + ((size_t)b * MV + i) * MV;
      for (int c = lane * 8; c < MV; c += 256) {
        const uint32_t bits = row[c >> 5] >> (c & 31);
        uint32_t h[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          h[q] = ((bits >> (2 * q)) & 1u ? 0x3F80u : 0u) |
                 ((bits >> (2 * q + 1)) & 1u ? 0x3F800000u : 0u);
        *reinterpret_cast<uint4*>(ob + c) = make_uint4(h[0], h[1], h[2],
                                                       h[3]);
      }
    } else {
      uint32_t* d = dst + ((size_t)b * n_out + j) * n + (size_t)i * W;
      for (int w = lane; w < W; w += 32) d[w] = row[w];
    }
    __syncwarp();  // the row is written before the next one loads
  }
}

template <int VW>
cudaError_t launch_level(bool final, unsigned grid, size_t smem,
                         cudaStream_t st, const uint32_t* src,
                         uint32_t* dst, uint16_t* out, int n_in, int n_out,
                         int MV, int R, int nblk, int ks_log) {
  auto kernel = final ? tree_level_kernel<true, VW>
                      : tree_level_kernel<false, VW>;
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_smem((const void*)kernel, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, st>>>(src, dst, out, n_in, n_out, MV, R,
                                       nblk, ks_log);
  return cudaGetLastError();
}

}  // namespace

// MV is a power of two, 8 <= MV <= 512. ws holds at least
// (B * (C + 1) + B * ceil((C + 1) / 2)) * MV * W uint32 words,
// W = ceil(MV / 32): the packed leaves, then the second ping-pong buffer.
// Enqueues one pack launch and one launch per tree level on `stream` and
// returns the first non-zero cudaGetLastError().
extern "C" int jt_chunk_combine(void* P, void* tot0, void* out, void* ws,
                                int B, int C, int MV, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int W = (MV + 31) >> 5;
  const int n = MV * W;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;

  uint32_t* buf[2] = {(uint32_t*)ws,
                      (uint32_t*)ws + (size_t)B * (C + 1) * n};
  const uint16_t* Pp = (const uint16_t*)P;
  const uint16_t* tp = (const uint16_t*)tot0;
  const unsigned leaves = (unsigned)B * (C + 1);
  if ((MV & 31) == 0) {
    const int runs = MV * MV >> 8;
    const int per_block = kWarps * kPackUnroll;
    const dim3 grid(leaves, (runs + per_block - 1) / per_block);
    pack_flat_kernel<<<grid, kThreads, 0, st>>>(Pp, tp, buf[0], C, MV);
  } else {
    const dim3 grid(leaves, (n + kThreads - 1) / kThreads);
    pack_rows_kernel<<<grid, kThreads, 0, st>>>(Pp, tp, buf[0], C, MV, W);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // a lane ORs VW words at a time; the W / VW lane groups of a warp
  // split the row's bits ks = 32 / (W / VW) ways
  const int VW = W >= 4 ? 4 : W;
  int ks_log = 5;
  for (int q = W / VW; q > 1; q >>= 1) --ks_log;
  int n_in = C + 1, cur = 0;
  do {
    const int n_out = (n_in + kFanIn - 1) / kFanIn;
    // row blocks per node: the fewest (a power of two, at least 2) that
    // put kCtasPerSm CTAs per SM in flight, at most one row each
    int nblk = 2;
    while (nblk < MV &&
           (long long)B * n_out * nblk < (long long)kCtasPerSm * sms)
      nblk <<= 1;
    const int R = MV / nblk;
    const unsigned grid = (unsigned)((long long)B * n_out * nblk);
    const size_t smem = ((size_t)(min(kFanIn, n_in) - 1) * n + kWarps * W) *
                        sizeof(uint32_t);
    const bool final = n_out == 1;
    uint16_t* o = final ? (uint16_t*)out : nullptr;
    uint32_t* d = final ? nullptr : buf[cur ^ 1];
    if (VW == 4)
      err = launch_level<4>(final, grid, smem, st, buf[cur], d, o, n_in,
                            n_out, MV, R, nblk, ks_log);
    else if (VW == 2)
      err = launch_level<2>(final, grid, smem, st, buf[cur], d, o, n_in,
                            n_out, MV, R, nblk, ks_log);
    else
      err = launch_level<1>(final, grid, smem, st, buf[cur], d, o, n_in,
                            n_out, MV, R, nblk, ks_log);
    if (err != cudaSuccess) return (int)err;
    cur ^= 1;
    n_in = n_out;
  } while (n_in > 1);
  return 0;
}
