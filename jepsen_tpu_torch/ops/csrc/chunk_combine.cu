// Chunk-product combine for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel jepsen_tpu/ops/pallas_matrix.py
// `_build_combine` (pl.pallas_call at :824, body :805-818).
//
// What it computes, per key b: acc = tot0[b]; for c = 0 .. C-1:
// acc = (P[b, c] . acc > 0) — the time-ordered chain with later chunks on
// the left — and writes acc once as bf16 0/1 [B, MV, MV]. An entry counts
// as 1 when its bf16 value is > 0.
//
// What bounds it. B*C*2*MV^3 operations counted as dense products, issued
// serially per key (each product needs the previous one), against B*C*MV^2
// bf16 entries read once: at the headline (B = 1, C = 256, MV = 256) 8.6e9
// operations (about 4 us at the dense int8 tensor rate) and 32 MB (about
// 10 us at 3.35 TB/s). The real bound is the serial chain on one SM per
// key: with B = 1 one CTA does all the work.
//
// What the design does about it. One CTA per key keeps its accumulator
// resident in shared memory as bit-packed rows (32 columns per 32-bit
// word), packs each product's bf16 rows into words with 16-byte loads as
// it streams through (each product read from device memory once), and
// computes the boolean product row-word-parallel as
// acc'[i, j] = OR over the set bits k of row P[i] of acc[k, j]. This is
// the TPU kernel's semantics kept simple; a tree across CTAs and prefetch
// of chunk c+1 under chunk c are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ bool bf16_pos(uint16_t h) {
  return !(h & 0x8000u) && h != 0 && h <= 0x7F80u;  // > 0, not NaN
}

__device__ __forceinline__ uint32_t pos_bits(uint32_t two) {
  return (bf16_pos((uint16_t)(two & 0xFFFFu)) ? 1u : 0u) |
         (bf16_pos((uint16_t)(two >> 16)) ? 2u : 0u);
}

// dst[i, j] = bits of (src[i, 32j + l] > 0), l = 0 .. 31
__device__ __forceinline__ void pack(uint32_t* __restrict__ dst,
                                     const uint16_t* __restrict__ src,
                                     int MV, int n, int logW, int W) {
  for (int o = threadIdx.x; o < n; o += blockDim.x) {
    const int i = o >> logW;
    const int j = o & (W - 1);
    const uint16_t* row = src + (size_t)i * MV + (j << 5);
    uint32_t word = 0;
    if ((MV & 31) == 0) {
      const uint4* v = reinterpret_cast<const uint4*>(row);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 x = __ldg(v + q);
        const int base = q * 8;
        word |= pos_bits(x.x) << base;
        word |= pos_bits(x.y) << (base + 2);
        word |= pos_bits(x.z) << (base + 4);
        word |= pos_bits(x.w) << (base + 6);
      }
    } else {
      for (int l = 0; l < MV - (j << 5) && l < 32; ++l)
        if (bf16_pos(row[l])) word |= 1u << l;
    }
    dst[o] = word;
  }
}

__global__ void __launch_bounds__(kThreads)
chunk_combine_kernel(const uint16_t* __restrict__ P,    // [B, C, MV, MV]
                     const uint16_t* __restrict__ tot0, // [B, MV, MV]
                     uint16_t* __restrict__ out,        // [B, MV, MV]
                     int C, int MV, int logW) {
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x;
  const int W = 1 << logW;
  const int n = MV << logW;
  uint32_t* acc = smem;
  uint32_t* A = acc + n;
  uint32_t* Y = A + n;
  const size_t mat = (size_t)MV * MV;

  pack(acc, tot0 + b * mat, MV, n, logW, W);
  for (int c = 0; c < C; ++c) {
    pack(A, P + ((size_t)b * C + c) * mat, MV, n, logW, W);
    __syncthreads();
    for (int o = threadIdx.x; o < n; o += blockDim.x) {
      const int i = o >> logW;
      const int j = o & (W - 1);
      const uint32_t* a = A + (i << logW);
      uint32_t r = 0;
      for (int wi = 0; wi < W; ++wi) {
        uint32_t x = a[wi];
        while (x) {
          const int k = (wi << 5) + __ffs(x) - 1;
          x &= x - 1;
          r |= acc[(k << logW) + j];
        }
      }
      Y[o] = r;
    }
    __syncthreads();  // A and acc are free; Y holds the new accumulator
    uint32_t* tmp = acc; acc = Y; Y = tmp;
  }
  __syncthreads();

  uint16_t* o_b = out + b * mat;
  for (size_t e = threadIdx.x; e < mat; e += blockDim.x) {
    const int i = (int)(e / MV);
    const int col = (int)(e - (size_t)i * MV);
    const uint32_t bit = (acc[(i << logW) + (col >> 5)] >> (col & 31)) & 1u;
    o_b[e] = bit ? (uint16_t)0x3F80 : (uint16_t)0;
  }
}

}  // namespace

extern "C" int jt_chunk_combine(void* P, void* tot0, void* out, int B,
                                int C, int MV, void* stream) {
  int W = (MV + 31) >> 5, logW = 0;
  while ((1 << logW) < W) ++logW;
  const size_t smem = (size_t)3 * (MV << logW) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  chunk_combine_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint16_t*)P, (const uint16_t*)tot0, (uint16_t*)out, C, MV,
      logW);
  return (int)cudaGetLastError();
}
