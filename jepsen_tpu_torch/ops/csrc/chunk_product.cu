// Transfer-matrix chunk product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel jepsen_tpu/ops/pallas_matrix.py `_build`
// (pl.pallas_call at :464; bodies kernel_resident :381-396 and kernel_hbm
// :398-439, per-return step make_step :343-379) in all of its variants
// (f32 / int8 / packed) and L-build modes (none / vmem / hbm): they are
// representations of one bit-identical function, and this kernel is its
// single Hopper counterpart.
//
// What it computes, per chunk g, starting from P = I, for each valid
// return t of the chunk (MV = 2^S * V, row/col index (a, w) = a * V + w
// with a a mask of linearized pending slots and w a model state):
//   L[(a,w),(b,v)] = OR_s pend[t,s] & (b == a ^ 2^s, bit s of a set)
//                         & mtT[ids[t,s]][w][v]
//   Bm = (I + L) ^ (2^k)   boolean squarings while npend > 2^k
//   A[(a,w)] = bit s of a clear ? Bm[(a | 2^s, w)] : 0   (s = slot[t])
//   P = A . P              boolean product
// and writes P once as bf16 0/1 [G, MV, MV] (the Pallas output layout).
//
// What bounds it. Counted as dense products (telemetry.matrix_modeled_flops)
// the work is G*T*(ceil(log2 S)+2)*2*MV^3 operations. At the headline plan
// (G = 256 chunks of T = 32 returns, S = 5, MV = 256) that is 1.37e12,
// 0.69 ms at the card's dense int8 tensor rate (1,979 TOP/s); counting
// only the valid returns (8,070) with the squarings their pending counts
// need and one compose product each (the kill is a gather), 7.2e11 and
// 0.36 ms. The bytes are small: the id grids in and 32 MB of bf16
// products out, about 10 us at 3.35 TB/s. So it is bound by operations,
// and every intermediate must stay on chip.
//
// What the design does about it. One CTA per chunk loops over its T
// returns (the TPU's sequential grid axis). P, Bm and a scratch matrix
// stay resident in dynamic shared memory as bit-packed rows (32 columns
// per 32-bit word: 8 KB per matrix at MV = 256, 32 KB at MV = 512), so no
// intermediate touches device memory. L is built directly from the index
// structure (no Rexp/Kexp/U1/U2 tables). The kill is a row gather fused
// into the compose product. A boolean product C = A . B is computed row-
// word-parallel as C[i, j] = OR over the set bits k of row A[i] of B[k, j],
// so its cost follows the density of A rather than MV^3; squarings the
// pending count cannot use are skipped, and padding steps are skipped
// outright. This is the simple, correct first form: it runs on the CUDA
// cores, not the tensor cores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// C[i, j] = OR_{k in row i of A} B[k, j] over bit-packed [MV, W] matrices.
__device__ __forceinline__ void bool_mm(uint32_t* __restrict__ C,
                                        const uint32_t* __restrict__ A,
                                        const uint32_t* __restrict__ B,
                                        int n, int logW, int W) {
  for (int o = threadIdx.x; o < n; o += blockDim.x) {
    const int i = o >> logW;
    const int j = o & (W - 1);
    const uint32_t* a = A + (i << logW);
    uint32_t acc = 0;
    for (int wi = 0; wi < W; ++wi) {
      uint32_t x = a[wi];
      while (x) {
        const int k = (wi << 5) + __ffs(x) - 1;
        x &= x - 1;
        acc |= B[(k << logW) + j];
      }
    }
    C[o] = acc;
  }
}

// C = Kill_s(X) . P: row (a, w) of the left operand is X's row
// (a | 2^s, w) when bit s of a is clear, else zero.
__device__ __forceinline__ void kill_mm(uint32_t* __restrict__ C,
                                        const uint32_t* __restrict__ X,
                                        const uint32_t* __restrict__ P,
                                        int n, int logW, int W, int logV,
                                        int s) {
  for (int o = threadIdx.x; o < n; o += blockDim.x) {
    const int i = o >> logW;
    const int j = o & (W - 1);
    const int a = i >> logV;
    uint32_t acc = 0;
    if (!((a >> s) & 1)) {
      const uint32_t* r = X + ((i + (1 << (s + logV))) << logW);
      for (int wi = 0; wi < W; ++wi) {
        uint32_t x = r[wi];
        while (x) {
          const int k = (wi << 5) + __ffs(x) - 1;
          x &= x - 1;
          acc |= P[(k << logW) + j];
        }
      }
    }
    C[o] = acc;
  }
}

__device__ __forceinline__ uint32_t eye_word(int i, int j) {
  return (i >> 5) == j ? (1u << (i & 31)) : 0u;
}

__global__ void __launch_bounds__(kThreads)
chunk_product_kernel(const int* __restrict__ pmask,    // [T, G]
                     const int* __restrict__ sv,       // [T, G], -1 = pad
                     const int* __restrict__ ids,      // [T, G, S]
                     const uint32_t* __restrict__ mtbits,  // [U, V]
                     uint16_t* __restrict__ out,       // [G, MV, MV] bf16
                     int T, int G, int S, int logV) {
  extern __shared__ uint32_t smem[];
  const int g = blockIdx.x;
  const int V = 1 << logV;
  const int MV = V << S;
  const int W = (MV + 31) >> 5;
  int logW = 0;
  while ((1 << logW) < W) ++logW;
  const int n = MV << logW;
  uint32_t* P = smem;
  uint32_t* X = P + n;
  uint32_t* Y = X + n;
  uint32_t* mt = Y + n;  // [S, V]: this step's transition rows per slot

  int n_sq = 0;
  while ((1 << n_sq) < S) ++n_sq;

  for (int o = threadIdx.x; o < n; o += blockDim.x)
    P[o] = eye_word(o >> logW, o & (W - 1));

  for (int t = 0; t < T; ++t) {
    const int slot = sv[t * G + g];
    if (slot < 0) continue;  // padding return: identity
    const int pm = pmask[t * G + g];
    __syncthreads();  // the previous step is done with X, Y and mt
    for (int k = threadIdx.x; k < S * V; k += blockDim.x) {
      const int s = k >> logV;
      mt[k] = ((pm >> s) & 1)
                  ? mtbits[ids[(t * G + g) * S + s] * V + (k & (V - 1))]
                  : 0u;
    }
    __syncthreads();
    // X = I + L, built from the index structure
    for (int o = threadIdx.x; o < n; o += blockDim.x) {
      const int i = o >> logW;
      const int j = o & (W - 1);
      const int a = i >> logV;
      const int w = i & (V - 1);
      uint32_t word = eye_word(i, j);
      int m = pm & a;  // pending slots whose bit is set in a
      while (m) {
        const int s = __ffs(m) - 1;
        m &= m - 1;
        const int col0 = (a ^ (1 << s)) << logV;
        if ((col0 >> 5) == j) word |= mt[(s << logV) + w] << (col0 & 31);
      }
      X[o] = word;
    }
    // closure: (I + L)^(2^q) reaches every path once 2^q >= npend
    const int npend = __popc(pm);
    for (int q = 0; q < n_sq; ++q) {
      if (npend > (1 << q)) {
        __syncthreads();
        bool_mm(Y, X, X, n, logW, W);
        uint32_t* tmp = X; X = Y; Y = tmp;
      }
    }
    __syncthreads();
    kill_mm(Y, X, P, n, logW, W, logV, slot);
    uint32_t* tmp = P; P = Y; Y = tmp;
  }
  __syncthreads();

  uint16_t* o_g = out + (size_t)g * MV * MV;
  for (int e = threadIdx.x; e < MV * MV; e += blockDim.x) {
    const int i = e / MV;
    const int c = e - i * MV;
    const uint32_t bit = (P[(i << logW) + (c >> 5)] >> (c & 31)) & 1u;
    o_g[e] = bit ? (uint16_t)0x3F80 : (uint16_t)0;
  }
}

}  // namespace

extern "C" int jt_chunk_product(void* pmask, void* sv, void* ids,
                                void* mtbits, void* out, int T, int G,
                                int S, int V, void* stream) {
  int logV = 0;
  while ((1 << logV) < V) ++logV;
  const int MV = V << S;
  int W = (MV + 31) >> 5, logW = 0;
  while ((1 << logW) < W) ++logW;
  const size_t smem =
      (size_t)(3 * (MV << logW) + S * V) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_product_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  chunk_product_kernel<<<G, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)pmask, (const int*)sv, (const int*)ids,
      (const uint32_t*)mtbits, (uint16_t*)out, T, G, S, logV);
  return (int)cudaGetLastError();
}
