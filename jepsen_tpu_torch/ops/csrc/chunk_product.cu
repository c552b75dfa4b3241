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
// with a a mask of linearized pending slots and w a model state; pm the
// pending mask, s = slot[t] the returning slot):
//   L[(a,w),(b,v)] = OR_s pm_s & (b == a ^ 2^s, bit s of a set)
//                         & mtT[ids[t,s]][w][v]
//   X = (I + L)* . P
//   P[(a,w)] = bit s of a clear ? X[(a | 2^s, w)] : 0
// and writes P once as bf16 0/1 [G, MV, MV] (the Pallas output layout).
// _build computes the same P as Kill_s((I + L)^(2^q)) . P.
//
// Why it runs no matrix products. L only moves mask a to a ^ 2^s for a
// pending slot s whose bit is set in a: each step clears one pending
// bit. So L is triangular in the level popcount(a & pm), and X = P + L.X
// is computed row by row in level order, in place:
//   X(a,w) = P(a,w) | OR_{s in pm & a} OR_{v in mt_s[w]} X(a ^ 2^s, v)
// where rows of level p read only rows of level p - 1, already final, and
// rows of level 0 keep P. A path from (a, w) takes at most
// popcount(a & pm) <= npend steps, and _build's squarings reach an
// exponent 2^q >= npend (it skips only those npend cannot use), so both
// reach the full closure; boolean products are exact, so the two agree
// bit for bit. The kill is a row selection: row a of the new P is row
// a | 2^s of X. No squaring and no compose product is left, and nothing
// dense for a tensor core: the kernel issues no wgmma or mma, only 32-bit
// ORs of shared-memory words.
//
// What bounds it. The least work is the bf16 write-out, 33.5 MB at the
// headline plan (G = 256 chunks, MV = 256): 10.0 us at 3.35 TB/s; then the
// shared-memory words the level and kill passes must read, (1 + sources)
// words per rewritten row and column word plus one per kill pair, about
// 4 us there at 32 words a clock per SM. What bounds it in practice is
// the chain of each chunk: npend level passes and a kill per return, each
// pass ordered after the last, 32 returns in series, with only about two
// chunks an SM.
//
// Design. The closure and the kill never mix columns, so a warp owns
// kWordsPerWarp 32-column words of its chunk's P and runs the chunk's T
// returns on them alone (the TPU's sequential grid axis): its passes are
// ordered by __syncwarp, and no CTA barrier sits in the step loop. A CTA
// takes kWords words of one chunk: all of them at every MV the wrapper
// takes, with warps left idle in the step loop (they stage and write).
// P is the only matrix, bit-packed in dynamic shared memory and updated
// in place, laid out [column word][V][M] (M = 2^S masks; a pad staggers
// a warp's words across banks), so that lanes on different masks touch
// different banks. The operands of kStage returns at a time are staged
// in shared memory by the whole CTA, so the step loop reads no device
// memory: the returning slot, the pending mask, the pending slots' V-bit
// transition rows mt_s[w], per slot the mask of its non-empty rows and
// the first of them (one, most often: a read or CAS moves one state, a
// write all states to one), and the masks in level order (level
// popcount(a & pm), so each level is one contiguous run). Per valid return, level p = 1 .. npend:
// the lanes take the (mask, word) items of level p in turn, so lanes are
// not spent on masks of other levels; a lane holds the word of its V rows
// in registers (V is a template parameter), loads the V rows of each
// source block a ^ 2^s together and ORs them in through mt_s. Then the
// kill: one lane moves block a | 2^s onto block a and zeroes it, so no
// source is read after it was zeroed. Padding returns are skipped. The
// write-out stores 8 bf16 a thread with one 16-byte store, neighbouring
// threads on neighbouring addresses of a row.
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kWordsPerWarp = 2;  // column words a warp owns
constexpr int kWords = kWarps * kWordsPerWarp;  // column words a CTA
// returns whose operands are staged in shared memory at once
constexpr int kStage = 32;
constexpr int kMaxSlots = 8;
// binomials C(n, k) for n, k <= kMaxSlots, 0 when k > n
constexpr int kBinomN = kMaxSlots + 1;
constexpr uint32_t kOne = 0x3F80u;  // bf16 1.0

__device__ __forceinline__ uint32_t bf16_pair(uint32_t two_bits) {
  return ((two_bits & 1u) ? kOne : 0u) | ((two_bits & 2u) ? kOne << 16 : 0u);
}

// Position of mask a when the masks are ordered by level popcount(a & pm),
// then by the colex rank of a's pending bits, then by its other bits: the
// masks of level p are then contiguous, C(npend, p) * 2^(S - npend) of
// them after those of the lower levels.
__device__ __forceinline__ int level_order_pos(int a, int pm, int S,
                                               const int* binom) {
  int l = 0, np = 0, nf = 0, xr = 0, y = 0;
  for (int b = 0; b < S; ++b) {
    const int bit = (a >> b) & 1;
    if ((pm >> b) & 1) {
      if (bit) xr += binom[np * kBinomN + ++l];
      ++np;
    } else {
      y |= bit << nf++;
    }
  }
  int off = 0;
  for (int q = 0; q < l; ++q) off += binom[np * kBinomN + q];
  return ((off + xr) << nf) | y;
}

// acc[w] |= OR_{v in mt_s[w]} x[v] over the rows w in `rows` (not empty);
// r is the first such row's word, the others are read from mt_s.
template <int LOGV>
__device__ __forceinline__ void fold_source(uint32_t (&acc)[1 << LOGV],
                                            const uint32_t (&x)[1 << LOGV],
                                            uint32_t rows, uint32_t r,
                                            const uint32_t* mt_s) {
  constexpr int V = 1 << LOGV;
  for (;;) {
    const int w = __ffs((int)rows) - 1;
    rows &= rows - 1;
    uint32_t t = 0u;
#pragma unroll
    for (int v = 0; v < V; ++v)
      if ((r >> v) & 1u) t |= x[v];
#pragma unroll
    for (int q = 0; q < V; ++q)
      if (q == w) acc[q] |= t;
    if (rows == 0u) return;
    r = mt_s[__ffs((int)rows) - 1];
  }
}

// One level pass on a warp's column words (word jj of mask a, row v at
// Pw[jj * ws + v * M + a]) over the masks ord[0 .. count) of level p:
// X(a, w) |= OR_{s in pm & a} OR_{v in mt_s[w]} X(a ^ 2^s, v). The lanes
// take the (mask, word) items of the level in turn, so every lane has
// work while there is work. Blocks of level p read only blocks of p - 1.
template <int LOGV>
__device__ __forceinline__ void level_pass(uint32_t* Pw, int ws, int M,
                                           int logJ, const uint8_t* ord,
                                           int count, const uint32_t* mt,
                                           const uint32_t* nz,
                                           const uint32_t* r1, int pm) {
  constexpr int V = 1 << LOGV;
  for (int it = threadIdx.x & 31; it < (count << logJ); it += 32) {
    const int a = ord[it >> logJ];
    uint32_t* Pj = Pw + (it & ((1 << logJ) - 1)) * ws;
    uint32_t acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = Pj[v * M + a];
    int m = a & pm;
    while (m) {
      const int s = __ffs(m) - 1;
      m &= m - 1;
      const uint32_t rows = nz[s];
      if (rows == 0u) continue;
      const int b = a ^ (1 << s);
      uint32_t x[V];
#pragma unroll
      for (int v = 0; v < V; ++v) x[v] = Pj[v * M + b];
      fold_source<LOGV>(acc, x, rows, r1[s], mt + (s << LOGV));
    }
#pragma unroll
    for (int v = 0; v < V; ++v) Pj[v * M + a] = acc[v];
  }
}

// The kill on a warp's column words, in place by block pairs: block lo <-
// block hi = lo | 2^slot, block hi <- 0; one lane owns both blocks.
template <int LOGV>
__device__ __forceinline__ void kill_pass(uint32_t* Pw, int ws, int M,
                                          int logJ, int slot) {
  constexpr int V = 1 << LOGV;
  for (int it = threadIdx.x & 31; it < ((M >> 1) << logJ); it += 32) {
    const int r = it >> logJ;
    uint32_t* Pj = Pw + (it & ((1 << logJ) - 1)) * ws;
    const int lo = ((r >> slot) << (slot + 1)) | (r & ((1 << slot) - 1));
    const int hi = lo | (1 << slot);
    uint32_t x[V];
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = Pj[v * M + hi];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      Pj[v * M + lo] = x[v];
      Pj[v * M + hi] = 0u;
    }
  }
}

template <int LOGV>
__global__ void __launch_bounds__(kThreads)
chunk_product_kernel(const int* __restrict__ pmask,    // [T, G]
                     const int* __restrict__ sv,       // [T, G], -1 = pad
                     const int* __restrict__ ids,      // [T, G, S]
                     const uint32_t* __restrict__ mtbits,  // [U, V]
                     uint16_t* __restrict__ out,       // [G, MV, MV] bf16
                     int T, int G, int S) {
  constexpr int V = 1 << LOGV;
  extern __shared__ uint32_t smem[];
  const int g = blockIdx.x;
  const int M = 1 << S;
  const int SV = S << LOGV;
  const int logMV = S + LOGV;
  const int MV = 1 << logMV;
  const int W = MV > 32 ? MV >> 5 : 1;
  const int warp = threadIdx.x >> 5;
  const int j0 = blockIdx.y * kWords;           // this CTA's first word
  const int cols = min(kWords, W - j0);         // and its number of words
  // this warp's words: jw .. jw + 2^logJ - 1 (none when logJ < 0)
  const int jw = warp * kWordsPerWarp;
  const int nw = min(kWordsPerWarp, cols - jw);
  const int logJ = nw > 0 ? __ffs(nw) - 1 : -1;
  // column word c of the CTA: row a * V + v at smem[c * ws + v * M + a];
  // the pad staggers the words of a warp across banks
  const int ws = (M << LOGV) + 32 / kWordsPerWarp;
  uint32_t* Pw = smem + jw * ws;
  uint32_t* st_mt = smem + min(kWords, W) * ws; // [kStage, S, V]
  uint32_t* st_nz = st_mt + kStage * SV;        // [kStage, kMaxSlots]
  uint32_t* st_r1 = st_nz + kStage * kMaxSlots; // [kStage, kMaxSlots]
  int* st_pm = (int*)(st_r1 + kStage * kMaxSlots);  // [kStage]
  int* st_slot = st_pm + kStage;                // [kStage]
  int* binom = st_slot + kStage;                // [kBinomN, kBinomN]
  uint8_t* st_ord = (uint8_t*)(binom + kBinomN * kBinomN);  // [kStage, M]

  // P = I: row i = a * V + v has its one in column i
  for (int e = threadIdx.x; e < cols * (M << LOGV); e += kThreads) {
    const int c = e >> (S + LOGV);
    const int r = e & ((M << LOGV) - 1);
    const int i = ((r & (M - 1)) << LOGV) + (r >> S);
    smem[c * ws + r] = (i >> 5) == j0 + c ? 1u << (i & 31) : 0u;
  }
  for (int q = threadIdx.x; q < kBinomN * kBinomN; q += kThreads) {
    const int nn = q / kBinomN, kk = q % kBinomN;
    int r = 1;
    for (int i = 0; i < kk; ++i) r = r * (nn - i) / (i + 1);  // 0 if kk > nn
    binom[q] = r;
  }

  for (int t0 = 0; t0 < T; t0 += kStage) {
    const int nt = min(kStage, T - t0);
    __syncthreads();  // every step of the last stage is done with st_*
    for (int k = threadIdx.x; k < nt * SV; k += kThreads) {
      const int tk = k / SV;
      const int r = k - tk * SV;
      const int s = r >> LOGV;
      const int e = (t0 + tk) * G + g;
      // ids are read for pending slots of valid returns only
      st_mt[k] = (sv[e] >= 0 && ((pmask[e] >> s) & 1))
                     ? mtbits[ids[e * S + s] * V + (r & (V - 1))]
                     : 0u;
    }
    for (int q = threadIdx.x; q < nt * kMaxSlots; q += kThreads) {
      const int e = (t0 + q / kMaxSlots) * G + g;
      const int s = q % kMaxSlots;
      uint32_t rows = 0u, r1 = 0u;
      if (s < S && sv[e] >= 0 && ((pmask[e] >> s) & 1)) {
        const uint32_t* r = mtbits + ids[e * S + s] * V;
        for (int w = V - 1; w >= 0; --w) {
          if (r[w] != 0u) {
            rows |= 1u << w;
            r1 = r[w];
          }
        }
      }
      st_nz[q] = rows;
      st_r1[q] = r1;
    }
    for (int k = threadIdx.x; k < nt; k += kThreads) {
      st_pm[k] = pmask[(t0 + k) * G + g];
      st_slot[k] = sv[(t0 + k) * G + g];
    }
    for (int q = threadIdx.x; q < (nt << S); q += kThreads) {
      const int pm = pmask[(t0 + (q >> S)) * G + g];
      st_ord[((q >> S) << S) + level_order_pos(q & (M - 1), pm, S, binom)] =
          (uint8_t)(q & (M - 1));
    }
    __syncthreads();

    if (logJ >= 0) {
      for (int k = 0; k < nt; ++k) {
        const int slot = st_slot[k];
        if (slot < 0) continue;  // padding return: identity
        const int pm = st_pm[k];
        const int npend = __popc(pm);
        const int nf = S - npend;
        // closure, level by level: blocks of level p read blocks of p - 1
        int first = 1 << nf;  // the level-0 blocks come first and keep P
        for (int p = 1; p <= npend; ++p) {
          const int count = binom[npend * kBinomN + p] << nf;
          level_pass<LOGV>(Pw, ws, M, logJ, st_ord + (k << S) + first, count,
                           st_mt + k * SV, st_nz + k * kMaxSlots,
                           st_r1 + k * kMaxSlots, pm);
          first += count;
          __syncwarp();
        }
        kill_pass<LOGV>(Pw, ws, M, logJ, slot);
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // write-out of the CTA's column words, 8 bf16 a 16-byte store (the
  // wrapper takes MV >= 8, so a row holds at least one store)
  uint16_t* o_g = out + (size_t)g * MV * MV + j0 * 32;
  const int per_row = (cols * min(MV, 32)) >> 3;  // stores a row
  for (int e = threadIdx.x; e < MV * per_row; e += kThreads) {
    const int i = e / per_row;
    const int c = (e - i * per_row) << 3;       // column within the CTA
    const uint32_t b =
        (smem[(c >> 5) * ws + (i & (V - 1)) * M + (i >> LOGV)] >>
         (c & 31)) & 0xFFu;
    *reinterpret_cast<uint4*>(o_g + (size_t)i * MV + c) =
        make_uint4(bf16_pair(b), bf16_pair(b >> 2), bf16_pair(b >> 4),
                   bf16_pair(b >> 6));
  }
}

template <int LOGV>
int launch(const void* pmask, const void* sv, const void* ids,
           const void* mtbits, void* out, int T, int G, int S,
           cudaStream_t stream) {
  const int logMV = S + LOGV;
  const int W = logMV > 5 ? 1 << (logMV - 5) : 1;
  const size_t smem =
      ((size_t)min(kWords, W) * ((1 << logMV) + 32 / kWordsPerWarp) +
       (size_t)kStage * (S << LOGV) + 2 * (size_t)kStage * kMaxSlots +
       2 * kStage + kBinomN * kBinomN) *
          sizeof(uint32_t) +
      ((size_t)kStage << S);
  const cudaError_t err =
      allow_smem((const void*)chunk_product_kernel<LOGV>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(G, (W + kWords - 1) / kWords);
  chunk_product_kernel<LOGV><<<grid, kThreads, smem, stream>>>(
      (const int*)pmask, (const int*)sv, (const int*)ids,
      (const uint32_t*)mtbits, (uint16_t*)out, T, G, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int jt_chunk_product(void* pmask, void* sv, void* ids,
                                void* mtbits, void* out, int T, int G,
                                int S, int V, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (V) {
    case 1: return launch<0>(pmask, sv, ids, mtbits, out, T, G, S, st);
    case 2: return launch<1>(pmask, sv, ids, mtbits, out, T, G, S, st);
    case 4: return launch<2>(pmask, sv, ids, mtbits, out, T, G, S, st);
    case 8: return launch<3>(pmask, sv, ids, mtbits, out, T, G, S, st);
    case 16: return launch<4>(pmask, sv, ids, mtbits, out, T, G, S, st);
    case 32: return launch<5>(pmask, sv, ids, mtbits, out, T, G, S, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
