// Set-full classify (BASELINE config 4) for Hopper (sm_90a).
//
// Replaces jepsen_tpu/ops/setscan.py:69 _build_classify, with the bit
// unpack that classify_elements runs on the device before it (:131-141):
// each element's verdict (stable, lost, never-read), whether a read saw
// it stale, and its visibility latency, from masked min/max reductions
// over the reads x elements membership matrix.
//
// Bound: bytes. The function reads the packed matrix (4 R W bytes), the
// read times (8 R) and the element columns (8 + 8 + 1 bytes an element)
// once and writes 13 bytes an element; it does a compare and a select a
// cell and no products.
//
// Design: one thread an element. A 256-thread CTA takes 8 consecutive
// words of a row: warp w takes word 8 blockIdx.x + w and lane j its bit
// j, element 32 (8 blockIdx.x + w) + j, so a warp reads one word a row
// as a broadcast and each lane tests its bit where it lies (the matrix
// is never unpacked). Two passes over the R rows: the first finds
// first_seen, the smallest read time with the bit set, and runs only
// when some lane of the warp has no add-ok (known = ok_t otherwise); the
// second takes the reductions over the rows read at or after known.
// Times are float64, with +-inf as the empty min and max; the rows need
// not be sorted by time.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerCta = 8;
constexpr int kThreads = 32 * kWarpsPerCta;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStable = 0, kLost = 1, kNeverRead = 2;

__global__ void __launch_bounds__(kThreads)
set_classify_kernel(const uint32_t* __restrict__ words,
                    const double* __restrict__ t_read,
                    const double* __restrict__ invoke_t,
                    const double* __restrict__ ok_t,
                    const uint8_t* __restrict__ has_ok,
                    int32_t* __restrict__ code, uint8_t* __restrict__ stale,
                    double* __restrict__ latency, int R, int W, int E) {
  const int lane = threadIdx.x & 31;
  const long long w =
      (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (w >= W) return;  // the whole warp: one word
  const long long e = w * 32 + lane;
  const bool live = e < E;
  const uint32_t bit = 1u << lane;
  const uint32_t* col = words + w;
  const bool hok = live && has_ok[e] != 0;
  double known = hok ? ok_t[e] : INFINITY;

  // pass 1: first_seen, needed only for the lanes with no add-ok
  if (__any_sync(kFull, live && !hok)) {
    double first = INFINITY;
#pragma unroll 8
    for (int r = 0; r < R; ++r) {
      const uint32_t word = __ldg(col + (size_t)r * W);
      const double t = __ldg(t_read + r);
      if (word & bit) first = fmin(first, t);
    }
    if (!hok) known = first;
  }

  // pass 2: over the rows read at or after known, whether there is one,
  // and the last time the element was present (lp) and absent (la)
  bool any_later = false;
  double lp = -INFINITY, la = -INFINITY;
#pragma unroll 8
  for (int r = 0; r < R; ++r) {
    const uint32_t word = __ldg(col + (size_t)r * W);
    const double t = __ldg(t_read + r);
    if (t >= known) {
      any_later = true;
      if (word & bit) {
        lp = fmax(lp, t);
      } else {
        la = fmax(la, t);
      }
    }
  }
  if (!live) return;

  const bool never_known = known >= INFINITY;
  const bool has_present = lp > -INFINITY;
  const bool has_absent = la > -INFINITY;
  const bool lost = has_absent && (!has_present || la > lp);
  const bool never_read = never_known || !any_later;
  const int c = never_read ? kNeverRead : (lost ? kLost : kStable);
  code[e] = c;
  // absent after known but present again later
  stale[e] = (c == kStable && has_absent) ? 1 : 0;
  const double d = (has_absent ? la : known) - invoke_t[e];
  latency[e] = d > 0.0 ? d : 0.0;
}

}  // namespace

// words uint32 [R, W] (bit j of word w: element 32 w + j), t_read f64
// [R], invoke_t and ok_t f64 [E], has_ok uint8 [E] -> code int32 [E],
// stale uint8 [E], latency f64 [E]. W = ceil(E / 32). Enqueues one
// launch on `stream`; returns its cudaGetLastError().
extern "C" int jt_set_classify(const void* words, const void* t_read,
                               const void* invoke_t, const void* ok_t,
                               const void* has_ok, void* code, void* stale,
                               void* latency, int R, int W, int E,
                               void* stream) {
  if (E <= 0 || W <= 0) return 0;
  const int blocks = (W + kWarpsPerCta - 1) / kWarpsPerCta;
  set_classify_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const double*)t_read,
      (const double*)invoke_t, (const double*)ok_t, (const uint8_t*)has_ok,
      (int32_t*)code, (uint8_t*)stale, (double*)latency, R, W, E);
  return (int)cudaGetLastError();
}
