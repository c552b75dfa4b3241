// The model transitions the frontier scans compute (frontier_dense.cu,
// frontier_sparse.cu): a launch takes one, named by the code, keys and
// values of its step's `kernel_model` (jepsen_tpu_torch/models).
//
// - kCas: the CAS register (`_cas_step_ids`). State and op arguments are
//   interned value ids; f is read, write or cas.
// - kMultiRegister: the multi-register map over nk keys of nv values
//   (`multi_register_spec`, jepsen_tpu/models/__init__.py:451-483). The
//   state is nk base-(nv + 1) digits, digit 0 for None; the op packs one
//   base-(2 nv + 2) action a key into a: 0 none, 1 read None (always
//   legal), 2 + v read v (legal iff the key's digit is v + 1), 2 + nv + v
//   write v (the key's digit becomes v + 1). f and b are unused.
//
// The kernels are templated on the code (kModel), so a launch runs the
// one step its model names and the CAS instantiation compiles to the CAS
// step alone. The multi-register step walks the launch's nk keys and
// stops there (the loop is unrolled to kMaxKeys so that it reads the
// launch's constants by constant index, and leaves at k = nk, uniform
// over the launch); it decodes an op's actions once for all the states
// it steps at a time. Every
// division is by a constant of the launch (the action base, the state
// base and the digit powers) and is a multiply-high by a reciprocal that
// make_model computes on the host, exact on every int32: floor division
// of x < 0 is ~(~x / d). Sums wrap, as torch's and jnp's int32 arithmetic
// does, so the step equals the plain version's on any int32 state and
// op. This header also builds
// without CUDA (g++, with __device__ and __forceinline__ defined away),
// as the CPU tests build it.
#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kCas = 0, kMultiRegister = 1;
constexpr int kMaxKeys = 16;

// floor division by a constant d >= 1: with l = ceil(log2 d) and mul =
// ceil(2^(31 + l) / d) < 2^32, u / d = umulhi(2u, mul) >> l for every
// 0 <= u < 2^31 (mul d - 2^(31 + l) < d <= 2^l, so the error stays
// below 1 / d)
struct Recip {
  unsigned mul;
  int l;
};

struct Model {
  int code;
  int nk, nv;    // multi-register: keys and values
  int span;      // (nv + 1)^nk: the map's states, which a step keeps there
  int sb, ab;    // the state's digit base nv + 1, the action's 2 nv + 2
  Recip sb_r, ab_r;
  int pw[kMaxKeys];  // (nv + 1)^k
  Recip pw_r[kMaxKeys];
};

inline Recip make_recip(long long d) {
  int l = 0;
  while ((1LL << l) < d) ++l;
  return {(unsigned)(((1ULL << (31 + l)) + (unsigned long long)d - 1) /
                     (unsigned long long)d),
          l};
}

// The launch's model for (code, nk, nv), or false when the kernels do not
// take it: an unknown code, or a multi-register shape whose actions
// overflow int32 ((2 nv + 2)^nk >= 2^31, as multi_register_spec raises).
inline bool make_model(int code, int nk, int nv, Model* m) {
  *m = Model{};
  m->code = code;
  m->nk = nk;
  m->nv = nv;
  if (code == kCas) return true;
  if (code != kMultiRegister || nk < 1 || nk > kMaxKeys || nv < 1)
    return false;
  long long ab = 1, p = 1;
  for (int k = 0; k < nk; ++k) {
    ab *= 2LL * nv + 2;
    if (ab >= (1LL << 31)) return false;
    m->pw[k] = (int)p;
    m->pw_r[k] = make_recip(p);
    p *= nv + 1;
  }
  m->span = (int)p;  // (nv + 1)^nk < (2 nv + 2)^nk < 2^31
  m->sb = nv + 1;
  m->ab = 2 * nv + 2;
  m->sb_r = make_recip(m->sb);
  m->ab_r = make_recip(m->ab);
  return true;
}

__device__ __forceinline__ unsigned umulhi(unsigned a, unsigned b) {
#ifdef __CUDA_ARCH__
  return __umulhi(a, b);
#else
  return (unsigned)(((unsigned long long)a * b) >> 32);
#endif
}

// floor(x / d) for the d of r, any int32 x
__device__ __forceinline__ int floor_div(int x, Recip r) {
  const int sg = x >> 31;  // 0, or -1 for x < 0: then ~x = x ^ sg >= 0
  const unsigned u = (unsigned)(x ^ sg);
  return (int)(umulhi(u << 1, r.mul) >> r.l) ^ sg;
}

// copied from jepsen_tpu_torch/models/__init__.py _cas_step_ids: read v ok
// iff v == state or v == 0 (None); write v -> v; cas (a, b) ok iff
// state == a, -> b; any other f never applies
__device__ __forceinline__ int cas_step(int state, int f, int a, int b,
                                        bool* ok) {
  const bool is_read = f == 0, is_write = f == 1, is_cas = f == 2;
  const bool k = (is_read && (a == 0 || a == state)) || is_write ||
                 (is_cas && state == a);
  *ok = k;
  return is_write ? a : ((is_cas && k) ? b : state);
}

// copied from jepsen_tpu_torch/models/__init__.py _MultiRegisterStep
// (jepsen_tpu/models/__init__.py:466-481), for kN states under one op:
// key k's action is digit k of a, decoded once for all kN states, and
// each state's digit k is read as the earlier keys left it. The kN
// states' chains are independent, so they interleave. No branch skips
// the keys an op leaves alone: on the sparse scan's passes, whose
// threads step different ops, the branch cost more than it saved
// (measured on the card; PERF.md).
template <int kN>
__device__ __forceinline__ void multi_register_steps(const Model& m,
                                                     const int* state, int a,
                                                     int* next, bool* ok) {
  int acts = a;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    next[i] = state[i];
    ok[i] = true;
  }
#pragma unroll
  for (int k = 0; k < kMaxKeys; ++k) {
    if (k == m.nk) break;
    const int q = floor_div(acts, m.ab_r);
    const int act = acts - q * m.ab;
    acts = q;
    const bool is_w = act >= 2 + m.nv;
    // the digit a read needs, or a write leaves
    const int want = is_w ? act - (1 + m.nv) : act - 1;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      // digit 0's power is 1
      const int hi = k == 0 ? next[i] : floor_div(next[i], m.pw_r[k]);
      const int digit = hi - floor_div(hi, m.sb_r) * m.sb;
      // act 0 (none) and 1 (read None) neither need nor change a digit
      ok[i] = ok[i] && (is_w || act < 2 || digit == want);
      // wraps as int32 tensors do (unsigned: no overflow in C++)
      next[i] = (int)((unsigned)next[i] +
                      (unsigned)((is_w ? want : digit) - digit) *
                          (unsigned)m.pw[k]);
    }
  }
}

// The transitions of model kModel of kN states under the op (f, a, b);
// ok[i] whether it applies to state[i].
template <int kModel, int kN>
__device__ __forceinline__ void model_steps(const Model& m, const int* state,
                                            int f, int a, int b, int* next,
                                            bool* ok) {
  if constexpr (kModel == kMultiRegister) {
    multi_register_steps<kN>(m, state, a, next, ok);
  } else {
#pragma unroll
    for (int i = 0; i < kN; ++i)
      next[i] = cas_step(state[i], f, a, b, &ok[i]);
  }
}

// One state's transition: model_steps of one.
template <int kModel>
__device__ __forceinline__ int model_step(const Model& m, int state, int f,
                                          int a, int b, bool* ok) {
  int next;
  model_steps<kModel, 1>(m, &state, f, a, b, &next, ok);
  return next;
}

// The first state whose transitions can leave [0, V) (the dense table's
// out-of-range flag need not step the states below it): a multi-register
// step keeps every state of the map [0, span) in the map, so when the map
// fits in the table only the states past it, the table's padding, can
// leave; the CAS step may send any state anywhere.
template <int kModel>
__device__ __forceinline__ int first_leaving_state(const Model& m, int V) {
  if constexpr (kModel == kMultiRegister)
    return m.span <= V ? m.span : 0;
  else
    return 0;
}

}  // namespace
