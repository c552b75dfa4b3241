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
// step alone; the multi-register step runs its kMaxKeys digits unrolled,
// each guarded by k < nk (uniform over the launch), with no branch on the
// data. Division and remainder
// floor and sums wrap, as torch's and jnp's int32 arithmetic does, so the
// step equals the plain version's on any int32 input.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kCas = 0, kMultiRegister = 1;
constexpr int kMaxKeys = 16;

struct Model {
  int code;
  int nk, nv;         // multi-register: keys and values
  int pw[kMaxKeys];   // (nv + 1)^k, computed once a launch on the host
};

// The launch's model for (code, nk, nv), or false when the kernels do not
// take it: an unknown code, or a multi-register shape whose actions
// overflow int32 ((2 nv + 2)^nk >= 2^31, as multi_register_spec raises).
inline bool make_model(int code, int nk, int nv, Model* m) {
  m->code = code;
  m->nk = nk;
  m->nv = nv;
  for (int k = 0; k < kMaxKeys; ++k) m->pw[k] = 0;
  if (code == kCas) return true;
  if (code != kMultiRegister || nk < 1 || nk > kMaxKeys || nv < 1)
    return false;
  long long ab = 1, p = 1;
  for (int k = 0; k < nk; ++k) {
    ab *= 2LL * nv + 2;
    if (ab >= (1LL << 31)) return false;
    m->pw[k] = (int)p;
    p *= nv + 1;
  }
  return true;
}

__device__ __forceinline__ int floor_div(int x, int m) {
  const int q = x / m;
  return q - (x - q * m < 0 ? 1 : 0);
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
// (jepsen_tpu/models/__init__.py:466-481): key k's action is digit k of a,
// its value digit k of the state as the earlier keys left it
__device__ __forceinline__ int multi_register_step(const Model& m, int state,
                                                   int a, bool* ok) {
  const int sb = m.nv + 1, ab = 2 * m.nv + 2;
  int acts = a, next = state;
  bool good = true;
#pragma unroll
  for (int k = 0; k < kMaxKeys; ++k) {
    if (k < m.nk) {
      const int q = floor_div(acts, ab);
      const int act = acts - q * ab;
      acts = q;
      const int hi = floor_div(next, m.pw[k]);
      const int digit = hi - floor_div(hi, sb) * sb;
      const bool is_rv = act >= 2 && act < 2 + m.nv;
      const bool is_w = act >= 2 + m.nv;
      good = good && (!is_rv || digit == act - 1);
      // wraps as int32 tensors do (unsigned: no overflow in C++)
      next = (int)((unsigned)next +
                   (unsigned)((is_w ? act - (1 + m.nv) : digit) - digit) *
                       (unsigned)m.pw[k]);
    }
  }
  *ok = good;
  return next;
}

// The transition of model kModel of state under the op (f, a, b); *ok
// whether it applies.
template <int kModel>
__device__ __forceinline__ int model_step(const Model& m, int state, int f,
                                          int a, int b, bool* ok) {
  if constexpr (kModel == kMultiRegister)
    return multi_register_step(m, state, a, ok);
  else
    return cas_step(state, f, a, b, ok);
}

}  // namespace
