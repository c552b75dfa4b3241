"""The multi-register transition of the frontier kernels
(``jepsen_tpu_torch/ops/csrc/frontier_model.cuh``) on the CPU: a numpy
replay of its arithmetic (each division a multiply-high by a reciprocal
that ``make_model`` computes, floor division of a negative x as
~(~x / d)) against the JAX package's ``multi_register_spec(nk,
nv).step_ids`` on seeded int32 states and ops, negative and out-of-map
ones included; the header itself built with ``g++`` and run on the same
inputs; and the header's out-of-range flag over the states from
``first_leaving_state`` on (none of a map that fits in the table; every
state of the table when the map does not) against
the flag of the JAX package's ``_build_dense_step``, which also steps a
table's padding past the map (the port repairs that, ROADMAP Queue 3
item 4). States, verdicts and flags are integers: tolerance zero."""
from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

HEADER = (Path(__file__).resolve().parents[1] / "jepsen_tpu_torch" / "ops"
          / "csrc" / "frontier_model.cuh")
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
# the largest nv make_model takes at nk = 1: (2 nv + 2) < 2^31
NV_MAX = (1 << 30) - 2
SHAPES = [(3, 5), (2, 3), (1, 300), (15, 1), (1, NV_MAX)]
# shapes whose actions overflow int32: make_model and the spec refuse them
REFUSED = [(16, 1), (1, NV_MAX + 1), (17, 1)]


def _recip(d: int) -> tuple[int, int]:
    """make_recip: (mul, l), l = ceil(log2 d), mul = ceil(2^(31 + l) / d)."""
    l = (d - 1).bit_length()
    mul = -(-(1 << (31 + l)) // d)
    assert mul < 1 << 32
    return mul, l


def _model(nk: int, nv: int):
    """make_model's multi-register constants, or None where it refuses."""
    if not (1 <= nk <= 16 and nv >= 1) or (2 * nv + 2) ** nk >= 1 << 31:
        return None
    sb, ab = nv + 1, 2 * nv + 2
    pw = [sb ** k for k in range(nk)]
    return {"nk": nk, "nv": nv, "sb": sb, "ab": ab, "span": sb ** nk,
            "sb_r": _recip(sb), "ab_r": _recip(ab), "pw": pw,
            "pw_r": [_recip(p) for p in pw]}


def _i32(x):
    """int64 array -> the int32 it wraps to, as int64."""
    return ((np.asarray(x, np.int64) + (1 << 31)) % (1 << 32)) - (1 << 31)


def _floor_div(x, r):
    """floor_div: x int32 values in int64; umulhi(2u, mul) >> l, u = x ^
    sign."""
    mul, l = r
    sg = np.where(x < 0, -1, 0)
    u = np.where(x < 0, ~x, x)                      # 0 <= u < 2^31
    # 2u * mul < 2^64: exact in uint64
    q = ((2 * u).astype(np.uint64) * np.uint64(mul)) >> np.uint64(32 + l)
    q = q.astype(np.int64)
    return np.where(sg < 0, ~q, q)


def _replay_step(m, state, a):
    """multi_register_steps of the header in numpy: (next state, ok).
    Each key's action is decoded once and applied to every state; an
    action 0 or 1 leaves the state and the verdict alone."""
    acts, nxt = np.broadcast_arrays(np.asarray(a, np.int64),
                                    np.asarray(state, np.int64))
    good = np.ones(nxt.shape, bool)
    nv = m["nv"]
    for k in range(m["nk"]):
        q = _floor_div(acts, m["ab_r"])
        act = acts - q * m["ab"]
        acts = q
        hi = nxt if k == 0 else _floor_div(nxt, m["pw_r"][k])
        digit = hi - _floor_div(hi, m["sb_r"]) * m["sb"]
        is_rv = (act >= 2) & (act < 2 + nv)
        is_w = act >= 2 + nv
        good &= ~is_rv | (digit == act - 1)
        nxt = _i32(nxt + (np.where(is_w, act - (1 + nv), digit) - digit)
                   * m["pw"][k])
    return nxt, good


def _inputs(m, seed: int, n: int = 4000):
    """Seeded (state, a) int32 pairs: states in the map, past it, negative
    and at the int32 ends; ops as the encoding packs them and any int32."""
    rng = np.random.default_rng(seed)
    span, nk, ab = m["span"], m["nk"], m["ab"]
    states = np.concatenate([
        rng.integers(0, span, n // 4),
        rng.integers(span, I32_MAX, n // 4, endpoint=True),
        rng.integers(I32_MIN, 0, n // 4),
        rng.integers(I32_MIN, I32_MAX, n // 4 - 8, endpoint=True),
        [0, span - 1, span, -1, I32_MIN, I32_MAX, I32_MIN + 1, I32_MAX - 1],
    ]).astype(np.int64)
    digits = rng.integers(0, ab, (n // 2, nk))
    packed = (digits * np.array([ab ** k for k in range(nk)])).sum(1)
    ops = np.concatenate([
        packed, rng.integers(I32_MIN, I32_MAX, n - n // 2 - 4,
                             endpoint=True),
        [0, -1, I32_MIN, I32_MAX]]).astype(np.int64)
    return states, rng.permutation(ops)


def _jax_step(nk, nv, state, a):
    import jax.numpy as jnp
    from jepsen_tpu.models import multi_register_spec
    st, ok = multi_register_spec(nk, nv).step_ids(
        jnp.asarray(state, jnp.int32), jnp.zeros(len(a), jnp.int32),
        jnp.asarray(a, jnp.int32), jnp.zeros(len(a), jnp.int32))
    return np.asarray(st, np.int64), np.asarray(ok)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 6, 7, 12, 36, 216, 1 << 20,
                               (1 << 30) - 1, 1 << 30, (1 << 31) - 1])
def test_reciprocal_floor_division_is_exact(d):
    """floor_div by make_recip's reciprocal equals // on int32 values,
    the ends and the multiples of d included."""
    rng = np.random.default_rng(d % 1000)
    x = np.concatenate([
        rng.integers(I32_MIN, I32_MAX, 20000, endpoint=True),
        [I32_MIN, I32_MIN + 1, -1, 0, 1, I32_MAX - 1, I32_MAX],
        np.clip(np.arange(-3, 4) * d + np.array([-1, 0, 1])[:, None],
                I32_MIN, I32_MAX).ravel()]).astype(np.int64)
    assert np.array_equal(_floor_div(x, _recip(d)), x // d)


@pytest.mark.parametrize("shape", SHAPES + REFUSED, ids=str)
def test_replayed_step_matches_jax_spec(shape):
    """The header's step, replayed, equals multi_register_spec's step_ids
    (next state and legality) on every input; a shape whose actions
    overflow int32 is refused by both."""
    from jepsen_tpu.models import multi_register_spec
    m = _model(*shape)
    if shape in REFUSED:
        assert m is None
        with pytest.raises(ValueError):
            multi_register_spec(*shape)
        return
    states, ops = _inputs(m, seed=sum(shape) % 997)
    want = _jax_step(*shape, states, ops)
    got = _replay_step(m, states, ops)
    assert np.array_equal(got[1], want[1])
    assert np.array_equal(got[0], want[0])


STEPPER_CPP = r"""
#include <cstdio>
#include "frontier_model.cuh"
// step NK NV N, then N (state, a) pairs: each pair's next state and ok;
// flag NK NV V N, then N ops a: first_leaving_state, then each op's
// out-of-range flag as frontier_dense.cu computes it (the states from
// first_leaving_state to V whose transition applies and leaves [0, V))
int main() {
  char mode[8];
  int nk, nv, V = 0, n;
  if (std::scanf("%7s %d %d", mode, &nk, &nv) != 3) return 2;
  const bool flag = mode[0] == 'f';
  if (flag && std::scanf("%d", &V) != 1) return 2;
  if (std::scanf("%d", &n) != 1) return 2;
  Model m;
  if (!make_model(kMultiRegister, nk, nv, &m)) {
    std::printf("refused\n");
    return 0;
  }
  const int first = first_leaving_state<kMultiRegister>(m, V);
  if (flag) std::printf("%d\n", first);
  for (int i = 0; i < n; ++i) {
    int s = 0, a;
    if (!flag && std::scanf("%d", &s) != 1) return 2;
    if (std::scanf("%d", &a) != 1) return 2;
    bool ok;
    if (!flag) {
      const int t = model_step<kMultiRegister>(m, s, 0, a, 0, &ok);
      std::printf("%d %d\n", t, ok ? 1 : 0);
      continue;
    }
    bool oob = false;
    for (int v = first; v < V && !oob; ++v) {
      const int t = model_step<kMultiRegister>(m, v, 0, a, 0, &ok);
      oob = ok && (t < 0 || t >= V);
    }
    std::printf("%d\n", oob ? 1 : 0);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def header_stepper(tmp_path_factory):
    """The header built by g++ (CUDA's qualifiers defined away) into a
    program that steps the pairs it reads."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    d = tmp_path_factory.mktemp("frontier_model")
    (d / "stepper.cpp").write_text(STEPPER_CPP)
    exe = d / "stepper"
    subprocess.run(["g++", "-std=c++17", "-O2", "-D__device__=",
                    "-D__forceinline__=inline", "-I", str(HEADER.parent),
                    "-o", str(exe), str(d / "stepper.cpp")], check=True,
                   capture_output=True, text=True)
    return exe


def _run_stepper(exe, shape, states, ops):
    text = f"step {shape[0]} {shape[1]} {len(states)}\n" + "".join(
        f"{s} {a}\n" for s, a in zip(states.tolist(), ops.tolist()))
    out = subprocess.run([str(exe)], input=text, capture_output=True,
                         text=True, check=True).stdout.split()
    if out == ["refused"]:
        return None
    got = np.asarray(out, np.int64).reshape(-1, 2)
    return got[:, 0], got[:, 1].astype(bool)


@pytest.mark.parametrize("shape", SHAPES + REFUSED, ids=str)
def test_header_step_matches_python_twin(header_stepper, shape):
    """model_step<kMultiRegister> of the header, built by g++, equals
    multi_register_step_py on the map's states (legality, and the state
    where the step applies) and the JAX spec's step on every int32 input;
    the header refuses the shapes the spec refuses."""
    from jepsen_tpu_torch.checker.linear_cpu import multi_register_step_py
    m = _model(*shape)
    if m is None:
        dummy = np.zeros(1, np.int64)
        assert _run_stepper(header_stepper, shape, dummy, dummy) is None
        return
    states, ops = _inputs(m, seed=sum(shape) % 991 + 1, n=2000)
    got_s, got_ok = _run_stepper(header_stepper, shape, states, ops)
    want_s, want_ok = _jax_step(*shape, states, ops)
    assert np.array_equal(got_ok, want_ok)
    assert np.array_equal(got_s, want_s)
    step = multi_register_step_py(*shape)
    in_map = np.nonzero((states >= 0) & (states < m["span"]))[0]
    assert len(in_map) > 100
    for i in in_map.tolist():
        s, ok = step(int(states[i]), 0, int(ops[i]), 0)
        assert bool(got_ok[i]) is ok
        if ok:
            assert int(got_s[i]) == s


def _header_flags(exe, shape, V: int, ops):
    """The header's first_leaving_state at V, and each op's out-of-range
    flag over the states from it to V, as frontier_dense.cu computes
    them."""
    text = f"flag {shape[0]} {shape[1]} {V} {len(ops)}\n" + "".join(
        f"{a}\n" for a in ops.tolist())
    out = subprocess.run([str(exe)], input=text, capture_output=True,
                         text=True, check=True).stdout.split()
    return int(out[0]), [x == "1" for x in out[1:]]


@pytest.mark.parametrize("shape,V", [((3, 5), 256), ((2, 3), 16),
                                     ((3, 5), 128)], ids=str)
def test_padding_only_out_of_range_flag_matches_jax(header_stepper, shape,
                                                    V):
    """The header's flag over the model's states (from
    first_leaving_state, V when the map fits in V, else 0, to V) equals a numpy replay over the states
    [0, min(span, V)), op by op, on ops as the encoding packs them and on
    any int32. Where every state of the table is the model's (span >= V)
    it equals the flag of jitlin._build_dense_step; at (3, 5) in a
    256-wide table the JAX package's flag also steps the padding past the
    216 states, which no history reaches, and the port's does not (ROADMAP
    Queue 3 item 4): the port's stays clear where the reference's is
    set."""
    import jax
    import jax.numpy as jnp
    from jepsen_tpu.models import multi_register_spec
    from jepsen_tpu.ops.jitlin import _build_dense_step
    m = _model(*shape)
    run = jax.jit(_build_dense_step(1, V, multi_register_spec(*shape)
                                    .step_ids, 0))
    _, ops = _inputs(m, seed=V + shape[0], n=96)
    want = []
    for a in ops:
        ev = [jnp.asarray([x], jnp.int32) for x in (0, 0, 0, int(a), 0)]
        want.append(bool(run(*ev)[2]))
    first, got = _header_flags(header_stepper, shape, V, ops)
    assert first == (V if m["span"] <= V else 0)
    states = np.arange(min(m["span"], V))
    real = []
    for a in ops:
        nxt, ok = _replay_step(m, states, np.full(len(states), a))
        real.append(bool((ok & ((nxt < 0) | (nxt >= V))).any()))
    assert got == real
    if m["span"] >= V:
        assert got == want
    else:
        # the reference's flag takes both values here (writes that push a
        # padding state past 255, reads that no padding state passes);
        # the port's is clear: a step keeps the map's states in the map
        assert 0 < sum(want) < len(want)
        assert not any(got)
