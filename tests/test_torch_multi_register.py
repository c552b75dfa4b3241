"""The multi-register (multi-key-acid) slice of jepsen_tpu_torch against
jepsen_tpu on the CPU: the packed encode, the frontier scans' plain
versions with the multi-register transition against the JAX builders,
the checker on every rung (``torch-frontier`` dense and sparse,
``torch-matrix`` at (2, 3), the exact twin) against the JAX package's
``jitlin-tpu`` rung and its CPU searches, the independent checker on a
multi-key-acid history, and the five repairs that letting another model
in required. Verdicts, events, frontiers and states are integers or
flags: tolerance zero.

The ``cuda``-marked tests hold each frontier kernel with the
multi-register transition against its plain version on the card (dense
CTA path at 216 states, dense warp path at (2, 3), sparse at S = 10-12,
the batched entries at B = 8) and the checker on the card against its
``accelerator="cpu"`` run; they skip without a card."""
from __future__ import annotations

import gc

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.histories import (
    corrupt_txn_keys, corrupt_txn_reads, multi_key_acid_history,
    multi_register_history,
)

OPTS = {"explain": False}
REF_OPTS = {"explain": False, "checker_sharded": False}
SENT_MASK, SENT_STATE = 0xFFFFFFFF, 0x7FFFFFFF


def _port_checker(**kw):
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.models import MultiRegister
    return linearizable(MultiRegister(), **kw)


def _ref_checker(**kw):
    from jepsen_tpu.checker.linearizable import linearizable
    from jepsen_tpu.models import MultiRegister
    return linearizable(MultiRegister(), **kw)


def _events(stream):
    return [np.asarray(x, np.int32) for x in
            (stream.kind, stream.slot, stream.f, stream.a, stream.b)]


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

ENCODE_CASES = {
    "valid": lambda: multi_register_history(80, 5, seed=1),
    "crashed": lambda: multi_register_history(80, 5, seed=2, crash_every=5),
    "readers": lambda: multi_register_history(60, 10, seed=3, n_readers=5),
    "shape_2x3": lambda: multi_register_history(60, 4, n_keys=2, n_values=3,
                                                seed=4),
}


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_encode_matches_reference(case):
    from jepsen_tpu.checker.linear_encode import (
        encode_multi_register_ops as ref_encode)
    from jepsen_tpu_torch.checker.linear_encode import (
        encode_multi_register_ops)

    h = ENCODE_CASES[case]()
    shape = (2, 3) if case == "shape_2x3" else (3, 5)
    got, ref = encode_multi_register_ops(h, *shape), ref_encode(h, *shape)
    for col in ("kind", "slot", "f", "a", "b", "op_index"):
        x, y = getattr(got, col), getattr(ref, col)
        assert x.dtype == y.dtype and np.array_equal(x, y), col
    assert (got.n_slots, got.n_ops, len(got.intern)) == (
        ref.n_slots, ref.n_ops, len(ref.intern))


@pytest.mark.parametrize("value", [
    [["r", 0, 1], ["w", 0, 2]],          # a key twice
    [["w", 1, 5]],                       # a value past V
    [["r", 2, -1]],                      # a value below 0
    [["w", 3, 1]],                       # a key past K
    [["w", "k", 1]],                     # a key that is not an int
    [["x", 0, 1]],                       # an unknown micro-op
])
def test_encode_raises_where_reference_raises(value):
    from jepsen_tpu.checker.linear_encode import (
        encode_multi_register_ops as ref_encode)
    from jepsen_tpu_torch.checker.linear_encode import (
        encode_multi_register_ops)

    h = [{"type": "invoke", "process": 0, "f": "txn", "value": value},
         {"type": "ok", "process": 0, "f": "txn", "value": value}]
    with pytest.raises(ValueError):
        ref_encode(h)
    with pytest.raises(ValueError):
        encode_multi_register_ops(h)
    h2 = [dict(op, f="read") for op in h]
    with pytest.raises(ValueError):
        encode_multi_register_ops(h2)


def test_outside_the_encoding_takes_wgl():
    """A history the packed encoding cannot hold runs the object-model
    search, in both packages."""
    h = [{"type": "invoke", "process": 0, "f": "txn",
          "value": [["w", 0, 7], ["r", 0, None]]},
         {"type": "ok", "process": 0, "f": "txn",
          "value": [["w", 0, 7], ["r", 0, 7]]}]
    ref = _ref_checker(accelerator="tpu").check({}, h, OPTS)
    got = _port_checker(accelerator="gpu", device="cpu").check({}, h, OPTS)
    assert got["valid?"] is ref["valid?"] is True
    assert got["algorithm"] == ref["algorithm"] == "wgl-cpu"


# ---------------------------------------------------------------------------
# the frontier scans' plain versions with the multi-register transition
# ---------------------------------------------------------------------------

def _jax_dense(ev, table0, shape):
    import jax
    from jepsen_tpu.models import multi_register_spec
    from jepsen_tpu.ops.jitlin import _build_dense_step
    M, V = table0.shape
    run = _build_dense_step(M.bit_length() - 1, V,
                            multi_register_spec(*shape).step_ids, 0)
    out = jax.jit(run.resume)(*ev, table0)
    return [np.asarray(x) for x in out]


def _jax_sparse(ev, mask0, state0, S, shape):
    import jax
    from jepsen_tpu.models import multi_register_spec
    from jepsen_tpu.ops.jitlin import _build_step
    run = _build_step(S, len(mask0), multi_register_spec(*shape).step_ids,
                      0)
    out = jax.jit(run.resume)(*ev, mask0, state0)
    return [np.asarray(x) for x in out]


def _port_dense(ev, table0, shape):
    from jepsen_tpu_torch.models import multi_register_spec
    from jepsen_tpu_torch.ops.frontier_kernels import frontier_dense
    out = frontier_dense(*(torch.from_numpy(x) for x in ev),
                         torch.from_numpy(table0),
                         step_ids=multi_register_spec(*shape).step_ids)
    return [x.numpy() for x in out]


def _port_sparse(ev, mask0, state0, S, shape):
    from jepsen_tpu_torch.convert import frontier_from_numpy
    from jepsen_tpu_torch.models import multi_register_spec
    from jepsen_tpu_torch.ops.frontier_kernels import frontier_sparse
    m0, s0 = frontier_from_numpy(mask0, state0, device="cpu")
    out = frontier_sparse(*(torch.from_numpy(x) for x in ev), m0, s0, S,
                          step_ids=multi_register_spec(*shape).step_ids)
    return [x.to(torch.int64).numpy() for x in out]


def _same(got, ref):
    for x, y in zip(got, ref):
        assert np.array_equal(np.asarray(x, np.int64),
                              np.asarray(y, np.int64))


def _init_frontier(K, states=(0,)):
    mask = np.full(K, SENT_MASK, np.uint32)
    state = np.full(K, SENT_STATE, np.int32)
    mask[:len(states)] = 0
    state[:len(states)] = states
    return mask, state


DENSE_CASES = {
    # (history, shape, table S or None for the stream's)
    "valid_3x5": (lambda: multi_register_history(50, 4, seed=11), (3, 5)),
    "invalid_3x5": (lambda: corrupt_txn_reads(
        multi_register_history(50, 4, seed=12), 1, seed=0), (3, 5)),
    "crashed_3x5": (lambda: multi_register_history(
        40, 3, seed=13, crash_every=4), (3, 5)),
    "valid_2x3": (lambda: multi_register_history(
        60, 4, n_keys=2, n_values=3, seed=14), (2, 3)),
    "invalid_2x3": (lambda: corrupt_txn_reads(multi_register_history(
        60, 4, n_keys=2, n_values=3, seed=15), 1, seed=1, n_values=3),
        (2, 3)),
}


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_plain_matches_jax(case):
    from jepsen_tpu_torch.checker.linear_encode import (
        encode_multi_register_ops)
    from jepsen_tpu_torch.ops.jitlin import _bucket
    make, shape = DENSE_CASES[case]
    st = encode_multi_register_ops(make(), *shape)
    S, V = max(1, st.n_slots), _bucket(len(st.intern), floor=16)
    table0 = np.zeros((1 << S, V), bool)
    table0[0, 0] = True
    ev = _events(st)
    got = _port_dense(ev, table0, shape)
    want = _jax_dense(ev, table0, shape)
    # at 216 states the table is bucketed to 256: the reference flags a
    # write from a state past 215, which no history reaches, as out of
    # range; the port flags the map's states alone (ROADMAP Queue 3 item
    # 4), so its flag is clear there. At (2, 3) the 16 states fill the
    # table and both flags are clear
    assert bool(want[2]) is (shape == (3, 5))
    assert bool(got[2]) is False
    _same(got[:2] + got[3:], want[:2] + want[3:])


SPARSE_CASES = {
    "valid_s10": lambda: multi_register_history(36, 5, seed=21,
                                                crash_every=4),
    "invalid_s10": lambda: corrupt_txn_reads(multi_register_history(
        36, 5, seed=22, crash_every=4), 1, seed=2),
    "valid_s5": lambda: multi_register_history(60, 5, seed=23),
}


@pytest.mark.parametrize("K", [256, 16])
@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_sparse_plain_matches_jax(case, K):
    from jepsen_tpu_torch.checker.linear_encode import (
        encode_multi_register_ops)
    st = encode_multi_register_ops(SPARSE_CASES[case]())
    S = max(1, st.n_slots)
    ev = _events(st)
    m0, s0 = _init_frontier(K)
    _same(_port_sparse(ev, m0, s0, S, (3, 5)),
          _jax_sparse(ev, m0, s0, S, (3, 5)))


def _unsorted_pass_case():
    """A list of (mask 0, state 5) and (0, 6) at (2, 5) (state base 6),
    then a pending "write key 1 := 2" and a no-op txn returning twice:
    the write sends 5 to 23 and 6 to 18, so a pass's expansions of one
    mask group come out in the other order (the first pass from the
    given list, the later ones from the sorted list)."""
    a_write = (2 + 5 + 2) * 12      # key 1's action digit: write 2
    kind = np.asarray([0, 0, 1, 0, 1], np.int32)
    slot = np.asarray([0, 1, 1, 1, 1], np.int32)
    a = np.asarray([a_write, 0, 0, 0, 0], np.int32)
    zero = np.zeros(5, np.int32)
    return [kind, slot, zero, a, zero], 2


def test_sparse_pass_with_unsorted_expansions_matches_jax():
    from jepsen_tpu_torch.models import multi_register_spec
    ev, S = _unsorted_pass_case()
    step = multi_register_spec(2, 5).step_ids
    st, ok = step(torch.tensor([5, 6]), 0, ev[3][0], 0)
    assert st.tolist() == [23, 18] and ok.all()
    m0, s0 = _init_frontier(8, states=(5, 6))
    got = _port_sparse(ev, m0, s0, S, (2, 5))
    _same(got, _jax_sparse(ev, m0, s0, S, (2, 5)))
    assert bool(got[0])


def test_kernels_take_the_model_their_step_names():
    """The wrappers hand the kernels the step's (model, keys, values);
    a step the kernels have no copy of is refused before any launch."""
    from jepsen_tpu_torch.models import cas_register_spec, multi_register_spec
    from jepsen_tpu_torch.ops.frontier_kernels import _model_args

    assert _model_args(None, "x") == (0, 0, 0)
    assert _model_args(cas_register_spec(2).step_ids, "x") == (0, 0, 0)
    assert _model_args(multi_register_spec(3, 5).step_ids, "x") == (1, 3, 5)
    with pytest.raises(ValueError, match="no copy"):
        _model_args(lambda *x: x, "frontier_dense")


# ---------------------------------------------------------------------------
# the checker
# ---------------------------------------------------------------------------

CHECK_CASES = {
    "dense_valid": lambda: multi_register_history(60, 5, seed=1),
    "dense_invalid": lambda: corrupt_txn_reads(
        multi_register_history(60, 5, seed=2), 1, seed=0),
    "dense_s9": lambda: multi_register_history(40, 5, seed=3, crash_every=4),
    "sparse_invalid": lambda: corrupt_txn_reads(multi_register_history(
        50, 5, seed=4, crash_every=5), 1, seed=1),
    "sparse_valid": lambda: multi_register_history(50, 5, seed=4,
                                                   crash_every=5),
}
# the rung each case settles on, in the port (the reference's name: the
# port's "torch-frontier" is its "jitlin-tpu")
CHECK_RUNGS = {
    "dense_valid": "torch-frontier",
    # the dense table is bucketed past the map's 216 states, and a write
    # from a state past them leaves [0, 256): the reference's inexact flag
    # makes the dead table "unknown", so its exact twin settles it; the
    # port flags the map's states alone (ROADMAP Queue 3 item 4) and
    # settles it on the table
    "dense_invalid": "torch-frontier",
    "dense_s9": "torch-frontier",
    "sparse_invalid": "torch-frontier",
    # the K = 256 list overflows and dies: the twin settles it
    "sparse_valid": "jitlin-cpu(fallback)",
}


# where the reference's rung differs from the port's renamed one
REF_RUNGS = {"dense_invalid": "jitlin-cpu(fallback)"}


@pytest.mark.parametrize("case", sorted(CHECK_CASES))
def test_checker_matches_reference_on_every_rung(case):
    """The port's device path (plain versions on the CPU) and its CPU
    twin against the JAX package's ``jitlin-tpu`` rung (its XLA frontier
    on the JAX CPU backend): verdict, failing op, context, final
    configurations and ``configs-max``; the port's ``wgl``: verdict (its
    depth-first search reports another failing op)."""
    from jepsen_tpu_torch.checker.linear_encode import (
        encode_multi_register_ops)
    from jepsen_tpu_torch.ops.jitlin import JitLinKernel

    h = CHECK_CASES[case]()
    st = encode_multi_register_ops(h)
    route = JitLinKernel().route(st.n_slots, len(st.intern))
    assert route == ("dense" if case.startswith("dense") else "sparse")
    assert (st.n_slots <= 9) is (route == "dense")
    ref = _ref_checker(accelerator="tpu").check({}, h, OPTS)
    got = _port_checker(accelerator="gpu", device="cpu").check({}, h, OPTS)
    cpu = _port_checker(accelerator="cpu").check({}, h, OPTS)
    wgl = _port_checker(algorithm="wgl").check({}, h, OPTS)
    assert got["algorithm"] == CHECK_RUNGS[case]
    assert ref["algorithm"] == REF_RUNGS.get(case, CHECK_RUNGS[case].replace(
        "torch-frontier", "jitlin-tpu"))
    assert cpu["algorithm"] == "jitlin-cpu"
    assert wgl["algorithm"] == "wgl-cpu"
    assert got["valid?"] is ref["valid?"] is cpu["valid?"] is wgl["valid?"]
    assert got["valid?"] is not case.endswith("invalid")
    assert got["configs-max"] == ref["configs-max"]
    for key in ("failed-op", "context", "final-configs"):
        assert got.get(key) == ref.get(key) == cpu.get(key), key


def test_shape_2x3_takes_the_matrix_rung():
    """At (2, 3) the map has 16 states, within the matrix rung: a history
    of at least 2,000 returns settles on ``torch-matrix`` there, and its
    corrupted copy on the frontier's dense table (warp-path shape)."""
    from jepsen_tpu_torch.checker.linear_encode import (
        encode_multi_register_ops)

    h = multi_register_history(2100, 3, n_keys=2, n_values=3, seed=31)
    st = encode_multi_register_ops(h, 2, 3)
    assert int((st.kind == 1).sum()) >= 2000 and len(st.intern) == 16
    ref = _ref_checker(accelerator="cpu", multi_shape=(2, 3)).check(
        {}, h, OPTS)
    got = _port_checker(accelerator="gpu", device="cpu",
                        multi_shape=(2, 3)).check({}, h, OPTS)
    assert (got["valid?"], got["algorithm"]) == (True, "torch-matrix")
    assert ref["valid?"] is True
    bad = corrupt_txn_reads(h, 1, seed=3, n_values=3)
    ref = _ref_checker(accelerator="cpu", multi_shape=(2, 3)).check(
        {}, bad, OPTS)
    got = _port_checker(accelerator="gpu", device="cpu",
                        multi_shape=(2, 3)).check({}, bad, OPTS)
    assert (got["valid?"], got["algorithm"]) == (False, "torch-frontier")
    assert got["failed-op"] == ref["failed-op"]
    assert got["final-configs"] == ref["final-configs"]


# ---------------------------------------------------------------------------
# the repairs on entry
# ---------------------------------------------------------------------------

def test_native_rung_is_cas_only():
    """The native rung searches the CAS register: a multi-register
    stream, whose ops encode as f = 0 (a CAS read of the packed action),
    skips it; the CAS search would call this valid history invalid."""
    from jepsen_tpu_torch.checker.linear_encode import (
        encode_multi_register_ops)
    from jepsen_tpu_torch.native import check_stream_native

    h = multi_register_history(40, 3, seed=41)
    cas = check_stream_native(encode_multi_register_ops(h))
    assert cas is not None and cas.valid is False
    got = _port_checker(accelerator="cpu").check({}, h, OPTS)
    ref = _ref_checker(accelerator="cpu").check({}, h, OPTS)
    assert (got["valid?"], got["algorithm"]) == (True, "jitlin-cpu")
    assert (ref["valid?"], ref["algorithm"]) == (True, "jitlin-cpu")


def test_twin_steps_the_encodings_model():
    """The exact twin, as the terminal rung and for the final
    configurations of a device verdict, steps the multi-register model:
    the CAS step would give another failing op (or none)."""
    from jepsen_tpu_torch.checker.linear_cpu import (
        cas_register_step_py, check_stream, multi_register_step_py)
    from jepsen_tpu_torch.checker.linear_encode import (
        encode_multi_register_ops)

    for case in ("dense_invalid", "sparse_invalid"):
        h = CHECK_CASES[case]()
        st = encode_multi_register_ops(h)
        cas = check_stream(st, step=cas_register_step_py)
        twin = check_stream(st, step=multi_register_step_py(3, 5))
        assert (cas.failed_op_index, cas.final_configs) != (
            twin.failed_op_index, twin.final_configs)
        ref = _ref_checker(accelerator="tpu").check({}, h, OPTS)
        got = _port_checker(accelerator="gpu", device="cpu").check(
            {}, h, OPTS)
        assert got["failed-op"] == ref["failed-op"] \
            == h[twin.failed_op_index]
        assert got["final-configs"] == ref["final-configs"] \
            == twin.final_configs


def test_matrix_cache_holds_one_kernel_per_step():
    """The matrix path's kernel cache is keyed by the step itself: a
    check builds no new kernel for a shape it has seen, and a step
    built after another was freed never gets that one's kernel."""
    from jepsen_tpu_torch.models import cas_register_spec
    from jepsen_tpu_torch.ops import jitlin

    h23 = multi_register_history(120, 3, n_keys=2, n_values=3, seed=51)
    h15 = corrupt_txn_reads(multi_register_history(
        120, 3, n_keys=1, n_values=15, seed=52), 1, seed=0, n_values=15)
    specs, sizes = {}, []
    for _ in range(3):   # two shapes in turn (both 16 states), three times
        for h, shape, alive in ((h23, (2, 3), True), (h15, (1, 15), False)):
            st, _, spec = _port_checker(multi_shape=shape)._encoding(h)
            assert spec is specs.setdefault(shape, spec)
            m = jitlin.matrix_check(st, step_ids=spec.step_ids, force=True,
                                    device="cpu")
            assert (m[0], m[2]) == (alive, False)
        sizes.append(len(jitlin._MATRIX_CACHE))
    assert sizes[1] == sizes[2] == sizes[0]

    # a step that accepts everything, freed, then one that accepts no
    # write: the second must not reuse the first's kernel
    cas = cas_register_spec().step_ids

    def everything(state, f, a, b):
        st2, ok = cas(state, f, a, b)
        return st2, ok | True

    def no_writes(state, f, a, b):
        st2, ok = cas(state, f, a, b)
        return st2, ok & (torch.as_tensor(f) != 1)

    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    from jepsen_tpu_torch.histories import register_history
    reg = encode_register_ops(register_history(60, 3, seed=53, n_values=3))
    for fn, want in ((everything, True), (no_writes, False)):
        step = (lambda f: lambda *x: f(*x))(fn)
        got = jitlin.matrix_check(reg, step_ids=step, force=True,
                                  device="cpu")
        assert got[0] is want
        del step
        gc.collect()


def test_batched_lane_takes_the_cas_register_alone():
    """The independent checker's batched lane stands aside for another
    model and for ``algorithm="wgl"``: each key then takes its own
    check, as in the reference."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.histories import independent_register_history

    h = multi_key_acid_history(4, per_group=12, n_procs=4, seed=61)
    out = independent.checker(_port_checker(
        accelerator="gpu", device="cpu")).check({}, h, OPTS)
    assert out["valid?"] is True
    assert {r["algorithm"] for r in out["results"].values()} <= {
        "torch-frontier", "jitlin-cpu(fallback)"}
    hr = independent_register_history(3, 60, n_procs=3, n_values=4)
    out = independent.checker(linearizable(
        algorithm="wgl", accelerator="gpu", device="cpu")).check(
        {}, hr, OPTS)
    assert {r["algorithm"] for r in out["results"].values()} == {"wgl-cpu"}
    out = independent.checker(linearizable(
        accelerator="gpu", device="cpu")).check(
        {}, hr, {**OPTS, "algorithm": "wgl"})
    assert {r["algorithm"] for r in out["results"].values()} == {"wgl-cpu"}


def test_batch_check_lane_for_another_spec(caplog):
    """``batch_check``'s CPU lane searches the CAS register; a batch of
    another spec keeps the device lane (here its plain versions), with a
    warning when the CPU lane was asked for."""
    from jepsen_tpu_torch.checker.linear_cpu import (
        check_stream, multi_register_step_py)
    from jepsen_tpu_torch.checker.linear_encode import (
        encode_multi_register_ops)
    from jepsen_tpu_torch.models import multi_register_spec
    from jepsen_tpu_torch.ops.jitlin import JitLinKernel
    from jepsen_tpu_torch.parallel import batch_check, last_route

    hs = [multi_register_history(20, 4, seed=70 + i) for i in range(3)]
    hs[1] = corrupt_txn_reads(hs[1], 1, seed=0)
    sts = [encode_multi_register_ops(h) for h in hs]
    kernel = JitLinKernel(step_ids=multi_register_spec(3, 5).step_ids,
                          device="cpu")
    want = [check_stream(s, step=multi_register_step_py(3, 5)).valid
            for s in sts]
    assert want == [True, False, True]
    for acc in ("cpu", "auto", "gpu"):
        caplog.clear()
        out = batch_check(sts, kernel=kernel, accelerator=acc)
        assert last_route() == "device"
        assert [r[0] for r in out] == want
        assert ("no host twin" in caplog.text) is (acc == "cpu")


# ---------------------------------------------------------------------------
# the independent checker on multi-key-acid
# ---------------------------------------------------------------------------

def test_independent_multi_key_acid_matches_reference():
    """``independent.checker(compose({"linear": linearizable(
    MultiRegister())}))`` on a small multi-key-acid history with
    corrupted keys: each key's verdict, failing op and rung (the port's
    device path against the reference's ``jitlin-tpu``), and the
    failures, equal the reference's."""
    from jepsen_tpu import independent as ref_ind
    from jepsen_tpu.checker import compose as ref_compose
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker import compose

    h = corrupt_txn_keys(multi_key_acid_history(8, seed=81), [1, 4], n=1)
    ref = ref_ind.checker(ref_compose({"linear": _ref_checker(
        accelerator="tpu")})).check({}, h, REF_OPTS)
    got = independent.checker(compose({"linear": _port_checker(
        accelerator="gpu", device="cpu")})).check({}, h, OPTS)
    cpu = independent.checker(compose({"linear": _port_checker(
        accelerator="cpu")})).check({}, h, OPTS)
    assert got["failures"] == ref["failures"] == cpu["failures"] == [
        "1", "4"]
    assert got["count"] == ref["count"] == 8
    for k, r in ref["results"].items():
        g, c = got["results"][k]["linear"], cpu["results"][k]["linear"]
        assert g["valid?"] is r["linear"]["valid?"] is c["valid?"]
        assert g["algorithm"] == r["linear"]["algorithm"].replace(
            "jitlin-tpu", "torch-frontier")
        assert g.get("failed-op") == r["linear"].get("failed-op") \
            == c.get("failed-op")


def test_multi_key_acid_history_shape():
    from jepsen_tpu_torch import independent
    h = multi_key_acid_history(3, per_group=20, n_procs=10, seed=91)
    keys, subs = independent.split_history(h)
    assert sorted(keys) == [0, 1, 2]
    for k, sub in subs.items():
        assert sum(op["type"] == "invoke" for op in sub) == 20
        assert {op["process"] // 10 for op in sub} == {k}
        for op in sub:
            reads = op["value"][0][0] == "r"
            assert (op["process"] % 10 < 5) is reads
    assert h == multi_key_acid_history(3, per_group=20, n_procs=10, seed=91)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CARD_DENSE = {
    # (history, shape, table S, V, warp path?)
    "cta_s5": (lambda: multi_register_history(300, 5, seed=101), (3, 5),
               None, 256, False),
    "cta_s9": (lambda: multi_register_history(200, 5, seed=102,
                                              crash_every=22), (3, 5),
               9, 256, False),
    "cta_s9_invalid": (lambda: corrupt_txn_reads(multi_register_history(
        200, 5, seed=103), 2, seed=1), (3, 5), 9, 256, False),
    "warp_2x3": (lambda: multi_register_history(
        300, 5, n_keys=2, n_values=3, seed=104), (2, 3), None, 16, True),
    "warp_2x3_invalid": (lambda: corrupt_txn_reads(multi_register_history(
        300, 5, n_keys=2, n_values=3, seed=105), 1, seed=2, n_values=3),
        (2, 3), None, 16, True),
    "cta_s8_v512": (lambda: multi_register_history(150, 5, seed=106),
                    (3, 5), 8, 512, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_DENSE))
def test_dense_kernel_multi_register_on_card(cuda_device, case):
    from jepsen_tpu_torch.checker.linear_encode import (
        encode_multi_register_ops)
    from jepsen_tpu_torch.models import multi_register_spec
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    make, shape, S, V, warp = CARD_DENSE[case]
    st = encode_multi_register_ops(make(), *shape)
    S = S or max(1, st.n_slots)
    assert st.n_slots <= S and fk.dense_warp_path(S, V) is warp
    step = multi_register_spec(*shape).step_ids
    ev = [torch.from_numpy(x).to(cuda_device) for x in _events(st)]
    t0 = fk.init_table(S, V, 0, cuda_device)
    got = fk.frontier_dense(*ev, t0, step_ids=step)
    paths = fk.frontier_dense.paths.tolist()
    work = {}
    ref = fk.frontier_dense_torch(*ev, t0, step_ids=step, work=work)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    assert paths == [work["warp_returns"], work["returns"]]


CARD_SPARSE = {
    "s10": lambda: multi_register_history(60, 5, seed=111, crash_every=5),
    "s12": lambda: multi_register_history(60, 5, seed=111, crash_every=4),
    "s10_invalid": lambda: corrupt_txn_reads(multi_register_history(
        60, 5, seed=113, crash_every=4), 1, seed=3),
    "s5": lambda: multi_register_history(200, 5, seed=114),
}


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 16])
@pytest.mark.parametrize("case", sorted(CARD_SPARSE))
def test_sparse_kernel_multi_register_on_card(cuda_device, case, K):
    from jepsen_tpu_torch.checker.linear_encode import (
        encode_multi_register_ops)
    from jepsen_tpu_torch.models import multi_register_spec
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    st = encode_multi_register_ops(CARD_SPARSE[case]())
    S = max(1, st.n_slots)
    assert (S >= 10) is (case != "s5")
    step = multi_register_spec(3, 5).step_ids
    ev = [torch.from_numpy(x).to(cuda_device) for x in _events(st)]
    m0, s0 = fk.init_frontier(K, 0, cuda_device)
    got = fk.frontier_sparse(*ev, m0, s0, S, step_ids=step)
    paths = fk.frontier_sparse.paths.tolist()
    work = {}
    ref = fk.frontier_sparse_torch(*ev, m0, s0, S, step_ids=step, work=work)
    for x, y in zip(got, ref):
        assert torch.equal(x.to(torch.int64), y.to(torch.int64))
    assert paths == [work["warp_passes"], work["passes"]]


@pytest.mark.cuda
def test_sparse_kernel_unsorted_expansions_on_card(cuda_device):
    from jepsen_tpu_torch.models import multi_register_spec
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    ev, S = _unsorted_pass_case()
    m0, s0 = _init_frontier(8, states=(5, 6))
    m0 = torch.from_numpy(m0.astype(np.int64)).to(torch.uint32)
    s0 = torch.from_numpy(s0)
    step = multi_register_spec(2, 5).step_ids
    ref = fk.frontier_sparse_torch(*(torch.from_numpy(x) for x in ev), m0,
                                   s0, S, step_ids=step)
    got = fk.frontier_sparse(*(torch.from_numpy(x).to(cuda_device)
                               for x in ev), m0.to(cuda_device),
                             s0.to(cuda_device), S, step_ids=step)
    for x, y in zip(got, ref):
        assert torch.equal(x.cpu().to(torch.int64), y.to(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_batched_kernels_multi_register_on_card(cuda_device, kind):
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linear_encode import (
        encode_multi_register_ops)
    from jepsen_tpu_torch.models import multi_register_spec
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    h = corrupt_txn_keys(multi_key_acid_history(8, seed=121), [2, 5], n=1)
    _, subs = independent.split_history(h)
    sts = [encode_multi_register_ops(s) for s in subs.values()]
    S = max(s.n_slots for s in sts)
    step = multi_register_spec(3, 5).step_ids
    batch = fk.batch_events(sts, S, cuda_device)
    cpu_batch = fk.batch_events(sts, S, "cpu")
    if kind == "dense":
        got = fk.frontier_dense_batch(batch, 256, 0, step)
        work = []
        ref = fk.frontier_dense_batch_torch(cpu_batch, 256, 0, step, work)
        unit = "returns"
    else:
        got = fk.frontier_sparse_batch(batch, 256, 0, step)
        work = []
        ref = fk.frontier_sparse_batch_torch(cpu_batch, 256, 0, step, work)
        unit = "passes"
    for x, y in zip(got, ref):
        assert torch.equal(x.cpu(), y)
    paths = getattr(fk, f"frontier_{kind}_batch").paths.tolist()
    assert paths == [[w.get(f"warp_{unit}", 0), w.get(unit, 0)]
                     for w in work]


@pytest.mark.cuda
def test_kernels_raise_for_a_step_without_a_copy_on_card(cuda_device):
    from jepsen_tpu_torch.checker.linear_encode import (
        encode_multi_register_ops)
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    from jepsen_tpu_torch.ops.jitlin import JitLinKernel
    st = encode_multi_register_ops(multi_register_history(20, 3, seed=141))
    ev = [torch.from_numpy(x).to(cuda_device) for x in _events(st)]
    step = (lambda *x: x)
    n = fk.frontier_dense.launches, fk.frontier_sparse.launches
    with pytest.raises(ValueError, match="no copy"):
        fk.frontier_dense(*ev, fk.init_table(st.n_slots, 256, 0,
                                             cuda_device), step_ids=step)
    with pytest.raises(ValueError, match="no copy"):
        fk.frontier_sparse(*ev, *fk.init_frontier(16, 0, cuda_device),
                           st.n_slots, step_ids=step)
    with pytest.raises(ValueError, match="no copy"):
        JitLinKernel(step_ids=step).check(st)
    assert (fk.frontier_dense.launches, fk.frontier_sparse.launches) == n


@pytest.mark.cuda
def test_checker_multi_register_on_card(cuda_device):
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker import compose
    h = corrupt_txn_keys(multi_key_acid_history(40, seed=131), [3, 9], n=1)
    got = independent.checker(compose({"linear": _port_checker(
        accelerator="gpu")})).check({}, h, OPTS)
    cpu = independent.checker(compose({"linear": _port_checker(
        accelerator="cpu")})).check({}, h, OPTS)
    assert got["failures"] == cpu["failures"] == ["3", "9"]
    for k, r in cpu["results"].items():
        assert got["results"][k]["linear"]["valid?"] is r["linear"]["valid?"]
        assert got["results"][k]["linear"].get("failed-op") \
            == r["linear"].get("failed-op")
    for case in sorted(CHECK_CASES):
        hh = CHECK_CASES[case]()
        g = _port_checker(accelerator="gpu").check({}, hh, OPTS)
        c = _port_checker(accelerator="cpu").check({}, hh, OPTS)
        assert g["algorithm"] == CHECK_RUNGS[case]
        assert (g["valid?"], g.get("failed-op"), g.get("final-configs")) \
            == (c["valid?"], c.get("failed-op"), c.get("final-configs"))
