"""jepsen_tpu_torch.models' object models and the multi-register spec
against jepsen_tpu.models: every object model's ``step`` on seeded op
sequences (the same next model, field for field, or both inconsistent
with the same message), and ``multi_register_spec``'s torch ``step_ids``
against the jnp one exhaustively over every state and packed action
(tolerance zero: int32 and bool results)."""
from __future__ import annotations

import itertools
import random

import numpy as np
import pytest
import torch


def _register_op(rng):
    f = rng.choice(["read", "write", "cas", "swap"])
    v = rng.choice([None, 0, 1, 2])
    if f == "cas":
        v = [rng.choice([None, 0, 1, 2]), rng.randrange(3)]
    return {"f": f, "value": v}


def _lock_op(rng):
    f = rng.choice(["acquire", "acquire", "release", "touch"])
    op = {"f": f, "process": rng.choice([0, 1, 2, None, -1])}
    r = rng.random()
    if r < 0.3:
        op["value"] = rng.randrange(6)            # a fence
    elif r < 0.5:
        op["value"] = {"fence": rng.randrange(6),
                       "client": rng.choice([None, 7, 8])}
    elif r < 0.6:
        op["value"] = True                         # not a fence
    return op


def _queue_op(rng):
    f = rng.choice(["enqueue", "enqueue", "dequeue", "peek"])
    return {"f": f, "value": rng.randrange(3)}


def _set_op(rng):
    if rng.random() < 0.6:
        return {"f": "add", "value": rng.randrange(4)}
    if rng.random() < 0.2:
        return {"f": "read", "value": None}
    return {"f": rng.choice(["read", "remove"]),
            "value": sorted(rng.sample(range(4), rng.randrange(4)))}


def _txn_op(rng):
    if rng.random() < 0.05:
        return {"f": "txn", "value": [["x", 0, 1]]}
    keys = rng.sample(range(3), rng.randrange(1, 4))
    return {"f": "txn",
            "value": [[rng.choice("rw"), k, rng.choice([None, 0, 1, 2])]
                      for k in keys]}


# model name -> (constructor kwargs, op maker)
MODELS = {
    "NoOp": ({}, _register_op),
    "Register": ({}, _register_op),
    "CASRegister": ({}, _register_op),
    "Mutex": ({}, _lock_op),
    "OwnerMutex": ({}, _lock_op),
    "ReentrantMutex": ({}, _lock_op),
    "FencedMutex": ({}, _lock_op),
    "ReentrantFencedMutex": ({}, _lock_op),
    "AcquiredPermits": ({}, _lock_op),
    "FIFOQueue": ({}, _queue_op),
    "UnorderedQueue": ({}, _queue_op),
    "SetModel": ({}, _set_op),
    "MultiRegister": ({}, _txn_op),
}


def _same_model(a, b) -> bool:
    return type(a).__name__ == type(b).__name__ and vars(a) == vars(b)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_object_model_steps_match_reference(name, seed):
    import jepsen_tpu.models as jm
    import jepsen_tpu_torch.models as tm

    kw, make_op = MODELS[name]
    rng = random.Random(1000 * seed + len(name))
    port, ref = getattr(tm, name)(**kw), getattr(jm, name)(**kw)
    consistent = 0
    for _ in range(300):
        op = make_op(rng)
        p2, r2 = port.step(op), ref.step(op)
        assert tm.is_inconsistent(p2) == jm.is_inconsistent(r2), op
        assert _same_model(p2, r2), (op, p2, r2)
        if not tm.is_inconsistent(p2):
            consistent += 1
            port, ref = p2, r2
            hash(port)   # object models key the search's memo
    assert consistent > 0


def test_fence_and_client_helpers_match_reference():
    import jepsen_tpu.models as jm
    import jepsen_tpu_torch.models as tm

    rng = random.Random(5)
    for _ in range(200):
        op = _lock_op(rng)
        assert tm._op_fence(op) == jm._op_fence(op)
        assert tm._op_client(op) == jm._op_client(op)


def test_memo_wraps_a_model():
    from jepsen_tpu_torch.models import Memo, Register
    assert Memo(Register(1)).model == Register(1)
    assert hash(Memo(Register(1))) == hash(Memo(Register(1)))


def _all_inputs(K, V):
    SB, AB = V + 1, 2 * V + 2
    st, a = np.meshgrid(np.arange(SB ** K), np.arange(AB ** K),
                        indexing="ij")
    return st.astype(np.int32).ravel(), a.astype(np.int32).ravel()


@pytest.mark.parametrize("shape", [(3, 5), (2, 3)])
def test_multi_register_step_ids_match_jnp_exhaustively(shape):
    """Every state of the map against every packed action, at the
    workload's (3, 5) (216 x 1,728) and at (2, 3)."""
    import jax.numpy as jnp

    import jepsen_tpu.models as jm
    import jepsen_tpu_torch.models as tm

    K, V = shape
    ref, port = jm.multi_register_spec(K, V), tm.multi_register_spec(K, V)
    assert (port.name, port.init_state, port.num_f) == (
        ref.name, ref.init_state, ref.num_f)
    st, a = _all_inputs(K, V)
    zero = np.zeros_like(st)
    r_st, r_ok = ref.step_ids(*(jnp.asarray(x) for x in (st, zero, a, zero)))
    p_st, p_ok = port.step_ids(*(torch.from_numpy(x)
                                 for x in (st, zero, a, zero)))
    assert p_st.dtype == torch.int32 and p_ok.dtype == torch.bool
    assert np.array_equal(p_st.numpy(), np.asarray(r_st))
    assert np.array_equal(p_ok.numpy(), np.asarray(r_ok))


def test_multi_register_step_ids_broadcast_and_negative_inputs():
    """The [U, V] broadcast the plain versions use (states against
    per-op columns) and int32 values outside the encoding, where //
    and % floor as jnp's do."""
    import jax.numpy as jnp

    import jepsen_tpu.models as jm
    import jepsen_tpu_torch.models as tm

    rng = np.random.default_rng(3)
    st = rng.integers(-2 ** 31, 2 ** 31 - 1, (1, 64)).astype(np.int32)
    a = rng.integers(-2 ** 31, 2 ** 31 - 1, (32, 1)).astype(np.int32)
    r_st, r_ok = jm.multi_register_spec(3, 5).step_ids(
        jnp.asarray(st), 0, jnp.asarray(a), 0)
    p_st, p_ok = tm.multi_register_spec(3, 5).step_ids(
        torch.from_numpy(st), 0, torch.from_numpy(a), 0)
    assert p_st.shape == (32, 64)
    assert np.array_equal(p_st.numpy(), np.asarray(r_st))
    assert np.array_equal(p_ok.numpy(), np.asarray(r_ok))


def test_multi_register_step_py_matches_step_ids():
    from jepsen_tpu.checker.linear_cpu import (
        multi_register_step_py as ref_step_py)
    from jepsen_tpu_torch.checker.linear_cpu import multi_register_step_py
    from jepsen_tpu_torch.models import multi_register_spec

    K, V = 2, 3
    step, ref_step = multi_register_step_py(K, V), ref_step_py(K, V)
    st, a = _all_inputs(K, V)
    t_st, t_ok = multi_register_spec(K, V).step_ids(
        torch.from_numpy(st), 0, torch.from_numpy(a), 0)
    for s, x, ts, tok in zip(st.tolist(), a.tolist(), t_st.tolist(),
                             t_ok.tolist()):
        got = step(s, 0, x, 0)
        assert got == ref_step(s, 0, x, 0)
        assert got[1] == tok
        if tok:
            assert got[0] == ts


def test_kernel_models_and_one_spec_per_shape():
    """Each spec's step names the transition the frontier kernels carry;
    ``multi_register_spec`` returns one spec (one step) per shape and
    raises where the reference raises."""
    import jepsen_tpu.models as jm
    from jepsen_tpu_torch.models import (
        KERNEL_CAS, KERNEL_MULTI_REGISTER, cas_register_spec, kernel_model,
        multi_register_spec, register_spec)

    assert kernel_model(cas_register_spec(3).step_ids) == (KERNEL_CAS, 0, 0)
    assert kernel_model(register_spec().step_ids) == (KERNEL_CAS, 0, 0)
    assert kernel_model(multi_register_spec(3, 5).step_ids) == (
        KERNEL_MULTI_REGISTER, 3, 5)
    assert kernel_model(lambda *x: x) is None
    assert multi_register_spec(3, 5) is multi_register_spec(3, 5)
    assert multi_register_spec(2, 3).step_ids \
        is not multi_register_spec(3, 5).step_ids
    for K, V in itertools.product((8, 9), (4, 5)):
        ref_raises = port_raises = False
        try:
            jm.multi_register_spec(K, V)
        except ValueError:
            ref_raises = True
        try:
            multi_register_spec(K, V)
        except ValueError:
            port_raises = True
        assert ref_raises == port_raises
