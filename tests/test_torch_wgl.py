"""jepsen_tpu_torch's object-model search ``wgl`` and the checker's
``algorithm`` option against jepsen_tpu's on seeded concurrent histories
of every model: valid histories (each op takes effect at its completion,
against the model), histories with crashed (``info``) ops, and copies
with one corrupted return. The same ``valid?``, failing op index,
algorithm name and peak memo size (tolerance zero)."""
from __future__ import annotations

import random

import pytest

OPTS = {"explain": False}


def _simulate(model, make_op, complete, n_ops, n_procs, seed, crash_p=0.0):
    """A concurrent history: each invoke's op from ``make_op``; at its
    completion ``complete`` fills in what the op saw, and the op takes
    effect against the model there (``ok``), or did not apply (``fail``),
    or crashed (``info``: taking effect or not by a coin when what it saw
    is its invoke's value, else not, since the search sees a crashed op
    as invoked)."""
    from jepsen_tpu_torch.models import is_inconsistent
    rng = random.Random(seed)
    history, pending = [], {}
    m, invoked = model, 0
    while invoked < n_ops or pending:
        free = [p for p in range(n_procs) if p not in pending]
        if invoked < n_ops and free and (not pending or rng.random() < 0.6):
            p = rng.choice(free)
            op = {"type": "invoke", "process": p, **make_op(rng, p)}
            history.append(op)
            pending[p] = op
            invoked += 1
            continue
        p = rng.choice(sorted(pending))
        inv = pending.pop(p)
        done = complete(rng, m, dict(inv))
        m2 = m.step(done)
        if is_inconsistent(m2):
            history.append({**done, "type": "fail"})
        elif rng.random() < crash_p:
            if done.get("value") == inv.get("value") and rng.random() < 0.5:
                m = m2
            history.append({**done, "type": "info"})
        else:
            m = m2
            history.append({**done, "type": "ok"})
    return history


def _reg_op(rng, p):
    f = rng.choice(["read", "write", "cas"])
    if f == "read":
        return {"f": f, "value": None}
    if f == "write":
        return {"f": f, "value": rng.randrange(3)}
    return {"f": f, "value": [rng.randrange(3), rng.randrange(3)]}


def _rw_op(rng, p):
    return ({"f": "read", "value": None} if rng.random() < 0.5
            else {"f": "write", "value": rng.randrange(3)})


def _reg_done(rng, m, op):
    if op["f"] == "read":
        op["value"] = m.value
    return op


def _lock_op(rng, p):
    return {"f": rng.choice(["acquire", "release"]), "value": None}


_FENCE = [0]


def _fence_done(rng, m, op):
    if op["f"] == "acquire":
        _FENCE[0] += 1
        op["value"] = _FENCE[0] if rng.random() < 0.8 else None
    return op


def _queue_op(rng, p):
    f = rng.choice(["enqueue", "dequeue"])
    return {"f": f, "value": rng.randrange(4) if f == "enqueue" else None}


def _fifo_done(rng, m, op):
    if op["f"] == "dequeue":
        op["value"] = m.items[0] if m.items else rng.randrange(4)
    return op


def _unordered_done(rng, m, op):
    if op["f"] == "dequeue":
        items = sorted(v for v, _ in m.items)
        op["value"] = rng.choice(items) if items else rng.randrange(4)
    return op


def _set_op(rng, p):
    return ({"f": "add", "value": rng.randrange(5)} if rng.random() < 0.6
            else {"f": "read", "value": None})


def _set_done(rng, m, op):
    if op["f"] == "read":
        op["value"] = sorted(m.items)
    return op


def _txn_op(rng, p):
    keys = sorted(rng.sample(range(3), rng.randrange(1, 4)))
    if rng.random() < 0.5:
        return {"f": "txn", "value": [["r", k, None] for k in keys]}
    return {"f": "txn", "value": [["w", k, rng.randrange(5)] for k in keys]}


def _txn_done(rng, m, op):
    if op["value"][0][0] == "r":
        op["value"] = [["r", k, m.get(k)] for _, k, _ in op["value"]]
    return op


def _same(rng, m, op):
    return op


# model name -> (op maker, completion)
MODELS = {
    "NoOp": (_reg_op, _same),
    "Register": (_rw_op, _reg_done),
    "CASRegister": (_reg_op, _reg_done),
    "Mutex": (_lock_op, _same),
    "OwnerMutex": (_lock_op, _same),
    "ReentrantMutex": (_lock_op, _same),
    "FencedMutex": (_lock_op, _fence_done),
    "ReentrantFencedMutex": (_lock_op, _fence_done),
    "AcquiredPermits": (_lock_op, _same),
    "FIFOQueue": (_queue_op, _fifo_done),
    "UnorderedQueue": (_queue_op, _unordered_done),
    "SetModel": (_set_op, _set_done),
    "MultiRegister": (_txn_op, _txn_done),
}


def _corrupt(history, seed):
    """One ok return answering what its op could not have seen (a read
    or dequeue of 9, a set read with an extra element, a txn read of a
    value no write gave, a lock op that failed made ok)."""
    rng = random.Random(seed)
    out = [dict(op) for op in history]
    oks = [i for i, op in enumerate(out) if op["type"] in ("ok", "fail")]
    for i in rng.sample(oks, len(oks)):
        op = out[i]
        f, v = op["f"], op.get("value")
        if op["type"] == "fail" and f in ("acquire", "release"):
            op["type"] = "ok"
            return out
        if op["type"] != "ok":
            continue
        if f in ("read", "dequeue") and not isinstance(v, list):
            op["value"] = 9
            return out
        if f == "read":
            op["value"] = sorted(v) + [9]
            return out
        if f == "txn" and v[0][0] == "r":
            op["value"] = [["r", k, 4] for _, k, _ in v]
            return out
    return out


def _case(name, variant, seed):
    import jepsen_tpu_torch.models as tm
    make_op, complete = MODELS[name]
    _FENCE[0] = 0
    h = _simulate(getattr(tm, name)(), make_op, complete, n_ops=24,
                  n_procs=3, seed=seed,
                  crash_p=0.2 if variant == "crashed" else 0.0)
    return _corrupt(h, seed) if variant == "corrupted" else h


@pytest.mark.parametrize("variant", ["valid", "crashed", "corrupted"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_wgl_matches_reference(name, variant):
    import jepsen_tpu.models as jm
    from jepsen_tpu.checker.linear_cpu import wgl as ref_wgl
    import jepsen_tpu_torch.models as tm
    from jepsen_tpu_torch.checker.linear_cpu import wgl

    invalid = 0
    for seed in range(4):
        h = _case(name, variant, seed)
        got = wgl(h, getattr(tm, name)())
        ref = ref_wgl(h, getattr(jm, name)())
        assert (got.valid, got.failed_op_index, got.algorithm,
                got.configs_max) == (ref.valid, ref.failed_op_index,
                                     ref.algorithm, ref.configs_max), seed
        if variant != "corrupted":
            assert got.valid is True
        invalid += got.valid is False
    if variant == "corrupted" and name not in ("NoOp", "AcquiredPermits"):
        assert invalid > 0


def test_wgl_step_budget_and_empty_history_match_reference():
    from jepsen_tpu.checker.linear_cpu import wgl as ref_wgl
    from jepsen_tpu.models import CASRegister as RefReg
    from jepsen_tpu_torch.checker.linear_cpu import wgl
    from jepsen_tpu_torch.models import CASRegister

    h = _case("CASRegister", "valid", 7)
    for steps in (1, 5, 50_000_000):
        got, ref = wgl(h, CASRegister(), steps), ref_wgl(h, RefReg(), steps)
        assert (got.valid, got.configs_max) == (ref.valid, ref.configs_max)
    assert wgl([], CASRegister()).valid is True


@pytest.mark.parametrize("algorithm", ["auto", "wgl"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_checker_matches_reference_for_every_model(name, algorithm):
    """``linearizable(model=m)`` accepts every model: the encodable ones
    take the int-encoded search under "auto", the rest and "wgl" the
    object-model search; verdict, algorithm, failing op and context
    equal the JAX package's checker on the CPU."""
    import jepsen_tpu.models as jm
    from jepsen_tpu.checker.linearizable import linearizable as ref_lin
    import jepsen_tpu_torch.models as tm
    from jepsen_tpu_torch.checker.linearizable import linearizable

    for variant, seed in (("valid", 11), ("crashed", 12), ("corrupted", 13)):
        h = _case(name, variant, seed)
        ref = ref_lin(getattr(jm, name)(), algorithm=algorithm,
                      accelerator="cpu").check({}, h, OPTS)
        got = linearizable(getattr(tm, name)(), algorithm=algorithm,
                           accelerator="cpu", device="cpu").check(
            {}, h, OPTS)
        for key in ("valid?", "algorithm", "configs-max", "failed-op",
                    "context", "final-configs"):
            assert got.get(key) == ref.get(key), (variant, key)
        encodable = name in ("CASRegister", "MultiRegister")
        assert (got["algorithm"] == "wgl-cpu") == (
            algorithm == "wgl" or not encodable)


def test_algorithm_in_opts_overrides_the_checker():
    from jepsen_tpu_torch.checker.linearizable import linearizable

    h = _case("CASRegister", "corrupted", 3)
    chk = linearizable(accelerator="cpu", device="cpu")
    assert chk.check({}, h, {"algorithm": "wgl"})["algorithm"] == "wgl-cpu"
    assert chk.check({}, h, {})["algorithm"] == "jitlin-native"
    with pytest.raises(ValueError):
        chk.check({}, h, {"algorithm": "linear"})
