"""jepsen_tpu_torch's anomaly forensics against jepsen_tpu's on the CPU
(after tests/test_explain.py:19-271): the device localization
(``jitlin.matrix_localize``, its plain versions on ``device="cpu"``) on
planted-anomaly histories, whole and segmented; the witness shrink
(``checker/explain.explain_stream``) key for key; the knobs' coercion;
and the checkers' results: ``LinearizableChecker`` settling an invalid
history at ``torch-matrix`` with the reference's ``explain`` map (CAS and
the (2, 3) multi-register shape), ``explain: False`` restoring the
frontier rung, and the batched ``independent`` lane's per-key forensics.
Positions and maps are integers and strings: tolerance zero."""
from __future__ import annotations

import numpy as np
import pytest


# copied from tests/test_explain.py:19-43, without the times
def _history(n_blocks, plant_anomaly_at=None, seed=3):
    """Write/read blocks over a 5-value register domain (3 processes);
    a planted read observes a value that was NOT the previous write."""
    rng = np.random.default_rng(seed)
    ops = []
    for b in range(n_blocks):
        p = int(rng.integers(3))
        v = int(rng.integers(5))
        p2 = int(rng.integers(3))
        rv = (v + 1) % 5 if b == plant_anomaly_at else v
        ops += [
            {"process": p, "type": "invoke", "f": "write", "value": v},
            {"process": p, "type": "ok", "f": "write", "value": v},
            {"process": p2, "type": "invoke", "f": "read", "value": None},
            {"process": p2, "type": "ok", "f": "read", "value": rv},
        ]
    return ops


def _streams(history):
    """(the JAX package's stream, the port's stream) of one history."""
    from jepsen_tpu.checker.linear_encode import (
        encode_register_ops as ref_enc)
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    return ref_enc(history), encode_register_ops(history)


def _twin(stream):
    from jepsen_tpu_torch.checker.linear_cpu import check_stream
    return check_stream(stream)


def _loc_key(loc):
    return (loc.failed_event, loc.failed_op_index, loc.chunk, loc.step,
            loc.bisect_steps, loc.n_chunks, loc.chunk_returns)


# ---------------------------------------------------------------------------
# localization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plant", [0, 1, 700, 1500, 2047])
def test_matrix_localize_matches_jax(plant):
    from jepsen_tpu.ops import jitlin as rj
    from jepsen_tpu_torch.ops import jitlin

    ref_s, s = _streams(_history(2048, plant_anomaly_at=plant))
    want = rj.matrix_localize(ref_s)
    got = jitlin.matrix_localize(s, device="cpu")
    assert got is not None and want is not None
    assert _loc_key(got) == _loc_key(want)
    twin = _twin(s)
    assert twin.valid is False
    assert (got.failed_event, got.failed_op_index) == (
        twin.failed_event, twin.failed_op_index)
    # the guilty window's grids and entry frontier are the reference's
    assert np.array_equal(got.window_pend, np.asarray(want.window_pend))
    assert np.array_equal(got.window_valid, np.asarray(want.window_valid))
    assert np.array_equal(got.v_start.numpy(),
                          np.asarray(want.v_start, np.float32) > 0)


def test_matrix_localize_valid_returns_none():
    from jepsen_tpu_torch.ops import jitlin

    _, s = _streams(_history(2048))
    assert _twin(s).valid is True
    assert jitlin.matrix_localize(s, device="cpu") is None


def test_matrix_localize_concurrent_history_matches_jax():
    """Four processes (S = 4, MV = 128), two corrupted reads: the same
    localization, on the chunks of real concurrency."""
    from jepsen_tpu.ops import jitlin as rj
    from jepsen_tpu_torch.histories import corrupt_reads, register_history
    from jepsen_tpu_torch.ops import jitlin

    h = corrupt_reads(register_history(2400, n_procs=4, seed=7, n_values=5),
                      n=2, seed=3)
    ref_s, s = _streams(h)
    want = rj.matrix_localize(ref_s)
    got = jitlin.matrix_localize(s, device="cpu")
    assert _loc_key(got) == _loc_key(want)
    assert got.failed_event == _twin(s).failed_event


def _slice(stream, lo, hi):
    from jepsen_tpu_torch.checker.linear_encode import EventStream
    return EventStream(kind=stream.kind[lo:hi], slot=stream.slot[lo:hi],
                       f=stream.f[lo:hi], a=stream.a[lo:hi],
                       b=stream.b[lo:hi], op_index=stream.op_index[lo:hi],
                       n_slots=stream.n_slots, n_ops=stream.n_ops,
                       intern=stream.intern)


def test_matrix_localize_segmented_chain():
    """A failing segment localizes against the carried product of the
    earlier ones (the port's ``matrix_check_resume`` total) and gives the
    whole stream's exact first anomaly, with no rescan of the chain."""
    from jepsen_tpu.ops.jitlin import quiescent_cuts
    from jepsen_tpu_torch.ops import jitlin

    _, s = _streams(_history(4096, plant_anomaly_at=3000))
    twin = _twin(s)
    cuts = quiescent_cuts(np.asarray(s.kind), 1 << 13)
    assert len(cuts) >= 2, "the chain must span several segments"
    kw = dict(n_slots=s.n_slots, num_states=len(s.intern), device="cpu")
    tot, base, found = None, 0, None
    for end in cuts:
        seg = _slice(s, base, end)
        alive, inexact, tot2 = jitlin.matrix_check_resume(seg, tot, **kw)
        assert not bool(inexact.any())
        if not bool(alive.all()):
            loc = jitlin.matrix_localize(seg, tot0=tot, **kw)
            assert loc is not None
            found = (base + loc.failed_event, loc.failed_op_index)
            break
        tot, base = tot2, end
    assert base > 0, "the anomaly lies past the first segment"
    assert found == (twin.failed_event, twin.failed_op_index)


def test_first_failure_matches_jax():
    from jepsen_tpu.checker import explain as ref_ex
    from jepsen_tpu_torch.checker import explain

    for h in (_history(2048, plant_anomaly_at=1500),
              _history(40, plant_anomaly_at=35), _history(40)):
        ref_s, s = _streams(h)
        assert explain.first_failure(s, device="cpu") == \
            ref_ex.first_failure(ref_s)


# ---------------------------------------------------------------------------
# witness shrink
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget,max_ops", [(64, 2), (128, 16), (6, 1)])
def test_explain_stream_matches_jax(budget, max_ops):
    from jepsen_tpu.checker import explain as ref_ex
    from jepsen_tpu_torch.checker import explain

    ref_s, s = _streams(_history(8192, plant_anomaly_at=2000))
    want = ref_ex.explain_stream(ref_s, max_witness_ops=max_ops,
                                 shrink_budget=budget)
    got = explain.explain_stream(s, max_witness_ops=max_ops,
                                 shrink_budget=budget, device="cpu")
    for f in (want, got):
        assert f.pop("explain_latency_seconds") >= 0
    assert got == want
    assert got["backend"] == "matrix-bisect"
    assert got["first_anomaly"]["op_index"] == _twin(s).failed_op_index
    assert got["witness"]["candidates"] <= budget


def test_explain_stream_shrinks_through_the_rescan(monkeypatch):
    """Every ddmin round is one rescan of its candidates, padded to a
    power of two of at least 4 with keep-all rows."""
    from jepsen_tpu_torch.checker import explain
    from jepsen_tpu_torch.ops import jitlin

    calls = []
    real = jitlin.matrix_window_rescan

    def spy(loc, pend, valid):
        calls.append(pend.shape[0])
        return real(loc, pend, valid)

    monkeypatch.setattr(jitlin, "matrix_window_rescan", spy)
    _, s = _streams(_history(8192, plant_anomaly_at=2000))
    got = explain.explain_stream(s, max_witness_ops=2, shrink_budget=64,
                                 device="cpu")
    assert len(calls) == got["witness"]["rounds"] >= 1
    assert all(k >= 4 and k & (k - 1) == 0 for k in calls)


def test_explain_stream_cpu_fallback_and_valid():
    from jepsen_tpu.checker import explain as ref_ex
    from jepsen_tpu_torch.checker import explain

    ref_s, s = _streams(_history(40, plant_anomaly_at=35))
    want = ref_ex.explain_stream(ref_s)
    got = explain.explain_stream(s, device="cpu")
    for f in (want, got):
        f.pop("explain_latency_seconds")
    assert got == want and got["backend"] == "frontier-cpu"
    assert _twin(s).failed_op_index in got["witness"]["op_indices"]
    assert explain.explain_stream(_streams(_history(40))[1],
                                  device="cpu") is None
    assert explain.explain_stream(_streams(_history(2048))[1],
                                  device="cpu") is None


def test_ddmin_matches_jax():
    from jepsen_tpu.checker import explain as ref_ex
    from jepsen_tpu_torch.checker import explain

    items = list(range(40))
    for need, budget, floor in (({3, 17, 31}, 128, 0), ({5}, 10, 0),
                                (set(range(40)), 50, 0), ({2, 9}, 128, 4)):
        fails = (lambda sub, need=need: need <= set(sub))
        assert explain.ddmin(items, fails, budget, floor) == \
            ref_ex.ddmin(items, fails, budget, floor)


KNOB_VALUES = [None, "", True, False, 0, 1, 2, "yes", "No", " on ", "off",
               "garbage", 3.5, "12", "-4", "7.9", [1]]


def test_knobs_coerce_as_jax():
    from jepsen_tpu.checker import explain as ref_ex
    from jepsen_tpu_torch.checker import explain

    for v in KNOB_VALUES:
        for test, opts in (({"explain": v}, None), ({}, {"explain": v}),
                           ({"explain": False}, {"explain": v})):
            assert explain.enabled(test, opts) == ref_ex.enabled(test, opts)
        t = {"explain_shrink_budget": v, "explain_max_witness_ops": v}
        assert explain.shrink_budget(t) == ref_ex.shrink_budget(t)
        assert explain.max_witness_ops(t) == ref_ex.max_witness_ops(t)
    assert explain.enabled() is True and explain.shrink_budget() == 128


# ---------------------------------------------------------------------------
# the checkers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plant", [1, 700])
def test_checker_settles_invalid_at_matrix_rung(plant):
    from jepsen_tpu.checker.linearizable import LinearizableChecker as Ref
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker

    h = _history(2048, plant_anomaly_at=plant)
    twin = _twin(_streams(h)[1])
    ref = Ref(accelerator="tpu").check({}, h, {"checker_sharded": False})
    got = LinearizableChecker(accelerator="gpu", device="cpu").check(
        {}, h, {})
    assert (ref["algorithm"], got["algorithm"]) == ("jitlin-tpu-matrix",
                                                    "torch-matrix")
    assert got["valid?"] is False and got["configs-max"] == 0
    for key in ("failed-op", "context", "final-configs", "explain"):
        assert got[key] == ref[key], key
    assert got["failed-op"] == h[twin.failed_op_index]
    assert got["explain"]["backend"] == "matrix-bisect"
    assert got["explain"]["first-anomaly-op"] == twin.failed_op_index


@pytest.mark.parametrize("where", ["opts", "test", "string"])
def test_explain_off_restores_frontier_rung(where):
    from jepsen_tpu.checker.linearizable import LinearizableChecker as Ref
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker

    h = _history(2048, plant_anomaly_at=700)
    test, opts = {"opts": ({}, {"explain": False}),
                  "test": ({"explain": False}, {}),
                  "string": ({"explain": True}, {"explain": "off"})}[where]
    ref = Ref(accelerator="tpu").check(test, h,
                                       {**opts, "checker_sharded": False})
    got = LinearizableChecker(accelerator="gpu", device="cpu").check(
        test, h, opts)
    assert got["algorithm"] == "torch-frontier"
    assert ref["algorithm"] != "jitlin-tpu-matrix"
    assert "explain" not in got and "explain" not in ref
    for key in ("valid?", "failed-op", "context", "final-configs"):
        assert got[key] == ref[key], key


def test_checker_knobs_reach_the_shrink():
    """The test map's shrink knobs reach the witness shrink: the map
    equals the reference's under the same knobs."""
    from jepsen_tpu.checker.linearizable import LinearizableChecker as Ref
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker

    h = _history(8192, plant_anomaly_at=2000)
    test = {"explain_shrink_budget": "8", "explain_max_witness_ops": 1}
    ref = Ref(accelerator="tpu").check(test, h, {"checker_sharded": False})
    got = LinearizableChecker(accelerator="gpu", device="cpu").check(
        test, h, {})
    assert got["explain"] == ref["explain"]
    assert got["algorithm"] == "torch-matrix"


def test_cpu_accelerator_explains_on_the_cpu():
    """Under accelerator="cpu" the verdict comes from the host rungs and
    the forensics localize with the plain versions on the CPU: the
    reference's map."""
    from jepsen_tpu.checker.linearizable import LinearizableChecker as Ref
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker

    h = _history(2048, plant_anomaly_at=1500)
    ref = Ref(accelerator="cpu").check({}, h, {})
    got = LinearizableChecker(accelerator="cpu").check({}, h, {})
    assert got["algorithm"] == ref["algorithm"]
    for key in ("valid?", "failed-op", "final-configs", "explain"):
        assert got[key] == ref[key], key


def test_multi_register_settles_at_matrix_rung():
    """An invalid (2, 3) multi-register history (16 states) settles at
    ``torch-matrix`` with the reference's failing op and ``explain``."""
    from jepsen_tpu.checker.linearizable import linearizable as ref_lin
    from jepsen_tpu.models import MultiRegister as RefMR
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.histories import (
        corrupt_txn_reads, multi_register_history)
    from jepsen_tpu_torch.models import MultiRegister

    h = multi_register_history(2100, 3, n_keys=2, n_values=3, seed=31)
    bad = corrupt_txn_reads(h, 1, seed=3, n_values=3)
    ref = ref_lin(RefMR(), accelerator="tpu", multi_shape=(2, 3)).check(
        {}, bad, {"checker_sharded": False})
    got = linearizable(MultiRegister(), accelerator="gpu", device="cpu",
                       multi_shape=(2, 3)).check({}, bad, {})
    assert (got["valid?"], got["algorithm"]) == (False, "torch-matrix")
    assert ref["algorithm"] == "jitlin-tpu-matrix"
    for key in ("failed-op", "final-configs", "explain"):
        assert got[key] == ref[key], key
    assert got["explain"]["backend"] == "matrix-bisect"


def _lifted_four_keys():
    """tests/test_explain.py:442's history: four keys of 128 blocks, key
    2 with a planted anomaly at block 80."""
    h = []
    for k in range(4):
        plant = 80 if k == 2 else None
        for op in _history(128, plant_anomaly_at=plant, seed=20 + k):
            op = dict(op)
            if op.get("value") is not None or op["f"] == "read":
                op["value"] = [f"k{k}", op.get("value")]
            h.append(op)
    return h


@pytest.mark.parametrize("explain_on", [True, False])
def test_batched_independent_lane_explains_invalid_keys(explain_on):
    from jepsen_tpu import independent as ref_ind
    from jepsen_tpu.checker.linearizable import LinearizableChecker as Ref
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker

    h = _lifted_four_keys()
    opts = {} if explain_on else {"explain": False}
    ref = ref_ind.checker(Ref(accelerator="tpu")).check(
        {}, h, {**opts, "checker_sharded": False})
    got = independent.checker(LinearizableChecker(
        accelerator="gpu", device="cpu")).check({}, h, opts)
    assert got["valid?"] is ref["valid?"] is False
    assert got["failures"] == ref["failures"] == ["k2"]
    for k, r in got["results"].items():
        want = ref["results"][k]
        assert r["algorithm"] == "jitlin-gpu"
        assert r.get("explain") == want.get("explain"), k
        assert r["valid?"] == want["valid?"]
    assert ("explain" in got["results"]["k2"]) is explain_on
    assert not any("explain" in got["results"][k] for k in ("k0", "k1",
                                                           "k3"))
