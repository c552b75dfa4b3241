"""The port's history IR against jepsen_tpu's on the CPU, tolerance zero:
the canonical columns, the f lookups and type masks, every view, the
device placement (one device, and a mesh that repeats a device), the
run's shared IR (``history_ir.of``: identity memo, knob, lazy columns
and the errors of their build), each checker with the IR and without
it, and the WAL tailer through a torn WAL and a resume. Histories are
made from a seed with numpy."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from jepsen_tpu_torch import history_ir
from jepsen_tpu_torch.histories import (
    corrupt_keys, corrupt_reads, elle_history, independent_register_history,
    multi_register_history, register_history, rw_register_history,
    set_full_history,
)
from jepsen_tpu_torch.history_ir import DeviceHistory, views
from jepsen_tpu_torch.history_ir.ir import CANONICAL_COLUMNS
from jepsen_tpu_torch.journal import (
    WalTailer, parse_wal_chunk_py, read_wal, wal_path,
)

NO_EXPLAIN = {"explain": False}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run many small torch ops; the suite runs several
    workers on the machine's cores, where torch's thread pool would
    oversubscribe them (tens of times slower). One thread, restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def messy_register_history(n: int = 160, seed: int = 3) -> list[dict]:
    """A register history with fails, infos (crashed reads among them),
    nemesis ops, overwritten invokes and an open tail: every rule of the
    register encoder and of the invocation pairing."""
    rng = np.random.default_rng(seed)
    h, open_p = [], {}
    for i in range(n):
        p = int(rng.integers(5))
        if p in open_p and rng.random() < 0.9:
            f, v = open_p.pop(p)
            typ = ["ok", "ok", "ok", "fail", "info"][int(rng.integers(5))]
            val = int(rng.integers(5)) if typ == "ok" and f == "read" else v
            h.append({"type": typ, "process": p, "f": f, "value": val,
                      "time": i})
        elif rng.random() < 0.1:
            h.append({"type": "info", "process": "nemesis", "f": "kill",
                      "value": None, "time": i})
        else:
            f = ["read", "write", "cas"][int(rng.integers(3))]
            v = (None if f == "read" else int(rng.integers(5))
                 if f == "write" else [int(rng.integers(5)),
                                       int(rng.integers(5))])
            open_p[p] = (f, v)  # an open invoke is overwritten
            h.append({"type": "invoke", "process": p, "f": f, "value": v,
                      "time": i})
    return h


def _both(h):
    from jepsen_tpu.history_ir import DeviceHistory as RefDeviceHistory
    return DeviceHistory.from_ops(h), RefDeviceHistory.from_ops(h)


def _ref_of(h):
    """The JAX package's shared IR of ``h``, on a test map of its own."""
    from jepsen_tpu import history_ir as ref_ir
    return ref_ir.of({}, h)


def _assert_streams_equal(got, want):
    for name in ("kind", "slot", "f", "a", "b", "op_index"):
        assert np.array_equal(np.asarray(getattr(got, name)),
                              np.asarray(getattr(want, name))), name
    assert (got.n_slots, got.n_ops) == (want.n_slots, want.n_ops)
    assert len(got.intern) == len(want.intern)


def _assert_ir_equal(got, want):
    for name in CANONICAL_COLUMNS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.f_table == want.f_table
    assert got.intern.table == want.intern.table


# ---------------------------------------------------------------------------
# columns, masks and views
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2, 3])
def test_columns_and_masks_match_jax(seed):
    h = messy_register_history(seed=seed)
    dh, ref = _both(h)
    for name in CANONICAL_COLUMNS:
        a, b = getattr(dh, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert dh.f_table == ref.f_table
    assert dh.intern.table == ref.intern.table
    for f in dh.f_table + ["absent"]:
        assert dh.f_id(f) == ref.f_id(f)
        assert np.array_equal(dh.mask_f(f), ref.mask_f(f))
    for mask in ("is_invoke", "is_ok", "is_fail", "is_info"):
        assert np.array_equal(getattr(dh, mask), getattr(ref, mask)), mask
    assert dh.f_id("absent") == -1 and not dh.mask_f("absent").any()


@pytest.mark.parametrize("init_value", [None, 0])
def test_register_views_match_jax(init_value):
    from jepsen_tpu.history_ir import views as ref_views
    dh, ref = _both(messy_register_history(seed=4))
    got = views.register_stream(dh, init_value=init_value)
    _assert_streams_equal(got, ref_views.register_stream(
        ref, init_value=init_value))
    assert got.intern.table == ref_views.register_stream(
        ref, init_value=init_value).intern.table
    assert views.register_stream(dh, init_value=init_value) is got


def test_multi_register_view_matches_jax():
    from jepsen_tpu.history_ir import views as ref_views
    dh, ref = _both(multi_register_history(40, 4, seed=11))
    got = views.multi_register_stream(dh, 3, 5)
    _assert_streams_equal(got, ref_views.multi_register_stream(ref, 3, 5))
    # outside the packed encoding (a key past the shape): None, memoized
    assert views.multi_register_stream(dh, 2, 5) is None
    assert ref_views.multi_register_stream(ref, 2, 5) is None
    assert ("multi-register-stream", 2, 5) in dh.view_keys()


@pytest.mark.parametrize("pairs", [0, 2])
def test_elle_views_match_jax(pairs):
    from jepsen_tpu.history_ir import views as ref_views
    h = elle_history(200, n_keys=10, crossed_pairs=pairs)
    h.insert(5, {"type": "fail", "process": 1, "f": "txn",
                 "value": [["append", 3, 10 ** 6]]})
    dh, ref = _both(h)
    graph, txns, extras, nk = views.elle_build(dh)
    rgraph, rtxns, rextras, rnk = ref_views.elle_build(ref)
    assert (graph.n, nk) == (rgraph.n, rnk)
    assert sorted(graph.edge_list()) == sorted(rgraph.edge_list())
    assert txns == rtxns and dict(extras) == dict(rextras)
    assert views.elle_build(dh)[0] is graph
    cols, rcols = views.elle_columns(dh), ref_views.elle_columns(ref)
    assert set(cols) == set(rcols)
    for k in cols:
        assert np.array_equal(np.asarray(cols[k]), np.asarray(rcols[k])), k
    assert views.txn_nodes(dh) == ref_views.txn_nodes(ref)
    # an op of an unknown type codes as info: txn_nodes keeps it out
    odd = DeviceHistory.from_ops(h + [{"type": "weird", "process": 0}])
    assert views.txn_nodes(odd) == views.txn_nodes(dh)


def test_elle_build_outside_the_regime_is_none():
    from jepsen_tpu.history_ir import views as ref_views
    h = [{"type": "invoke", "process": 0, "f": "txn",
          "value": [["append", "k", "not-an-int"]]},
         {"type": "ok", "process": 0, "f": "txn",
          "value": [["append", "k", "not-an-int"]]}]
    dh, ref = _both(h)
    assert views.elle_build(dh) is None and ref_views.elle_build(ref) is None


def test_set_membership_matches_jax():
    from jepsen_tpu.history_ir import views as ref_views
    dh, ref = _both(set_full_history(300, 20, n_lost=2, n_stale=2, seed=1))
    got, want = views.set_membership(dh), ref_views.set_membership(ref)
    assert views.set_membership(dh) is got
    assert got["els"] == want["els"]
    for k in ("member", "has_ok"):
        assert np.array_equal(got[k], want[k]), k
    # the port keeps float64 times (ROADMAP Queue 3 item 3); these are
    # exact in float32 too
    for k in ("read_t", "invoke_t", "ok_t"):
        assert got[k].dtype == np.float64
        assert np.array_equal(got[k].astype(np.float32), want[k]), k


def test_subhistories_match_jax():
    from jepsen_tpu.history_ir import views as ref_views
    h = independent_register_history(5, 40, n_procs=3, seed=7)
    h.insert(3, {"type": "info", "process": "nemesis", "f": "kill",
                 "value": None})
    dh, ref = _both(h)
    keys, subs = views.subhistories(dh)
    rkeys, rsubs = ref_views.subhistories(ref)
    assert keys == rkeys and list(subs) == list(rsubs)
    assert subs == rsubs
    assert views.subhistories(dh)[1] is subs


# ---------------------------------------------------------------------------
# device placement
# ---------------------------------------------------------------------------

def test_device_columns_on_one_device():
    dh = DeviceHistory.from_ops(messy_register_history(n=31, seed=21))
    cols, n = dh.device_columns("cpu")
    assert n == len(dh) == 31
    for name in CANONICAL_COLUMNS:
        t = cols[name]
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert np.array_equal(t.numpy(), getattr(dh, name)), name
        assert t.numpy().dtype == getattr(dh, name).dtype
    assert dh.device_columns("cpu")[0] is cols


def test_device_columns_on_a_mesh_match_jax():
    import jax

    from jepsen_tpu_torch.parallel import Mesh
    h = messy_register_history(n=30, seed=21)
    dh, ref = _both(h)
    repeat = Mesh(["cpu", "cpu:0"] * 2)
    mcols, n = dh.device_columns(mesh=repeat)
    assert n == 30
    for name in CANONICAL_COLUMNS:
        shards = mcols[name]
        assert len(shards) == 4 and all(s.shape == (8,) for s in shards)
        full = torch.cat(shards).numpy()
        assert np.array_equal(full[:n], getattr(dh, name)), name
        # pad rows are inert: no process, no pairing
        pad = -1 if name in ("processes", "completion_of",
                             "invocation_of") else 0
        assert (full[n:] == pad).all(), name
    # each shard is a tensor of its own, even where the devices repeat
    assert len({s.data_ptr() for s in mcols["types"]}) == 4
    assert dh.device_columns(mesh=repeat)[0] is mcols
    # a mesh of the same width over other devices is another placement
    other = dh.device_columns(mesh=Mesh(["cpu"] * 4))[0]
    assert other is not mcols
    assert ("__device__", repeat.key()) in dh.view_keys()
    # the reference pads and splits the same way on its 8-device mesh
    if len(jax.devices()) >= 8:
        from jepsen_tpu.parallel import get_mesh
        rcols, rn = ref.device_columns(get_mesh(8))
        pcols, pn = dh.device_columns(mesh=Mesh(["cpu"] * 8))
        assert rn == pn
        for name in CANONICAL_COLUMNS:
            assert np.array_equal(torch.cat(pcols[name]).numpy(),
                                  np.asarray(rcols[name])), name


def test_device_columns_raise_without_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dh = DeviceHistory.from_ops(messy_register_history(n=10))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dh.device_columns()
    assert not dh.view_keys()  # a build that raises caches nothing


# ---------------------------------------------------------------------------
# the run's shared IR
# ---------------------------------------------------------------------------

def test_of_memoizes_by_identity():
    h = register_history(60, n_procs=3, seed=2)
    test = {}
    ir = history_ir.of(test, h)
    assert test[history_ir.ATTACH_KEY] is ir and ir.ops is h
    assert history_ir.of(test, h) is ir
    # a re-indexed copy is another history: a new IR replaces the old
    copy = [dict(op) for op in h]
    ir2 = history_ir.of(test, copy)
    assert ir2 is not ir and ir2.ops is copy
    assert test[history_ir.ATTACH_KEY] is ir2
    assert history_ir.of(None, h) is None
    assert history_ir.of(test, None) is None


@pytest.mark.parametrize("value", [None, "", True, False, 0, 1, "off",
                                   "yes", "garbage", 2.5])
def test_ir_knobs_coerce_as_jax(value):
    from jepsen_tpu import history_ir as ref_ir
    test = {"ir_enabled": value}
    assert history_ir.enabled(test) == ref_ir.enabled(test)
    h = register_history(20, seed=1)
    assert (history_ir.of(test, h) is None) is (not ref_ir.enabled(test))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_lazy_ir_builds_its_columns_once(seed, monkeypatch):
    """of's IR holds the caller's list and builds nothing until a column
    is read: the ops-only views equal the eager IR's, and the first
    column read builds every column once, equal to the eager build's and
    to the reference's."""
    from jepsen_tpu_torch.history_ir import ir as ir_mod
    h = messy_register_history(seed=seed)
    builds = []
    real_from_ops = ir_mod.DeviceHistory.from_ops.__func__

    def counted_from_ops(cls, history, intern=None):
        builds.append(1)
        return real_from_ops(cls, history, intern)
    monkeypatch.setattr(ir_mod.DeviceHistory, "from_ops",
                        classmethod(counted_from_ops))
    ir = history_ir.of({}, h)
    eager, ref = _both(h)
    builds.clear()
    assert ir.ops is h and len(ir) == len(h) and not ir.columns_built()
    _assert_streams_equal(views.register_stream(ir),
                          views.register_stream(eager))
    assert views.txn_nodes(ir) == views.txn_nodes(eager)
    assert views.subhistories(ir) == views.subhistories(eager)
    assert not builds and not ir.columns_built()
    assert np.array_equal(ir.is_ok, ref.is_ok)
    assert ir.columns_built() and ir.ops is h and len(builds) == 1
    _assert_ir_equal(ir, eager)
    _assert_ir_equal(ir, ref)
    assert len(builds) == 1 and len(ir) == len(h)
    with pytest.raises(AttributeError):
        ir.not_a_column


HISTORIES = {
    "register": lambda: messy_register_history(seed=5),
    "elle": lambda: elle_history(200, n_keys=10, crossed_pairs=2),
    "elle_odd_types": lambda: elle_history(60, n_keys=4) + [
        {"type": "weird", "process": 0},
        {"type": "info", "process": "nemesis", "f": "kill"},
        {"type": "fail", "process": "nemesis", "f": "kill"}],
    "rw_register": lambda: rw_register_history(1000, crossed_pairs=1),
}


@pytest.mark.parametrize("case", sorted(HISTORIES))
def test_txn_nodes_split_equals_the_masks(case):
    """txn_nodes picks by the type masks on an IR whose columns are
    built, and in one pass over the ops on one whose columns are not:
    the same split, and the reference's."""
    from jepsen_tpu.history_ir import views as ref_views
    h = HISTORIES[case]()
    lazy, (eager, ref) = history_ir.of({}, h), _both(h)
    got = views.txn_nodes(lazy)
    assert not lazy.columns_built()
    assert got == views.txn_nodes(eager) == ref_views.txn_nodes(ref)
    assert got == views.txn_split(h)


def test_the_malformed_history_falls_back_soft():
    """The reference's malformed history (tests/test_history_ir.py::
    test_malformed_history_falls_back_soft): its non-numeric time raises
    ValueError in from_ops, one of the three packing errors. The
    reference's of returns None there; the port's of builds no columns,
    so the checks on its IR give what they give without it, and only a
    column read raises the build's error."""
    from jepsen_tpu import history_ir as ref_ir
    from jepsen_tpu_torch.elle import list_append, rw_register
    h = [{"type": "info", "process": ["weird"], "time": "bogus"}]
    with pytest.raises(ValueError):
        DeviceHistory.from_ops(h)
    assert ref_ir.of({}, h) is None
    t = {}
    ir = history_ir.of(t, h)
    assert t[history_ir.ATTACH_KEY] is ir
    for mod in (list_append, rw_register):
        on = mod.check(h, accelerator="gpu", device="cpu", ir=ir)
        assert on == mod.check(h, accelerator="gpu", device="cpu")
        assert on["valid?"] is True
    assert not ir.columns_built() and len(ir) == 1
    with pytest.raises(ValueError):
        ir.types
    assert not ir.columns_built()


def test_of_passes_other_errors_on(monkeypatch, tmp_path):
    """of builds nothing, so a check on its IR reads no column; an error
    of the column build, of any type, reaches the caller that read one
    (the store's sidecar, device_columns)."""
    from jepsen_tpu_torch import store

    def boom(*a, **k):
        raise RuntimeError("not a packing error")
    monkeypatch.setattr(DeviceHistory, "from_ops", classmethod(boom))
    h = register_history(20, seed=1)
    test = {"name": "boom", "start_time": "t0", "store_dir": str(tmp_path),
            "history": h}
    ir = history_ir.of(test, h)
    assert _lin("cpu").check(test, h, NO_EXPLAIN)["valid?"] is True
    with pytest.raises(RuntimeError, match="not a packing error"):
        store.write_columnar(test)
    with pytest.raises(RuntimeError, match="not a packing error"):
        ir.device_columns("cpu")
    assert not ir.columns_built()


# ---------------------------------------------------------------------------
# checkers with the IR and without it
# ---------------------------------------------------------------------------

def _lin(acc, **kw):
    from jepsen_tpu_torch.checker.linearizable import linearizable
    return linearizable(accelerator=acc, device="cpu", **kw)


def _ref_lin(**kw):
    from jepsen_tpu.checker.linearizable import linearizable
    return linearizable(accelerator="cpu", **kw)


def _multi(acc):
    from jepsen_tpu_torch.models import MultiRegister
    return _lin(acc, model=MultiRegister())


def _ref_multi():
    from jepsen_tpu.models import MultiRegister
    return _ref_lin(model=MultiRegister())


def _set_full(acc):
    from jepsen_tpu_torch.checker import set_full
    return set_full(True, acc, device="cpu")


def _ref_set_full():
    from jepsen_tpu.checker import set_full
    return set_full(True, "cpu")


def _independent(acc):
    from jepsen_tpu_torch import independent
    return independent.checker(_lin(acc))


def _ref_independent():
    from jepsen_tpu import independent
    return independent.checker(_ref_lin())


# (port checker by accelerator, the reference's CPU oracle, history) by
# case
CHECKER_CASES = {
    "cas_valid": (_lin, _ref_lin, lambda: register_history(
        200, n_procs=3, seed=3, n_values=5)),
    "cas_invalid": (_lin, _ref_lin, lambda: corrupt_reads(
        register_history(200, n_procs=3, seed=4, n_values=5), n=2, seed=1)),
    "multi_register": (_multi, _ref_multi, lambda: multi_register_history(
        25, 4, seed=12)),
    "set_full": (_set_full, _ref_set_full, lambda: set_full_history(
        300, 20, n_lost=2, n_stale=2, seed=1)),
    "independent": (_independent, _ref_independent, lambda: corrupt_keys(
        independent_register_history(4, 60, n_procs=3, seed=9), [2])),
}


def _comparable(out: dict) -> dict:
    """A result map without the fields that name the backend (the
    port's ``torch-*`` and ``jitlin-gpu`` against the reference's
    ``jitlin-tpu*``) or its frontier's peak, which differ by rung, and
    without ``plot``, a path under each package's own store dir."""
    out = {k: v for k, v in out.items()
           if k not in ("algorithm", "configs-max", "plot")}
    if isinstance(out.get("results"), dict):
        # a key of the batched lane carries only its verdict
        out["results"] = {k: v["valid?"] for k, v in out["results"].items()}
    return out


@pytest.fixture
def small_matrix_regime(monkeypatch):
    """Admits these short histories to the port's matrix screen, which
    is quicker on the CPU than the frontier scans' plain versions."""
    from jepsen_tpu_torch.ops import jitlin
    monkeypatch.setattr(jitlin, "MATRIX_MIN_RETURNS", 10)


@pytest.mark.parametrize("accelerator", ["gpu", "cpu"])
@pytest.mark.parametrize("case", sorted(CHECKER_CASES))
def test_checker_same_with_and_without_ir(case, accelerator,
                                          small_matrix_regime):
    make, make_ref, hist = CHECKER_CASES[case]
    h = hist()
    chk = make(accelerator)
    test = {"name": case}
    on = chk.check(test, h, NO_EXPLAIN)
    # the set-full walk on the CPU encodes nothing, as in the reference
    uses_ir = not (case == "set_full" and accelerator == "cpu")
    assert (test.get(history_ir.ATTACH_KEY) is not None) is uses_ir
    # no checker's view reads the IR's columns
    assert not uses_ir or not test[history_ir.ATTACH_KEY].columns_built()
    off = chk.check({"ir_enabled": False}, h, NO_EXPLAIN)
    assert on == off
    ref = make_ref().check({}, h, NO_EXPLAIN)
    assert _comparable(on) == _comparable(ref)
    assert on["valid?"] is (not case.endswith(("invalid", "set_full",
                                               "independent")))


@pytest.mark.parametrize("pairs", [0, 2])
def test_list_append_same_with_and_without_ir(pairs):
    from jepsen_tpu.elle import list_append as ref_la
    from jepsen_tpu_torch.elle import list_append
    h = elle_history(300, n_keys=10, crossed_pairs=pairs)
    ir = history_ir.of({}, h)
    for acc in ("gpu", "cpu"):
        on = list_append.check(h, accelerator=acc, device="cpu", ir=ir)
        off = list_append.check(h, accelerator=acc, device="cpu")
        assert on == off
    assert ("elle-build",) in ir.view_keys()
    assert ("txn-nodes",) in ir.view_keys()
    ref = ref_la.check(h, accelerator="tpu", ir=_ref_of(h))
    got = list_append.check(h, accelerator="gpu", device="cpu", ir=ir)
    assert got == ref
    # outside the columnar regime the IR's txn_nodes feed the Python
    # builder
    odd = [dict(op) for op in h]
    first_ok = next(i for i, op in enumerate(odd) if op["type"] == "ok")
    odd[first_ok]["value"] = [["append", 0, "x"]]
    odd_ir = history_ir.of({}, odd)
    assert list_append.check(odd, accelerator="gpu", device="cpu",
                             ir=odd_ir) == list_append.check(
        odd, accelerator="gpu", device="cpu")


@pytest.mark.parametrize("pairs", [0, 1])
def test_rw_register_same_with_and_without_ir(pairs):
    from jepsen_tpu.elle import rw_register as ref_rw
    from jepsen_tpu_torch.elle import rw_register
    h = rw_register_history(1000, crossed_pairs=pairs)
    ir = history_ir.of({}, h)
    on = rw_register.check(h, accelerator="gpu", device="cpu", ir=ir)
    assert on == rw_register.check(h, accelerator="gpu", device="cpu")
    assert on == ref_rw.check(h, accelerator="cpu", ir=_ref_of(h))
    assert ("txn-nodes",) in ir.view_keys()


def test_two_checker_run_encodes_once(monkeypatch, tmp_path):
    """A Compose of two linearizable checkers and the store's sidecar
    on one test map: one register encode, and the canonical columns
    built once, by the sidecar (the checks build none)."""
    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.checker import compose, linear_encode, linearizable
    from jepsen_tpu_torch.history_ir import ir as ir_mod
    builds, encodes = [], []
    real_from_ops = ir_mod.DeviceHistory.from_ops.__func__
    real_encode = linear_encode.encode_register_ops

    def counted_from_ops(cls, history, intern=None):
        builds.append(1)
        return real_from_ops(cls, history, intern)

    def counted_encode(*a, **k):
        encodes.append(1)
        return real_encode(*a, **k)
    monkeypatch.setattr(ir_mod.DeviceHistory, "from_ops",
                        classmethod(counted_from_ops))
    for mod in (linear_encode, linearizable):
        monkeypatch.setattr(mod, "encode_register_ops", counted_encode)
    h = register_history(300, n_procs=3, seed=6)
    test = {"name": "two", "start_time": "t0", "store_dir": str(tmp_path),
            "history": h}
    chk = compose({"a": _lin("gpu"), "b": _lin("cpu")})
    out = chk.check(test, h, NO_EXPLAIN)
    assert out["a"]["valid?"] is True and out["b"]["valid?"] is True
    assert (len(builds), len(encodes)) == (0, 1)
    store.write_columnar(test)
    assert (len(builds), len(encodes)) == (1, 1)
    ir = test[history_ir.ATTACH_KEY]
    assert [k for k in ir.view_keys() if k[0] == "register-stream"] == [
        ("register-stream", None)]
    # without the IR each checker encodes on its own
    chk.check({"ir_enabled": False}, h, NO_EXPLAIN)
    assert len(encodes) == 3


def test_independent_per_key_checks_keep_the_run_ir():
    """Per-key checks (a Compose of two linearizables keeps the batched
    lane out) see ``ir_enabled: False`` and leave the run's IR alone."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker import compose
    h = independent_register_history(3, 40, n_procs=3, seed=4)
    test = {"name": "ind"}
    chk = independent.checker(compose({"a": _lin("cpu"), "b": _lin("cpu")}))
    assert chk.check(test, h, NO_EXPLAIN)["valid?"] is True
    ir = test[history_ir.ATTACH_KEY]
    assert ir.ops is h and ("subhistories",) in ir.view_keys()


# ---------------------------------------------------------------------------
# the WAL tailer
# ---------------------------------------------------------------------------

def _write(path, text, mode="a"):
    with open(path, mode) as f:
        f.write(text)


def test_wal_tailer_through_a_torn_wal_and_a_resume(tmp_path):
    """The same bytes through both packages' tailers: an in-progress
    final line, an interior torn line, and a fresh tailer resumed at the
    first one's offset with its prefix digest."""
    from jepsen_tpu.journal import WalTailer as RefTailer
    h = messy_register_history(n=90, seed=9)
    lines = [json.dumps(op) for op in h]
    wal = tmp_path / "history.wal.jsonl"
    t, rt = WalTailer(wal), RefTailer(wal)
    seen = []

    def poll(final=False):
        got, want = t.poll(final=final), rt.poll(final=final)
        assert got == want
        seen.extend(got)
        assert (t.offset, t.lines_read, t.torn_skipped, t.truncated_tail) \
            == (rt.offset, rt.lines_read, rt.torn_skipped,
                rt.truncated_tail)
        return got

    assert poll() == []  # no file yet
    _write(wal, "\n".join(lines[:30]) + "\n", "w")
    assert len(poll()) == 30
    _write(wal, lines[30][:10])  # the writer is mid-line
    assert poll() == [] and len(seen) == 30
    _write(wal, lines[30][10:] + "\n" + "\n".join(lines[31:50]) + "\n")
    assert len(poll()) == 20
    _write(wal, lines[50][:7] + "\n")  # an interior torn line
    _write(wal, "\n".join(lines[51:70]) + "\n")
    assert len(poll()) == 19 and t.torn_skipped == 1
    assert t.prefix_sha() == rt.prefix_sha()
    # resume: a fresh tailer adopts the offset only with the right digest
    t2, rt2 = WalTailer(wal), RefTailer(wal)
    assert not t2.seek(t.offset, prefix_sha="0" * 64)
    assert not rt2.seek(rt.offset, prefix_sha="0" * 64)
    assert t2.offset == 0
    assert not t2.seek(10 ** 9)  # past the end of the file
    assert t2.seek(t.offset, t.lines_read, t.torn_skipped, t.prefix_sha())
    assert rt2.seek(rt.offset, rt.lines_read, rt.torn_skipped,
                    rt.prefix_sha())
    t, rt = t2, rt2
    _write(wal, "\n".join(lines[70:]) + "\n" + '{"type": "ok", "pro')
    assert len(poll()) == 20
    assert poll(final=True) == [] and t.truncated_tail
    assert seen == h[:50] + h[51:]
    assert read_wal(wal) == (h[:50] + h[51:], True)


CHUNKS = [
    b"",
    b'{"a": 1}\n{"a": 2}\n',
    b'{"a": 1}\n{"a": 2',
    b'{"a": 1}\n{"a"\n{"b": [1, 2]}\n',
    b'\n  \n{"a": "\\u00e9"}\n',
    b'{"x": [1,\n37]}\n',
    b'{"a": 1},{"a": 2}\n',
    b'{"a": "\xff"}\n{"b": 1}\n',
]


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("chunk", CHUNKS, ids=range(len(CHUNKS)))
def test_parse_wal_chunk_matches_jax(chunk, final):
    from jepsen_tpu.journal import parse_wal_chunk_py as ref_parse
    assert parse_wal_chunk_py(chunk, final) == ref_parse(chunk, final)


def test_poll_bytes_matches_jax(tmp_path):
    from jepsen_tpu.journal import WalTailer as RefTailer
    wal = tmp_path / "history.wal.jsonl"
    _write(wal, '{"a": 1}\n{"a": 2}\n{"a"', "w")
    t, rt = WalTailer(wal), RefTailer(wal)
    assert t.poll_bytes() == rt.poll_bytes() == b'{"a": 1}\n{"a": 2}\n'
    assert (t.offset, t.lines_read) == (rt.offset, rt.lines_read)
    assert t.poll_bytes() == b"" and t.prefix_sha() == rt.prefix_sha()
    assert wal_path({"name": "n", "start_time": "t", "store_dir": "s"}) \
        == Path("s/n/t/history.wal.jsonl")
