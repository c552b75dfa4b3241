"""The port's store and history-IR sidecar against the JAX package's: a
``history.npz`` written by either package loads in the other with equal
keys and arrays (canonical columns, ``f_table``, ``val_table``,
``elle_*``, ``lin_*``), and the store's edge cases (a JSON collision in
the value table, a torn ``history.jsonl``, a leading nemesis op) behave
as the reference's. Tolerance zero."""
from __future__ import annotations

import numpy as np
import pytest

from jepsen_tpu import store as ref_store
from jepsen_tpu.history_ir import sidecar as ref_sidecar
from jepsen_tpu_torch import store
from jepsen_tpu_torch.histories import (corrupt_reads, elle_history,
                                        register_history)
from jepsen_tpu_torch.history_ir import DeviceHistory, sidecar
from jepsen_tpu_torch.history_ir.ir import CANONICAL_COLUMNS

TS = "20260101T000000"


def _with_nemesis(h):
    """``h`` behind a nemesis op and with a failed write, times and
    indices, so that the canonical columns see every op kind."""
    ops = [{"type": "info", "process": "nemesis", "f": "start-partition",
            "value": None, "time": 0}]
    for i, op in enumerate(h):
        ops.append(dict(op, time=10 * (i + 1), index=i + 1))
    ops += [{"type": "invoke", "process": 0, "f": "write", "value": 3,
             "time": 10 ** 12},
            {"type": "fail", "process": 0, "f": "write", "value": 3,
             "time": 10 ** 12 + 1, "error": "timeout"}]
    return ops


# (name, history): a list-append history with anomalies, a clean one, a
# register history (lin_* columns) and a register history behind a
# nemesis op with a failed write
CASES = [
    ("elle_pairs", lambda: elle_history(200, n_keys=10, crossed_pairs=2)),
    ("elle_valid", lambda: elle_history(120, n_keys=6)),
    ("register", lambda: register_history(150, n_procs=3, seed=4,
                                          n_values=5)),
    ("register_nemesis", lambda: _with_nemesis(
        corrupt_reads(register_history(80, n_procs=3, seed=5, n_values=4),
                      n=1, seed=2))),
]


def _npz(d, name):
    with np.load(d / name / TS / "history.npz", allow_pickle=True) as z:
        return {k: z[k] for k in z.files}


def assert_arrays_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_port_writes_the_jax_packages_sidecar(case, tmp_path):
    name, make = case
    h = make()
    for mod, sub in ((store, "port"), (ref_store, "jax")):
        test = {"name": name, "start_time": TS,
                "store_dir": str(tmp_path / sub), "history": h}
        mod.write_history(test)
        mod.write_columnar(test)
    got, want = _npz(tmp_path / "port", name), _npz(tmp_path / "jax", name)
    assert_arrays_equal(got, want)
    assert {"f_table", "val_table", *CANONICAL_COLUMNS} <= set(want)
    assert any(k.startswith("elle_" if name.startswith("elle")
                            else "lin_") for k in want)
    for f in ("history.jsonl", "history.txt"):
        assert (tmp_path / "port" / name / TS / f).read_bytes() == \
            (tmp_path / "jax" / name / TS / f).read_bytes()
    # and the JAX package reads the port's file as its own
    back = ref_store.load_columnar(name, TS, str(tmp_path / "port"))
    assert back.intern.table == ref_store.load_columnar(
        name, TS, str(tmp_path / "jax")).intern.table


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_jax_store_loads_in_the_port(case, tmp_path):
    name, make = case
    ref_store.save_1({"name": name, "start_time": TS,
                      "store_dir": str(tmp_path), "history": make()})
    d = str(tmp_path)
    dh = store.load_columnar(name, TS, d)
    want = ref_store.load_columnar(name, TS, d)
    assert isinstance(dh, DeviceHistory)
    for col in CANONICAL_COLUMNS:
        assert np.array_equal(getattr(dh, col), getattr(want, col)), col
    assert dh.f_table == want.f_table
    assert dh.intern.table == want.intern.table
    for loader in ("load_elle_columns", "load_linear_columns"):
        got, ref = getattr(store, loader)(name, TS, d), \
            getattr(ref_store, loader)(name, TS, d)
        assert (got is None) == (ref is None), loader
        if ref is not None:
            assert_arrays_equal(got, ref)
    assert store.load_history(name, TS, d) == \
        ref_store.load_history(name, TS, d)


def test_value_intern_positional_on_json_collision(tmp_path):
    """Two distinct intern ids whose canonical-JSON rows collide (tuple
    vs list with equal contents) keep their positional ids on reload, in
    either package."""
    h = [
        {"type": "invoke", "process": 0, "f": "w", "value": (1, 2),
         "time": 0},
        {"type": "ok", "process": 0, "f": "w", "value": [1, 2], "time": 1},
        {"type": "invoke", "process": 1, "f": "w", "value": "tail",
         "time": 2},
        {"type": "ok", "process": 1, "f": "w", "value": "tail", "time": 3},
    ]
    dh = DeviceHistory.from_ops(h)
    assert len(dh.intern.table) == 4  # None, (1,2), [1,2], 'tail'
    p = tmp_path / "history.npz"
    sidecar.save(p, dh)
    for back in (sidecar.load(p), ref_sidecar.load(p)):
        assert len(back.intern.table) == len(dh.intern.table)
        assert np.array_equal(back.value_ids, dh.value_ids)
        assert back.intern.value(int(dh.value_ids[2])) == "tail"
        assert back.intern.value(int(dh.value_ids[1])) == [1, 2]


def test_torn_last_line_is_dropped(tmp_path):
    h = register_history(20, n_procs=2, seed=1, n_values=3)
    test = {"name": "torn", "start_time": TS, "store_dir": str(tmp_path),
            "history": h}
    store.write_history(test)
    p = tmp_path / "torn" / TS / "history.jsonl"
    with open(p, "a") as f:
        f.write('{"type": "ok", "proc')
    assert store.load_history("torn", TS, str(tmp_path)) == h
    assert ref_store.load_history("torn", TS, str(tmp_path)) == h


def test_leading_nemesis_op_keeps_lin_columns(tmp_path):
    """A nemesis op before the first client op must not mask a register
    run from the lin_* probe (the model: the JAX package's
    test_lin_sidecar_survives_leading_nemesis_op)."""
    h = [{"type": "info", "process": "nemesis", "f": "start-partition",
          "value": None}]
    for i in range(10):
        h.append({"type": "invoke", "process": 0, "f": "write", "value": i})
        h.append({"type": "ok", "process": 0, "f": "write", "value": i})
    test = {"name": "nem", "start_time": TS, "store_dir": str(tmp_path),
            "history": h}
    store.write_history(test)
    store.write_columnar(test)
    cols = store.load_linear_columns("nem", TS, str(tmp_path))
    assert cols is not None and int(cols["n_ops"]) == 10
    assert store.first_client_f(h) == "write"
