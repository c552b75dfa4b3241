"""The port's Elle checks (jepsen_tpu_torch.elle) against jepsen_tpu.elle,
at tolerance zero: the whole result maps must be equal.

The same histories (the anomaly families of tests/test_elle.py, and the
seeded history makers of jepsen_tpu_torch.histories) go to the JAX
package, whose device programs run as ``jax.jit`` on the CPU, and to the
port on ``device="cpu"``, whose kernel wrappers run their plain torch
versions. The port's ``accelerator="gpu"`` is held against the
reference's ``"tpu"``, and ``"cpu"`` and ``"auto"`` against their
namesakes.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jepsen_tpu.elle as ref_elle
from jepsen_tpu.elle import columnar as ref_columnar
from jepsen_tpu.elle import list_append as ref_la
from jepsen_tpu.elle import rw_register as ref_rw
import jepsen_tpu_torch.elle as elle
from jepsen_tpu_torch.convert import graph_from_numpy
from jepsen_tpu_torch.elle import columnar, list_append, rw_register
from jepsen_tpu_torch.histories import elle_history, rw_register_history
from jepsen_tpu_torch.ops import scc_kernels

ROOT = Path(__file__).resolve().parent.parent
# the port's accelerator name for each of the reference's
PAIRS = [("tpu", "gpu"), ("cpu", "cpu"), ("auto", "auto")]


def ok(process, txn):
    return {"type": "ok", "process": process, "f": "txn", "value": txn}


def fail(process, txn):
    return {"type": "fail", "process": process, "f": "txn", "value": txn}


def inv(process, txn):
    return {"type": "invoke", "process": process, "f": "txn",
            "value": [[f, k, None if f == "r" else v] for f, k, v in txn]}


def timed(txns, procs=3):
    """Each txn invoked and completed in turn (real invoke/ok intervals,
    so φ exists), on process i % procs."""
    h = []
    for i, t in enumerate(txns):
        h += [inv(i % procs, t), ok(i % procs, t)]
    return h


# list-append anomaly families (the shapes of tests/test_elle.py)
APPEND_FAMILIES = {
    "serializable": [ok(0, [["append", "x", 1]]),
                     ok(1, [["r", "x", [1]], ["append", "x", 2]]),
                     ok(0, [["r", "x", [1, 2]]])],
    "G0": [ok(0, [["append", "x", 1], ["append", "y", 1]]),
           ok(1, [["append", "x", 2], ["append", "y", 2]]),
           ok(2, [["r", "x", [1, 2]], ["r", "y", [2, 1]]])],
    "G1a": [fail(0, [["append", "x", 9]]), ok(1, [["r", "x", [9]]])],
    "G1b": [ok(0, [["append", "x", 1], ["append", "x", 2]]),
            ok(1, [["r", "x", [1]]]), ok(2, [["r", "x", [1, 2]]])],
    "G1c": [ok(0, [["append", "x", 1], ["r", "y", [1]]]),
            ok(1, [["append", "y", 1], ["r", "x", [1]]])],
    "G-single": [ok(0, [["append", "x", 1], ["append", "y", 1]]),
                 ok(1, [["r", "x", [1]], ["r", "y", []]]),
                 ok(2, [["r", "y", [1]]])],
    "G2": [ok(0, [["r", "x", []], ["append", "y", 1]]),
           ok(1, [["r", "y", []], ["append", "x", 1]]),
           ok(2, [["r", "x", [1]], ["r", "y", [1]]])],
    "internal": [ok(0, [["append", "x", 1], ["r", "x", []]])],
    "incompatible-order": [ok(0, [["append", "x", 1]]),
                           ok(1, [["append", "x", 2]]),
                           ok(2, [["r", "x", [1, 2]]]),
                           ok(3, [["r", "x", [2]]])],
    "realtime-cycle": [inv(0, [["append", "x", 1]]),
                       ok(0, [["append", "x", 1]]),
                       inv(1, [["r", "x", []]]), ok(1, [["r", "x", []]]),
                       inv(2, [["r", "x", [1]]]), ok(2, [["r", "x", [1]]])],
    "process-cycle": [ok(0, [["append", "x", 1]]), ok(0, [["r", "x", []]]),
                      ok(1, [["r", "x", [1]]])],
    "G1c-timed": timed([[["append", "x", 1], ["r", "y", [1]]],
                        [["append", "y", 1], ["r", "x", [1]]],
                        [["append", "z", 1]]]),
    "G2-timed": timed([[["r", "x", []], ["append", "y", 1]],
                       [["r", "y", []], ["append", "x", 1]],
                       [["r", "x", [1]], ["r", "y", [1]]]]),
}

# rw-register anomaly families
RW_FAMILIES = {
    "serializable": [ok(0, [["w", "x", 1]]),
                     ok(1, [["r", "x", 1], ["w", "x", 2]]),
                     ok(0, [["r", "x", 2]])],
    # each txn read the other's write, then overwrote it: ww both ways
    "G0": [ok(0, [["r", "x", 1], ["w", "x", 2], ["w", "y", 1]]),
           ok(1, [["w", "x", 1], ["r", "y", 1], ["w", "y", 2]])],
    "G1a": [fail(0, [["w", "x", 9]]), ok(1, [["r", "x", 9]])],
    "G1b": [ok(0, [["w", "x", 1], ["w", "x", 2]]), ok(1, [["r", "x", 1]])],
    "G1c": [ok(0, [["w", "x", 1], ["r", "y", 1]]),
            ok(1, [["w", "y", 1], ["r", "x", 1]])],
    "G-single": [ok(0, [["w", "x", 1]]),
                 ok(1, [["r", "x", 1], ["w", "x", 2], ["w", "y", 2]]),
                 ok(2, [["r", "y", 2], ["r", "x", 1]])],
    "G2": timed([[["r", 0, None], ["w", 1, 1]],
                 [["r", 1, None], ["w", 0, 1]],
                 [["r", 0, 1], ["r", 1, 1]]]),
    "internal": [ok(0, [["w", "x", 1], ["r", "x", 5]])],
    "realtime-cycle": [inv(0, [["w", "x", 1]]), ok(0, [["w", "x", 1]]),
                       inv(1, [["r", "x", None]]),
                       ok(1, [["r", "x", None]])],
    "process-cycle": [ok(0, [["w", "x", 1]]), ok(0, [["r", "x", None]]),
                      ok(1, [["r", "x", 1]])],
    "cyclic-versions": timed([[["r", 0, 1], ["w", 0, 2]],
                              [["r", 0, 2], ["w", 0, 1]]]),
    "version-chain": timed([[["w", 0, 1]], [["r", 0, 1], ["w", 0, 2]],
                            [["r", 0, 2], ["w", 0, 3], ["w", 1, 30]],
                            [["r", 1, 30], ["r", 0, 1]]]),
}


def port_check(mod, h, acc, **kw):
    return mod.check(h, accelerator=acc, device="cpu", **kw)


@pytest.mark.parametrize("acc", PAIRS, ids=lambda p: p[1])
@pytest.mark.parametrize("family", sorted(APPEND_FAMILIES))
def test_list_append_matches_jax(family, acc):
    h = APPEND_FAMILIES[family]
    want = ref_la.check(h, accelerator=acc[0])
    got = port_check(list_append, h, acc[1])
    assert got == want
    if family not in ("serializable", "G1c-timed", "G2-timed"):
        assert family in got["anomaly-types"], got


@pytest.mark.parametrize("acc", PAIRS, ids=lambda p: p[1])
@pytest.mark.parametrize("family", sorted(RW_FAMILIES))
def test_rw_register_matches_jax(family, acc):
    h = RW_FAMILIES[family]
    want = ref_rw.check(h, accelerator=acc[0])
    got = port_check(rw_register, h, acc[1])
    assert got == want
    assert got["valid?"] is (family == "serializable"), got


def test_consistency_models_forwarded():
    for models in (("serializable",), ("read-committed",), ("sequential",)):
        for fam in ("realtime-cycle", "process-cycle", "G-single"):
            h = APPEND_FAMILIES[fam]
            assert port_check(list_append, h, "gpu",
                              consistency_models=models) == \
                ref_la.check(h, accelerator="tpu",
                             consistency_models=models)
            h = RW_FAMILIES[fam]
            assert port_check(rw_register, h, "gpu",
                              consistency_models=models) == \
                ref_rw.check(h, accelerator="tpu",
                             consistency_models=models)


def _bench():
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_elle_history_is_the_benchmarks():
    b = _bench()
    assert elle_history(300, crossed_pairs=4) == \
        b._elle_history(300, crossed_pairs=4)
    wide = elle_history(2000, crossed_pairs=2, wide=True)
    pairs = [i for i, op in enumerate(wide[1::2]) if op["process"] >= 10]
    assert pairs == [50, 950, 1050, 1950] and len(wide) == 2 * 2004


# (name, history): the 2k-txn histories of the slice's shapes
SLICE_HISTORIES = [
    ("valid", lambda: elle_history(2000)),
    ("pairs_at_end", lambda: elle_history(2000, crossed_pairs=8)),
    ("wide_window", lambda: elle_history(2000, crossed_pairs=2, wide=True)),
]


@pytest.mark.parametrize("case", SLICE_HISTORIES, ids=lambda c: c[0])
def test_slice_list_append_matches_jax_and_oracle(case):
    name, make = case
    h = make()
    before = scc_kernels.cluster_screen.launches
    got = port_check(list_append, h, "gpu")
    assert got == ref_la.check(h, accelerator="tpu")
    assert scc_kernels.cluster_screen.launches == before
    oracle = port_check(list_append, h, "cpu")
    assert {k: v for k, v in got.items() if k != "builder"} == oracle
    want = [] if name == "valid" else ["G1c", "realtime-cycle"]
    assert got["anomaly-types"] == want
    assert set(columnar.LAST_PHASE_SECONDS) == {"build", "cycles"}


def test_slice_rw_register_matches_jax_and_oracle():
    h = rw_register_history(1500, crossed_pairs=1)
    got = port_check(rw_register, h, "gpu")
    assert got == ref_rw.check(h, accelerator="tpu")
    assert got == port_check(rw_register, h, "cpu")
    assert "G1c" in got["anomaly-types"]
    h = rw_register_history(800, n_keys=5, seed=3)
    assert port_check(rw_register, h, "gpu") == \
        ref_rw.check(h, accelerator="tpu")


def _ref_graph(h):
    graph, _txns, _extras, _nk = ref_columnar._build_py(h)
    return graph


@pytest.mark.parametrize("drop_phi", [False, True], ids=["cluster", "global"])
@pytest.mark.parametrize("n_pairs", [0, 3])
def test_check_cycles_matches_jax_on_one_graph(drop_phi, n_pairs):
    """One JAX-built graph carried into the port; ``drop_phi`` takes
    away its φ so both packages take the global trim path."""
    h = elle_history(600, crossed_pairs=n_pairs, wide=False)
    g = _ref_graph(h)
    order = None if drop_phi else g.time_order
    pg = graph_from_numpy(g.n, *g.cols, order)
    g.time_order = order
    trims = scc_kernels.scc_trim.launches
    got = elle.check_cycles(pg, accelerator="gpu", device="cpu")
    assert scc_kernels.scc_trim.launches == trims
    assert got == ref_elle.check_cycles(g, accelerator="tpu")
    assert bool(got) == (n_pairs > 0)
    assert elle.check_cycles(pg, accelerator="cpu") == \
        ref_elle.check_cycles(g, accelerator="cpu")


def test_graph_from_numpy_rejects_bad_columns():
    with pytest.raises(ValueError):
        graph_from_numpy(3, [0, 1], [0, 1], [1])
    with pytest.raises(ValueError):
        graph_from_numpy(3, [7], [0], [1])
    with pytest.raises(ValueError):
        graph_from_numpy(3, [0], [0], [3])
    with pytest.raises(ValueError):
        graph_from_numpy(3, [0], [0], [1], time_order=[0, 1])


def test_accelerator_names_and_default_device():
    h = APPEND_FAMILIES["G1c-timed"]
    for mod in (list_append, rw_register):
        with pytest.raises(ValueError):
            mod.check(h, accelerator="tpu", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("the default device is the card here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        list_append.check(h, accelerator="gpu")
    # the cpu oracle needs no device
    assert list_append.check(h, accelerator="cpu")["valid?"] is False


def test_trim_cpu_twin_matches_jax():
    rng = np.random.default_rng(5)
    src = rng.integers(0, 80, 200)
    dst = rng.integers(0, 80, 200)
    np.testing.assert_array_equal(elle._trim_cpu(80, src, dst),
                                  ref_elle._trim_cpu(80, src, dst))
