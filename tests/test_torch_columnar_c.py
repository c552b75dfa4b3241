"""The port's C columnar parser (jepsen_tpu_torch/native/columnar_ext.c)
against the JAX package's: ``parse_columns`` key for key, the C front's
graph build against the numpy front's, and the list-append check through
the C front against ``jepsen_tpu.elle.list_append.check``. Tolerance
zero. The histories are tiny and made from seeded numpy generators."""
from __future__ import annotations

import numpy as np
import pytest

from jepsen_tpu.elle import columnar as ref_columnar
from jepsen_tpu.elle import list_append as ref_la
from jepsen_tpu_torch.elle import columnar, list_append
from jepsen_tpu_torch.native import columnar_c


def messy_history(seed: int, n_txns: int = 40) -> list[dict]:
    """A list-append history with every corner the parser walks:
    multi-appends, failed (multi-)appends, info txns, unfulfilled and
    empty reads, invokes, then random corruptions of the reads (a dropped
    tail element, a duplicated element, a phantom value, an arbitrary
    single value)."""
    rng = np.random.default_rng(seed)
    lists: dict = {}
    history: list[dict] = []
    last = [0]

    def fresh():
        last[0] += 1
        return last[0]

    for i in range(n_txns):
        p = i % 5
        k = int(rng.integers(3))
        kind = rng.random()
        if kind < 0.15:
            mops = [["append", k, fresh()]
                    for _ in range(int(rng.integers(1, 3)))]
            history.append({"type": "invoke", "process": p, "f": "txn",
                            "value": [list(m) for m in mops]})
            history.append({"type": "fail", "process": p, "f": "txn",
                            "value": mops})
            continue
        mops = []
        for _ in range(int(rng.integers(1, 4))):
            if rng.random() < 0.5:
                mops.append(["r", k, None])
            else:
                v = fresh()
                lists.setdefault(k, []).append(v)
                mops.append(["append", k, v])
        applied = [["r", m[1], list(lists.get(m[1], []))] if m[0] == "r"
                   else m for m in mops]
        history.append({"type": "invoke", "process": p, "f": "txn",
                        "value": mops})
        t = "info" if kind < 0.22 else "ok"
        history.append({"type": t, "process": p, "f": "txn",
                        "value": applied if t == "ok" else mops})
    for _ in range(int(rng.integers(4))):
        oks = [op for op in history if op["type"] == "ok"]
        reads = [m for m in oks[int(rng.integers(len(oks)))]["value"]
                 if m[0] == "r"]
        if not reads:
            continue
        m = reads[int(rng.integers(len(reads)))]
        roll = rng.random()
        if roll < 0.3 and m[2]:
            m[2] = list(m[2][:-1])
        elif roll < 0.5 and m[2]:
            m[2] = list(m[2]) + [m[2][0]]
        elif roll < 0.75:
            m[2] = list(m[2]) + [last[0] + int(rng.integers(1, 9))]
        else:
            m[2] = [int(rng.integers(1, last[0] + 1))]
    return history


def clean_history(seed: int, n_txns: int = 60) -> list[dict]:
    """A serializable list-append history: one process a txn at a time,
    every read the key's whole list."""
    rng = np.random.default_rng(seed)
    lists: dict = {}
    history: list[dict] = []
    for i in range(n_txns):
        mops = []
        for _ in range(int(rng.integers(1, 4))):
            k = int(rng.integers(4))
            if rng.random() < 0.5:
                mops.append(["r", k, list(lists.get(k, []))])
            else:
                lists.setdefault(k, []).append(100 * i + len(mops))
                mops.append(["append", k, 100 * i + len(mops)])
        p = int(rng.integers(4))
        history.append({"type": "invoke", "process": p, "f": "txn",
                        "value": [[f, k, None if f == "r" else v]
                                  for f, k, v in mops]})
        history.append({"type": "ok", "process": p, "f": "txn",
                        "value": mops})
    return history


HISTORIES = ([(f"messy{s}", lambda s=s: messy_history(s)) for s in range(32)]
             + [(f"clean{s}", lambda s=s: clean_history(s))
                for s in range(8)])


def assert_columns_equal(got, want) -> None:
    assert got is not None and want is not None
    assert set(got) == set(want) == set(columnar.ELLE_COLUMN_KEYS)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("case", HISTORIES, ids=lambda c: c[0])
def test_parse_columns_matches_jax(case):
    h = case[1]()
    assert_columns_equal(columnar.parse_columns(h),
                         ref_columnar.parse_columns(h))


# histories outside the storable regime: a non-int read payload, a
# non-int key, float elements (last and not last), a bool append
OUT_OF_REGIME = {
    "str_payload": [{"type": "ok", "process": 0, "f": "txn",
                     "value": [["append", 0, 1], ["r", 0, "ab"]]}],
    "str_key": [{"type": "ok", "process": 0, "f": "txn",
                 "value": [["append", "x", 1], ["r", "x", [1]]]}],
    "float_last": [{"type": "ok", "process": 0, "f": "txn",
                    "value": [["append", 0, 1], ["r", 0, [1, 1.5]]]}],
    "float_inner": [{"type": "ok", "process": 0, "f": "txn",
                     "value": [["append", 0, 2]]},
                    {"type": "ok", "process": 1, "f": "txn",
                     "value": [["r", 0, [2]], ["r", 1, [1.5, 2]]]}],
    "float_spine": [{"type": "ok", "process": 0, "f": "txn",
                     "value": [["append", 0, 2], ["r", 0, [0.5, 2]]]}],
}


@pytest.mark.parametrize("name", sorted(OUT_OF_REGIME))
def test_parse_columns_none_out_of_regime(name):
    h = OUT_OF_REGIME[name]
    assert ref_columnar.parse_columns(h) is None
    assert columnar.parse_columns(h) is None


def _graph_form(parts):
    graph, txns, extras, n_keys = parts
    return (graph.n, graph.edge_list(), graph.time_order.tolist()
            if graph.time_order is not None else None, txns,
            dict(extras), n_keys)


@pytest.mark.parametrize("case", HISTORIES[::4], ids=lambda c: c[0])
def test_c_front_builds_the_numpy_fronts_graph(case):
    h = case[1]()
    out = columnar_c.mod().parse(h)
    assert out is not None
    assert _graph_form(columnar._build_from_c(out)) == \
        _graph_form(columnar._build_py(h))
    assert _graph_form(columnar._build(h)) == \
        _graph_form(columnar._build_py(h))


@pytest.mark.parametrize("case", HISTORIES[::2], ids=lambda c: c[0])
def test_list_append_through_c_front_matches_jax(case):
    h = case[1]()
    got = list_append.check(h, accelerator="auto", device="cpu")
    assert got.get("builder") == "columnar"
    assert got == ref_la.check(h, accelerator="auto")


def test_parse_regime_misses_take_the_numpy_front(monkeypatch):
    """None and the TypeError, ValueError and OverflowError of ``parse``
    go to the numpy front; any other error propagates."""
    h = clean_history(1)
    want = _graph_form(columnar._build_py(h))

    class Fake:
        def __init__(self, exc):
            self.exc = exc

        def parse(self, history):
            if self.exc is None:
                return None
            raise self.exc

    for exc in (None, TypeError("t"), ValueError("v"), OverflowError("o")):
        monkeypatch.setattr(columnar, "_cmod", lambda e=exc: Fake(e))
        assert _graph_form(columnar._build(h)) == want
        assert exc is not None or columnar.parse_columns(h) is None
    monkeypatch.setattr(columnar, "_cmod",
                        lambda: Fake(MemoryError("m")))
    with pytest.raises(MemoryError):
        columnar._build(h)
    with pytest.raises(MemoryError):
        columnar.parse_columns(h)


def test_failed_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "columnar_ext.c"
    broken.write_text(columnar_c.SRC.read_text()
                      + "\nthis is not C++;\n")
    monkeypatch.setattr(columnar_c, "SRC", broken)
    monkeypatch.setattr(columnar_c, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(columnar_c, "_MOD", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        columnar_c.mod()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        list_append.check(clean_history(0), accelerator="gpu",
                          device="cpu")
    assert not list((tmp_path / "build").glob("*.so"))


def test_module_name_differs_from_the_references():
    """Both packages' parsers load in one process."""
    from jepsen_tpu.native import columnar_c as ref_columnar_c
    assert columnar_c.mod().__name__ == "_columnar_c_torch"
    assert ref_columnar_c.mod().__name__ == "_columnar_c"
