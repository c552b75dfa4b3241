"""The artifacts of an invalid verdict, jepsen_tpu_torch against jepsen_tpu
on the CPU: ``plot`` (``linear.png``) and ``explain``'s ``artifacts``
(``anomaly.json``, ``witness-timeline.html``) of an invalid
linearizable check and of an invalid key of an independent check, in
the batched lane and key by key, each in a store dir of its own; the
payload ``explain.compose_anomaly`` composes; and a suite's composed
check (stats, exceptions, the lifted register workload with its
timeline, perf, clock) whose whole result map equals the JAX package's
with only the algorithm names mapped, and whose files are the same:
HTML byte for byte, ``anomaly.json`` as JSON (without the forensics'
own wall time), PNGs pixel for pixel."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from jepsen_tpu_torch.histories import (
    corrupt_keys, corrupt_reads, independent_register_history,
    register_history, stamp_times, with_nemesis,
)

TS = "20261018T000000.000"
# the JAX package's algorithm names, by the port's rung or lane
REF_ALGORITHM = {"torch-frontier": "jitlin-tpu",
                 "torch-matrix": "jitlin-tpu-matrix",
                 "jitlin-gpu": "jitlin-tpu"}


@pytest.fixture(autouse=True)
def _pyplot_registry_lock(monkeypatch):
    """The JAX package draws through pyplot, whose figure registry
    (numbering, current figure) its checkers share across a Compose's
    threads; one lock around figure creation and closing keeps its
    threads' figures apart. The port draws on figures of its own."""
    import threading

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    lock = threading.Lock()
    for name in ("subplots", "close"):
        real = getattr(plt, name)

        def locked(*a, _real=real, **k):
            with lock:
                return _real(*a, **k)
        monkeypatch.setattr(plt, name, locked)


@pytest.fixture
def small_matrix_regime(monkeypatch):
    """Admits short histories to both packages' matrix rung, the JAX
    package's Pallas kernels in interpret mode."""
    import jepsen_tpu.ops.jitlin as ref_jitlin
    import jepsen_tpu.ops.pallas_matrix as pm
    from jepsen_tpu_torch.ops import jitlin
    monkeypatch.setattr(pm, "FORCE_INTERPRET", True)
    for mod in (ref_jitlin, jitlin):
        monkeypatch.setattr(mod, "MATRIX_MIN_RETURNS", 10)


def _run_dir(root: Path, rows=()):
    """A test map on its own store dir under ``root``, with ``rows`` as the
    run's faults.jsonl."""
    test = {"name": "suite", "start_time": TS, "store_dir": str(root)}
    d = root / "suite" / TS
    d.mkdir(parents=True)
    (d / "faults.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows))
    return test, d


def _files(d: Path) -> list[str]:
    return sorted(str(p.relative_to(d)) for p in d.rglob("*")
                  if p.is_file() and p.name != "check.ckpt")


def _same_files(a: Path, b: Path) -> None:
    """Every file of run dir ``a`` is in ``b``, the same: PNG pixels,
    anomaly.json without its wall time, the rest byte for byte."""
    import matplotlib.image as mpimg
    assert _files(a) == _files(b)
    for f in _files(a):
        x, y = a / f, b / f
        if f.endswith(".png"):
            px, py = mpimg.imread(x), mpimg.imread(y)
            assert px.shape == py.shape and np.array_equal(px, py), f
        elif f.endswith("anomaly.json"):
            jx, jy = json.loads(x.read_text()), json.loads(y.read_text())
            for j in (jx, jy):
                j.pop("explain_latency_seconds")
            assert jx == jy, f
        else:
            assert x.read_bytes() == y.read_bytes(), f


def _mapped(result, run_dir: Path):
    """A result map with the port's algorithm names taken back to the
    reference's and ``plot`` paths made relative to the run dir."""
    if isinstance(result, dict):
        out = {}
        for k, v in result.items():
            if k == "algorithm":
                v = REF_ALGORITHM.get(v, v)
            elif k == "plot" and v is not None:
                v = str(Path(v).relative_to(run_dir))
            out[k] = _mapped(v, run_dir)
        return out
    if isinstance(result, list):
        return [_mapped(v, run_dir) for v in result]
    return result


def _timed_bad(n_ops, seed, bad=2):
    h = corrupt_reads(register_history(n_ops, n_procs=5, seed=seed,
                                       n_values=5), n=bad, seed=seed)
    h = stamp_times(h, seed=seed)
    first = next(i for i, op in enumerate(h) if op["value"] == 999)
    return with_nemesis(
        h, [(10, 40, "start", "stop"),
            (max(0, first - 30), first + 30, "start-partition",
             "stop-partition")],
        offsets_at=(3, first), seed=seed)


@pytest.mark.parametrize("lane", ["cpu", "frontier", "matrix"])
def test_invalid_check_writes_the_reference_artifacts(tmp_path, lane,
                                                      request):
    from jepsen_tpu.checker.linearizable import linearizable as ref_lin
    from jepsen_tpu_torch.checker.linearizable import linearizable
    if lane == "matrix":
        request.getfixturevalue("small_matrix_regime")
    h, rows = _timed_bad(300, seed=4)
    port_kw = ({"accelerator": "cpu"} if lane == "cpu"
               else {"accelerator": "gpu", "device": "cpu"})
    ref_acc = "cpu" if lane == "cpu" else "tpu"
    ref_test, ref_d = _run_dir(tmp_path / "ref", rows)
    test, d = _run_dir(tmp_path / "port", rows)
    want = ref_lin(accelerator=ref_acc).check(ref_test, h,
                                              {"checker_sharded": False})
    got = linearizable(**port_kw).check(test, h, {})
    assert got["valid?"] is False
    assert got["plot"] == str(d / "linear.png")
    assert got["explain"]["artifacts"] == ["anomaly.json",
                                           "witness-timeline.html"]
    assert _mapped(got, d) == _mapped(want, ref_d)
    _same_files(ref_d, d)
    anomaly = json.loads((d / "anomaly.json").read_text())
    assert anomaly["first_anomaly"]["op_index"] == \
        got["explain"]["first-anomaly-op"]
    assert [w["f"] for w in anomaly["fault_windows"]
            if w["overlaps_witness"]] == ["start-partition"]
    if lane == "matrix":
        assert got["algorithm"] == "torch-matrix"
        assert got["explain"]["backend"] == "matrix-bisect"


def test_no_store_dir_no_artifacts():
    """A test map that addresses no store dir: ``plot`` None and no
    artifacts, as in the reference; the verdict stands."""
    from jepsen_tpu.checker.linearizable import linearizable as ref_lin
    from jepsen_tpu_torch.checker.linearizable import linearizable
    h, _ = _timed_bad(200, seed=6)
    for test in ({}, None):
        got = linearizable(accelerator="cpu").check(test, h, {})
        want = ref_lin(accelerator="cpu").check(test, h, {})
        assert got["valid?"] is False and got["plot"] is None
        assert got == want


def _lifted(n_keys=4, n_ops=60, bad=(2,)):
    h = corrupt_keys(independent_register_history(n_keys, n_ops, n_procs=3),
                     list(bad))
    h = stamp_times(h, seed=9)
    return with_nemesis(h, [(20, 200, "start-partition", "stop-partition")],
                        offsets_at=(5, 300), seed=9)


@pytest.mark.parametrize("lane", ["batched", "per-key"])
def test_independent_keys_write_the_reference_artifacts(tmp_path, lane):
    from jepsen_tpu import independent as ref_ind
    from jepsen_tpu.checker.linearizable import linearizable as ref_lin
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable
    h, rows = _lifted(bad=(1, 2))
    port_kw, ref_acc = (({"accelerator": "gpu", "device": "cpu"}, "tpu")
                        if lane == "batched" else ({"accelerator": "cpu"},
                                                   "cpu"))
    ref_test, ref_d = _run_dir(tmp_path / "ref", rows)
    test, d = _run_dir(tmp_path / "port", rows)
    want = ref_ind.checker(ref_lin(accelerator=ref_acc)).check(
        ref_test, h, {"checker_sharded": False})
    got = independent.checker(linearizable(**port_kw)).check(test, h, {})
    assert got["failures"] == ["1", "2"]
    want = _mapped(want, ref_d)
    if lane == "per-key":
        # the port renders each invalid key's linear.png under its
        # independent/<k>, where the reference renders every key's to the
        # run's one linear.png (ROADMAP Queue 3 item 6)
        for k in ("1", "2"):
            assert want["results"][k]["plot"] == "linear.png"
            want["results"][k]["plot"] = f"independent/{k}/linear.png"
    assert _mapped(got, d) == want
    for k in ("1", "2"):
        assert got["results"][k]["explain"]["artifacts"] == [
            "anomaly.json", "witness-timeline.html"]
        assert (d / "independent" / k / "anomaly.json").exists()
    # a key's sub-history holds no nemesis op: no fault window per key
    assert json.loads((d / "independent" / "1" / "anomaly.json"
                       ).read_text())["fault_windows"] == []
    # the per-key lane renders one linear.png under each invalid key's
    # independent/<k> and none at the run's top (the reference renders
    # both keys to the top's one path); the batched lane renders none
    pngs = [f for f in _files(d) if f.endswith("linear.png")]
    assert pngs == ([f"independent/{k}/linear.png" for k in ("1", "2")]
                    if lane == "per-key" else [])
    assert ("linear.png" in _files(ref_d)) is (lane == "per-key")
    if lane == "per-key":
        # the rest equals the reference's files
        for f in pngs:
            (d / f).unlink()
        (ref_d / "linear.png").unlink()
    _same_files(ref_d, d)


def test_compose_anomaly_matches_jax():
    from jepsen_tpu.checker import explain as ref
    from jepsen_tpu_torch.checker import explain
    h, rows = _timed_bad(300, seed=7)
    first = next(i for i, op in enumerate(h) if op.get("value") == 999)
    forensics = {"first_anomaly": {"event": 17, "op_index": first},
                 "witness": {"op_indices": list(range(0, 500, 2)),
                             "context_op_indices": [1]},
                 "backend": "matrix-bisect", "bisect_steps": 3}
    got = explain.compose_anomaly(h, forensics, registry_rows=rows)
    assert got == ref.compose_anomaly(h, forensics, registry_rows=rows)
    assert got["witness"]["ops_truncated"] == 250 - explain.MAX_DETAIL_OPS
    assert explain.compose_anomaly(None, forensics) == \
        ref.compose_anomaly(None, forensics)
    assert (explain.ANOMALY_NAME, explain.WITNESS_TIMELINE_NAME) == (
        ref.ANOMALY_NAME, ref.WITNESS_TIMELINE_NAME)
    for test in (None, {}, {"name": "no-start-time"}):
        assert explain.write_artifacts(test, h, forensics) == \
            ref.write_artifacts(test, h, forensics) == {}


def _suite(pkg, lin_kw):
    """A suite's composed check as ``suites.compose_test`` and the register
    workload compose it, in package ``pkg`` ("ref" or "port")."""
    if pkg == "ref":
        from jepsen_tpu import checker as c
        from jepsen_tpu import independent as ind
        from jepsen_tpu.checker.linearizable import linearizable
        from jepsen_tpu.models import CASRegister
    else:
        from jepsen_tpu_torch import checker as c
        from jepsen_tpu_torch import independent as ind
        from jepsen_tpu_torch.checker.linearizable import linearizable
        from jepsen_tpu_torch.models import CASRegister
    workload = ind.checker(c.compose({
        "linear": linearizable(model=CASRegister(), **lin_kw),
        "timeline": c.timeline_html()}))
    return c.compose({"stats": c.stats(),
                      "exceptions": c.unhandled_exceptions(),
                      "workload": workload, "perf": c.perf(),
                      "clock": c.clock_plot()})


@pytest.mark.parametrize("lane", ["batched", "per-key"])
def test_composed_suite_matches_jax(tmp_path, lane):
    """19a's shape at 4 keys of 60 ops, one key corrupted, with a run's
    clock, a nemesis window and its registry rows: the whole result map
    and every file equal the JAX package's."""
    h, rows = _lifted()
    port_kw, ref_acc = (({"accelerator": "gpu", "device": "cpu"}, "tpu")
                        if lane == "batched" else ({"accelerator": "cpu"},
                                                   "cpu"))
    ref_test, ref_d = _run_dir(tmp_path / "ref", rows)
    test, d = _run_dir(tmp_path / "port", rows)
    want = _suite("ref", {"accelerator": ref_acc}).check(
        ref_test, h, {"checker_sharded": False})
    got = _suite("port", port_kw).check(test, h, {})
    assert got["valid?"] is False
    assert got["workload"]["failures"] == ["2"]
    assert got["stats"]["valid?"] is True and got["clock"] == {
        "valid?": True}
    if lane == "batched":
        assert got["workload"]["results"]["2"]["linear"]["algorithm"] == \
            "jitlin-gpu"
    want = _mapped(want, ref_d)
    if lane == "per-key":
        # the invalid key's linear.png goes under its independent/2, where
        # the reference writes it at the run's top (ROADMAP Queue 3 item
        # 6); one key is invalid, so the two files hold the same pixels
        lin = want["workload"]["results"]["2"]["linear"]
        assert lin["plot"] == "linear.png"
        lin["plot"] = "independent/2/linear.png"
        assert "linear.png" not in _files(d)
        (ref_d / "linear.png").rename(ref_d / "independent/2/linear.png")
    assert _mapped(got, d) == want
    assert {"clock-skew.png", "latency-raw.png", "latency-quantiles.png",
            "rate.png", "independent/2/anomaly.json",
            "independent/2/witness-timeline.html"} <= set(_files(d))
    assert [f"independent/{k}/timeline.html" for k in range(4)] == [
        f for f in _files(d) if f.endswith("/timeline.html")]
    _same_files(ref_d, d)
