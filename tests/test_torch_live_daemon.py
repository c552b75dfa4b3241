"""The port's live daemon (``live/daemon.py``) on the CPU
(``device="cpu"``), against jepsen_tpu's ``LiveDaemon`` on a copy of the
same store, tolerance zero: run discovery, the register, multi-key and
list-append runs' statuses poll by poll and their final verdicts (equal
to the offline checks'), a workload with no live checker (lag only),
the per-run breaker, a restart that resumes from ``live-session.ckpt``
(and one whose WAL diverged), the top-K ``run="other"`` metric fold, the
``live-metrics.prom`` export, a torn WAL line's rebuild at finalize,
the admission budget, and the poller thread's start and stop. WALs are
written in chunks between polls, so no test waits on a clock."""
from __future__ import annotations

import json
import sys
import time

import pytest
import torch

from jepsen_tpu_torch.histories import (
    corrupt_reads, elle_history, independent_register_history,
    register_history,
)
from jepsen_tpu_torch.live import daemon as daemon_mod
from jepsen_tpu_torch.live.daemon import (
    LiveDaemon, RunTracker, load_live_status)

TS = "20260803T000000.000"
# status keys that hold times or the rung's label (the port's rung names
# differ from the reference's: ROADMAP, Queue 3)
UNCOMPARED = ("lag_s", "updated", "backend")


@pytest.fixture(autouse=True)
def isolated_rates():
    """One torch thread, and both packages' measured CPU rates (which
    the daemons feed) restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    names = ("jepsen_tpu_torch.parallel.pipeline",
             "jepsen_tpu.parallel.pipeline")
    saved = {m: dict(sys.modules[m]._CPU_RATE) for m in names
             if m in sys.modules}
    yield
    torch.set_num_threads(n)
    for m in names:
        if m in sys.modules:
            sys.modules[m]._CPU_RATE.clear()
            sys.modules[m]._CPU_RATE.update(saved.get(m, {}))


def _lines(ops) -> str:
    return "".join(json.dumps(op) + "\n" for op in ops)


class Store:
    """A store root whose runs' WALs grow chunk by chunk."""

    def __init__(self, root, runs: dict):
        self.root, self.runs = root, runs
        for name in runs:
            (root / name / TS).mkdir(parents=True)
            (root / name / TS / "history.wal.jsonl").touch()

    def run_dir(self, name):
        return self.root / name / TS

    def append(self, name, lo, hi) -> None:
        with open(self.run_dir(name) / "history.wal.jsonl", "a") as f:
            f.write(_lines(self.runs[name][lo:hi]))

    def complete(self, name) -> None:
        (self.run_dir(name) / "history.jsonl").write_text(
            _lines(self.runs[name]))


def _strip(status: dict) -> dict:
    return {k: v for k, v in status.items() if k not in UNCOMPARED}


def _drive(stores_and_daemons, runs, chunk):
    """Appends each run's next chunk to every store, then polls every
    daemon; completes the runs and polls until idle. Returns each
    daemon's poll statuses."""
    longest = max(len(h) for h in runs.values())
    polls = [[] for _ in stores_and_daemons]
    for lo in range(0, longest, chunk):
        for (store, d), out in zip(stores_and_daemons, polls):
            for name in runs:
                store.append(name, lo, lo + chunk)
            out.append(d.poll_once())
    for (store, d), out in zip(stores_and_daemons, polls):
        for name in runs:
            store.complete(name)
        out.append(d.run_until_idle(timeout_s=60))
    return polls


def test_daemon_matches_jax_on_one_store(tmp_path):
    """Four runs under one store root, discovered and tailed poll by poll
    by the port's daemon and by the reference's on a copy of the store:
    every poll's statuses equal, and each run's final verdict the
    offline check's."""
    from jepsen_tpu.live.daemon import LiveDaemon as RefDaemon
    from jepsen_tpu.live.daemon import load_live_status as ref_load
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.elle import list_append
    reg = register_history(400, n_procs=5, seed=11, n_values=5)
    runs = {"reg": reg, "bad": corrupt_reads(reg, n=2, seed=4),
            "keys": independent_register_history(6, 50, seed=1300),
            "append": [dict(op, f="txn") for op in
                       elle_history(120, n_keys=7, crossed_pairs=1)]}
    port = Store(tmp_path / "port", runs)
    ref = Store(tmp_path / "ref", runs)
    d = LiveDaemon(store_root=str(port.root), accelerator="cpu",
                   device="cpu", poll_s=0.0)
    rd = RefDaemon(store_root=str(ref.root), accelerator="cpu", poll_s=0.0)
    got, want = _drive([(port, d), (ref, rd)], runs, chunk=150)
    assert len(got) == len(want) > 5
    for g, w in zip(got, want):
        assert {k: _strip(v) for k, v in g.items()} == \
            {k: _strip(v) for k, v in w.items()}
    assert not d.trackers and not rd.trackers
    finals = {name: load_live_status(port.run_dir(name)) for name in runs}
    for name in runs:
        assert _strip(finals[name]) == _strip(ref_load(ref.run_dir(name)))
        assert finals[name]["state"] == "final"
        assert finals[name]["ops_absorbed"] == len(runs[name])
    lin = linearizable(accelerator="cpu", device="cpu")
    for name in ("reg", "bad"):
        want_r = lin.check({}, runs[name], {"explain": False})
        res = finals[name]["results"]
        assert res["valid?"] is want_r["valid?"] is (name == "reg")
        if name == "bad":
            first = finals[name]["first_anomaly_op"]
            assert res["failed-op-index"] == first
            assert all(runs[name][first][k] == v
                       for k, v in want_r["failed-op"].items())
    ind = independent.checker(lin).check({}, runs["keys"], {})
    assert finals["keys"]["results"]["valid?"] is ind["valid?"] is True
    la = list_append.check(runs["append"], accelerator="cpu", device="cpu")
    assert finals["append"]["results"]["valid?"] is la["valid?"] is False
    assert finals["append"]["results"]["anomaly-types"] == \
        la["anomaly-types"]
    assert finals["append"]["workload"] == "list-append"
    prom = (port.root / "live-metrics.prom").read_text()
    for metric in ("live_checker_lag_ops", "live_checker_lag_s",
                   "live_verdict", "live_first_anomaly_op",
                   "live_runs_active", "live_poll_seconds",
                   "live_ops_tailed_total", "fleet_invalid_runs"):
        assert metric in prom, metric
    rows = [json.loads(ln) for ln in
            (port.root / "live-metrics.json").read_text().splitlines()]
    assert {"live_verdict", "live_polls_total"} <= {r["name"] for r in rows}


def test_unsupported_workload_reports_lag_only(tmp_path):
    h = [{"type": t, "process": 0, "f": "txn", "value": [["w", 1, i]],
          "time": i} for i in range(30) for t in ("invoke", "ok")]
    store = Store(tmp_path, {"unsup": h})
    store.append("unsup", 0, len(h))
    d = LiveDaemon(store_root=str(tmp_path), accelerator="cpu",
                   device="cpu")
    d.poll_once()
    status = load_live_status(store.run_dir("unsup"))
    assert (status["state"], status["workload"], status["valid_so_far"],
            status["ops_absorbed"]) == ("untracked", None, None, len(h))
    store.complete("unsup")
    d.poll_once()
    status = load_live_status(store.run_dir("unsup"))
    assert status["state"] == "final" and status["valid_so_far"] is None
    assert "results" not in status and not d.trackers


def test_breaker_opens_after_threshold_failing_polls(tmp_path,
                                                     monkeypatch):
    h = register_history(60, n_procs=3, seed=1, n_values=4)
    store = Store(tmp_path, {"bad": h})
    store.append("bad", 0, 40)
    d = LiveDaemon(store_root=str(tmp_path), accelerator="cpu",
                   device="cpu")
    d.poll_once()
    (tr,) = d.trackers.values()

    def boom():
        raise RuntimeError("kaboom")
    monkeypatch.setattr(tr.session, "verdict", boom)
    for i in range(daemon_mod.LIVE_BREAKER_THRESHOLD):
        assert not tr.broken
        store.append("bad", 40 + i, 41 + i)  # pending work each poll
        d.poll_once()
    assert tr.broken and "kaboom" in tr.broken
    status = load_live_status(store.run_dir("bad"))
    assert status["state"] == "error" and "kaboom" in status["error"]
    prom = (tmp_path / "live-metrics.prom").read_text()
    assert 'live_run_breaker_open{run="bad/%s"} 1' % TS in prom


def test_restart_resumes_from_the_snapshot(tmp_path, monkeypatch):
    """A daemon stopped mid-run leaves ``live-session.ckpt``; the next
    daemon resumes at its WAL offset, and the run ends with the verdict
    of a daemon that ran throughout. A WAL rewritten under the snapshot
    is re-ingested."""
    monkeypatch.setattr(daemon_mod, "SNAPSHOT_MIN_INTERVAL_S", 0.0)
    h = corrupt_reads(register_history(300, n_procs=4, seed=8,
                                       n_values=5), n=1, seed=2)
    half = len(h) // 2
    finals = {}
    for case in ("throughout", "resumed", "diverged"):
        store = Store(tmp_path / case, {"reg": h})
        store.append("reg", 0, half)
        d = LiveDaemon(store_root=str(store.root), accelerator="cpu",
                       device="cpu")
        d.poll_once()
        if case != "throughout":
            ckpt = json.loads((store.run_dir("reg") /
                               daemon_mod.LIVE_CKPT_NAME).read_text())
            assert ckpt["ops_absorbed"] == half
            d.stop()
            if case == "diverged":
                wal = store.run_dir("reg") / "history.wal.jsonl"
                wal.write_text(wal.read_text().replace('"process": 0',
                                                       '"process":  0', 1))
            d = LiveDaemon(store_root=str(store.root), accelerator="cpu",
                           device="cpu")
            assert d.discover() == 1
            (tr,) = d.trackers.values()
            assert tr.resumed is (case == "resumed")
            assert tr.tailer.offset == (ckpt["offset"] if case == "resumed"
                                        else 0)
        store.append("reg", half, len(h))
        store.complete("reg")
        d.run_until_idle(timeout_s=60)
        finals[case] = load_live_status(store.run_dir("reg"))
        assert not (store.run_dir("reg") / daemon_mod.LIVE_CKPT_NAME).exists()
        counts = {r["name"]: r["value"] for r in d.registry.snapshot()
                  if r["name"].startswith("live_session_resume")}
        assert counts == {"throughout": {}, "resumed": {
            "live_session_resumes_total": 1.0}, "diverged": {
            "live_session_resume_rejected_total": 1.0}}[case]
    for case in ("resumed", "diverged"):
        assert finals[case]["results"] == finals["throughout"]["results"]
        assert finals[case]["ops_absorbed"] == len(h)
    assert finals["throughout"]["results"]["valid?"] is False


def test_top_k_run_series_fold_into_other(tmp_path, monkeypatch):
    monkeypatch.setattr(daemon_mod, "DEFAULT_RUN_SERIES_TOPK", 2)
    runs = {f"r{k}": register_history(30 + 10 * k, n_procs=3, seed=k,
                                      n_values=4) for k in range(4)}
    runs["r3"] = corrupt_reads(runs["r3"], n=1, seed=0)
    store = Store(tmp_path, runs)
    for name, h in runs.items():
        store.append(name, 0, len(h) - 3)  # open invokes: some lag
    d = LiveDaemon(store_root=str(tmp_path), accelerator="cpu",
                   device="cpu")
    statuses = d.poll_once()
    rows = [r for r in d.registry.snapshot()
            if r["name"] in ("live_checker_lag_ops", "live_verdict")]
    lag = {r["labels"]["run"]: r["value"] for r in rows
           if r["name"] == "live_checker_lag_ops"}
    ranked = sorted(statuses.values(), key=lambda s: s["lag_ops"],
                    reverse=True)
    top = {f"{s['name']}/{TS}": s["lag_ops"] for s in ranked[:2]}
    assert lag == {**top, "other": max(s["lag_ops"] for s in ranked[2:])}
    verdict = {r["labels"]["run"]: r["value"] for r in rows
               if r["name"] == "live_verdict"}
    rest = [s["valid_so_far"] for s in ranked[2:]]
    assert verdict["other"] == (0.0 if False in rest else 1.0)
    assert set(verdict) == set(lag)
    # the per-run counters keep the first two runs' labels
    tailed = {r["labels"]["run"] for r in d.registry.snapshot()
              if r["name"] == "live_ops_tailed_total"}
    assert len(tailed) == 3 and "other" in tailed


def test_finalize_rebuilds_after_a_torn_wal_line(tmp_path):
    """A torn mid-WAL line: finalize rebuilds from ``history.jsonl``, so
    the anomaly inside the torn op is still found at its index."""
    from jepsen_tpu_torch.checker.linear_cpu import check_stream
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    h = corrupt_reads(register_history(120, n_procs=4, seed=12,
                                       n_values=5), n=1, seed=3)
    planted = check_stream(encode_register_ops(h)).failed_op_index
    run_dir = tmp_path / "torn" / TS
    run_dir.mkdir(parents=True)
    with open(run_dir / "history.wal.jsonl", "w") as f:
        for i, op in enumerate(h):
            line = json.dumps(op)
            f.write(line[: len(line) // 2] + "\n" if i == planted
                    else line + "\n")
    (run_dir / "history.jsonl").write_text(_lines(h))
    tr = RunTracker(run_dir, accelerator="cpu", device="cpu")
    tr.tail()
    assert tr.tailer.torn_skipped == 1
    results = tr.finalize()
    assert results["valid?"] is False
    assert results["failed-op-index"] == planted
    assert tr.ops_absorbed == len(h)


def test_admission_defers_and_does_not_starve(tmp_path):
    from jepsen_tpu_torch.parallel.pipeline import CostModel
    runs = {f"r{k}": register_history(120, n_procs=3, seed=20 + k,
                                      n_values=4) for k in range(2)}
    store = Store(tmp_path, runs)
    d = LiveDaemon(store_root=str(tmp_path), accelerator="cpu",
                   device="cpu", check_budget_s=0.001,
                   cost_model=CostModel(cpu_events_per_sec_=1000.0))
    _drive([(store, d)], runs, chunk=20)
    for name in runs:
        s = load_live_status(store.run_dir(name))
        assert s["state"] == "final" and s["results"]["valid?"] is True
    deferred = [r for r in d.registry.snapshot()
                if r["name"] == "live_admission_deferred_total"]
    assert deferred and sum(r["value"] for r in deferred) > 0


def test_poller_thread_finalizes_and_stops(tmp_path):
    h = register_history(80, n_procs=3, seed=5, n_values=4)
    store = Store(tmp_path, {"reg": h})
    store.append("reg", 0, len(h))
    store.complete("reg")
    d = LiveDaemon(store_root=str(tmp_path), accelerator="cpu",
                   device="cpu", poll_s=0.01, run_dirs=[store.run_dir("reg")])
    d.start()
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            status = load_live_status(store.run_dir("reg"))
            if status and status["state"] == "final":
                break
            time.sleep(0.01)
    finally:
        t0 = time.monotonic()
        d.stop()
    assert time.monotonic() - t0 < 5 and d._thread is None
    assert status["state"] == "final" and status["results"]["valid?"]


def test_poll_check_and_finalize_slices_on_the_live_track(tmp_path):
    from jepsen_tpu_torch import trace
    from jepsen_tpu_torch.trace.flight import FlightRecorder
    h = register_history(40, n_procs=3, seed=4, n_values=4)
    store = Store(tmp_path, {"reg": h})
    store.append("reg", 0, len(h) // 2)
    d = LiveDaemon(store_root=str(tmp_path), accelerator="cpu",
                   device="cpu")
    tracer = trace.RunTracer(flight=FlightRecorder(64))
    with trace.use(tracer):
        d.poll_once()
        store.append("reg", len(h) // 2, len(h))
        store.complete("reg")
        d.poll_once()
    events = [(e["track"], e["name"], e["args"]) for e in
              tracer.flight.snapshot()]
    assert [(t, n) for t, n, _ in events] == [
        ("live", "check"), ("live", "poll"), ("live", "finalize"),
        ("live", "poll")]
    assert events[0][2]["run"] == events[2][2]["run"] == f"reg/{TS}"
    assert events[1][2] == events[3][2] == {"runs": 1}


def test_max_runs_bounds_admission(tmp_path):
    """At ``max_runs`` trackers discovery admits no more runs (counted);
    a run that settles frees its place for the next."""
    runs = {f"r{k}": register_history(40, n_procs=3, seed=30 + k,
                                      n_values=4) for k in range(3)}
    store = Store(tmp_path, runs)
    for name in runs:
        store.append(name, 0, len(runs[name]))
    d = LiveDaemon(store_root=str(tmp_path), accelerator="cpu",
                   device="cpu", max_runs=2)
    d.poll_once()
    assert len(d.trackers) == 2
    rejected = [r["value"] for r in d.registry.snapshot()
                if r["name"] == "live_admission_rejected_total"]
    assert rejected == [1.0]
    tracked = {tr.name for tr in d.trackers.values()}
    for name in tracked:
        store.complete(name)
    d.poll_once()  # settles the two
    assert not d.trackers
    d.poll_once()  # the third takes a free place
    waiting = set(runs) - tracked
    assert {tr.name for tr in d.trackers.values()} == waiting
    for name in waiting:
        store.complete(name)
    d.run_until_idle(timeout_s=60)
    for name, h in runs.items():
        s = load_live_status(store.run_dir(name))
        assert s["state"] == "final", name
        assert s["results"]["valid?"] is True and s["ops_absorbed"] == len(h)


def test_completed_run_is_left_to_post_hoc_checks(tmp_path):
    """A run whose ``history.jsonl`` exists before the daemon first sees
    it is not tracked (unless named), nor one a daemon already settled."""
    h = register_history(20, n_procs=2, seed=3, n_values=3)
    store = Store(tmp_path, {"done": h, "settled": h})
    for name in ("done", "settled"):
        store.append(name, 0, len(h))
        store.complete(name)
    (store.run_dir("settled") / daemon_mod.LIVE_STATUS_NAME).write_text(
        json.dumps({"state": "final"}))
    d = LiveDaemon(store_root=str(tmp_path), accelerator="cpu",
                   device="cpu")
    assert d.discover() == 0 and d.discover() == 0
    d2 = LiveDaemon(store_root=None, run_dirs=[store.run_dir("done")],
                    accelerator="cpu", device="cpu")
    assert d2.discover() == 1


@pytest.mark.cuda
def test_daemon_screens_on_card(tmp_path, monkeypatch):
    """The daemon's register sessions on the card: each poll's statuses
    equal a CPU daemon's on a copy of the store, the screened polls
    launch the chunk-product and combine kernels, and the corrupted
    copy's final verdict is the CPU twin's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from jepsen_tpu_torch.ops import matrix_kernels as mk
    monkeypatch.setattr(daemon_mod, "SNAPSHOT_MIN_INTERVAL_S", 0.0)
    h = register_history(4000, n_procs=5, seed=42, n_values=5)
    runs = {"reg": h, "bad": corrupt_reads(h, n=2, seed=0)}
    card, cpu = Store(tmp_path / "card", runs), Store(tmp_path / "cpu", runs)
    d = LiveDaemon(store_root=str(card.root), accelerator="gpu", poll_s=0.0)
    c = LiveDaemon(store_root=str(cpu.root), accelerator="cpu",
                   device="cpu", poll_s=0.0)
    mk.chunk_product.launches = mk.combine_product.launches = 0
    got, want = _drive([(card, d), (cpu, c)], runs, chunk=1000)
    assert mk.chunk_product.launches >= 2 and mk.combine_product.launches >= 2
    for g, w in zip(got, want):
        assert {k: _strip(v) for k, v in g.items()} == \
            {k: _strip(v) for k, v in w.items()}
    assert load_live_status(card.run_dir("bad"))["results"]["valid?"] is False
