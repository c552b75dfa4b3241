"""jepsen_tpu_torch's telemetry registry (``telemetry.py``) against
jepsen_tpu's on the CPU, and the instruments of the port's check path.

* The registry: one numpy-seeded sequence of instrument calls (inc, set,
  set_max, dec, observe, the single-writer cells and observers, events,
  and the type and label conflicts) goes into both packages' registries:
  ``render_prom()`` text, ``snapshot()`` rows, ``quantile()`` values and
  ``export`` files are equal (tolerance zero; the events' clock is
  patched to one value in both).
* The device memory helper returns None for a CPU device without
  touching ``torch.cuda``, and reads the allocator's nested peak for a
  CUDA one.
* The check path: the port on ``device="cpu"`` and the reference on the
  CPU (its Pallas kernels in interpret mode), each with a live registry
  and tracer, on a headline-shaped history, its corrupted copy with
  ``explain`` on, a segmented check that writes ``check.ckpt`` and the
  check that resumes from it, and a small key batch: the same metric
  families, label sets and counts and the same trace events and args,
  apart from times, under the rung and algorithm name maps of ROADMAP.md
  (Queue 3, divergences), whose other differences are listed in
  ``REF_ONLY``, ``PORT_ONLY`` and ``PHASES``.
* Off by default: the ``NULL`` registry and ``NULL_TRACER`` do no work
  through a whole check; a kernel that fails raises through a check with
  a live registry and tracer.
* On the card (``cuda``-marked, skipped here): the memory gauge after a
  card check, and ``profiler_trace`` naming the matrix kernels.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

# the reference's ladder rungs -> the port's (ROADMAP.md, Queue 3)
RUNGS = {"sharded-matrix": "torch-sharded-matrix",
         "pallas-matrix": "torch-matrix", "jitlin-device": "torch-frontier",
         "native-c": "native-c", "cpu": "cpu"}
# the reference's algorithm names -> the port's
ALGORITHMS = {"jitlin-tpu-matrix": "torch-matrix",
              "jitlin-tpu-matrix-sharded": "torch-sharded-matrix",
              "jitlin-tpu": "torch-frontier"}
# families the reference's check path emits and the port's does not: its
# Pallas self-test probe (the port has none), the kernel variant its phase
# split carries (the port's kernels have one representation), and its
# modeled dense f32 FLOP/s and their share of a published peak (the
# port's kernels compute no such products)
REF_ONLY = {"pallas_probe_seconds_total", "checker_matrix_variant_total",
            "checker_achieved_matmul_flops", "checker_roofline_frac"}
# the port's matrix_check_batch pipelines every batch, one history
# included (the reference only batches of more than MATRIX_PIPELINE_KEYS
# keys): its dispatch_* instruments count a single-history check too
PORT_ONLY = {"dispatch_batches_total", "dispatch_inflight",
             "dispatch_inflight_peak", "dispatch_overlap_frac",
             "dispatch_stall_seconds", "dispatch_sync_seconds"}
# the phase labels of checker_matrix_phase_seconds: the numeric keys of
# each package's last_phase_seconds()
PHASES = {"ref": {"prepass", "grids", "dispatch", "fetch"},
          "port": {"prepass", "grids", "dispatch", "fetch", "sub_batches"}}
# gauges whose values the data fixes (the others hold times and rates)
EXACT_GAUGES = {"explain_bisect_steps", "witness_ops",
                "checker_ckpt_staleness_ops", "dispatch_inflight",
                "dispatch_inflight_peak", "checker_mesh_padding_frac"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run many small torch ops; the suite runs several
    workers on the machine's cores, where torch's thread pool would
    oversubscribe them. One thread, restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the registry, call for call
# ---------------------------------------------------------------------------

class _Clock:
    """A stand-in for a module's ``time``: a fixed wall clock and a
    counting perf counter, the same in both packages."""

    def __init__(self):
        self.t = 0.0

    def time(self):
        return 1_700_000_000.25

    def perf_counter(self):
        self.t += 0.001953125
        return self.t


def _modules():
    from jepsen_tpu import telemetry as ref
    from jepsen_tpu_torch import telemetry
    return ref, telemetry


def _drive(mod, seed: int):
    """A seeded sequence of instrument calls on a fresh registry of
    ``mod``; returns the registry and the messages of the errors the
    calls raised, in order."""
    rng = np.random.default_rng(seed)
    reg = mod.Registry(max_events=8)
    raised = []
    names = ["ops_total", "lag_seconds", "queue_depth", "sizes"]
    hist_buckets = mod.log_buckets(1e-4, 2.0, 12)
    reg.counter("ops_total", "ops, by node", labels=("node",))
    reg.histogram("lag_seconds", "lag\nwith \\ escapes", labels=("node",))
    reg.gauge("queue_depth", "depth", labels=("node",))
    reg.histogram("sizes", "sizes", buckets=hist_buckets)
    for _ in range(300):
        op = int(rng.integers(12))
        lab = {"node": f"n{int(rng.integers(3))}"}
        v = float(np.round(rng.exponential(0.05), 6))
        try:
            if op == 0:
                reg.counter("ops_total", "ops, by node",
                            labels=("node",)).inc(
                    float(rng.integers(1, 4)), **lab)
            elif op == 1:
                reg.gauge("queue_depth", "depth", labels=("node",)).set(
                    int(rng.integers(50)), **lab)
            elif op == 2:
                reg.gauge("queue_depth", labels=("node",)).inc(2.5, **lab)
            elif op == 3:
                reg.gauge("queue_depth", labels=("node",)).dec(1.0, **lab)
            elif op == 4:
                reg.gauge("high_water", "max seen").set_max(v * 1e3)
            elif op == 5:
                reg.histogram("lag_seconds", "lag\nwith \\ escapes",
                              labels=("node",)).observe(v, **lab)
            elif op == 6:
                reg.histogram("sizes", "sizes", buckets=hist_buckets
                              ).observe(v)
            elif op == 7:
                reg.counter("ops_total", labels=("node",)).cell(**lab)[0] \
                    += 1.0
                reg.histogram("sizes").observer()(v / 3)
            elif op == 8:
                reg.event("fault", node=lab["node"], f="partition")
            elif op == 9:
                # a type conflict: a family's name taken by another kind
                name = names[int(rng.integers(4))]
                (reg.counter if name == "queue_depth" else reg.gauge)(
                    name, labels=("node",))
            elif op == 10:
                # a label conflict
                reg.counter("ops_total", labels=("other",))
            else:
                with reg.timer("step_seconds", "steps", phase="a"):
                    pass
                reg.counter("ops_total", labels=("node",)).inc(
                    -1.0, **lab)
        except ValueError as e:
            raised.append(str(e))
    reg.counter("esc_total", 'help "quoted"', labels=("k",)).inc(
        k='va"l\\ue\nx')
    return reg, raised


@pytest.mark.parametrize("seed", range(8))
def test_registry_sequence_matches_jax(seed, monkeypatch):
    ref, port = _modules()
    for mod in (ref, port):
        monkeypatch.setattr(mod, "time", _Clock())
    want, want_raised = _drive(ref, seed)
    got, got_raised = _drive(port, seed)
    assert got_raised == want_raised and got_raised
    assert got.render_prom() == want.render_prom()
    assert got.snapshot() == want.snapshot()
    for name, labels in (("lag_seconds", {"node": "n0"}),
                         ("lag_seconds", {"node": "n2"}),
                         ("sizes", {}), ("step_seconds", {"phase": "a"})):
        for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
            g = got.histogram(name).quantile(q, **labels)
            w = want.histogram(name).quantile(q, **labels)
            assert g == w, (name, q)


def test_snapshot_matches_jax_apart_from_event_times():
    """The events' timestamps are the only difference between two
    packages' snapshots taken on the real clock."""
    ref, port = _modules()
    rows = []
    for mod in (ref, port):
        reg = mod.Registry()
        reg.counter("a_total").inc(3)
        reg.event("fault", f="kill")
        reg.event("fault", f="start")
        snap = reg.snapshot()
        assert all(isinstance(r.pop("time"), float)
                   for r in snap if r["type"] == "event")
        rows.append(snap)
    assert rows[0] == rows[1]


@pytest.mark.parametrize("start,factor,count", [
    (1e-6, 4.0, 20), (0.5, 1.5, 7), (3.0, 10.0, 1), (1e-9, 2.0, 40)])
def test_log_buckets_match_jax(start, factor, count):
    ref, port = _modules()
    assert port.log_buckets(start, factor, count) == \
        ref.log_buckets(start, factor, count)
    assert port.DEFAULT_BUCKETS == ref.DEFAULT_BUCKETS


@pytest.mark.parametrize("args", [(0, 2.0, 3), (1.0, 1.0, 3), (1.0, 2.0, 0)])
def test_log_buckets_reject_as_jax(args):
    ref, port = _modules()
    for mod in (ref, port):
        with pytest.raises(ValueError):
            mod.log_buckets(*args)


@pytest.mark.parametrize("seed", [5, 6])
def test_export_files_match_jax(tmp_path, monkeypatch, seed):
    ref, port = _modules()
    for mod in (ref, port):
        monkeypatch.setattr(mod, "time", _Clock())
    files = {}
    for key, mod in (("ref", ref), ("port", port)):
        reg, _ = _drive(mod, seed)
        d = tmp_path / key
        reg.export(d)
        reg.export(d, prefix="again")
        files[key] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert sorted(files["port"]) == ["again.json", "again.prom",
                                     "metrics.json", "metrics.prom"]
    assert files["port"] == files["ref"]
    rows = [json.loads(ln) for ln in
            files["port"]["metrics.json"].decode().splitlines()]
    assert rows[-1]["type"] == "event"


def test_null_registry_and_install_as_jax():
    ref, port = _modules()
    for mod in (ref, port):
        assert mod.get_registry() is mod.NULL and not mod.NULL.enabled
        null = mod.NULL
        for inst in (null.counter("a"), null.gauge("b"), null.histogram("c")):
            inst.inc()
            inst.set(1)
            inst.set_max(2)
            inst.dec()
            inst.observe(3)
            inst.observer()(1.0)
            assert inst.value() == 0.0 and inst.quantile(0.5) is None
            assert inst.cell() == [0.0]
        with null.timer("t"):
            pass
        null.event("e")
        assert null.snapshot() == [] and null.render_prom() == ""
        live = mod.Registry()
        with mod.use(live) as r:
            assert r is live and mod.get_registry() is live
            prev = mod.install(None)
            assert prev is live and mod.get_registry() is mod.NULL
            mod.install(live)
        assert mod.get_registry() is mod.NULL


def test_atomic_write_leaves_no_tmp(tmp_path):
    _, port = _modules()
    port._atomic_write(tmp_path / "a.txt", "one")
    port._atomic_write(tmp_path / "a.txt", "two")
    assert [p.name for p in tmp_path.iterdir()] == ["a.txt"]
    assert (tmp_path / "a.txt").read_text() == "two"


# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------

def test_device_memory_helpers_leave_cuda_alone(monkeypatch):
    _, port = _modules()

    def boom(*a, **kw):
        raise AssertionError("touched torch.cuda")

    for fn in ("memory_stats", "memory_stats_as_nested_dict",
               "max_memory_allocated", "is_available", "current_device",
               "init"):
        monkeypatch.setattr(torch.cuda, fn, boom)
    for dev in ("cpu", torch.device("cpu"), "meta"):
        assert port.device_memory_peak_bytes(dev) is None


@pytest.mark.parametrize("peak", [0, 1, 123_456_789, 80 * 2**30])
def test_device_memory_peak_is_max_memory_allocated(monkeypatch, peak):
    """For a CUDA device the helper reads the allocator's nested stats:
    the value ``torch.cuda.max_memory_allocated`` reads from the same
    stats, flattened (0 before the allocator's first use). A stats read
    that fails gives None."""
    from torch.cuda import memory as cuda_memory
    _, port = _modules()
    nested = {"allocated_bytes": {
        pool: {"current": 7, "peak": peak if pool == "all" else 3,
               "allocated": 11, "freed": 4}
        for pool in ("all", "large_pool", "small_pool")},
        "num_alloc_retries": 0}
    seen = []

    def stats(device=None):
        seen.append(device)
        return nested

    monkeypatch.setattr(cuda_memory, "memory_stats_as_nested_dict", stats)
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", stats)
    want = torch.cuda.max_memory_allocated("cuda:1")
    assert port.device_memory_peak_bytes("cuda:1") == want == peak
    assert seen[-1] == torch.device("cuda:1")
    nested.clear()
    assert port.device_memory_peak_bytes("cuda") == \
        torch.cuda.max_memory_allocated("cuda") == 0

    def broken(device=None):
        raise RuntimeError("no allocator")

    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", broken)
    assert port.device_memory_peak_bytes("cuda") is None


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    _, port = _modules()
    with port.profiler_trace(tmp_path / "prof"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "prof" / port.PROFILE_NAME).read_text())
    assert any("mm" in str(e.get("name")) for e in trace["traceEvents"])


def test_profiler_that_cannot_start_still_runs_the_block(tmp_path,
                                                         monkeypatch):
    import torch.profiler
    _, port = _modules()

    def broken(*a, **kw):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    ran = []
    with port.profiler_trace(tmp_path):
        ran.append(1)
    assert ran == [1]
    assert not (tmp_path / port.PROFILE_NAME).exists()


# ---------------------------------------------------------------------------
# the check path, with live registries and tracers in both packages
# ---------------------------------------------------------------------------

def _timed(history):
    """``history`` with op i at time 1000 i (trace ids name a time)."""
    return [{**op, "time": 1000 * i} for i, op in enumerate(history)]


def _headline(n_ops=300):
    from jepsen_tpu_torch.histories import register_history
    return _timed(register_history(n_ops, n_procs=5, seed=42, n_values=5))


@pytest.fixture
def both(monkeypatch):
    """Both packages on the CPU with fresh first-check sets, empty phase
    splits, the reference's Pallas kernels in interpret mode, and short
    histories admitted to both matrix screens."""
    import jepsen_tpu.checker.linearizable as ref_lin
    import jepsen_tpu.ops.jitlin as ref_jit
    import jepsen_tpu.ops.pallas_matrix as pm
    import threading

    from jepsen_tpu_torch.checker import linearizable as lin
    from jepsen_tpu_torch.ops import jitlin
    monkeypatch.setattr(pm, "FORCE_INTERPRET", True)
    for mod in (ref_jit, jitlin):
        monkeypatch.setattr(mod, "MATRIX_MIN_RETURNS", 10)
        monkeypatch.setattr(mod, "_PHASE", threading.local())
    for mod in (ref_lin, lin):
        monkeypatch.setattr(mod, "_FIRST_CHECK_SEEN", set())


def _observe(pkg: str, fn, path):
    """Runs ``fn()`` under a live registry and a tracer (Perfetto sink and
    flight recorder) of package ``pkg``; returns (fn's value, the
    registry, the trace's events, the flight ring)."""
    if pkg == "ref":
        from jepsen_tpu import telemetry
        from jepsen_tpu import trace as tr
        from jepsen_tpu.trace.flight import FlightRecorder
        from jepsen_tpu.trace.perfetto import PerfettoSink, read_trace_events
    else:
        from jepsen_tpu_torch import telemetry
        from jepsen_tpu_torch import trace as tr
        from jepsen_tpu_torch.trace.flight import FlightRecorder
        from jepsen_tpu_torch.trace.perfetto import (PerfettoSink,
                                                     read_trace_events)
    reg = telemetry.Registry()
    tracer = tr.RunTracer(perfetto=PerfettoSink(path),
                          flight=FlightRecorder(256))
    with telemetry.use(reg), tr.use(tracer):
        out = fn()
    tracer.close()
    with open(path, encoding="utf-8") as f:
        json.load(f)        # strict JSON after close()
    return out, reg, read_trace_events(path), tracer.flight.snapshot()


def _families(reg, pkg: str, pipelined: bool = False) -> dict:
    """{(family, type, labels): what the data fixes}: a counter's value,
    a histogram's count, an exact gauge's value, else None (a time or a
    rate), with the reference's names mapped to the port's and the
    families only one package has dropped (``pipelined``: both packages
    ran the dispatch pipeline)."""
    drop = REF_ONLY if pkg == "ref" else set() if pipelined else PORT_ONLY
    out = {}
    for row in reg.snapshot():
        if row["type"] == "event" or row["name"] in drop:
            continue
        labels = {k: RUNGS.get(v, ALGORITHMS.get(v, v))
                  for k, v in row["labels"].items()}
        if row["name"] == "checker_matrix_phase_seconds":
            assert labels["phase"] in PHASES[pkg]
            if labels["phase"] not in PHASES["ref"]:
                continue
        key = (row["name"], row["type"], tuple(sorted(labels.items())))
        if row["type"] == "counter":
            out[key] = row["value"]
        elif row["type"] == "histogram":
            out[key] = row["count"]
        else:
            out[key] = row["value"] if row["name"] in EXACT_GAUGES else None
    return out


def _events(evs) -> list:
    """The trace's events without times and lanes, tracks by name, the
    reference's backend and algorithm names mapped to the port's."""
    tracks = {e["tid"]: e["args"]["name"] for e in evs
              if e.get("ph") == "M" and e.get("name") == "thread_name"}
    out = []
    for e in evs:
        if e.get("ph") == "M":
            continue
        args = {k: RUNGS.get(v, ALGORITHMS.get(v, v))
                if isinstance(v, str) else v
                for k, v in e.get("args", {}).items()}
        out.append((e["ph"], tracks[e["tid"]], e.get("name"),
                    tuple(sorted(args.items()))))
    return out


def _same_telemetry(got, want, pipelined: bool = False):
    """The port's (result, registry, events, ring) against the
    reference's: families, label sets, counts, events and the flight
    ring's event names equal."""
    assert _families(got[1], "port", pipelined) == \
        _families(want[1], "ref")
    assert _events(got[2]) == _events(want[2])
    assert [e.get("name") for e in got[3]] == [e.get("name")
                                               for e in want[3]]


def _run_both(tmp_path, port_fn, ref_fn):
    want = _observe("ref", ref_fn, tmp_path / "ref.json")
    got = _observe("port", port_fn, tmp_path / "port.json")
    return got, want


@pytest.mark.parametrize("case", ["valid", "corrupted"])
def test_headline_check_telemetry_matches_jax(case, both, tmp_path):
    from jepsen_tpu.checker.linearizable import LinearizableChecker as Ref
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.histories import corrupt_reads

    h = _headline()
    if case == "corrupted":
        h = corrupt_reads(h, n=2, seed=0)
    got, want = _run_both(
        tmp_path,
        lambda: LinearizableChecker(accelerator="gpu", device="cpu").check(
            {}, h, {}),
        lambda: Ref(accelerator="tpu").check({}, h,
                                             {"checker_sharded": False}))
    assert got[0]["valid?"] is want[0]["valid?"] is (case == "valid")
    assert got[0]["algorithm"] == "torch-matrix"
    _same_telemetry(got, want)
    fams = _families(got[1], "port")
    assert fams[("checker_backend_total", "counter",
                 (("backend", "torch-matrix"),))] == 1
    names = [e[2] for e in _events(got[2])]
    assert names == (["rung"] if case == "valid" else ["rung", "explain"])
    if case == "corrupted":
        assert fams[("explain_total", "counter",
                     (("backend", "matrix-bisect"),))] == 1
        op = got[0]["failed-op"]
        inv = next(o for o in reversed(h[:h.index(op)])
                   if o["process"] == op["process"]
                   and o["type"] == "invoke")
        explain = [e for e in _events(got[2]) if e[2] == "explain"][0]
        assert dict(explain[3])["trace_id"] == f"{op['process']}-" \
            f"{inv['time']}"


def test_explain_off_demotes_as_jax(both, tmp_path):
    """``explain`` off: the matrix rung declines the corrupted history
    and the frontier rung settles it; both packages trace the decline and
    count the demotion."""
    from jepsen_tpu.checker.linearizable import LinearizableChecker as Ref
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.histories import corrupt_reads

    h = corrupt_reads(_headline(), n=2, seed=0)
    opts = {"explain": False}
    got, want = _run_both(
        tmp_path,
        lambda: LinearizableChecker(accelerator="gpu", device="cpu").check(
            {}, h, opts),
        lambda: Ref(accelerator="tpu").check(
            {}, h, {**opts, "checker_sharded": False}))
    assert got[0]["algorithm"] == "torch-frontier"
    _same_telemetry(got, want)
    assert [(e[2], dict(e[3]).get("outcome")) for e in _events(got[2])] == [
        ("rung", "declined"), ("demote", None), ("rung", "settled"),
        ("explain", None)]


def test_host_regime_checks_trace_as_jax(both, tmp_path):
    """``accelerator="cpu"``: the native rung settles, one span each."""
    from jepsen_tpu.checker.linearizable import LinearizableChecker as Ref
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker

    h = _headline(120)
    got, want = _run_both(
        tmp_path,
        lambda: LinearizableChecker(accelerator="cpu").check({}, h, {}),
        lambda: Ref(accelerator="cpu").check({}, h, {}))
    assert got[0]["algorithm"] == want[0]["algorithm"] == "jitlin-native"
    _same_telemetry(got, want)


def _blocks(n_blocks: int) -> list[dict]:
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_resume import block_history
    return _timed(block_history(n_blocks))


def test_segmented_check_and_resume_match_jax(both, tmp_path, monkeypatch):
    """A chain past the (lowered) segment bound writes ``check.ckpt``
    after each segment; a check with the same store resumes from it,
    runs the remaining segments and clears it. Segment spans, writes,
    the resume and the staleness gauge are the reference's."""
    import jepsen_tpu.ops.jitlin as ref_jit
    from jepsen_tpu.checker import checkpoint as ref_ck
    from jepsen_tpu.checker.linear_encode import (
        encode_register_ops as ref_enc)
    from jepsen_tpu.checker.linearizable import LinearizableChecker as Ref
    from jepsen_tpu_torch.checker import checkpoint as ck
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.ops import jitlin

    for mod in (jitlin, ref_jit):
        monkeypatch.setattr(mod, "MATRIX_SEGMENT_EVENTS", 1024)
    h = _blocks(700)

    def run(pkg):
        test = {"name": "seg", "start_time": "20261018T000000.000Z",
                "store_dir": str(tmp_path / pkg),
                "check_ckpt_interval": 1e-9}
        if pkg == "ref":
            store = ref_ck.CheckpointStore(
                tmp_path / pkg / "seg" / test["start_time"]
                / ref_ck.CKPT_NAME, interval_s=1e-9)
            chain = ref_jit.matrix_check_segmented(ref_enc(h), ckpt=store)
            out = Ref(accelerator="tpu").check(test, h,
                                               {"checker_sharded": False})
        else:
            store = ck.CheckpointStore(
                tmp_path / pkg / "seg" / test["start_time"] / ck.CKPT_NAME,
                interval_s=1e-9)
            chain = jitlin.matrix_check_segmented(
                encode_register_ops(h), ckpt=store, device="cpu")
            out = LinearizableChecker(accelerator="gpu",
                                      device="cpu").check(test, h, {})
        return chain, out, store.writes

    want = _observe("ref", lambda: run("ref"), tmp_path / "ref.json")
    got = _observe("port", lambda: run("port"), tmp_path / "port.json")
    assert got[0][0][0] is True and got[0][1]["valid?"] is True
    assert got[0][2] == want[0][2] > 1
    _same_telemetry(got, want)
    fams = _families(got[1], "port")
    n_cuts = len(jitlin.quiescent_cuts(encode_register_ops(h).kind, 1024))
    evs = _events(got[2])
    segs = [e for e in evs if e[2] == "segment"]
    writes = [e for e in evs if e[2] == "ckpt-write"]
    resumes = [e for e in evs if e[2] == "ckpt-resume"]
    assert len(resumes) == 1 and dict(resumes[0][3]) == {"source": "ckpt"}
    # the chain's segments, then the resumed check's last one
    assert len(segs) == n_cuts + 1
    assert fams[("checker_resume_total", "counter",
                 (("source", "ckpt"),))] == 1
    assert fams[("checker_ckpt_writes_total", "counter", ())] == \
        len(writes) == got[0][2] == n_cuts - 1
    assert all(e[1] == "checkpoint" for e in segs + writes + resumes)
    assert not list((tmp_path / "port").rglob("check.ckpt"))


def test_key_batch_telemetry_matches_jax(both, tmp_path, monkeypatch):
    """Five keys, two of them corrupted, in sub-batches of two keys
    (MATRIX_PIPELINE_KEYS lowered in both packages, so both pipelines
    run): the dispatch instruments and the invalid keys' forensics."""
    import jepsen_tpu.ops.jitlin as ref_jit
    from jepsen_tpu import independent as ref_ind
    from jepsen_tpu.checker.linearizable import LinearizableChecker as Ref
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.histories import (corrupt_keys,
                                            independent_register_history)
    from jepsen_tpu_torch.ops import jitlin
    from jepsen_tpu_torch.parallel import pipeline

    for mod in (jitlin, ref_jit):
        monkeypatch.setattr(mod, "MATRIX_PIPELINE_KEYS", 2)
    h = _timed(corrupt_keys(independent_register_history(
        5, 60, n_procs=3, n_values=4, seed=2000), (1, 3)))
    got, want = _run_both(
        tmp_path,
        lambda: independent.checker(LinearizableChecker(
            accelerator="gpu", device="cpu")).check({}, h, {}),
        lambda: ref_ind.checker(Ref(accelerator="tpu")).check(
            {}, h, {"checker_sharded": False}))
    assert got[0]["failures"] == want[0]["failures"] == ["1", "3"]
    # the batch pipelines in both: the dispatch instruments are compared
    _same_telemetry(got, want, pipelined=True)
    assert _families(got[1], "port", True)[(
        "dispatch_batches_total", "counter", (("queue", "matrix"),))] == 3
    stats = pipeline.last_stats()
    assert stats["batches"] == 3 and stats["inflight_peak"] == 2


def test_sidecar_failure_counts_as_jax(tmp_path):
    from jepsen_tpu import store as ref_store
    from jepsen_tpu_torch import store
    got = _observe("port", lambda: store.note_sidecar_load_failure(
        "x", ValueError("bad")), tmp_path / "p.json")
    want = _observe("ref", lambda: ref_store.note_sidecar_load_failure(
        "x", ValueError("bad")), tmp_path / "r.json")
    assert _families(got[1], "port") == _families(want[1], "ref") == {
        ("store_sidecar_load_failures_total", "counter", ()): 1.0}


def test_mesh_padding_gauge(tmp_path):
    """A sharded dispatch on a mesh of four CPU entries publishes its
    padding share, the value ``last_dispatch_info`` holds."""
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    from jepsen_tpu_torch.ops import jitlin
    from jepsen_tpu_torch.parallel import Mesh

    s = encode_register_ops(_headline(200))
    got = _observe("port", lambda: jitlin.matrix_check(
        s, force=True, mesh=Mesh(["cpu"] * 4)), tmp_path / "p.json")
    frac = jitlin.last_dispatch_info()["mesh_padding_frac"]
    assert frac is not None
    assert got[1].gauge("checker_mesh_padding_frac").value() == frac


def test_phase_labels_are_the_split_keys(both, tmp_path):
    """checker_matrix_phase_seconds's labels are exactly the numeric keys
    of the port's last_phase_seconds(), each with its value."""
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.ops import jitlin

    got = _observe("port", lambda: LinearizableChecker(
        accelerator="gpu", device="cpu").check({}, _headline(), {}),
        tmp_path / "p.json")
    split = jitlin.last_phase_seconds()
    rows = {r["labels"]["phase"]: r["value"] for r in got[1].snapshot()
            if r["name"] == "checker_matrix_phase_seconds"}
    assert rows == {k: v for k, v in split.items()
                    if isinstance(v, (int, float))}
    assert set(rows) == PHASES["port"]


def test_wgl_check_telemetry_matches_jax(both, tmp_path):
    """``algorithm="wgl"``: the object-model search, recorded as its
    backend with no rung span, in both packages."""
    from jepsen_tpu.checker.linearizable import LinearizableChecker as Ref
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker

    h = _headline(40)
    got, want = _run_both(
        tmp_path,
        lambda: LinearizableChecker(algorithm="wgl").check({}, h, {}),
        lambda: Ref(algorithm="wgl").check({}, h, {}))
    _same_telemetry(got, want)
    assert _families(got[1], "port")[("checker_backend_total", "counter",
                                      (("backend", "wgl-cpu"),))] == 1
    assert _events(got[2]) == []


# ---------------------------------------------------------------------------
# off by default; a failing kernel still raises
# ---------------------------------------------------------------------------

def test_null_registry_and_tracer_do_no_work(both, monkeypatch, tmp_path):
    """With nothing installed, no instrument is built, no clock is read
    for a span and no sink is reached through a whole check: an invalid
    one with explain, a segmented one with a checkpoint, and a batch."""
    from jepsen_tpu_torch import telemetry
    from jepsen_tpu_torch import trace as tr
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.histories import corrupt_reads
    from jepsen_tpu_torch.ops import jitlin

    assert telemetry.get_registry() is telemetry.NULL
    assert tr.get_tracer() is tr.NULL_TRACER
    touched = []

    def spy(name):
        def f(*a, **kw):
            touched.append(name)
            raise AssertionError(name)
        return f

    monkeypatch.setattr(telemetry.Registry, "_family", spy("_family"))
    monkeypatch.setattr(tr, "now_us", spy("now_us"))
    monkeypatch.setattr(telemetry, "device_memory_peak_bytes",
                        spy("device_memory_peak_bytes"))
    monkeypatch.setattr(jitlin, "MATRIX_SEGMENT_EVENTS", 1024)
    chk = LinearizableChecker(accelerator="gpu", device="cpu")
    assert chk.check({}, corrupt_reads(_headline(), n=2, seed=0),
                     {})["valid?"] is False
    test = {"name": "n", "start_time": "t", "store_dir": str(tmp_path),
            "check_ckpt_interval": 1e-9}
    assert chk.check(test, _blocks(300), {})["valid?"] is True
    assert touched == []


def test_a_failing_kernel_raises_through_a_live_check(both, monkeypatch,
                                                      tmp_path):
    """The plain chunk product (the kernel's stand-in on the CPU) raises:
    the check raises the same error with a live registry and tracer, and
    the rung's span says ``error``."""
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.ops import matrix_kernels

    def broken(*a, **kw):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(matrix_kernels, "chunk_product_torch", broken)
    seen = {}

    def check():
        try:
            LinearizableChecker(accelerator="gpu", device="cpu").check(
                {}, _headline(), {})
        except RuntimeError as e:
            seen["error"] = str(e)

    got = _observe("port", check, tmp_path / "p.json")
    assert seen == {"error": "kernel failed"}
    assert [(e[2], dict(e[3])["outcome"]) for e in _events(got[2])] == [
        ("rung", "error")]
    assert "checker_backend_total" not in {r["name"]
                                           for r in got[1].snapshot()}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The CUDA device; skips where there is none (decided here, never
    at import, so every test worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_memory_gauge_after_a_card_check(cuda_device, tmp_path):
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.histories import register_history

    h = register_history(10_000, n_procs=5, seed=42, n_values=5)
    got = _observe("port", lambda: LinearizableChecker(
        accelerator="gpu").check({}, h, {}), tmp_path / "p.json")
    assert got[0]["algorithm"] == "torch-matrix"
    peak = got[1].gauge("checker_device_memory_peak_bytes").value()
    total = torch.cuda.get_device_properties(0).total_memory
    assert 0 < peak <= total
    assert peak == torch.cuda.max_memory_allocated(cuda_device)


@pytest.mark.cuda
def test_profiler_trace_names_the_matrix_kernels(cuda_device, tmp_path):
    from jepsen_tpu_torch import telemetry
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.histories import register_history

    h = register_history(10_000, n_procs=5, seed=42, n_values=5)
    chk = LinearizableChecker(accelerator="gpu")
    chk.check({}, h, {})
    torch.cuda.synchronize()
    # the combine's CUDA kernels (ops/csrc/chunk_combine.cu)
    combine = ("pack_flat_kernel", "pack_rows_kernel", "tree_level_kernel")

    def names_both(text):
        return "chunk_product_kernel" in text and any(k in text
                                                      for k in combine)

    # the profiler now and then returns a trace without the device's
    # events: take it again, up to five times
    for attempt in range(5):
        d = tmp_path / str(attempt)
        with telemetry.profiler_trace(d):
            chk.check({}, h, {})
            torch.cuda.synchronize()
        text = (d / telemetry.PROFILE_NAME).read_text()
        if names_both(text):
            break
    assert names_both(text)
