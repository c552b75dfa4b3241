"""jepsen_tpu_torch's run tracer (``trace/``) against jepsen_tpu's on the
CPU: one numpy-seeded sequence of the check path's events (complete
slices and instants, timed and on the patched clock) goes through both
packages' ``RunTracer`` with a Perfetto sink and a flight recorder, with
``now_us`` patched to one counter in both. The Perfetto files are equal
byte for byte, the flight recorder's ring (wraparound included) and its
dump are equal, and so are the trace ids, the track names and the
tolerant reader."""
from __future__ import annotations

import json

import numpy as np
import pytest


def _packages():
    import jepsen_tpu.trace as ref
    import jepsen_tpu_torch.trace as port
    return ref, port


class _Counter:
    """``now_us``: 1,000 us after the last call."""

    def __init__(self):
        self.t = 1_700_000_000_000_000

    def __call__(self):
        self.t += 1000
        return self.t


def _drive(mod, path, capacity: int, seed: int):
    """The seeded event sequence through a RunTracer of ``mod``; returns
    the tracer, closed."""
    from importlib import import_module
    flight = import_module(mod.__name__ + ".flight")
    perfetto = import_module(mod.__name__ + ".perfetto")
    rng = np.random.default_rng(seed)
    tracer = mod.RunTracer(perfetto=perfetto.PerfettoSink(path),
                           flight=flight.FlightRecorder(capacity))
    tracks = [mod.TRACK_CHECKER, mod.TRACK_LADDER, mod.TRACK_CHECKPOINT]
    for i in range(200):
        kind = int(rng.integers(5))
        track = tracks[int(rng.integers(len(tracks)))]
        args = {"i": i, "v": int(rng.integers(100)),
                "s": f"x{int(rng.integers(5))}",
                "ok": bool(rng.integers(2))}
        if kind == 0:
            # a rung slice, its duration clamped to at least 1 us
            tracer.complete(track, "rung", 1_000 * i,
                            int(rng.integers(-2, 3)), args=args)
        elif kind == 1:
            tracer.complete(track, "segment", 1_000 * i,
                            float(rng.exponential(50.0)))
        elif kind == 2:
            tracer.instant(track, "ckpt-write", args=args)
        elif kind == 3:
            tracer.instant(track, "explain", args=args,
                           ts_us=int(rng.integers(1 << 40)))
        else:
            tracer.instant(track, "demote")
    tracer.close()
    return tracer


@pytest.mark.parametrize("capacity,seed", [
    (16, 0), (1000, 1), (1, 2), (199, 3), (200, 4), (201, 5), (64, 6)])
def test_tracer_files_and_ring_match_jax(tmp_path, monkeypatch, capacity,
                                         seed):
    ref, port = _packages()
    for mod in (ref, port):
        monkeypatch.setattr(mod, "now_us", _Counter())
    want = _drive(ref, tmp_path / "ref.json", capacity, seed)
    got = _drive(port, tmp_path / "port.json", capacity, seed)
    text = (tmp_path / "port.json").read_text()
    assert text == (tmp_path / "ref.json").read_text()
    events = json.loads(text)       # strict JSON after close()
    assert events[-1]["name"] == "trace_done"
    assert got.perfetto.events == want.perfetto.events == 200
    assert got.flight.snapshot() == want.flight.snapshot()
    assert got.flight.recorded == want.flight.recorded == min(capacity,
                                                              got.flight
                                                              .recorded)
    # the dump: a header naming the trigger, then the ring
    for key, tracer in (("ref", want), ("port", got)):
        assert tracer.dump_flight(tmp_path / f"{key}.jsonl", "stall")
    rows = {}
    for key in ("ref", "port"):
        lines = (tmp_path / f"{key}.jsonl").read_text().splitlines()
        head = json.loads(lines[0])
        assert head.pop("dumped_at") > 0
        rows[key] = [head] + [json.loads(ln) for ln in lines[1:]]
    assert rows["port"] == rows["ref"]
    assert rows["port"][0]["retained"] == got.flight.recorded


@pytest.mark.parametrize("process,time_ns", [
    (0, 0), (3, 1_700_000_123), ("nemesis", 42), (None, None), (7, 1.5),
    (-1, -5), ("p", "t"), (2**63, 10**20)])
def test_trace_ids_and_tracks_match_jax(process, time_ns):
    ref, port = _packages()
    assert port.trace_id_for(process, time_ns) == \
        ref.trace_id_for(process, time_ns)
    assert (port.TRACK_CHECKER, port.TRACK_LADDER, port.TRACK_CHECKPOINT) \
        == (ref.TRACK_CHECKER, ref.TRACK_LADDER, ref.TRACK_CHECKPOINT)
    assert (port.TRACE_NAME, port.FLIGHT_NAME, port.DEFAULT_FLIGHT_EVENTS) \
        == (ref.TRACE_NAME, ref.FLIGHT_NAME, ref.DEFAULT_FLIGHT_EVENTS)


def test_reader_tolerates_a_torn_tail_as_jax(tmp_path):
    from jepsen_tpu.trace.perfetto import read_trace_events as ref_read
    from jepsen_tpu_torch.trace.perfetto import read_trace_events
    p = tmp_path / "t.json"
    p.write_text('[\n{"ph": "i", "name": "a"},\n{"ph": "X", "name": "b", '
                 '"dur": 3},\n[1, 2],\n{"ph": "i", "na')
    assert read_trace_events(p) == ref_read(p) == [
        {"ph": "i", "name": "a"}, {"ph": "X", "name": "b", "dur": 3}]
    assert read_trace_events(p, max_bytes=30) == ref_read(p, max_bytes=30)


def test_flight_recorder_needs_capacity():
    from jepsen_tpu_torch.trace.flight import FlightRecorder
    with pytest.raises(ValueError):
        FlightRecorder(0)


def test_flight_dump_counts_its_trigger(tmp_path):
    """A dump bumps ``trace_flight_dumps_total{reason}`` in the live
    registry, as the reference's does."""
    from jepsen_tpu import telemetry as ref_tel
    from jepsen_tpu_torch import telemetry
    ref, port = _packages()
    rows = []
    for tel, mod in ((ref_tel, ref), (telemetry, port)):
        from importlib import import_module
        flight = import_module(mod.__name__ + ".flight")
        reg = tel.Registry()
        tracer = mod.RunTracer(flight=flight.FlightRecorder(4))
        with tel.use(reg):
            tracer.instant(mod.TRACK_LADDER, "demote")
            assert tracer.dump_flight(tmp_path / f"{mod.__name__}.jsonl",
                                      "fatal")
        assert not mod.RunTracer().dump_flight(tmp_path / "x", "fatal")
        rows.append(reg.render_prom())
    assert rows[0] == rows[1]
    assert 'trace_flight_dumps_total{reason="fatal"} 1' in rows[1]


def test_null_tracer_and_install_as_jax(tmp_path):
    ref, port = _packages()
    for mod in (ref, port):
        null = mod.NULL_TRACER
        assert mod.get_tracer() is null and not null.enabled
        assert null.perfetto is None and null.flight is None
        null.complete("t", "n", 0, 1)
        null.instant("t", "n")
        assert null.dump_flight(tmp_path / "n", "x") is False
        assert not (tmp_path / "n").exists()
        null.close()
        live = mod.RunTracer()
        assert not live.enabled
        with mod.use(live) as t:
            assert t is live and mod.get_tracer() is live
            assert mod.install(None) is live
            assert mod.get_tracer() is null
            mod.install(live)
        assert mod.get_tracer() is null
