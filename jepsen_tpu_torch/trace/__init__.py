"""Run-wide causal tracing: one span stream per run, two sinks (the port
of jepsen_tpu/trace/__init__.py).

Every timeline a check produces (the checker's rung attempts, the
segmented chain's segments, checkpoint writes and resumes, an invalid
verdict's anomaly) emits events into one :class:`RunTracer`, causally
linked by a stable trace id (:func:`trace_id_for`: a pure function of an
op's process and invoke time, which the history keeps).

Two sinks, independently enabled:

* :class:`~jepsen_tpu_torch.trace.perfetto.PerfettoSink`: a streaming
  Perfetto/Chrome ``trace.json`` (Trace Event Format), one event a line.
* :class:`~jepsen_tpu_torch.trace.flight.FlightRecorder`: a bounded ring
  of the most recent events, dumped to ``flight-recorder.jsonl`` on
  demand (:meth:`RunTracer.dump_flight`).

Zero-cost disabled mode: the module default is :data:`NULL_TRACER`,
whose every method is a constant no-op, and call sites guard hot blocks
on ``tracer.enabled``. A caller turns tracing on with ``with
trace.use(RunTracer(perfetto=..., flight=...)): ...``; the port has no
run loop yet that installs one for a run. Not ported, to come with that
run loop and its interpreter, nemesis and live daemon: the tracks they
write, the interpreter's op-tuple sink and its B/E slices, fault
windows, scoped spans, the atexit crash dump, the ``trace`` and
``flight_recorder_events`` knobs with ``for_test``, and
``trace/derive.py``, which re-derives a stored run's trace from its
history.
"""
from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager

from jepsen_tpu_torch.trace.flight import FlightRecorder
from jepsen_tpu_torch.trace.perfetto import PerfettoSink

logger = logging.getLogger("jepsen_tpu_torch.trace")

# copied from jepsen_tpu/trace/__init__.py:49-358: the check path's tracks,
# and the tracer without the run loop's op sink, B/E and window slices,
# scoped spans and crash hook

TRACE_NAME = "trace.json"
FLIGHT_NAME = "flight-recorder.jsonl"

DEFAULT_FLIGHT_EVENTS = 4096

# Track naming convention (lint-enforced for literals, JTM001): kebab-case.
TRACK_CHECKER = "checker"
TRACK_LADDER = "checker-ladder"
TRACK_CHECKPOINT = "checkpoint"
# the live daemon's poll, check and finalize slices (live/daemon.py)
TRACK_LIVE = "live"


def trace_id_for(process, time_ns) -> str:
    """The stable trace id of one history-bound op: a pure function of
    its ``(process, invoke-time-ns)`` pair — minted at interpreter
    dispatch, re-derivable from any artifact that persists those two
    fields (the WAL record, history.jsonl, a quarantined late
    completion). Process renumbering makes the pair unique per run:
    one process never has two ops in flight. Deliberately a plain
    format, not a hash: the id is an identity, cheap enough for the
    dispatch hot path, and a human reading a trace can see which
    process/op it names."""
    return f"{process}-{time_ns}"


def now_us() -> int:
    """Trace-event timestamp: wall-clock microseconds (the Trace Event
    Format's ``ts`` unit)."""
    return time.time_ns() // 1000


class RunTracer:
    """One run's span stream. Thread-safe: a check's threads (the key
    batches' pool, the dispatch pipeline) emit concurrently; each sink
    serializes internally. Event building happens only when a sink is
    attached (``enabled``), so the disabled path costs one attribute
    read."""

    def __init__(self, perfetto: PerfettoSink | None = None,
                 flight: FlightRecorder | None = None):
        self.perfetto = perfetto
        self.flight = flight
        self.enabled = perfetto is not None or flight is not None
        self._closed = False
        self._lock = threading.Lock()

    # -- emission ---------------------------------------------------------

    def _emit(self, ev: dict) -> None:
        p, fl = self.perfetto, self.flight
        if p is not None:
            p.emit(ev)
        if fl is not None:
            fl.record(ev)

    def complete(self, track: str, name: str, start_us: int, dur_us: int,
                 args: dict | None = None) -> None:
        """A self-contained slice (Trace Event ``X``): emitted once at
        completion, so interleaving emitters (watchdog-abandoned rungs,
        overlapping daemon polls) can never tear a B/E pairing."""
        if not self.enabled:
            return
        self._emit({"ph": "X", "track": track, "name": name,
                    "ts": start_us, "dur": max(int(dur_us), 1),
                    "args": args or {}})

    def instant(self, track: str, name: str, args: dict | None = None,
                ts_us: int | None = None) -> None:
        if not self.enabled:
            return
        self._emit({"ph": "i", "track": track, "name": name,
                    "ts": now_us() if ts_us is None else ts_us,
                    "s": "t", "args": args or {}})

    # -- flight-recorder dumping -----------------------------------------

    def dump_flight(self, path, reason: str) -> bool:
        """Dumps the flight recorder's ring to ``path`` (jsonl, fsynced).
        Returns False when no recorder is attached or the dump failed;
        never raises — this runs on crash paths."""
        fl = self.flight
        if fl is None:
            return False
        ok = fl.dump(path, reason=reason)
        if ok:
            try:
                from jepsen_tpu_torch import telemetry
                reg = telemetry.get_registry()
                if reg.enabled:
                    reg.counter(
                        "trace_flight_dumps_total",
                        "flight-recorder dumps, by trigger",
                        labels=("reason",)).inc(reason=reason)
            except Exception:  # noqa: BLE001 — a dump must never raise
                logger.exception("flight-dump telemetry failed")
        return ok

    # -- lifecycle --------------------------------------------------------

    def close(self) -> None:
        """Flushes and terminates the sinks. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self.perfetto is not None:
            self.perfetto.close()


class NullTracer:
    """The disabled mode: every method a constant no-op."""

    enabled = False
    perfetto = None
    flight = None

    def complete(self, *a, **kw) -> None:
        pass

    def instant(self, *a, **kw) -> None:
        pass

    def dump_flight(self, path, reason: str) -> bool:
        return False

    def close(self) -> None:
        pass


NULL_TRACER = NullTracer()

_TRACER: RunTracer | NullTracer = NULL_TRACER
_TRACER_LOCK = threading.Lock()


def get_tracer() -> RunTracer | NullTracer:
    """The currently installed run tracer (NULL when tracing is off)."""
    return _TRACER


def install(tracer: RunTracer | NullTracer | None):
    """Swaps the process-global tracer; returns the previous one so
    callers can restore it."""
    global _TRACER
    with _TRACER_LOCK:
        prev = _TRACER
        _TRACER = tracer if tracer is not None else NULL_TRACER
        return prev


@contextmanager
def use(tracer: RunTracer | NullTracer):
    prev = install(tracer)
    try:
        yield tracer
    finally:
        install(prev)
