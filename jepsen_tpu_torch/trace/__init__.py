"""Run-wide causal tracing: one span stream per run, two sinks (the port
of jepsen_tpu/trace/__init__.py).

Every timeline a run produces (interpreter dispatch per worker, nemesis
fault windows from the durable registry, the checker's rung attempts, the
segmented chain's segments, checkpoint writes and resumes, live-daemon
polls, WAL fsyncs) emits events into one :class:`RunTracer`, causally
linked by a stable trace id (:func:`trace_id_for`: a pure function of an
op's process and invoke time, which the history keeps).

Two sinks, independently enabled:

* :class:`~jepsen_tpu_torch.trace.perfetto.PerfettoSink`: a streaming
  Perfetto/Chrome ``trace.json`` (Trace Event Format), one event a line;
  on with the test map's ``trace`` knob.
* :class:`~jepsen_tpu_torch.trace.flight.FlightRecorder`: a bounded ring
  of the most recent events, dumped to ``flight-recorder.jsonl`` by the
  stall watchdog, the run's fatal path and an atexit crash hook;
  ``flight_recorder_events`` sizes it, ``0`` disables.

Zero-cost disabled mode: the module default is :data:`NULL_TRACER`,
whose every method is a constant no-op, and call sites guard hot blocks
on ``tracer.enabled``. ``core.run`` installs a live tracer per run
(:func:`for_test`, from the test map alone: no environment variable is
read) and restores the previous one after. Not ported:
``trace/derive.py``, which re-derives a stored run's trace from its
history.
"""
from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager

from jepsen_tpu_torch.trace.flight import OP_BEGIN, OP_COMPLETE, FlightRecorder
from jepsen_tpu_torch.trace.perfetto import PerfettoSink

logger = logging.getLogger("jepsen_tpu_torch.trace")

# copied from jepsen_tpu/trace/__init__.py:49-418, the knobs from the
# test map alone; the tracer's B/E slices and ``span`` wait with their
# callers (the reference's tracing.py and trace/derive.py)

TRACE_NAME = "trace.json"
FLIGHT_NAME = "flight-recorder.jsonl"

DEFAULT_FLIGHT_EVENTS = 4096

# Track naming convention (lint-enforced for literals, JTM001): kebab-case.
# Worker tracks are dynamic ("worker-0".."worker-N"); the nemesis worker's
# track is "nemesis" so fault ops and fault windows share a lane.
TRACK_SCHEDULER = "scheduler"
TRACK_NEMESIS = "nemesis"
TRACK_CHECKER = "checker"
TRACK_LADDER = "checker-ladder"
TRACK_CHECKPOINT = "checkpoint"
TRACK_LIVE = "live"
TRACK_WAL = "wal"

def worker_track(worker_id) -> str:
    """The per-worker track name; the nemesis worker gets its own lane
    (``worker_id`` is the interpreter's NEMESIS sentinel there)."""
    if isinstance(worker_id, int):
        return f"worker-{worker_id}"
    return TRACK_NEMESIS


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
    """One run's span stream. Thread-safe: the interpreter scheduler,
    worker threads, the nemesis thread, checker watchdog threads and
    the live daemon's poller all emit concurrently; each sink serializes
    internally. Event building happens only when a sink is attached
    (``enabled``), so the disabled path costs one attribute read."""

    def __init__(self, perfetto: PerfettoSink | None = None,
                 flight: FlightRecorder | None = None):
        self.perfetto = perfetto
        self.flight = flight
        self.enabled = perfetto is not None or flight is not None
        self._crash_path = None
        self._closed = False
        self._lock = threading.Lock()

    # -- emission ---------------------------------------------------------

    def _emit(self, ev: dict) -> None:
        p, fl = self.perfetto, self.flight
        if p is not None:
            p.emit(ev)
        if fl is not None:
            fl.record(ev)

    # -- the interpreter's single-writer fast path ------------------------

    def set_op_origin(self, origin_us: int) -> None:
        """One-shot clock pairing (wall-us minus relative-us at run
        start), captured by the interpreter before its loop: op tuples
        carry only the op's relative time, and the sinks shift them
        onto the wall clock with this at expansion time — so the hot
        path never reads a clock at all."""
        if self.perfetto is not None:
            self.perfetto.op_origin_us = origin_us
        if self.flight is not None:
            self.flight.op_origin_us = origin_us

    def op_sink(self):
        """The scheduler's op-event appender (telemetry's ``cell()``
        analog): a callable taking one compact op tuple —
        ``(OP_BEGIN, worker, op)`` at dispatch, ``(OP_COMPLETE,
        worker, completion, invoke_time_ns)`` at completion.
        Flight-only runs (the default) get the ring's raw
        ``deque.append``; with a Perfetto sink attached the tuple fans
        out to both. None when tracing is off."""
        p, fl = self.perfetto, self.flight
        if p is not None and fl is not None:
            p_append, f_append = p.appender(), fl.appender()

            def both(ev) -> None:
                p_append(ev)
                f_append(ev)
            return both
        if p is not None:
            return p.appender()
        if fl is not None:
            return fl.appender()
        return None

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

    def window_begin(self, track: str, name: str, wid,
                     args: dict | None = None,
                     ts_us: int | None = None) -> None:
        """Opens an async slice (Trace Event ``b``) — fault windows and
        client invokes overlap freely, keyed by id instead of nesting."""
        if not self.enabled:
            return
        self._emit({"ph": "b", "track": track, "name": name,
                    "cat": "window", "id": str(wid),
                    "ts": now_us() if ts_us is None else ts_us,
                    "args": args or {}})

    def window_end(self, track: str, name: str, wid,
                   args: dict | None = None,
                   ts_us: int | None = None) -> None:
        if not self.enabled:
            return
        self._emit({"ph": "e", "track": track, "name": name,
                    "cat": "window", "id": str(wid),
                    "ts": now_us() if ts_us is None else ts_us,
                    "args": args or {}})

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

    def arm_crash_dump(self, path) -> None:
        """Registers an atexit hook that dumps the flight recorder if
        this tracer is never closed cleanly — the last line of defense
        when a run dies outside core.run's fatal-path dump."""
        import atexit
        with self._lock:
            self._crash_path = path
        atexit.register(self._atexit_dump)

    def _atexit_dump(self) -> None:
        with self._lock:
            if self._closed or self._crash_path is None:
                return
            path = self._crash_path
        self.dump_flight(path, reason="atexit")

    # -- lifecycle --------------------------------------------------------

    def close(self) -> None:
        """Flushes/terminates the sinks and disarms the crash hook.
        Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        import atexit
        try:
            atexit.unregister(self._atexit_dump)
        except Exception:  # noqa: BLE001
            pass
        if self.perfetto is not None:
            self.perfetto.close()


class NullTracer:
    """The disabled mode: every method a constant no-op."""

    enabled = False
    perfetto = None
    flight = None

    def set_op_origin(self, origin_us: int) -> None:
        pass

    def op_sink(self):
        return None

    def complete(self, *a, **kw) -> None:
        pass

    def instant(self, *a, **kw) -> None:
        pass

    def window_begin(self, *a, **kw) -> None:
        pass

    def window_end(self, *a, **kw) -> None:
        pass

    def dump_flight(self, path, reason: str) -> bool:
        return False

    def arm_crash_dump(self, path) -> None:
        pass

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
    callers can restore it (core.run does)."""
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


# ---------------------------------------------------------------------------
# Knob coercion (KNB house style: tolerant at runtime, preflight errors)
# ---------------------------------------------------------------------------

def trace_enabled(test: dict | None) -> bool:
    """The ``trace`` knob of the test map, tolerantly
    (``parallel.coerce_flag``): garbage warns and reads as unset."""
    from jepsen_tpu_torch.parallel import coerce_flag
    return bool(coerce_flag((test or {}).get("trace"), knob="trace"))


def flight_recorder_events(test: dict | None) -> int:
    """The flight-recorder ring capacity: ``flight_recorder_events`` in
    the test map, else :data:`DEFAULT_FLIGHT_EVENTS`. ``<= 0`` disables;
    garbage warns and takes the default."""
    v = (test or {}).get("flight_recorder_events")
    if v is None or v == "":
        return DEFAULT_FLIGHT_EVENTS
    if isinstance(v, bool):
        logger.warning("unparsable flight_recorder_events=%r; using "
                       "default %d", v, DEFAULT_FLIGHT_EVENTS)
        return DEFAULT_FLIGHT_EVENTS
    try:
        return max(0, int(float(v)))
    except (TypeError, ValueError):
        logger.warning("unparsable flight_recorder_events=%r; using "
                       "default %d", v, DEFAULT_FLIGHT_EVENTS)
        return DEFAULT_FLIGHT_EVENTS


def for_test(test: dict) -> RunTracer | NullTracer:
    """Builds the run's tracer from its knobs: a Perfetto sink into the
    store dir at ``--trace`` verbosity, a flight recorder unless
    ``flight_recorder_events`` is 0. Returns NULL_TRACER when both are
    off (the default run's hot paths then pay one attribute read)."""
    perfetto = None
    if trace_enabled(test):
        try:
            from jepsen_tpu_torch import store
            perfetto = PerfettoSink(store.path_mk(test, TRACE_NAME))
        except Exception:  # noqa: BLE001 — no store coords: no trace file
            logger.exception("couldn't open %s; span sink off", TRACE_NAME)
    capacity = flight_recorder_events(test)
    flight = FlightRecorder(capacity) if capacity > 0 else None
    if perfetto is None and flight is None:
        return NULL_TRACER
    return RunTracer(perfetto=perfetto, flight=flight)
