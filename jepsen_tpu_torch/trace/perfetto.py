"""Streaming Perfetto/Chrome Trace Event sink (the port of
jepsen_tpu/trace/perfetto.py).

Writes the JSON *array* form of the Trace Event Format — ``[`` then one
event object per line, comma-terminated. Emission is ASYNCHRONOUS: hot
callers (the interpreter's scheduler) pay one deque append; a
background writer thread drains the queue every
:data:`FLUSH_INTERVAL_S`, expands compact op tuples (same
:func:`~jepsen_tpu.trace.flight.expand_op_event` the flight recorder
dumps through — one schema), serializes, writes, and flushes. The
serialization cost runs while the scheduler is parked in its own queue
waits, and the file's complete-line prefix trails the run by at most
one flush interval, so a SIGKILL'd run still leaves a loadable trace
(Perfetto's and Chrome's JSON importers both accept an unterminated
array; :func:`read_trace_events` is the same tolerant reader for our
own tooling). A clean :meth:`close` drains everything and appends the
``]`` terminator, making the file strictly valid JSON.

Tracks: the tracer's logical track names map to (pid 1, tid n) lanes;
each track's first event is preceded by a ``thread_name`` metadata
event so Perfetto labels the lane.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from pathlib import Path

from jepsen_tpu_torch.trace.flight import expand_op_event

logger = logging.getLogger("jepsen_tpu_torch.trace.perfetto")

# copied from jepsen_tpu/trace/perfetto.py:35-248 (whole)

PID = 1
FLUSH_INTERVAL_S = 0.1
WRITER_JOIN_S = 5.0
# events serialized per GIL-holding stretch: the writer yields between
# chunks so a big backlog can't stall the scheduler for a full drain
DRAIN_CHUNK = 512


class PerfettoSink:
    """Append-only ``trace.json`` writer with a background drain
    thread. ``emit`` never raises and never blocks on I/O — a dying
    trace file must not take down the run it observes (the WAL's
    contract)."""

    def __init__(self, path, flush_interval_s: float = FLUSH_INTERVAL_S):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._q: deque = deque()
        self._tids: dict[str, int] = {}
        # writer-side memo tables for the hot op-tuple shapes: worker ->
        # registered tid, f/process -> their JSON encodings (op streams
        # draw from tiny vocabularies, so each encodes once)
        self._worker_tids: dict = {}
        self._json_memo: dict = {}
        self._events = 0
        self._broken = False
        # wall-us minus relative-us at run start (see FlightRecorder)
        self.op_origin_us: int | None = None
        self._lock = threading.Lock()  # serializes drains (writer/close)
        self._stop = threading.Event()
        self._f = open(self.path, "w", encoding="utf-8")
        self._f.write("[\n")
        self._f.flush()
        self._writer = threading.Thread(
            target=self._writer_loop, daemon=True,
            name="jepsen-trace-writer",
            args=(flush_interval_s,))
        self._writer.start()

    def emit(self, ev) -> None:
        """One tracer event — a full dict ({ph, track, name, ts, ...})
        or a compact op tuple — onto the write queue; the writer owns
        expansion, the pid/tid mapping, and the file. The append is
        deliberately lockless: deque.append is GIL-atomic, and the
        lock below only serializes the drain side (writer vs close)."""
        self._q.append(ev)  # lint: ignore[lock-guard]

    def appender(self):
        """The raw bound queue append for single-writer hot paths
        (the flight recorder's ``appender`` twin)."""
        return self._q.append

    def _writer_loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            while self._drain():
                time.sleep(0)  # yield between chunks (GIL fairness)
        while self._drain():  # close() signaled: sweep the backlog
            pass

    def _track_tid(self, track: str, lines: list[str]) -> int:
        """The track's tid, appending its thread_name metadata line on
        first use. Caller holds the lock."""
        tid = self._tids.get(track)
        if tid is None:
            tid = self._tids[track] = len(self._tids) + 1
            lines.append(json.dumps(
                {"ph": "M", "name": "thread_name", "pid": PID,
                 "tid": tid, "args": {"name": track}}))
        return tid

    def _jmemo(self, value) -> str:
        j = self._json_memo.get(value)
        if j is None:
            j = self._json_memo[value] = json.dumps(value, default=str)
        return j

    def _op_line(self, ev: tuple, lines: list[str]) -> str | None:
        """One compact op tuple -> its JSON line, formatted directly —
        no intermediate dict, memoized f/process encodings. This is
        the writer's hot loop: op events dominate a trace, and the
        direct format keeps the writer thread's GIL share (which the
        scheduler competes with) to a fraction of json.dumps'.
        Dispatch (B) tuples are flight-ring context only — the
        completion's self-contained X slice covers the op here, so a
        trace.json never pays two events per op. Falls back to the
        shared dict expansion for odd shapes (an error'd completion, a
        non-literal time)."""
        if ev[0] == "B":
            return None  # subsumed by the completion's X slice
        _, worker, comp, t0 = ev
        end = comp.get("time")
        if not isinstance(t0, int) or not isinstance(end, int) \
                or comp.get("error") is not None:
            ev2 = expand_op_event(ev, self.op_origin_us)
            if ev2 is None:
                return None
            from jepsen_tpu_torch.trace import worker_track
            out = {k: v for k, v in ev2.items() if k != "track"}
            out["pid"] = PID
            out["tid"] = self._track_tid(worker_track(worker), lines)
            return json.dumps(out, default=str)
        ts = t0 // 1000
        origin = self.op_origin_us
        if origin is not None:
            ts += origin
        dur = (end - t0) // 1000
        if dur < 1:
            dur = 1
        wt = self._worker_tids.get(worker)
        if wt is None:
            from jepsen_tpu_torch.trace import worker_track
            wt = self._worker_tids[worker] = self._track_tid(
                worker_track(worker), lines)
        name_j = self._jmemo(str(comp.get("f")))
        proc = comp.get("process")
        return (f'{{"ph":"X","pid":1,"tid":{wt},"ts":{ts},"dur":{dur},'
                f'"name":{name_j},"args":{{"process":{self._jmemo(proc)},'
                f'"f":{name_j},"type":{self._jmemo(comp.get("type"))},'
                f'"trace_id":"{proc}-{t0}"}}}}')

    def _drain(self) -> bool:
        """Serializes and writes up to DRAIN_CHUNK queued events.
        Returns True when a backlog remains (the writer yields and
        comes straight back), False when the queue is drained."""
        with self._lock:
            if self._broken or self._f.closed or not self._q:
                return False
            lines: list[str] = []
            try:
                for _ in range(DRAIN_CHUNK):
                    try:
                        ev = self._q.popleft()
                    except IndexError:
                        break
                    if isinstance(ev, tuple):
                        line = self._op_line(ev, lines)
                        if line is not None:
                            lines.append(line)
                            self._events += 1
                        continue
                    tid = self._track_tid(ev.get("track", "run"), lines)
                    out = {k: v for k, v in ev.items() if k != "track"}
                    out["pid"] = PID
                    out["tid"] = tid
                    lines.append(json.dumps(out, default=str))
                    self._events += 1
                if lines:
                    # one write + one flush per batch: the kernel page
                    # cache survives a SIGKILL, so the loadable prefix
                    # trails the run by at most one flush interval
                    self._f.write(",\n".join(lines) + ",\n")
                    self._f.flush()
            except (OSError, ValueError, TypeError):
                logger.exception("trace.json write failed; span sink off "
                                 "for the rest of the run")
                self._broken = True
                try:
                    self._f.close()
                except OSError:
                    pass
                return False
            return bool(self._q)

    @property
    def events(self) -> int:
        with self._lock:
            return self._events

    def close(self) -> None:
        """Drains the queue, terminates the array — a final comma-less
        marker event then ``]`` — and closes. Idempotent; a crashed run
        that never gets here still loads (the terminator is optional in
        the Trace Event Format, and :func:`read_trace_events` parses
        per-line either way)."""
        self._stop.set()
        self._writer.join(timeout=WRITER_JOIN_S)
        self._drain()
        with self._lock:
            if self._f.closed:
                return
            try:
                self._f.write(json.dumps(
                    {"ph": "M", "name": "trace_done", "pid": PID,
                     "tid": 0, "args": {"events": self._events}})
                    + "\n]\n")
                self._f.flush()
            except (OSError, ValueError):
                logger.exception("trace.json terminator write failed")
            try:
                self._f.close()
            except OSError:
                pass


def read_trace_events(path, max_bytes: int | None = None) -> list[dict]:
    """Tolerant Trace Event reader: parses the per-line array this sink
    writes (terminated or not), dropping a torn final line — the same
    valid-prefix contract the WAL reader gives history. ``max_bytes``
    bounds the read for summary rendering over huge traces."""
    p = Path(path)
    with open(p, encoding="utf-8", errors="replace") as f:
        data = f.read(max_bytes) if max_bytes else f.read()
    events: list[dict] = []
    for line in data.splitlines():
        line = line.strip().rstrip(",")
        if not line or line in ("[", "]"):
            continue
        try:
            ev = json.loads(line)
        except json.JSONDecodeError:
            continue  # torn tail (or a mid-read cut at max_bytes)
        if isinstance(ev, dict):
            events.append(ev)
    return events
