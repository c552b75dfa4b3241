"""The flight recorder: a bounded in-memory ring of recent trace events
(the port of jepsen_tpu/trace/flight.py).

The *default* run pays for no trace file — but a wedge or crash with no
trace is undiagnosable. This ring keeps the most recent N events (the
last ~seconds of causal context: dispatches, completions, reaps, fault
windows, ladder demotions) at near-zero cost, and is dumped to
``flight-recorder.jsonl`` only when something goes wrong: the
interpreter's stall watchdog, core.run's fatal path, or the atexit
crash hook (doc/observability.md "Causal trace").

Lock-free-ish by design: the ring IS a ``collections.deque(maxlen=N)``
— append is one C call, eviction of the oldest event is native, and
the GIL serializes concurrent emitters. The interpreter's op fast path
(:meth:`appender` — the telemetry ``cell()`` analog) appends raw
``(kind, worker, op-dict-reference)`` tuples with no dict build, no
timestamp read, and no id mint; ALL derivable work (track name, trace
id via :func:`trace_id_for`, wall timestamps from the op's own
relative time + the run's one-shot origin) is deferred to
:func:`expand_op_event` at dump time.
"""
from __future__ import annotations

import json
import logging
import os
import time
from collections import deque
from pathlib import Path

logger = logging.getLogger("jepsen_tpu_torch.trace.flight")

# copied from jepsen_tpu/trace/flight.py:32-161 (whole)

# compact op-tuple kinds (the scheduler's single-writer fast path):
# a 3-tuple (OP_BEGIN, worker, op) at dispatch — flight-ring only, the
# in-flight context a crash dump needs — and a 4-tuple (OP_COMPLETE,
# worker, completion, invoke_time_ns) at completion, which both sinks
# render as one self-contained slice (invoke -> completion)
OP_BEGIN = "B"
OP_COMPLETE = "X"


class FlightRecorder:
    """Fixed-capacity event ring: exactly the most recent ``capacity``
    events survive (deque maxlen semantics — wraparound is native and
    exact)."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("flight recorder needs capacity >= 1")
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        # wall-us minus relative-us at run start; set once by the
        # interpreter so dump timestamps land on the wall clock
        self.op_origin_us: int | None = None

    def record(self, ev) -> None:
        """A full event dict (instants, windows, rung slices) or a
        compact op tuple."""
        self._ring.append(ev)

    def appender(self):
        """The raw bound ``deque.append`` — the single-writer hot-path
        handle (telemetry's ``cell()`` pattern): the interpreter's
        scheduler appends op tuples through this with one C call."""
        return self._ring.append

    @property
    def recorded(self) -> int:
        """Events currently retained (capacity-capped)."""
        return len(self._ring)

    def snapshot(self) -> list:
        """Events oldest->newest. Exact when writers are quiescent
        (dumps happen on stalls/crashes); a concurrent writer can at
        worst add/evict an event mid-copy."""
        return list(self._ring)

    def dump(self, path, reason: str) -> bool:
        """Writes the ring to ``path`` as jsonl — a header row naming
        the trigger, then the retained events oldest-first (op tuples
        expanded to full events) — flushed and fsynced (this file is
        written precisely when the process may be about to die).
        Appends, so a stall dump followed by a crash dump keeps both.
        Returns True on success; never raises."""
        events = self.snapshot()
        try:
            p = Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            with open(p, "a", encoding="utf-8") as f:
                f.write(json.dumps({
                    "flight_recorder": True, "reason": reason,
                    "dumped_at": time.time(), "capacity": self.capacity,
                    "retained": len(events),
                    "timebase": ("wall-us" if self.op_origin_us is not None
                                 else "relative-us"),
                }) + "\n")
                # a dispatch (B) tuple whose op later completed inside
                # the ring is subsumed by its X slice — keep B only for
                # ops still in flight (the context a crash dump is FOR)
                completed = {(ev[1], ev[3]) for ev in events
                             if isinstance(ev, tuple) and len(ev) == 4}
                for ev in events:
                    if isinstance(ev, tuple):
                        if ev[0] == OP_BEGIN and \
                                (ev[1], ev[2].get("time")) in completed:
                            continue
                        ev = expand_op_event(ev, self.op_origin_us)
                    if ev is None:
                        continue
                    f.write(json.dumps(ev, default=str) + "\n")
                f.flush()
                os.fsync(f.fileno())
            logger.warning("flight recorder dumped %d event(s) to %s "
                           "(reason: %s)", len(events), p, reason)
            return True
        except Exception:  # noqa: BLE001 — a crash dump must never raise
            logger.exception("flight-recorder dump to %s failed", path)
            return False


def expand_op_event(ev: tuple, origin_us: int | None) -> dict | None:
    """One compact op tuple -> the full event dict, identical in shape
    to what a synchronous emitter would have produced (same
    track/name/args/trace-id), so the flight dump and trace.json speak
    one schema. Timestamps: the op's own relative nanoseconds shifted
    by the run's one-shot ``origin_us`` (relative-only when the origin
    was never captured — ordering still holds)."""
    from jepsen_tpu_torch.trace import trace_id_for, worker_track
    try:
        track = worker_track(ev[1])
        if ev[0] == OP_BEGIN:
            _, _, op = ev
            t = op.get("time")
            ts = int(t) // 1000 if isinstance(t, (int, float)) else 0
            if origin_us is not None:
                ts += origin_us
            return {"ph": "B", "track": track,
                    "name": str(op.get("f")), "ts": ts,
                    "args": {"process": op.get("process"),
                             "f": str(op.get("f")),
                             "trace_id": trace_id_for(op.get("process"),
                                                      t)}}
        _, _, comp, t0 = ev
        end = comp.get("time")
        if not isinstance(t0, (int, float)):
            t0 = end if isinstance(end, (int, float)) else 0
        ts = int(t0) // 1000
        if origin_us is not None:
            ts += origin_us
        dur = (max(int(end - t0) // 1000, 1)
               if isinstance(end, (int, float)) else 1)
        args = {"process": comp.get("process"),
                "f": str(comp.get("f")),
                "type": comp.get("type"),
                "trace_id": trace_id_for(comp.get("process"), int(t0))}
        if comp.get("error") is not None:
            args["error"] = str(comp.get("error"))
        return {"ph": "X", "track": track, "name": str(comp.get("f")),
                "ts": ts, "dur": dur, "args": args}
    except Exception:  # noqa: BLE001 — one bad tuple can't kill a dump
        logger.exception("couldn't expand op trace tuple")
        return None
