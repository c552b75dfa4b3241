"""The flight recorder: a bounded in-memory ring of recent trace events
(the port of jepsen_tpu/trace/flight.py).

The default run pays for no trace file, but a wedge or crash with no
trace is undiagnosable. This ring keeps the most recent N events at near
zero cost and is dumped to ``flight-recorder.jsonl`` only when something
goes wrong (``RunTracer.dump_flight``). The ring is a
``collections.deque(maxlen=N)``: append is one C call and eviction of the
oldest event is native. Not ported: the interpreter's compact op tuples
and their expansion, which come with the run loop that emits them.
"""
from __future__ import annotations

import json
import logging
import os
import time
from collections import deque
from pathlib import Path

logger = logging.getLogger("jepsen_tpu_torch.trace.flight")

# copied from jepsen_tpu/trace/flight.py:41-118, without the op tuples


class FlightRecorder:
    """Fixed-capacity event ring: exactly the most recent ``capacity``
    events survive (deque maxlen semantics — wraparound is native and
    exact)."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("flight recorder needs capacity >= 1")
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)

    def record(self, ev: dict) -> None:
        """One event dict (instants, rung and segment slices)."""
        self._ring.append(ev)

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
        the trigger, then the retained events oldest-first — flushed and
        fsynced (this file is written precisely when the process may be
        about to die). Appends, so a stall dump followed by a crash dump
        keeps both. Returns True on success; never raises."""
        events = self.snapshot()
        try:
            p = Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            with open(p, "a", encoding="utf-8") as f:
                f.write(json.dumps({
                    "flight_recorder": True, "reason": reason,
                    "dumped_at": time.time(), "capacity": self.capacity,
                    "retained": len(events), "timebase": "relative-us",
                }) + "\n")
                for ev in events:
                    f.write(json.dumps(ev, default=str) + "\n")
                f.flush()
                os.fsync(f.fileno())
            logger.warning("flight recorder dumped %d event(s) to %s "
                           "(reason: %s)", len(events), p, reason)
            return True
        except Exception:  # noqa: BLE001 — a crash dump must never raise
            logger.exception("flight-recorder dump to %s failed", path)
            return False

