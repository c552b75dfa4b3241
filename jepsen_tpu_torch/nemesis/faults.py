"""The durable fault registry's read-only surface (jepsen_tpu/nemesis/
faults.py): what the reports and the anomaly forensics read of a run's
``store/<test>/<ts>/faults.jsonl``.

Registry rows: ``{"op": "inject", "id": n, "kind": ..., "f": ...,
"value": ..., "time": ...}`` and ``{"op": "heal", "id": n, "via": ...,
"time": ...}``, append-only jsonl read with the same torn-tail-tolerant
reader as the history (``journal.read_jsonl_tolerant``).
:func:`history_windows` turns them into fault windows in history time,
which the perf plots shade and ``anomaly.json`` overlays on a witness.

Not ported: the registry itself (``FaultRegistry``, its writer and
fsync, the ENOSPC park), the heal actions and their replay, and
``actionable_unhealed``. They come with the nemesis and the run loop
that inject faults (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

from pathlib import Path

# copied from jepsen_tpu/nemesis/faults.py:49
FAULTS_NAME = "faults.jsonl"

# copied from jepsen_tpu/nemesis/faults.py:65-66
KINDS = ("net", "netem", "clock", "clock-rate", "process", "pause",
         "file", "membership")

# copied from jepsen_tpu/nemesis/faults.py:102-133 (the table
# inside classify), hoisted to a module constant: (phase, kind) of the
# nemesis :f names that open or close a fault window
_TABLE = {
    "start-partition": ("begin", "net"), "partition": ("begin", "net"),
    "snub": ("begin", "net"),
    "stop-partition": ("end", "net"), "heal": ("end", "net"),
    "slow": ("begin", "netem"), "flaky": ("begin", "netem"),
    "start-netem": ("begin", "netem"),
    "fast": ("end", "netem"), "stop-netem": ("end", "netem"),
    "bump": ("begin", "clock"), "strobe": ("begin", "clock"),
    "scramble-clock": ("begin", "clock"),
    "start-clock": ("begin", "clock"),
    "reset": ("end", "clock"), "reset-time": ("end", "clock"),
    "stop-clock": ("end", "clock"),
    "kill": ("begin", "process"),
    "pause": ("begin", "pause"), "resume": ("end", "pause"),
    "start-pause": ("begin", "pause"), "stop-pause": ("end", "pause"),
    "truncate-file": ("begin", "file"), "bitflip": ("begin", "file"),
    # membership reconfigurations: each op is a one-shot state
    # transition, opened as "begin" and healed by resolution, never by a
    # closing op
    "grow": ("begin", "membership"), "shrink": ("begin", "membership"),
    "join": ("begin", "membership"), "leave": ("begin", "membership"),
    "add-node": ("begin", "membership"),
    "remove-node": ("begin", "membership"),
    "rolling-restart": ("begin", "membership"),
    "reconfigure": ("begin", "membership"),
    "start-clock-rate": ("begin", "clock-rate"),
    "stop-clock-rate": ("end", "clock-rate"),
}


# copied from jepsen_tpu/nemesis/faults.py:92-153
def classify(f) -> tuple[str | None, str | None]:
    """``(phase, kind)`` for a nemesis op :f — ``("begin", "net")`` for
    an op that opens a fault window, ``("end", "net")`` for one that
    closes it, ``(None, None)`` when the op is not a fault (or is the
    ambiguous bare ``start``/``stop`` pair, which the kill package uses
    as heal/fault in the *opposite* sense from the raw partitioner)."""
    if not isinstance(f, str):
        return None, None
    n = f.replace("_", "-")
    if n in _TABLE:
        return _TABLE[n]
    # package convention: start-<x>/stop-<x> open and close an <x>
    # window — but only map to a kind we know how to heal. An unknown
    # suffix (yugabyte's stop-master is a fault INJECTION, not a heal)
    # must not be guessed at: wrong bookkeeping is worse than none.
    for prefix, phase in (("start-", "begin"), ("stop-", "end")):
        if n.startswith(prefix):
            base = n[len(prefix):]
            if base in KINDS:
                return phase, base
            if "partition" in base:
                return phase, "net"
            return None, None
    # bare "start"/"stop" are ambiguous and are NOT classified
    return None, None


# copied from jepsen_tpu/nemesis/faults.py:332-342
def load_rows(path) -> list[dict]:
    """Every row of a ``faults.jsonl`` (torn-tail tolerant, like the
    registry's own loader); [] when the file is absent/unreadable."""
    from jepsen_tpu_torch.journal import read_jsonl_tolerant
    try:
        rows, _truncated = read_jsonl_tolerant(Path(path))
    except OSError:
        return []
    return [r for r in rows if isinstance(r, dict)]


# copied from jepsen_tpu/nemesis/faults.py:345-365
def pair_rows(rows: list[dict]) -> list[dict]:
    """Inject rows joined with their heal rows: ``[{id, kind, f, value,
    t_wall, healed, via, t_heal_wall}]`` in injection order. Wall-clock
    times (the registry records ``time.time()``); use
    :func:`history_windows` for history-relative overlays."""
    heals: dict = {}
    for r in rows:
        if r.get("op") == "heal":
            heals.setdefault(r.get("id"), r)
    out = []
    for r in rows:
        if r.get("op") != "inject":
            continue
        h = heals.get(r.get("id"))
        out.append({"id": r.get("id"), "kind": r.get("kind"),
                    "f": r.get("f"), "value": r.get("value"),
                    "t_wall": r.get("time"),
                    "healed": h is not None,
                    "via": (h or {}).get("via"),
                    "t_heal_wall": (h or {}).get("time")})
    return out


# copied from jepsen_tpu/nemesis/faults.py:368-407
def history_windows(history: list[dict], rows: list[dict]) -> list[dict]:
    """Fault windows in HISTORY time: each durable inject record matched
    (in order, by ``:f``) to its nemesis op in the history for the start
    edge; the end edge is the next nemesis op classifying as
    ``("end", same kind)``, else open. A window whose heal happened
    OUTSIDE the history (nemesis teardown, a crash-path replay) keeps
    ``end_time: None`` with ``healed``/``via`` set. Registry rows with no
    matching history op (a crash before the injection journaled) are
    skipped."""
    paired = pair_rows(rows)
    queues: dict = {}
    for w in paired:
        queues.setdefault(w.get("f"), []).append(w)
    open_by_kind: dict[str, list[dict]] = {}
    out: list[dict] = []
    for op in history or []:
        if op.get("process") != "nemesis" or op.get("type") != "info":
            continue
        f = op.get("f")
        phase, kind = classify(f)
        if phase == "begin":
            q = queues.get(f)
            rec = q.pop(0) if q else None
            win = {"kind": kind if rec is None else rec.get("kind"),
                   "f": f, "start_time": op.get("time"),
                   "end_time": None,
                   "healed": bool(rec and rec.get("healed")),
                   "via": (rec or {}).get("via"),
                   "record_id": (rec or {}).get("id"),
                   "in_registry": rec is not None}
            out.append(win)
            open_by_kind.setdefault(win["kind"], []).append(win)
        elif phase == "end":
            opened = open_by_kind.get(kind) or []
            if opened:
                win = opened.pop(0)
                win["end_time"] = op.get("time")
    return out
