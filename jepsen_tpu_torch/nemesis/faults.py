"""The durable fault registry's read-only surface (jepsen_tpu/nemesis/
faults.py): what the reports and the anomaly forensics read of a run's
``store/<test>/<ts>/faults.jsonl``.

Registry rows: ``{"op": "inject", "id": n, "kind": ..., "f": ...,
"value": ..., "time": ...}`` and ``{"op": "heal", "id": n, "via": ...,
"time": ...}``, append-only jsonl read with the same torn-tail-tolerant
reader as the history (``journal.read_jsonl_tolerant``).
:func:`history_windows` turns them into fault windows in history time,
which the perf plots shade and ``anomaly.json`` overlays on a witness.

The writer side: :class:`FaultRegistry` records every injected fault
*before* injection (fsynced; a full disk parks rows) and marks it healed
after the closing op or the nemesis teardown; ``core.run`` replays what
a run left unhealed (:func:`replay_unhealed`) with the idempotent heal
actions for net, netem, process and pause faults (file damage is
unhealable). The clock, membership and clock-rate healers wait with
their nemeses (ROADMAP Queue 1 item 11): their rows replay as
unhealable.
"""
from __future__ import annotations

import errno
import json
import logging
import os
import threading
import time
from pathlib import Path
from typing import Any

logger = logging.getLogger("jepsen_tpu_torch.nemesis.faults")

# copied from jepsen_tpu/nemesis/faults.py:49-53
FAULTS_NAME = "faults.jsonl"
# rows held in memory while the disk is full (ENOSPC): fault records
# are few and small, but losing one means an unhealable cluster, so
# the bound is generous
ENOSPC_PARK_MAX_ROWS = 1000

# copied from jepsen_tpu/nemesis/faults.py:65-66
KINDS = ("net", "netem", "clock", "clock-rate", "process", "pause",
         "file", "membership")

# copied from jepsen_tpu/nemesis/faults.py:67-89

# What a successful nemesis teardown restores ("resumes normal
# operation", nemesis.clj contract): everything EXCEPT file damage,
# which no teardown can undo — those entries stay on the books — and
# membership reconfigurations: State.teardown stops the view polling,
# it does NOT restore the pre-op member set, so an unresolved reconfig
# must survive teardown for the crash-path / `cli heal` replay.
TEARDOWN_HEALS = ("net", "netem", "clock", "clock-rate", "process",
                  "pause")

# Kinds with no heal action at all — recorded as evidence, reported as
# unhealable, and not worth a crash-path replay warning on their own.
UNHEALABLE_KINDS = ("file",)

# Kinds the interpreter's GENERIC pre-fire snapshot must never record:
# a membership record is only actionable with the pre-op member set and
# a heal spec, which only a self-recording nemesis
# (``Nemesis.self_recorded_kinds``, e.g. MembershipNemesis) can supply.
# A generic row would be permanently-unhealed noise — and several
# pre-existing suites (faunadb topology's add-node/remove-node,
# rethinkdb's reconfigure) legitimately use membership-flavored ``:f``
# names with plain nemeses that keep no model at all.
SELF_RECORDED_ONLY = ("membership",)

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


# copied from jepsen_tpu/nemesis/faults.py:156-329
class FaultRegistry:  # durability: fsync
    """Append-only durable fault log. Thread-safe: nemesis ops arrive on
    the nemesis worker thread while teardown/replay run on the
    orchestrator thread."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._entries: dict[int, dict] = {}
        self._healed: set[int] = set()
        self._next_id = 0
        if self.path.exists():
            self._load()
        self._f = open(self.path, "a", encoding="utf-8")
        # ENOSPC park (doc/robustness.md "Fleet HA"): rows waiting for
        # the disk to drain, retried on the next _append/close. Rows
        # are idempotent on load (keyed by id), so the torn/duplicate
        # lines a failed flush can leave are harmless; the tolerant
        # reader skips them.
        self._parked: list[str] = []
        self._dirty_tail = False

    def _load(self) -> None:
        from jepsen_tpu_torch.journal import read_jsonl_tolerant
        rows, _truncated = read_jsonl_tolerant(self.path)
        for row in rows:
            rid = row.get("id")
            if not isinstance(rid, int):
                continue
            if row.get("op") == "inject":
                self._entries[rid] = row
                self._next_id = max(self._next_id, rid + 1)
            elif row.get("op") == "heal":
                self._healed.add(rid)

    def _append(self, row: dict) -> None:
        from jepsen_tpu_torch.store import _serializable
        line = json.dumps(_serializable(row)) + "\n"
        reopened = self._f.closed
        if reopened:
            # a LATE record — a reaped fault injection landing after the
            # run closed the registry (interpreter zombie thread) — must
            # still reach the durable log: it may be the only evidence
            # the cluster is dirty. Append-only jsonl makes a one-shot
            # reopen safe.
            self._f = open(self.path, "a", encoding="utf-8")
        try:
            # a bare newline terminates whatever partial line a failed
            # flush left (readers skip torn lines); the ENOSPC backlog
            # rides along before the new row
            prefix = ("\n" if self._dirty_tail else "") \
                + "".join(self._parked)
            self._f.write(prefix + line)
            self._f.flush()
            os.fsync(self._f.fileno())
            if self._parked or self._dirty_tail:
                logger.info("fault registry %s recovered from ENOSPC; "
                            "%d parked row(s) flushed", self.path,
                            len(self._parked))
            self._parked = []
            self._dirty_tail = False
        except OSError as e:
            if e.errno != errno.ENOSPC:
                raise
            # disk full is transient: park the row (bounded) for the
            # next _append/close instead of losing the only evidence a
            # fault was injected — a full disk must not make the
            # registry permanently self-disable (doc/robustness.md
            # "Fleet HA")
            self._dirty_tail = True
            if len(self._parked) < ENOSPC_PARK_MAX_ROWS:
                self._parked.append(line)
            logger.warning("fault registry %s hit ENOSPC; row parked "
                           "for retry (%d waiting)", self.path,
                           len(self._parked))
        finally:
            if reopened:
                try:
                    self._f.close()
                except OSError:
                    pass

    def record(self, kind: str, f=None, value: Any = None) -> int:
        """Durably records an injection BEFORE it happens; returns the
        fault id. If the control process dies right after, the entry is
        already on disk for ``cli heal``."""
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            row = {"op": "inject", "id": rid, "kind": kind, "f": f,
                   "value": value, "time": time.time()}
            self._entries[rid] = row
            self._append(row)
        self._count("nemesis_faults_recorded_total", kind)
        # causal trace: the DURABLE registry is the source of truth for
        # fault windows (not the op stream — crash-replayed heals and
        # late re-records only exist here); async slices keyed by fault
        # id so overlapping windows never interleave
        from jepsen_tpu_torch import trace as trace_mod
        tracer = trace_mod.get_tracer()
        if tracer.enabled:
            tracer.window_begin(trace_mod.TRACK_NEMESIS, str(kind),
                                wid=f"fault-{rid}",
                                args={"f": str(f), "id": rid})
        return rid

    def mark_healed(self, fault_id: int | None = None,
                    kind: str | None = None, kinds=None,
                    via: str = "nemesis") -> list[int]:
        """Marks faults healed: one by id, every unhealed fault of a
        kind (or of any kind in ``kinds``), or — all selectors None —
        every unhealed fault. Returns the ids marked."""
        with self._lock:
            if fault_id is not None:
                ids = ([fault_id] if fault_id in self._entries
                       and fault_id not in self._healed else [])
            else:
                wanted = (set(kinds) if kinds is not None
                          else {kind} if kind is not None else None)
                ids = [rid for rid, row in sorted(self._entries.items())
                       if rid not in self._healed
                       and (wanted is None or row.get("kind") in wanted)]
            for rid in ids:
                self._healed.add(rid)
                self._append({"op": "heal", "id": rid, "via": via,
                              "time": time.time()})
        for rid in ids:
            self._count("nemesis_faults_healed_total",
                        self._entries[rid].get("kind"))
        if ids:
            from jepsen_tpu_torch import trace as trace_mod
            tracer = trace_mod.get_tracer()
            if tracer.enabled:
                for rid in ids:
                    tracer.window_end(
                        trace_mod.TRACK_NEMESIS,
                        str(self._entries[rid].get("kind")),
                        wid=f"fault-{rid}", args={"via": via})
        return ids

    def unhealed(self) -> list[dict]:
        with self._lock:
            return [dict(row) for rid, row in sorted(self._entries.items())
                    if rid not in self._healed]

    def close(self) -> None:
        with self._lock:
            if (self._parked or self._dirty_tail) and not self._f.closed:
                # last ENOSPC-drain try before the handle goes away
                try:
                    self._f.write(("\n" if self._dirty_tail else "")
                                  + "".join(self._parked))
                    self._f.flush()
                    os.fsync(self._f.fileno())
                    self._parked = []
                    self._dirty_tail = False
                except OSError:
                    logger.warning("fault registry %s: %d parked row(s) "
                                   "lost at close (disk still full)",
                                   self.path, len(self._parked))
            if not self._f.closed:
                try:
                    self._f.close()
                except OSError:
                    pass

    @staticmethod
    def _count(metric: str, kind) -> None:
        from jepsen_tpu_torch import telemetry
        reg = telemetry.get_registry()
        if reg.enabled:
            reg.counter(metric, "durable fault-registry entries",
                        labels=("kind",)).inc(kind=str(kind))


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


# copied from jepsen_tpu/nemesis/faults.py:410-503, without the clock
# healer and the IPTables default
def actionable_unhealed(registry: FaultRegistry) -> tuple[list[dict],
                                                          list[dict]]:
    """Splits the registry's unhealed entries into ``(actionable,
    evidence)`` — *evidence* being :data:`UNHEALABLE_KINDS` rows (file
    damage), which a crash-path replay should report, never retry."""
    pending = registry.unhealed()
    actionable = [r for r in pending
                  if str(r.get("kind")) not in UNHEALABLE_KINDS]
    evidence = [r for r in pending
                if str(r.get("kind")) in UNHEALABLE_KINDS]
    return actionable, evidence


class Unhealable(Exception):
    """This fault kind cannot be healed with the handles available
    (e.g. a process kill from ``cli heal``, where the db object is
    gone, or file damage with no inverse)."""


# ---------------------------------------------------------------------------
# Heal actions — each idempotent over the whole cluster
# ---------------------------------------------------------------------------

def _net_for(test: dict):
    net = test.get("net")
    if net is not None:
        return net
    # offline heal: the serialized test map dropped the net object;
    # rebuild the default for the transport (IPTables waits with the
    # real remotes, ROADMAP Queue 1 item 11)
    from jepsen_tpu_torch.net import NoopNet
    if (test.get("ssh") or {}).get("dummy"):
        return NoopNet()
    raise Unhealable("no live net object, and the port has no IPTables "
                     "net to rebuild for a real transport")


def _heal_net(test: dict) -> None:
    _net_for(test).heal(test)


def _heal_netem(test: dict) -> None:
    _net_for(test).fast(test)


def _db_heal(test: dict, method: str) -> None:
    from jepsen_tpu_torch import db as db_mod
    from jepsen_tpu_torch.utils import real_pmap
    db = test.get("db")
    want = db_mod.Process if method == "start" else db_mod.Pause
    if db is None or not isinstance(db, want):
        raise Unhealable(
            f"no live db object implementing {method!r}; restart the "
            "cluster's processes manually or re-run from a live test map")
    fn = db.start if method == "start" else db.resume
    real_pmap(lambda n: fn(test, n), list(test.get("nodes") or []))


def _heal_process(test: dict) -> None:
    _db_heal(test, "start")


def _heal_pause(test: dict) -> None:
    _db_heal(test, "resume")


def _heal_file(test: dict) -> None:
    raise Unhealable("file damage (truncate/bitflip) has no inverse; "
                     "the db setup cycle must rebuild the node")

HEALERS = {
    "net": _heal_net,
    "netem": _heal_netem,
    "process": _heal_process,
    "pause": _heal_pause,
    "file": _heal_file,
}


# copied from jepsen_tpu/nemesis/faults.py:560-617, without the row
# healers of membership and clock-rate faults
def replay_unhealed(test: dict, registry: FaultRegistry,
                    tries: int = 4, rng=None) -> dict:
    """Heals every unhealed fault in the registry, grouped by kind (one
    idempotent cluster-wide action heals any number of same-kind
    faults), each action retried with capped-exponential full-jitter
    backoff. Entries are marked healed only after their action
    succeeded — a second replay is exactly a no-op. Returns
    ``{"healed": [...], "unhealable": [...], "failed": [...]}`` id
    lists."""
    from jepsen_tpu_torch import telemetry
    from jepsen_tpu_torch.utils import retry_with_backoff

    out: dict[str, list[int]] = {"healed": [], "unhealable": [],
                                 "failed": []}
    pending = registry.unhealed()
    if not pending:
        return out
    by_kind: dict[str, list[dict]] = {}
    for row in pending:
        by_kind.setdefault(str(row.get("kind")), []).append(row)
    reg = telemetry.get_registry()
    for kind in sorted(by_kind):
        rows = by_kind[kind]
        ids = [r["id"] for r in rows]
        healer = HEALERS.get(kind)
        try:
            if healer is None:
                raise Unhealable(f"no healer registered for kind {kind!r}")
            action = lambda: healer(test)  # noqa: E731
            # Unhealable is a terminal verdict, not a flake: no backoff
            retry_with_backoff(action, tries=tries, rng=rng,
                               desc=f"heal {kind}", no_retry=(Unhealable,))
        except Unhealable as e:
            logger.warning("faults %s (kind %s) left unhealed: %s",
                           ids, kind, e)
            out["unhealable"].extend(ids)
            continue
        except Exception:  # noqa: BLE001 — keep healing the other kinds
            logger.exception("heal replay for kind %r failed after %d "
                             "tries", kind, tries)
            out["failed"].extend(ids)
            continue
        registry.mark_healed(kind=kind, via="replay")
        out["healed"].extend(ids)
        if reg.enabled:
            reg.counter("nemesis_heal_replayed_total",
                        "fault heals applied by crash-path/cli replay",
                        labels=("kind",)).inc(len(ids), kind=kind)
    return out
