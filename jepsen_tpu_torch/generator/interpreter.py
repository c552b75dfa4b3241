"""Threaded interpreter: bridges the pure generator to real client threads
(the port of jepsen_tpu/generator/interpreter.py).

Reference: jepsen/src/jepsen/generator/interpreter.clj. One thread per
client worker plus one for the nemesis; each worker has a size-1 in-queue,
all share a completion queue; a single scheduler thread alternates between
polling completions and asking the generator for ops (interpreter.clj:
181-310). Crashed ops (:info) renumber the worker's process and force a
client reopen unless the client is reusable (:33-67, :142-157). Pseudo-ops
(:sleep/:log) are handled in-worker and excluded from history (:172-179).

Deadlines and reaping (doc/robustness.md): the reference blocks forever
on a client that never returns — one hung ``Client.invoke`` wedges the
whole run. Here every history-bound op carries a deadline (``op
['timeout_s']`` → ``test['op_timeout_s']`` → :data:`DEFAULT_OP_TIMEOUT_S`,
``None``/``0`` disables) and the scheduler's wait points clamp to the
earliest one. On expiry the scheduler synthesizes an indeterminate
``{:type :info, :error [op-timeout ...]}`` completion — journaled and
process-renumbered like any crash — marks the worker *zombie*, and spawns
a replacement thread under the same worker id with a bumped generation.
A zombie's late completion (stale generation) is quarantined to the
run's ``late.jsonl``, never appended to history; the zombie's client is
closed by the zombie's own thread when it finally unblocks, never
concurrently by the scheduler. The drain phase runs under its own
deadline (``drain_timeout_s``), and a stall detector
(``stall_s``) dumps all thread stacks into the store dir when
neither a dispatch nor a completion happens for too long.
"""
from __future__ import annotations

import logging
import queue
import threading
import time as _time
from typing import Any

from jepsen_tpu_torch import client as client_mod, telemetry
from jepsen_tpu_torch import journal as journal_mod
from jepsen_tpu_torch import trace as trace_mod
from jepsen_tpu_torch.generator import (
    NEMESIS, PENDING, Context, as_gen, context, friendly_exceptions, validate,
)
from jepsen_tpu_torch.utils import (
    relative_time_nanos, relative_time_origin, with_relative_time,
)

logger = logging.getLogger("jepsen_tpu_torch.interpreter")

# copied from jepsen_tpu/generator/interpreter.py:49-1036, with _knob
# reading the test map and the default only

# Max time between generator re-polls when pending, µs (interpreter.clj:166-170)
MAX_PENDING_INTERVAL_S = 0.001

# Completions processed (and WAL records coalesced) per scheduler drain
# chunk (doc/performance.md "Host ingest spine").
DEFAULT_SCHED_BATCH_OPS = 256

# Deadline defaults (doc/robustness.md). The op timeout is deliberately
# generous: it exists to unwedge a run, not to police slow databases —
# a synthesized :info is indeterminate, and flooding a history with
# them tells the checker nothing.
DEFAULT_OP_TIMEOUT_S = 600.0
DEFAULT_DRAIN_TIMEOUT_S = 60.0
DEFAULT_STALL_S = 300.0
# How often the drain loop wakes to re-check its deadlines when no
# completion arrives, and how long the shutdown path waits for worker
# threads (and thus their self-closed clients) before abandoning them.
DRAIN_POLL_S = 0.5
SHUTDOWN_JOIN_S = 5.0

STALL_DUMP_NAME = "stall-threads.txt"

_UNSET = object()


def _knob(test: dict, key: str, default: float) -> float | None:
    """A timeout knob: the test map's value, else the default.
    ``None``/``0`` disables and returns None."""
    return float(test.get(key, default) or 0) or None


def _coerce_timeout(v, fallback: float | None) -> float | None:
    """A per-op ``timeout_s`` override, tolerantly: falsy (incl. "0")
    disables, garbage degrades to ``fallback`` with a warning — a bad
    op field must not kill the scheduler."""
    if not v:
        return None
    try:
        return float(v) or None
    except (TypeError, ValueError):
        logger.warning("unparsable op timeout_s=%r; using %s", v, fallback)
        return fallback


class _Exit:
    pass


_EXIT = _Exit()


class _SchedBus:
    """Chunked completion bus between workers and the scheduler.

    Workers stage compact ``(worker_id, generation, payload)`` tuples;
    the scheduler drains the staged run (up to ``max_chunk``) in ONE
    lock round instead of one queue hop per completion — the
    scheduler-side analog of the batched trace emission, and the thing
    that lets the WAL coalesce a whole chunk into one write+fsync.
    Arrival order is preserved exactly (stages append under the lock),
    so history order, generator updates, and the late-quarantine
    bookkeeping see the same schedule a per-op queue.Queue would.
    """

    def __init__(self):
        self.max_chunk = DEFAULT_SCHED_BATCH_OPS
        self._cv = threading.Condition(threading.Lock())
        self._staged: list = []

    def put(self, item) -> None:  # owner: worker
        with self._cv:
            self._staged.append(item)
            self._cv.notify()

    def qsize(self) -> int:  # owner: scheduler (sampled metric only)
        with self._cv:
            return len(self._staged)

    def drain_nowait(self) -> list:  # owner: scheduler
        # racy truthiness peek: a miss only delays one poll round, and
        # the hot loop skips a lock acquisition on every empty pass
        if not self._staged:
            return []
        with self._cv:
            return self._take()

    def drain(self, timeout: float) -> list:  # owner: scheduler
        """Blocks up to ``timeout`` for the first staged tuple; an empty
        list is the queue.Empty analog (the wait genuinely timed out —
        wait_for rides out spurious wakeups, and a notify always leaves
        something staged for _take)."""
        with self._cv:
            self._cv.wait_for(lambda: self._staged, timeout)
            return self._take()

    def _take(self) -> list:
        staged = self._staged
        if len(staged) <= self.max_chunk:
            self._staged = []
            return staged
        chunk = staged[:self.max_chunk]
        del staged[:self.max_chunk]
        return chunk


class Worker:
    """One sequential execution context (interpreter.clj:19-31)."""

    def open(self, test: dict, worker_id) -> "Worker":
        return self

    def invoke(self, test: dict, op: dict) -> dict:
        raise NotImplementedError

    def close(self, test: dict) -> None:
        pass


class ClientWorker(Worker):
    """Wraps a Client; reopens it when its process crashes
    (interpreter.clj:33-67)."""

    def __init__(self, node: str, client: client_mod.Client | None = None,
                 process=None):
        self.node = node
        self.client = client
        self.process = process

    def open(self, test, worker_id):
        return self

    def _ensure_client(self, test, process):
        if self.client is not None and (
            self.process == process or getattr(self.client, "reusable", False)
        ):
            self.process = process
            return self.client
        if self.client is not None:
            try:
                self.client.close(test)
            except Exception:  # noqa: BLE001
                logger.exception("error closing client for reopen")
            self.client = None
        self.client = test["client"].open(test, self.node)
        self.process = process
        return self.client

    def invoke(self, test, op):  # owner: worker
        try:
            c = self._ensure_client(test, op.get("process"))
        except Exception as e:  # noqa: BLE001
            logger.exception("client open failed")
            return {**op, "type": "fail", "error": ["no-client", repr(e)]}
        try:
            return c.invoke(test, op)
        except Exception as e:  # noqa: BLE001
            logger.exception("client op crashed")
            # indeterminate: the op may or may not have happened
            # (interpreter.clj:142-157)
            return {**op, "type": "info", "error": ["indeterminate", repr(e)]}

    def close(self, test):
        if self.client is not None:
            self.client.close(test)
            self.client = None


class NemesisWorker(Worker):
    """Applies ops via the test's nemesis (interpreter.clj:69-76).

    When the test carries a durable fault registry (``test['_faults']``,
    installed by core.run), fault-opening ops are recorded to
    ``faults.jsonl`` BEFORE injection and fault-closing ops mark their
    kind healed after they complete cleanly — the exactly-once-heal
    ledger a crashed run's recovery replays (doc/robustness.md).

    Unlike clients (reopened per process), the nemesis OBJECT is shared:
    after a deadline reap, the replacement worker invokes the same
    ``test['nemesis']`` while the zombie may still be blocked inside it.
    Nemeses must tolerate that — per-call transports and idempotent
    heal actions (the existing package contract) already do."""

    # Set by _spawn_worker: when the scheduler reaps this worker at a
    # deadline, a fault-closing op that later completes must NOT mark
    # its kind healed — the synthesized :info already stands and the
    # entry stays on the books for the crash-path / cli-heal replay.
    zombied: threading.Event | None = None

    # the fault row must be on disk before the injection fires; the
    # durability-protocol lint rule holds this method to that order
    # durability: record-before-act
    def invoke(self, test, op):  # owner: worker
        reg = telemetry.get_registry()
        if reg.enabled:
            f = str(op.get("f"))
            reg.counter("nemesis_ops_total", "nemesis ops applied",
                        labels=("f",)).inc(f=f)
            phase = telemetry.fault_phase(op.get("f"))
            if phase is not None:
                reg.event("nemesis-fault", f=f, phase=phase,
                          value=repr(op.get("value")))
                gauge = reg.gauge("nemesis_fault_active",
                                  "open fault windows (begin - end events)")
                gauge.inc() if phase == "begin" else gauge.dec()
        nemesis = test.get("nemesis")
        faults = test.get("_faults") if nemesis is not None else None
        fault_phase = fault_kind = None
        if faults is not None:
            from jepsen_tpu_torch.nemesis import self_recorded_kinds
            from jepsen_tpu_torch.nemesis.faults import (
                SELF_RECORDED_ONLY, classify,
            )
            fault_phase, fault_kind = classify(op.get("f"))
            if fault_kind is not None \
                    and (fault_kind in SELF_RECORDED_ONLY
                         or fault_kind in self_recorded_kinds(nemesis)):
                # the nemesis keeps its own (richer) registry books for
                # this kind — e.g. membership records the pre-op member
                # set and heal-marks at resolution; a generic record
                # here would double-book an entry nothing ever heals.
                # SELF_RECORDED_ONLY kinds are ALSO skipped for plain
                # nemeses (faunadb topology, rethinkdb reconfigure):
                # without a model there is no pre-op set to restore,
                # and an unhealable row is worse than none
                fault_phase = fault_kind = None
            if fault_phase == "begin":
                try:
                    faults.record(fault_kind, f=op.get("f"),
                                  value=op.get("value"))
                except Exception:  # noqa: BLE001 — never blocks injection
                    logger.exception("fault registry record failed")
        try:
            if nemesis is None:
                return {**op, "type": "info"}
            completion = nemesis.invoke(test, op)
            if completion is None:
                completion = {**op}
            completion.setdefault("type", "info")
            if (faults is not None and fault_phase == "begin"
                    and completion.get("error") is None
                    and self.zombied is not None
                    and self.zombied.is_set()):
                # the injection landed AFTER this worker was reaped: a
                # same-kind closing op may already have marked the
                # pre-recorded entry healed, so put the fault back on
                # the books — the replay / `cli heal` must know the
                # late injection exists
                try:
                    faults.record(fault_kind, f=op.get("f"),
                                  value=op.get("value"))
                    logger.warning(
                        "fault-opening op %r completed after its "
                        "deadline; re-recorded kind %r as unhealed",
                        op.get("f"), fault_kind)
                except Exception:  # noqa: BLE001
                    logger.exception("late fault re-record failed")
            if (faults is not None and fault_phase == "end"
                    and completion.get("error") is None):
                if self.zombied is not None and self.zombied.is_set():
                    # this closing op outlived its deadline: the run
                    # already recorded an indeterminate :info for it, so
                    # the entry must stay unhealed — core.run's
                    # crash-path replay / `cli heal` restores the network
                    logger.warning(
                        "fault-closing op %r completed after its "
                        "deadline; leaving kind %r unhealed for replay",
                        op.get("f"), fault_kind)
                else:
                    try:
                        faults.mark_healed(kind=fault_kind, via="nemesis")
                    except Exception:  # noqa: BLE001
                        logger.exception("fault registry heal-mark failed")
            return completion
        except Exception as e:  # noqa: BLE001
            logger.exception("nemesis op crashed")
            return {**op, "type": "info", "error": ["indeterminate", repr(e)]}


def goes_in_history(op: dict) -> bool:
    """:sleep and :log pseudo-ops are invisible (interpreter.clj:172-179)."""
    return op.get("type") not in ("sleep", "log")


# Per-worker-thread state, installed by _spawn_worker's run() so code
# called FROM a worker (clients, nemeses) can learn its fate without a
# worker handle. Off-worker threads see nothing.
_worker_tls = threading.local()


def current_worker_zombie():
    """The calling thread's zombie event (None off-worker) — helpers
    that hop threads (``utils.timeout``) hand it to their child via
    :func:`adopt_worker_zombie` so :func:`current_op_reaped` keeps
    answering for the logical op, not the physical thread."""
    return getattr(_worker_tls, "zombied", None)


def adopt_worker_zombie(event) -> None:
    if event is not None:
        _worker_tls.zombied = event


def current_op_reaped() -> bool:
    """True when the calling thread is an interpreter worker whose
    in-flight op was reaped at its deadline (the worker is zombied and a
    synthesized indeterminate ``:info`` already stands in the history).
    Client/nemesis code consults this to keep late side effects off the
    books — e.g. the membership nemesis leaves its registry entry
    unhealed so the crash-path / ``cli heal`` replay restores the
    pre-op member set (doc/robustness.md)."""
    ev = getattr(_worker_tls, "zombied", None)
    return ev is not None and ev.is_set()


def _spawn_worker(test: dict, worker_id, completions: "_SchedBus",
                  generation: int = 0):
    """Worker thread + its in-queue (interpreter.clj:99-164).

    Every completion is tagged with this worker's ``generation`` so the
    scheduler can tell a live worker's result from a reaped zombie's
    late one. The worker owns its client's lifecycle: it closes the
    client from its own thread on ``_EXIT`` — and, when zombied, after
    its one outstanding op finally unblocks — so a close can never race
    a mid-``invoke`` use of the same client object."""
    in_q: queue.Queue = queue.Queue(maxsize=1)
    if worker_id == NEMESIS:
        worker: Worker = NemesisWorker()
    else:
        nodes = test.get("nodes") or [None]
        worker = ClientWorker(nodes[worker_id % len(nodes)])
    zombied = threading.Event()
    if isinstance(worker, NemesisWorker):
        worker.zombied = zombied

    def close_own_client():  # owner: worker
        if isinstance(worker, ClientWorker):
            try:
                worker.close(test)
            except Exception:  # noqa: BLE001
                logger.exception("worker %s client close failed", worker_id)

    def run():  # owner: worker
        threading.current_thread().name = (
            f"jepsen-worker-{worker_id}"
            + (f".{generation}" if generation else ""))
        _worker_tls.zombied = zombied
        while True:
            op = in_q.get()
            if op is _EXIT:
                # close-before-ack: when the scheduler sees this exit
                # marker, the client is already released (a hung close
                # is therefore caught by the drain deadline)
                close_own_client()
                completions.put((worker_id, generation, _EXIT))
                return
            typ = op.get("type")
            if typ == "sleep":
                _time.sleep(op.get("value") or 0)
                completion = {**op}
            elif typ == "log":
                logger.info("%s", op.get("value"))
                completion = {**op}
            else:
                completion = worker.invoke(test, op)
            completions.put((worker_id, generation, completion))
            if zombied.is_set():
                # reaped mid-op: the completion above will be
                # quarantined (stale generation); close our own client
                # and die — a replacement already took this worker id
                close_own_client()
                return

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return {"id": worker_id, "in": in_q, "thread": t, "worker": worker,
            "gen": generation, "zombied": zombied}


class _StallWatchdog:
    """Detects a wedged run: history-bound ops in flight, yet neither a
    dispatch nor a completion for ``stall_s`` seconds. Fires once per
    stall episode: a telemetry event + counter, a warning, and an
    all-threads stack dump into the store dir (``stall-threads.txt``) so
    the wedge is diagnosable post-mortem. Re-arms only after activity
    resumes. ``inflight_probe`` gates firing: a schedule that is merely
    *quiet* (nothing in flight — a long :sleep, future-dated ops spaced
    far apart) is not a stall."""

    def __init__(self, test: dict, stall_s: float | None, activity: list,
                 inflight_probe=None):
        self.test = test
        self.stall_s = stall_s
        self.activity = activity
        self.inflight_probe = inflight_probe or (lambda: True)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "_StallWatchdog":
        if self.stall_s:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="jepsen-stall-watchdog")
            self._thread.start()
        return self

    def _loop(self) -> None:  # owner: any
        fired_at = None
        poll = min(max(self.stall_s / 4.0, 0.05), 5.0)
        while not self._stop.wait(poll):
            if not self.inflight_probe():
                fired_at = None
                continue  # quiet schedule, not a stall
            last = self.activity[0]
            if _time.monotonic() - last < self.stall_s:
                fired_at = None
                continue
            if fired_at == last:
                continue  # this episode is already on the record
            fired_at = last
            self._fire(_time.monotonic() - last)

    def _fire(self, idle_s: float) -> None:
        logger.warning("interpreter stalled: no dispatch or completion "
                       "for %.1fs; dumping thread stacks", idle_s)
        reg = telemetry.get_registry()
        if reg.enabled:
            reg.counter(
                "interpreter_stalls_total",
                "stall-detector trips (no dispatch or completion for "
                "stall_s)").inc()
            reg.event("interpreter-stall", idle_s=round(idle_s, 3))
        tracer = trace_mod.get_tracer()
        tracer.instant(trace_mod.TRACK_SCHEDULER, "stall",
                       args={"idle_s": round(idle_s, 3)})
        try:
            from jepsen_tpu_torch import store
            target = store.path_mk(self.test, STALL_DUMP_NAME)
        except Exception:  # noqa: BLE001 — bare test map, no store coords
            logger.debug("no store dir for stall dump", exc_info=True)
            return
        telemetry.dump_thread_stacks(target)
        # a wedge is exactly what the flight recorder exists for: the
        # last ~N events of causal context land next to the stack dump
        try:
            from jepsen_tpu_torch import store
            tracer.dump_flight(
                store.path_mk(self.test, trace_mod.FLIGHT_NAME),
                reason="stall")
        except Exception:  # noqa: BLE001 — diagnostics never raise
            logger.debug("no store dir for flight dump", exc_info=True)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def run(test: dict) -> list[dict]:  # owner: scheduler
    """Runs the test's generator to completion, returning the history
    (interpreter.clj:181-310). Must be called inside
    utils.with_relative_time (core.run does this); establishes one if not.
    """
    if relative_time_origin() is None:
        with with_relative_time():
            return run(test)

    gen = friendly_exceptions(validate(as_gen(test.get("generator"))))
    ctx = context(test)
    # chunked scheduler (doc/performance.md "Host ingest spine"): one
    # constant caps both the completions processed per bus drain and the
    # WAL records coalesced per flush
    completions = _SchedBus()
    workers = {w["id"]: w for w in (
        _spawn_worker(test, wid, completions) for wid in ctx.workers
    )}
    history: list[dict] = []
    # write-ahead journal (core.run installs it): every history-bound op
    # — invocations at dispatch, completions as they arrive — lands in
    # history.wal.jsonl before the scheduler next goes to sleep, so a
    # killed run leaves a replayable prefix (doc/robustness.md). Within
    # one drain chunk the records stage in wal_stage and land as ONE
    # write(+interval fsync) via Journal.append_many — bytes identical
    # to per-op appends, syscalls per chunk instead of per op.
    journal = test.get("_journal")
    wal_stage: list = []

    def wal_push(rec) -> None:  # owner: scheduler
        if journal is None:
            return
        wal_stage.append(rec)
        if len(wal_stage) >= DEFAULT_SCHED_BATCH_OPS:
            wal_flush()

    def wal_flush() -> None:  # owner: scheduler
        """Coalesced WAL landing — called at every point the scheduler
        can block or exit, so the durability contract stays "everything
        before the scheduler sleeps is on disk"."""
        if wal_stage:
            journal.append_many(wal_stage)
            wal_stage.clear()

    # deadline knobs (doc/robustness.md): the test map wins, then the
    # generous defaults; None/0 disables
    default_timeout_s = _knob(test, "op_timeout_s", DEFAULT_OP_TIMEOUT_S)
    drain_timeout_s = _knob(test, "drain_timeout_s", DEFAULT_DRAIN_TIMEOUT_S)
    stall_s = _knob(test, "stall_s", DEFAULT_STALL_S)

    # telemetry: instruments fetched ONCE before the loop, then driven
    # through the single-writer fast paths (cell/observer — only this
    # scheduler thread mutates them, so no per-op lock). When disabled
    # the per-op cost is a single boolean check (metrics_on).
    reg = telemetry.get_registry()
    metrics_on = reg.enabled
    # causal trace (doc/observability.md "Causal trace"): every
    # history-bound op opens a slice on its worker's track at dispatch,
    # keyed by the stable trace id — a pure function of the op's
    # (process, invoke-time), which client spans, the WAL record, reap
    # forensics, and the checker's explain localization all share. The
    # hot path appends one raw tuple per event through op_sink() (the
    # telemetry cell() analog); track names, ids, and wall timestamps
    # are derived at sink-drain/dump time from the op dicts + the
    # one-shot clock origin below.
    tracer = trace_mod.get_tracer()
    tracing_on = tracer.enabled
    op_trace = None
    if tracing_on:
        tracer.set_op_origin(_time.time_ns() // 1000
                             - relative_time_nanos() // 1000)
        op_trace = tracer.op_sink()
        tracer.instant(trace_mod.TRACK_SCHEDULER, "interpreter-start",
                       args={"workers": len(ctx.workers)})
    OP_B, OP_X = trace_mod.OP_BEGIN, trace_mod.OP_COMPLETE
    m_latency = reg.histogram(
        "interpreter_op_latency_seconds",
        "invoke -> completion latency by op :f", labels=("f",))
    inflight_cell = reg.gauge(
        "interpreter_in_flight_ops",
        "ops dispatched, not yet completed").cell()
    qdepth_cell = reg.gauge(
        "interpreter_completion_queue_depth",
        "completions waiting for the scheduler (sampled every 128th)").cell()
    m_ops = reg.counter("interpreter_ops_total",
                        "ops dispatched to workers", labels=("f",))
    m_crash = reg.counter(
        "interpreter_crashed_ops_total",
        "client ops that crashed to :info (process renumbered)",
        labels=("f",))
    m_timeouts = reg.counter(
        "interpreter_op_timeouts_total",
        "in-flight ops reaped at their deadline (:info synthesized)",
        labels=("f",))
    zombies_gauge = reg.gauge(
        "interpreter_zombie_workers",
        "deadline-reaped workers whose late completion has not arrived "
        "yet (drain/shutdown abandons are counted separately)")
    m_late = reg.counter(
        "interpreter_late_completions_total",
        "stale-generation completions quarantined to late.jsonl")
    m_abandoned = reg.counter(
        "interpreter_abandoned_workers_total",
        "workers abandoned at shutdown (still busy past the drain/join "
        "bounds)")
    lat_obs: dict = {}       # f -> bound observe closure
    ops_cells: dict = {}     # f -> counter cell
    invoke_at: dict = {}     # thread -> dispatch time (relative nanos)
    inflight: dict = {}      # thread -> its in-flight history-bound op
    deadlines: dict = {}     # thread -> (deadline rel-nanos, timeout_s)
    zombies: list = []       # reaped records (their threads self-close)
    inflight_n = 0
    completion_i = 0

    # late.jsonl: core.run installs a ForensicLog; a standalone run
    # builds its own lazily when the test map has store coordinates
    late_log = test.get("_late")
    own_late = False
    activity = [_time.monotonic()]
    # the probe reads the scheduler-owned dict without a lock: a racy
    # truthiness check is fine for a detector that only ever logs
    watchdog = _StallWatchdog(test, stall_s, activity,
                              inflight_probe=lambda: bool(invoke_at)).start()

    def thread_of(process):
        return NEMESIS if process == NEMESIS else ctx.thread_of(process)

    def process_completion(completion) -> Any:  # owner: scheduler
        """Re-stamps time, frees the thread, updates the generator, and
        renumbers crashed processes (interpreter.clj:216-241). Returns the
        freed thread id."""
        nonlocal ctx, gen, inflight_n, completion_i
        now = relative_time_nanos()
        completion = {**completion, "time": now}
        ctx = ctx.with_time(now)
        thread = thread_of(completion.get("process"))
        if goes_in_history(completion):
            history.append(completion)
            wal_push(completion)
            # dispatch-time tracking is unconditional: the deadline layer
            # needs it whether or not metrics are on
            t0 = invoke_at.pop(thread, None)
            inflight.pop(thread, None)
            deadlines.pop(thread, None)
            if op_trace is not None:
                op_trace((OP_X, thread, completion, t0))
            if metrics_on:
                if t0 is not None:
                    f = completion.get("f")
                    obs = lat_obs.get(f)
                    if obs is None:
                        obs = lat_obs[f] = m_latency.observer(f=str(f))
                    obs((now - t0) / 1e9)
                inflight_n -= 1
                inflight_cell[0] = inflight_n
                completion_i += 1
                if not completion_i & 127:  # qsize() locks: sample rarely
                    qdepth_cell[0] = completions.qsize()
                if (completion.get("type") == "info"
                        and completion.get("process") != NEMESIS):
                    m_crash.inc(f=str(completion.get("f")))
            if gen is not None:
                gen = gen.update(test, ctx, completion)
            if (completion.get("type") == "info"
                    and completion.get("process") != NEMESIS):
                ctx = ctx.with_next_process(thread)
        ctx = ctx.free_thread(thread)
        return thread

    def quarantine(wid, payload) -> None:  # owner: scheduler
        """A stale-generation completion: the zombie finally unblocked.
        Its synthesized :info already stands in the history, so this one
        is written to the late.jsonl forensic artifact instead — never
        appended to history, never journaled."""
        nonlocal late_log, own_late
        if metrics_on:
            zombies_gauge.dec()
        if not goes_in_history(payload):
            return
        if metrics_on:
            m_late.inc()
        if tracing_on:
            tracer.instant(
                trace_mod.TRACK_SCHEDULER, "late-completion",
                args={"worker": wid, "f": str(payload.get("f")),
                      "trace_id": trace_mod.trace_id_for(
                          payload.get("process"), payload.get("time"))})
        logger.info("quarantined late completion from zombie worker %s "
                    "(f=%r)", wid, payload.get("f"))
        if late_log is None and not own_late:
            own_late = True  # only try to build one once
            try:
                late_log = journal_mod.ForensicLog(
                    journal_mod.late_path(test))
            except Exception:  # noqa: BLE001 — bare test map, no store
                logger.debug("no store dir for late.jsonl", exc_info=True)
        if late_log is not None:
            # invoke_time preserves the dispatch stamp the re-stamped
            # "time" clobbers: it is the trace id's second input, so
            # offline derivation can join this row to its dispatch
            # slice (jepsen_tpu/trace/derive.py)
            late_log.append({**payload, "late": True, "worker": wid,
                             "invoke_time": payload.get("time"),
                             "time": relative_time_nanos()})

    def on_item(item) -> None:  # owner: scheduler
        """Routes one completion-queue item: current-generation
        completions advance the run; stale ones are quarantined; stale
        exit markers (a zombie dying) are dropped."""
        wid, gen_, payload = item
        activity[0] = _time.monotonic()
        if gen_ != workers[wid]["gen"]:
            if payload is not _EXIT:
                quarantine(wid, payload)
            return
        if payload is _EXIT:
            return  # only drain/shutdown send exits to live workers
        process_completion(payload)

    def zombify(w) -> None:  # owner: scheduler
        """The one way a worker is given up on: mark it, leave an exit
        marker so a racing completion can't strand it on a dead queue,
        and put it on the books. The zombie closes its own client and
        exits when it unblocks."""
        w["zombied"].set()
        try:
            w["in"].put_nowait(_EXIT)
        except queue.Full:
            pass
        zombies.append(w)

    def reap(thread, error) -> None:  # owner: scheduler
        """Deadline expiry: zombifies ``thread``'s worker, synthesizes
        the indeterminate :info completion for its in-flight op (which
        journals and renumbers like any crash), and spawns a replacement
        under a bumped generation. The zombie's client is closed by the
        zombie's own thread when it unblocks — never here. Deadlines are
        registered only for history-bound ops, so the in-flight op is
        always present (pseudo-ops never reap)."""
        w = workers[thread]
        zombify(w)
        op = inflight[thread]
        deadlines.pop(thread, None)
        workers[thread] = _spawn_worker(test, thread, completions,
                                        generation=w["gen"] + 1)
        if metrics_on:
            m_timeouts.inc(f=str(op.get("f")))
            zombies_gauge.inc()
        if tracing_on:
            # the reap instant carries the op's trace id, so the
            # synthesized :info (which ends the dispatch slice below)
            # links back to the original dispatch causally
            tracer.instant(
                trace_mod.TRACK_SCHEDULER, "op-timeout",
                args={"worker": thread, "f": str(op.get("f")),
                      "replacement_gen": w["gen"] + 1,
                      "trace_id": trace_mod.trace_id_for(
                          op.get("process"), op.get("time"))})
        logger.warning(
            "op deadline expired on worker %s (f=%r); synthesizing :info "
            "and spawning replacement generation %d", thread, op.get("f"),
            w["gen"] + 1)
        process_completion({**op, "type": "info", "error": error})

    def expire_deadlines(now_ns) -> list:  # owner: scheduler
        """Reaps every thread whose per-op deadline has passed; returns
        the reaped thread ids."""
        expired = [(t, s) for t, (d, s) in list(deadlines.items())
                   if d <= now_ns]
        for t, timeout_s in expired:
            reap(t, ["op-timeout", timeout_s])
        return [t for t, _ in expired]

    def earliest_deadline_wait(now_ns) -> float | None:  # owner: scheduler
        if not deadlines:
            return None
        ddl = min(d for d, _ in deadlines.values())
        return max((ddl - now_ns) / 1e9, 0.0)

    try:
        # main scheduling loop (interpreter.clj:206-292)
        while True:
            # 1. drain any ready completions — BEFORE the deadline check:
            # a completion that already arrived beat its deadline and
            # must never be falsely reaped. Chunked: the old loop only
            # ever reached expire_deadlines with an EMPTY queue (the
            # get_nowait/continue spin), so handling the whole chunk and
            # continuing is order-identical to one-at-a-time.
            chunk = completions.drain_nowait()
            if chunk:
                for item in chunk:
                    on_item(item)
                continue
            now = relative_time_nanos()
            if deadlines and expire_deadlines(now):
                continue
            # 2. ask the generator
            ctx = ctx.with_time(now)
            res = gen.op(test, ctx) if gen is not None else None
            if res is None:
                break  # exhausted -> drain
            op, gen2 = res
            ddl_wait = earliest_deadline_wait(now)
            if op is PENDING:
                gen = gen2
                # nothing soon: block briefly on completions
                # (max-pending-interval, interpreter.clj:166-170,264)
                wait_s = MAX_PENDING_INTERVAL_S
                if ddl_wait is not None:
                    wait_s = min(wait_s, ddl_wait)
                wal_flush()  # land staged records before sleeping
                for item in completions.drain(wait_s):
                    on_item(item)
                continue
            if op["time"] > now:
                # future-dated: wait for its time, but a completion may
                # change the schedule — reconsult the (old) generator
                # (interpreter.clj:268-275); an in-flight deadline may
                # fire first, so never sleep past it
                full_wait = (op["time"] - now) / 1e9
                wait_s = full_wait
                if ddl_wait is not None:
                    wait_s = min(wait_s, ddl_wait)
                wal_flush()  # land staged records before sleeping
                chunk = completions.drain(wait_s)
                if chunk:
                    for item in chunk:
                        on_item(item)
                    continue
                if wait_s < full_wait:
                    continue  # woke for a deadline, not the op time
            # dispatch
            gen = gen2
            now = relative_time_nanos()
            op = {**op, "time": now}
            thread = thread_of(op.get("process"))
            workers[thread]["in"].put(op)
            ctx = ctx.busy_thread(thread).with_time(now)
            activity[0] = _time.monotonic()
            if goes_in_history(op):
                history.append(op)
                wal_push(op)
                invoke_at[thread] = now
                inflight[thread] = op
                if op_trace is not None:
                    op_trace((OP_B, thread, op))
                timeout_s = op.get("timeout_s", _UNSET)
                if timeout_s is _UNSET:
                    timeout_s = default_timeout_s
                else:
                    timeout_s = _coerce_timeout(timeout_s,
                                                default_timeout_s)
                if timeout_s:
                    deadlines[thread] = (now + int(timeout_s * 1e9),
                                         timeout_s)
                if metrics_on:
                    inflight_n += 1
                    inflight_cell[0] = inflight_n
                    f = op.get("f")
                    cell = ops_cells.get(f)
                    if cell is None:
                        cell = ops_cells[f] = m_ops.cell(f=str(f))
                    cell[0] += 1
                if gen is not None:
                    gen = gen.update(test, ctx, op)

        # drain: free workers exit now; busy workers exit after completing
        # (interpreter.clj:250-261). The whole phase runs under its own
        # deadline so one stuck op or hung client close can't wedge
        # teardown — the run must always reach its checker.
        drain_deadline = (_time.monotonic() + drain_timeout_s
                          if drain_timeout_s else None)
        if tracing_on:
            tracer.instant(trace_mod.TRACK_SCHEDULER, "drain-begin",
                           args={"busy": len(ctx.workers)
                                 - len(ctx.free_threads)})
        pending_exits = set(workers)
        reaped_in_drain: set = set()
        wal_flush()  # main loop is done; land anything still staged
        for t in ctx.free_threads:
            workers[t]["in"].put(_EXIT)
        while pending_exits:
            now = relative_time_nanos()
            wait_s = DRAIN_POLL_S
            ddl_wait = earliest_deadline_wait(now)
            if ddl_wait is not None:
                wait_s = min(wait_s, ddl_wait)
            if drain_deadline is not None:
                wait_s = min(wait_s,
                             max(drain_deadline - _time.monotonic(), 0.0))
            wal_flush()  # land staged records before sleeping
            chunk = completions.drain(wait_s)
            if not chunk:
                just_reaped = expire_deadlines(relative_time_nanos())
                reaped_in_drain.update(just_reaped)
                for t in just_reaped:
                    # the replacement worker is idle: release it
                    workers[t]["in"].put(_EXIT)
                if (drain_deadline is not None
                        and _time.monotonic() >= drain_deadline):
                    # drain deadline: synthesize :info for whatever is
                    # still stuck, abandon the stragglers, proceed
                    for swid in sorted(pending_exits, key=str):
                        if swid in reaped_in_drain:
                            # a per-op deadline already handled it
                            # during this drain: the fresh replacement
                            # is exiting cleanly, not stuck — don't
                            # zombify or count it
                            continue
                        w = workers[swid]
                        if not w["thread"].is_alive():
                            continue
                        zombify(w)
                        sop = inflight.get(swid)
                        deadlines.pop(swid, None)
                        if metrics_on:
                            # the abandon counter, not the zombie gauge:
                            # same-generation abandons have no stale
                            # completion to decrement on, so the gauge
                            # would drift for a thread that does return
                            m_abandoned.inc()
                        logger.warning(
                            "drain deadline expired; abandoning worker "
                            "%s (%s)", swid,
                            f"f={sop.get('f')!r}" if sop is not None
                            else "no history-bound op in flight")
                        if tracing_on:
                            tracer.instant(
                                trace_mod.TRACK_SCHEDULER,
                                "worker-abandoned",
                                args={"worker": swid,
                                      "phase": "drain-deadline"})
                        if sop is not None:
                            process_completion(
                                {**sop, "type": "info",
                                 "error": ["op-timeout", "drain-deadline"]})
                    break
                continue
            activity[0] = _time.monotonic()
            for wid, gen_, payload in chunk:
                if gen_ != workers[wid]["gen"]:
                    if payload is not _EXIT:
                        quarantine(wid, payload)
                    continue
                if payload is _EXIT:
                    pending_exits.discard(wid)
                    continue
                thread = process_completion(payload)
                workers[thread]["in"].put(_EXIT)
    finally:
        watchdog.stop()
        try:
            wal_flush()  # never leak staged WAL records on any exit path
        except Exception:
            logger.exception("final WAL flush failed")
        # shutdown: every live worker gets an exit marker; one too busy
        # to take it is abandoned EXPLICITLY below — zombie-marked,
        # counted, logged — never silently leaked (interpreter.clj:294-309)
        for w in workers.values():
            if not w["thread"].is_alive():
                continue
            try:
                w["in"].put_nowait(_EXIT)
            except queue.Full:
                pass
        join_deadline = _time.monotonic() + SHUTDOWN_JOIN_S
        for w in workers.values():
            if w["zombied"].is_set():
                continue  # a known zombie: never wait on a hung thread
            w["thread"].join(
                timeout=max(join_deadline - _time.monotonic(), 0.0))
        for w in workers.values():
            if w["thread"].is_alive():
                if not w["zombied"].is_set():
                    # still mid-op after the bounded join: make the
                    # abandonment explicit; the worker closes its own
                    # client when it unblocks
                    zombify(w)
                    if metrics_on:
                        m_abandoned.inc()
                    if tracing_on:
                        tracer.instant(trace_mod.TRACK_SCHEDULER,
                                       "worker-abandoned",
                                       args={"worker": w["id"],
                                             "phase": "shutdown"})
                    logger.warning(
                        "worker %s still busy at shutdown; abandoned "
                        "(its client closes on its own thread when it "
                        "unblocks)", w["id"])
                continue
            # the thread exited, so it already closed its own client;
            # this is a safety net for a thread that died some other
            # way — with the thread gone, the close cannot race an
            # in-flight invoke
            try:
                if isinstance(w["worker"], ClientWorker):
                    w["worker"].close(test)
            except Exception:  # noqa: BLE001
                pass
        if zombies:
            logger.info("run finished with %d zombie/abandoned worker(s) "
                        "on the books", len(zombies))
        if own_late and late_log is not None:
            late_log.close()
    return history
