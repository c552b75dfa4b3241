"""Checker protocol: ``check(test, history, opts) -> {"valid?": ...}``
where valid? is True, False, or "unknown"; the plumbing that merges and
composes checkers; and the built-in checkers a suite composes
(jepsen_tpu/checker/__init__.py): stats, unhandled exceptions, the set
checkers (``SetChecker``, and ``SetFullChecker``, whose device path
classifies every element on the card through ops/setscan), the queue,
unique-ids and counter checkers and the log-file grep, one host pass
over the history each, and the constructors of the reports
(``checker/perf_plots.py``, ``clock.py``, ``timeline.py``), which import
their modules lazily as the reference does."""
from __future__ import annotations

import logging
import re
import threading
from collections import Counter as MultiSet
from collections import defaultdict
from typing import Any

from jepsen_tpu_torch import history as h
from jepsen_tpu_torch.utils import bounded_pmap, quantile

logger = logging.getLogger("jepsen_tpu_torch.checker")

# copied from jepsen_tpu/checker/__init__.py:27
VALID_PRIORITY = {False: 0, "unknown": 1, True: 2}


# copied from jepsen_tpu/checker/__init__.py:29-36
def merge_valid(valids) -> Any:
    """false > unknown > true (checker.clj:29-50)."""
    result = True
    for v in valids:
        v = "unknown" if v == "unknown" else bool(v) if isinstance(v, bool) else v
        if VALID_PRIORITY.get(v, 1) < VALID_PRIORITY.get(result, 1):
            result = v
    return result


# copied from jepsen_tpu/checker/__init__.py:39-44
class Checker:
    def check(self, test: dict, history: list[dict], opts: dict) -> dict:
        raise NotImplementedError

    def name(self) -> str:
        return type(self).__name__


# copied from jepsen_tpu/checker/__init__.py:47-53
def check_safe(checker: Checker, test: dict, history: list[dict],
               opts: dict | None = None) -> dict:
    """Exceptions become {'valid?': 'unknown'} (checker.clj:74-85)."""
    try:
        return checker.check(test, history, opts or {})
    except Exception as e:  # noqa: BLE001
        logger.exception("checker %s crashed", checker.name())
        return {"valid?": "unknown", "error": repr(e)}


# copied from jepsen_tpu/checker/__init__.py:56-71
class Compose(Checker):
    """A map of named checkers run in parallel; overall valid? merges
    (checker.clj:87-99)."""

    def __init__(self, checkers: dict[str, Checker]):
        self.checkers = checkers

    def check(self, test, history, opts):
        names = list(self.checkers)
        results = bounded_pmap(
            lambda n: check_safe(self.checkers[n], test, history, opts), names
        )
        by_name = dict(zip(names, results))
        return {
            "valid?": merge_valid(r.get("valid?") for r in results),
            **by_name,
        }


# copied from jepsen_tpu/checker/__init__.py:74-75
def compose(checkers: dict[str, Checker]) -> Checker:
    return Compose(checkers)


# copied from jepsen_tpu/checker/__init__.py:79-94
class ConcurrencyLimit(Checker):
    """Limits concurrent executions of a memory-hungry checker via a
    semaphore (checker.clj:101-116)."""

    _sems: dict[int, threading.Semaphore] = {}
    _lock = threading.Lock()

    def __init__(self, limit: int, checker: Checker):
        self.limit = limit
        self.checker = checker
        with ConcurrencyLimit._lock:
            self._sem = ConcurrencyLimit._sems.setdefault(
                limit, threading.Semaphore(limit))

    def check(self, test, history, opts):
        with self._sem:
            return self.checker.check(test, history, opts)


# copied from jepsen_tpu/checker/__init__.py:97-101
class Noop(Checker):
    """Always valid (checker.clj:68-72)."""

    def check(self, test, history, opts):
        return {"valid?": True}


# copied from jepsen_tpu/checker/__init__.py:104-108
class UnbridledOptimism(Checker):
    """It's valid! (checker.clj:118-122)"""

    def check(self, test, history, opts):
        return {"valid?": True}


# copied from jepsen_tpu/checker/__init__.py:111-132
class UnhandledExceptions(Checker):
    """Aggregates ops with errors/exceptions by frequency
    (checker.clj:124-151). Informational: always valid."""

    def check(self, test, history, opts):
        groups: dict[Any, list] = defaultdict(list)
        for op in history:
            if op.get("exception") is not None or (
                op.get("type") in ("info", "fail")
                    and op.get("error") is not None):
                key = (op.get("f"), _freeze(op.get("error")),
                       _freeze(op.get("exception")))
                groups[key].append(op)
        exceptions = sorted(
            (
                {"f": k[0], "error": ops_[0].get("error"),
                 "exception": ops_[0].get("exception"), "count": len(ops_),
                 "example": ops_[0]}
                for k, ops_ in groups.items()
            ),
            key=lambda m: -m["count"],
        )
        return {"valid?": True, "exceptions": exceptions}


# copied from jepsen_tpu/checker/__init__.py:135-142
def _freeze(x):
    if isinstance(x, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(v) for v in x)
    if isinstance(x, set):
        return frozenset(_freeze(v) for v in x)
    return x


# copied from jepsen_tpu/checker/__init__.py:145-181
class Stats(Checker):
    """ok/fail/info counts overall and by :f; valid iff every :f saw at
    least one ok (checker.clj:153-183). ``ungated_fs`` exempts specific
    op fs from the validity gate (counts still reported), for probes
    where ONE op type is expected to fail en masse while the rest must
    still work."""

    def __init__(self, ungated_fs=()):
        self.ungated_fs = frozenset(ungated_fs or ())

    def check(self, test, history, opts):
        def summarize(ops):
            c = MultiSet(op.get("type") for op in ops)
            ok, fail, info = c.get("ok", 0), c.get("fail", 0), c.get("info", 0)
            n = ok + fail + info
            return {
                "count": n, "ok-count": ok, "fail-count": fail,
                "info-count": info, "valid?": ok > 0,
            }

        completions = [op for op in history
                       if op.get("type") in ("ok", "fail", "info")
                       and h.is_client_op(op)]
        by_f = defaultdict(list)
        for op in completions:
            by_f[op.get("f")].append(op)
        by_f_stats = {f: summarize(ops_) for f, ops_ in by_f.items()}
        return {
            **summarize(completions),
            "by-f": by_f_stats,
            "valid?": merge_valid(
                [s["valid?"] for f, s in by_f_stats.items()
                 if f not in self.ungated_fs] or [True]),
        }


# copied from jepsen_tpu/checker/__init__.py:184-222
class SetChecker(Checker):
    """Grow-only set: :add ops then a final :read of the full set
    (checker.clj:240-291)."""

    def check(self, test, history, opts):
        attempts, adds = set(), set()
        final_read = None
        for op in history:
            f, typ, v = op.get("f"), op.get("type"), op.get("value")
            if f == "add":
                if typ == "invoke":
                    attempts.add(v)
                elif typ == "ok":
                    adds.add(v)
            elif f == "read" and typ == "ok":
                final_read = set(v)
        if final_read is None:
            return {"valid?": "unknown", "error": "Set was never read"}
        # The OK set is every read value that we tried to add
        ok = final_read & attempts
        # Unexpected values are those we never tried to add
        unexpected = final_read - attempts
        # Lost records are those we acknowledged but weren't read
        lost = adds - final_read
        # Recovered records are those we weren't sure about and that showed up
        recovered = ok - adds
        return {
            "valid?": not lost and not unexpected,
            "attempt-count": len(attempts),
            "acknowledged-count": len(adds),
            "ok-count": len(ok),
            "lost-count": len(lost),
            "unexpected-count": len(unexpected),
            "recovered-count": len(recovered),
            "ok": sorted(ok, key=repr),
            "lost": sorted(lost, key=repr),
            "unexpected": sorted(unexpected, key=repr),
            "recovered": sorted(recovered, key=repr),
        }


# the set-full checker's accelerators, as the linearizable checker's
SET_FULL_ACCELERATORS = ("gpu", "cpu", "auto")


class SetFullChecker(Checker):
    """Full set analysis: every element's visibility lifecycle across *all*
    reads, not just the final one (checker.clj:294-592; jepsen_tpu/checker/
    __init__.py:225-384).

    Each added element ends up :stable (present in the final read and every
    read after it became known), :lost (known, then absent from some later
    read and never seen again), or :never-read. Stale reads (absent after
    known, but present again later) violate linearizability when the
    linearizable option is set. Also reports visibility latency quantiles.

    ``accelerator`` "gpu" or "auto" (the default) encodes the history as a
    reads x elements membership matrix (history_ir.views.set_full_columns,
    times in float64; the view ``set_membership`` of the run's shared IR
    when ``history_ir.of`` gives one) and classifies every element in one
    launch of the set-classify kernel on ``device`` (None: the CUDA
    device; "cpu": its plain version). "cpu" runs the reference's per-element walk, the
    oracle. A device failure raises: there is no fallback to the walk.
    """

    def __init__(self, linearizable: bool = False, accelerator: str = "auto",
                 device=None):
        if accelerator not in SET_FULL_ACCELERATORS:
            raise ValueError(f"accelerator {accelerator!r} not in "
                             f"{SET_FULL_ACCELERATORS}")
        self.linearizable = linearizable
        self.accelerator = accelerator
        self.device = device

    def check(self, test, history, opts):
        accelerator = opts.get("accelerator", self.accelerator)
        if accelerator not in SET_FULL_ACCELERATORS:
            raise ValueError(f"accelerator {accelerator!r} not in "
                             f"{SET_FULL_ACCELERATORS}")
        if accelerator == "cpu":
            return self._check_cpu(test, history, opts)
        return self._check_device(test, history, opts)

    # copied from jepsen_tpu/checker/__init__.py:265-309, on the port's
    # encode and kernel
    def _check_device(self, test, history, opts):
        from jepsen_tpu_torch import history_ir
        from jepsen_tpu_torch.history_ir import views
        from jepsen_tpu_torch.ops import setscan

        # the membership encode is an IR view, memoized on the run's
        # shared IR when the test map can carry one
        ir = history_ir.of(test, history)
        enc = (views.set_membership(ir) if ir is not None
               else views.set_full_columns(history))
        if "error" in enc:
            return {"valid?": "unknown", "error": enc["error"]}
        member = enc["member"]
        read_t, invoke_t = enc["read_t"], enc["invoke_t"]
        ok_t, has_ok, els = enc["ok_t"], enc["has_ok"], enc["els"]
        E = len(els)
        code, stale, latency = setscan.classify_elements(
            member, read_t, invoke_t, ok_t, has_ok, device=self.device)

        lost = [els[j] for j in range(E) if code[j] == setscan.LOST]
        never_read = [els[j] for j in range(E)
                      if code[j] == setscan.NEVER_READ]
        stale_els = [els[j] for j in range(E) if stale[j]]
        stable_lat = sorted(float(latency[j]) for j in range(E)
                            if code[j] == setscan.STABLE)
        latencies = ({q: quantile(stable_lat, q)
                      for q in (0.0, 0.5, 0.99, 1.0)} if stable_lat else {})
        valid = not lost
        if self.linearizable and stale_els:
            valid = False
        return {
            "valid?": valid,
            "attempt-count": E,
            "stable-count": sum(1 for j in range(E)
                                if code[j] == setscan.STABLE),
            "lost-count": len(lost),
            "lost": sorted(lost, key=repr)[:100],
            "never-read-count": len(never_read),
            "never-read": sorted(never_read, key=repr)[:100],
            "stale-count": len(stale_els),
            "stale": sorted(stale_els, key=repr)[:100],
            "stable-latencies": latencies,
        }

    # copied from jepsen_tpu/checker/__init__.py:311-384
    def _check_cpu(self, test, history, opts):
        adds: dict[Any, dict] = {}   # element -> {invoke_time, ok_time}
        reads: list[tuple[int, int, set]] = []  # (invoke_time, index, value-set)
        pending_read_invokes: dict[Any, int] = {}
        for i, op in enumerate(history):
            f, typ, v, p = op.get("f"), op.get("type"), op.get("value"), op.get("process")
            t = op.get("time", i)
            if f == "add":
                if typ == "invoke":
                    adds.setdefault(v, {"invoke_time": t, "ok_time": None})
                elif typ == "ok":
                    if v in adds:
                        adds[v]["ok_time"] = t
                    else:
                        adds[v] = {"invoke_time": t, "ok_time": t}
            elif f == "read":
                if typ == "invoke":
                    pending_read_invokes[p] = t
                elif typ == "ok":
                    t0 = pending_read_invokes.pop(p, t)
                    reads.append((t0, i, set(v)))
        if not reads:
            return {"valid?": "unknown", "error": "Set was never read"}
        reads.sort()
        results = {}
        stable_latencies = []
        lost, never_read, stale = [], [], []
        for el, info in adds.items():
            known_time = info["ok_time"]
            present = [(t0, el in vs) for (t0, _, vs) in reads]
            first_seen = next((t0 for (t0, _, vs) in reads if el in vs), None)
            if known_time is None:
                known_time = first_seen
            if known_time is None:
                never_read.append(el)
                results[el] = "never-read"
                continue
            later = [(t0, p) for (t0, p) in present if t0 >= known_time]
            if not later:
                never_read.append(el)
                results[el] = "never-read"
                continue
            # last absence and last presence among later reads
            last_present = max((t0 for (t0, p) in later if p), default=None)
            last_absent = max((t0 for (t0, p) in later if not p), default=None)
            if last_present is None or (last_absent is not None and last_absent > last_present):
                lost.append(el)
                results[el] = "lost"
                continue
            if last_absent is not None:
                # absent after known, but came back: stale read
                stale.append(el)
            results[el] = "stable"
            # stable latency: time from add-ok to start of uninterrupted presence
            stable_from = known_time if last_absent is None else last_absent
            stable_latencies.append(max(0, stable_from - info["invoke_time"]))
        stable_count = sum(1 for v in results.values() if v == "stable")
        sl = sorted(stable_latencies)
        latencies = {q: quantile(sl, q) for q in (0.0, 0.5, 0.99, 1.0)} if sl else {}
        valid = not lost
        if self.linearizable and stale:
            valid = False
        return {
            "valid?": valid,
            "attempt-count": len(adds),
            "stable-count": stable_count,
            "lost-count": len(lost),
            "lost": sorted(lost, key=repr)[:100],
            "never-read-count": len(never_read),
            "never-read": sorted(never_read, key=repr)[:100],
            "stale-count": len(stale),
            "stale": sorted(stale, key=repr)[:100],
            "stable-latencies": latencies,
        }


# copied from jepsen_tpu/checker/__init__.py:387-413
class QueueChecker(Checker):
    """Model-based queue check: enqueues count from invocation (they may
    have happened even without an ack); every ok dequeue must be consistent
    with the model (checker.clj:218-238)."""

    def __init__(self, model):
        self.model = model

    def check(self, test, history, opts):
        from jepsen_tpu_torch.models import is_inconsistent
        model = self.model
        error = None
        for op in history:
            f, typ = op.get("f"), op.get("type")
            if typ == "invoke" and f == "enqueue":
                m2 = model.step(op)
                if not is_inconsistent(m2):
                    model = m2
            elif typ == "ok" and f == "dequeue":
                m2 = model.step(op)
                if is_inconsistent(m2):
                    error = {"op": op, "error": m2.msg}
                    break
                model = m2
        if error:
            return {"valid?": False, "error": error}
        return {"valid?": True, "final-queue-size": _model_size(model)}


# copied from jepsen_tpu/checker/__init__.py:416-422
def _model_size(model):
    items = getattr(model, "items", None)
    if items is None:
        return None
    if isinstance(items, frozenset):
        return sum(n for _, n in items)
    return len(items)


# copied from jepsen_tpu/checker/__init__.py:425-451
def expand_queue_drain_ops(history: list[dict]) -> list[dict]:
    """Expands ``drain`` ops (value = list of drained elements) into
    synthetic dequeue invoke/ok pairs (checker.clj:594-626).

    Beyond the reference: a crashed (``info``) drain that carries a
    partial element list is expanded too — those elements were
    definitely consumed before the crash, and dropping them would
    produce false ``lost`` verdicts. A crashed drain with no element
    list is unsupported, as in the reference."""
    out: list[dict] = []
    for op in history:
        if op.get("f") != "drain":
            out.append(op)
            continue
        typ = op.get("type")
        if typ in ("invoke", "fail"):
            continue
        if typ == "ok" or (typ == "info"
                           and isinstance(op.get("value"), list)):
            for element in op.get("value") or []:
                out.append({**op, "type": "invoke", "f": "dequeue",
                            "value": None})
                out.append({**op, "type": "ok", "f": "dequeue",
                            "value": element})
        else:
            raise ValueError(f"crashed drain operation unsupported: {op!r}")
    return out


# copied from jepsen_tpu/checker/__init__.py:454-498
class TotalQueueChecker(Checker):
    """Multiset queue algebra: what goes in must come out
    (checker.clj:628-687). Ok ``drain`` ops are expanded into dequeues
    first, per the reference's total-queue."""

    def check(self, test, history, opts):
        history = expand_queue_drain_ops(history)
        attempts: MultiSet = MultiSet()
        enqueues: MultiSet = MultiSet()
        dequeues: MultiSet = MultiSet()
        for op in history:
            f, typ, v = op.get("f"), op.get("type"), op.get("value")
            if f == "enqueue":
                if typ == "invoke":
                    attempts[v] += 1
                elif typ == "ok":
                    enqueues[v] += 1
            elif f == "dequeue" and typ == "ok":
                dequeues[v] += 1
        ok = dequeues & attempts
        # dequeues of values we *never* tried to enqueue — records from
        # nowhere (full multiplicity, not just the excess)
        unexpected = MultiSet({v: n for v, n in dequeues.items()
                               if v not in attempts})
        # dequeues in excess of attempts, for values attempted at least
        # once: redelivery, not invalidity
        duplicated = dequeues - attempts - unexpected
        # acknowledged enqueues that never came out
        lost = enqueues - dequeues
        # dequeues whose enqueue was attempted but never acknowledged
        recovered = ok - enqueues
        return {
            "valid?": not lost and not unexpected,
            "attempt-count": sum(attempts.values()),
            "acknowledged-count": sum(enqueues.values()),
            "ok-count": sum(ok.values()),
            "unexpected-count": sum(unexpected.values()),
            "duplicated-count": sum(duplicated.values()),
            "lost-count": sum(lost.values()),
            "recovered-count": sum(recovered.values()),
            "lost": sorted(lost.elements(), key=repr)[:100],
            "unexpected": sorted(unexpected.elements(), key=repr)[:100],
            "duplicated": sorted(duplicated.elements(), key=repr)[:100],
            "recovered": sorted(recovered.elements(), key=repr)[:100],
        }


# copied from jepsen_tpu/checker/__init__.py:501-522
class UniqueIdsChecker(Checker):
    """All ok :generate ops must return distinct ids (checker.clj:689-734)."""

    def check(self, test, history, opts):
        attempted = 0
        acknowledged: MultiSet = MultiSet()
        for op in history:
            if op.get("f") == "generate":
                if op.get("type") == "invoke":
                    attempted += 1
                elif op.get("type") == "ok":
                    acknowledged[op.get("value")] += 1
        dups = {v: n for v, n in acknowledged.items() if n > 1}
        return {
            "valid?": not dups,
            "attempted-count": attempted,
            "acknowledged-count": sum(acknowledged.values()),
            "duplicated-count": len(dups),
            "duplicated": dict(sorted(dups.items(),
                                      key=lambda kv: -kv[1])[:100]),
            "range": [min(acknowledged, key=repr), max(acknowledged, key=repr)]
            if acknowledged else None,
        }


# copied from jepsen_tpu/checker/__init__.py:525-567
class CounterChecker(Checker):
    """PN-counter bounds check: each ok read must lie within [lower, upper]
    where indeterminate adds widen the window (checker.clj:737-795)."""

    def check(self, test, history, opts):
        lower = 0
        upper = 0
        reads_checked = 0
        errors = []
        # track pending adds so fails can be rolled back
        pending: dict[Any, float] = {}
        for op in history:
            f, typ, v, p = (op.get("f"), op.get("type"), op.get("value"),
                            op.get("process"))
            if f == "add":
                if typ == "invoke":
                    pending[p] = v
                    if v >= 0:
                        upper += v
                    else:
                        lower += v
                elif typ == "ok":
                    v = pending.pop(p, v)
                    if v >= 0:
                        lower += v
                    else:
                        upper += v
                elif typ == "fail":
                    v = pending.pop(p, v)
                    if v >= 0:
                        upper -= v
                    else:
                        lower -= v
                # info: leave the window widened forever (indeterminate)
            elif f == "read" and typ == "ok":
                reads_checked += 1
                if not (lower <= v <= upper):
                    errors.append({"op": op, "expected": [lower, upper]})
        return {
            "valid?": not errors,
            "reads-checked": reads_checked,
            "errors": errors[:100],
            "final-bounds": [lower, upper],
        }


# copied from jepsen_tpu/checker/__init__.py:570-590, over the port's store
class LogFilePattern(Checker):
    """Greps downloaded node logs for a pattern; matches mean invalid
    (checker.clj:839-881)."""

    def __init__(self, pattern: str, filename: str):
        self.pattern = pattern
        self.filename = filename

    def check(self, test, history, opts):
        from jepsen_tpu_torch import store
        matches = []
        for node in test.get("nodes", []):
            path = store.path(test, node, self.filename)
            try:
                with open(path, "r", errors="replace") as f:
                    for line in f:
                        if re.search(self.pattern, line):
                            matches.append({"node": node,
                                            "line": line.rstrip()})
            except FileNotFoundError:
                continue
        return {"valid?": not matches, "count": len(matches),
                "matches": matches[:100]}


# the constructors, copied from jepsen_tpu/checker/__init__.py:594-604
def noop() -> Checker:
    return Noop()


def stats(ungated_fs=()) -> Checker:
    return Stats(ungated_fs)


def unhandled_exceptions() -> Checker:
    return UnhandledExceptions()


# copied from jepsen_tpu/checker/__init__.py:606-607
def set_checker() -> Checker:
    return SetChecker()


# jepsen_tpu/checker/__init__.py:610-611, with the port's default
# accelerator ("auto": the card) and device
def set_full(linearizable: bool = False, accelerator: str = "auto",
             device=None) -> Checker:
    return SetFullChecker(linearizable=linearizable, accelerator=accelerator,
                          device=device)


# copied from jepsen_tpu/checker/__init__.py:614-660
def queue(model) -> Checker:
    return QueueChecker(model)


def total_queue() -> Checker:
    return TotalQueueChecker()


def unique_ids() -> Checker:
    return UniqueIdsChecker()


def counter() -> Checker:
    return CounterChecker()


def log_file_pattern(pattern: str, filename: str) -> Checker:
    return LogFilePattern(pattern, filename)


def unbridled_optimism() -> Checker:
    return UnbridledOptimism()


def latency_graph() -> Checker:
    from jepsen_tpu_torch.checker.perf_plots import LatencyGraph
    return LatencyGraph()


def rate_graph() -> Checker:
    from jepsen_tpu_torch.checker.perf_plots import RateGraph
    return RateGraph()


def perf() -> Checker:
    from jepsen_tpu_torch.checker.perf_plots import perf as _perf
    return _perf()


def clock_plot() -> Checker:
    from jepsen_tpu_torch.checker.clock import ClockPlot
    return ClockPlot()


def timeline_html() -> Checker:
    from jepsen_tpu_torch.checker.timeline import Timeline
    return Timeline()
