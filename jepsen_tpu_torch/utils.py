"""Host helpers: the port of jepsen_tpu/utils/__init__.py (after
jepsen/src/jepsen/util.clj), whole.

Time here follows the reference's convention: every history ``time`` is a
*relative* monotonic nanosecond count from the start of the test
(util.clj:333-347), so histories are comparable and serializable.
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import math
import os
import random
import threading
import time as _time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Iterable, Sequence

logger = logging.getLogger("jepsen_tpu_torch")

# copied from jepsen_tpu/utils/__init__.py:22-479

NANOS_PER_SECOND = 1_000_000_000
NANOS_PER_MILLI = 1_000_000
MICROS_PER_SECOND = 1_000_000


def majority(n: int) -> int:
    """Smallest integer strictly greater than half of n (util.clj:84)."""
    return n // 2 + 1


def atomic_write_json(path, value) -> None:
    """Durable atomic JSON write: tmp file + flush + fsync + rename, so
    readers never see a torn document and the content survives a crash.
    Shared by the durable fake cluster's members file and the
    membership heal's pre-op-set restore (doc/robustness.md)."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(value, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def minority(n: int) -> int:
    """Largest number of nodes that is still a minority."""
    return (n - 1) // 2


def minority_third(n: int) -> int:
    """Largest m such that 3m < n, min 1 (util.clj:89). Useful for Raft-style
    systems where a third of nodes can fail without losing two quorums."""
    return max(1, (n - 1) // 3)


def parse_concurrency(s, n_nodes: int) -> int:
    """'30' -> 30; '3n' -> 3 * n_nodes; 'n' -> n_nodes (cli.clj:150-165).
    Single source of truth for the CLI and core.prepare_test."""
    if isinstance(s, int):
        return s
    s = str(s).strip()
    if s.endswith("n"):
        return int(s[:-1] or 1) * n_nodes
    return int(s)


def secs_to_nanos(s: float) -> int:
    return int(s * NANOS_PER_SECOND)


def nanos_to_secs(n: int) -> float:
    return n / NANOS_PER_SECOND

def ms_to_nanos(ms: float) -> int:
    return int(ms * NANOS_PER_MILLI)


def nanos_to_ms(n: int) -> float:
    return n / NANOS_PER_MILLI


def linear_time_nanos() -> int:
    """A monotonic clock in nanoseconds (util.clj:328)."""
    return _time.monotonic_ns()


# Relative test clock (util.clj:333-347). All history :time values are nanos
# since the enclosing with_relative_time block began.
_relative_time_origin: contextvars.ContextVar[int | None] = contextvars.ContextVar(
    "relative_time_origin", default=None
)


@contextlib.contextmanager
def with_relative_time():
    """Zeroes the test clock for the dynamic extent of this block."""
    token = _relative_time_origin.set(linear_time_nanos())
    try:
        yield
    finally:
        _relative_time_origin.reset(token)


def relative_time_nanos() -> int:
    origin = _relative_time_origin.get()
    if origin is None:
        raise RuntimeError("relative_time_nanos called outside with_relative_time")
    return linear_time_nanos() - origin


def relative_time_origin() -> int | None:
    return _relative_time_origin.get()


def sleep_nanos(n: int) -> None:
    if n > 0:
        _time.sleep(n / NANOS_PER_SECOND)


class ExceptionHolder:
    __slots__ = ("exc",)

    def __init__(self):
        self.exc: BaseException | None = None


# Heartbeat interval for bounded-wait joins: long enough to never spam
# a healthy run, short enough that a wedged thread is visible in the
# log well before anyone reaches for SIGKILL.
JOIN_HEARTBEAT_S = 30.0


def join_noisy(thread: threading.Thread, what: str,
               heartbeat_s: float = JOIN_HEARTBEAT_S,
               max_wait_s: float | None = None) -> bool:
    """Joins ``thread`` with the same wait-forever semantics as a bare
    ``join()``, but bounded per wait with a heartbeat log — the caller
    (often the orchestrator/scheduler thread) is never wedged SILENTLY,
    and a stuck thread is diagnosable from the log
    (no-unbounded-block, doc/static-analysis.md).

    ``max_wait_s`` bounds the TOTAL wait: once exhausted the thread is
    left running and False is returned — the wedge-proof-teardown mode
    (a poll thread stuck in remote I/O must not hold the run's teardown
    hostage). Returns True when the thread finished."""
    waited = 0.0
    while thread.is_alive():
        if max_wait_s is not None and waited >= max_wait_s:
            logger.warning("%s still running after %.0fs; abandoning "
                           "the wait", what, waited)
            return False
        step = heartbeat_s if max_wait_s is None \
            else min(heartbeat_s, max_wait_s - waited)
        thread.join(timeout=step)
        if thread.is_alive():
            waited += step
            logger.warning("%s still running after %.0fs", what, waited)
    return True


# thread-helper: sync-spawn(arg=0)
def real_pmap(fn: Callable, coll: Sequence) -> list:
    """Maps fn over coll in one thread per element; re-raises the first
    non-interrupt exception raised by any element (util.clj:65-78, dom-top's
    real-pmap). Unlike a pooled map, every element genuinely runs concurrently
    — required for barrier-synchronized DB setup across nodes."""
    coll = list(coll)
    if not coll:
        return []
    if len(coll) == 1:
        return [fn(coll[0])]
    results: list = [None] * len(coll)
    errors: list[BaseException | None] = [None] * len(coll)

    def run(i, x):
        try:
            results[i] = fn(x)
        except BaseException as e:  # noqa: BLE001 - mirrored to caller
            errors[i] = e

    threads = [threading.Thread(target=run, args=(i, x), daemon=True) for i, x in enumerate(coll)]
    for t in threads:
        t.start()
    for t in threads:
        join_noisy(t, f"real_pmap element {t.name}")
    for e in errors:
        if e is not None:
            raise e
    return results


# thread-helper: sync-spawn(arg=0)
def bounded_pmap(fn: Callable, coll: Iterable, bound: int | None = None) -> list:
    """Parallel map with a bounded worker pool (dom-top bounded-pmap)."""
    coll = list(coll)
    if not coll:
        return []
    bound = bound or min(32, len(coll))
    with ThreadPoolExecutor(max_workers=bound) as pool:
        return list(pool.map(fn, coll))


class JepsenTimeout(Exception):
    pass


# thread-helper: spawn(arg=2) — the child is abandoned at the deadline,
# so its block can't wedge the caller; ownership still transfers
def timeout(ms: float, dflt: Any, fn: Callable[[], Any]) -> Any:
    """Runs fn in a thread; if it doesn't complete within ms, returns dflt
    (util.clj:370-381). The straggler thread is abandoned (daemon).

    The caller's interpreter-worker identity rides along: code under a
    nemesis ``Timeout`` wrapper (or any thread-hopping helper) must
    still see ``interpreter.current_op_reaped()`` — the membership
    nemesis keys its leave-the-registry-entry-unhealed rule on it."""
    from jepsen_tpu_torch.generator.interpreter import (
        adopt_worker_zombie, current_worker_zombie,
    )
    result: list = []
    error: list = []
    zombie = current_worker_zombie()

    def run():
        adopt_worker_zombie(zombie)
        try:
            result.append(fn())
        except BaseException as e:  # noqa: BLE001
            error.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(ms / 1000.0)
    if t.is_alive():
        return dflt
    if error:
        raise error[0]
    return result[0]


def backoff_delay(attempt: int, base_s: float = 0.05, cap_s: float = 5.0,
                  rng: random.Random | None = None) -> float:
    """Capped exponential backoff with FULL jitter (the AWS
    architecture-blog schedule): ``uniform(0, min(cap, base * 2**n))``.
    Full jitter decorrelates retry storms — N clients that failed
    together spread over the whole window instead of thundering back in
    lockstep. ``rng`` makes the schedule deterministic under a seeded
    ``random.Random`` for tests."""
    ceiling = min(cap_s, base_s * (2.0 ** attempt))
    return (rng or random).uniform(0.0, ceiling)


def retry_with_backoff(fn: Callable[[], Any], tries: int = 5,
                       base_s: float = 0.05, cap_s: float = 5.0,
                       rng: random.Random | None = None,
                       desc: str = "operation",
                       no_retry: tuple = ()) -> Any:
    """Runs fn up to ``tries`` times with :func:`backoff_delay` sleeps
    between attempts; raises the last exception when every try fails.
    Exception types in ``no_retry`` are terminal verdicts, re-raised
    immediately without burning the remaining attempts. The workhorse
    behind idempotent nemesis teardowns and fault-registry heal replay
    (doc/robustness.md)."""
    err: Exception | None = None
    for attempt in range(tries):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001
            if no_retry and isinstance(e, no_retry):
                raise
            err = e
            if attempt < tries - 1:
                delay = backoff_delay(attempt, base_s, cap_s, rng)
                logger.debug("%s failed (try %d/%d), backing off %.3fs: %r",
                             desc, attempt + 1, tries, delay, e)
                _time.sleep(delay)
    raise err


def retry(dt_seconds: float, fn: Callable[[], Any], retries: int | None = None) -> Any:
    """Retries fn every dt seconds until it returns non-exceptionally
    (util.clj:425-440)."""
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001
            attempt += 1
            if retries is not None and attempt > retries:
                raise
            logger.debug("retrying after %r", e)
            _time.sleep(dt_seconds)


def await_fn(
    fn: Callable[[], Any],
    retry_interval: float = 1.0,
    log_interval: float = 10.0,
    log_message: str | None = None,
    timeout_s: float = 60.0,
) -> Any:
    """Invokes fn until it returns non-exceptionally (util.clj:383-424)."""
    t0 = _time.monotonic()
    last_log = t0
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001
            now = _time.monotonic()
            if now - t0 > timeout_s:
                raise JepsenTimeout(f"await_fn timed out after {timeout_s}s") from e
            if now - last_log > log_interval:
                logger.info(log_message or f"still waiting: {e!r}")
                last_log = now
            _time.sleep(retry_interval)


def meh(fn: Callable[[], Any]) -> Any:
    """Runs fn, returning the exception instead of raising (util.clj:656)."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001
        return e


@contextlib.contextmanager
def with_thread_name(name: str):
    t = threading.current_thread()
    old = t.name
    t.name = name
    try:
        yield
    finally:
        t.name = old


def map_vals(fn: Callable, m: dict) -> dict:
    return {k: fn(v) for k, v in m.items()}


def map_keys(fn: Callable, m: dict) -> dict:
    return {fn(k): v for k, v in m.items()}


def rand_nth_empty(seq: Sequence, rng: random.Random | None = None):
    """Random element or None if empty."""
    if not seq:
        return None
    r = rng or random
    return seq[r.randrange(len(seq))]


def integer_interval_set_str(xs: Iterable[int]) -> str:
    """Compact string for a set of integers: '#{1-3 5 7-9}'
    (util.clj:629-654)."""
    xs = sorted(set(xs))
    if not xs:
        return "#{}"
    parts = []
    lo = prev = xs[0]
    for x in xs[1:]:
        if x == prev + 1:
            prev = x
            continue
        parts.append(f"{lo}" if lo == prev else f"{lo}-{prev}")
        lo = prev = x
    parts.append(f"{lo}" if lo == prev else f"{lo}-{prev}")
    return "#{" + " ".join(parts) + "}"


def op2str(op: dict) -> str:
    """Render an op like the reference log format (util.clj:205-243)."""
    proc = op.get("process")
    typ = op.get("type")
    f = op.get("f")
    value = op.get("value")
    err = op.get("error")
    s = f"{proc}\t{typ}\t{f}\t{value}"
    if err is not None:
        s += f"\t{err}"
    return s


def log_op(op: dict) -> None:
    logger.info(op2str(op))


def history_to_latencies(history: list[dict]) -> list[dict]:
    """Pairs invocations with completions, attaching :latency (nanos) to both,
    and :completion to the invocation (util.clj:700-735). Unmatched invokes
    get latency = max time seen."""
    history = [dict(op) for op in history]
    pending: dict[Any, int] = {}
    max_time = 0
    for i, op in enumerate(history):
        t = op.get("time", 0)
        max_time = max(max_time, t)
        if op.get("type") == "invoke":
            pending[op.get("process")] = i
        elif op.get("type") in ("ok", "fail", "info"):
            j = pending.pop(op.get("process"), None)
            if j is not None:
                latency = t - history[j].get("time", 0)
                history[j]["latency"] = latency
                op["latency"] = latency
                history[j]["completion"] = op
    for i in pending.values():
        history[i]["latency"] = max_time - history[i].get("time", 0)
    return history


def nemesis_intervals(history: list[dict], start_fs=("start",), stop_fs=("stop",)) -> list[tuple]:
    """Pairs up intervals of nemesis activity: [(start-op, stop-op-or-None)]
    (util.clj:736-783)."""
    intervals = []
    starts: list[dict] = []
    for op in history:
        if op.get("process") != "nemesis":
            continue
        if op.get("type") != "info":
            continue
        f = op.get("f")
        if f in start_fs:
            starts.append(op)
        elif f in stop_fs:
            if starts:
                intervals.append((starts.pop(0), op))
    for s in starts:
        intervals.append((s, None))
    return intervals


def quantile(sorted_xs: Sequence[float], q: float) -> float:
    """Nearest-rank quantile over a pre-sorted sequence."""
    if not sorted_xs:
        return math.nan
    i = min(len(sorted_xs) - 1, max(0, int(math.ceil(q * len(sorted_xs))) - 1))
    return sorted_xs[i]


def fraction(a: float, b: float) -> float:
    """a/b, but 1 when b is zero (checker.clj stats convention)."""
    return a / b if b else 1.0


class NamedLocks:
    """A map of named reentrant locks (util.clj:860-900)."""

    def __init__(self):
        self._locks: dict[Any, threading.RLock] = {}
        self._guard = threading.Lock()

    @contextlib.contextmanager
    def hold(self, name):
        with self._guard:
            lock = self._locks.setdefault(name, threading.RLock())
        with lock:
            yield




def int_key(k):
    """Digit-string → int, anything else unchanged. JSON round-trips
    (store history.jsonl → analyze re-check) stringify dict keys, so
    checkers comparing read maps against int-keyed config (bank
    accounts, transfer's Accounts model) normalize through this before
    judging — a stored history must reach the live verdict."""
    if isinstance(k, str):
        try:
            return int(k)
        except ValueError:
            return k
    return k


def int_keyed(d: dict) -> dict:
    return {int_key(k): v for k, v in d.items()}
