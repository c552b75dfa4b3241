"""Host helpers shared by the checkers."""
from __future__ import annotations

import json
import logging
import math
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Iterable, Sequence

logger = logging.getLogger("jepsen_tpu_torch")

# copied from jepsen_tpu/utils/__init__.py:25
NANOS_PER_MILLI = 1_000_000


# copied from jepsen_tpu/utils/__init__.py:34-45
def atomic_write_json(path, value) -> None:
    """Durable atomic JSON write: tmp file + flush + fsync + rename, so
    readers never see a torn document and the content survives a crash."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(value, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# copied from jepsen_tpu/utils/__init__.py:196-203
def bounded_pmap(fn: Callable, coll: Iterable, bound: int | None = None) -> list:
    """Parallel map with a bounded worker pool (dom-top bounded-pmap)."""
    coll = list(coll)
    if not coll:
        return []
    bound = bound or min(32, len(coll))
    with ThreadPoolExecutor(max_workers=bound) as pool:
        return list(pool.map(fn, coll))


# copied from jepsen_tpu/utils/__init__.py:436-441
def quantile(sorted_xs: Sequence[float], q: float) -> float:
    """Nearest-rank quantile over a pre-sorted sequence."""
    if not sorted_xs:
        return math.nan
    i = min(len(sorted_xs) - 1, max(0, int(math.ceil(q * len(sorted_xs))) - 1))
    return sorted_xs[i]


# copied from jepsen_tpu/utils/__init__.py:81-82
def nanos_to_ms(n: int) -> float:
    return n / NANOS_PER_MILLI


# copied from jepsen_tpu/utils/__init__.py:444-446
def fraction(a: float, b: float) -> float:
    """a/b, but 1 when b is zero (checker.clj stats convention)."""
    return a / b if b else 1.0


# copied from jepsen_tpu/utils/__init__.py:391-412
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


# copied from jepsen_tpu/utils/__init__.py:415-433
def nemesis_intervals(history: list[dict], start_fs=("start",),
                      stop_fs=("stop",)) -> list[tuple]:
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


# copied from jepsen_tpu/utils/__init__.py:374-384
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


# copied from jepsen_tpu/utils/__init__.py:133-161, without the total
# wait bound (``max_wait_s``), which the port's one caller does not pass
JOIN_HEARTBEAT_S = 30.0


def join_noisy(thread: threading.Thread, what: str,
               heartbeat_s: float = JOIN_HEARTBEAT_S) -> None:
    """Joins ``thread`` with the same wait-forever semantics as a bare
    ``join()``, but bounded per wait with a heartbeat log — the caller
    is never wedged SILENTLY, and a stuck thread is diagnosable from
    the log."""
    waited = 0.0
    while thread.is_alive():
        thread.join(timeout=heartbeat_s)
        if thread.is_alive():
            waited += heartbeat_s
            logger.warning("%s still running after %.0fs", what, waited)
