"""jepsen_tpu_torch's host checkers against jepsen_tpu's on the CPU: the
stats, unhandled-exceptions, queue, total-queue, unique-ids, counter and
log-file checkers, the trivial ones (noop, unbridled optimism, the
concurrency limit), the drain expansion and the helpers they read
(``history.is_client_op``, ``utils.nanos_to_ms``, ``fraction``,
``history_to_latencies``, ``nemesis_intervals``). Each case feeds one
seeded numpy-made history to both packages; the result maps must be
equal, tolerance zero."""
from __future__ import annotations

import numpy as np
import pytest

from jepsen_tpu_torch.histories import (
    register_history, stamp_times, with_nemesis,
)


def _register_run(n_ops=200, seed=5, errors=0):
    """A timed register history with a nemesis window, a check-offsets op
    and ``errors`` seeded fail/info completions carrying an error (some
    with an exception map)."""
    h = stamp_times(register_history(n_ops, n_procs=4, seed=seed,
                                     n_values=5), seed=seed)
    rng = np.random.default_rng(seed)
    done = [i for i, op in enumerate(h) if op["type"] != "invoke"]
    for k, i in enumerate(rng.choice(done, size=errors, replace=False)):
        op = dict(h[int(i)])
        op["type"] = "info" if k % 2 else "fail"
        op["error"] = ["timeout", "conn-refused", ":unavailable"][k % 3]
        if k % 4 == 3:
            op["exception"] = {"class": "IOException", "msg": f"e{k % 2}"}
        h[int(i)] = op
    h, _ = with_nemesis(h, [(30, 90, "start", "stop")], offsets_at=(50,),
                        seed=seed)
    return h


def _queue_history(n=120, seed=3, lose=0, unexpected=0, dup=0,
                   fail_enq=0, drain=None):
    """Enqueues of distinct values by 3 processes and dequeues draining
    them in a seeded order; ``lose`` acknowledged values never dequeued,
    ``unexpected`` dequeues of values never enqueued, ``dup`` values
    dequeued twice, ``fail_enq`` enqueues that fail (never acked, never
    dequeued: a few are recovered below). ``drain`` "ok" or "info" drains
    the last dequeues in one drain op of that type."""
    rng = np.random.default_rng(seed)
    h = []
    vals = list(range(n))
    failed = set(rng.choice(n, size=fail_enq, replace=False).tolist())
    for v in vals:
        p = v % 3
        h.append({"type": "invoke", "process": p, "f": "enqueue",
                  "value": v})
        h.append({"type": "fail" if v in failed else "ok", "process": p,
                  "f": "enqueue", "value": v})
    out = [v for v in rng.permutation(vals).tolist() if v not in failed]
    out += sorted(failed)[:1]          # one failed enqueue came out anyway
    out = out[lose:]
    out += [10_000 + k for k in range(unexpected)]
    out += out[:dup]
    tail = []
    if drain is not None:
        out, tail = out[:-5], out[-5:]
    for v in out:
        h.append({"type": "invoke", "process": 3, "f": "dequeue",
                  "value": None})
        h.append({"type": "ok", "process": 3, "f": "dequeue", "value": v})
    if drain is not None:
        h.append({"type": "invoke", "process": 4, "f": "drain",
                  "value": None})
        h.append({"type": drain, "process": 4, "f": "drain", "value": tail})
    return h


def _ids_history(n=150, seed=4, dups=0):
    rng = np.random.default_rng(seed)
    ids = rng.choice(10 ** 6, size=n, replace=False).tolist()
    for k in range(dups):
        ids[-1 - k] = ids[k]
    h = []
    for i, v in enumerate(ids):
        p = i % 4
        h.append({"type": "invoke", "process": p, "f": "generate",
                  "value": None})
        h.append({"type": "ok" if i % 17 else "info", "process": p,
                  "f": "generate", "value": v if i % 17 else None})
    return h


def _counter_history(n=200, seed=6, bad_read=False, negative=False):
    """Adds (some failing, some indeterminate) and reads of a counter by
    4 processes; each read answers a value inside the window the
    checker computes, or, with ``bad_read``, one read answers past it."""
    rng = np.random.default_rng(seed)
    h = []
    total = 0
    for i in range(n):
        p = i % 4
        if rng.random() < 0.6:
            v = int(rng.integers(-3 if negative else 1, 6))
            h.append({"type": "invoke", "process": p, "f": "add",
                      "value": v})
            r = rng.random()
            typ = "ok" if r < 0.7 else "fail" if r < 0.85 else "info"
            if typ == "ok":
                total += v
            h.append({"type": typ, "process": p, "f": "add", "value": v})
        else:
            h.append({"type": "invoke", "process": p, "f": "read",
                      "value": None})
            h.append({"type": "ok", "process": p, "f": "read",
                      "value": total})
    if bad_read:
        h.append({"type": "invoke", "process": 0, "f": "read",
                  "value": None})
        h.append({"type": "ok", "process": 0, "f": "read",
                  "value": 10 ** 6})
    return h


def _checkers(ctor, *args):
    """(the port's checker, the JAX package's) from a constructor name."""
    from jepsen_tpu import checker as rc
    from jepsen_tpu_torch import checker as pc
    return getattr(pc, ctor)(*args), getattr(rc, ctor)(*args)


CASES = {
    "stats-valid": ("stats", (), lambda: _register_run(), True),
    "stats-errors": ("stats", (), lambda: _register_run(errors=12), True),
    "stats-never-ok": ("stats", (), lambda: _register_run() + [
        {"type": "invoke", "process": 1, "f": "scan", "value": None},
        {"type": "fail", "process": 1, "f": "scan", "value": None}],
        False),
    "stats-ungated": ("stats", (("scan",),), lambda: _register_run() + [
        {"type": "invoke", "process": 1, "f": "scan", "value": None},
        {"type": "fail", "process": 1, "f": "scan", "value": None}],
        True),
    "stats-empty": ("stats", (), lambda: [], True),
    "exceptions": ("unhandled_exceptions", (),
                   lambda: _register_run(errors=12), True),
    "exceptions-none": ("unhandled_exceptions", (),
                        lambda: _register_run(), True),
    "exceptions-empty": ("unhandled_exceptions", (), lambda: [], True),
    "total-queue-valid": ("total_queue", (), lambda: _queue_history(),
                          True),
    "total-queue-lost": ("total_queue", (),
                         lambda: _queue_history(lose=4, fail_enq=3), False),
    "total-queue-unexpected": ("total_queue", (),
                               lambda: _queue_history(unexpected=2, dup=3),
                               False),
    "total-queue-duplicated": ("total_queue", (),
                               lambda: _queue_history(dup=3), True),
    "total-queue-drain": ("total_queue", (),
                          lambda: _queue_history(drain="ok"), True),
    "total-queue-crashed-drain": ("total_queue", (),
                                  lambda: _queue_history(drain="info"),
                                  True),
    "total-queue-empty": ("total_queue", (), lambda: [], True),
    "unique-ids-valid": ("unique_ids", (), lambda: _ids_history(), True),
    "unique-ids-dups": ("unique_ids", (), lambda: _ids_history(dups=3),
                        False),
    "unique-ids-empty": ("unique_ids", (), lambda: [], True),
    "counter-valid": ("counter", (), lambda: _counter_history(), True),
    "counter-negative": ("counter", (),
                         lambda: _counter_history(negative=True), True),
    "counter-bad-read": ("counter", (),
                         lambda: _counter_history(bad_read=True), False),
    "counter-empty": ("counter", (), lambda: [], True),
    "noop": ("noop", (), lambda: _register_run(), True),
    "unbridled-optimism": ("unbridled_optimism", (),
                           lambda: _counter_history(bad_read=True), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_checker_matches_jax(case):
    ctor, args, make, valid = CASES[case]
    history = make()
    got_chk, want_chk = _checkers(ctor, *args)
    got = got_chk.check({}, history, {})
    assert got == want_chk.check({}, history, {})
    assert got["valid?"] is valid


def test_counter_failed_add_rolls_back():
    """A failed add leaves the window as it was: a read of the old total
    is valid in both packages, and the window is the reference's."""
    h = [{"type": "invoke", "process": 0, "f": "add", "value": 5},
         {"type": "invoke", "process": 1, "f": "read", "value": None},
         {"type": "ok", "process": 1, "f": "read", "value": 5},
         {"type": "fail", "process": 0, "f": "add", "value": 5},
         {"type": "invoke", "process": 1, "f": "read", "value": None},
         {"type": "ok", "process": 1, "f": "read", "value": 5}]
    got_chk, want_chk = _checkers("counter")
    got = got_chk.check({}, h, {})
    assert got == want_chk.check({}, h, {})
    assert got["valid?"] is False and got["final-bounds"] == [0, 0]
    assert [e["op"]["value"] for e in got["errors"]] == [5]


@pytest.mark.parametrize("model,bad", [("UnorderedQueue", False),
                                       ("UnorderedQueue", True),
                                       ("FIFOQueue", False),
                                       ("FIFOQueue", True)])
def test_queue_checker_matches_jax(model, bad):
    """The model-based queue check: an in-order drain is valid under
    both models; an unexpected dequeue, or (FIFO) one out of order, is
    invalid at the same op with the same message."""
    from jepsen_tpu import models as rm
    from jepsen_tpu_torch import models as pm
    h = []
    for v in range(12):
        h.append({"type": "invoke", "process": v % 2, "f": "enqueue",
                  "value": v})
        h.append({"type": "ok", "process": v % 2, "f": "enqueue",
                  "value": v})
    order = list(range(12))
    if bad:
        order[4:6] = [5, 4] if model == "FIFOQueue" else [5, 99]
    for v in order[:10]:
        h.append({"type": "invoke", "process": 2, "f": "dequeue",
                  "value": None})
        h.append({"type": "ok", "process": 2, "f": "dequeue", "value": v})
    from jepsen_tpu.checker import queue as ref_queue
    from jepsen_tpu_torch.checker import queue
    got = queue(getattr(pm, model)()).check({}, h, {})
    assert got == ref_queue(getattr(rm, model)()).check({}, h, {})
    assert got["valid?"] is not bad
    if not bad:
        assert got["final-queue-size"] == 2


def test_crashed_drain_without_elements_raises_in_both():
    from jepsen_tpu.checker import expand_queue_drain_ops as ref_expand
    from jepsen_tpu_torch.checker import expand_queue_drain_ops
    h = [{"type": "invoke", "process": 0, "f": "drain", "value": None},
         {"type": "info", "process": 0, "f": "drain", "value": None}]
    for fn in (expand_queue_drain_ops, ref_expand):
        with pytest.raises(ValueError, match="crashed drain"):
            fn(h)
    ok = _queue_history(n=20, drain="info")
    assert expand_queue_drain_ops(ok) == ref_expand(ok)


@pytest.mark.parametrize("lines,pattern", [
    ({"n1": "ok\nall good\n", "n2": "fine\n"}, "panic|FATAL"),
    ({"n1": "ok\nFATAL: disk\n", "n2": "panic: x\nmore\n"}, "panic|FATAL"),
    ({"n1": "FATAL once\n"}, "FATAL"),          # n2's log is missing
])
def test_log_file_pattern_matches_jax(tmp_path, lines, pattern):
    from jepsen_tpu import store as ref_store
    from jepsen_tpu_torch import store
    test = {"name": "logs", "start_time": "t0", "store_dir": str(tmp_path),
            "nodes": ["n1", "n2"]}
    for node, text in lines.items():
        store.path_mk(test, node, "db.log").write_text(text)
    assert ref_store.path(test, "n1", "db.log") == store.path(
        test, "n1", "db.log")
    got_chk, want_chk = _checkers("log_file_pattern", pattern, "db.log")
    got = got_chk.check(test, [], {})
    assert got == want_chk.check(test, [], {})
    assert got["valid?"] is (got["count"] == 0)


def test_concurrency_limit_matches_jax():
    from jepsen_tpu.checker import ConcurrencyLimit as Ref
    from jepsen_tpu.checker import Stats as RefStats
    from jepsen_tpu_torch.checker import ConcurrencyLimit, Stats
    h = _register_run(errors=4)
    got = ConcurrencyLimit(2, Stats()).check({}, h, {})
    assert got == Ref(2, RefStats()).check({}, h, {})
    assert ConcurrencyLimit(2, Stats())._sem is ConcurrencyLimit(
        2, Stats())._sem


@pytest.mark.parametrize("seed", [0, 1])
def test_history_helpers_match_jax(seed):
    from jepsen_tpu import history as rh
    from jepsen_tpu import utils as ru
    from jepsen_tpu_torch import history, utils
    h = _register_run(n_ops=80, seed=seed)
    # an invoke left open at the end gets the max time as its latency
    h.append({"type": "invoke", "process": 9, "f": "read", "value": None,
              "time": h[-1]["time"] + 5})
    h += [{"type": "info", "process": "nemesis", "f": "start",
           "value": None, "time": h[-1]["time"] + 7}]
    assert utils.history_to_latencies(h) == ru.history_to_latencies(h)
    assert utils.nemesis_intervals(h) == ru.nemesis_intervals(h)
    assert utils.nemesis_intervals(h, ("check-offsets",), ("stop",)) == \
        ru.nemesis_intervals(h, ("check-offsets",), ("stop",))
    assert [history.is_client_op(op) for op in h] == \
        [rh.is_client_op(op) for op in h]
    for n in (0, 1, 999_999, 1_500_000, 2 ** 40):
        assert utils.nanos_to_ms(n) == ru.nanos_to_ms(n)
    for a, b in ((3, 4), (0, 0), (5, 0), (2.5, 7.0)):
        assert utils.fraction(a, b) == ru.fraction(a, b)
