"""Deterministic generator simulation — the unit-test backbone (the port
of jepsen_tpu/generator/simulate.py, its Python path: the C scheduler
lane ``sim_lane`` waits with ``columnar_ext.c``'s copy of it).

Equivalent capability to jepsen.generator.test (shipped in the reference's
src/ as a public testing kit, jepsen/src/jepsen/generator/test.clj): a
simulated scheduler with model workers of fixed latency, so generator
behavior is asserted as exact op/time/process sequences without threads or a
cluster (SURVEY.md §4 tier 1).
"""
from __future__ import annotations

import random
import time as _time
from heapq import heappop as _heappop, heappush as _heappush
from typing import Callable

from jepsen_tpu_torch.generator import (
    NEMESIS, PENDING, Context, as_gen, context, next_process,
)
from jepsen_tpu_torch.utils import ms_to_nanos

DEFAULT_TEST = {"concurrency": 2}


# copied from jepsen_tpu/generator/simulate.py:45-68
def default_context(test: dict | None = None, seed: int = 0) -> Context:
    """Two client workers plus nemesis, deterministic rng
    (generator/test.clj:8-24, with-fixed-rand seeding :32-40)."""
    return context(test or DEFAULT_TEST, rng=random.Random(seed))


class StepClock:
    """A virtual wall clock derived from its OWN call count: each read
    advances ``step_s`` seconds. Injected into :func:`simulate` as
    ``clock``, it makes ``max_wall_s`` a pure step-count cap — the same
    seed truncates at the same op under any machine load, which is the
    reproducibility contract schedule fuzzing is built on
    (doc/robustness.md "Schedule fuzzing")."""

    def __init__(self, step_s: float = 1e-6):
        self.step_s = step_s
        self.reads = 0

    def __call__(self) -> float:
        t = self.reads * self.step_s
        self.reads += 1
        return t


# copied from jepsen_tpu/generator/simulate.py:69-254, without the
# native lane's branch
def simulate(
    test: dict,
    gen,
    complete_fn: Callable[[Context, dict], dict | None],
    ctx: Context | None = None,
    limit: int = 100_000,
    *,
    seed: int = 0,
    max_wall_s: float | None = None,
    stats: dict | None = None,
    clock: Callable[[], float] | None = None,
) -> list[dict]:
    """Simulates gen against model workers.

    complete_fn(ctx, invoke_op) -> completion op (type ok/fail/info, with
    :time set to when the worker would finish) or None for ops that never
    complete. Pseudo-ops (:sleep/:log) occupy their thread for their
    duration but do not enter the returned history.

    Returns the full history: invokes and completions interleaved in time
    order, with generator updates and crashed-process renumbering applied
    exactly as the threaded interpreter would.

    Termination is guaranteed: ``limit`` caps scheduler steps (each step
    either emits an op, applies a completion, or breaks), ``seed`` makes
    the default context's rng injectable (deterministic enumeration —
    preflight and exact-sequence tests depend on it), and ``max_wall_s``
    adds a hard wall-clock cap for generators whose per-op cost is
    unbounded (preflight must never hang on a pathological generator);
    on expiry the history collected so far is returned. A generator
    stuck at :pending with nothing in flight is a deadlock and breaks
    immediately rather than spinning.

    ``clock`` makes the wall-cap clock injectable (default
    ``time.monotonic``). The real clock means the same seed can
    truncate at DIFFERENT ops under different machine load — fine for
    preflight's never-hang cap, fatal for seed ⇒ schedule
    reproducibility. Callers that need exact replay pass a virtual
    clock (:class:`StepClock`), making the cap a deterministic
    function of scheduler steps alone.

    Pass a dict as ``stats`` to learn HOW the simulation ended:
    ``steps`` taken, and ``step_limited`` / ``wall_limited`` flags —
    callers that must distinguish "generator exhausted" from "cap hit"
    (preflight's GEN003 truncation diagnostic) read these instead of
    guessing from history length.
    """
    ctx = ctx or default_context(test, seed=seed)
    g = as_gen(gen)
    history: list[dict] = []
    # completions waiting for their time, as a (time, seq, op) heap:
    # the soonest is peeked on EVERY step but removed only when it
    # applies, so O(1) peek beats the old per-step linear min(). ``seq``
    # (monotone insertion order) breaks time ties exactly the way the
    # old first-match scan did — and keeps the un-comparable op dicts
    # out of the tuple comparison.
    pending: list[tuple] = []
    pending_seq = 0
    if stats is None:
        stats = {}
    stats.update(steps=0, step_limited=False, wall_limited=False)

    if clock is None:
        clock = _time.monotonic
    deadline = (clock() + max_wall_s
                if max_wall_s is not None else None)
    steps = 0
    try:
        while True:
            if steps >= limit:
                stats["step_limited"] = True
                break
            steps += 1
            if deadline is not None and clock() >= deadline:
                stats["wall_limited"] = True
                break
            comp = pending[0][2] if pending else None
            res = g.op(test, ctx) if g is not None else None
            if res is None:
                if comp is None:
                    break
                g, ctx, _ = _apply_completion(test, g, ctx, comp, history)
                _heappop(pending)
                continue
            op, g_next = res
            if op is PENDING:
                if comp is None:
                    # Nothing will ever free a thread or advance time:
                    # deadlock.
                    break
                g, ctx, _ = _apply_completion(test, g, ctx, comp, history)
                _heappop(pending)
                continue
            if comp is not None and pending[0][0] <= op["time"]:
                # the completion happens first: apply it (updating the
                # generator — an until_ok/on_update must see it) and
                # reconsult; the op we were offered came from the
                # pre-completion generator state and is NOT dispatched
                g, ctx, _ = _apply_completion(test, g, ctx, comp, history)
                _heappop(pending)
                continue
            # dispatch the op
            g = g_next
            if op["time"] > ctx.time:
                ctx = ctx.with_time(op["time"])
            thread = (NEMESIS if op["process"] == NEMESIS
                      else ctx.thread_of(op["process"]))
            ctx = ctx.busy_thread(thread)
            if op["type"] in ("sleep", "log"):
                dt = op["value"] if op["type"] == "sleep" else 0
                completion = dict(op)
                completion["time"] = (op["time"]
                                      + ms_to_nanos(dt * 1000 if dt else 0))
                completion["type"] = "__free__"
                _heappush(pending,
                          (completion["time"], pending_seq, completion))
                pending_seq += 1
                if g is not None:
                    g = g.update(test, ctx, op)
                continue
            history.append(op)
            if g is not None:
                g = g.update(test, ctx, op)
            completion = complete_fn(ctx, op)
            if completion is not None:
                _heappush(pending,
                          (completion["time"], pending_seq, completion))
                pending_seq += 1
    finally:
        stats["steps"] = steps
    return history


def _apply_completion(test, g, ctx, comp, history):
    if comp["time"] > ctx.time:
        ctx = ctx.with_time(comp["time"])
    thread = NEMESIS if comp["process"] == NEMESIS else ctx.thread_of(comp["process"])
    ctx = ctx.free_thread(thread)
    if comp["type"] == "__free__":
        return g, ctx, False
    if comp["type"] == "info" and comp["process"] != NEMESIS:
        # crashed: worker gets a fresh process id (generator.clj:519-527)
        ctx = ctx.with_next_process(thread)
    history.append(comp)
    if g is not None:
        g = g.update(test, ctx, comp)
    return g, ctx, False


# copied from jepsen_tpu/generator/simulate.py:401-432
def _completer(typ: str, latency_nanos: int):
    def complete(ctx: Context, op: dict):
        comp = dict(op)
        comp["type"] = typ
        comp["time"] = op["time"] + latency_nanos
        return comp
    return complete


def quick(test: dict, gen, ctx: Context | None = None, **caps) -> list[dict]:
    """Zero-latency :ok completions — the fastest way to see what a
    generator emits (generator/test.clj quick). ``caps`` pass through to
    :func:`simulate` (``seed``/``limit``/``max_wall_s`` — preflight's
    bounded enumeration rides this)."""
    return simulate(test, gen, _completer("ok", 0), ctx, **caps)


def perfect(test: dict, gen, ctx: Context | None = None, latency_ms: float = 10.0, **caps) -> list[dict]:
    """Fixed-latency :ok completions (generator/test.clj perfect)."""
    return simulate(test, gen, _completer("ok", ms_to_nanos(latency_ms)), ctx, **caps)


def perfect_info(test: dict, gen, ctx: Context | None = None, latency_ms: float = 10.0, **caps) -> list[dict]:
    """Fixed-latency :info (crashed) completions — exercises process
    renumbering (generator/test.clj perfect-info)."""
    return simulate(test, gen, _completer("info", ms_to_nanos(latency_ms)), ctx, **caps)


def invocations(history: list[dict]) -> list[dict]:
    return [op for op in history if op.get("type") == "invoke"]
