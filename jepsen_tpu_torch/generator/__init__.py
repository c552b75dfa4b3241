"""Purely-functional op scheduling DSL (the port of
jepsen_tpu/generator/__init__.py, after jepsen/src/jepsen/generator.clj).

A *generator* is an immutable value with two operations::

    gen.op(test, ctx)      -> None                      (exhausted)
                            | (PENDING, gen')           (nothing soon)
                            | (op_dict, gen')           (op to run at op["time"])

    gen.update(test, ctx, event) -> gen'                (react to history event)

(protocol at generator.clj:382-390). Plain data act as generators
(generator.clj:545-620): a dict emits exactly one op; a list emits each
element in order; a callable is invoked as ``f(test, ctx)`` or ``f()`` each
time and stays in place until it returns None; None is exhausted.

The *context* models logical time (relative nanos), the set of free threads,
and the thread->process map (generator.clj:453-464). All scheduling decisions
are pure: the interpreter (generator/interpreter.py) and the deterministic
simulator (generator/simulate.py) both drive the same protocol, which is what
makes the reference's exact-output unit-test strategy (SURVEY.md §4 tier 1)
possible here.
"""
from __future__ import annotations

import logging
import random as _random
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Iterable, Sequence

from jepsen_tpu_torch.utils import secs_to_nanos

logger = logging.getLogger("jepsen_tpu_torch.generator")

# copied from jepsen_tpu/generator/__init__.py:32-1307 (whole)

NEMESIS = "nemesis"


class _Pending:
    __slots__ = ()

    def __repr__(self):
        return "PENDING"


PENDING = _Pending()


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Context:
    """Scheduling context: logical time, free threads, thread->process map.

    Threads are identified by ints 0..n-1 plus the string "nemesis". A
    *process* is the logical client identity; when a process crashes (:info),
    its thread gets a fresh process id = old + concurrency
    (generator.clj:519-527).
    """

    time: int = 0
    free_threads: frozenset = frozenset()
    workers: dict = field(default_factory=dict)  # thread -> process (treat as immutable)
    rng: _random.Random = field(default_factory=lambda: _random.Random(), compare=False, repr=False)

    # -- queries ----------------------------------------------------------
    def all_threads(self):
        return self.workers.keys()

    def thread_count(self) -> int:
        return len(self.workers)

    def process_of(self, thread):
        return self.workers[thread]

    def thread_of(self, process):
        # fast path: until a process crashes, workers[t] == t, so a
        # process that maps to itself IS its thread (process ids are
        # unique across the map, so no other thread can claim it)
        w = self.workers
        if process is not None and w.get(process) == process:
            return process
        for t, p in w.items():
            if p == process:
                return t
        return None

    def free_processes(self) -> list:
        return [self.workers[t] for t in self.free_threads]

    def some_free_process(self):
        """Fair uniform choice among free threads' processes
        (generator.clj:480-487; fairness rationale 438-449)."""
        if not self.free_threads:
            return None
        # the sorted view is memoized by the free-thread SET value —
        # contexts churn every step but cycle through few distinct sets,
        # and the per-poll sort was the scheduler loop's second-hottest
        # cost (the reference leans on Bifurcan's ordered sets here)
        ts = _FREE_SORT_CACHE.get(self.free_threads)
        if ts is None:
            if len(_FREE_SORT_CACHE) > 4096:
                _FREE_SORT_CACHE.clear()
            ts = sorted(self.free_threads, key=_thread_sort_key)
            _FREE_SORT_CACHE[self.free_threads] = ts
        # rng._randbelow is the exact draw randrange()/choice() bottom
        # out in (Random dispatches it per-instance, so subclasses that
        # override random() keep their variant) — byte-identical entropy
        # consumption, so deterministic enumeration (preflight,
        # exact-sequence tests) sees the same schedule, minus two frames
        # of argument plumbing on the hottest call of the scheduler
        return self.workers[ts[self.rng._randbelow(len(ts))]]

    # -- functional updates (direct __dict__ construction: the generated
    # frozen-dataclass __init__ routes every field through
    # object.__setattr__, ~3x the cost of plain dict stores, and these
    # three run on every scheduler step) --------------------------------
    def with_time(self, time: int) -> "Context":
        c = Context.__new__(Context)
        d = c.__dict__
        d["time"] = time
        d["free_threads"] = self.free_threads
        d["workers"] = self.workers
        d["rng"] = self.rng
        return c

    def busy_thread(self, thread) -> "Context":
        # free-thread sets cycle through a tiny space (2^threads), so
        # the set algebra is memoized the same way the sorted view is
        key = (self.free_threads, thread)
        fs = _FREE_SUB_CACHE.get(key)
        if fs is None:
            if len(_FREE_SUB_CACHE) > 4096:
                _FREE_SUB_CACHE.clear()
            fs = _FREE_SUB_CACHE[key] = self.free_threads - {thread}
        c = Context.__new__(Context)
        d = c.__dict__
        d["time"] = self.time
        d["free_threads"] = fs
        d["workers"] = self.workers
        d["rng"] = self.rng
        return c

    def free_thread(self, thread) -> "Context":
        key = (self.free_threads, thread)
        fs = _FREE_ADD_CACHE.get(key)
        if fs is None:
            if len(_FREE_ADD_CACHE) > 4096:
                _FREE_ADD_CACHE.clear()
            fs = _FREE_ADD_CACHE[key] = self.free_threads | {thread}
        c = Context.__new__(Context)
        d = c.__dict__
        d["time"] = self.time
        d["free_threads"] = fs
        d["workers"] = self.workers
        d["rng"] = self.rng
        return c

    def with_next_process(self, thread) -> "Context":
        """Assigns a fresh process id to thread after a crash."""
        workers = dict(self.workers)
        workers[thread] = next_process(self, thread)
        return replace(self, workers=workers)

    def restrict(self, threads: frozenset) -> "Context":
        """A sub-context containing only the given threads (on-threads,
        generator.clj:844-883)."""
        return replace(
            self,
            free_threads=self.free_threads & threads,
            workers={t: p for t, p in self.workers.items() if t in threads},
        )


_FREE_SORT_CACHE: dict = {}
_FREE_SUB_CACHE: dict = {}
_FREE_ADD_CACHE: dict = {}


def _thread_sort_key(t):
    return (1, 0) if t == NEMESIS else (0, t)


def next_process(ctx: Context, thread):
    """Process id for thread after its current process crashes: old + number
    of client threads; nemesis never renumbers (generator.clj:519-527)."""
    if thread == NEMESIS:
        return NEMESIS
    client_threads = sum(1 for t in ctx.workers if t != NEMESIS)
    return ctx.workers[thread] + client_threads


def context(test: dict, rng: _random.Random | None = None) -> Context:
    """Fresh context for a test: threads 0..concurrency-1 plus nemesis, all
    free, workers[i] = i (generator.clj:453-464)."""
    n = test.get("concurrency", 1)
    threads = list(range(n)) + [NEMESIS]
    return Context(
        time=0,
        free_threads=frozenset(threads),
        workers={t: t for t in threads},
        rng=rng or _random.Random(),
    )


def fill_in_op(op: dict, ctx: Context):
    """Fills in missing :time (ctx.time) and :process (some free process) on
    an op template (generator.clj:531-543). Returns PENDING if the op needs a
    process and none is free."""
    op = dict(op)
    if op.get("process") is None:
        p = ctx.some_free_process()
        if p is None:
            return PENDING
        op["process"] = p
    if op.get("time") is None:
        op["time"] = ctx.time
    op.setdefault("type", "invoke")
    op.setdefault("f", None)
    op.setdefault("value", None)
    return op


# ---------------------------------------------------------------------------
# The Generator protocol + data coercion
# ---------------------------------------------------------------------------

class Generator:
    def op(self, test: dict, ctx: Context):
        raise NotImplementedError

    def update(self, test: dict, ctx: Context, event: dict) -> "Generator":
        return self

    # Combinator sugar so gens compose fluently.
    def __rshift__(self, other):
        return then(other, self)


def as_gen(x) -> "Generator | None":
    """Coerces plain data to a generator (generator.clj:545-620)."""
    if x is None or isinstance(x, Generator):
        return x
    if isinstance(x, dict):
        return OpTemplate(x)
    if isinstance(x, (list, tuple)):
        return Seq([e for e in x if e is not None])
    if callable(x):
        return Fn(x)
    raise TypeError(f"don't know how to treat {x!r} as a generator")


@dataclass(frozen=True)
class OpTemplate(Generator):
    """A dict is a generator that emits exactly one op, then is exhausted."""

    template: dict

    def op(self, test, ctx):
        op = fill_in_op(self.template, ctx)
        if op is PENDING:
            return (PENDING, self)
        return (op, None)


@dataclass(frozen=True)
class Fn(Generator):
    """A callable invoked as f(test, ctx) or f() each time an op is needed.
    Returns an op-map or generator; the fn itself stays in place. Exhausted
    when the call returns None (generator.clj:575-599)."""

    f: Callable

    def op(self, test, ctx):
        # the calling convention (f(test, ctx) vs f()) is discovered once
        # by trial and memoized: the old raise-and-retry probe cost ~1µs
        # of exception machinery on EVERY op for zero-arity fns — the
        # single hottest line of the simulated scheduler. The memo lives
        # outside the dataclass fields, so equality/hash are unchanged.
        f = self.f
        style = self.__dict__.get("_style")
        if style == 0:
            x = f()
        elif style == 1:
            x = f(test, ctx)
        else:
            try:
                x = f(test, ctx)
                object.__setattr__(self, "_style", 1)
            except TypeError as e:
                if "positional argument" in str(e):
                    x = f()
                    object.__setattr__(self, "_style", 0)
                else:
                    raise
        return self.op_tail(test, ctx, x)

    def op_tail(self, test, ctx, x):
        """Fn.op's tail after ``x = f()`` — split out, in the reference,
        so its native scheduler lane can hand back an already-consumed x
        on bail without calling f twice."""
        if x is None:
            return None
        if type(x) is dict:
            # exactly what as_gen→OpTemplate.op would produce — one op,
            # inner generator exhausted, the fn stays as continuation —
            # with fill_in_op's body inlined (x may be a shared template,
            # so the copy is load-bearing; only the frames are shed)
            op = dict(x)
            if op.get("process") is None:
                p = ctx.some_free_process()
                if p is None:
                    return (PENDING, self)
                op["process"] = p
            if op.get("time") is None:
                op["time"] = ctx.time
            op.setdefault("type", "invoke")
            op.setdefault("f", None)
            op.setdefault("value", None)
            return (op, self)
        gen = as_gen(x)
        res = gen.op(test, ctx)
        if res is None:
            return None
        op, gen2 = res
        if op is PENDING:
            return (PENDING, self)
        # emitted one op from the result; the fn remains our continuation
        return (op, self if gen2 is None else Seq([gen2, self]))


@dataclass(frozen=True)
class Seq(Generator):
    """Emits each element generator in order (vectors/seqs as generators)."""

    gens: tuple

    def __init__(self, gens: Iterable):
        object.__setattr__(self, "gens", tuple(gens))

    def op(self, test, ctx):
        gens = self.gens
        while gens:
            g = as_gen(gens[0])
            if g is None:
                gens = gens[1:]
                continue
            res = g.op(test, ctx)
            if res is None:
                gens = gens[1:]
                continue
            op, g2 = res
            rest = (g2,) + gens[1:] if g2 is not None else gens[1:]
            if op is PENDING and not rest:
                return (PENDING, Seq(()))
            return (op, Seq(rest) if rest else None)
        return None

    def update(self, test, ctx, event):
        if not self.gens:
            return self
        g = as_gen(self.gens[0])
        if g is None:
            return self
        g2 = g.update(test, ctx, event)
        return Seq((g2,) + self.gens[1:])


# ---------------------------------------------------------------------------
# Combinators
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Validate(Generator):
    """Checks that emitted ops are well-formed (generator.clj:622-676)."""

    gen: Any

    def op(self, test, ctx):
        g = as_gen(self.gen)
        if g is None:
            return None
        res = g.op(test, ctx)
        if res is None:
            return None
        op, g2 = res
        if op is not PENDING:
            problems = []
            if not isinstance(op, dict):
                problems.append(f"op {op!r} is not a dict")
            else:
                if op.get("type") not in ("invoke", "info", "sleep", "log"):
                    problems.append(f"bad :type {op.get('type')!r}")
                if op.get("type") == "invoke":
                    p = op.get("process")
                    if p not in ctx.free_processes():
                        problems.append(f"process {p!r} is not free")
                if not isinstance(op.get("time"), int):
                    problems.append("no :time")
            if problems:
                raise ValueError(f"invalid op {op!r}: {problems}")
        return (op, Validate(g2) if g2 is not None else None)

    def update(self, test, ctx, event):
        g = as_gen(self.gen)
        if g is None:
            return self
        return Validate(g.update(test, ctx, event))


@dataclass(frozen=True)
class FriendlyExceptions(Generator):
    """Wraps op/update to re-raise with generator context
    (generator.clj:678-718)."""

    gen: Any

    def op(self, test, ctx):
        g = as_gen(self.gen)
        if g is None:
            return None
        try:
            res = g.op(test, ctx)
        except Exception as e:
            raise RuntimeError(
                f"generator {type(g).__name__} threw {e!r} when asked for an op"
            ) from e
        if res is None:
            return None
        op, g2 = res
        return (op, FriendlyExceptions(g2) if g2 is not None else None)

    def update(self, test, ctx, event):
        g = as_gen(self.gen)
        if g is None:
            return self
        try:
            return FriendlyExceptions(g.update(test, ctx, event))
        except Exception as e:
            raise RuntimeError(
                f"generator {type(g).__name__} threw {e!r} on update {event!r}"
            ) from e


@dataclass(frozen=True)
class Trace(Generator):
    """Logs every op/update with context (generator.clj:720-763)."""

    k: str
    gen: Any

    def op(self, test, ctx):
        g = as_gen(self.gen)
        if g is None:
            logger.info("%s op -> exhausted", self.k)
            return None
        res = g.op(test, ctx)
        logger.info("%s op(time=%d free=%s) -> %r", self.k, ctx.time,
                    sorted(ctx.free_threads, key=_thread_sort_key), res and res[0])
        if res is None:
            return None
        op, g2 = res
        return (op, Trace(self.k, g2) if g2 is not None else None)

    def update(self, test, ctx, event):
        g = as_gen(self.gen)
        logger.info("%s update %r", self.k, event)
        if g is None:
            return self
        return Trace(self.k, g.update(test, ctx, event))


@dataclass(frozen=True)
class Map(Generator):
    """Applies f to every emitted op (generator.clj:765-796)."""

    f: Callable
    gen: Any

    def op(self, test, ctx):
        g = as_gen(self.gen)
        if g is None:
            return None
        res = g.op(test, ctx)
        if res is None:
            return None
        op, g2 = res
        if op is not PENDING:
            op = self.f(op)
        return (op, Map(self.f, g2) if g2 is not None else None)

    def update(self, test, ctx, event):
        g = as_gen(self.gen)
        if g is None:
            return self
        return Map(self.f, g.update(test, ctx, event))


def f_map(f_mapping: dict, gen) -> Generator:
    """Rewrites op :f via a mapping dict (for nemesis composition)."""
    def rewrite(op):
        op = dict(op)
        if op.get("f") in f_mapping:
            op["f"] = f_mapping[op["f"]]
        return op
    return Map(rewrite, gen)


def op_timeout(timeout_s, gen) -> Generator:
    """Stamps ``timeout_s`` onto every emitted op — the per-op deadline
    override the interpreter honors ahead of ``test['op_timeout_s']``
    (doc/robustness.md). ``None``/``0``
    exempts these ops from deadlines entirely (e.g. a legitimately
    slow schema migration riding alongside deadline-bounded traffic)."""
    def stamp(op):
        return {**op, "timeout_s": timeout_s}
    return Map(stamp, gen)


@dataclass(frozen=True)
class Filter(Generator):
    """Emits only ops satisfying pred (generator.clj:798-817)."""

    pred: Callable
    gen: Any

    def op(self, test, ctx):
        g = as_gen(self.gen)
        while g is not None:
            res = g.op(test, ctx)
            if res is None:
                return None
            op, g2 = res
            if op is PENDING or self.pred(op):
                return (op, Filter(self.pred, g2) if g2 is not None else None)
            g = g2  # skip this op
        return None

    def update(self, test, ctx, event):
        g = as_gen(self.gen)
        if g is None:
            return self
        return Filter(self.pred, g.update(test, ctx, event))


@dataclass(frozen=True)
class OnUpdate(Generator):
    """Calls (f this test ctx event) to transform the whole generator on
    every update (generator.clj:827-842)."""

    f: Callable
    gen: Any

    def op(self, test, ctx):
        g = as_gen(self.gen)
        if g is None:
            return None
        res = g.op(test, ctx)
        if res is None:
            return None
        op, g2 = res
        return (op, OnUpdate(self.f, g2) if g2 is not None else None)

    def update(self, test, ctx, event):
        return self.f(self, test, ctx, event)


@dataclass(frozen=True)
class OnThreads(Generator):
    """Restricts gen to threads satisfying pred (generator.clj:844-883)."""

    pred: Callable  # thread -> bool
    gen: Any

    def _threads(self, ctx: Context) -> frozenset:
        return frozenset(t for t in ctx.workers if self.pred(t))

    def op(self, test, ctx):
        g = as_gen(self.gen)
        if g is None:
            return None
        sub = ctx.restrict(self._threads(ctx))
        res = g.op(test, sub)
        if res is None:
            return None
        op, g2 = res
        return (op, OnThreads(self.pred, g2) if g2 is not None else None)

    def update(self, test, ctx, event):
        g = as_gen(self.gen)
        if g is None:
            return self
        p = event.get("process")
        thread = ctx.thread_of(p) if p != NEMESIS else NEMESIS
        if thread is not None and self.pred(thread):
            sub = ctx.restrict(self._threads(ctx))
            return OnThreads(self.pred, g.update(test, sub, event))
        return self


def on_threads(threads, gen) -> Generator:
    ts = frozenset(threads)
    return OnThreads(lambda t: t in ts, gen)


def clients(gen) -> Generator:
    """Restricts to client threads (generator.clj:1093-1103)."""
    return OnThreads(lambda t: t != NEMESIS, gen)


def nemesis_gen(gen) -> Generator:
    """Restricts to the nemesis thread (generator.clj:1105-1115)."""
    return OnThreads(lambda t: t == NEMESIS, gen)


def soonest_op_map(candidates: Sequence[tuple]) -> tuple | None:
    """Given (op, gen, weight-ish) candidate tuples, picks the one whose op
    has the earliest time; PENDING sorts last; ties break by weight-ish
    random choice (generator.clj:885-927). Candidates are (op, gen, key)."""
    best = None
    best_time = None
    for cand in candidates:
        op = cand[0]
        if op is PENDING:
            if best is None:
                best = cand
                best_time = None
        else:
            t = op.get("time", 0)
            if best_time is None or t < best_time:
                best = cand
                best_time = t
    return best


@dataclass(frozen=True)
class Any_(Generator):
    """Emits the soonest op from any of several generators
    (generator.clj:929-953). Updates propagate to all."""

    gens: tuple

    def op(self, test, ctx):
        candidates = []
        alive = []
        for i, g in enumerate(self.gens):
            g = as_gen(g)
            if g is None:
                continue
            res = g.op(test, ctx)
            if res is None:
                continue
            alive.append((i, g))
            candidates.append((res[0], res[1], i))
        if not candidates:
            return None
        best = soonest_op_map(candidates)
        op, g2, i = best
        new_gens = []
        for j, g in enumerate(self.gens):
            if as_gen(g) is None:
                new_gens.append(g)
            elif j == i:
                new_gens.append(g2)
            else:
                new_gens.append(g)
        if op is PENDING:
            return (PENDING, self)
        return (op, Any_(tuple(new_gens)))

    def update(self, test, ctx, event):
        return Any_(tuple(
            as_gen(g).update(test, ctx, event) if as_gen(g) is not None else g
            for g in self.gens
        ))


def any_gen(*gens) -> Generator:
    return Any_(tuple(gens))


@dataclass(frozen=True)
class EachThread(Generator):
    """Gives each thread its own private copy of gen
    (generator.clj:955-1007)."""

    gen: Any
    per_thread: tuple = ()  # ((thread, gen-or-EXHAUSTED), ...)

    _EXHAUSTED = ("__exhausted__",)

    def _table(self):
        return dict(self.per_thread)

    def op(self, test, ctx):
        table = self._table()
        candidates = []
        for t in sorted(ctx.free_threads, key=_thread_sort_key):
            g = table.get(t, self.gen)
            if g is EachThread._EXHAUSTED:
                continue
            g = as_gen(g)
            if g is None:
                continue
            sub = ctx.restrict(frozenset([t]))
            res = g.op(test, sub)
            if res is None:
                table[t] = EachThread._EXHAUSTED
                continue
            candidates.append((res[0], res[1], t))
        if not candidates:
            # exhausted only when every thread's gen is exhausted
            if all(table.get(t, self.gen) is EachThread._EXHAUSTED for t in ctx.workers):
                return None
            return (PENDING, replace(self, per_thread=tuple(table.items())))
        best = soonest_op_map(candidates)
        op, g2, t = best
        if op is PENDING:
            return (PENDING, replace(self, per_thread=tuple(table.items())))
        table[t] = g2 if g2 is not None else EachThread._EXHAUSTED
        return (op, replace(self, per_thread=tuple(table.items())))

    def update(self, test, ctx, event):
        p = event.get("process")
        t = NEMESIS if p == NEMESIS else ctx.thread_of(p)
        if t is None:
            return self
        table = self._table()
        g = table.get(t, self.gen)
        if g is EachThread._EXHAUSTED:
            return self
        g = as_gen(g)
        if g is None:
            return self
        sub = ctx.restrict(frozenset([t]))
        table[t] = g.update(test, sub, event)
        return replace(self, per_thread=tuple(table.items()))


def each_thread(gen) -> Generator:
    return EachThread(gen)


@dataclass(frozen=True)
class Reserve(Generator):
    """Reserves thread ranges for specific generators; remaining threads get
    the default (generator.clj:1009-1089). Args: [(n1, gen1), (n2, gen2), ...],
    default_gen."""

    ranges: tuple  # ((frozenset_of_threads, gen), ...)
    default: Any

    def op(self, test, ctx):
        candidates = []
        reserved = frozenset().union(*[r[0] for r in self.ranges]) if self.ranges else frozenset()
        for i, (threads, g) in enumerate(self.ranges):
            g = as_gen(g)
            if g is None:
                continue
            sub = ctx.restrict(threads)
            res = g.op(test, sub)
            if res is not None:
                candidates.append((res[0], res[1], i))
        dg = as_gen(self.default)
        if dg is not None:
            rest = frozenset(t for t in ctx.workers if t not in reserved)
            res = dg.op(test, ctx.restrict(rest))
            if res is not None:
                candidates.append((res[0], res[1], -1))
        if not candidates:
            return None
        op, g2, i = soonest_op_map(candidates)
        if op is PENDING:
            return (PENDING, self)
        if i == -1:
            return (op, replace(self, default=g2))
        ranges = list(self.ranges)
        ranges[i] = (ranges[i][0], g2)
        return (op, replace(self, ranges=tuple(ranges)))

    def update(self, test, ctx, event):
        p = event.get("process")
        t = NEMESIS if p == NEMESIS else ctx.thread_of(p)
        if t is None:
            return self
        for i, (threads, g) in enumerate(self.ranges):
            if t in threads:
                g = as_gen(g)
                if g is None:
                    return self
                ranges = list(self.ranges)
                ranges[i] = (threads, g.update(test, ctx.restrict(threads), event))
                return replace(self, ranges=tuple(ranges))
        dg = as_gen(self.default)
        if dg is None:
            return self
        reserved = frozenset().union(*[r[0] for r in self.ranges]) if self.ranges else frozenset()
        rest = frozenset(x for x in ctx.workers if x not in reserved)
        return replace(self, default=dg.update(test, ctx.restrict(rest), event))


def reserve(*args) -> Generator:
    """reserve(n1, gen1, n2, gen2, ..., default_gen): first n1 threads run
    gen1, next n2 run gen2, ..., all other threads (incl. nemesis? no —
    clients only by convention) run default."""
    *pairs, default = args
    assert len(pairs) % 2 == 0, "reserve takes n,gen pairs plus a default"
    ranges = []
    start = 0
    for i in range(0, len(pairs), 2):
        n, g = pairs[i], pairs[i + 1]
        ranges.append((frozenset(range(start, start + n)), g))
        start += n
    return Reserve(tuple(ranges), default)


@dataclass(frozen=True)
class Mix(Generator):
    """Uniform random mixture of generators; exhausted ones drop out
    (generator.clj:1124-1154)."""

    gens: tuple

    def op(self, test, ctx):
        gens = list(self.gens)
        while gens:
            i = ctx.rng.randrange(len(gens))
            g = as_gen(gens[i])
            if g is None:
                gens.pop(i)
                continue
            res = g.op(test, ctx)
            if res is None:
                gens.pop(i)
                continue
            op, g2 = res
            if op is PENDING:
                return (PENDING, Mix(tuple(gens)))
            gens[i] = g2 if g2 is not None else None
            if gens[i] is None:
                gens.pop(i)
            return (op, Mix(tuple(gens)) if gens else None)
        return None


def mix(gens) -> Generator:
    return Mix(tuple(gens))


@dataclass(frozen=True)
class Limit(Generator):
    """At most n ops (generator.clj:1156-1170)."""

    remaining: int
    gen: Any

    def op(self, test, ctx):
        remaining = self.remaining
        if remaining <= 0:
            return None
        g = as_gen(self.gen)
        if g is None:
            return None
        return self.op_tail(g.op(test, ctx))

    def op_tail(self, res):
        """Limit.op's tail after the inner generator produced ``res`` —
        in the reference, its native lane's bail handoff re-enters here
        with its consumed inner result."""
        if res is None:
            return None
        remaining = self.remaining
        op, g2 = res
        if op is PENDING:
            return (PENDING, _mk_limit(remaining, g2))
        return (op, _mk_limit(remaining - 1, g2) if g2 is not None else None)

    def update(self, test, ctx, event):
        g = as_gen(self.gen)
        if g is None:
            return self
        g2 = g.update(test, ctx, event)
        if g2 is g and g is self.gen:
            # inner generator ignored the event (Fn and friends return
            # self): the copy the old code built here was ==-identical,
            # so returning self is observationally the same value
            return self
        return Limit(self.remaining, g2)


def _mk_limit(remaining, gen) -> "Limit":
    """Limit built by direct __dict__ store — ==/hash-identical to
    Limit(remaining, gen), without the frozen-dataclass __init__ that
    routes both fields through object.__setattr__ (one Limit is built
    per emitted op, so this is scheduler-hot)."""
    lim = Limit.__new__(Limit)
    d = lim.__dict__
    d["remaining"] = remaining
    d["gen"] = gen
    return lim


def limit(n: int, gen) -> Generator:
    return Limit(n, gen)


def once(gen) -> Generator:
    """Exactly one op (generator.clj:1172-1175)."""
    return Limit(1, gen)


@dataclass(frozen=True)
class Log(Generator):
    """Emits a single :log pseudo-op (generator.clj:1177-1181); handled
    in-worker, excluded from history."""

    msg: str

    def op(self, test, ctx):
        op = fill_in_op({"type": "log", "value": self.msg, "f": None}, ctx)
        if op is PENDING:
            return (PENDING, self)
        return (op, None)


def log(msg: str) -> Generator:
    return Log(msg)


@dataclass(frozen=True)
class Repeat(Generator):
    """Emits the same underlying generator's op forever (or n times),
    never advancing it (generator.clj:1183-1210)."""

    remaining: int  # -1 = infinite
    gen: Any

    def op(self, test, ctx):
        if self.remaining == 0:
            return None
        g = as_gen(self.gen)
        if g is None:
            return None
        res = g.op(test, ctx)
        if res is None:
            return None
        op, _ = res
        if op is PENDING:
            return (PENDING, self)
        nxt = self.remaining - 1 if self.remaining > 0 else -1
        return (op, Repeat(nxt, self.gen) if nxt != 0 else None)

    def update(self, test, ctx, event):
        g = as_gen(self.gen)
        if g is None:
            return self
        return Repeat(self.remaining, g.update(test, ctx, event))


def repeat(*args) -> Generator:
    """repeat(gen) or repeat(n, gen)."""
    if len(args) == 1:
        return Repeat(-1, args[0])
    return Repeat(args[0], args[1])


_FRESH = "__cycle_fresh__"


@dataclass(frozen=True)
class Cycle(Generator):
    """Restarts gen from its original state when exhausted. ``remaining``
    counts cycles left to start; -1 = infinite."""

    remaining: int
    original: Any
    gen: Any = _FRESH

    def op(self, test, ctx):
        remaining, g = self.remaining, self.gen
        for _ in range(2):  # at most one restart per call
            if g is _FRESH:
                if remaining == 0:
                    return None
                if remaining > 0:
                    remaining -= 1
                g = self.original
            gg = as_gen(g)
            res = gg.op(test, ctx) if gg is not None else None
            if res is None:
                g = _FRESH
                continue
            op, g2 = res
            nxt = Cycle(remaining, self.original, g2 if g2 is not None else _FRESH)
            if op is PENDING:
                return (PENDING, nxt)
            return (op, nxt)
        return None

    def update(self, test, ctx, event):
        if self.gen is _FRESH:
            return self
        g = as_gen(self.gen)
        if g is None:
            return self
        return replace(self, gen=g.update(test, ctx, event))


def cycle(gen, times: int = -1) -> Generator:
    return Cycle(times, gen)


@dataclass(frozen=True)
class ProcessLimit(Generator):
    """Stops after n distinct processes have participated
    (generator.clj:1212-1237)."""

    n: int
    gen: Any
    seen: frozenset = frozenset()

    def op(self, test, ctx):
        g = as_gen(self.gen)
        if g is None:
            return None
        res = g.op(test, ctx)
        if res is None:
            return None
        op, g2 = res
        if op is PENDING:
            return (PENDING, replace(self, gen=g2))
        seen = self.seen | {op.get("process")}
        if len(seen) > self.n:
            return None
        return (op, replace(self, gen=g2, seen=seen) if g2 is not None else None)

    def update(self, test, ctx, event):
        g = as_gen(self.gen)
        if g is None:
            return self
        return replace(self, gen=g.update(test, ctx, event))


def process_limit(n: int, gen) -> Generator:
    return ProcessLimit(n, gen)


@dataclass(frozen=True)
class TimeLimit(Generator):
    """Passes ops through for dt seconds from the first op
    (generator.clj:1239-1263)."""

    dt_nanos: int
    gen: Any
    deadline: int | None = None

    def op(self, test, ctx):
        g = as_gen(self.gen)
        if g is None:
            return None
        res = g.op(test, ctx)
        if res is None:
            return None
        op, g2 = res
        if op is PENDING:
            return (PENDING, replace(self, gen=g2))
        deadline = self.deadline
        if deadline is None:
            deadline = op["time"] + self.dt_nanos
        if op["time"] >= deadline:
            return None
        return (op, replace(self, gen=g2, deadline=deadline) if g2 is not None else None)

    def update(self, test, ctx, event):
        g = as_gen(self.gen)
        if g is None:
            return self
        return replace(self, gen=g.update(test, ctx, event))


def time_limit(dt_seconds: float, gen) -> Generator:
    return TimeLimit(secs_to_nanos(dt_seconds), gen)


@dataclass(frozen=True)
class Stagger(Generator):
    """Schedules ops at uniform random intervals averaging dt seconds —
    a *total* rate across all threads, not per-thread
    (generator.clj:1265-1305)."""

    dt_nanos: int
    gen: Any
    next_time: int | None = None

    def op(self, test, ctx):
        g = as_gen(self.gen)
        if g is None:
            return None
        res = g.op(test, ctx)
        if res is None:
            return None
        op, g2 = res
        if op is PENDING:
            return (PENDING, replace(self, gen=g2))
        nt = self.next_time if self.next_time is not None else ctx.time
        op = dict(op)
        op["time"] = max(op["time"], nt)
        nt2 = nt + int(ctx.rng.random() * 2 * self.dt_nanos)
        return (op, replace(self, gen=g2, next_time=nt2) if g2 is not None else None)

    def update(self, test, ctx, event):
        g = as_gen(self.gen)
        if g is None:
            return self
        return replace(self, gen=g.update(test, ctx, event))


def stagger(dt_seconds: float, gen) -> Generator:
    return Stagger(secs_to_nanos(dt_seconds), gen)


@dataclass(frozen=True)
class Delay(Generator):
    """Emits ops no faster than every dt seconds (generator.clj:1344-1370)."""

    dt_nanos: int
    gen: Any
    next_time: int | None = None

    def op(self, test, ctx):
        g = as_gen(self.gen)
        if g is None:
            return None
        res = g.op(test, ctx)
        if res is None:
            return None
        op, g2 = res
        if op is PENDING:
            return (PENDING, replace(self, gen=g2))
        nt = self.next_time if self.next_time is not None else ctx.time
        op = dict(op)
        op["time"] = max(op["time"], nt)
        return (op, replace(self, gen=g2, next_time=op["time"] + self.dt_nanos)
                if g2 is not None else None)

    def update(self, test, ctx, event):
        g = as_gen(self.gen)
        if g is None:
            return self
        return replace(self, gen=g.update(test, ctx, event))


def delay(dt_seconds: float, gen) -> Generator:
    return Delay(secs_to_nanos(dt_seconds), gen)


@dataclass(frozen=True)
class Sleep(Generator):
    """One :sleep pseudo-op; the worker sleeps dt seconds
    (generator.clj:1372-1376)."""

    dt_seconds: float

    def op(self, test, ctx):
        op = fill_in_op({"type": "sleep", "value": self.dt_seconds, "f": None}, ctx)
        if op is PENDING:
            return (PENDING, self)
        return (op, None)


def sleep(dt_seconds: float) -> Generator:
    return Sleep(dt_seconds)


@dataclass(frozen=True)
class Synchronize(Generator):
    """Waits until every thread is free before unleashing gen
    (generator.clj:1378-1397)."""

    gen: Any
    released: bool = False

    def op(self, test, ctx):
        g = as_gen(self.gen)
        if g is None:
            return None
        if not self.released:
            if frozenset(ctx.workers) != ctx.free_threads:
                return (PENDING, self)
        res = g.op(test, ctx)
        if res is None:
            return None
        op, g2 = res
        if op is PENDING:
            return (PENDING, replace(self, released=True, gen=g2))
        return (op, replace(self, released=True, gen=g2) if g2 is not None else None)

    def update(self, test, ctx, event):
        g = as_gen(self.gen)
        if g is None:
            return self
        return replace(self, gen=g.update(test, ctx, event))


def synchronize(gen) -> Generator:
    return Synchronize(gen)


def phases(*gens) -> Generator:
    """Each phase waits for all threads to go idle before starting
    (generator.clj:1399-1409)."""
    return Seq([Synchronize(g) for g in gens])


def then(b, a) -> Generator:
    """a, then (once all threads idle) b (generator.clj:1411-1416)."""
    return Seq([a, Synchronize(b)])


@dataclass(frozen=True)
class UntilOk(Generator):
    """Passes ops through until some op completes :ok
    (generator.clj:1418-1436)."""

    gen: Any
    done: bool = False

    def op(self, test, ctx):
        if self.done:
            return None
        g = as_gen(self.gen)
        if g is None:
            return None
        res = g.op(test, ctx)
        if res is None:
            return None
        op, g2 = res
        if op is PENDING:
            return (PENDING, replace(self, gen=g2))
        return (op, replace(self, gen=g2) if g2 is not None else None)

    def update(self, test, ctx, event):
        if event.get("type") == "ok":
            return replace(self, done=True)
        g = as_gen(self.gen)
        if g is None:
            return self
        return replace(self, gen=g.update(test, ctx, event))


def until_ok(gen) -> Generator:
    return UntilOk(gen)


@dataclass(frozen=True)
class FlipFlop(Generator):
    """Alternates ops between two generators (generator.clj:1438-1452)."""

    a: Any
    b: Any
    which: int = 0

    def op(self, test, ctx):
        gens = [self.a, self.b]
        g = as_gen(gens[self.which])
        if g is None:
            return None
        res = g.op(test, ctx)
        if res is None:
            return None
        op, g2 = res
        if op is PENDING:
            gens[self.which] = g2
            return (PENDING, FlipFlop(gens[0], gens[1], self.which))
        gens[self.which] = g2
        return (op, FlipFlop(gens[0], gens[1], 1 - self.which))

    def update(self, test, ctx, event):
        return self


def flip_flop(a, b) -> Generator:
    return FlipFlop(a, b)


def validate(gen) -> Generator:
    return Validate(gen)


def friendly_exceptions(gen) -> Generator:
    return FriendlyExceptions(gen)


def trace(k: str, gen) -> Generator:
    return Trace(k, gen)


def gen_map(f: Callable, gen) -> Generator:
    return Map(f, gen)


def gen_filter(pred: Callable, gen) -> Generator:
    return Filter(pred, gen)


def on_update(f: Callable, gen) -> Generator:
    return OnUpdate(f, gen)
