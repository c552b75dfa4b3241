"""Pause-to-lose-writes workload (reference:
aerospike/src/aerospike/pause.clj — pause a node holding masterships
while clients keep blind-appending; the paused node traps in-flight
writes in memory, a new master is promoted and takes later writes, and
when the old master resumes it applies its trapped writes with a
far-future local clock, clobbering everything acknowledged since. The
probe is a per-key append set: a lost acknowledged element is the
anomaly).

A state machine shared by the client generator, the nemesis generator,
and the completion stream coordinates the phases (pause.clj:173-208):

- ``healthy``: clients append to the current key block; after
  ``pause-healthy-delay`` seconds the nemesis pauses the master set →
- ``paused``: appends continue (they fail against the paused master
  until an election promotes a peer); the FIRST acknowledged append →
- ``wait``: all client ops stop for ``pause-delay`` seconds (so the
  trapped write's local timestamp lands beyond every acknowledged
  one), then the nemesis resumes the node, fresh masters and a fresh
  key block are chosen, and the loop returns to ``healthy``.

The reference drives this with blocking sleeps inside an old-style
per-thread generator; here the same machine rides the pure-generator
protocol — phase waits are PENDING polls, delays are future-timed ops
the interpreter sleeps toward, and the paused→wait edge fires in
``update`` when an append completion arrives (pause.clj's client-side
``swap!``).

Checker: the per-key set checker under the independent lift
(pause.clj:212-214) — every acknowledged element must be in its key's
final read.

The port of jepsen_tpu/workloads/pause_workload.py.
"""
from __future__ import annotations

import threading

from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import independent
from jepsen_tpu_torch.checker import set_checker
from jepsen_tpu_torch.generator import PENDING, Generator, fill_in_op

# copied from jepsen_tpu/workloads/pause_workload.py:42-199
DEFAULT_HEALTHY_DELAY_S = 5.0   # pause.clj:17-19
DEFAULT_PAUSE_DELAY_S = 30.0    # pause.clj:21-23
MASTERS_LIMIT = 1               # pause.clj:25-27


class MachineState:
    """The shared phase machine (pause.clj:29-38 next-healthy)."""

    def __init__(self, rng=None):
        import random as _random
        self.lock = threading.Lock()
        self.rng = rng or _random.Random()
        self.phase = "init"
        self.masters: list = []
        self.keys: list = []
        self.next_key = 0
        self.next_value = 0
        self.phase_at = 0  # history time (ns) of the last transition

    def next_healthy(self, test, now: int) -> None:
        """Pick new masters and a fresh key block (pause.clj:29-38)."""
        nodes = list(test.get("nodes") or ["n1"])
        self.masters = self.rng.sample(nodes, min(MASTERS_LIMIT, len(nodes)))
        per = max(1, int(test.get("concurrency", 5)) // len(nodes))
        self.keys = list(range(self.next_key, self.next_key + per))
        self.next_key += per
        self.phase = "healthy"
        self.phase_at = now


def _delay_ns(test, key: str, default_s: float) -> int:
    return int(float(test.get(key, default_s)) * 1e9)


class PauseClientGen(Generator):
    """Appends to this phase's key block; PENDING through ``wait``;
    flips paused→wait on the first acknowledged append
    (pause.clj:162-171, 92-97)."""

    def __init__(self, state: MachineState):
        self.state = state

    def op(self, test, ctx):
        s = self.state
        with s.lock:
            if s.phase == "init":
                s.next_healthy(test, ctx.time)
            if s.phase == "wait" or not s.keys:
                return (PENDING, self)
            if s.phase == "healthy" and ctx.time < s.phase_at:
                # the resume op that opened this phase is future-timed;
                # appending before it fires would break the wait window
                return (PENDING, self)
            p = ctx.some_free_process()
            # clients-wrapped in production; guard the nemesis sentinel
            # for bare-context polls
            if p is None or not isinstance(p, int):
                return (PENDING, self)
            k = s.keys[p % len(s.keys)]
            v = s.next_value
            s.next_value += 1
        return ({"type": "invoke", "f": "add", "process": p,
                 "time": ctx.time,
                 "value": independent.tuple_value(k, v)}, self)

    def update(self, test, ctx, event):
        if event.get("type") == "ok" and event.get("f") == "add":
            s = self.state
            with s.lock:
                # only adds acknowledged AFTER the pause actually fired
                # count — the pause op itself is future-timed, and an
                # ack from the pre-pause window must not end the phase
                if s.phase == "paused" \
                        and (event.get("time") or ctx.time) >= s.phase_at:
                    s.phase = "wait"
                    s.phase_at = event.get("time") or ctx.time
        return self


class PauseNemesisGen(Generator):
    """healthy → (after healthy-delay) pause op; paused → PENDING until
    the clients flip to wait; wait → (after pause-delay) resume op with
    a fresh key block (pause.clj:145-160).

    ``op`` is PURE — composing generators (any_gen) poll candidates and
    discard the losers, so a state transition at emission time would
    fire on polls that never dispatch. Transitions ride ``update``,
    which only ever sees dispatched events; phase guards make the
    invocation/completion double-delivery idempotent."""

    def __init__(self, state: MachineState):
        self.state = state

    def op(self, test, ctx):
        s = self.state
        with s.lock:
            if s.phase == "init":
                s.next_healthy(test, ctx.time)
            if s.phase == "healthy":
                t = s.phase_at + _delay_ns(test, "pause-healthy-delay",
                                           DEFAULT_HEALTHY_DELAY_S)
                op = fill_in_op({"type": "info", "f": "pause",
                                 "value": list(s.masters),
                                 "time": max(ctx.time, t)}, ctx)
                return (PENDING, self) if op is PENDING else (op, self)
            if s.phase == "wait":
                t = s.phase_at + _delay_ns(test, "pause-delay",
                                           DEFAULT_PAUSE_DELAY_S)
                op = fill_in_op({"type": "info", "f": "resume",
                                 "value": list(s.masters),
                                 "time": max(ctx.time, t)}, ctx)
                return (PENDING, self) if op is PENDING else (op, self)
            return (PENDING, self)

    def update(self, test, ctx, event):
        s = self.state
        f = event.get("f")
        with s.lock:
            if f == "pause" and s.phase == "healthy":
                s.phase = "paused"
                s.phase_at = event.get("time") or ctx.time
            elif f == "resume" and s.phase == "wait":
                s.next_healthy(test, event.get("time") or ctx.time)
        return self


def final_reads(state: MachineState):
    """One read per key ever used (pause.clj:215-224). A one-shot Fn —
    ``gen.once`` would cap the whole Seq at a single op, and a bare Fn
    would rebuild the Seq forever."""
    done: list = []

    def build(test, ctx):
        if done:
            return None
        done.append(True)
        with state.lock:
            n = state.next_key
        return gen.Seq([{"f": "read",
                         "value": independent.tuple_value(k, None)}
                        for k in range(n)])

    return gen.Fn(build)


def workload(test: dict | None = None, state: MachineState | None = None,
             **_) -> dict:
    """The workload half; the suite pairs it with the pause fault
    package sharing the same MachineState (pause.clj:173-233
    workload+nemesis)."""
    state = state or MachineState()
    return {
        "pause-workload": True,
        "pause_state": state,
        "generator": PauseClientGen(state),
        "final_generator": final_reads(state),
        "checker": independent.checker(set_checker()),
    }
