"""Fault injection (the port of jepsen_tpu/nemesis/__init__.py, after
jepsen/src/jepsen/nemesis.clj).

A Nemesis is a special client for failure modes: setup/invoke/teardown
(nemesis.clj:11-16), plus Reflection (``fs``) so composition can route ops
by :f (:18-21). The *grudge* functions here are pure set math over node
lists (nemesis.clj:108-281) — fully unit-testable without a cluster; the
partitioner applies grudges via the net layer over SSH. Over the dummy
remote every nemesis runs its code paths and acts on nothing. The durable
fault registry's surface is :mod:`jepsen_tpu_torch.nemesis.faults`.
"""
from __future__ import annotations

import logging
import random
from typing import Any, Callable, Iterable

from jepsen_tpu_torch.utils import majority

logger = logging.getLogger("jepsen_tpu_torch.nemesis")

# copied from jepsen_tpu/nemesis/__init__.py:20-512 (whole)


class Nemesis:
    def setup(self, test: dict) -> "Nemesis":
        return self

    def invoke(self, test: dict, op: dict) -> dict:
        raise NotImplementedError

    def teardown(self, test: dict) -> None:
        pass

    def fs(self) -> set:
        """The set of :f values this nemesis handles (Reflection,
        nemesis.clj:18-21)."""
        return set()

    def self_recorded_kinds(self) -> set:
        """Fault kinds (faults.KINDS) this nemesis books into the
        durable registry ITSELF — richer records than the interpreter's
        generic pre-fire snapshot (e.g. the membership nemesis records
        the pre-op member set and marks entries healed at resolution).
        The interpreter's NemesisWorker skips its own record/heal-mark
        for these kinds so every fault lands exactly once."""
        return set()


def self_recorded_kinds(nemesis) -> set:
    """``nemesis.self_recorded_kinds()`` with tolerance for bare duck-
    typed nemeses (tests wire plain objects) — absent or broken means
    "none": the generic registry path stays on."""
    fn = getattr(nemesis, "self_recorded_kinds", None)
    if not callable(fn):
        return set()
    try:
        return set(fn() or ())
    except Exception:  # noqa: BLE001 — reflection must never block an op
        logger.exception("self_recorded_kinds() raised; assuming none")
        return set()


class Noop(Nemesis):
    """Does nothing (jepsen.nemesis/noop)."""

    def invoke(self, test, op):
        return {**op, "type": "info"}


class ValidateNemesis(Nemesis):
    """Checks op shapes around an inner nemesis (nemesis.clj:49-90)."""

    def __init__(self, nemesis: Nemesis):
        self.nemesis = nemesis

    def setup(self, test):
        inner = self.nemesis.setup(test)
        if inner is None:
            raise ValueError(f"{self.nemesis!r}.setup returned None")
        return ValidateNemesis(inner)

    def invoke(self, test, op):
        if op.get("type") != "invoke" and op.get("type") != "info":
            raise ValueError(f"nemesis op has type {op.get('type')!r}")
        completion = self.nemesis.invoke(test, op)
        if not isinstance(completion, dict):
            raise ValueError(f"nemesis completion {completion!r} is not an op")
        return completion

    def teardown(self, test):
        self.nemesis.teardown(test)

    def fs(self):
        return self.nemesis.fs()

    def self_recorded_kinds(self):
        return self_recorded_kinds(self.nemesis)


def validate(nemesis: Nemesis) -> Nemesis:
    return ValidateNemesis(nemesis)


class Timeout(Nemesis):
    """Gives up on ops that take longer than dt seconds
    (nemesis.clj:92-106)."""

    def __init__(self, dt_seconds: float, nemesis: Nemesis):
        self.dt = dt_seconds
        self.nemesis = nemesis

    def setup(self, test):
        return Timeout(self.dt, self.nemesis.setup(test))

    def invoke(self, test, op):
        from jepsen_tpu_torch.utils import timeout as timeout_fn
        res = timeout_fn(self.dt * 1000, None, lambda: self.nemesis.invoke(test, op))
        if res is None:
            return {**op, "type": "info", "value": "timeout"}
        return res

    def teardown(self, test):
        self.nemesis.teardown(test)

    def fs(self):
        return self.nemesis.fs()

    def self_recorded_kinds(self):
        return self_recorded_kinds(self.nemesis)


# ---------------------------------------------------------------------------
# Grudge math: pure functions from node lists to partition maps
# (a *grudge* maps each node -> collection of nodes it should snub)
# ---------------------------------------------------------------------------

def bisect(coll: list) -> tuple[list, list]:
    """Splits a collection in half; first half smaller (nemesis.clj:108-112)."""
    coll = list(coll)
    mid = len(coll) // 2
    return coll[:mid], coll[mid:]


def split_one(coll: list, rng: random.Random | None = None) -> tuple[list, list]:
    """Splits off one random node: ([n], rest) (nemesis.clj:114-118)."""
    coll = list(coll)
    r = rng or random
    i = r.randrange(len(coll))
    return [coll[i]], coll[:i] + coll[i + 1:]


def complete_grudge(components: Iterable[list]) -> dict:
    """Given components, every node snubs every node outside its component
    (nemesis.clj:120-132)."""
    components = [list(c) for c in components]
    all_nodes = [n for c in components for n in c]
    grudge = {}
    for c in components:
        others = [n for n in all_nodes if n not in c]
        for n in c:
            grudge[n] = set(others)
    return grudge


def invert_grudge(grudge: dict) -> dict:
    """Takes a grudge of what to cut, returns what to *keep* cut if you
    invert connectivity (nemesis.clj:134-142)."""
    nodes = set(grudge)
    return {n: nodes - set(snubbed) - {n} for n, snubbed in grudge.items()}


def bridge(nodes: list) -> dict:
    """Two halves connected only through a single bridge node
    (nemesis.clj:144-155)."""
    nodes = list(nodes)
    mid = len(nodes) // 2
    bridge_node = nodes[mid]
    halves = (nodes[:mid], nodes[mid + 1:])
    grudge = {}
    for i, half in enumerate(halves):
        other = halves[1 - i]
        for n in half:
            grudge[n] = set(other)
    grudge[bridge_node] = set()
    return grudge


def majorities_ring_perfect(nodes: list) -> dict:
    """Every node sees a majority, but no node sees the *same* majority:
    node i sees the (majority-sized) window centered on i in a ring
    (nemesis.clj:202-216)."""
    nodes = list(nodes)
    n = len(nodes)
    m = majority(n)
    half = (m - 1) // 2
    grudge = {}
    for i, node in enumerate(nodes):
        visible = {nodes[(i + d) % n] for d in range(-half, half + 1)}
        # if majority is even-sized, extend forward
        d = half + 1
        while len(visible) < m:
            visible.add(nodes[(i + d) % n])
            d += 1
        grudge[node] = set(nodes) - visible
    return grudge


def majorities_ring_stochastic(nodes: list, rng: random.Random | None = None) -> dict:
    """Random variant: each node sees a random majority including itself
    (nemesis.clj:218-258). Unlike the perfect ring this may isolate some
    links asymmetrically; grudges are symmetrized by union."""
    nodes = list(nodes)
    r = rng or random
    n = len(nodes)
    m = majority(n)
    visible: dict[Any, set] = {}
    for node in nodes:
        others = [x for x in nodes if x != node]
        r.shuffle(others)
        visible[node] = {node} | set(others[: m - 1])
    grudge = {node: set(nodes) - visible[node] for node in nodes}
    # symmetrize: if a snubs b, b snubs a
    for a in nodes:
        for b in grudge[a]:
            grudge[b].add(a)
    return grudge


def partition_halves_grudge(nodes: list) -> dict:
    return complete_grudge(bisect(nodes))


def partition_random_halves_grudge(nodes: list, rng=None) -> dict:
    nodes = list(nodes)
    (rng or random).shuffle(nodes)
    return complete_grudge(bisect(nodes))


def partition_random_node_grudge(nodes: list, rng=None) -> dict:
    return complete_grudge(split_one(nodes, rng))


# ---------------------------------------------------------------------------
# Partitioner nemesis (applies grudges via the net layer)
# ---------------------------------------------------------------------------

class Partitioner(Nemesis):
    """start-partition / stop-partition via a grudge function
    (nemesis.clj:157-183). grudge_fn(test, nodes, op_value) -> grudge."""

    def __init__(self, grudge_fn: Callable | None = None):
        self.grudge_fn = grudge_fn

    def setup(self, test):
        net = test.get("net")
        if net is not None:
            net.heal(test)
        return self

    def fs(self):
        return {"start-partition", "stop-partition", "start", "stop"}

    def _grudge(self, test, op):
        v = op.get("value")
        if isinstance(v, dict):
            return v  # explicit grudge
        nodes = list(test.get("nodes") or [])
        if self.grudge_fn is not None:
            return self.grudge_fn(test, nodes, v)
        if v == "majority":
            return partition_random_halves_grudge(nodes)
        if v == "one":
            return partition_random_node_grudge(nodes)
        if v == "majorities-ring":
            return majorities_ring_perfect(nodes)
        return partition_halves_grudge(nodes)

    def invoke(self, test, op):
        f = op.get("f")
        net = test.get("net")
        if f in ("start", "start-partition"):
            grudge = self._grudge(test, op)
            if net is not None:
                net.drop_all(test, grudge)
            return {**op, "type": "info",
                    "value": ["isolated", {k: sorted(v) for k, v in grudge.items()}]}
        if f in ("stop", "stop-partition"):
            if net is not None:
                net.heal(test)
            return {**op, "type": "info", "value": "network-healed"}
        return {**op, "type": "info", "value": ["unknown-f", f]}

    def teardown(self, test):
        net = test.get("net")
        if net is not None:
            net.heal(test)


def partitioner(grudge_fn=None) -> Nemesis:
    return Partitioner(grudge_fn)


def partition_halves() -> Nemesis:
    return Partitioner(lambda test, nodes, v: partition_halves_grudge(nodes))


def partition_random_halves() -> Nemesis:
    return Partitioner(lambda test, nodes, v: partition_random_halves_grudge(nodes))


def partition_random_node() -> Nemesis:
    return Partitioner(lambda test, nodes, v: partition_random_node_grudge(nodes))


def partition_majorities_ring() -> Nemesis:
    return Partitioner(lambda test, nodes, v: majorities_ring_perfect(nodes))


# ---------------------------------------------------------------------------
# Composition (nemesis.clj:285-428)
# ---------------------------------------------------------------------------

class FMap(Nemesis):
    """Rewrites op :f values through a mapping before the inner nemesis sees
    them (nemesis.clj:285-327)."""

    def __init__(self, f_mapping: dict, nemesis: Nemesis):
        self.f_mapping = f_mapping
        self.inverse = {v: k for k, v in f_mapping.items()}
        self.nemesis = nemesis

    def setup(self, test):
        return FMap(self.f_mapping, self.nemesis.setup(test))

    def invoke(self, test, op):
        f = op.get("f")
        inner_f = self.inverse.get(f, f)
        completion = self.nemesis.invoke(test, {**op, "f": inner_f})
        return {**completion, "f": f}

    def teardown(self, test):
        self.nemesis.teardown(test)

    def fs(self):
        return {self.f_mapping.get(f, f) for f in self.nemesis.fs()}

    def self_recorded_kinds(self):
        # kinds are classify() groups, not :f names — no renaming
        return self_recorded_kinds(self.nemesis)


def f_map(f_mapping: dict, nemesis: Nemesis) -> Nemesis:
    return FMap(f_mapping, nemesis)


class Compose(Nemesis):
    """Routes ops to the sub-nemesis whose fs() claims the op's :f
    (Reflection-based compose, nemesis.clj:329-428)."""

    def __init__(self, nemeses: list[Nemesis]):
        self.nemeses = list(nemeses)

    def setup(self, test):
        return Compose([n.setup(test) for n in self.nemeses])

    def _route(self, f):
        for n in self.nemeses:
            if f in n.fs():
                return n
        return None

    def invoke(self, test, op):
        n = self._route(op.get("f"))
        if n is None:
            raise ValueError(
                f"no nemesis handles f={op.get('f')!r} "
                f"(available: {[sorted(map(str, x.fs())) for x in self.nemeses]})"
            )
        return n.invoke(test, op)

    def teardown(self, test):
        for n in self.nemeses:
            n.teardown(test)

    def fs(self):
        out = set()
        for n in self.nemeses:
            out |= n.fs()
        return out

    def self_recorded_kinds(self):
        out = set()
        for n in self.nemeses:
            out |= self_recorded_kinds(n)
        return out


def compose(nemeses: Iterable[Nemesis]) -> Nemesis:
    return Compose(list(nemeses))


class NodeStartStopper(Nemesis):
    """Runs start/stop functions on targeted nodes (node-start-stopper,
    nemesis.clj:452-495). targeter(test, nodes) -> nodes to affect."""

    def __init__(self, targeter: Callable, start_fn: Callable, stop_fn: Callable,
                 start_f: str = "start", stop_f: str = "stop"):
        self.targeter = targeter
        self.start_fn = start_fn
        self.stop_fn = stop_fn
        self.start_f = start_f
        self.stop_f = stop_f
        self.affected: list = []

    def fs(self):
        return {self.start_f, self.stop_f}

    def invoke(self, test, op):
        from jepsen_tpu_torch.utils import real_pmap
        f = op.get("f")
        if f == self.start_f:
            targets = list(self.targeter(test, list(test.get("nodes") or [])))
            real_pmap(lambda n: self.start_fn(test, n), targets)
            self.affected = targets
            return {**op, "type": "info", "value": [f, targets]}
        if f == self.stop_f:
            targets = self.affected or list(test.get("nodes") or [])
            real_pmap(lambda n: self.stop_fn(test, n), targets)
            self.affected = []
            return {**op, "type": "info", "value": [f, targets]}
        return {**op, "type": "info", "value": ["unknown-f", f]}


def hammer_time(targeter=None, process: str = "") -> Nemesis:
    """SIGSTOP/SIGCONT a process on targeted nodes (nemesis.clj:497-511)."""
    from jepsen_tpu_torch import control

    targeter = targeter or (lambda test, nodes: [random.choice(nodes)])

    def start(test, node):
        control.on(node, test, lambda: control.exec_("killall", "-s", "STOP", process))

    def stop(test, node):
        control.on(node, test, lambda: control.exec_("killall", "-s", "CONT", process))

    return NodeStartStopper(targeter, start, stop, "start-pause", "stop-pause")


def set_time(test, node, unix_seconds: float) -> None:
    """Sets the wall clock on a node via ``date`` (nemesis.clj:430-433
    set-time!) — the coarse sibling of the compiled bump-time utility
    (nemesis/time.py)."""
    from jepsen_tpu_torch import control
    control.on(node, test,
               lambda: control.exec_("date", "-s", f"@{int(unix_seconds)}"))


class ClockScrambler(Nemesis):
    """Randomizes node clocks within ±limit seconds of now
    (nemesis.clj:435-450); teardown restores approximately-correct
    time. The C-utility ClockNemesis (nemesis/time.py) is the precise
    replacement; this is the reference's original coarse scrambler."""

    def __init__(self, limit_s: int):
        self.limit_s = limit_s

    def fs(self):
        return {"scramble-clock"}

    def invoke(self, test, op):
        import time as _time
        from jepsen_tpu_torch.utils import real_pmap
        nodes = op.get("value") or list(test.get("nodes") or [])

        def scramble(node):
            offset = random.randint(-self.limit_s, self.limit_s)
            set_time(test, node, _time.time() + offset)
            return offset
        offsets = real_pmap(scramble, nodes)
        return {**op, "type": "info",
                "value": dict(zip(nodes, offsets))}

    def teardown(self, test):
        import time as _time
        from jepsen_tpu_torch.utils import real_pmap
        real_pmap(lambda n: set_time(test, n, _time.time()),
                  list(test.get("nodes") or []))


def clock_scrambler(limit_s: int) -> Nemesis:
    return ClockScrambler(limit_s)


class TruncateFile(Nemesis):
    """Truncates a file on targeted nodes by a random number of bytes
    (nemesis.clj:513-539)."""

    def __init__(self, path: str, max_bytes: int = 1024):
        self.path = path
        self.max_bytes = max_bytes

    def fs(self):
        return {"truncate-file"}

    def invoke(self, test, op):
        from jepsen_tpu_torch import control
        from jepsen_tpu_torch.utils import real_pmap
        nodes = op.get("value") or list(test.get("nodes") or [])
        n_bytes = random.randrange(1, self.max_bytes)

        def trunc(node):
            control.on(node, test,
                       lambda: control.exec_("truncate", "-c", "-s",
                                             f"-{n_bytes}", self.path))
        real_pmap(trunc, nodes)
        return {**op, "type": "info", "value": ["truncated", self.path, n_bytes, nodes]}
