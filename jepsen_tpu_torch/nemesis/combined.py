"""Composable nemesis packages (the port of jepsen_tpu/nemesis/combined.py;
reference: jepsen/src/jepsen/nemesis/combined.clj).

A *package* bundles a nemesis with the generators that drive it:

    {"nemesis": Nemesis, "generator": gen, "final_generator": gen | None,
     "perf": {"name", "start", "stop", "fs"}}

``nemesis_package(opts)`` assembles kill/pause/partition/clock packages
from ``opts["faults"]`` and composes them into one (combined.clj:328-374).
The port has the kill, pause and partition packages; a clock, membership
or clock-rate fault raises ``NotImplementedError`` (their packages wait
with ``nemesis/time.py`` and ``membership.py``, ROADMAP Queue 1 item 11).
Node targeting uses the db-nodes spec DSL (combined.clj:38-61): None/
"one"/"minority"/"majority"/"minority-third"/"primaries"/"all".
"""
from __future__ import annotations

import random

from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import nemesis as nem
from jepsen_tpu_torch.db import Pause, Primary, Process
from jepsen_tpu_torch.utils import majority, minority_third, real_pmap

# copied from jepsen_tpu/nemesis/combined.py:24-228, :382-491, without the
# clock, membership and clock-rate packages and their reconfiguration
# combos
DEFAULT_INTERVAL = 10.0  # seconds between faults (combined.clj:27-29)


# ---------------------------------------------------------------------------
# node specs (combined.clj:38-61)
# ---------------------------------------------------------------------------

def db_nodes(test: dict, db, node_spec, rng: random.Random | None = None) -> list:
    """Nodes targeted by a spec: None (random choice among specs), "one",
    "minority", "majority", "minority-third", "primaries", "all"."""
    rng = rng or random
    nodes = list(test.get("nodes") or [])
    if node_spec is None:
        specs = ["one", "minority-third", "majority", "all"]
        if isinstance(db, Primary):
            specs.append("primaries")
        node_spec = rng.choice(specs)
    if node_spec == "one":
        return [rng.choice(nodes)]
    if node_spec == "minority":
        n = max(1, (len(nodes) - 1) // 2)
        return rng.sample(nodes, n)
    if node_spec == "majority":
        return rng.sample(nodes, majority(len(nodes)))
    if node_spec == "minority-third":
        return rng.sample(nodes, max(1, minority_third(len(nodes))))
    if node_spec == "primaries":
        return list(db.primaries(test)) if isinstance(db, Primary) else []
    if node_spec == "all":
        return nodes
    if isinstance(node_spec, (list, tuple)):
        return list(node_spec)
    raise ValueError(f"unknown node spec {node_spec!r}")


# ---------------------------------------------------------------------------
# db package: kill / pause via the DB's Process/Pause protocols
# (combined.clj:70-160)
# ---------------------------------------------------------------------------

class DBNemesis(nem.Nemesis):
    """start/kill and pause/resume DB processes on targeted nodes."""

    def __init__(self, db):
        self.db = db

    def fs(self):
        out = set()
        if isinstance(self.db, Process):
            out |= {"start", "kill"}
        if isinstance(self.db, Pause):
            out |= {"pause", "resume"}
        return out

    def invoke(self, test, op):
        from jepsen_tpu_torch import control
        f = op.get("f")
        spec = op.get("value")
        if f in ("start", "resume"):
            targets = list(test.get("nodes") or [])
        else:
            targets = db_nodes(test, self.db, spec)
        method = {"start": "start", "kill": "kill",
                  "pause": "pause", "resume": "resume"}[f]

        def one(node):
            return node, control.on(
                node, test, lambda: getattr(self.db, method)(test, node))

        res = dict(real_pmap(one, targets))
        return {**op, "type": "info", "value": {f: res}}


def db_package(opts: dict) -> dict | None:
    """Kill/pause package when those faults are requested
    (combined.clj:141-160)."""
    faults = set(opts.get("faults") or [])
    db = opts.get("db")
    if db is None:
        return None
    interval = opts.get("interval", DEFAULT_INTERVAL)
    wants_kill = "kill" in faults and isinstance(db, Process)
    wants_pause = "pause" in faults and isinstance(db, Pause)
    if not (wants_kill or wants_pause):
        return None

    streams = []
    fs = set()
    if wants_kill:
        fs |= {"start", "kill"}
        streams.append(gen.Seq([{"type": "info", "f": "kill", "value": None},
                                {"type": "info", "f": "start", "value": None}]))
    if wants_pause:
        fs |= {"pause", "resume"}
        streams.append(gen.Seq([{"type": "info", "f": "pause", "value": None},
                                {"type": "info", "f": "resume", "value": None}]))
    g = gen.stagger(interval, gen.mix([gen.cycle(s) for s in streams]))
    final = gen.Seq([{"type": "info", "f": "start", "value": None}]
                    if wants_kill else []) if wants_kill else None
    return {
        "nemesis": DBNemesis(db),
        "generator": g,
        "final_generator": final,
        "perf": {"name": "kill/pause", "fs": fs,
                 "start": {"kill", "pause"}, "stop": {"start", "resume"}},
    }


# ---------------------------------------------------------------------------
# partition package (combined.clj:162-246)
# ---------------------------------------------------------------------------

def grudge_for(test: dict, db, part_spec, rng: random.Random | None = None) -> dict:
    """A grudge map for a partition spec (combined.clj:162-188): None,
    "one", "majority", "majorities-ring", "primaries", "minority-third"."""
    rng = rng or random
    nodes = list(test.get("nodes") or [])
    if part_spec is None:
        specs = ["one", "majority", "majorities-ring", "minority-third"]
        if isinstance(db, Primary):
            specs.append("primaries")
        part_spec = rng.choice(specs)
    if part_spec == "one":
        iso = [rng.choice(nodes)]
        rest = [n for n in nodes if n not in iso]
        return nem.complete_grudge([iso, rest])
    if part_spec == "majority":
        shuffled = rng.sample(nodes, len(nodes))
        m = majority(len(nodes))
        return nem.complete_grudge([shuffled[:m], shuffled[m:]])
    if part_spec == "minority-third":
        shuffled = rng.sample(nodes, len(nodes))
        m = max(1, minority_third(len(nodes)))
        return nem.complete_grudge([shuffled[:m], shuffled[m:]])
    if part_spec == "majorities-ring":
        return nem.majorities_ring_stochastic(nodes, rng=random.Random(rng.random()))
    if part_spec == "primaries":
        prim = list(db.primaries(test)) if isinstance(db, Primary) else []
        if not prim:
            return {}
        iso = [rng.choice(prim)]
        rest = [n for n in nodes if n not in iso]
        return nem.complete_grudge([iso, rest])
    raise ValueError(f"unknown partition spec {part_spec!r}")


class PartitionNemesis(nem.Nemesis):
    """start-partition/stop-partition over the test's Net
    (combined.clj:196-224)."""

    def __init__(self, db):
        self.db = db

    def fs(self):
        return {"start-partition", "stop-partition"}

    def setup(self, test):
        net = test.get("net")
        if net is not None:
            net.heal(test)
        return self

    def invoke(self, test, op):
        f = op.get("f")
        net = test.get("net")
        if f == "start-partition":
            grudge = grudge_for(test, self.db, op.get("value"))
            if net is not None:
                net.drop_all(test, grudge)
            return {**op, "type": "info", "value": ["isolated", grudge]}
        if f == "stop-partition":
            if net is not None:
                net.heal(test)
            return {**op, "type": "info", "value": ["network-healed"]}
        return {**op, "type": "info", "value": ["unknown-f", f]}

    def teardown(self, test):
        net = test.get("net")
        if net is not None:
            net.heal(test)


def partition_package(opts: dict) -> dict | None:
    """(combined.clj:226-246)"""
    if "partition" not in set(opts.get("faults") or []):
        return None
    interval = opts.get("interval", DEFAULT_INTERVAL)
    g = gen.stagger(interval, gen.cycle(gen.Seq([
        {"type": "info", "f": "start-partition", "value": None},
        {"type": "info", "f": "stop-partition", "value": None},
    ])))
    return {
        "nemesis": PartitionNemesis(opts.get("db")),
        "generator": g,
        "final_generator": gen.Seq([
            {"type": "info", "f": "stop-partition", "value": None}]),
        "perf": {"name": "partition", "fs": {"start-partition", "stop-partition"},
                 "start": {"start-partition"}, "stop": {"stop-partition"}},
    }


# ---------------------------------------------------------------------------
# composition (combined.clj:283-374)
# ---------------------------------------------------------------------------

def f_map_package(f_mapping: dict, pkg: dict) -> dict:
    """Lifts a package's fs through a renaming map (combined.clj:283-303)."""
    inv = {v: k for k, v in f_mapping.items()}
    return {
        **pkg,
        "nemesis": nem.f_map(f_mapping, pkg["nemesis"]),
        "generator": gen.f_map(f_mapping, pkg["generator"]),
        "final_generator": (gen.f_map(f_mapping, pkg["final_generator"])
                            if pkg.get("final_generator") is not None else None),
        "perf": {**pkg.get("perf", {}),
                 "fs": {f_mapping.get(f, f)
                        for f in pkg.get("perf", {}).get("fs", set())},
                 "start": {f_mapping.get(f, f)
                           for f in pkg.get("perf", {}).get("start", set())},
                 "stop": {f_mapping.get(f, f)
                          for f in pkg.get("perf", {}).get("stop", set())}},
    }


def compose_packages(packages: list[dict]) -> dict:
    """(combined.clj:305-316)"""
    packages = [p for p in packages if p]
    finals = [p["final_generator"] for p in packages
              if p.get("final_generator") is not None]
    return {
        "nemesis": nem.compose([p["nemesis"] for p in packages]),
        "generator": gen.any_gen(*[p["generator"] for p in packages])
        if len(packages) > 1 else (packages[0]["generator"] if packages else None),
        "final_generator": (gen.Seq(finals) if finals else None),
        "perf": [p.get("perf") for p in packages],
    }


# faults whose packages are not ported yet
WAITING_FAULTS = ("clock", "membership", "clock-rate",
                  "partition-during-reconfig", "clock-rate-during-reconfig")


def nemesis_package(opts: dict) -> dict:
    """The top-level entry (combined.clj:328-374). opts keys: db, faults
    (a set of "kill"/"pause"/"partition" plus any name registered in
    ``fault_packages``), interval, extra_packages, fault_packages (name →
    builder(opts), the DB-specific vocabularies). A fault of
    :data:`WAITING_FAULTS` raises ``NotImplementedError``: a fault the user
    named must never silently no-op."""
    faults = set(opts.get("faults") or [])
    waiting = sorted(faults & set(WAITING_FAULTS))
    if waiting:
        raise NotImplementedError(
            f"fault(s) {waiting} are not ported yet: the clock, membership "
            "and clock-rate packages wait with nemesis/time.py and "
            "membership.py (ROADMAP Queue 1 item 11)")
    pkgs = [db_package(opts), partition_package(opts)]
    registry = opts.get("fault_packages") or {}
    for name in sorted(faults & set(registry)):
        pkgs.append(registry[name](opts))
    pkgs += list(opts.get("extra_packages") or [])
    pkgs = [p for p in pkgs if p]
    if not pkgs:
        return {"nemesis": nem.Noop(), "generator": None,
                "final_generator": None, "perf": []}
    return compose_packages(pkgs)
