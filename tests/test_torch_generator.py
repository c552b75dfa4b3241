"""The port's generator and simulated scheduler against the JAX package's:
the same spec, built from each package's combinators, simulated from the
same seed, gives the same ops, op for op (type, f, value, process, time).

The table covers every combinator a suite's ``compose_test`` uses
(clients, nemesis_gen, any_gen, time_limit, phases), the register
workload (Fn, mix, limit, process_limit, the key-lifting concurrent
generator), the kill/pause and partition nemesis packages (stagger,
cycle, Seq, mix, any_gen through compose_packages, f_map), and
``independent.sequential_generator``. The JAX side's ``simulate`` may
take its C scheduler lane, which that package holds to its Python loop.
"""
from __future__ import annotations

import itertools

import pytest

import jepsen_tpu.fakes as jfakes
import jepsen_tpu.generator as jgen
import jepsen_tpu.generator.simulate as jsim
import jepsen_tpu.independent as jind
import jepsen_tpu.nemesis.combined as jcomb
import jepsen_tpu.workloads.register as jreg
import jepsen_tpu_torch.fakes as tfakes
import jepsen_tpu_torch.generator as tgen
import jepsen_tpu_torch.generator.simulate as tsim
import jepsen_tpu_torch.independent as tind
import jepsen_tpu_torch.nemesis.combined as tcomb
import jepsen_tpu_torch.workloads.register as treg

JAX = {"gen": jgen, "sim": jsim, "ind": jind, "comb": jcomb,
       "reg": jreg, "fakes": jfakes}
PORT = {"gen": tgen, "sim": tsim, "ind": tind, "comb": tcomb,
        "reg": treg, "fakes": tfakes}

FIELDS = ("type", "f", "value", "process", "time")


def _w(test, ctx):
    return {"f": "write", "value": ctx.rng.randint(0, 4)}


def _r(test, ctx):
    return {"f": "read", "value": None}


def _cas(test, ctx):
    return {"f": "cas", "value": [ctx.rng.randint(0, 4),
                                  ctx.rng.randint(0, 4)]}


def _rwc(g):
    return g.mix([g.Fn(_r), g.Fn(_w), g.Fn(_cas)])


def _package(m, faults, interval=0.2):
    return m["comb"].nemesis_package({"db": m["fakes"].KVStore(),
                                      "faults": set(faults),
                                      "interval": interval})


def _nemesis_run(m, pkg, seconds=2.0):
    g = m["gen"]
    return g.phases(g.time_limit(seconds, g.nemesis_gen(pkg["generator"])),
                    g.nemesis_gen(pkg["final_generator"]))


def _compose_test(m, seconds=1.0):
    """compose_test's generator (jepsen_tpu/suites/__init__.py:22-64)
    around the register workload and the three nemesis packages."""
    g = m["gen"]
    wl = m["reg"].workload({"concurrency": 5}, accelerator="cpu")
    pkg = _package(m, {"partition", "kill", "pause"}, interval=0.1)
    main = g.time_limit(seconds, g.any_gen(
        g.clients(wl["generator"]), g.nemesis_gen(pkg["generator"])))
    return g.phases(main, g.nemesis_gen(pkg["final_generator"]))


SPECS = {
    "clients-limit-fn": lambda m: m["gen"].clients(
        m["gen"].limit(30, m["gen"].Fn(_w))),
    "mix": lambda m: m["gen"].clients(m["gen"].limit(60, _rwc(m["gen"]))),
    "process-limit": lambda m: m["gen"].clients(m["gen"].process_limit(
        4, m["gen"].limit(60, _rwc(m["gen"])))),
    "stagger": lambda m: m["gen"].clients(m["gen"].limit(
        25, m["gen"].stagger(0.05, m["gen"].repeat({"f": "read"})))),
    "time-limit": lambda m: m["gen"].time_limit(0.5, m["gen"].clients(
        m["gen"].stagger(0.01, m["gen"].Fn(_w)))),
    "any-gen-nemesis-gen": lambda m: m["gen"].time_limit(1.0, m["gen"].any_gen(
        m["gen"].clients(m["gen"].stagger(0.02, _rwc(m["gen"]))),
        m["gen"].nemesis_gen(m["gen"].stagger(0.2, m["gen"].cycle(
            m["gen"].Seq([{"type": "info", "f": "start"},
                          {"type": "info", "f": "stop"}])))))),
    "phases": lambda m: m["gen"].phases(
        m["gen"].clients(m["gen"].limit(12, _rwc(m["gen"]))),
        m["gen"].nemesis_gen(m["gen"].Seq([{"type": "info",
                                             "f": "start-partition"}])),
        m["gen"].clients(m["gen"].limit(6, m["gen"].repeat({"f": "read"})))),
    "f-map": lambda m: m["gen"].clients(m["gen"].f_map(
        {"read": "get"}, m["gen"].limit(20, _rwc(m["gen"])))),
    "partition-package": lambda m: _nemesis_run(m, _package(m, {"partition"})),
    "kill-pause-package": lambda m: _nemesis_run(
        m, _package(m, {"kill", "pause"})),
    "three-packages": lambda m: _nemesis_run(
        m, _package(m, {"partition", "kill", "pause"})),
    "f-map-package": lambda m: _nemesis_run(m, m["comb"].f_map_package(
        {"start-partition": "split", "stop-partition": "join"},
        m["comb"].partition_package({"faults": {"partition"},
                                     "interval": 0.2}))),
    "register-workload": lambda m: m["gen"].time_limit(
        1.0, m["gen"].clients(m["reg"].workload(
            {"concurrency": 5}, accelerator="cpu")["generator"])),
    "concurrent-generator": lambda m: m["gen"].clients(m["gen"].limit(
        80, m["ind"].concurrent_generator(
            2, itertools.count(),
            lambda k: m["gen"].limit(5, _rwc(m["gen"]))))),
    "sequential-generator": lambda m: m["gen"].clients(
        m["ind"].sequential_generator(
            range(4), lambda k: m["gen"].limit(6, _rwc(m["gen"])))),
    "compose-test": _compose_test,
}

SIMULATORS = ("perfect", "quick", "perfect_info")
# scheduler steps a simulation may take: zero-latency completions never
# advance a time limit's clock, so ``quick`` ends at this cap there
STEPS = 3000


def _simulate(m, spec, simulator, concurrency, seed):
    test = {"concurrency": concurrency}
    ctx = m["sim"].default_context(test, seed=seed)
    return getattr(m["sim"], simulator)(test, SPECS[spec](m), ctx,
                                        limit=STEPS)


def _rows(history):
    return [tuple(op.get(k) for k in FIELDS) for op in history]


@pytest.mark.parametrize("simulator", SIMULATORS)
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_simulated_ops_equal_reference(spec, simulator):
    # the register workload's key groups take 5 threads each
    for concurrency, seed in ((5, 0), (10, 11)):
        want = _simulate(JAX, spec, simulator, concurrency, seed)
        got = _simulate(PORT, spec, simulator, concurrency, seed)
        assert want, (spec, simulator)
        assert _rows(got) == _rows(want), (spec, simulator, concurrency)


def test_table_reaches_every_kind_of_op():
    """The table's histories hold client and nemesis ops, invocations and
    completions, a crash's renumbered process and lifted values."""
    seen = set()
    for spec in SPECS:
        for op in _simulate(PORT, spec, "perfect_info", 5, 0):
            seen.add((op["process"] == "nemesis", op["type"]))
            if isinstance(op.get("value"), list) and op.get("f") == "read":
                seen.add("lifted")
            if isinstance(op["process"], int) and op["process"] >= 5:
                seen.add("renumbered")
    assert {(True, "info"), (False, "invoke"), (False, "info"),
            "lifted", "renumbered"} <= seen, seen


# (spec, StepClock step in seconds, max_wall_s, step limit): a wall cap
# that a virtual clock turns into a step count, one it never reaches,
# and the step limit alone
CAPS = [("mix", 1e-6, 4e-5, STEPS), ("compose-test", 1e-3, 0.25, STEPS),
        ("three-packages", 1e-6, 1.0, STEPS), ("register-workload", None,
                                                None, 57),
        ("stagger", 1e-6, None, 9)]


@pytest.mark.parametrize("spec,step_s,max_wall_s,limit", CAPS)
@pytest.mark.parametrize("simulator", ("perfect", "quick"))
def test_capped_simulation_equals_reference(spec, step_s, max_wall_s, limit,
                                            simulator):
    """``simulate``'s caps against the JAX package's: a ``StepClock``
    feeding ``max_wall_s`` truncates both at the same op, and ``stats``
    says alike how each ended (steps, step or wall limited)."""
    out = {}
    for side, m in (("port", PORT), ("jax", JAX)):
        test = {"concurrency": 5}
        stats = {}
        caps = {"limit": limit, "stats": stats, "max_wall_s": max_wall_s}
        if step_s is not None:
            caps["clock"] = m["sim"].StepClock(step_s)
        h = getattr(m["sim"], simulator)(
            test, SPECS[spec](m), m["sim"].default_context(test, seed=3),
            **caps)
        out[side] = (_rows(h), stats,
                     caps["clock"].reads if step_s is not None else None)
    assert out["port"] == out["jax"]
    stats = out["port"][1]
    assert stats["wall_limited"] is (max_wall_s is not None and
                                     max_wall_s < 1.0)
    assert stats["step_limited"] is (limit < STEPS)
