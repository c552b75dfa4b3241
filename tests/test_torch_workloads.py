"""The port's workload kits and its fake cluster against the JAX
package's, on the CPU, at tolerance zero:

* each kit's generator, from the same seed through both packages'
  ``simulate.quick`` and ``perfect``: the same ops, op for op;
* each kit's checker on the same seeded histories, valid and broken
  (histories driven through the port's fake client with a seeded
  interleaving, or made by ``jepsen_tpu_torch.histories``): the same
  result maps;
* the cases of ``tests/test_workloads.py`` that cover the ported kits;
* ``fakes.KVStore`` and ``KVClient``, op for op, for every dispatch arm;
* ROADMAP Queue 3 items 4 and 5 (a multi-register key settles on the
  dense table; a nemesis op's two-element value is no key), each beside
  the JAX package's behaviour;
* whole fake runs of multi-key-acid through the port's ``core.run``,
  valid and with a stale-read double, whose stored histories the JAX
  package's checker gives the port's verdicts.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import random
import tempfile
from pathlib import Path

import numpy as np
import pytest

import jepsen_tpu.fakes as jfakes
import jepsen_tpu.generator as jgen
import jepsen_tpu.generator.simulate as jsim
import jepsen_tpu.independent as jind
import jepsen_tpu_torch.fakes as tfakes
import jepsen_tpu_torch.generator as tgen
import jepsen_tpu_torch.generator.simulate as tsim
import jepsen_tpu_torch.independent as tind
from jepsen_tpu_torch import histories

ROOT = Path(__file__).resolve().parent.parent
NODES = ["n1", "n2", "n3", "n4", "n5"]
FIELDS = ("type", "f", "value", "process", "time")
STEPS = 3000


JAX = {"gen": jgen, "sim": jsim, "root": "jepsen_tpu"}
PORT = {"gen": tgen, "sim": tsim, "root": "jepsen_tpu_torch"}


def _wl(m, kit):
    return importlib.import_module(f"{m['root']}.workloads.{kit}")


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------

def _limited(n, kit, **kw):
    def spec(m, test):
        return m["gen"].clients(m["gen"].limit(
            n, _wl(m, kit).workload(test, **kw)["generator"]))
    return spec


def _with_final(n, kit, **kw):
    def spec(m, test):
        w = _wl(m, kit).workload(test, **kw)
        g = m["gen"]
        return g.phases(g.clients(g.limit(n, w["generator"])),
                        g.clients(w["final_generator"]))
    return spec


def _cp_lock(fn, **kw):
    def spec(m, test):
        rnd = random.Random
        random.Random = lambda *a: rnd(7)   # cas_long draws from its own rng
        try:
            w = getattr(_wl(m, "cp_lock"), fn)(test, **kw)
        finally:
            random.Random = rnd
        return m["gen"].clients(m["gen"].limit(60, w["generator"]))
    return spec


def _pause(m, test):
    pw = _wl(m, "pause_workload")
    state = pw.MachineState(rng=random.Random(3))
    w = pw.workload(test, state=state)
    g = m["gen"]
    return g.phases(
        g.limit(120, g.any_gen(g.clients(w["generator"]),
                               g.nemesis_gen(pw.PauseNemesisGen(state)))),
        g.clients(w["final_generator"]))


def _elementary(kit, builder, n=60, **kw):
    def spec(m, test):
        gen = getattr(_wl(m, kit), builder)(**kw)
        return m["gen"].clients(m["gen"].limit(n, gen))
    return spec


# kit -> (threads, extra test map, spec(m, test))
GENS = {
    "single_key_acid": (10, {}, _limited(300, "single_key_acid")),
    "multi_key_acid": (10, {}, _limited(300, "multi_key_acid")),
    "set": (3, {}, _with_final(60, "set_workload")),
    "set_full": (3, {}, _with_final(60, "set_workload", full=True)),
    "append": (3, {}, _limited(80, "append")),
    "wr": (3, {}, _limited(80, "wr")),
    "mutex": (3, {}, _limited(40, "mutex")),
    "lock": (3, {}, _cp_lock("lock_workload", flavor="lock")),
    "cp_lock": (3, {}, _cp_lock("lock_workload", flavor="cp-lock")),
    "reentrant_cp_lock": (3, {}, _cp_lock("lock_workload",
                                          flavor="reentrant-cp-lock")),
    "fenced_lock": (3, {}, _cp_lock("lock_workload", flavor="fenced-lock")),
    "reentrant_fenced_lock": (3, {}, _cp_lock(
        "lock_workload", flavor="reentrant-fenced-lock")),
    "semaphore": (3, {}, _cp_lock("semaphore_workload")),
    "ids": (3, {}, _cp_lock("ids_workload")),
    "cas_long": (3, {}, _cp_lock("cas_long_workload")),
    "counter": (3, {}, _limited(60, "counter")),
    "counter_negative": (3, {}, _limited(60, "counter", negative=True)),
    "queue": (3, {}, _with_final(60, "queue_workload")),
    "lost_updates": (10, {}, _limited(200, "lost_updates")),
    "pause": (4, {"pause-healthy-delay": 0.01, "pause-delay": 0.02},
              _pause),
    "bank": (3, {"accounts": [0, 1, 2]}, _elementary("bank", "generator")),
    "transfer": (3, {}, _elementary("transfer", "generator",
                                    accounts=[0, 1, 2])),
    "long_fork": (3, {}, _elementary("long_fork", "generator", n=80,
                                     group_size=3)),
}


def _simulate(m, kit, simulator, seed):
    threads, extra, spec = GENS[kit]
    test = {"concurrency": threads, "nodes": NODES, **extra}
    ctx = m["sim"].default_context(test, seed=seed)
    return getattr(m["sim"], simulator)(test, spec(m, test), ctx,
                                        limit=STEPS)


def _rows(history):
    return [tuple(op.get(k) for k in FIELDS) for op in history]


@pytest.mark.parametrize("simulator", ["quick", "perfect"])
@pytest.mark.parametrize("kit", sorted(GENS))
def test_generator_matches_jax(kit, simulator):
    got = _rows(_simulate(PORT, kit, simulator, seed=11))
    assert got == _rows(_simulate(JAX, kit, simulator, seed=11))
    assert sum(r[0] == "invoke" for r in got) >= 20


# ---------------------------------------------------------------------------
# checkers on seeded histories
# ---------------------------------------------------------------------------

def _drive(invocations, client, test, seed, width=3):
    """A concurrent history of ``invocations`` through a fake client: at
    each step a seeded choice invokes the next op (at most ``width`` in
    flight, one a process), applies an op in flight to the store (its
    linearization point) or completes an applied one. Times are steps of
    1 ms."""
    rng = np.random.default_rng(seed)
    todo, i, flight, h, t = list(invocations), 0, [], [], 0
    while i < len(todo) or flight:
        t += 1
        c = int(rng.integers(3))
        waiting = [x for x in flight if x[1] is None]
        applied = [x for x in flight if x[1] is not None]
        if c == 0 and i < len(todo) and len(flight) < width \
                and todo[i]["process"] not in {x[0]["process"]
                                               for x in flight}:
            inv = {"type": "invoke", "f": todo[i]["f"],
                   "value": todo[i]["value"], "process": todo[i]["process"],
                   "time": t * 1_000_000}
            h.append(inv)
            flight.append([inv, None])
            i += 1
        elif c == 1 and waiting:
            x = waiting[int(rng.integers(len(waiting)))]
            x[1] = client.invoke(test, dict(x[0]))
        elif c == 2 and applied:
            x = applied[int(rng.integers(len(applied)))]
            h.append({**x[1], "time": t * 1_000_000})
            flight.remove(x)
    return h


def _driven(kit, test, client_kw=None, seed=5, width=3):
    """The kit's generator (the port's ``perfect`` simulation's
    invocations) driven through a fresh port fake."""
    invs = [op for op in _simulate(PORT, kit, "perfect", seed)
            if op["type"] == "invoke" and op["process"] != "nemesis"]
    kv = tfakes.KVStore()
    client = tfakes.KVClient(kv, **(client_kw or {})).open(test, "n1")
    client.setup(test)
    return _drive(invs, client, test, seed, width)


def _read_keys_only(h):
    """The ops of the keys that took a final read: the generator's limit
    cuts the last keys' groups before their reads."""
    read = {op["value"][0] for op in h if op["type"] == "ok"
            and op["f"] == "read"}
    return [op for op in h if op["value"][0] in read]


def _ok(h, f):
    return [i for i, op in enumerate(h) if op["type"] == "ok"
            and op["f"] == f]


def _set(h, i, value):
    h = [dict(op) for op in h]
    h[i]["value"] = value
    return h


def _break_lifted_read(h):
    i = [j for j in _ok(h, "read") if h[j]["value"][1] is not None][-1]
    return _set(h, i, [h[i]["value"][0], 9])


def _break_set(h):
    """Every read loses the first acknowledged add."""
    el = h[_ok(h, "add")[0]]["value"]
    return [{**op, "value": [x for x in op["value"] if x != el]}
            if op["type"] == "ok" and op["f"] == "read" else op for op in h]


def _break_append(h):
    i = next(j for j in reversed(_ok(h, "txn")) if any(
        m[0] == "r" and len(m[2]) >= 2 for m in h[j]["value"]))
    mops = [["r", m[1], list(reversed(m[2]))] if m[0] == "r" else m
            for m in h[i]["value"]]
    return _set(h, i, mops)


def _break_wr(h):
    """The last read of a value reads the key's initial None instead."""
    i = next(j for j in reversed(_ok(h, "txn")) if any(
        m[0] == "r" and m[2] is not None for m in h[j]["value"]))
    k = next(m[1] for m in h[i]["value"] if m[0] == "r" and m[2] is not None)
    mops = [["r", k, None] if m[0] == "r" and m[1] == k else m
            for m in h[i]["value"]]
    return _set(h, i, mops)


def _break_mutex(h):
    """The first failed acquire succeeds: the lock is held twice."""
    i = next(j for j, op in enumerate(h) if op["type"] == "fail"
             and op["f"] == "acquire")
    return [{**op, "type": "ok"} if j == i else op for j, op in enumerate(h)]


def _break_counter(h):
    i = _ok(h, "read")[-1]
    return _set(h, i, h[i]["value"] + 1000)


def _break_queue(h):
    i = _ok(h, "dequeue")[0]
    return _set(h, i, 10 ** 6)


def _break_lifted_set(h):
    """The last read of the first key read nonempty loses an element."""
    k = next(h[j]["value"][0] for j in _ok(h, "read") if h[j]["value"][1])
    i = [j for j in _ok(h, "read") if h[j]["value"][0] == k][-1]
    return _set(h, i, [k, h[i]["value"][1][1:]])


def _break_balances(h):
    i = _ok(h, "read")[-1]
    v = dict(h[i]["value"])
    v[0] += 1
    return _set(h, i, v)


def _break_long_fork(h):
    g = [0, 1, 2]
    fork = [[["r", k, 1 if k == a else None] for k in g] for a in (0, 1)]
    return h + [{"type": "ok", "process": 0, "f": "txn", "value": v,
                 "time": h[-1]["time"] + 1} for v in fork]


def _kit_checker(kit, test=None, **kw):
    def make(m):
        return _wl(m, kit).workload(test, **kw)["checker"]
    return make


ACID_OPTS = {"accelerator": "cpu"}

# case -> (history maker, test map, checker maker(m), breaker or None)
CHECKS = {
    "single_key_acid": (lambda: _driven("single_key_acid", {}), {},
                        _kit_checker("single_key_acid", accelerator="cpu"),
                        _break_lifted_read),
    "multi_key_acid": (
        lambda: histories.multi_key_acid_history(4, seed=9),
        {}, _kit_checker("multi_key_acid", accelerator="cpu"),
        lambda h: histories.corrupt_txn_keys(h, [0, 2])),
    "set": (lambda: _driven("set", {}), {},
            _kit_checker("set_workload"), _break_set),
    "set_full": (lambda: _driven("set_full", {}), {},
                 _kit_checker("set_workload", full=True,
                              accelerator="cpu"), _break_set),
    "append": (lambda: _driven("append", {}), {},
               _kit_checker("append", accelerator="cpu"), _break_append),
    "wr": (lambda: _driven("wr", {}, {"txn_style": "wr"}), {},
           _kit_checker("wr", accelerator="cpu"), _break_wr),
    "mutex": (lambda: _driven("mutex", {}), {}, _kit_checker("mutex"),
              _break_mutex),
    # the counter check bounds a read by the adds completed before it
    # completes (checker.clj:737-795): one op in flight at a time
    "counter": (lambda: _driven("counter", {"counter": True}, width=1), {},
                _kit_checker("counter"), _break_counter),
    "counter_negative": (
        lambda: _driven("counter_negative", {"counter": True}, width=1), {},
        _kit_checker("counter", negative=True), _break_counter),
    "queue": (lambda: _driven("queue", {}), {},
              _kit_checker("queue_workload"), _break_queue),
    "lost_updates": (lambda: _read_keys_only(
        _driven("lost_updates", {"lost-updates": True})), {},
        _kit_checker("lost_updates"), _break_lifted_set),
    "pause": (lambda: _driven("pause", {"pause-workload": True}), {},
              _kit_checker("pause_workload"), _break_lifted_set),
    "bank": (lambda: _driven("bank", {"accounts": [0, 1, 2]},
                             {"whole_read": "bank"}),
             {"accounts": [0, 1, 2], "total-amount": 30},
             lambda m: _wl(m, "bank").checker(), _break_balances),
    "transfer": (lambda: _driven("transfer", {"accounts": [0, 1, 2]},
                                 {"whole_read": "bank"}), {},
                 lambda m: _wl(m, "transfer").TransferChecker([0, 1, 2], 10),
                 _break_balances),
    "long_fork": (lambda: _driven("long_fork", {}, {"txn_style": "wr"}), {},
                  _kit_checker("long_fork"), _break_long_fork),
}
# the cp-lock kits' histories are their generators' perfect completions:
# every acquire succeeds, so a lock held by one thread is acquired by
# another (invalid) at 3 threads, and not at 1
for _kit in ("lock", "cp_lock", "reentrant_cp_lock", "fenced_lock",
             "reentrant_fenced_lock", "semaphore", "ids", "cas_long"):
    CHECKS[_kit] = (None, {}, None, None)

_MEMO: dict = {}


def _history(case, broken):
    key = (case, broken)
    if key not in _MEMO:
        make, _, _, brk = CHECKS[case]
        if make is None:
            threads = 3 if broken else 1
            saved = GENS[case]
            GENS[case] = (threads,) + saved[1:]
            try:
                h = _simulate(PORT, case, "perfect", seed=5)
            finally:
                GENS[case] = saved
        else:
            h = make() if not broken else brk(_history(case, False))
        _MEMO[key] = h
    return _MEMO[key]


def _cp_checker(case):
    fn, kw = {"semaphore": ("semaphore_workload", {}),
              "ids": ("ids_workload", {}),
              "cas_long": ("cas_long_workload", {})}.get(
        case, ("lock_workload", {"flavor": case.replace("_", "-")}))
    return lambda m: getattr(_wl(m, "cp_lock"), fn)(None, **kw)["checker"]


def _plain(x, root=None):
    """A result map through JSON, as a stored result is compared, with
    paths under the run dir ``root`` made relative to it."""
    text = json.dumps(x, default=repr, sort_keys=True)
    if root is not None:
        text = text.replace(str(root), "")
    return json.loads(text)


def _run_map(tmp_path, pkg, **extra):
    """A test map that addresses the store dir ``tmp_path/pkg``."""
    return {"name": "kit", "start_time": "t0",
            "store_dir": str(tmp_path / pkg), **extra}


def _both(make, test, h, opts, tmp_path):
    """The port's and the JAX package's results, their paths relative to
    their run dirs. An invalid key of a lifted check renders its
    linear.png under its ``independent/<k>`` in the port, at the run's
    top in the JAX package (ROADMAP Queue 3 item 6): the JAX package's
    path is moved there."""
    got, want = [_plain(make(m).check(_run_map(tmp_path, pkg, **test), h,
                                      dict(opts)), tmp_path / pkg)
                 for m, pkg in ((PORT, "port"), (JAX, "jax"))]
    for k, r in (want.get("results") or {}).items():
        lin = r.get("linear") if isinstance(r, dict) else None
        if isinstance(lin, dict) and lin.get("plot"):
            assert lin["plot"] == "/kit/t0/linear.png"
            lin["plot"] = f"/kit/t0/independent/{k}/linear.png"
    return got, want


@pytest.mark.parametrize("broken", [False, True], ids=["valid", "broken"])
@pytest.mark.parametrize("case", sorted(CHECKS))
def test_checker_matches_jax(case, broken, tmp_path):
    h = _history(case, broken)
    _, test, make, _ = CHECKS[case]
    got, want = _both(make or _cp_checker(case), test, h, {}, tmp_path)
    assert got == want
    # the fake serves no "generate" (every op fails), and a cas-long
    # history's perfect completions break the register at one thread too
    if case not in ("ids", "cas_long"):
        assert got["valid?"] is (not broken)


# ---------------------------------------------------------------------------
# the cases of tests/test_workloads.py that cover the ported kits
# ---------------------------------------------------------------------------

def op(typ, process, f, value=None):
    return {"type": typ, "process": process, "f": f, "value": value}


_BANK = {"accounts": [0, 1], "total-amount": 20}
_BANK_OK = [
    op("invoke", 0, "read"), op("ok", 0, "read", {0: 10, 1: 10}),
    op("invoke", 1, "transfer", {"from": 0, "to": 1, "amount": 5}),
    op("ok", 1, "transfer", {"from": 0, "to": 1, "amount": 5}),
    op("invoke", 0, "read"), op("ok", 0, "read", {0: 5, 1: 15})]
_LF_FORK = [op("ok", 0, "txn", [["w", 0, 1]]),
            op("ok", 1, "txn", [["w", 1, 1]]),
            op("ok", 2, "txn", [["r", 0, 1], ["r", 1, None]]),
            op("ok", 3, "txn", [["r", 0, None], ["r", 1, 1]])]
_LF_OK = [op("ok", 0, "txn", [["w", 0, 1]]),
          op("ok", 2, "txn", [["r", 0, 1], ["r", 1, None]]),
          op("ok", 3, "txn", [["r", 0, 1], ["r", 1, 1]]),
          op("ok", 1, "txn", [["w", 1, 1]])]
_LF_ACCOUNT = [op("ok", 0, "txn", [["r", 0, None], ["r", 1, None]]),
               op("ok", 1, "txn", [["r", 0, 1], ["r", 1, None]]),
               op("ok", 0, "txn", [["r", 0, 1], ["r", 1, 1]])]
_SET = [op("invoke", 0, "add", 0), op("ok", 0, "add", 0),
        op("invoke", 1, "add", 1), op("ok", 1, "add", 1),
        op("invoke", 0, "read"), op("ok", 0, "read", [0, 1])]
_Q_OK = [op("invoke", 0, "enqueue", 1), op("ok", 0, "enqueue", 1),
         op("invoke", 1, "enqueue", 2), op("ok", 1, "enqueue", 2),
         op("invoke", 0, "dequeue"), op("ok", 0, "dequeue", 1),
         op("invoke", 1, "drain"), op("ok", 1, "drain", [2])]
_Q_DUP = [op("invoke", 0, "enqueue", 1), op("ok", 0, "enqueue", 1),
          op("invoke", 0, "dequeue"), op("ok", 0, "dequeue", 1),
          op("invoke", 0, "dequeue"), op("ok", 0, "dequeue", 1)]


def _mr(txns):
    h = []
    for i, mops in enumerate(txns):
        h.append({"type": "invoke", "process": i % 3, "f": "txn",
                  "value": [[f, k, None if f == "r" else v]
                            for f, k, v in mops]})
        h.append({"type": "ok", "process": i % 3, "f": "txn", "value": mops})
    return h


def _mr_seq():
    rng, state, txns = random.Random(5), {}, []
    for _ in range(40):
        keys = sorted(rng.sample(range(3), rng.randint(1, 3)))
        if rng.random() < 0.5:
            mops = [["w", k, rng.randrange(5)] for k in keys]
            state.update({k: v for _, k, v in mops})
        else:
            mops = [["r", k, state.get(k)] for k in keys]
        txns.append(mops)
    return _mr(txns)


def _lin(**kw):
    def make(m):
        lin = importlib.import_module(f"{m['root']}.checker.linearizable")
        models = importlib.import_module(f"{m['root']}.models")
        return lin.linearizable(model=models.MultiRegister(), **kw)
    return make


# case -> (checker maker(m), test map, history, opts, expected valid?)
REFERENCE_CASES = {
    "bank_valid": (lambda m: _wl(m, "bank").checker(), _BANK, _BANK_OK, {},
                   True),
    "bank_wrong_total": (lambda m: _wl(m, "bank").checker(), _BANK,
                         [op("invoke", 0, "read"),
                          op("ok", 0, "read", {0: 10, 1: 11})], {}, False),
    "bank_negative_balance": (lambda m: _wl(m, "bank").checker(), _BANK,
                              [op("invoke", 0, "read"),
                               op("ok", 0, "read", {0: -5, 1: 25})], {},
                              False),
    "bank_negative_allowed": (
        lambda m: _wl(m, "bank").checker(negative_balances=True), _BANK,
        [op("invoke", 0, "read"), op("ok", 0, "read", {0: -5, 1: 25})], {},
        True),
    "bank_stored_string_keys": (lambda m: _wl(m, "bank").checker(), _BANK,
                                [op("ok", 0, "read", {"0": 5, "1": 15})],
                                {}, True),
    "long_fork_detects_fork": (
        lambda m: _wl(m, "long_fork").checker(group_size=2), {}, _LF_FORK,
        {}, False),
    "long_fork_comparable_ok": (
        lambda m: _wl(m, "long_fork").checker(group_size=2), {}, _LF_OK, {},
        True),
    "long_fork_read_accounting": (
        lambda m: _wl(m, "long_fork").checker(group_size=2), {},
        _LF_ACCOUNT, {}, True),
    "set_checker_valid": (_kit_checker("set_workload"), {}, _SET, {}, True),
    "set_checker_lost": (_kit_checker("set_workload"), {},
                         _SET[:-1] + [op("ok", 0, "read", [1])], {}, False),
    "append_single_txn": (_kit_checker("append"), {},
                          [op("ok", 0, "txn", [["append", "x", 1],
                                               ["r", "x", [1]]])],
                          {"accelerator": "cpu"}, True),
    "wr_single_txn": (_kit_checker("wr"), {},
                      [op("ok", 0, "txn", [["w", "x", 1], ["r", "x", 1]])],
                      {"accelerator": "cpu"}, True),
    "queue_drain_expansion": (_kit_checker("queue_workload"), {}, _Q_OK, {},
                              True),
    "queue_lost_in_drain": (_kit_checker("queue_workload"), {},
                            _Q_OK[:-2] + [op("invoke", 1, "drain"),
                                          op("ok", 1, "drain", [])], {},
                            False),
    "queue_recovered": (_kit_checker("queue_workload"), {},
                        [op("invoke", 0, "enqueue", 9),
                         op("info", 0, "enqueue", 9),
                         op("invoke", 1, "drain"),
                         op("ok", 1, "drain", [9])], {}, True),
    "queue_duplicate_delivery": (_kit_checker("queue_workload"), {}, _Q_DUP,
                                 {}, True),
    "queue_unexpected": (_kit_checker("queue_workload"), {},
                         _Q_DUP + [op("invoke", 1, "dequeue"),
                                   op("ok", 1, "dequeue", 99)], {}, False),
    "multi_key_acid_good": (_lin(accelerator="cpu"), {}, _mr([
        [["w", 0, 1], ["w", 1, 2]], [["r", 0, 1], ["r", 1, 2]],
        [["w", 0, 4]], [["r", 0, 4], ["r", 2, None]]]), {}, True),
    "multi_key_acid_bad": (_lin(accelerator="cpu"), {},
                           _mr([[["w", 0, 1]], [["r", 0, 2]]]), {}, False),
    "multi_key_acid_jitlin_sequential": (
        _lin(algorithm="jitlin", accelerator="cpu"), {}, _mr_seq(), {}, True),
    "multi_key_acid_wgl_sequential": (_lin(algorithm="wgl"), {}, _mr_seq(),
                                      {}, True),
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_case_matches_jax(case, tmp_path):
    make, test, h, opts, valid = REFERENCE_CASES[case]
    got, want = _both(make, test, h, opts, tmp_path)
    assert got == want
    assert got["valid?"] is valid


def test_multi_register_model_steps_as_jax():
    from jepsen_tpu.models import MultiRegister as JM
    from jepsen_tpu.models import is_inconsistent as jbad
    from jepsen_tpu_torch.models import MultiRegister as TM
    from jepsen_tpu_torch.models import is_inconsistent as tbad
    rng = random.Random(3)
    tm, jm = TM(), JM()
    for _ in range(200):
        keys = sorted(rng.sample(range(3), rng.randint(1, 3)))
        f = rng.choice("rw")
        mops = [[f, k, rng.choice([None, 0, 1, 2]) if f == "r"
                 else rng.randrange(3)] for k in keys]
        a, b = tm.step({"f": "txn", "value": mops}), jm.step(
            {"f": "txn", "value": mops})
        assert tbad(a) is jbad(b)
        if not tbad(a):
            assert a.entries == b.entries
            tm, jm = a, b


def test_bank_plotter_png_matches_jax(tmp_path):
    """The bank plot of the same reads: the same PNG, pixel for pixel
    (the port draws on a Figure of its own), beside the SI check."""
    pytest.importorskip("matplotlib")
    import matplotlib.image as mpimg
    h = [op("invoke", 0, "read"), op("ok", 0, "read", {0: 10, 1: 10}),
         op("invoke", 1, "read"), op("ok", 1, "read", {0: 9, 1: 11})]
    for i, o in enumerate(h):
        o["time"] = i * 10 ** 9
    out = {}
    for name, m in (("port", PORT), ("jax", JAX)):
        w = _wl(m, "bank").workload()
        test = {**w, **_BANK, "name": "bank-plot", "start_time": "t0",
                "store_dir": str(tmp_path / name), "nodes": ["n1", "n2"]}
        out[name] = w["checker"].check(test, h, {})
    got, want = out["port"], out["jax"]
    assert got["valid?"] is want["valid?"] is True
    assert got["SI"] == want["SI"]
    px = [mpimg.imread(r["plot"]["plot"]) for r in (got, want)]
    assert Path(got["plot"]["plot"]).name == "bank.png"
    assert px[0].shape == px[1].shape and np.array_equal(*px)


def test_unported_kits_raise():
    import jepsen_tpu_torch.workloads as w
    ref = sorted(p.stem for p in (ROOT / "jepsen_tpu/workloads").glob("*.py")
                 if p.stem != "__init__")
    assert sorted(w.PORTED + w.UNPORTED) == ref
    for name in w.UNPORTED:
        with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
            getattr(w, name)


def test_set_full_kit_checks_on_the_card_by_default(monkeypatch):
    """The JAX package's set kit checks set-full on the host unless asked;
    the port's, an entry point, defaults to "auto" (the card), as its
    ``checker.set_full`` does: with no CUDA device its check raises rather
    than walk the history on the host, and "cpu" walks it as the JAX
    package's does."""
    import torch
    from jepsen_tpu.history import index as jindex
    from jepsen_tpu.workloads import set_workload as jset
    from jepsen_tpu_torch.history import index
    from jepsen_tpu_torch.workloads import set_workload as tset
    assert jset.workload(full=True)["checker"].accelerator == "cpu"
    chk = tset.workload(full=True)["checker"]
    assert chk.accelerator == "auto"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        chk.check({}, index([dict(o) for o in _SET]), {})
    got = tset.workload(full=True, accelerator="cpu")["checker"].check(
        {}, index([dict(o) for o in _SET]), {})
    want = jset.workload(full=True)["checker"].check(
        {}, jindex([dict(o) for o in _SET]), {})
    assert got == want and got["valid?"] is True


def test_int_keys_as_jax():
    from jepsen_tpu.utils import int_key as jk, int_keyed as jkd
    from jepsen_tpu_torch.utils import int_key, int_keyed
    for k in ("7", "-3", "x", 5, None, "1.5", ("a",)):
        assert int_key(k) == jk(k)
    d = {"0": 1, "a": 2, 3: 4}
    assert int_keyed(d) == jkd(d) == {0: 1, "a": 2, 3: 4}


# ---------------------------------------------------------------------------
# the fake cluster, op for op
# ---------------------------------------------------------------------------

def _sim_ops(kit):
    return [{"f": op["f"], "value": op["value"], "process": op["process"]}
            for op in _simulate(PORT, kit, "perfect", seed=2)
            if op["type"] == "invoke" and op["process"] != "nemesis"]


def _ops(*pairs, process=0):
    return [{"f": f, "value": v, "process": process} for f, v in pairs]


# dispatch -> (test map, client kwargs, ops)
FAKE_CASES = {
    "register": ({}, {}, _sim_ops("single_key_acid")),
    "multi-txn": ({"txn-mode": "multi"}, {}, _sim_ops("multi_key_acid")),
    "set": ({}, {}, _sim_ops("set_full")),
    "append": ({}, {}, _sim_ops("append")),
    "wr": ({}, {"txn_style": "wr"}, _sim_ops("wr")),
    "long-fork": ({}, {"txn_style": "wr"}, _sim_ops("long_fork")),
    "mutex": ({}, {}, _sim_ops("mutex") + _sim_ops("cp_lock")),
    "counter": ({"counter": True}, {}, _sim_ops("counter_negative")),
    "queue": ({}, {}, _sim_ops("queue") + _ops(("dequeue", None))),
    "lost-updates": ({"lost-updates": True}, {}, _sim_ops("lost_updates")),
    "pause": ({"pause-workload": True}, {}, _sim_ops("pause")),
    "bank": ({"accounts": [0, 1, 2]}, {"whole_read": "bank"},
             _sim_ops("bank") + _ops(("transfer", {"from": 0, "to": 1,
                                                   "amount": 99}))),
    "transfer": ({"accounts": [0, 1, 2]}, {"whole_read": "bank"},
                 _sim_ops("transfer")),
    "dirty-rows": ({"dirty-rows": 3}, {"whole_read": "dirty"},
                   _ops(("read", None), ("write", 4), ("read", None))),
    "ddl-table": ({"ddl-table": True}, {}, _ops(
        ("insert", None), ("read", None), ("create-table", None),
        ("insert", None), ("insert", None), ("read", None),
        ("drop-table", None), ("read", None))),
    "table-workload": ({"table-workload": True}, {}, _ops(
        ("insert", [1, 0]), ("create-table", 1), ("insert", [1, 5]))),
    "upsert": ({"upsert-workload": True}, {}, _ops(
        ("read-uids", [3, None]), ("upsert", [3, 9]), ("upsert", [3, 10]),
        ("read-uids", [3, None]))),
    "pages": ({"pages": True}, {}, _ops(
        ("add", [1, [5, 2]]), ("add", [1, [7]]), ("read", [1, None]))),
    "dirty-read": ({"dirty-read": True}, {}, _ops(
        ("read", 4), ("write", 4), ("read", 4), ("refresh", None),
        ("strong-read", None))),
    "version-divergence": ({"version-divergence": True}, {}, _ops(
        ("read", [2, None]), ("write", [2, 7]), ("write", [2, 8]),
        ("read", [2, None]))),
    "comments": ({"comments": True}, {}, _ops(
        ("write", [1, 4]), ("write", [1, 2]), ("read", [1, None]))),
    "monotonic-key": ({"monotonic-key": True}, {}, _ops(
        ("inc", 3), ("inc", 3), ("inc", 4), ("read", {3: None, 5: None}))),
    "delete": ({"delete-workload": True}, {}, _ops(
        ("read", [1, None]), ("upsert", [1, None]), ("upsert", [1, None]),
        ("read", [1, None]), ("delete", [1, None]), ("delete", [1, None]))),
    "dgraph-sequential": ({"dgraph-sequential": True}, {}, _ops(
        ("inc", [2, None]), ("inc", [2, None]), ("read", [2, None]))),
    "ledger": ({"ledger": True}, {}, _ops(
        ("transfer", [0, 5]), ("transfer", [0, -7]), ("transfer", [0, -5]))),
    "key-count": ({"key-count": 3}, {}, _ops(
        ("write", 4), ("read", 4), ("read", 5))),
    "adya-monotonic": ({}, {}, _ops(
        ("insert", [(1, 2), 7, "a"]), ("insert", [(1, 2), 8, "b"]),
        ("inc", None), ("inc", None), ("read-all", None))),
    "unknown-f": ({}, {}, _ops(("frobnicate", None))),
}


def _store_state(db):
    return {k: repr(v) for k, v in sorted(vars(db).items())
            if k not in ("lock", "_log_lock")}


@pytest.mark.parametrize("case", sorted(FAKE_CASES))
def test_fake_cluster_matches_jax(case):
    test, kw, ops = FAKE_CASES[case]
    out = {}
    for name, fakes in (("port", tfakes), ("jax", jfakes)):
        db = fakes.KVStore()
        client = fakes.KVClient(db, **kw).open(test, "n1")
        client.setup(test)
        done = [client.invoke(dict(test), {"type": "invoke", **o})
                for o in ops]
        client.teardown(test)
        before = _store_state(db)
        db.teardown(test, "n1")
        out[name] = (done, before, _store_state(db), db.log,
                     client.supported_fs(test))
    assert out["port"] == out["jax"]
    assert any(c["type"] == "ok" for c in out["port"][0]) \
        is (case != "unknown-f")


# ---------------------------------------------------------------------------
# ROADMAP Queue 3 items 4 and 5
# ---------------------------------------------------------------------------

def test_multi_key_acid_invalid_keys_settle_on_the_dense_table(tmp_path):
    """Item 4: multi-key-acid's keys with an impossible read, through the
    kit's checker on the port's device lane (its plain kernels on the
    CPU): each settles on the dense table (``torch-frontier``), where
    the JAX package's device lane calls its table "unknown" and settles
    in its exact twin; the verdicts and failed ops are the same."""
    h = histories.corrupt_txn_keys(histories.multi_key_acid_history(
        3, n_procs=6, seed=21), [0, 2])
    got = _wl(PORT, "multi_key_acid").workload(
        {"nodes": NODES}, accelerator="gpu", device="cpu")["checker"].check(
        _run_map(tmp_path, "port"), h, {})
    want = _wl(JAX, "multi_key_acid").workload(
        {"nodes": NODES}, accelerator="tpu")["checker"].check(
        _run_map(tmp_path, "jax"), h, {})
    assert got["failures"] == want["failures"] == ["0", "2"]
    from jepsen_tpu_torch.checker.linear_encode import (
        encode_multi_register_ops)
    from jepsen_tpu_torch.ops.jitlin import JitLinKernel
    keys, subs = tind.split_history(h)
    routes = {str(k): JitLinKernel().route(
        encode_multi_register_ops(subs[k]).n_slots, 216) for k in keys}
    assert set(routes.values()) == {"dense"}
    for k in ("0", "1", "2"):
        g, w = got["results"][k]["linear"], want["results"][k]["linear"]
        assert (g["valid?"], g.get("failed-op")) == (
            w["valid?"], w.get("failed-op"))
        assert g["algorithm"] == "torch-frontier"
        assert w["algorithm"] == ("jitlin-cpu(fallback)" if k != "1"
                                  else "jitlin-tpu")


def _partitioned(n_keys=3, bad=(1,)):
    h = histories.corrupt_keys(histories.independent_register_history(
        n_keys, 40, n_procs=3), list(bad))
    grudge = {"n1": ["n2", "n3"], "n2": ["n1"], "n3": ["n1"]}
    nem = [{"type": "info", "process": "nemesis", "f": "start-partition",
            "value": None},
           {"type": "info", "process": "nemesis", "f": "start-partition",
            "value": ["isolated", grudge]},
           {"type": "info", "process": "nemesis", "f": "stop-partition",
            "value": None},
           {"type": "info", "process": "nemesis", "f": "stop-partition",
            "value": ["network-healed", None]}]
    return h[:20] + nem[:2] + h[20:60] + nem[2:] + h[60:]


def test_nemesis_values_are_no_keys():
    """Item 5: a partition's ``["isolated", grudge]`` info op (and a
    two-element heal value) is no key in the port's split; the JAX
    package splits them as keys, which it reports valid. The real keys'
    sub-histories and verdicts are the same."""
    h = _partitioned()
    keys = tind.history_keys(h)
    assert sorted(keys) == [0, 1, 2]
    assert jind.history_keys(h) == keys + ["isolated", "network-healed"]
    assert tind.split_history(h)[0] == keys
    subs = tind.split_history(h)[1]
    for k in keys:
        assert subs[k] == tind.subhistory(k, h) == jind.subhistory(k, h)
    assert tind.subhistory("isolated", h) == []
    from jepsen_tpu.checker.linearizable import linearizable as jlin
    from jepsen_tpu_torch.checker.linearizable import linearizable
    got = tind.checker(linearizable(accelerator="cpu")).check({}, h, {})
    want = jind.checker(jlin(accelerator="cpu")).check({}, h, {})
    assert got["failures"] == want["failures"] == ["1"]
    assert sorted(want["results"]) == ["0", "1", "2", "isolated",
                                       "network-healed"]
    assert sorted(got["results"]) == ["0", "1", "2"]
    for k in got["results"]:
        assert got["results"][k] == want["results"][k]
    assert all(want["results"][k]["valid?"] is True
               for k in ("isolated", "network-healed"))


def test_live_session_routes_client_ops_alone():
    """Item 5 in the live multi-key session: the nemesis op counts
    toward the absorbed ops and opens no key's session."""
    from jepsen_tpu_torch.live.sessions import MultiKeyLinearSession
    h = _partitioned()
    s = MultiKeyLinearSession(accelerator="cpu")
    s.add_many(h)
    assert sorted(s.sub) == [0, 1, 2]
    assert s.ops_absorbed == len(h)


# ---------------------------------------------------------------------------
# whole fake runs through core.run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chip_smoke():
    """chip_smoke.py as a module (its top level imports the standard
    library only), for phase 21's test map and doubles."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lifted_verdicts(res, history):
    """The verdict, the invalid keys and each client key's (verdict,
    failed op's history index); a nemesis value the JAX package splits as
    a key (ROADMAP Queue 3 item 5) must be valid there and is left out."""
    nemesis = {str(op["value"][0]) for op in history
               if op.get("process") == "nemesis"
               and tind.is_tuple_value(op.get("value"))}
    per_key = {}
    for k, r in res["results"].items():
        r = r.get("linear", r)
        if k in nemesis and k not in {str(x) for x in
                                       tind.history_keys(history)}:
            assert r["valid?"] is True
            continue
        op = r.get("failed-op")
        per_key[k] = (r["valid?"], None if op is None else op.get("index"))
    return res["valid?"], sorted(res.get("failures") or []), per_key


@pytest.mark.parametrize("run", ["valid", "stale"])
def test_multi_key_acid_run_checked_by_reference(chip_smoke, run,
                                                 monkeypatch):
    """Phase 21's multi-key-acid test map at a 0.5 s time limit on the
    CPU, with the honest fake client and with phase 21's stale-read
    double: the port's verdict, and the JAX package's multi-key-acid
    checker over the stored history gives the same verdicts key by
    key."""
    from jepsen_tpu.checker import linear_report as jreport
    from jepsen_tpu.workloads import multi_key_acid as jmka
    from jepsen_tpu_torch import core, store
    from jepsen_tpu_torch.checker import linear_report
    from jepsen_tpu_torch.history import index
    # the verdicts are compared, not the invalid keys' linear.png
    for mod in (jreport, linear_report):
        monkeypatch.setattr(mod, "render_failure", lambda *a, **k: None)
    client = (chip_smoke._honest_client("multi-key-acid") if run == "valid"
              else lambda kv: chip_smoke._stale_txn_client(kv, 3, every=10))
    # faults every 0.1 s, so that a 0.5 s run holds nemesis ops
    monkeypatch.setattr(chip_smoke, "NEMESIS_INTERVAL", 0.1)
    with tempfile.TemporaryDirectory() as tmp:
        test, _ = chip_smoke.run_test_map(
            tmp, client, 0.5, "cpu", "cpu", "multi-key-acid", 10)
        # the verdicts are compared: the workload's check alone (no
        # reports), without the invalid keys' forensics
        test["checker"] = test["checker"].checkers["workload"]
        test["explain"] = False
        result = core.run(test)
        mine = result["results"]
        history = index(store.load_history(result["name"],
                                           result["start_time"], tmp))
        assert len(history) == len(result["history"]) > 100
        assert mine["valid?"] is (run == "valid"), mine["failures"]
        assert {"history.jsonl", "results.json", "test.json",
                "faults.jsonl"} <= {p.name for p in
                                    store.test_dir(result).iterdir()}
        want = jmka.workload({"nodes": NODES}, accelerator="cpu")[
            "checker"].check({"name": "ref", "start_time": "t0",
                              "store_dir": tmp, "explain": False},
                             history, {})
        assert _lifted_verdicts(want, history) == \
            _lifted_verdicts(mine, history)


# status file fields: the live daemon's final Elle verdict is reused for a
# bare AppendChecker only when its session was list-append's
_ELLE_FRESH = {"state": "final", "workload": "list-append",
               "ops_absorbed": 4,
               "results": {"valid?": False, "anomaly-types": ["G1c"]}}
APPEND_REUSE = {"fresh": {}, "register-session": {"workload": "register"},
                "stale": {"ops_absorbed": 3}}


@pytest.mark.parametrize("case", sorted(APPEND_REUSE))
def test_live_final_results_of_append_as_jax(tmp_path, case):
    """``core._live_final_results``' append branch over a run directory's
    ``live-status.json``, against the JAX package's: a fresh list-append
    verdict is reused for the append kit's checker, a register session's
    or a stale one is not; a reused verdict also through the port's
    ``core.analyze``."""
    from jepsen_tpu import core as jcore
    from jepsen_tpu.workloads import append as japp
    from jepsen_tpu_torch import core, store
    from jepsen_tpu_torch.live.daemon import LIVE_STATUS_NAME
    from jepsen_tpu_torch.workloads import append
    test = {"name": "app", "start_time": "t0", "store_dir": str(tmp_path),
            "live_reuse": True,
            "history": [{"type": t, "f": "txn", "process": 0,
                         "value": [["r", 1, None]]}
                        for t in ("invoke", "ok") * 2]}
    store.path_mk(test, LIVE_STATUS_NAME).write_text(
        json.dumps({**_ELLE_FRESH, **APPEND_REUSE[case]}))
    got = core._live_final_results(test, append.checker())
    assert got == jcore._live_final_results(test, japp.checker())
    assert (got is not None) is (case == "fresh")
    if got is not None:
        assert got == {**_ELLE_FRESH["results"], "live-reused": True}
        assert core.analyze(dict(test, checker=append.checker()))[
            "results"] == got
