"""Whole test runs through the port's ``core.run`` over the dummy remote
and the in-memory doubles, with ``accelerator="cpu"`` (the cases of
tests/test_core.py, after jepsen/test/jepsen/core_test.clj), and the
port's run histories held against the JAX package's checker: the same
verdicts and invalid keys. A ``cuda``-marked case runs the etcd suite's
fake register test map on the card."""
from __future__ import annotations

import importlib.util
import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import pytest
import torch

import jepsen_tpu_torch.generator as gen
from jepsen_tpu_torch import checker, core, independent
from jepsen_tpu_torch import nemesis as nemesis_mod
from jepsen_tpu_torch import store
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.fakes import (AtomClient, AtomDB, CrashingClient,
                                    KVClient, KVStore, noop_test)
from jepsen_tpu_torch.nemesis import combined, faults as faults_mod
from jepsen_tpu_torch.net import NoopNet
from jepsen_tpu_torch.workloads import register

ROOT = Path(__file__).resolve().parent.parent


def cas_test(tmp, n_ops=200, concurrency=5):
    db = AtomDB()
    return noop_test(
        name="cas-register",
        db=db,
        client=AtomClient(db),
        concurrency=concurrency,
        store_dir=tmp,
        generator=gen.clients(gen.limit(n_ops, gen.mix([
            gen.repeat({"f": "read"}),
            lambda test, ctx: {"f": "write", "value": ctx.rng.randrange(5)},
            lambda test, ctx: {"f": "cas",
                               "value": [ctx.rng.randrange(5),
                                         ctx.rng.randrange(5)]},
        ]))),
        checker=checker.compose({
            "linear": linearizable(accelerator="cpu"),
            "stats": checker.stats(),
        }),
    ), db


def test_basic_cas_run():
    with tempfile.TemporaryDirectory() as tmp:
        test, db = cas_test(tmp, n_ops=200, concurrency=5)
        result = core.run(test)
        history = result["history"]
        assert all("index" in op for op in history)
        invokes = [op for op in history if op["type"] == "invoke"]
        completions = [op for op in history
                       if op["type"] in ("ok", "fail", "info")]
        assert len(invokes) == 200
        assert len(completions) == 200
        assert result["results"]["valid?"] is True, result["results"]
        assert result["results"]["linear"]["valid?"] is True
        opens = [e for e in db.log if e[0] == "client-open"]
        closes = [e for e in db.log if e[0] == "client-close"]
        assert len(opens) >= len(test["nodes"])
        assert len(closes) == len(opens)
        setups = [e for e in db.log if e[0] == "db-setup"]
        assert len(setups) == len(test["nodes"])


def test_store_persistence_round_trip():
    with tempfile.TemporaryDirectory() as tmp:
        test, _ = cas_test(tmp, n_ops=50)
        result = core.run(test)
        name, ts = result["name"], result["start_time"]
        loaded = store.load_test(name, ts, tmp)
        assert len(loaded["history"]) == len(result["history"])
        assert loaded["results"]["valid?"] == result["results"]["valid?"]
        assert loaded["results"]["linear"]["valid?"] is True
        assert (store.test_dir(result) / "history.npz").exists()
        assert (store.base_dir(result) / name / "latest").exists()
        # the WAL is discarded once history.jsonl is saved
        assert not (store.test_dir(result) / "history.wal.jsonl").exists()
        assert store.latest(tmp)[:2] == (name, ts)


def test_worker_recovery_crashing_client():
    """A client that always throws: every op becomes :info, processes are
    renumbered, and the run completes (core_test.clj:179-198)."""
    with tempfile.TemporaryDirectory() as tmp:
        client = CrashingClient()
        test = noop_test(
            name="crash", client=client, concurrency=2, store_dir=tmp,
            generator=gen.clients(gen.limit(10, gen.repeat({"f": "read"}))),
            checker=checker.unbridled_optimism(),
        )
        result = core.run(test)
        infos = [op for op in result["history"] if op["type"] == "info"]
        assert len(infos) == 10
        assert client.invocations == 10
        procs = {op["process"] for op in result["history"]
                 if op["type"] == "invoke"}
        assert len(procs) == 10


def test_nemesis_ops_flow_through():
    with tempfile.TemporaryDirectory() as tmp:
        db = AtomDB()
        test = noop_test(
            name="nemesis-flow", db=db, client=AtomClient(db),
            concurrency=2, store_dir=tmp,
            nemesis=nemesis_mod.partition_random_halves(),
            generator=gen.phases(
                gen.nemesis_gen(gen.once(gen.repeat(
                    {"f": "start-partition", "value": "majority"}))),
                gen.clients(gen.limit(10, gen.repeat({"f": "read"}))),
                gen.nemesis_gen(gen.once(gen.repeat(
                    {"f": "stop-partition"}))),
            ),
            checker=checker.unbridled_optimism(),
        )
        result = core.run(test)
        nem_ops = [op for op in result["history"]
                   if op["process"] == "nemesis"]
        assert any(op["f"] == "start-partition" and op["type"] == "info"
                   and op["value"][0] == "isolated" for op in nem_ops)
        assert any(e[0] == "drop-all" for e in result.get("_net_log", []))
        assert any(e[0] == "heal" for e in result.get("_net_log", []))
        # the registry recorded the window and its heal
        rows = faults_mod.load_rows(store.path(result, "faults.jsonl"))
        assert [r["op"] for r in rows] == ["inject", "heal"], rows


def test_generator_exception_shuts_down_cleanly():
    """Generator throws mid-run: run raises, workers die, clients close
    (core_test.clj generator-recovery-test)."""
    with tempfile.TemporaryDirectory() as tmp:
        db = AtomDB()

        def boom(test, ctx):
            raise RuntimeError("generator exploded")

        test = noop_test(
            name="gen-crash", db=db, client=AtomClient(db), concurrency=2,
            store_dir=tmp,
            generator=gen.clients([gen.limit(4, gen.repeat({"f": "read"})),
                                   boom]),
            checker=checker.unbridled_optimism(),
        )
        with pytest.raises(RuntimeError):
            core.run(test)
        opens = [e for e in db.log if e[0] == "client-open"]
        closes = [e for e in db.log if e[0] == "client-close"]
        assert len(closes) >= len(opens) - len(test["nodes"])


def test_time_limit_wall_clock():
    """time_limit bounds the run in real time."""
    with tempfile.TemporaryDirectory() as tmp:
        db = AtomDB()
        test = noop_test(
            name="timed", db=db, client=AtomClient(db), concurrency=2,
            store_dir=tmp,
            generator=gen.time_limit(1.0, gen.clients(
                gen.stagger(0.05, gen.repeat({"f": "read"})))),
            checker=checker.stats(),
        )
        t0 = time.monotonic()
        result = core.run(test)
        dt = time.monotonic() - t0
        assert dt < 15
        assert result["results"]["valid?"] is True
        n = result["results"]["count"]
        assert 5 <= n <= 40


# -- the etcd suite's fake register test, through the port --------------

def _chip_smoke():
    """chip_smoke.py as a module (its top level imports the standard
    library only), for phase 20b's stale-read double."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stale_client(kv, every, seed):
    return _chip_smoke()._stale_client(kv, seed, every=every)


def register_test(tmp, time_limit=0.5, client=None, kv=None,
                  faults=("partition", "kill", "pause"), interval=0.1,
                  accelerator="cpu", device="cpu", checker_=None):
    """The etcd suite's fake register test map (compose_test and
    build_suite_test's fake branch, jepsen_tpu/suites/__init__.py:22-186)
    over the port."""
    kv = kv or KVStore()
    base = {"name": "etcd-register", "nodes": ["n1", "n2", "n3", "n4", "n5"],
            "concurrency": 5, "time_limit": time_limit,
            "ssh": {"dummy": True}, "store_dir": tmp, "db": kv,
            "client": client or KVClient(kv), "os": None, "net": NoopNet()}
    wl = register.workload(base, accelerator=accelerator, device=device)
    pkg = combined.nemesis_package({"db": kv, "faults": set(faults),
                                    "interval": interval})
    test = dict(base)
    main = gen.time_limit(time_limit, gen.any_gen(
        gen.clients(wl["generator"]), gen.nemesis_gen(pkg["generator"])))
    test["generator"] = gen.phases(main,
                                   gen.nemesis_gen(pkg["final_generator"]))
    test["checker"] = checker_ or checker.compose({
        "stats": checker.stats(), "exceptions": checker.unhandled_exceptions(),
        "workload": wl["checker"]})
    test["nemesis"] = pkg["nemesis"]
    return test


def _stored_history(result, tmp):
    """The run's stored history.jsonl, indexed as analyze indexes it."""
    from jepsen_tpu_torch.history import index
    return index(store.load_history(result["name"], result["start_time"],
                                    tmp))


def _jax_independent_check(history):
    from jepsen_tpu import independent as jind
    from jepsen_tpu.checker.linearizable import linearizable as jlin
    return jind.checker(jlin(accelerator="cpu")).check({}, history, {})


def _verdicts(res, history):
    """The result map's verdict, its invalid keys, and each key's verdict
    and failed op (its history index). A key the batched lane settled
    names its failed op by ``explain``'s ``first-anomaly-op``, a position
    in the key's sub-history; the rung names differ between the packages
    (ROADMAP Queue 3)."""
    keys = {str(k): k for k in independent.history_keys(history)}
    per_key = {}
    for sk, r in (res.get("results") or {}).items():
        op = r.get("failed-op")
        first = (r.get("explain") or {}).get("first-anomaly-op")
        if op is None and first is not None:
            op = independent.subhistory(keys[sk], history)[first]
        per_key[sk] = (r.get("valid?"), None if op is None
                       else op.get("index"))
    return res.get("valid?"), sorted(map(str, res.get("failures") or [])), \
        per_key


def test_run_history_checked_by_reference_gives_port_result():
    """A port run of the fake register test; its stored history, checked
    by the JAX package's ``independent.checker`` over ``linearizable`` on
    the CPU, gives the port's verdicts key by key."""
    with tempfile.TemporaryDirectory() as tmp:
        test = register_test(tmp, checker_=independent.checker(
            linearizable(accelerator="cpu")))
        result = core.run(test)
        mine = result["results"]
        assert mine["valid?"] is True, mine
        history = _stored_history(result, tmp)
        assert len(history) == len(result["history"]) > 100
        assert _verdicts(_jax_independent_check(history), history) == \
            _verdicts(mine, history)
        names = set(os.listdir(store.test_dir(result)))
        assert {"history.jsonl", "results.json", "test.json",
                "faults.jsonl"} <= names
        assert "history.wal.jsonl" not in names
        rows = faults_mod.load_rows(store.path(result, "faults.jsonl"))
        kinds = {r["kind"] for r in rows if r["op"] == "inject"}
        assert kinds <= {"net", "process", "pause"} and kinds, rows
        assert not faults_mod.FaultRegistry(
            store.path(result, "faults.jsonl")).unhealed()


def test_stale_read_run_gives_reference_invalid_keys():
    """The stale-read double (one read in 20 answers with a key's
    previous value): the run is invalid, and the JAX package's checker
    finds the same invalid keys, failing at the same ops."""
    with tempfile.TemporaryDirectory() as tmp:
        kv = KVStore()
        test = register_test(tmp, kv=kv, client=stale_client(kv, 20, 5),
                             time_limit=0.6, checker_=independent.checker(
                                 linearizable(accelerator="cpu")))
        result = core.run(test)
        mine = result["results"]
        assert mine["valid?"] is False and mine["failures"], mine
        history = _stored_history(result, tmp)
        assert _verdicts(_jax_independent_check(history), history) == \
            _verdicts(mine, history)
        # the port's device lane (its plain kernels on the CPU) agrees
        again = independent.checker(linearizable(
            accelerator="gpu", device="cpu")).check({}, history, {})
        assert _verdicts(again, history) == _verdicts(mine, history)


_KILLED_RUN = """
import sys, time
import jepsen_tpu_torch.generator as gen
from jepsen_tpu_torch import checker, core, nemesis
from jepsen_tpu_torch.fakes import AtomClient, AtomDB, noop_test
db = AtomDB()
core.run(noop_test(
    name="killed", db=db, client=AtomClient(db), concurrency=2,
    store_dir=sys.argv[1], start_time="t0",
    nemesis=nemesis.partition_random_halves(),
    generator=gen.phases(
        gen.nemesis_gen(gen.once(gen.repeat({"f": "start-partition"}))),
        gen.clients(gen.time_limit(60, gen.stagger(
            0.05, gen.repeat({"f": "read"})))),
        gen.nemesis_gen(gen.once(gen.repeat({"f": "stop-partition"})))),
    checker=checker.unbridled_optimism()))
"""


def test_killed_run_leaves_faults_that_replay_heals():
    """A run SIGKILLed between its partition's start and stop leaves a
    faults.jsonl with the window open; replay_unhealed heals it once (the
    net's heal on the dummy remote), and a second replay is a no-op."""
    with tempfile.TemporaryDirectory() as tmp:
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.Popen([sys.executable, "-c", _KILLED_RUN, tmp],
                                cwd=ROOT, env=env,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        path = Path(tmp) / "killed" / "t0" / faults_mod.FAULTS_NAME
        try:
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                if path.exists() and "inject" in path.read_text():
                    break
                assert proc.poll() is None, "the run ended early"
                time.sleep(0.05)
            time.sleep(0.2)  # a few client ops after the injection
        finally:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)
        wal = path.parent / "history.wal.jsonl"
        assert not (path.parent / "history.jsonl").exists()
        # the journal's prefix, read alike by the port's readers and the
        # JAX package's: the partition's invocation and client ops
        from jepsen_tpu import journal as jjournal
        from jepsen_tpu_torch import journal
        rows, truncated = journal.read_wal(wal)
        assert (rows, truncated) == jjournal.read_wal(wal)
        assert journal.WalTailer(wal).finalize() == \
            jjournal.WalTailer(wal).finalize() == rows
        assert rows[0]["f"] == "start-partition"
        assert sum(op["f"] == "read" and op["type"] == "ok"
                   for op in rows) >= 1
        reg = faults_mod.FaultRegistry(path)
        actionable, evidence = faults_mod.actionable_unhealed(reg)
        assert [r["kind"] for r in actionable] == ["net"] and not evidence
        test = json.loads((path.parent / "test.json").read_text())
        assert test["ssh"] == {"dummy": True}
        out = faults_mod.replay_unhealed(test, reg, rng=random.Random(0))
        assert out == {"healed": [0], "unhealable": [], "failed": []}
        assert test["_net_log"] == [("heal",)]
        assert faults_mod.replay_unhealed(test, reg)["healed"] == []
        reg.close()
        rows = faults_mod.load_rows(path)
        assert [(r["op"], r.get("via")) for r in rows] == \
            [("inject", None), ("heal", "replay")]


@pytest.mark.cuda
def test_fake_register_run_launches_matrix_kernels_on_card(monkeypatch):
    """Phase 20a's test map at a 1 s time limit on the card: valid, and
    the analysis launched the chunk-product and combine kernels (the
    screen's return threshold lowered: a 1 s run holds about as many
    returns as the 2,000 it needs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from jepsen_tpu_torch.ops import jitlin
    from jepsen_tpu_torch.ops import matrix_kernels as mk
    monkeypatch.setattr(jitlin, "MATRIX_MIN_RETURNS", 10)
    with tempfile.TemporaryDirectory() as tmp:
        test = register_test(tmp, time_limit=1.0, interval=1.0,
                             accelerator="gpu", device=None)
        mk.chunk_product.launches = mk.combine_product.launches = 0
        result = core.run(test)
        assert result["results"]["valid?"] is True, result["results"]
        assert mk.chunk_product.launches >= 1
        assert mk.combine_product.launches >= 1


# (test map fields, status file fields or None, checker): the live
# daemon's final verdict is reused only when it is fresh and the checker
# is a bare linearizable one over a register workload
_FRESH = {"state": "final", "workload": "register", "ops_absorbed": 4,
          "results": {"valid?": False, "failed-op-index": 2,
                      "anomaly-types": ["stale-read"]}}
LIVE_REUSE = {
    "fresh": ({"live_reuse": True}, {}, "lin"),
    "reuse-off": ({}, {}, "lin"),
    "recovered": ({"live_reuse": True, "wal_recovered": True}, {}, "lin"),
    "no-status": ({"live_reuse": True}, None, "lin"),
    "tailing": ({"live_reuse": True}, {"state": "tailing"}, "lin"),
    "stale": ({"live_reuse": True}, {"ops_absorbed": 3}, "lin"),
    "no-verdict": ({"live_reuse": True}, {"results": {"n": 1}}, "lin"),
    "other-workload": ({"live_reuse": True},
                       {"workload": "register-independent"}, "lin"),
    "composed-checker": ({"live_reuse": True}, {}, "compose"),
}


@pytest.mark.parametrize("case", sorted(LIVE_REUSE))
def test_live_final_results_matches_reference(tmp_path, case):
    """``core._live_final_results`` over a run directory's
    ``live-status.json``, against the JAX package's on the same file:
    the same reuse or refusal; a reused verdict also through the port's
    ``core.analyze``."""
    from jepsen_tpu import checker as jchecker
    from jepsen_tpu import core as jcore
    from jepsen_tpu.checker.linearizable import linearizable as jlin
    from jepsen_tpu_torch.live.daemon import LIVE_STATUS_NAME
    fields, status, which = LIVE_REUSE[case]
    test = {"name": "reg", "start_time": "t0", "store_dir": str(tmp_path),
            "history": [{"type": t, "f": "read", "process": 0,
                         "value": None} for t in ("invoke", "ok") * 2],
            **fields}
    if status is not None:
        store.path_mk(test, LIVE_STATUS_NAME).write_text(
            json.dumps({**_FRESH, **status}))
    checkers = {
        "lin": (linearizable(accelerator="cpu"), jlin(accelerator="cpu")),
        "compose": (checker.compose({"l": linearizable(accelerator="cpu")}),
                    jchecker.compose({"l": jlin(accelerator="cpu")}))}
    mine, theirs = checkers[which]
    got = core._live_final_results(test, mine)
    assert got == jcore._live_final_results(test, theirs)
    assert (got is not None) is (case == "fresh")
    if got is not None:
        assert got == {**_FRESH["results"], "live-reused": True}
        assert core.analyze(dict(test, checker=mine))["results"] == got
