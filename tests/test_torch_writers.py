"""The run's durable writers against the JAX package's, on the same inputs
at tolerance zero: the write-ahead journal (``journal.Journal``) and the
forensic log (``ForensicLog``), the fault registry's inject and heal rows
(``nemesis.faults.FaultRegistry``) and its heal replay, and the store's
writers (``serializable_test``, ``write_results``, ``write_test``,
``save_1``, ``save_2``, ``update_symlinks``). Each case feeds the same
ops, test map and fault events, under one fixed clock, to both packages'
writers and compares the files byte for byte (``history.npz`` array by
array). The WAL the port's ``Journal`` writes is read back by the port's
``read_wal`` and ``WalTailer`` and by the JAX package's, and tailed by
both packages' live daemons, whose final verdict ``core.analyze`` then
reuses."""
from __future__ import annotations

import itertools
import json
import random
import time
from pathlib import Path

import numpy as np
import pytest

import jepsen_tpu.db as jdb
import jepsen_tpu.fakes as jfakes
import jepsen_tpu.journal as jjournal
import jepsen_tpu.net as jnet
import jepsen_tpu.nemesis.faults as jfaults
import jepsen_tpu.store as jstore
import jepsen_tpu_torch.db as tdb
import jepsen_tpu_torch.fakes as tfakes
import jepsen_tpu_torch.journal as tjournal
import jepsen_tpu_torch.net as tnet
import jepsen_tpu_torch.nemesis.faults as tfaults
import jepsen_tpu_torch.store as tstore
from jepsen_tpu_torch.histories import (corrupt_reads,
                                        independent_register_history,
                                        register_history)
from jepsen_tpu_torch.history import index

JAX = {"journal": jjournal, "faults": jfaults, "store": jstore,
       "fakes": jfakes, "net": jnet, "db": jdb}
PORT = {"journal": tjournal, "faults": tfaults, "store": tstore,
        "fakes": tfakes, "net": tnet, "db": tdb}
SIDES = (("port", PORT), ("jax", JAX))
NODES = ["n1", "n2", "n3", "n4", "n5"]


@pytest.fixture
def fixed_clock(monkeypatch):
    """``time.time`` as a counter that ``reset()`` restarts, so that each
    package's writer sees the same sequence of stamps."""
    state = {}

    def reset():
        state["it"] = itertools.count(1_760_000_000.0, 0.25)

    reset()
    monkeypatch.setattr(time, "time", lambda: next(state["it"]))
    return reset


class _Unrepresentable:
    def __repr__(self):
        raise RuntimeError("no repr")


def _register_ops() -> list[dict]:
    return index(register_history(120, n_procs=5, seed=21, n_values=5))


def _odd_ops() -> list[dict]:
    """Ops holding every type the serializer converts: sets, tuples,
    numpy scalars, paths, non-string keys, private keys, nested maps;
    one whose value has no repr (dropped by both writers)."""
    rng = np.random.default_rng(7)
    ops = []
    for i in range(40):
        v = int(rng.integers(0, 9))
        ops.append({"type": ("invoke", "ok", "info", "fail")[i % 4],
                    "process": "nemesis" if i % 5 == 0 else i % 3,
                    "f": ("read", "write", "cas", "start-partition")[i % 4],
                    "value": [("k", v), {v, v + 1}, np.int64(v),
                              np.float32(v / 4), Path(f"/n{v}"), None],
                    "time": i * 1000 + v, "index": i,
                    "extra": {1: "one", "_hidden": 2, "nest": (v,)},
                    "_private": "dropped"})
    ops.insert(17, {"type": "invoke", "process": 0, "f": "read",
                    "value": _Unrepresentable(), "time": 17_500})
    return ops


OP_SETS = {"register": _register_ops, "odd": _odd_ops}


def _per_op(journal, ops):
    for op in ops:
        journal.append(op)
        yield


def _batched(journal, ops):
    for lo in range(0, len(ops), 7):
        journal.append_many(ops[lo:lo + 7])
        yield


def _mixed(journal, ops):
    for lo in range(0, len(ops), 5):
        if (lo // 5) % 2:
            journal.append_many(ops[lo:lo + 5])
        else:
            for op in ops[lo:lo + 5]:
                journal.append(op)
        yield


WRITES = {"per-op": _per_op, "batched": _batched, "mixed": _mixed}


@pytest.mark.parametrize("writes", sorted(WRITES))
@pytest.mark.parametrize("ops", sorted(OP_SETS))
def test_journal_writes_reference_wal_and_both_readers_read_it(
        tmp_path, ops, writes):
    """The same ops through both packages' ``Journal``, step by step:
    the WALs are equal byte for byte after every step; the port's WAL,
    tailed as it grows by the port's ``WalTailer`` and the JAX
    package's, gives the same ops each poll, and all of them read back
    through both ``read_wal``s."""
    ops = OP_SETS[ops]()
    paths = {s: tmp_path / s / tjournal.WAL_NAME for s, _ in SIDES}
    journals = {s: m["journal"].Journal(paths[s], fsync_interval_s=0)
                for s, m in SIDES}
    steps = {s: WRITES[writes](journals[s], ops) for s, _ in SIDES}
    port_tail = tjournal.WalTailer(paths["port"])
    jax_tail = jjournal.WalTailer(paths["port"])
    tailed = []
    for _ in itertools.zip_longest(steps["port"], steps["jax"]):
        assert paths["port"].read_bytes() == paths["jax"].read_bytes()
        got = port_tail.poll()
        assert got == jax_tail.poll()
        tailed.extend(got)
    for j in journals.values():
        j.close()
    assert journals["port"].appended == journals["jax"].appended
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    assert port_tail.finalize() == jax_tail.finalize() == []
    rows, truncated = tjournal.read_wal(paths["port"])
    assert (rows, truncated) == jjournal.read_wal(paths["port"])
    assert not truncated and tailed == rows
    dropped = 1 if ops and any(isinstance(op.get("value"), _Unrepresentable)
                               for op in ops) else 0
    assert len(rows) == len(ops) - dropped
    assert rows == [json.loads(json.dumps(tstore._serializable(op)))
                    for op in ops
                    if not isinstance(op.get("value"), _Unrepresentable)]


def test_journal_torn_tail_reads_alike(tmp_path):
    """A WAL the port's journal wrote, cut mid-line as a killed writer
    leaves it: both packages' readers drop the torn line alike."""
    path = tmp_path / tjournal.WAL_NAME
    j = tjournal.Journal(path, fsync_interval_s=None)
    j.append_many(_register_ops()[:30])
    j.close()
    data = path.read_bytes()
    path.write_bytes(data[:-9])
    want = tjournal.read_wal(path)
    assert want == jjournal.read_wal(path)
    assert want[1] is True and len(want[0]) == 29
    port_tail, jax_tail = (tjournal.WalTailer(path),
                           jjournal.WalTailer(path))
    assert port_tail.poll() == jax_tail.poll() == want[0]
    assert port_tail.finalize() == jax_tail.finalize() == []
    assert port_tail.truncated_tail is jax_tail.truncated_tail is True


@pytest.mark.parametrize("n_rows", [0, 1, 12])
def test_forensic_log_matches_reference(tmp_path, n_rows):
    """Quarantined late completions through both ``ForensicLog``s: the
    same ``late.jsonl`` bytes, and no file at all when nothing came."""
    rows = [{"op": op, "worker": i % 3, "generation": i,
             "reaped-at": 1_000 + i, "_tid": i}
            for i, op in enumerate(_odd_ops()[:n_rows])]
    out = {}
    for s, m in SIDES:
        log = m["journal"].ForensicLog(tmp_path / s / tjournal.LATE_NAME)
        for r in rows:
            log.append(r)
        log.close()
        out[s] = (log.appended, log.path.read_bytes()
                  if log.path.exists() else None)
    assert out["port"] == out["jax"]
    assert (out["port"][1] is None) is (n_rows == 0)


# -- the fault registry ------------------------------------------------------

def _inject_heal(reg):
    a = reg.record("net", "start-partition",
                   ["isolated", {"n1": ["n2", "n3"], "n2": ("n1",)}])
    return [a, reg.mark_healed(kind="net")]


def _by_id(reg):
    a = reg.record("process", "kill", ["n1", "n2"])
    b = reg.record("pause", "pause", {"n3"})
    return [a, b, reg.mark_healed(fault_id=a), reg.mark_healed(fault_id=a),
            reg.mark_healed(fault_id=99)]


def _by_kinds(reg):
    ids = [reg.record(k, f, v) for k, f, v in (
        ("net", "start-partition", "majority"),
        ("process", "kill", ["n4"]), ("pause", "pause", ["n5"]),
        ("file", "truncate-file", {"node": "n1", "drop": 3}))]
    return ids + [reg.mark_healed(kinds={"process", "pause"})]


def _all(reg):
    ids = [reg.record(k) for k in ("net", "process", "pause")]
    return ids + [reg.mark_healed(), reg.mark_healed()]


EVENTS = {"inject-heal": _inject_heal, "by-id": _by_id,
          "by-kinds": _by_kinds, "all": _all}


@pytest.mark.parametrize("reopen", [False, True])
@pytest.mark.parametrize("events", sorted(EVENTS))
def test_fault_registry_rows_match_reference(tmp_path, fixed_clock, events,
                                             reopen):
    """The same fault events, under one fixed clock, through both
    packages' ``FaultRegistry``: the same ids returned, the same
    ``faults.jsonl`` bytes, the same unhealed and actionable rows. With
    ``reopen`` the registry is closed after the events and a new one
    loads the file and goes on (its next id, a heal of what is left)."""
    out = {}
    for s, m in SIDES:
        fixed_clock()
        path = tmp_path / s / tfaults.FAULTS_NAME
        reg = m["faults"].FaultRegistry(path)
        got = EVENTS[events](reg)
        if reopen:
            reg.close()
            reg = m["faults"].FaultRegistry(path)
            got += [reg.record("pause", "pause", ["n2"]),
                    reg.unhealed(), reg.mark_healed(kind="net")]
        got += [reg.unhealed(), m["faults"].actionable_unhealed(reg)]
        reg.close()
        out[s] = (got, path.read_bytes(), m["faults"].load_rows(path))
    assert out["port"] == out["jax"]
    assert out["port"][2], out["port"]


def _replay_map(m, live: str) -> dict:
    test = {"name": "replay", "nodes": list(NODES), "ssh": {"dummy": True}}
    if live == "live":
        test["db"] = m["fakes"].KVStore()
        test["net"] = m["net"].NoopNet()
    elif live == "no-process-db":
        test["db"] = m["db"].NoopDB()
    return test


@pytest.mark.parametrize("live", ["live", "serialized", "no-process-db"])
def test_replay_unhealed_matches_reference(tmp_path, fixed_clock, live):
    """An unhealed net, process, pause and file fault, healed by both
    packages' ``replay_unhealed`` over their own doubles: with a live
    test map (each heal acts), a serialized one (the net rebuilt for the
    dummy remote; kill and pause unhealable) and a db that cannot start
    or resume. The same verdicts, rows, and heal actions; a second
    replay heals nothing."""
    out = {}
    for s, m in SIDES:
        fixed_clock()
        path = tmp_path / s / tfaults.FAULTS_NAME
        reg = m["faults"].FaultRegistry(path)
        _by_kinds(reg)
        reg.record("process", "kill", ["n1"])
        reg.mark_healed(kinds={"process", "pause"})
        reg.record("process", "kill", ["n2"])
        reg.record("pause", "pause", ["n3"])
        test = _replay_map(m, live)
        first = m["faults"].replay_unhealed(test, reg, rng=random.Random(0))
        second = m["faults"].replay_unhealed(test, reg, rng=random.Random(0))
        reg.close()
        db = test.get("db")
        actions = (sorted(db.log) if hasattr(db, "log") else None,
                   test.get("_net_log"))
        out[s] = (first, second, actions, path.read_bytes())
    assert out["port"] == out["jax"]
    first, second, actions, _ = out["port"]
    assert first["healed"] and first["unhealable"]
    assert second["healed"] == []
    if live == "live":
        assert actions[0] == sorted([("db-start", n) for n in NODES]
                                    + [("db-resume", n) for n in NODES])
        assert actions[1] == [("heal",)]


# -- the store's writers -----------------------------------------------------

HISTORIES = {
    "register": lambda: register_history(200, n_procs=5, seed=3,
                                          n_values=5),
    "invalid": lambda: corrupt_reads(register_history(
        200, n_procs=5, seed=3, n_values=5), n=2, seed=1),
    "keys": lambda: independent_register_history(4, 60, seed=1301),
}


def _store_map(m, root: Path, history) -> dict:
    kv = m["fakes"].KVStore()
    return {
        "name": "etcd-register", "start_time": "20260101T000000.000",
        "store_dir": str(root), "nodes": ["n1", "n2", "n3"],
        "concurrency": 5, "time_limit": 10.0, "ssh": {"dummy": True},
        "db": kv, "client": m["fakes"].KVClient(kv),
        "net": m["net"].NoopNet(), "os": None, "checker": object(),
        "generator": object(), "nemesis": object(),
        "faults": {"pause", "kill", "partition"}, "tags": ("fake", 1),
        "seed": np.int64(5), "rate": np.float64(0.5),
        "path": Path("/var/lib/etcd"), "nested": {1: {"a": (1, 2)},
                                                  "_no": 3},
        "_journal": object(), "history": [dict(op) for op in history],
        "results": {"valid?": False, "failures": {"k2", "k1"},
                    "stats": {"count": np.int64(len(history)),
                              "by-f": {"read": (1, 2)}},
                    "_internal": 1, "anomalies": [{"op": history[0]}]},
    }


def _npz(path: Path) -> dict:
    with np.load(path, allow_pickle=True) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("history", sorted(HISTORIES))
def test_store_writers_match_reference(tmp_path, history):
    """One test map, with every type the serializer converts and every
    key it drops, through both packages' ``save_1`` then ``save_2``:
    ``serializable_test`` equal, and ``history.jsonl``, ``history.txt``,
    ``test.json`` (after each save) and ``results.json`` equal byte for
    byte; ``history.npz`` holds the same arrays; ``latest`` and
    ``current`` point at the run directory; each package's
    ``load_test`` reads the port's files as the port's does. Both write
    under one store path (the test map holds it), moved aside after
    each package's turn."""
    h = index(HISTORIES[history]())
    out = {}
    for s, m in SIDES:
        st = m["store"]
        test = _store_map(m, tmp_path / "store", h)
        files = {"serializable": st.serializable_test(test)}
        st.save_1(test)
        d = st.test_dir(test)
        files["test.json@1"] = (d / "test.json").read_bytes()
        test["results"]["stats"]["extra"] = {"after": 1}
        st.save_2(test)
        for name in ("history.jsonl", "history.txt", "test.json",
                     "results.json"):
            files[name] = (d / name).read_bytes()
        files["npz"] = _npz(d / "history.npz")
        base = Path(test["store_dir"])
        assert (base / test["name"] / "latest").resolve() == d.resolve()
        assert (base / "current").resolve() == d.resolve()
        base.rename(tmp_path / s)
        out[s] = files
    npz = out["port"].pop("npz"), out["jax"].pop("npz")
    assert out["port"] == out["jax"]
    assert sorted(npz[0]) == sorted(npz[1])
    for k in npz[0]:
        assert npz[0][k].dtype == npz[1][k].dtype, k
        assert np.array_equal(npz[0][k], npz[1][k]), k
    name, ts = "etcd-register", "20260101T000000.000"
    mine = tstore.load_test(name, ts, str(tmp_path / "port"))
    theirs = jstore.load_test(name, ts, str(tmp_path / "port"))
    assert mine["history"] == theirs["history"] == \
        [json.loads(json.dumps(tstore._serializable(op))) for op in h]
    assert mine["results"] == theirs["results"]


# -- the WAL, tailed by both live daemons ------------------------------------

@pytest.fixture
def one_thread_rates():
    """One torch thread, and both packages' measured CPU rates (which
    the daemons feed) restored after the test."""
    import sys

    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    names = ("jepsen_tpu_torch.parallel.pipeline",
             "jepsen_tpu.parallel.pipeline")
    saved = {m: dict(sys.modules[m]._CPU_RATE) for m in names
             if m in sys.modules}
    yield
    torch.set_num_threads(n)
    for m in names:
        if m in sys.modules:
            sys.modules[m]._CPU_RATE.clear()
            sys.modules[m]._CPU_RATE.update(saved.get(m, {}))


def test_journal_wal_tailed_by_both_daemons_and_reused(tmp_path,
                                                       one_thread_rates):
    """A register run's ops through each package's ``Journal`` in
    chunks, with each package's live daemon polling its store between
    chunks; ``write_history`` completes the run. Every poll's statuses
    are equal, the final verdict is the offline check's, and the port's
    ``core.analyze`` with ``live_reuse`` adopts it as the JAX package's
    ``_live_final_results`` does."""
    from jepsen_tpu.core import _live_final_results as ref_reuse
    from jepsen_tpu.checker.linearizable import linearizable as jlin
    from jepsen_tpu.live.daemon import LiveDaemon as RefDaemon
    from jepsen_tpu_torch import core
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.live.daemon import LiveDaemon, load_live_status
    h = index(corrupt_reads(register_history(300, n_procs=5, seed=11,
                                             n_values=5), n=1, seed=4))
    tests, journals, daemons = {}, {}, {}
    for s, m in SIDES:
        tests[s] = {"name": "reg", "start_time": "20260101T000000.000",
                    "store_dir": str(tmp_path / s), "history": h}
        journals[s] = m["journal"].Journal(
            m["journal"].wal_path(tests[s]), fsync_interval_s=None)
    daemons["port"] = LiveDaemon(store_root=str(tmp_path / "port"),
                                 accelerator="cpu", device="cpu", poll_s=0.0)
    daemons["jax"] = RefDaemon(store_root=str(tmp_path / "jax"),
                               accelerator="cpu", poll_s=0.0)
    skip = ("lag_s", "updated", "backend")
    for lo in range(0, len(h), 100):
        polls = {}
        for s, _ in SIDES:
            journals[s].append_many(h[lo:lo + 100])
            polls[s] = daemons[s].poll_once()
        assert {k: {f: v for f, v in st.items() if f not in skip}
                for k, st in polls["port"].items()} == \
            {k: {f: v for f, v in st.items() if f not in skip}
             for k, st in polls["jax"].items()}
    for s, m in SIDES:
        journals[s].close()
        m["store"].write_history(tests[s])
        daemons[s].run_until_idle(timeout_s=60)
    status = load_live_status(tstore.test_dir(tests["port"]))
    assert status["state"] == "final" and status["ops_absorbed"] == len(h)
    offline = linearizable(accelerator="cpu", device="cpu").check(
        {}, h, {"explain": False})
    assert status["results"]["valid?"] is offline["valid?"] is False
    test = dict(tests["port"], live_reuse=True,
                checker=linearizable(accelerator="cpu", device="cpu"))
    res = core.analyze(test)["results"]
    want = ref_reuse(dict(tests["jax"], live_reuse=True),
                     jlin(accelerator="cpu"))
    assert res["live-reused"] is want["live-reused"] is True
    assert {k: v for k, v in res.items() if k not in skip} == \
        {k: v for k, v in want.items() if k not in skip}
