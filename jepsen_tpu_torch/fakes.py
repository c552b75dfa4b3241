"""In-memory test doubles: a CAS register over a locked cell, with a meta-log
of lifecycle calls (the port of jepsen_tpu/fakes.py: the doubles the run
loop's tests and the register workload use; ``KVStore``/``KVClient``
carry the lifted register's read, write and cas, and their other fs come
with their workloads).

Reference: jepsen/src/jepsen/tests.clj:27-67 (atom-db / atom-client), the
backbone of cluster-free integration tests of the full run lifecycle
(core_test.clj basic-cas-test et al., SURVEY.md §4 tier 2).
"""
from __future__ import annotations

import threading
from typing import Any

from jepsen_tpu_torch import db as db_mod
from jepsen_tpu_torch.client import Client

# copied from jepsen_tpu/fakes.py:20-131


class MetaLogDB(db_mod.NoopDB, db_mod.Process, db_mod.Pause):
    """Base for in-memory 'clusters': a data lock plus a meta-log of
    lifecycle calls for assertions. Subclasses override ``_wipe`` to clear
    their data under the lock on teardown.

    Implements Process/Pause as meta-logged no-ops so fake-mode tests can
    schedule kill/pause nemesis packages end to end (an in-memory store
    has no process to kill, but the fault plumbing all runs)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.log: list[tuple] = []
        self._log_lock = threading.Lock()

    def _note(self, *event):
        with self._log_lock:
            self.log.append(event)

    def _wipe(self):
        pass

    def setup(self, test, node):
        self._note("db-setup", node)

    def teardown(self, test, node):
        with self.lock:
            self._wipe()
        self._note("db-teardown", node)

    def start(self, test, node):
        self._note("db-start", node)

    def kill(self, test, node):
        self._note("db-kill", node)

    def pause(self, test, node):
        self._note("db-pause", node)

    def resume(self, test, node):
        self._note("db-resume", node)


class AtomDB(MetaLogDB):
    """An in-memory 'cluster': one locked cell shared by all clients
    (tests.clj:27-44 atom-db)."""

    def __init__(self):
        super().__init__()
        self.value: Any = None

    def _wipe(self):
        self.value = None

    # register primitives used by AtomClient
    def read(self):
        with self.lock:
            return self.value

    def write(self, v):
        with self.lock:
            self.value = v

    def cas(self, old, new) -> bool:
        with self.lock:
            if self.value == old:
                self.value = new
                return True
            return False


class MetaLogClient(Client):
    """Base for clients over a MetaLogDB: records open/setup/teardown/close
    in the db's meta-log (tests.clj atom-client lifecycle shape)."""

    def __init__(self, db: MetaLogDB, node: str | None = None):
        self.db = db
        self.node = node

    def open(self, test, node):
        c = type(self)(self.db, node)
        self.db._note("client-open", node)
        return c

    def setup(self, test):
        self.db._note("client-setup", self.node)

    def teardown(self, test):
        self.db._note("client-teardown", self.node)

    def close(self, test):
        self.db._note("client-close", self.node)


class AtomClient(MetaLogClient):
    """CAS-register client over an AtomDB (tests.clj atom-client)."""

    def supported_fs(self, test):
        return {"read", "write", "cas"}

    def invoke(self, test, op):
        f, v = op.get("f"), op.get("value")
        if f == "read":
            return {**op, "type": "ok", "value": self.db.read()}
        if f == "write":
            self.db.write(v)
            return {**op, "type": "ok"}
        if f == "cas":
            old, new = v
            ok = self.db.cas(old, new)
            return {**op, "type": "ok" if ok else "fail"}
        return {**op, "type": "fail", "error": ["unknown-f", f]}



# copied from jepsen_tpu/fakes.py:133-193, :493-727: the registers and the
# register arm of KVClient.invoke
class KVStore(MetaLogDB):
    """In-memory many-key 'cluster': a dict of CAS registers — the surface
    of the independent-lifted register workload that suites run in
    --fake mode."""

    def __init__(self):
        super().__init__()
        self.registers: dict = {}

    def _wipe(self):
        self.registers.clear()

    def read(self, k):
        with self.lock:
            return self.registers.get(k)

    def write(self, k, v):
        with self.lock:
            self.registers[k] = v

    def cas(self, k, old, new) -> bool:
        with self.lock:
            if self.registers.get(k) == old:
                self.registers[k] = new
                return True
            return False


class KVClient(MetaLogClient):
    """Client over a KVStore speaking the independent-lifted register
    protocol ([k, v] tuple values, independent.clj:21-29)."""

    SUPPORTED_FS = frozenset({"read", "write", "cas"})

    def supported_fs(self, test):
        return set(self.SUPPORTED_FS)

    def invoke(self, test, op):
        f, v = op.get("f"), op.get("value")
        if f == "read":
            k, _ = v
            return {**op, "type": "ok", "value": [k, self.db.read(k)]}
        if f == "write":
            k, val = v
            self.db.write(k, val)
            return {**op, "type": "ok"}
        if f == "cas":
            k, (old, new) = v
            ok = self.db.cas(k, old, new)
            return {**op, "type": "ok" if ok else "fail"}
        return {**op, "type": "fail", "error": ["unknown-f", f]}


# copied from jepsen_tpu/fakes.py:866-904
class CrashingClient(Client):
    """Always raises — exercises the interpreter's indeterminate-op path
    (core_test.clj worker-recovery-test)."""

    def __init__(self):
        self.invocations = 0
        self._lock = threading.Lock()

    def open(self, test, node):
        return self

    def invoke(self, test, op):
        with self._lock:
            self.invocations += 1
        raise RuntimeError("client crashed (as designed)")

    def close(self, test):
        pass


def noop_test(**overrides) -> dict:
    """Default test map (reference: jepsen/src/jepsen/tests.clj:12-25 noop-test).
    A test is plain data; suites merge over these defaults."""
    from jepsen_tpu_torch import checker
    test = {
        "name": "noop",
        "nodes": ["n1", "n2", "n3", "n4", "n5"],
        "concurrency": 5,
        "ssh": {"dummy": True},
        "os": None,
        "db": db_mod.NoopDB(),
        "client": None,
        "nemesis": None,
        "generator": None,
        "checker": checker.unbridled_optimism(),
        "time_limit": 60,
    }
    test.update(overrides)
    return test
