"""In-memory test doubles: a CAS register over a locked cell, with a meta-log
of lifecycle calls (the port of jepsen_tpu/fakes.py: the doubles of the run
loop's tests and of every workload's fake mode; ``FakeClusterState``, the
membership state, waits for the membership nemesis, ROADMAP Queue 1
item 11).

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



# copied from jepsen_tpu/fakes.py:133-727: the store and the client of
# every workload
class KVStore(MetaLogDB):
    """In-memory many-key 'cluster': a dict of CAS registers plus a grow-only
    set — enough surface for the register (independent-lifted) and set
    workloads that suites run in --fake mode."""

    def __init__(self):
        super().__init__()
        self.registers: dict = {}
        self.elements: set = set()
        self.lists: dict = {}
        self.accounts: dict = {}   # bank workload balances
        self.rows: dict = {}       # dirty-reads workload rows
        self.mono: list = []       # monotonic workload (val, ts) rows
        self.seq: set = set()      # sequential workload subkeys
        self.adya: dict = {}       # adya G2 pair -> (cell, uid)
        self.holder = None         # mutex workload: current lock holder
        self.counter = 0           # counter workload
        self.ddl_rows: list | None = None  # default-value table (None=absent)
        self.ddl_next = 0
        self.cmt: dict = {}        # comments workload: key -> set of ids
        self.tables: set = set()   # table workload: created table ids
        self.lu: dict = {}         # lost-updates workload: key -> set
        self.mono_keys: dict = {}  # monotonic-key pool (tidb inc-workload)
        self.ledger: dict = {}     # ledger workload: account -> balance
        self.del_records: dict = {}  # delete workload: key -> uid
        self.del_next = 0

    def _wipe(self):
        self.registers.clear()
        self.elements.clear()
        self.lists.clear()
        self.accounts.clear()
        self.rows.clear()
        self.mono.clear()
        self.seq.clear()
        self.adya.clear()
        self.holder = None
        self.counter = 0
        self.ddl_rows = None
        self.ddl_next = 0
        self.cmt.clear()
        self.tables.clear()
        self.lu.clear()
        self.mono_keys.clear()
        self.ledger.clear()
        self.del_records.clear()
        self.del_next = 0

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

    def add(self, elem):
        with self.lock:
            self.elements.add(elem)

    def set_read(self) -> list:
        with self.lock:
            return sorted(self.elements)

    def set_read_raw(self) -> set:
        with self.lock:
            return set(self.elements)

    def contains(self, elem) -> bool:
        with self.lock:
            return elem in self.elements

    def txn(self, micro_ops, style: str = "append") -> list:
        """Atomically applies a txn of [f, k, v] micro-ops. ``style``
        picks what a read returns: "append" (the per-key list, Elle
        list-append) or "wr" (the register value, Elle rw-register /
        long-fork)."""
        with self.lock:
            out = []
            for f, k, v in micro_ops:
                if f == "r" and style == "wr":
                    out.append(["r", k, self.registers.get(k)])
                elif f == "r":
                    out.append(["r", k, list(self.lists.get(k, []))])
                elif f == "append":
                    self.lists.setdefault(k, []).append(v)
                    out.append(["append", k, v])
                elif f == "w":
                    self.registers[k] = v
                    out.append(["w", k, v])
                else:
                    raise ValueError(f"unknown micro-op {f!r}")
            return out

    def multi_txn(self, group, micro_ops) -> list:
        """Atomic multi-register txn for one independent key group
        (multi-key-acid): registers live at (group, k)."""
        with self.lock:
            out = []
            for f, k, v in micro_ops:
                if f == "r":
                    out.append(["r", k, self.registers.get((group, k))])
                elif f == "w":
                    self.registers[(group, k)] = v
                    out.append(["w", k, v])
                else:
                    raise ValueError(f"unknown micro-op {f!r}")
            return out

    # default-value workload: one DDL-churned table with an int column
    # whose default is 0 (the fake is anomaly-free: inserts always carry
    # the default, so reads never surface a null)
    def ddl_create(self) -> None:
        with self.lock:
            if self.ddl_rows is None:
                self.ddl_rows = []

    def ddl_drop(self) -> None:
        with self.lock:
            self.ddl_rows = None

    def ddl_insert(self) -> bool:
        with self.lock:
            if self.ddl_rows is None:
                return False
            self.ddl_rows.append({"id": self.ddl_next, "v": 0})
            self.ddl_next += 1
            return True

    def ddl_read(self) -> list | None:
        with self.lock:
            return (None if self.ddl_rows is None
                    else [dict(r) for r in self.ddl_rows])

    # table workload: created-table visibility (the fake is anomaly-free)
    def tbl_create(self, tid) -> None:
        with self.lock:
            self.tables.add(tid)

    def tbl_insert(self, tid) -> bool:
        with self.lock:
            return tid in self.tables

    # upsert workload: at most one record per key (the fake is
    # anomaly-free: creates are idempotent under the lock)
    def upsert_create(self, k) -> None:
        with self.lock:
            self.registers.setdefault(("__upsert__", k), f"u{k}")

    def upsert_read(self, k) -> list:
        with self.lock:
            u = self.registers.get(("__upsert__", k))
            return [u] if u is not None else []

    # version-divergence workload: per-key (value, version) rows — the
    # fake's versions advance atomically, so no version ever diverges
    def vd_write(self, k, val) -> None:
        with self.lock:
            _v, ver = self.registers.get(("__vd__", k), (None, 0))
            self.registers[("__vd__", k)] = (val, ver + 1)

    def vd_read(self, k) -> list:
        with self.lock:
            val, ver = self.registers.get(("__vd__", k), (None, None))
            return [val, ver]

    # pages workload: per-key element groups appended atomically
    def pages_add(self, k, group) -> None:
        with self.lock:
            self.lists.setdefault(("__pages__", k), []).extend(group)

    def pages_read(self, k) -> list:
        with self.lock:
            return sorted(self.lists.get(("__pages__", k), []))

    # lost-updates workload: per-key element sets (the fake applies
    # adds atomically, so no update is ever lost)
    def lu_add(self, k, el) -> None:
        with self.lock:
            self.lu.setdefault(k, set()).add(el)

    def lu_read(self, k) -> list:
        with self.lock:
            return sorted(self.lu.get(k, ()))

    # comments workload: per-key visible-id sets
    def cmt_write(self, k, i) -> None:
        with self.lock:
            self.cmt.setdefault(k, set()).add(i)

    def cmt_read(self, k) -> list:
        with self.lock:
            return sorted(self.cmt.get(k, ()))

    def enqueue(self, v):
        with self.lock:
            self.lists.setdefault("__queue__", []).append(v)

    def dequeue(self):
        """The head element, or None when empty."""
        with self.lock:
            q = self.lists.get("__queue__")
            return q.pop(0) if q else None

    def drain(self) -> list:
        with self.lock:
            q = self.lists.get("__queue__", [])
            out = list(q)
            q.clear()
            return out

    # bank (workloads/bank.py): atomic transfers over an accounts dict
    def bank_init(self, accounts, balance: int):
        with self.lock:
            for a in accounts:
                self.accounts.setdefault(a, balance)

    def bank_read(self) -> dict:
        with self.lock:
            return dict(self.accounts)

    def transfer(self, frm, to, amount: int) -> bool:
        """Atomically moves amount; refuses to overdraw (the reference
        bank clients fail transfers that would go negative)."""
        with self.lock:
            if self.accounts.get(frm, 0) < amount:
                return False
            self.accounts[frm] -= amount
            self.accounts[to] = self.accounts.get(to, 0) + amount
            return True

    # monotonic (workloads/monotonic.py): read-max-insert-max+1 rows
    def mono_inc(self) -> int:
        with self.lock:
            val = (self.mono[-1][0] + 1) if self.mono else 0
            self.mono.append((val, len(self.mono)))
            return val

    def mono_read(self) -> list:
        with self.lock:
            return [[v, ts] for v, ts in self.mono]

    # delete workload (workloads/delete_workload.py, dgraph/delete.clj):
    # key -> uid; reads see the whole record
    def del_upsert(self, k):
        """uid when created, None when already present."""
        with self.lock:
            if k in self.del_records:
                return None
            self.del_next += 1
            self.del_records[k] = f"0x{self.del_next:x}"
            return self.del_records[k]

    def del_delete(self, k):
        with self.lock:
            return self.del_records.pop(k, None)

    def del_read(self, k) -> list:
        with self.lock:
            uid = self.del_records.get(k)
            return [{"uid": uid, "key": k}] if uid is not None else []

    # per-process-monotonic register (workloads/dgraph_sequential.py)
    def seq_reg_inc(self, k) -> int:
        with self.lock:
            v = self.mono_keys.get(("seq", k), 0) + 1
            self.mono_keys[("seq", k)] = v
            return v

    def seq_reg_read(self, k) -> int:
        with self.lock:
            return self.mono_keys.get(("seq", k), 0)

    # monotonic-key (workloads/monotonic_key.py, tidb's inc-workload):
    # per-key increment-only pool, -1 = never written
    def mono_key_inc(self, k) -> int:
        with self.lock:
            v = self.mono_keys.get(k, -1) + 1
            self.mono_keys[k] = v
            return v

    def mono_key_read(self, ks) -> dict:
        with self.lock:
            return {k: self.mono_keys.get(k, -1) for k in ks}

    # ledger (workloads/ledger.py): row-per-transfer balances with a
    # non-negative guard, atomic here so the fake never double-spends
    def ledger_transfer(self, account, amount) -> bool:
        with self.lock:
            balance = self.ledger.get(account, 0)
            if amount < 0 and balance + amount < 0:
                return False
            self.ledger[account] = balance + amount
            return True

    # counter (workloads/counter.py)
    def counter_add(self, delta: int) -> None:
        with self.lock:
            self.counter += delta

    def counter_read(self) -> int:
        with self.lock:
            return self.counter

    # mutex (workloads/mutex.py): one lock, owner-checked release
    def acquire(self, p) -> bool:
        with self.lock:
            if self.holder is None:
                self.holder = p
                return True
            return False

    def release(self, p) -> bool:
        with self.lock:
            if self.holder == p:
                self.holder = None
                return True
            return False

    # adya G2 (workloads/adya.py): insert-if-pair-empty, atomically
    def adya_insert(self, pair, uid, cell) -> bool:
        with self.lock:
            if pair in self.adya:
                return False
            self.adya[pair] = (cell, uid)
            return True

    # sequential (workloads/sequential.py): ordered subkey inserts
    def seq_write(self, sks) -> None:
        with self.lock:
            for sk in sks:
                self.seq.add(sk)

    def seq_read(self, sks) -> list:
        with self.lock:
            return [sk if sk in self.seq else None for sk in sks]

    # dirty-reads (workloads/dirty_reads.py): n rows set atomically
    def rows_init(self, n: int):
        with self.lock:
            for i in range(n):
                self.rows.setdefault(i, -1)

    def write_all_rows(self, x):
        with self.lock:
            for i in self.rows:
                self.rows[i] = x

    def read_all_rows(self) -> list:
        with self.lock:
            return [v for _, v in sorted(self.rows.items())]


class KVClient(MetaLogClient):
    """Client over a KVStore, speaking both the independent-lifted register
    protocol ([k, v] tuple values, independent.clj:21-29) and the set
    workload's add/read ops.

    ``whole_read`` disambiguates what a bare ``{"f": "read", "value":
    None}`` means — "set" (whole-set read, the default), "bank" (all
    balances as a dict), or "dirty" (all dirty-reads rows) — since those
    three workloads share the same op shape."""

    def __init__(self, db: MetaLogDB, node: str | None = None,
                 whole_read: str = "set", txn_style: str = "append"):
        super().__init__(db, node)
        self.whole_read = whole_read
        self.txn_style = txn_style

    def open(self, test, node):
        c = type(self)(self.db, node, self.whole_read, self.txn_style)
        self.db._note("client-open", node)
        return c

    def setup(self, test):
        super().setup(test)
        if self.whole_read == "bank":
            self.db.bank_init(test.get("accounts", range(8)), 10)
        elif self.whole_read == "dirty":
            self.db.rows_init(int(test.get("dirty-rows", 4)))

    # the union of every dispatch arm below — preflight checks
    # generator-emitted :f values against this set before a run starts
    SUPPORTED_FS = frozenset({
        "read", "write", "cas", "add", "txn", "enqueue", "dequeue",
        "drain", "transfer", "insert", "acquire", "release", "inc",
        "read-all", "create-table", "drop-table", "upsert", "read-uids",
        "refresh", "strong-read", "delete",
    })

    def supported_fs(self, test):
        return set(self.SUPPORTED_FS)

    def invoke(self, test, op):
        f, v = op.get("f"), op.get("value")
        if test.get("counter") and f == "add":
            self.db.counter_add(int(v))
            return {**op, "type": "ok"}
        if test.get("counter") and f == "read" and v is None:
            return {**op, "type": "ok", "value": self.db.counter_read()}
        if test.get("txn-mode") == "multi" and f == "txn":
            k, mops = v
            return {**op, "type": "ok",
                    "value": [k, self.db.multi_txn(k, mops)]}
        if test.get("ddl-table"):
            if f == "create-table":
                self.db.ddl_create()
                return {**op, "type": "ok"}
            if f == "drop-table":
                self.db.ddl_drop()
                return {**op, "type": "ok"}
            if f == "insert":
                ok = self.db.ddl_insert()
                return {**op, "type": "ok" if ok else "fail"}
            if f == "read":
                rows = self.db.ddl_read()
                if rows is None:
                    return {**op, "type": "fail", "error": ["no-table"]}
                return {**op, "type": "ok", "value": rows}
        if test.get("table-workload"):
            if f == "create-table":
                self.db.tbl_create(v)
                return {**op, "type": "ok"}
            if f == "insert":
                tid, _k = v
                if self.db.tbl_insert(tid):
                    return {**op, "type": "ok"}
                return {**op, "type": "fail", "error": ["doesnt-exist", tid]}
        if test.get("upsert-workload"):
            if f == "upsert":
                k, _uid = v
                self.db.upsert_create(k)
                return {**op, "type": "ok"}
            if f == "read-uids":
                k, _ = v
                return {**op, "type": "ok",
                        "value": [k, self.db.upsert_read(k)]}
        if test.get("pages"):
            if f == "add":
                k, group = v
                self.db.pages_add(k, group)
                return {**op, "type": "ok"}
            if f == "read":
                k, _ = v
                return {**op, "type": "ok",
                        "value": [k, self.db.pages_read(k)]}
        if test.get("dirty-read"):
            if f == "write":
                self.db.add(("__dr__", v))
                return {**op, "type": "ok"}
            if f == "read" and v is not None:
                present = self.db.contains(("__dr__", v))
                return {**op, "type": "ok" if present else "fail"}
            if f == "refresh":
                return {**op, "type": "ok"}
            if f == "strong-read":
                els = [x[1] for x in self.db.set_read_raw()
                       if isinstance(x, tuple) and x[0] == "__dr__"]
                return {**op, "type": "ok", "value": sorted(els)}
        if test.get("version-divergence"):
            if f == "write":
                k, val = v
                self.db.vd_write(k, val)
                return {**op, "type": "ok"}
            if f == "read":
                k, _ = v
                return {**op, "type": "ok",
                        "value": [k, self.db.vd_read(k)]}
        if test.get("lost-updates") or test.get("pause-workload"):
            if f == "add":
                k, el = v
                self.db.lu_add(k, el)
                return {**op, "type": "ok"}
            if f == "read":
                k, _ = v
                return {**op, "type": "ok",
                        "value": [k, self.db.lu_read(k)]}
        if test.get("comments"):
            if f == "write":
                k, i = v
                self.db.cmt_write(k, i)
                return {**op, "type": "ok"}
            if f == "read":
                k, _ = v
                return {**op, "type": "ok",
                        "value": [k, self.db.cmt_read(k)]}
        if test.get("monotonic-key"):
            if f == "inc":
                return {**op, "type": "ok",
                        "value": {v: self.db.mono_key_inc(v)}}
            if f == "read":
                return {**op, "type": "ok",
                        "value": self.db.mono_key_read(
                            list((v or {}).keys()))}
        if test.get("delete-workload"):
            k, _ = v
            if f == "read":
                return {**op, "type": "ok",
                        "value": [k, self.db.del_read(k)]}
            if f == "upsert":
                uid = self.db.del_upsert(k)
                if uid is None:
                    return {**op, "type": "fail", "error": ["present"]}
                return {**op, "type": "ok"}
            if f == "delete":
                uid = self.db.del_delete(k)
                if uid is None:
                    return {**op, "type": "fail", "error": ["not-found"]}
                return {**op, "type": "ok"}
        if test.get("dgraph-sequential"):
            k, _ = v
            if f == "inc":
                return {**op, "type": "ok",
                        "value": [k, self.db.seq_reg_inc(k)]}
            if f == "read":
                return {**op, "type": "ok",
                        "value": [k, self.db.seq_reg_read(k)]}
        if test.get("ledger") and f == "transfer":
            account, amount = v[0], v[1]
            ok = self.db.ledger_transfer(account, int(amount))
            return {**op, "type": "ok" if ok else "fail"}
        if f == "transfer":
            t = v or {}
            ok = self.db.transfer(t.get("from"), t.get("to"),
                                  int(t.get("amount", 0)))
            return {**op, "type": "ok" if ok else "fail"}
        if f == "read" and v is None and self.whole_read == "bank":
            return {**op, "type": "ok", "value": self.db.bank_read()}
        if f == "read" and v is None and self.whole_read == "dirty":
            return {**op, "type": "ok", "value": self.db.read_all_rows()}
        if f == "write" and self.whole_read == "dirty":
            self.db.write_all_rows(v)
            return {**op, "type": "ok"}
        if f == "insert":
            pair, uid, cell = v
            ok = self.db.adya_insert(pair, uid, cell)
            return {**op, "type": "ok" if ok else "fail"}
        if f == "acquire":
            ok = self.db.acquire(op.get("process"))
            return {**op, "type": "ok" if ok else "fail"}
        if f == "release":
            ok = self.db.release(op.get("process"))
            return {**op, "type": "ok" if ok else "fail"}
        if f == "inc":
            return {**op, "type": "ok", "value": self.db.mono_inc()}
        if f == "read-all":
            return {**op, "type": "ok", "value": self.db.mono_read()}
        if test.get("key-count") and f in ("read", "write") \
                and not isinstance(v, (list, tuple)):
            sks = _subkeys(int(test.get("key-count", 5)), v)
            if f == "write":
                self.db.seq_write(sks)
                return {**op, "type": "ok"}
            return {**op, "type": "ok",
                    "value": [v, self.db.seq_read(list(reversed(sks)))]}
        if f == "txn":
            return {**op, "type": "ok",
                    "value": self.db.txn(v, style=self.txn_style)}
        if f == "add":
            self.db.add(v)
            return {**op, "type": "ok"}
        if f == "read" and v is None:  # whole-set read
            return {**op, "type": "ok", "value": self.db.set_read()}
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
        if f == "enqueue":
            self.db.enqueue(v)
            return {**op, "type": "ok"}
        if f == "dequeue":
            out = self.db.dequeue()
            if out is None:
                return {**op, "type": "fail"}
            return {**op, "type": "ok", "value": out}
        if f == "drain":
            return {**op, "type": "ok", "value": self.db.drain()}
        return {**op, "type": "fail", "error": ["unknown-f", f]}


# copied from jepsen_tpu/workloads/sequential.py:24-26 (the sequential
# workload waits for ROADMAP Queue 1 item 11)
def _subkeys(key_count: int, k) -> list[str]:
    """``k_0 .. k_{m-1}`` (sequential.clj:50-52)."""
    return [f"{k}_{i}" for i in range(key_count)]


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
