"""The CPU linearizability searches:

* :func:`check_stream` — the exact CPU twin of the transfer-matrix path:
  breadth-first just-in-time linearization over the int-encoded
  EventStream. It is the checker's terminal rung and the tests' oracle.
* :func:`wgl` — the Wing-Gong-Lowe depth-first search over op dicts and
  object models, for the models with no int encoding (and for
  ``algorithm="wgl"``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from jepsen_tpu_torch.checker.linear_encode import EV_INVOKE, EV_NOOP, EventStream
from jepsen_tpu_torch.models import (
    CAS_F_CAS, CAS_F_READ, CAS_F_WRITE, Model, is_inconsistent,
)


# copied from jepsen_tpu/checker/linear_cpu.py:24-34
def cas_register_step_py(state: int, f: int, a: int, b: int) -> tuple[int, bool]:
    """Pure-python twin of models.cas_register_spec().step_ids."""
    if f == CAS_F_READ:
        return state, (a == 0 or a == state)
    if f == CAS_F_WRITE:
        return a, True
    if f == CAS_F_CAS:
        if state == a:
            return b, True
        return state, False
    return state, False


# copied from jepsen_tpu/checker/linear_cpu.py:37-58
def multi_register_step_py(n_keys: int, n_values: int):
    """Pure-python twin of models.multi_register_spec().step_ids (same
    base-digit state/txn encodings; see that spec for the layout)."""
    V, K = n_values, n_keys
    SB, AB = V + 1, 2 * V + 2

    def step(state: int, f: int, a: int, b: int) -> tuple[int, bool]:
        acts = a
        for k in range(K):
            act = acts % AB
            acts //= AB
            digit = (state // (SB ** k)) % SB
            if 2 <= act < 2 + V:          # read value act-2
                if digit != act - 1:
                    return state, False
            elif act >= 2 + V:            # write value act-(2+V)
                state += (act - (1 + V) - digit) * (SB ** k)
        return state, True

    return step


# copied from jepsen_tpu/checker/linear_cpu.py:63-75
@dataclass
class LinearResult:
    valid: Any                 # True | False | "unknown"
    failed_event: int = -1     # event index where the frontier died
    failed_op_index: int = -1  # history index of that event's op
    configs_max: int = 0       # peak frontier size
    algorithm: str = ""
    # on failure: the surviving configurations just before the fatal
    # return killed them, truncated to 10. Each is {"state": model-state
    # value-or-id, "linearized": [history op-index...], "pending":
    # [history op-index...]}.
    final_configs: list | None = None


# copied from jepsen_tpu/checker/linear_cpu.py:78-244, without the
# coverage probe and its configs_min
class FrontierSession:
    """Resumable just-in-time linearization: the surviving
    configurations (linearized-pending bitmask, model state), the open
    ops per slot and the pending mask carry between absorbs. Once the
    frontier dies the session latches its failure LinearResult; further
    absorbs are no-ops. :meth:`snapshot` and :meth:`restore` carry the
    state through a durable checkpoint (checker/checkpoint.py).

    :meth:`absorb` runs the C closure of ``native/columnar_ext.c``
    (``history_ir.ingest.frontier_absorb``) for the CAS register over
    a list-backed stream, and this step loop on what the C declines."""

    def __init__(
        self,
        step: Callable[[int, int, int, int],
                       tuple[int, bool]] = cas_register_step_py,
        init_state: int = 0,
        algorithm: str = "jitlin-cpu",
    ):
        self.step = step
        self.algorithm = algorithm
        self.configs: set[tuple[int, int]] = {(0, init_state)}
        self.cur: dict[int, tuple[int, int, int]] = {}
        self.cur_idx: dict[int, int] = {}  # slot -> history index of open op
        self.pending_mask = 0
        self.configs_max = 1
        self.events_absorbed = 0
        self.failure: LinearResult | None = None

    def absorb(self, stream, start: int = 0,
               end: int | None = None) -> LinearResult:
        """Consumes events ``[start, end)`` of ``stream`` and returns the
        verdict so far. Event indices are absolute, so a failure reports
        the same ``failed_event`` a one-shot check would."""
        if self.failure is not None:
            return self.failure
        if end is None:
            end = len(stream.kind)
        # the C runs the same closure on COPIES and commits only a chunk
        # that stays alive; a death (or any regime miss) replays the
        # untouched state below, so the failure forensics are the
        # Python loop's
        from jepsen_tpu_torch.history_ir import ingest
        if ingest.frontier_absorb(self, stream, start, end):
            return self.result()
        step = self.step
        configs = self.configs
        cur = self.cur
        cur_idx = self.cur_idx
        pending_mask = self.pending_mask
        configs_max = self.configs_max
        kinds, slots = stream.kind, stream.slot
        fcol, acol, bcol, idxcol = stream.f, stream.a, stream.b, \
            stream.op_index
        for e in range(start, end):
            kind = kinds[e]
            if kind == EV_NOOP:
                continue
            s = int(slots[e])
            bit = 1 << s
            if kind == EV_INVOKE:
                cur[s] = (int(fcol[e]), int(acol[e]), int(bcol[e]))
                cur_idx[s] = int(idxcol[e])
                pending_mask |= bit
                continue
            # EV_RETURN: closure, then require this op linearized
            all_seen = set(configs)
            frontier = configs
            while frontier:
                new = set()
                for mask, state in frontier:
                    avail = pending_mask & ~mask
                    m = avail
                    while m:
                        low = m & (-m)
                        m ^= low
                        sl = low.bit_length() - 1
                        f, a, b2 = cur[sl]
                        st2, ok = step(state, f, a, b2)
                        if ok:
                            c2 = (mask | low, st2)
                            if c2 not in all_seen:
                                all_seen.add(c2)
                                new.add(c2)
                frontier = new
            configs_max = max(configs_max, len(all_seen))
            configs = {(mask & ~bit, state)
                       for (mask, state) in all_seen if mask & bit}
            pending_mask &= ~bit
            if not configs:
                def op_indices(mask):
                    return [cur_idx[t] for t in cur_idx if mask & (1 << t)]

                def state_val(st):
                    try:
                        return stream.intern.value(st)
                    except (IndexError, AttributeError):
                        return st

                # the fatal op WAS pending when these configs died — its
                # bit was cleared from pending_mask just above; restore it
                fatal_pending = pending_mask | bit
                finals = [{"state": state_val(state),
                           "linearized": sorted(op_indices(mask)),
                           "pending": sorted(
                               op_indices(fatal_pending & ~mask))}
                          for mask, state in sorted(all_seen)[:10]]
                self.configs_max = configs_max
                self.events_absorbed = e + 1
                self.failure = LinearResult(
                    valid=False, failed_event=e,
                    failed_op_index=int(stream.op_index[e]),
                    configs_max=configs_max, algorithm=self.algorithm,
                    final_configs=finals,
                )
                return self.failure
        self.configs = configs
        self.pending_mask = pending_mask
        self.configs_max = configs_max
        self.events_absorbed = end
        return self.result()

    def result(self) -> LinearResult:
        """The verdict over everything absorbed so far: valid-so-far, or
        the latched failure."""
        if self.failure is not None:
            return self.failure
        return LinearResult(valid=True, configs_max=self.configs_max,
                            algorithm=self.algorithm)

    # copied from jepsen_tpu/checker/linear_cpu.py:248-310. The port has no
    # coverage probe and so no ``configs_min``: a snapshot carries
    # ``"configs_min": None``, and ``restore`` takes a snapshot with or
    # without a value there (one the JAX package wrote) and drops it.

    def snapshot(self) -> dict | None:
        """The session's resumable state as a JSON-serializable dict, or
        None when it can't be serialized faithfully (exotic open-op
        values). Restoring it and absorbing the remaining events is
        bit-identical to one uninterrupted absorb: the configuration set,
        the open ops and the pending mask are the algorithm's whole
        state."""
        try:
            snap = {
                "configs": sorted([int(m), int(s)] for m, s in self.configs),
                "cur": {str(k): [int(x) for x in v]
                        for k, v in self.cur.items()},
                "cur_idx": {str(k): int(v) for k, v in self.cur_idx.items()},
                "pending_mask": int(self.pending_mask),
                "configs_max": int(self.configs_max),
                "configs_min": None,
                "events_absorbed": int(self.events_absorbed),
            }
            if self.failure is not None:
                f = self.failure
                snap["failure"] = {
                    "failed_event": int(f.failed_event),
                    "failed_op_index": int(f.failed_op_index),
                    "configs_max": int(f.configs_max),
                    "algorithm": f.algorithm,
                }
            return snap
        except (TypeError, ValueError):
            return None

    @classmethod
    def restore(cls, snap: dict, step=cas_register_step_py,
                init_state: int = 0, algorithm: str = "jitlin-cpu"):
        """A session rebuilt from :meth:`snapshot`'s product, or None on
        a malformed snapshot (the caller restarts from zero: a bad
        snapshot can delay a verdict, never change one)."""
        try:
            fs = cls(step=step, init_state=init_state, algorithm=algorithm)
            fs.configs = {(int(m), int(s)) for m, s in snap["configs"]}
            fs.cur = {int(k): tuple(int(x) for x in v)
                      for k, v in (snap.get("cur") or {}).items()}
            fs.cur_idx = {int(k): int(v)
                          for k, v in (snap.get("cur_idx") or {}).items()}
            fs.pending_mask = int(snap["pending_mask"])
            fs.configs_max = int(snap.get("configs_max", 1))
            fs.events_absorbed = int(snap["events_absorbed"])
            fail = snap.get("failure")
            if fail is not None:
                fs.failure = LinearResult(
                    valid=False,
                    failed_event=int(fail["failed_event"]),
                    failed_op_index=int(fail["failed_op_index"]),
                    configs_max=int(fail.get("configs_max", 0)),
                    algorithm=fail.get("algorithm") or algorithm,
                )
            return fs
        except (KeyError, TypeError, ValueError):
            return None


# copied from jepsen_tpu/checker/linear_cpu.py:310-319
def check_stream(
    stream: EventStream,
    step: Callable[[int, int, int, int], tuple[int, bool]] = cas_register_step_py,
    init_state: int = 0,
) -> LinearResult:
    """Breadth-first JIT linearization: configs are (linearized-pending
    bitmask, state) pairs; closure is computed lazily before each return
    event. One-shot absorb over a :class:`FrontierSession`."""
    return FrontierSession(step=step, init_state=init_state).absorb(stream)


# copied from jepsen_tpu/checker/linear_cpu.py:326-477
class _Node:
    __slots__ = ("kind", "op_id", "op", "match", "prev", "next")

    def __init__(self, kind, op_id, op):
        self.kind = kind      # 0 invoke, 1 return
        self.op_id = op_id
        self.op = op
        self.match = None
        self.prev = None
        self.next = None


def _unlink(n: _Node):
    n.prev.next = n.next
    n.next.prev = n.prev


def _relink(n: _Node):
    n.prev.next = n
    n.next.prev = n


def _preprocess(history: list[dict]):
    """Completes invocation values from returns, drops fail pairs and
    crashed reads. Returns [(inv_op, completed?)] per live op in invocation
    order plus their return positions (None = crashed)."""
    open_inv: dict = {}
    drop = set()
    completed_value: dict[int, Any] = {}
    returns: dict[int, int] = {}
    for i, op in enumerate(history):
        p, typ = op.get("process"), op.get("type")
        if not isinstance(p, int) or p < 0:
            drop.add(i)
            continue
        if typ == "invoke":
            open_inv[p] = i
        elif typ == "fail":
            j = open_inv.pop(p, None)
            if j is not None:
                drop.add(j)
            drop.add(i)
        elif typ == "ok":
            j = open_inv.pop(p, None)
            if j is not None:
                returns[j] = i
                if op.get("value") is not None:
                    completed_value[j] = op.get("value")
        elif typ == "info":
            j = open_inv.pop(p, None)
            drop.add(i)
            if j is not None and history[j].get("f") == "read":
                drop.add(j)
    for p, j in open_inv.items():
        if history[j].get("f") == "read":
            drop.add(j)
    live = []
    for i, op in enumerate(history):
        if i in drop or op.get("type") != "invoke":
            continue
        o = dict(op)
        if i in completed_value:
            o["value"] = completed_value[i]
        live.append((i, o, returns.get(i)))
    return live


def wgl(history: list[dict], model: Model, max_steps: int = 50_000_000) -> LinearResult:
    """Wing & Gong DFS with Lowe's (linearized-bitset, state) memoization
    (knossos.wgl equivalent). Crashed mutations may linearize at any later
    point or never."""
    live = _preprocess(history)
    n = len(live)
    if n == 0:
        return LinearResult(valid=True, algorithm="wgl-cpu")

    head = _Node(-1, -1, None)
    tail = _Node(-2, -1, None)
    head.next = tail
    tail.prev = head

    def insert_before(node, ref):
        node.prev = ref.prev
        node.next = ref
        ref.prev.next = node
        ref.prev = node

    # interleave invoke/return nodes in history order; crashed returns at end
    events: list[tuple[int, _Node]] = []
    ok_ops = set()
    for op_id, (hist_i, op, ret_i) in enumerate(live):
        inv = _Node(0, op_id, op)
        events.append((hist_i, inv))
        if ret_i is not None:
            ret = _Node(1, op_id, op)
            inv.match = ret
            ret.match = inv
            events.append((ret_i, ret))
            ok_ops.add(op_id)
    events.sort(key=lambda t: t[0])
    for _, node in events:
        insert_before(node, tail)

    ok_remaining = len(ok_ops)
    linearized_mask = 0
    seen: set[tuple[int, Model]] = set()
    stack: list[tuple[_Node, Model]] = []
    entry = head.next
    steps = 0
    max_lin = 0
    while True:
        steps += 1
        if steps > max_steps:
            return LinearResult(valid="unknown", algorithm="wgl-cpu",
                                configs_max=len(seen))
        if ok_remaining == 0:
            return LinearResult(valid=True, algorithm="wgl-cpu",
                                configs_max=len(seen))
        if entry.kind == 0:  # invoke: candidate for linearization
            m2 = entry.op and model.step(entry.op)
            if not is_inconsistent(m2):
                new_mask = linearized_mask | (1 << entry.op_id)
                key = (new_mask, m2)
                if key not in seen:
                    seen.add(key)
                    stack.append((entry, model))
                    _unlink(entry)
                    if entry.match is not None:
                        _unlink(entry.match)
                        ok_remaining -= 1
                    model = m2
                    linearized_mask = new_mask
                    max_lin = max(max_lin, bin(new_mask).count("1"))
                    entry = head.next
                    continue
            entry = entry.next
        else:
            # return entry of an unlinearized op (kind 1) or tail (kind -2):
            # no way forward; backtrack
            if not stack:
                # report how far we got: first un-linearizable return
                fail_op = entry.op_id if entry.kind == 1 else -1
                hist_i = live[fail_op][0] if fail_op >= 0 else -1
                return LinearResult(valid=False, failed_op_index=hist_i,
                                    algorithm="wgl-cpu", configs_max=len(seen))
            inv, model = stack.pop()
            linearized_mask &= ~(1 << inv.op_id)
            if inv.match is not None:
                _relink(inv.match)
                ok_remaining += 1
            _relink(inv)
            entry = inv.next
