"""History -> event-stream encoding for linearizability checking.

Shared front end of the CPU twin (linear_cpu) and the transfer-matrix
path (ops/jitlin):

* ``fail`` ops never happened: the invoke/fail pair is dropped.
* ``info`` (crashed) ops may or may not have happened. Crashed *reads*
  have no effect and are dropped; crashed mutations stay open forever.
* Each live op is assigned a small *slot* (reused after return), so a
  configuration's "linearized pending ops" is a machine-word bitmask.

Values are interned to dense int32 ids (id 0 = None).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from jepsen_tpu_torch.history import Intern
from jepsen_tpu_torch.models import CAS_F_CAS, CAS_F_READ, CAS_F_WRITE

# event kinds
EV_INVOKE, EV_RETURN, EV_NOOP = 0, 1, 2


# copied from jepsen_tpu/checker/linear_encode.py:37-52
@dataclass
class EventStream:
    """Columnar event stream for one key's history."""

    kind: np.ndarray   # int8: EV_INVOKE / EV_RETURN / EV_NOOP
    slot: np.ndarray   # int32: pending-slot id
    f: np.ndarray      # int32: model f code
    a: np.ndarray      # int32: first interned arg
    b: np.ndarray      # int32: second interned arg
    op_index: np.ndarray  # int32: source history index (diagnostics)
    n_slots: int
    n_ops: int
    intern: Intern = field(default_factory=Intern)

    def __len__(self):
        return len(self.kind)


# copied from jepsen_tpu/history_ir/views.py:52-172
def encode_register_ops(history, intern: Intern | None = None,
                        encode_args=None) -> EventStream:
    """Encodes a single-register r/w/cas history into an EventStream.

    Op encodings (f, a, b):
      read v  -> (CAS_F_READ, id(v), 0); a read of None (id 0) matches any state
      write v -> (CAS_F_WRITE, id(v), 0)
      cas [u,v] -> (CAS_F_CAS, id(u), id(v))

    ``encode_args(op) -> (f, a, b)`` overrides the per-op encoding."""
    intern = intern or Intern()
    kinds, slots, fs, as_, bs, idxs = [], [], [], [], [], []
    open_by_process: dict = {}   # process -> (slot, op)
    free_slots: list[int] = []
    next_slot = 0
    n_ops = 0

    if encode_args is None:
        def encode_args(op):
            f, v = op.get("f"), op.get("value")
            if f == "read":
                return CAS_F_READ, intern.id(v), 0
            if f == "write":
                return CAS_F_WRITE, intern.id(v), 0
            if f == "cas":
                u, w = v
                return CAS_F_CAS, intern.id(u), intern.id(w)
            raise ValueError(f"unknown register op {f!r}")

    # First pass: pair invokes with completions; find fail pairs and crashed
    # reads to drop; *complete* invocation values from their returns
    # (knossos history/complete semantics).
    drop = set()
    open_inv: dict = {}
    completed_value: dict[int, object] = {}  # invoke idx -> definitive value
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
            if j is not None and op.get("value") is not None:
                completed_value[j] = op.get("value")
        elif typ == "info":
            j = open_inv.pop(p, None)
            drop.add(i)  # info completion itself is not an event
            if j is not None and history[j].get("f") == "read":
                drop.add(j)  # crashed reads have no effect
    # ops still open at the end of history (no completion at all) crash too
    for p, j in open_inv.items():
        if history[j].get("f") == "read":
            drop.add(j)

    for i, op in enumerate(history):
        if i in drop:
            continue
        p, typ = op.get("process"), op.get("type")
        if typ == "invoke":
            if free_slots:
                s = free_slots.pop()
            else:
                s = next_slot
                next_slot += 1
            open_by_process[p] = (s, i)
            inv = dict(op)
            if i in completed_value:
                inv["value"] = completed_value[i]
            fcode, a, b = encode_args(inv)
            kinds.append(EV_INVOKE)
            slots.append(s)
            fs.append(fcode)
            as_.append(a)
            bs.append(b)
            idxs.append(i)
            n_ops += 1
        elif typ == "ok":
            got = open_by_process.pop(p, None)
            if got is None:
                continue
            s, j = got
            kinds.append(EV_RETURN)
            slots.append(s)
            fs.append(0)
            as_.append(0)
            bs.append(0)
            idxs.append(i)
            free_slots.append(s)
        # info: no return event — the crashed op's slot stays occupied
        # forever, so it may be linearized at any later point or never.

    return EventStream(
        kind=np.array(kinds, dtype=np.int8),
        slot=np.array(slots, dtype=np.int32),
        f=np.array(fs, dtype=np.int32),
        a=np.array(as_, dtype=np.int32),
        b=np.array(bs, dtype=np.int32),
        op_index=np.array(idxs, dtype=np.int32),
        n_slots=max(next_slot, 1),
        n_ops=n_ops,
        intern=intern,
    )


# copied from jepsen_tpu/history_ir/views.py:175-231
class _DenseIntern:
    """Stands in for Intern when states are arithmetic encodings rather
    than interned values: only the state-count surface is needed."""

    def __init__(self, n: int):
        self._n = n

    def __len__(self):
        return self._n


def encode_multi_register_ops(history, n_keys: int = 3, n_values: int = 5):
    """Encodes a multi-register txn history (the multi-key-acid workload,
    yugabyte/multi_key_acid.clj) for models.multi_register_spec: one op
    f="txn" whose value is [[f, k, v], ...] packs into base-(2V+2)
    per-key action digits of ``a`` (see the spec for the layout).

    The packed encoding holds one action per key, which covers the
    workload's generators exactly (they draw random nonempty *subsets*
    of the key range, so a txn never touches a key twice); a history
    with repeated keys in one txn raises ValueError and the checker
    falls back to the object-model search."""
    V, K = n_values, n_keys
    AB = 2 * V + 2

    def encode_args(op):
        if op.get("f") != "txn":
            raise ValueError(f"multi-register op must be txn, got "
                             f"{op.get('f')!r}")
        acts = [0] * K
        for f, k, v in op.get("value") or ():
            if not isinstance(k, int) or not (0 <= k < K):
                raise ValueError(f"key {k!r} outside [0, {K})")
            if acts[k] != 0:
                raise ValueError(f"txn touches key {k} twice")
            if f == "r":
                if v is None:
                    acts[k] = 1
                elif isinstance(v, int) and 0 <= v < V:
                    acts[k] = 2 + v
                else:
                    raise ValueError(f"read value {v!r} outside [0, {V})")
            elif f == "w":
                if not (isinstance(v, int) and 0 <= v < V):
                    raise ValueError(f"write value {v!r} outside [0, {V})")
                acts[k] = 2 + V + v
            else:
                raise ValueError(f"unknown micro-op {f!r}")
        a = 0
        for k in reversed(range(K)):
            a = a * AB + acts[k]
        return 0, a, 0

    stream = encode_register_ops(history, encode_args=encode_args)
    # interned-state count for kernel selection: the whole map space
    stream.intern = _DenseIntern((V + 1) ** K)
    return stream


# copied from jepsen_tpu/checker/linear_encode.py:108-111: the lin_*
# column round-trip lives with the sidecar (history_ir/sidecar.py)
def stream_from_columns(cols: dict) -> EventStream:
    """Rebuilds an EventStream from the ``lin_*`` column dict either
    package persists."""
    from jepsen_tpu_torch.history_ir import sidecar
    return sidecar.stream_from_columns(cols)
