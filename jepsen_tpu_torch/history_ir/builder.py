"""Incremental encoders for the live checker sessions: encode while the
run runs (jepsen_tpu/history_ir/builder.py).

The batch views (:mod:`jepsen_tpu_torch.history_ir.views`) walk the
finished history once. The classes here do the same work *op by op* as
ops arrive, and the live sessions (:mod:`jepsen_tpu_torch.live.sessions`)
adapt over them:

* :class:`LiveRegisterEncoder` — the register event stream, whose
  stream at every poll is the batch ``register_stream``'s prefix;
* :class:`LiveElleColumns` — the list-append transaction columns.

``LiveRegisterEncoder.add_many`` and ``encode_resolved`` go through the
C ingest spine (:mod:`jepsen_tpu_torch.history_ir.ingest` over
``native/columnar_ext.c``: ``register_add_encode`` and
``register_encode``), and run the Python loops on the C's regime misses
with the same state. The reference's canonical-column builder and WAL
streamer (``IncrementalHistoryBuilder``, ``WalStreamer``) come with the
run loop that would start them.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from jepsen_tpu_torch.history import Intern


# ---------------------------------------------------------------------------
# live-session encoders (the streaming sessions adapt over these)
# ---------------------------------------------------------------------------


# copied from jepsen_tpu/history_ir/builder.py:228-262
class ListStream:
    """A growing, list-backed event stream the FrontierSession can
    absorb from directly (plain-int lists index faster than numpy
    scalars on the Python step loop) and that converts to a real
    EventStream for device dispatch on demand."""

    __slots__ = ("kind", "slot", "f", "a", "b", "op_index", "intern",
                 "n_slots")

    def __init__(self, intern: Intern):
        self.kind: list[int] = []
        self.slot: list[int] = []
        self.f: list[int] = []
        self.a: list[int] = []
        self.b: list[int] = []
        self.op_index: list[int] = []
        self.intern = intern
        self.n_slots = 1

    def __len__(self):
        return len(self.kind)

    def to_event_stream(self):
        from jepsen_tpu_torch.checker.linear_encode import (
            EV_INVOKE, EventStream)
        return EventStream(
            kind=np.asarray(self.kind, np.int8),
            slot=np.asarray(self.slot, np.int32),
            f=np.asarray(self.f, np.int32),
            a=np.asarray(self.a, np.int32),
            b=np.asarray(self.b, np.int32),
            op_index=np.asarray(self.op_index, np.int32),
            n_slots=self.n_slots,
            n_ops=sum(1 for k in self.kind if k == EV_INVOKE),
            intern=self.intern,
        )


# copied from jepsen_tpu/history_ir/builder.py:265-550
class LiveRegisterEncoder:
    """Incremental twin of the register event-stream view
    (:func:`jepsen_tpu_torch.checker.linear_encode.encode_register_ops`):
    absorbs history ops in order and emits the identical event sequence
    (pinned against the batch encoder and the reference's encoder in
    tests/test_torch_live.py).

    The batch encoder resolves each invoke by looking ahead at its
    completion (fail pairs drop, crashed reads drop, a read's value
    completes from its :ok). Online, the look-ahead becomes a stall:
    encoding advances through the history strictly in order and pauses
    at the first invoke whose completion hasn't arrived yet — the
    *checkable prefix*. The stall is bounded by the run's concurrency
    (plus the per-op deadline that reaps hung ops to :info), and it is
    exactly the live checker's intrinsic lag."""

    def __init__(self, intern: Intern, encode_args=None):
        self.intern = intern
        self.stream = ListStream(intern)
        # snapshot() can only rebuild the default arg encoder; a custom
        # one makes the encoder unsnapshotable (restarts re-ingest)
        self._default_args = encode_args is None
        if encode_args is None:
            from jepsen_tpu_torch.models import (
                CAS_F_CAS, CAS_F_READ, CAS_F_WRITE,
            )

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
        self.encode_args = encode_args
        self._ops: list[dict] = []          # raw history, arrival order
        self._next = 0                      # next history index to encode
        self._open_inv: dict = {}           # process -> open invoke index
        self._outcome: dict[int, tuple] = {}  # invoke idx -> resolution
        # second-pass state (slot allocation), advanced in order only
        self._open_by_process: dict = {}
        self._free_slots: list[int] = []
        self._next_slot = 0
        self._finalized = False

    # -- arrival (first-pass resolution) --------------------------------

    def add(self, op: dict) -> None:
        i = len(self._ops)
        self._ops.append(op)
        p, typ = op.get("process"), op.get("type")
        if not isinstance(p, int) or p < 0:
            return
        if typ == "invoke":
            j = self._open_inv.pop(p, None)
            if j is not None:
                # overwritten invoke: never completed, never dropped by
                # the batch encoder either — encode it, return-less
                self._outcome[j] = ("keep",)
            self._open_inv[p] = i
        elif typ == "fail":
            j = self._open_inv.pop(p, None)
            if j is not None:
                self._outcome[j] = ("drop",)
        elif typ == "ok":
            j = self._open_inv.pop(p, None)
            if j is not None:
                v = op.get("value")
                self._outcome[j] = (("ok", v) if v is not None
                                    else ("keep",))
        elif typ == "info":
            j = self._open_inv.pop(p, None)
            if j is not None:
                self._outcome[j] = (
                    ("drop",) if self._ops[j].get("f") == "read"
                    else ("keep",))

    def add_many(self, ops: Sequence[dict]) -> None:
        """Chunked :meth:`add`: one native call a WAL poll instead of a
        Python frame an op (``history_ir.ingest``); the per-op loop
        when the encoder is out of the C's regime, with the same
        state."""
        from jepsen_tpu_torch.history_ir import ingest
        if ingest.encoder_add_encode(self, ops):
            return
        for op in ops:
            self.add(op)

    # -- encoding (second pass, in order, stalls at unresolved) ---------

    def encode_resolved(self) -> int:
        """Advances the encoder over every op whose resolution is known;
        returns the new count of encoded history ops (the checkable
        prefix length)."""
        # native fast path: advances the same cursor/slot state in
        # place; a mid-stream bail (exotic value, unknown f) leaves
        # ``_next`` AT the offending op so the loop below resumes — and
        # raises — from bit-identical state
        from jepsen_tpu_torch.history_ir import ingest
        if ingest.encoder_encode(self):
            return self._next
        from jepsen_tpu_torch.checker.linear_encode import (
            EV_INVOKE, EV_RETURN)
        ops = self._ops
        st = self.stream
        # hot loop: bound methods/locals hoisted — this runs once per
        # history op at WAL-ingest rate
        kind_app, slot_app = st.kind.append, st.slot.append
        f_app, a_app, b_app = st.f.append, st.a.append, st.b.append
        idx_app = st.op_index.append
        outcome_get = self._outcome.get
        free_slots = self._free_slots
        open_bp = self._open_by_process
        encode_args = self.encode_args
        n = len(ops)
        i = self._next
        while i < n:
            op = ops[i]
            p = op.get("process")
            typ = op.get("type")
            if not isinstance(p, int) or p < 0:
                i += 1
                continue
            if typ == "invoke":
                outcome = outcome_get(i)
                if outcome is None:
                    if not self._finalized:
                        break  # stall: completion not seen yet
                    # end of run: open reads never happened, open
                    # mutations stay pending forever (batch semantics)
                    outcome = (("drop",) if op.get("f") == "read"
                               else ("keep",))
                if outcome[0] == "drop":
                    i += 1
                    continue
                if free_slots:
                    s = free_slots.pop()
                else:
                    s = self._next_slot
                    self._next_slot += 1
                    st.n_slots = max(st.n_slots, self._next_slot)
                open_bp[p] = s
                inv = op
                if outcome[0] == "ok":
                    inv = dict(op)
                    inv["value"] = outcome[1]
                fcode, a, b = encode_args(inv)
                kind_app(EV_INVOKE)
                slot_app(s)
                f_app(fcode)
                a_app(a)
                b_app(b)
                idx_app(i)
            elif typ == "ok":
                s = open_bp.pop(p, None)
                if s is not None:
                    kind_app(EV_RETURN)
                    slot_app(s)
                    f_app(0)
                    a_app(0)
                    b_app(0)
                    idx_app(i)
                    free_slots.append(s)
            # fail/info: dropped pair / no return event — the crashed
            # op's slot stays occupied forever
            i += 1
        self._next = i
        return i

    def finalize(self) -> int:
        self._finalized = True
        return self.encode_resolved()

    @property
    def ops_seen(self) -> int:
        return len(self._ops)

    @property
    def ops_encoded(self) -> int:
        return self._next

    # -- durable snapshots (a live session's restart path) -------------

    _SCALARS = (type(None), bool, int, float, str)

    # encoded streams longer than this are not snapshotted: the raw-op
    # tail stays tiny (bounded by concurrency), but the encoded int
    # columns grow with the run, and re-serializing tens of MB of JSON
    # every snapshot interval would cost more than the restart re-ingest
    # it avoids. Beyond the cap a daemon restart re-reads the WAL — a
    # bounded few seconds of parse, paid once, instead of a recurring
    # per-poll tax.
    SNAPSHOT_MAX_EVENTS = 1 << 20

    def snapshot(self) -> dict | None:
        """The encoder's resumable state as a JSON-serializable dict,
        or None when it can't be serialized faithfully (exotic intern
        values, a custom ``encode_args``) or economically (the encoded
        columns are past :data:`SNAPSHOT_MAX_EVENTS`). History ops
        before the encode cursor are never consulted again — of the
        RAW history only the unresolved tail is kept (bounded by the
        run's concurrency) — but the encoded columns themselves ride
        along whole, which is what the size cap bounds."""
        if not getattr(self, "_default_args", False):
            return None  # custom encode_args: can't rebuild it
        if len(self.stream) > self.SNAPSHOT_MAX_EVENTS:
            return None  # re-ingest on restart beats a per-poll tax
        if any(not isinstance(v, self._SCALARS)
               for v in self.intern.table):
            return None
        nxt = self._next
        try:
            snap = {
                "intern": list(self.intern.table[1:]),
                "stream": {
                    "kind": list(self.stream.kind),
                    "slot": list(self.stream.slot),
                    "f": list(self.stream.f),
                    "a": list(self.stream.a),
                    "b": list(self.stream.b),
                    "op_index": list(self.stream.op_index),
                    "n_slots": self.stream.n_slots,
                },
                "next": nxt,
                "tail_ops": self._ops[nxt:],
                "open_inv": {str(p): i for p, i in self._open_inv.items()},
                "outcome": {str(i): list(o)
                            for i, o in self._outcome.items() if i >= nxt},
                "open_by_process": {str(p): s for p, s
                                    in self._open_by_process.items()},
                "free_slots": list(self._free_slots),
                "next_slot": self._next_slot,
                "finalized": self._finalized,
            }
            # prove JSON faithfulness now — a tail op with a tuple value
            # or non-string keys must reject here, not diverge later
            import json
            if json.loads(json.dumps(snap)) != snap:
                return None
            return snap
        except (TypeError, ValueError):
            return None

    @classmethod
    def restore(cls, snap: dict) -> "LiveRegisterEncoder | None":
        """An encoder rebuilt from :meth:`snapshot`'s product, or None
        on a malformed snapshot (the caller re-ingests from scratch —
        a bad snapshot may cost a re-read, never a wrong stream)."""
        try:
            intern = Intern()
            for v in snap["intern"]:
                intern.id(v)
            enc = cls(intern)
            st = enc.stream
            s = snap["stream"]
            st.kind = [int(x) for x in s["kind"]]
            st.slot = [int(x) for x in s["slot"]]
            st.f = [int(x) for x in s["f"]]
            st.a = [int(x) for x in s["a"]]
            st.b = [int(x) for x in s["b"]]
            st.op_index = [int(x) for x in s["op_index"]]
            st.n_slots = int(s["n_slots"])
            nxt = int(snap["next"])
            # ops before the cursor are never consulted again —
            # placeholders keep the indexing aligned without the bulk
            enc._ops = [None] * nxt + list(snap["tail_ops"])
            enc._next = nxt
            enc._open_inv = {int(p): int(i)
                             for p, i in (snap.get("open_inv")
                                          or {}).items()}
            enc._outcome = {int(i): tuple(o)
                            for i, o in (snap.get("outcome")
                                         or {}).items()}
            enc._open_by_process = {int(p): int(s2) for p, s2
                                    in (snap.get("open_by_process")
                                        or {}).items()}
            enc._free_slots = [int(x) for x in snap.get("free_slots") or []]
            enc._next_slot = int(snap["next_slot"])
            enc._finalized = bool(snap.get("finalized", False))
            return enc
        except (KeyError, TypeError, ValueError):
            return None


# copied from jepsen_tpu/history_ir/builder.py:552-665
class TxnCols:
    """Flattened micro-op columns for one node class (ok or info)."""

    __slots__ = ("pos", "inv", "proc", "txns",
                 "a_txn", "a_kid", "a_val", "a_mi",
                 "r_txn", "r_kid", "r_mi", "payloads")

    def __init__(self):
        self.pos: list[int] = []
        self.inv: list[int] = []
        self.proc: list[int] = []
        self.txns: list[dict] = []
        self.a_txn: list[int] = []
        self.a_kid: list[int] = []
        self.a_val: list[int] = []
        self.a_mi: list[int] = []
        self.r_txn: list[int] = []
        self.r_kid: list[int] = []
        self.r_mi: list[int] = []
        self.payloads: list[list] = []


class LiveElleColumns:
    """Incremental list-append builder columns: the per-op build work
    (event pairing, micro-op flattening, key interning) run once per op
    as a run's WAL streams in. The live :class:`ElleSession` is a thin
    adapter over this; each verdict pays only the vectorized assemble.
    A history outside the integer columnar regime sets ``fallback`` and
    the session re-checks from the retained history instead."""

    def __init__(self):
        from jepsen_tpu_torch.elle.columnar import _MAX_MOPS, _MAX_VAL
        self._max_mops = _MAX_MOPS
        self._max_val = _MAX_VAL
        self._last_ev: dict = {}      # process -> (idx, was_invoke)
        self.ok = TxnCols()
        self.info = TxnCols()
        self.f_kid: list[int] = []
        self.f_val: list[int] = []
        self._kid_of: dict = {}
        self.raw_key: list = []
        self.fallback: str | None = None

    def kid(self, k) -> int:
        from jepsen_tpu_torch.txn import _hk
        hk = _hk(k)
        i = self._kid_of.get(hk)
        if i is None:
            i = self._kid_of[hk] = len(self.raw_key)
            self.raw_key.append(k)
        return i

    def absorb(self, i: int, op: dict) -> None:
        """Absorbs history op ``i``; mirrors the batch builder's event
        extraction + flatten passes exactly (sessions' differential
        fuzz pins it)."""
        typ = op.get("type")
        if typ not in ("invoke", "ok", "fail", "info"):
            return
        p = op.get("process")
        try:
            prev = self._last_ev.get(p)
        except TypeError:  # unhashable process: outside every regime
            self.fallback = self.fallback or "unhashable process"
            return
        self._last_ev[p] = (i, typ == "invoke")
        if typ == "invoke":
            return
        inv = prev[0] if (prev is not None and prev[1]) else None
        if typ == "fail":
            for m in op.get("value") or ():
                if m[0] == "append":
                    v = m[2]
                    if not isinstance(v, int) or isinstance(v, bool) \
                            or not (0 <= v < self._max_val):
                        self.fallback = "non-int/overflow failed append"
                        return
                    self.f_kid.append(self.kid(m[1]))
                    self.f_val.append(v)
            return
        if not isinstance(p, int):
            return  # not a graph node (batch pint filter)
        cols = self.ok if typ == "ok" else self.info
        t = len(cols.pos)
        cols.pos.append(i)
        cols.inv.append(-1 if inv is None else inv)
        cols.proc.append(p)
        cols.txns.append(op)
        if self.fallback:
            return
        try:
            for mi, m in enumerate(op.get("value") or ()):
                if mi >= self._max_mops:
                    self.fallback = "over-long txn"
                    return
                f = m[0]
                if f == "append":
                    v = m[2]
                    if not isinstance(v, int) or isinstance(v, bool) \
                            or not (0 <= v < self._max_val):
                        self.fallback = "non-int/overflow append value"
                        return
                    cols.a_txn.append(t)
                    cols.a_kid.append(self.kid(m[1]))
                    cols.a_val.append(v)
                    cols.a_mi.append(mi)
                elif f == "r" and m[2] is not None:
                    cols.r_txn.append(t)
                    cols.r_kid.append(self.kid(m[1]))
                    cols.r_mi.append(mi)
                    cols.payloads.append(m[2] if type(m[2]) is list
                                         else list(m[2]))
        except (TypeError, ValueError, IndexError, OverflowError) as e:
            self.fallback = f"unflattenable txn: {e!r}"
