"""Per-run incremental checker sessions (jepsen_tpu/live/sessions.py).

Each session absorbs ops one at a time as a run's WAL streams in
(:class:`jepsen_tpu_torch.journal.WalTailer`) and answers ``verdict()``
— "valid so far" or "first anomaly at op N" — without re-reading or
re-encoding the prefix it has already seen:

* :class:`LinearLiveSession` — single-register linearizability. The
  history IR's incremental register encoder
  (:class:`jepsen_tpu_torch.history_ir.builder.LiveRegisterEncoder`, the
  streaming twin of ``encode_register_ops``) feeds two rungs, tried in
  order each poll:

  - ``torch-matrix`` — the transfer-matrix screen of the whole checkable
    prefix (``jitlin.matrix_check``: ``chunk_product.cu`` and
    ``chunk_combine.cu`` on the card) on the session's ``device``, when
    ``accelerator`` is "gpu", or "auto" from AUTO_TPU_THRESHOLD events
    up, and ``jitlin.matrix_ok`` holds; sharded over
    ``parallel.sharded_mesh_for`` when the cost model asks for it on
    several cards. An exact True settles the poll valid. An exact False
    is localized on the device (``jitlin.matrix_localize``:
    ``prefix_alive.cu``, then ``window_rescan.cu``) and latched: an
    invalid prefix stays invalid at the same op, so later polls answer
    from the latch without a launch.
  - ``frontier-cpu`` — the exact resumable CPU frontier
    (:class:`~jepsen_tpu_torch.checker.linear_cpu.FrontierSession`),
    which absorbs from its own offset. It settles an inexact or declined
    screen, and every poll out of the screen's regime: a rung, not a
    fallback.

* :class:`ElleSession` — list-append transactional anomalies. The build
  work (event pairing, micro-op flattening, key interning) is the
  history IR's incremental Elle builder
  (:class:`jepsen_tpu_torch.history_ir.builder.LiveElleColumns`), run
  once per op as it arrives; each verdict then pays only the vectorized
  assemble and the cycle check (``elle.columnar._assemble``, the batch
  code path, and ``elle.check_cycles`` on ``device``).

* :class:`MultiKeyLinearSession` — a key-lifted register history, one
  :class:`LinearLiveSession` a key.

Changes from the reference: the rungs replace its ``BackendLadder``
(no watchdog, breaker or demotion), and an error of the screen, of the
sharded screen or of the localization propagates from ``verdict()``,
where the reference retries a failed shard on one device and swallows a
failed localization. A bad op still poisons its session (``verdict``
then says "unknown" with the error) and does not kill it. The rung
labels are ``torch-matrix`` and ``frontier-cpu``. An error of a poll
reaches the live daemon (:mod:`jepsen_tpu_torch.live.daemon`), whose
per-run breaker opens after ``LIVE_BREAKER_THRESHOLD`` failing polls.
Not ported: the schedule fuzzer's ``coverage_probe``.

Sessions are single-threaded by contract: one poller owns them; nothing
here takes locks.
"""
from __future__ import annotations

import logging
from typing import Any

from jepsen_tpu_torch.checker.linear_cpu import (
    FrontierSession, cas_register_step_py,
)
from jepsen_tpu_torch.checker.linear_encode import EV_RETURN
from jepsen_tpu_torch.checker.linearizable import (
    ACCELERATORS, AUTO_TPU_THRESHOLD,
)
from jepsen_tpu_torch.elle.columnar import _MAX_KIDS
from jepsen_tpu_torch.history import Intern
from jepsen_tpu_torch.history_ir.builder import (
    LiveElleColumns, LiveRegisterEncoder,
)

logger = logging.getLogger("jepsen_tpu_torch.live.sessions")

#: the rung labels a register verdict reports as its ``backend``
MATRIX_BACKEND = "torch-matrix"
FRONTIER_BACKEND = "frontier-cpu"


def _check_accelerator(accelerator: str) -> None:
    if accelerator not in ACCELERATORS:
        raise ValueError(f"accelerator {accelerator!r} not in "
                         f"{ACCELERATORS}")


# copied from jepsen_tpu/live/sessions.py:59-312, the ladder replaced by
# the two rungs
class LinearLiveSession:
    """Streaming single-register linearizability over a WAL tail.
    ``accelerator`` is "gpu", "cpu" or "auto", as for the checker; the
    screen runs on ``device`` (the CUDA device by default)."""

    workload = "register"

    def __init__(self, accelerator: str = "auto", model_value=None,
                 device=None):
        _check_accelerator(accelerator)
        self.accelerator = accelerator
        self.device = device
        self.intern = Intern()
        init_id = (0 if model_value is None
                   else self.intern.id(model_value))
        self._spec_init = init_id
        self.encoder = LiveRegisterEncoder(self.intern)
        self.frontier = FrontierSession(step=cas_register_step_py,
                                        init_state=init_id,
                                        algorithm="jitlin-cpu-live")
        self._last = {"valid_so_far": True, "first_anomaly_op": None,
                      "backend": FRONTIER_BACKEND, "checked_ops": 0}
        self._broken: str | None = None
        # latched device localization: an invalid prefix stays invalid
        # with the SAME first anomaly (frontier death is monotone), so
        # later polls answer from the latch instead of re-localizing
        self._matrix_first: int | None = None

    # -- ingestion ------------------------------------------------------

    def add(self, op: dict) -> None:
        if self._broken:
            return
        try:
            self.encoder.add(op)
        except Exception as e:  # noqa: BLE001 — a bad op poisons, not kills
            self._broken = f"unencodable op: {e!r}"
            logger.exception("live register session poisoned")

    def add_many(self, ops: list) -> None:
        """:meth:`add` for each of ``ops``, with the same poison-not-kill
        contract."""
        if self._broken:
            return
        try:
            self.encoder.add_many(ops)
        except Exception as e:  # noqa: BLE001 — a bad op poisons, not kills
            self._broken = f"unencodable op: {e!r}"
            logger.exception("live register session poisoned")

    @property
    def ops_absorbed(self) -> int:
        return self.encoder.ops_seen

    @property
    def checked_ops(self) -> int:
        return self._last["checked_ops"]

    def last(self) -> dict:
        return dict(self._last)

    # -- rungs ----------------------------------------------------------

    def _matrix_eligible(self) -> bool:
        stream = self.encoder.stream
        if self.accelerator == "cpu" or (
                self.accelerator == "auto"
                and len(stream) < AUTO_TPU_THRESHOLD):
            return False
        from jepsen_tpu_torch.ops.jitlin import matrix_ok
        return matrix_ok(stream.n_slots, len(stream.intern),
                         stream.kind.count(EV_RETURN))

    def _matrix_screen(self) -> dict | None:
        """The stateless full-prefix screen: an exact True settles this
        poll's verdict without touching the CPU frontier (which catches
        up from its own offset when it next runs); an exact False
        localizes and latches. None: inexact, or the localization
        declined — the frontier settles the poll."""
        from jepsen_tpu_torch import parallel
        from jepsen_tpu_torch.device import resolve_device
        from jepsen_tpu_torch.models import cas_register_spec
        from jepsen_tpu_torch.ops.jitlin import matrix_check, matrix_localize
        checked = self.encoder.ops_encoded
        if self._matrix_first is not None:
            return {"valid_so_far": False,
                    "first_anomaly_op": self._matrix_first,
                    "checked_ops": checked}
        es = self.encoder.stream.to_event_stream()
        spec = cas_register_spec(self._spec_init)
        # the cost model's mesh is of cards: a session on the CPU keeps
        # its own device
        mesh = parallel.sharded_mesh_for(len(es.kind))
        if mesh is not None and \
                mesh.devices[0].type != resolve_device(self.device).type:
            mesh = None
        kw = dict(step_ids=spec.step_ids, init_state=spec.init_state,
                  num_states=len(es.intern), device=self.device)
        m = matrix_check(es, mesh=mesh, **kw)
        if m is None or m[2]:
            return None
        if m[0]:
            return {"valid_so_far": True, "first_anomaly_op": None,
                    "checked_ops": checked}
        loc = matrix_localize(es, **kw)
        if loc is None:
            return None
        self._matrix_first = int(loc.failed_op_index)
        return {"valid_so_far": False,
                "first_anomaly_op": self._matrix_first,
                "checked_ops": checked}

    def _frontier_rung(self) -> dict:
        fs = self.frontier
        res = fs.absorb(self.encoder.stream, start=fs.events_absorbed)
        first = None if res.valid is True else int(res.failed_op_index)
        return {"valid_so_far": res.valid, "first_anomaly_op": first,
                "checked_ops": self.encoder.ops_encoded}

    # -- verdicts -------------------------------------------------------

    def verdict(self) -> dict:
        """Advances the checkable prefix and returns the live verdict:
        ``{valid_so_far, first_anomaly_op, backend, checked_ops}``."""
        if self._broken:
            return {**self._last, "valid_so_far": "unknown",
                    "error": self._broken}
        self.encoder.encode_resolved()
        out = self._matrix_screen() if self._matrix_eligible() else None
        backend = MATRIX_BACKEND
        if out is None:
            out, backend = self._frontier_rung(), FRONTIER_BACKEND
        out["backend"] = backend
        self._last = out
        return dict(out)

    # -- durable snapshots (a restart's path) ---------------------------

    def snapshot(self) -> dict | None:
        """The session's resumable state as a JSON-serializable dict, or
        None when it can't be serialized faithfully (poisoned session,
        exotic values) — a restart then re-ingests the WAL from zero,
        slower but never wrong."""
        if self._broken:
            return None
        enc = self.encoder.snapshot()
        if enc is None:
            return None
        frontier = self.frontier.snapshot()
        if frontier is None:
            return None
        return {
            "workload": self.workload,
            "spec_init": self._spec_init,
            "encoder": enc,
            "frontier": frontier,
            "matrix_first": self._matrix_first,
            "last": dict(self._last),
        }

    @classmethod
    def restore(cls, snap: dict, accelerator: str = "auto", device=None):
        """A session rebuilt from :meth:`snapshot`, or None on a
        malformed snapshot."""
        try:
            enc = LiveRegisterEncoder.restore(snap["encoder"])
            if enc is None:
                return None
            init_id = int(snap["spec_init"])
            frontier = FrontierSession.restore(
                snap["frontier"], step=cas_register_step_py,
                init_state=init_id, algorithm="jitlin-cpu-live")
            if frontier is None:
                return None
            sess = cls(accelerator=accelerator, device=device)
            sess.intern = enc.intern
            sess._spec_init = init_id
            sess.encoder = enc
            sess.frontier = frontier
            sess._matrix_first = snap.get("matrix_first")
            last = snap.get("last")
            if isinstance(last, dict):
                sess._last = last
            return sess
        except (KeyError, TypeError, ValueError):
            return None

    def finalize(self) -> dict:
        """End-of-run verdict: resolves the still-open tail exactly as
        the batch encoder would, then settles on the exact CPU frontier
        (so ``failed-op-index`` is precise)."""
        if self._broken:
            return {"valid?": "unknown", "error": self._broken,
                    "algorithm": "jitlin-cpu-live"}
        self.encoder.finalize()
        res = self.frontier.absorb(self.encoder.stream,
                                   start=self.frontier.events_absorbed)
        self._last = {
            "valid_so_far": res.valid,
            "first_anomaly_op": (None if res.valid is True
                                 else int(res.failed_op_index)),
            "backend": FRONTIER_BACKEND, "checked_ops":
                self.encoder.ops_encoded,
        }
        out: dict[str, Any] = {
            "valid?": res.valid,
            "algorithm": res.algorithm,
            "configs-max": res.configs_max,
        }
        if res.valid is False and res.failed_op_index >= 0:
            out["failed-op-index"] = int(res.failed_op_index)
        return out


# copied from jepsen_tpu/live/sessions.py:314-441
class ElleSession:
    """Streaming list-append Elle: incremental graph-build columns.

    ``add`` runs the per-op build work (event pairing, micro-op
    flattening, key interning) exactly once per op; ``verdict`` pays
    only the vectorized assemble + φ-cluster cycle check (on ``device``
    under ``accelerator`` "gpu" or "auto"). A history outside the
    integer columnar regime (exotic keys, non-int payload elements)
    poisons the incremental columns and every later verdict runs the
    batch checker over the retained history — slower, never wrong."""

    workload = "list-append"

    def __init__(self, accelerator: str = "auto",
                 consistency_models=("strict-serializable",), device=None):
        _check_accelerator(accelerator)
        self.accelerator = accelerator
        self.consistency_models = tuple(consistency_models)
        self.device = device
        self.history: list[dict] = []
        self._cols = LiveElleColumns()
        self._last = {"valid_so_far": True, "first_anomaly_op": None,
                      "backend": "columnar-incremental", "checked_ops": 0}

    @property
    def _fallback(self):
        return self._cols.fallback

    @property
    def ops_absorbed(self) -> int:
        return len(self.history)

    @property
    def checked_ops(self) -> int:
        return self._last["checked_ops"]

    def last(self) -> dict:
        return dict(self._last)

    def add(self, op: dict) -> None:
        i = len(self.history)
        self.history.append(op)
        self._cols.absorb(i, op)

    def add_many(self, ops: list) -> None:
        for op in ops:
            self.add(op)

    def _check_batch(self) -> dict:
        from jepsen_tpu_torch.elle import list_append
        return list_append.check(
            self.history, accelerator=self.accelerator,
            consistency_models=self.consistency_models, device=self.device)

    def _update_last(self, result: dict) -> dict:
        first = None
        if result.get("valid?") is not True:
            first = _first_anomaly_op(result, self.history)
        self._last = {
            "valid_so_far": result.get("valid?"),
            "first_anomaly_op": first,
            "anomaly_types": result.get("anomaly-types") or [],
            "backend": ("batch-fallback" if self._fallback
                        else "columnar-incremental"),
            "checked_ops": len(self.history),
        }
        return dict(self._last)

    def verdict(self) -> dict:
        return self._update_last(self._result())

    def snapshot(self) -> dict | None:
        # an Elle session's state IS the whole retained history (the
        # batch fallback needs every op) — a snapshot would be as large
        # as the WAL it replaces, so restarts re-ingest instead
        return None

    def finalize(self) -> dict:
        out = self._result()
        self._update_last(out)
        return out

    def _result(self) -> dict:
        """The full checker result map over everything absorbed — the
        same map ``elle.list_append.check`` returns, without its
        ``read-scan-keys`` and with ``builder`` "columnar-incremental"."""
        import numpy as np

        from jepsen_tpu_torch import elle
        from jepsen_tpu_torch.elle import columnar

        cols = self._cols
        if cols.fallback or len(cols.raw_key) >= _MAX_KIDS:
            return self._check_batch()
        ok, info = cols.ok, cols.info
        n_ok = len(ok.pos)
        txns = ok.txns + info.txns
        if not txns:
            return {"valid?": True, "anomaly-types": [], "not": [],
                    "anomalies": {}, "txn-count": 0, "edge-count": 0,
                    "builder": "columnar-incremental"}
        parts = columnar._assemble(
            txns=txns, n_ok=n_ok, raw_key=cols.raw_key,
            a_txn=ok.a_txn + [n_ok + t for t in info.a_txn],
            a_kid=ok.a_kid + info.a_kid,
            a_val=ok.a_val + info.a_val,
            a_mi=ok.a_mi + info.a_mi,
            r_txn=ok.r_txn + [n_ok + t for t in info.r_txn],
            r_kid=ok.r_kid + info.r_kid,
            r_mi=ok.r_mi + info.r_mi,
            payloads=ok.payloads + info.payloads,
            f_kid=list(cols.f_kid), f_val=list(cols.f_val),
            node_pos=np.asarray(ok.pos + info.pos, np.int64),
            node_inv=np.asarray(ok.inv + info.inv, np.int64),
            node_proc=np.asarray(ok.proc + info.proc, np.int64))
        if parts is None:  # regime miss the per-op checks didn't catch
            cols.fallback = "assemble regime miss"
            return self._check_batch()
        graph, txns, extras, nk = parts
        cyc = elle.check_cycles(graph, accelerator=self.accelerator,
                                device=self.device)
        merged = {k: v for k, v in extras.items()
                  if k != "unobserved-writer"}
        result = elle.result_map(
            cyc, txns, merged, consistency_models=self.consistency_models)
        result["txn-count"] = graph.n
        result["edge-count"] = graph.edge_count()
        result["builder"] = "columnar-incremental"
        return result


# copied from jepsen_tpu/live/sessions.py:443-464
def _first_anomaly_op(result: dict, history: list[dict]) -> int | None:
    """Best-effort history index of the first anomalous txn cited by an
    Elle result (cycles cite txn values; extras cite reads/writers) —
    the "first anomaly at op N" surface. None when nothing matched."""
    cited: list = []
    for cycles in (result.get("anomalies") or {}).values():
        for item in cycles if isinstance(cycles, list) else ():
            for hop in item if isinstance(item, list) else ():
                if isinstance(hop, dict):
                    cited.extend([hop.get("from"), hop.get("to"),
                                  hop.get("read"), hop.get("read-txn"),
                                  hop.get("writer")])
    idx = None
    for i, op in enumerate(history):
        if op.get("type") not in ("ok", "info"):
            continue
        v = op.get("value")
        if v is None:
            continue
        if any(c is not None and c == v for c in cited):
            idx = i if idx is None else min(idx, i)
    return idx


# copied from jepsen_tpu/live/sessions.py:467-584
class MultiKeyLinearSession:
    """Streaming linearizability over an :mod:`jepsen_tpu_torch.independent`
    key-lifted register history: demuxes ``[k, v]`` tuple values into
    one :class:`LinearLiveSession` per key (the streaming twin of
    ``independent.subhistory`` — ops without a tuple value are outside
    every sub-history there too, so they only count toward lag)."""

    workload = "register-independent"

    def __init__(self, accelerator: str = "auto", device=None):
        _check_accelerator(accelerator)
        self.accelerator = accelerator
        self.device = device
        self.sub: dict = {}
        self.ops_absorbed = 0
        self._last = {"valid_so_far": True, "first_anomaly_op": None,
                      "backend": FRONTIER_BACKEND, "checked_ops": 0}

    def add(self, op: dict) -> None:
        from jepsen_tpu_torch import independent
        self.ops_absorbed += 1
        v = independent.keyed_value(op)
        if v is None:
            return
        k = independent._freeze_key(v[0])
        sess = self.sub.get(k)
        if sess is None:
            sess = self.sub[k] = LinearLiveSession(
                accelerator=self.accelerator, device=self.device)
        sess.add({**op, "value": v[1]})

    def add_many(self, ops: list) -> None:
        for op in ops:
            self.add(op)

    @property
    def checked_ops(self) -> int:
        routed = sum(s.ops_absorbed for s in self.sub.values())
        checked = sum(s.checked_ops for s in self.sub.values())
        # unroutable ops (nemesis, value-less infos) need no checking
        return self.ops_absorbed - routed + checked

    def last(self) -> dict:
        return dict(self._last)

    def _merge(self, per_key: dict) -> dict:
        valids = [r.get("valid_so_far") for r in per_key.values()]
        valid = (False if any(x is False for x in valids)
                 else "unknown" if any(x == "unknown" for x in valids)
                 else True)
        firsts = [r.get("first_anomaly_op") for r in per_key.values()
                  if r.get("first_anomaly_op") is not None]
        self._last = {
            "valid_so_far": valid,
            "first_anomaly_op": min(firsts) if firsts else None,
            "backend": FRONTIER_BACKEND,
            "checked_ops": self.checked_ops,
            "keys": len(self.sub),
        }
        return dict(self._last)

    def snapshot(self) -> dict | None:
        """Composes the per-key sessions' snapshots; any unsnapshotable
        key rejects the whole (a partial restore would silently drop a
        key's history)."""
        import json
        subs = []
        for k, s in self.sub.items():
            sub = s.snapshot()
            if sub is None:
                return None
            key = list(k) if isinstance(k, tuple) else k
            subs.append([key, sub])
        try:
            if json.loads(json.dumps(subs)) != subs:
                return None
        except (TypeError, ValueError):
            return None
        return {"workload": self.workload,
                "ops_absorbed": self.ops_absorbed,
                "last": dict(self._last), "sub": subs}

    @classmethod
    def restore(cls, snap: dict, accelerator: str = "auto", device=None):
        from jepsen_tpu_torch.independent import _freeze_key
        try:
            sess = cls(accelerator=accelerator, device=device)
            sess.ops_absorbed = int(snap["ops_absorbed"])
            last = snap.get("last")
            if isinstance(last, dict):
                sess._last = last
            for key, sub in snap["sub"]:
                restored = LinearLiveSession.restore(
                    sub, accelerator=accelerator, device=device)
                if restored is None:
                    return None
                sess.sub[_freeze_key(key)] = restored
            return sess
        except (KeyError, TypeError, ValueError):
            return None

    def verdict(self) -> dict:
        return self._merge({k: s.verdict() for k, s in self.sub.items()})

    def finalize(self) -> dict:
        results = {str(k): s.finalize() for k, s in self.sub.items()}
        self._merge({k: s.last() for k, s in self.sub.items()})
        valid = self._last["valid_so_far"]
        return {
            "valid?": valid,
            "count": len(results),
            "failures": sorted(k for k, r in results.items()
                               if r.get("valid?") is not True),
            "results": results,
        }


# copied from jepsen_tpu/live/sessions.py:587-634
#: session_for_ops sentinel: client ops seen, no live checker matches
UNSUPPORTED = object()


def restore_session(snap, accelerator: str = "auto", device=None):
    """A session rebuilt from a snapshot's ``session`` payload (a
    restart's path), or None when the payload is missing, names an
    unknown workload, or fails to restore — the caller then re-ingests
    the WAL from zero."""
    if not isinstance(snap, dict):
        return None
    workload = snap.get("workload")
    if workload == "register":
        return LinearLiveSession.restore(snap, accelerator=accelerator,
                                         device=device)
    if workload == "register-independent":
        return MultiKeyLinearSession.restore(snap, accelerator=accelerator,
                                             device=device)
    return None


def session_for_ops(ops: list[dict], accelerator: str = "auto",
                    device=None):
    """Sniffs the workload from the first client invocations and builds
    the matching session. Returns None while the evidence is still
    ambiguous (keep buffering), or :data:`UNSUPPORTED` when the
    workload has no live checker (the caller then reports lag only)."""
    from jepsen_tpu_torch.independent import is_tuple_value
    for op in ops:
        p, f = op.get("process"), op.get("f")
        if not isinstance(p, int) or p < 0 or f is None:
            continue
        v = op.get("value")
        if f in ("read", "write"):
            # plain registers carry None/scalar values; key-lifted ones
            # carry [k, v] tuples (independent.tuple_value)
            if is_tuple_value(v):
                return MultiKeyLinearSession(accelerator=accelerator,
                                             device=device)
            return LinearLiveSession(accelerator=accelerator, device=device)
        if f == "cas":
            # plain cas: [u, v] scalars; lifted cas: [k, [u, v]]
            if is_tuple_value(v) and isinstance(v[1], (list, tuple)):
                return MultiKeyLinearSession(accelerator=accelerator,
                                             device=device)
            if is_tuple_value(v):
                return LinearLiveSession(accelerator=accelerator,
                                         device=device)
            continue  # malformed/valueless cas: keep sniffing
        if f == "txn":
            mops = op.get("value") or ()
            fs = {m[0] for m in mops if isinstance(m, (list, tuple)) and m}
            if not fs:
                continue
            if fs <= {"append", "r"}:
                return ElleSession(accelerator=accelerator, device=device)
            return UNSUPPORTED  # multi-register txns: no live checker yet
        return UNSUPPORTED
    return None
