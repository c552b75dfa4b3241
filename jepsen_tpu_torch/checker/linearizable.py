"""Linearizability checker for every model of jepsen_tpu_torch.models.

Reference surface: jepsen.checker/linearizable (checker.clj:185-216) as
ported by jepsen_tpu/checker/linearizable.py. ``algorithm`` is "wgl"
(the object-model search ``linear_cpu.wgl``), "jitlin" (the int-encoded
search below) or "auto" (= "jitlin"). The models with an int encoding,
``CASRegister`` and ``MultiRegister`` (within its packed encoding, shape
``multi_shape``), take the int-encoded rungs; every other model, and a
multi-register history outside the packed encoding, runs ``wgl``. The
rungs, tried in order:

* ``torch-sharded-matrix`` — the matrix check below with its chunk axis
  sharded over a device mesh (``parallel.Mesh``; ops/jitlin.py
  ``_build_matrix_kernel_mesh``), in the same regime. ``checker_sharded``
  (opts over the test map, ``parallel.sharding_knobs``): True takes
  ``parallel.auto_mesh(mesh_devices)``, False turns the rung off, unset
  asks the cost model (``parallel.sharded_mesh_for``) for a checker on a
  card. On one card ``auto_mesh`` is None and the rung does not run. It
  settles as ``torch-matrix`` does (an invalid verdict localizes on one
  device); a screen that finished without settling is not repeated by
  ``torch-matrix``. An error of a shard propagates.
* ``torch-matrix`` — the block-composed transfer-matrix check
  (ops/jitlin.matrix_check) on the device, for histories in its regime;
  a stream longer than MATRIX_SEGMENT_EVENTS = 2^20 events, or one with
  a pending checkpoint, runs as a chain of segments cut at quiescent
  points (ops/jitlin.matrix_check_segmented). An exact True settles
  valid. With ``explain`` on (the default), an
  exact False localizes the first anomaly on the device
  (ops/jitlin.matrix_localize) and settles invalid with its event; with
  it off, or when the localization declines, and on an inexact verdict,
  the history passes on.
* ``torch-frontier`` — the reference's ``jitlin-device`` rung: the
  frontier scan of the whole history (ops/jitlin.JitLinKernel, the
  dense-table or sparse-frontier kernel) on the device. It settles
  valid, or invalid with the event at which the frontier died; an
  overflowed (or, for the dense table, inexact) frontier that died
  ("unknown") passes the history on. Streams with more than
  FRONTIER_MAX_SLOTS = 31 slots skip it.
* ``native-c`` — the C++ search (jepsen_tpu_torch/native, algorithm
  ``jitlin-native``), on the host regime only (``accelerator="cpu"``, or
  ``"auto"`` below AUTO_TPU_THRESHOLD events), for the CAS register from
  an initial state of id 0. Its capacity (-1) and slot (-2) limits pass
  the history on.
* ``cpu`` — the exact CPU twin (linear_cpu.check_stream with the
  encoding's step), which settles everything the other rungs did not,
  with the failing op; it starts at the matrix chain's last cut when the
  chain sank a carry. After a device rung ran, its algorithm reads
  ``jitlin-cpu(fallback)``.

``accelerator`` is "gpu" (the device rung whenever in regime), "cpu" or
"auto" (the device rung from AUTO_TPU_THRESHOLD events up). The native
rung does not run after a device rung, and returns no final
configurations: an invalid verdict re-runs ``check_stream`` for them, as
every invalid verdict from a rung without them does.

``explain`` (opts over the test map, default on; checker/explain.py)
adds anomaly forensics to an invalid result of the int-encoded rungs:
``out["explain"]`` holds the first anomaly's op, the size of a shrunk
witness, the backend (``matrix-bisect`` or ``frontier-cpu``) and the
bisection steps, and with a test map that addresses a store dir, the
artifacts written there (``anomaly.json`` and ``witness-timeline.html``,
``explain.write_artifacts``). The forensics never fail a check. Their
localization runs on the checker's device, or on the CPU under
``accelerator="cpu"``.

An invalid result also carries ``plot``: the path of ``linear.png``
(``checker/linear_report.render_failure``: the ops around the failure
and the dying configurations) in the test's store dir, or None when the
test map addresses none or the rendering fails (``matplotlib`` missing,
among others). Rendering never masks a verdict.

A test map with a ``start_time`` gives the check a durable checkpoint,
``store_dir/name/start_time/check.ckpt`` (checker/checkpoint.py): the
matrix chain and the CPU rung persist their carry there and resume a
valid one; a settled check removes it. ``check_ckpt_interval`` and
``resume_check`` in the test map tune it.

With a live telemetry registry or run tracer (``telemetry.use``,
``trace.use``), a check records the reference's instruments: the settling
backend, its times and events/s, the card's allocator high-water, and
the matrix rungs' phase split (``_record_metrics``);
each rung tried is a ``rung`` slice on the ladder track, a declined one
adds the reference's ``demote``, and an invalid verdict an ``explain``
instant with its op's trace id. Off by default, they cost a few attribute
reads a check.

:func:`check_stored` re-checks a stored run from the ``lin_*`` columns of
its ``history.npz`` sidecar (store.py), through the same rungs and with
no re-encode: a valid verdict settles there, ``"(stored)"`` after its
algorithm; anything else re-checks ``history.jsonl``.
"""
from __future__ import annotations

import logging
import time
from typing import Any

import numpy as np

from jepsen_tpu_torch import telemetry
from jepsen_tpu_torch import trace as trace_mod
from jepsen_tpu_torch.checker import Checker
from jepsen_tpu_torch.checker.explain import (
    enabled, explain_stream, max_witness_ops, shrink_budget, write_artifacts)
from jepsen_tpu_torch.checker.linear_cpu import (
    LinearResult, cas_register_step_py, check_stream, multi_register_step_py,
    wgl,
)
from jepsen_tpu_torch.checker.linear_encode import (
    EV_RETURN, encode_multi_register_ops, encode_register_ops,
)
from jepsen_tpu_torch.history import Intern
from jepsen_tpu_torch.models import (
    CASRegister, Model, MultiRegister, cas_register_spec, multi_register_spec,
)

logger = logging.getLogger("jepsen_tpu_torch.checker.linearizable")

# Histories below this many events run on CPU under accelerator="auto"
# (jepsen_tpu/checker/linearizable.py:36).
AUTO_TPU_THRESHOLD = 512

# Failure reports re-run the exact CPU search to recover the dying
# frontier; skip that recovery for histories longer than this.
MAX_REPORT_EVENTS = 200_000

# The frontier rung's sparse capacity K
# (jepsen_tpu/checker/linearizable.py:54).
FRONTIER_CAPACITY = 256

ACCELERATORS = ("gpu", "cpu", "auto")
ALGORITHMS = ("auto", "jitlin", "wgl")

# The most slots a stream may have to take the frontier rung. The sparse
# frontier's masks are uint32 and mask 0xFFFFFFFF is its empty entry
# (ops/frontier_kernels.py, csrc/frontier_sparse.cu), so a live
# configuration with all 32 slots linearized would read as empty: a
# 32-slot stream settles in the exact twin instead.
FRONTIER_MAX_SLOTS = 31

# the rungs that run on the checker's device, and the matrix rungs among
# them (``_record_metrics``)
DEVICE_RUNGS = ("torch-sharded-matrix", "torch-matrix", "torch-frontier")
MATRIX_RUNGS = ("torch-sharded-matrix", "torch-matrix")

# backends whose first check was recorded (jepsen_tpu/checker/
# linearizable.py:45): the first check of a process pays the kernels'
# build and the CUDA context
_FIRST_CHECK_SEEN: set = set()


# copied from jepsen_tpu/checker/ladder.py:217-228, without the log line
def _demote(name: str, reason: str) -> None:
    reg = telemetry.get_registry()
    if reg.enabled:
        reg.counter("checker_backend_demotions_total",
                    "ladder demotions, by backend and reason",
                    labels=("backend", "reason")
                    ).inc(backend=name, reason=reason)
    trace_mod.get_tracer().instant(
        trace_mod.TRACK_LADDER, "demote",
        args={"backend": name, "reason": reason})


class _Rung:
    """One attempt of a rung, as the reference's ladder traces it
    (jepsen_tpu/checker/ladder.py:296-382): a ``rung`` slice on the
    ladder track whose ``outcome`` is "settled" when the block set
    ``settled``, "declined" (then the reference's ``demote``) when it did
    not, "error" when it raised. The error propagates: no rung of the
    port demotes on one."""

    __slots__ = ("backend", "settled", "_tracer", "_t0")

    def __init__(self, backend: str):
        self.backend = backend
        self.settled = False

    def __enter__(self):
        self._tracer = trace_mod.get_tracer()
        self._t0 = trace_mod.now_us() if self._tracer.enabled else 0
        return self

    def __exit__(self, exc_type, exc, tb):
        outcome = ("error" if exc_type is not None
                   else "settled" if self.settled else "declined")
        if self._tracer.enabled:
            self._tracer.complete(
                trace_mod.TRACK_LADDER, "rung", self._t0,
                trace_mod.now_us() - self._t0,
                args={"backend": self.backend, "outcome": outcome})
        if outcome == "declined":
            _demote(self.backend, "declined")
        return False


class LinearizableChecker(Checker):
    def __init__(self, model: Model | None = None, algorithm: str = "auto",
                 accelerator: str = "auto", device=None,
                 capacity: int = FRONTIER_CAPACITY,
                 multi_shape: tuple = (3, 5)):
        self.model = model if model is not None else CASRegister()
        if algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm {algorithm!r} not in {ALGORITHMS}")
        if accelerator not in ACCELERATORS:
            raise ValueError(f"accelerator {accelerator!r} not in "
                             f"{ACCELERATORS}")
        self.algorithm = algorithm
        self.accelerator = accelerator
        # None = the CUDA device; resolved when the device rung runs
        self.device = device
        self.capacity = capacity
        # (n_keys, n_values) of the MultiRegister int encoding: the
        # multi-key-acid workload's shape (multi_key_acid.clj key-range,
        # rand-val)
        self.multi_shape = multi_shape

    # copied from jepsen_tpu/checker/linearizable.py:74-117
    def _encoding(self, history, ir=None):
        """(stream, step_py, spec) when the model has an int encoding,
        else None (the object-model wgl search). With an ``ir`` (the
        run's shared history IR) the stream is its memoized view, so a
        second checker over the same history pays no encode (the same
        stream either way). A non-None initial register value interns
        FIRST so its id is the initial state."""
        from jepsen_tpu_torch.history_ir import views
        if isinstance(self.model, CASRegister):
            if ir is not None:
                stream = views.register_stream(ir,
                                               init_value=self.model.value)
            else:
                intern = Intern()
                if self.model.value is not None:
                    intern.id(self.model.value)
                stream = encode_register_ops(history, intern=intern)
            init_id = (0 if self.model.value is None
                       else stream.intern.id(self.model.value))
            return stream, cas_register_step_py, cas_register_spec(init_id)
        if isinstance(self.model, MultiRegister):
            k, v = self.multi_shape
            if ir is not None:
                stream = views.multi_register_stream(ir, k, v)
                if stream is None:
                    return None  # outside the packed encoding: wgl
            else:
                try:
                    stream = encode_multi_register_ops(history, k, v)
                except ValueError:
                    return None  # outside the packed encoding: wgl
            return (stream, multi_register_step_py(k, v),
                    multi_register_spec(k, v))
        return None

    def check(self, test, history, opts):
        algorithm = opts.get("algorithm", self.algorithm)
        accelerator = opts.get("accelerator", self.accelerator)
        if algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm {algorithm!r} not in {ALGORITHMS}")
        # copied from jepsen_tpu/checker/linearizable.py:149-165: the
        # encode goes through the run's shared history IR when the test
        # map can carry one (history_ir.of memoizes on it)
        explain_on = enabled(test, opts)
        t0 = time.perf_counter()
        enc = None
        if algorithm != "wgl":
            from jepsen_tpu_torch import history_ir
            enc = self._encoding(history, ir=history_ir.of(test, history))
        if enc is None:
            res = wgl(history, self.model)
            self._record_metrics(res, time.perf_counter() - t0,
                                 len(history))
            return self._finish(res, history, test=test, opts=opts)
        stream, step_py, spec = enc
        from jepsen_tpu_torch.parallel import sharding_knobs
        sharded, mesh_devices = sharding_knobs(test, opts)
        extras: dict = {}
        # copied from jepsen_tpu/checker/linearizable.py:175-186: a check
        # with store coordinates persists its carry to check.ckpt and
        # resumes a valid one; a settled check clears it
        ckpt = self._ckpt_store(test)
        res = self._search_stream(stream, step_py, spec, accelerator,
                                  explain=explain_on, extras=extras,
                                  ckpt=ckpt, sharded=sharded,
                                  mesh_devices=mesh_devices)
        if ckpt is not None:
            ckpt.clear()
        self._record_metrics(res, time.perf_counter() - t0, len(stream))
        return self._finish(res, history, stream, step_py, spec.init_state,
                            test=test, step_ids=spec.step_ids,
                            explain_on=explain_on,
                            explain_loc=extras.get("loc"),
                            device=("cpu" if accelerator == "cpu"
                                    else self.device), opts=opts)

    # copied from jepsen_tpu/checker/linearizable.py:195-212
    @staticmethod
    def _ckpt_store(test):
        """The run's durable check.ckpt store, or None when the test map
        has no store coordinates (no ``start_time``) or checkpointing and
        resumption are both off."""
        if not isinstance(test, dict) or not test.get("start_time"):
            return None
        from jepsen_tpu_torch.checker import checkpoint as ckpt_mod
        interval = ckpt_mod.ckpt_interval(test)
        resume = ckpt_mod.resume_enabled(test)
        if interval is None and not resume:
            return None
        try:
            from jepsen_tpu_torch import store
            path = store.path(test, ckpt_mod.CKPT_NAME)
        except Exception:  # noqa: BLE001 — no store dir: no checkpoints
            return None
        return ckpt_mod.CheckpointStore(path, interval_s=interval,
                                        resume=resume)

    def _matrix_rung(self, stream, spec, ckpt, carries: list, mesh=None):
        """The matrix screen (jepsen_tpu/checker/linearizable.py:302-333,
        ``matrix_rung_check``): one-shot ``matrix_check`` for a stream
        within one segment when no resume is pending (no check.ckpt), else
        the resumable chain ``matrix_check_segmented``, whose carries after
        each exact, alive segment go to ``carries``. Bit-identical either
        way, and sharded over ``mesh`` when one is given."""
        from jepsen_tpu_torch.ops import jitlin
        kw = dict(step_ids=spec.step_ids, init_state=spec.init_state,
                  num_states=len(stream.intern), device=self.device,
                  mesh=mesh)
        resume_pending = (ckpt is not None and ckpt.resume
                          and ckpt.path.exists())
        if not resume_pending and len(stream) <= jitlin.MATRIX_SEGMENT_EVENTS:
            return jitlin.matrix_check(stream, **kw)
        return jitlin.matrix_check_segmented(stream, ckpt=ckpt,
                                             carry_sink=carries.append, **kw)

    # copied from jepsen_tpu/checker/linearizable.py:411-428
    # (``sharded_eligible``)
    def _sharded_mesh(self, stream, sharded, mesh_devices):
        """The mesh of the ``torch-sharded-matrix`` rung, or None: False
        turns it off, True takes ``auto_mesh`` past the cost gate, unset
        asks ``sharded_mesh_for`` when SHARDED is on and the checker's
        device is a card."""
        from jepsen_tpu_torch import parallel
        from jepsen_tpu_torch.device import resolve_device
        if sharded is False:
            return None
        if sharded is True:
            return parallel.auto_mesh(mesh_devices)
        if not parallel.sharded_enabled() \
                or resolve_device(self.device).type != "cuda":
            return None
        return parallel.sharded_mesh_for(len(stream), mesh_devices)

    # copied from jepsen_tpu/checker/linearizable.py:347-383
    # (``matrix_settle``)
    def _matrix_settle(self, m, stream, spec, explain, extras,
                       algorithm) -> LinearResult | None:
        """A finished matrix screen's verdict: an exact True settles
        valid; an exact False settles invalid at its localized event when
        ``explain`` is on (the localization runs on the checker's one
        device, for a sharded screen too); inexact, explain off or a
        declined localization give None. An error of the localization
        propagates (the reference demotes on it)."""
        from jepsen_tpu_torch.ops.jitlin import matrix_localize
        if m is None or m[2]:
            return None
        if m[0]:
            return LinearResult(valid=True, algorithm=algorithm)
        if not explain:
            return None
        loc = matrix_localize(stream, step_ids=spec.step_ids,
                              init_state=spec.init_state,
                              num_states=len(stream.intern),
                              device=self.device)
        if loc is None:
            return None
        if extras is not None:
            extras["loc"] = loc
        return LinearResult(valid=False, failed_event=loc.failed_event,
                            failed_op_index=loc.failed_op_index,
                            configs_max=0, algorithm=algorithm)

    def _search_stream(self, stream, step_py, spec, accelerator,
                       explain: bool = True,
                       extras: dict | None = None,
                       ckpt=None, sharded=None,
                       mesh_devices=None) -> LinearResult:
        """The rungs over an encoded stream. With ``explain``, a
        localization that settles a matrix rung goes to ``extras["loc"]``
        for the witness shrink. ``ckpt`` (a ``checkpoint.CheckpointStore``)
        makes the matrix chain and the CPU rung resumable. ``sharded`` and
        ``mesh_devices`` are ``parallel.sharding_knobs``'s pair."""
        from jepsen_tpu_torch.ops.jitlin import (
            JitLinKernel, matrix_ok, verdict)

        device_regime = not (accelerator == "cpu" or (
            accelerator == "auto" and len(stream) < AUTO_TPU_THRESHOLD))
        attempted = False
        carries: list = []
        if device_regime:
            n_returns = int((np.asarray(stream.kind) == EV_RETURN).sum())
            if matrix_ok(stream.n_slots, len(stream.intern), n_returns):
                attempted = True
                # the sharded screen first; one that finished without
                # settling is bit-identical to the single-device screen,
                # which then does not run (jepsen_tpu/checker/
                # linearizable.py:430-440, ``_matrix_screened``). A chain's
                # invalid verdict localizes over the whole stream.
                mesh = self._sharded_mesh(stream, sharded, mesh_devices)
                rungs = [(None, "torch-matrix")]
                if mesh is not None:
                    rungs.insert(0, (mesh, "torch-sharded-matrix"))
                for rung_mesh, algorithm in rungs:
                    with _Rung(algorithm) as rung:
                        m = self._matrix_rung(stream, spec, ckpt, carries,
                                              mesh=rung_mesh)
                        res = self._matrix_settle(m, stream, spec, explain,
                                                  extras, algorithm)
                        rung.settled = res is not None
                    if res is not None:
                        return res
                    if m is not None:
                        break
            # the dense table takes S <= 12, so one bound gates both
            if stream.n_slots <= FRONTIER_MAX_SLOTS:
                attempted = True
                # copied from jepsen_tpu/checker/linearizable.py:485-502
                with _Rung("torch-frontier") as rung:
                    kernel = JitLinKernel(step_ids=spec.step_ids,
                                          init_state=spec.init_state,
                                          device=self.device)
                    alive, died, overflow, peak = kernel.check(
                        stream, capacity=self.capacity)
                    valid = verdict(alive, overflow)
                    rung.settled = valid != "unknown"
                if rung.settled:
                    return LinearResult(
                        valid=valid, failed_event=died,
                        failed_op_index=(int(stream.op_index[died])
                                         if died >= 0 else -1),
                        configs_max=peak, algorithm="torch-frontier")
        elif isinstance(self.model, CASRegister) and spec.init_state == 0:
            # copied from jepsen_tpu/checker/linearizable.py:513-525: the
            # native rung, host regime only, for the model and init id it
            # hardcodes
            from jepsen_tpu_torch.native import check_stream_native
            with _Rung("native-c") as rung:
                res = check_stream_native(stream)
                rung.settled = res is not None and res.valid != "unknown"
            if rung.settled:
                return res
        with _Rung("cpu") as rung:
            res = self._cpu_rung(stream, step_py, spec.init_state, ckpt,
                                 carries[-1] if carries else None)
            rung.settled = True
        if attempted:
            res.algorithm = "jitlin-cpu(fallback)"
        return res

    @staticmethod
    def _cpu_rung(stream, step_py, init: int, ckpt, carry) -> LinearResult:
        """The exact CPU twin (jepsen_tpu/checker/linearizable.py:527-
        560, ``cpu_fn``): from the matrix chain's last carry when one was
        sunk (``frontier_from_matrix_carry``: the frontier at that cut),
        and checkpointed when the check has a store."""
        from jepsen_tpu_torch.checker import checkpoint as ckpt_mod
        session = None
        if carry is not None and carry.get("init_state") == init:
            session = ckpt_mod.frontier_from_matrix_carry(carry, step_py,
                                                          init)
            if session is not None:
                ckpt_mod.count_resume("carry")
                logger.info("exact CPU frontier resuming from the matrix "
                            "chain's carry at event %d",
                            session.events_absorbed)
        if ckpt is not None:
            return ckpt_mod.checkpointed_check_stream(
                stream, step_py, init, ckpt, session=session)
        if session is not None:
            return session.absorb(stream, start=session.events_absorbed)
        return check_stream(stream, step=step_py, init_state=init)

    # copied from jepsen_tpu/checker/linearizable.py:592-669: the device
    # rungs are the port's, the device memory that of the checker's device
    # (the reference's first local device), the phase split has the
    # port's keys (jitlin.last_phase_seconds), and the modeled-FLOPs and
    # roofline gauges are left out: they model dense f32 products that the
    # port's kernels do not compute. The reference's kernel-variant counter
    # is left out too: the port's split carries no variant
    def _record_metrics(self, res: LinearResult, dt: float,
                        n_events: int) -> None:
        """Telemetry of one check: which backend settled it, first-call
        (the kernels' build and the CUDA context included) and steady
        latency, events/s, the device memory high-water, and on the
        matrix rungs the host phase split. Reads only host values: no
        sync, no read-back."""
        reg = telemetry.get_registry()
        if not reg.enabled:
            return
        try:
            backend = res.algorithm or "unknown"
            reg.counter("checker_backend_total",
                        "checks settled, by winning backend",
                        labels=("backend",)).inc(backend=backend)
            reg.histogram("checker_check_seconds",
                          "check dispatch wall time", labels=("backend",)
                          ).observe(dt, backend=backend)
            first = reg.gauge(
                "checker_first_check_seconds",
                "first dispatch per backend (includes JIT compile)",
                labels=("backend",))
            if backend not in _FIRST_CHECK_SEEN:
                _FIRST_CHECK_SEEN.add(backend)
                first.set(dt, backend=backend)
            else:
                reg.gauge("checker_steady_check_seconds",
                          "most recent non-first dispatch (compile "
                          "amortized; first minus steady ~= compile cost)",
                          labels=("backend",)).set(dt, backend=backend)
            if dt > 0:
                reg.gauge("checker_events_per_sec",
                          "events verified per second, last check",
                          labels=("backend",)
                          ).set(n_events / dt, backend=backend)
            if backend in DEVICE_RUNGS:
                peak_bytes = telemetry.device_memory_peak_bytes(
                    "cuda" if self.device is None else self.device)
                if peak_bytes is not None:
                    reg.gauge("checker_device_memory_peak_bytes",
                              "device allocator high-water"
                              ).set_max(peak_bytes)
            if backend in MATRIX_RUNGS:
                from jepsen_tpu_torch.ops.jitlin import last_phase_seconds
                phase_g = reg.gauge(
                    "checker_matrix_phase_seconds",
                    "host/device phase split of the last matrix "
                    "dispatch", labels=("phase",))
                split = last_phase_seconds()
                for ph, secs in split.items():
                    if isinstance(secs, (int, float)):
                        phase_g.set(secs, phase=ph)
        except Exception:  # noqa: BLE001 — telemetry never fails a check
            logger.exception("checker telemetry recording failed")

    # copied from jepsen_tpu/checker/linearizable.py:715-750
    @staticmethod
    def _trace_anomaly(history, op_index: int, res) -> None:
        """The causal-trace half of an INVALID verdict: an ``explain``
        instant on the checker track carrying the first-anomaly op's
        stable trace id, minted from its invocation's time. Never fails a
        check."""
        try:
            tracer = trace_mod.get_tracer()
            if not tracer.enabled or not (0 <= op_index < len(history)):
                return
            op = history[op_index]
            inv = op
            if op.get("type") != "invoke":
                # walk back to this process's invocation: the most recent
                # earlier invoke by the same process
                for j in range(op_index - 1, -1, -1):
                    cand = history[j]
                    if cand.get("process") == op.get("process") \
                            and cand.get("type") == "invoke":
                        inv = cand
                        break
            tr_id = trace_mod.trace_id_for(inv.get("process"),
                                           inv.get("time"))
            tracer.instant(trace_mod.TRACK_CHECKER, "explain",
                           args={"op_index": op_index,
                                 "f": str(op.get("f")),
                                 "process": op.get("process"),
                                 "algorithm": res.algorithm,
                                 "trace_id": tr_id})
        except Exception:  # noqa: BLE001 — tracing never masks a verdict
            logger.exception("anomaly trace emission failed")

    # copied from jepsen_tpu/checker/linearizable.py:675-713
    def _finish(self, res: LinearResult, history, stream=None,
                step_py=None, init_state: int = 0, test=None, step_ids=None,
                explain_on: bool = False, explain_loc=None,
                device=None, opts=None) -> dict:
        out: dict[str, Any] = {
            "valid?": res.valid,
            "algorithm": res.algorithm,
            "configs-max": res.configs_max,
        }
        if res.valid is False and res.failed_op_index >= 0:
            i = res.failed_op_index
            lo = max(0, i - 5)
            out["failed-op"] = history[i] if i < len(history) else None
            out["context"] = history[lo: i + 1][-10:]
            self._trace_anomaly(history, i, res)
            if res.final_configs is None and stream is not None \
                    and len(stream) <= MAX_REPORT_EVENTS:
                res2 = check_stream(stream, step=step_py,
                                    init_state=init_state)
                if res2.valid is False:
                    res.final_configs = res2.final_configs
            if res.final_configs is not None:
                out["final-configs"] = res.final_configs
            out["plot"] = self._render(res, history, test, opts)
            self._explain(out, res, history, test, stream, step_py,
                          init_state, step_ids, explain_on, explain_loc,
                          device, opts)
        return out

    # copied from jepsen_tpu/checker/linearizable.py:752-786
    @staticmethod
    def _explain(out, res, history, test, stream, step_py, init_state,
                 step_ids, explain_on, explain_loc, device, opts) -> None:
        """Anomaly forensics for an INVALID verdict: localize and shrink a
        minimal witness, write ``anomaly.json`` and the witness timeline
        into the store dir, and surface a summary in the result. Never
        fails the check; ``explain: False`` turns it off."""
        if not explain_on or stream is None:
            return
        try:
            tmap = test if isinstance(test, dict) else {}
            forensics = explain_stream(
                stream, step_ids=step_ids, step_py=step_py,
                init_state=init_state, loc=explain_loc, failure=res,
                shrink_budget=shrink_budget(tmap),
                max_witness_ops=max_witness_ops(tmap), device=device)
            if forensics is None:
                return
            out["explain"] = {
                "first-anomaly-op": forensics["first_anomaly"]["op_index"],
                "witness-ops": len(forensics["witness"]["op_indices"]),
                "backend": forensics["backend"],
                "bisect-steps": forensics["bisect_steps"],
            }
            if test is not None:
                arts = write_artifacts(test, history, forensics, opts=opts)
                if arts:
                    out["explain"]["artifacts"] = sorted(
                        str(k) for k in arts)
        except Exception:  # noqa: BLE001 — forensics never mask a verdict
            logger.exception("anomaly forensics failed")

    # copied from jepsen_tpu/checker/linearizable.py:787-798, under the
    # opts' subdirectory: the reference writes every key of a lifted check
    # to the run's one linear.png (ROADMAP Queue 3 item 6)
    @staticmethod
    def _render(res, history, test, opts=None) -> str | None:
        """linear.png into the test's store dir (checker.clj:205-212),
        under ``independent/<k>`` for a key of a lifted check, beside its
        ``anomaly.json``."""
        if test is None:
            return None
        try:
            from jepsen_tpu_torch import store
            from jepsen_tpu_torch.checker.linear_report import render_failure
            sub = (opts or {}).get("subdirectory")
            path = str(store.path_mk(test, *filter(None, [sub,
                                                          "linear.png"])))
            return render_failure(history, res, path)
        except Exception:  # noqa: BLE001  rendering must not mask verdicts
            logger.exception("linear.png rendering failed")
            return None


def linearizable(model=None, **kw) -> Checker:
    return LinearizableChecker(model=model, **kw)


# copied from jepsen_tpu/checker/linearizable.py:805-850. An error of the
# stored lane's check propagates, a kernel's above all: the reference logs
# it and falls back to the jsonl ("fast lane must never block"), which
# would hide a failed kernel
def check_stored(test_name: str, timestamp: str, store_dir: str = "store",
                 model=None, accelerator: str = "auto",
                 device=None) -> dict:
    """Re-checks a STORED register run's linearizability, preferring the
    ``lin_*`` EventStream columns in its history.npz sidecar — no jsonl
    load, no re-encoding. The stored lane settles only VALID verdicts
    (``algorithm`` ends in ``"(stored)"``) through the same rungs as
    ``check``; anything else — invalid (the failure report needs the
    ops), a model other than ``CASRegister``, a missing, damaged or
    older sidecar — goes to the jsonl history through the normal
    check. Device work runs on ``device`` (the CUDA device by
    default)."""
    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.checker.linear_encode import stream_from_columns

    model = model if model is not None else CASRegister()
    stream = None
    if isinstance(model, CASRegister):
        try:
            cols = store.load_linear_columns(test_name, timestamp,
                                             store_dir)
            # decoding the columns is part of loading them: a malformed
            # lin_* set falls back like an unreadable sidecar
            if cols is not None:
                stream = stream_from_columns(cols)
                init_id = (0 if model.value is None
                           else stream.intern.id(model.value))
        except Exception as e:  # noqa: BLE001 - damaged sidecar: use jsonl
            store.note_sidecar_load_failure(
                f"{test_name}/{timestamp} (lin_*)", e)
            stream = None
    if stream is not None:
        spec = cas_register_spec(init_id)
        checker = LinearizableChecker(model=model, accelerator=accelerator,
                                      device=device)
        # the rungs check() runs, so the stored lane can't drift from the
        # live one; explain=False: an invalid stored verdict goes to the
        # jsonl check below, which localizes itself
        res = checker._search_stream(stream, cas_register_step_py, spec,
                                     accelerator, explain=False)
        res.algorithm += "(stored)"
        if res.valid is True:
            return checker._finish(res, [])
    history = store.load_history(test_name, timestamp, store_dir)
    checker = LinearizableChecker(model=model, accelerator=accelerator,
                                  device=device)
    return checker.check({"name": test_name, "start_time": timestamp,
                          "store_dir": store_dir}, history, {})

