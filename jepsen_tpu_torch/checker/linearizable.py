"""Linearizability checker for every model of jepsen_tpu_torch.models.

Reference surface: jepsen.checker/linearizable (checker.clj:185-216) as
ported by jepsen_tpu/checker/linearizable.py. ``algorithm`` is "wgl"
(the object-model search ``linear_cpu.wgl``), "jitlin" (the int-encoded
search below) or "auto" (= "jitlin"). The models with an int encoding,
``CASRegister`` and ``MultiRegister`` (within its packed encoding, shape
``multi_shape``), take the int-encoded rungs; every other model, and a
multi-register history outside the packed encoding, runs ``wgl``. The
rungs, tried in order:

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
bisection steps. The forensics never fail a check. Their localization
runs on the checker's device, or on the CPU under ``accelerator="cpu"``.
Not ported: the artifacts the reference writes beside them.

A test map with a ``start_time`` gives the check a durable checkpoint,
``store_dir/name/start_time/check.ckpt`` (checker/checkpoint.py): the
matrix chain and the CPU rung persist their carry there and resume a
valid one; a settled check removes it. ``check_ckpt_interval`` and
``resume_check`` in the test map tune it.
"""
from __future__ import annotations

import logging
from typing import Any

import numpy as np

from jepsen_tpu_torch.checker import Checker
from jepsen_tpu_torch.checker.explain import (
    enabled, explain_stream, max_witness_ops, shrink_budget)
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

    # copied from jepsen_tpu/checker/linearizable.py:74-117, without the
    # history IR
    def _encoding(self, history):
        """(stream, step_py, spec) when the model has an int encoding,
        else None (the object-model wgl search). A non-None initial
        register value interns FIRST so its id is the initial state."""
        if isinstance(self.model, CASRegister):
            intern = Intern()
            if self.model.value is not None:
                intern.id(self.model.value)
            stream = encode_register_ops(history, intern=intern)
            init_id = (0 if self.model.value is None
                       else stream.intern.id(self.model.value))
            return stream, cas_register_step_py, cas_register_spec(init_id)
        if isinstance(self.model, MultiRegister):
            k, v = self.multi_shape
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
        # copied from jepsen_tpu/checker/linearizable.py:149-165
        explain_on = enabled(test, opts)
        enc = None if algorithm == "wgl" else self._encoding(history)
        if enc is None:
            return self._finish(wgl(history, self.model), history)
        stream, step_py, spec = enc
        extras: dict = {}
        # copied from jepsen_tpu/checker/linearizable.py:175-186: a check
        # with store coordinates persists its carry to check.ckpt and
        # resumes a valid one; a settled check clears it
        ckpt = self._ckpt_store(test)
        res = self._search_stream(stream, step_py, spec, accelerator,
                                  explain=explain_on, extras=extras,
                                  ckpt=ckpt)
        if ckpt is not None:
            ckpt.clear()
        return self._finish(res, history, stream, step_py, spec.init_state,
                            test=test, step_ids=spec.step_ids,
                            explain_on=explain_on,
                            explain_loc=extras.get("loc"),
                            device=("cpu" if accelerator == "cpu"
                                    else self.device))

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

    def _matrix_rung(self, stream, spec, ckpt, carries: list):
        """The matrix screen (jepsen_tpu/checker/linearizable.py:302-333,
        ``matrix_rung_check``): one-shot ``matrix_check`` for a stream
        within one segment when no resume is pending (no check.ckpt), else
        the resumable chain ``matrix_check_segmented``, whose carries after
        each exact, alive segment go to ``carries``. Bit-identical either
        way."""
        from jepsen_tpu_torch.ops import jitlin
        kw = dict(step_ids=spec.step_ids, init_state=spec.init_state,
                  num_states=len(stream.intern), device=self.device)
        resume_pending = (ckpt is not None and ckpt.resume
                          and ckpt.path.exists())
        if not resume_pending and len(stream) <= jitlin.MATRIX_SEGMENT_EVENTS:
            return jitlin.matrix_check(stream, **kw)
        return jitlin.matrix_check_segmented(stream, ckpt=ckpt,
                                             carry_sink=carries.append, **kw)

    def _search_stream(self, stream, step_py, spec, accelerator,
                       explain: bool = True,
                       extras: dict | None = None,
                       ckpt=None) -> LinearResult:
        """The rungs over an encoded stream. With ``explain``, a
        localization that settles the matrix rung goes to
        ``extras["loc"]`` for the witness shrink. ``ckpt`` (a
        ``checkpoint.CheckpointStore``) makes the matrix chain and the CPU
        rung resumable."""
        from jepsen_tpu_torch.ops.jitlin import (
            JitLinKernel, matrix_localize, matrix_ok, verdict)

        device_regime = not (accelerator == "cpu" or (
            accelerator == "auto" and len(stream) < AUTO_TPU_THRESHOLD))
        attempted = False
        carries: list = []
        if device_regime:
            n_returns = int((np.asarray(stream.kind) == EV_RETURN).sum())
            if matrix_ok(stream.n_slots, len(stream.intern), n_returns):
                attempted = True
                m = self._matrix_rung(stream, spec, ckpt, carries)
                # copied from jepsen_tpu/checker/linearizable.py:347-383
                # (matrix_settle): an exact True settles valid; an exact
                # False settles invalid at its localized event when explain
                # is on; inexact, explain off or a declined localization
                # pass the history on. An error of the localization
                # propagates (the reference demotes on it). A chain's
                # invalid verdict localizes over the whole stream.
                if m is not None and not m[2] and m[0]:
                    return LinearResult(valid=True, algorithm="torch-matrix")
                if m is not None and not m[2] and explain:
                    loc = matrix_localize(stream, step_ids=spec.step_ids,
                                          init_state=spec.init_state,
                                          num_states=len(stream.intern),
                                          device=self.device)
                    if loc is not None:
                        if extras is not None:
                            extras["loc"] = loc
                        return LinearResult(
                            valid=False, failed_event=loc.failed_event,
                            failed_op_index=loc.failed_op_index,
                            configs_max=0, algorithm="torch-matrix")
            # the dense table takes S <= 12, so one bound gates both
            if stream.n_slots <= FRONTIER_MAX_SLOTS:
                attempted = True
                # copied from jepsen_tpu/checker/linearizable.py:485-502
                kernel = JitLinKernel(step_ids=spec.step_ids,
                                      init_state=spec.init_state,
                                      device=self.device)
                alive, died, overflow, peak = kernel.check(
                    stream, capacity=self.capacity)
                valid = verdict(alive, overflow)
                if valid != "unknown":
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
            res = check_stream_native(stream)
            if res is not None and res.valid != "unknown":
                return res
        res = self._cpu_rung(stream, step_py, spec.init_state, ckpt,
                             carries[-1] if carries else None)
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

    # copied from jepsen_tpu/checker/linearizable.py:675-713 without the
    # plot, the trace and the explain artifacts
    def _finish(self, res: LinearResult, history, stream=None,
                step_py=None, init_state: int = 0, test=None, step_ids=None,
                explain_on: bool = False, explain_loc=None,
                device=None) -> dict:
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
            if res.final_configs is None and stream is not None \
                    and len(stream) <= MAX_REPORT_EVENTS:
                res2 = check_stream(stream, step=step_py,
                                    init_state=init_state)
                if res2.valid is False:
                    res.final_configs = res2.final_configs
            if res.final_configs is not None:
                out["final-configs"] = res.final_configs
            self._explain(out, res, test, stream, step_py, init_state,
                          step_ids, explain_on, explain_loc, device)
        return out

    # copied from jepsen_tpu/checker/linearizable.py:752-786 without
    # write_artifacts
    @staticmethod
    def _explain(out, res, test, stream, step_py, init_state, step_ids,
                 explain_on, explain_loc, device) -> None:
        """Anomaly forensics for an INVALID verdict: localize and shrink a
        minimal witness, and surface a summary in the result. Never fails
        the check; ``explain: False`` turns it off."""
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
        except Exception:  # noqa: BLE001 — forensics never mask a verdict
            logger.exception("anomaly forensics failed")


def linearizable(model=None, **kw) -> Checker:
    return LinearizableChecker(model=model, **kw)
