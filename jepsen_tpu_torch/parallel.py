"""Key-batched checking of independent per-key register histories
(jepsen_tpu/parallel/__init__.py:446-647, without the device mesh and
the round-trip cost model).

:func:`batch_check` checks B keys' event streams together. On the card
the key-batched transfer-matrix screen (``jitlin.matrix_check_batch``)
runs first when the batch is in its regime; the keys it leaves
undecided (not alive, or inexact) go to one key-batched frontier launch
(``frontier_dense_batch`` or ``frontier_sparse_batch``, one CTA a key),
whose results replace the screen's. The CPU lane searches the CAS
register key by key with the native C++ search, then the Python twin for
what it does not take; a batch of another spec keeps the device lane.
"""
from __future__ import annotations

import logging
import threading
from typing import Sequence

import numpy as np
import torch

from jepsen_tpu_torch.checker.linearizable import (
    ACCELERATORS, AUTO_TPU_THRESHOLD)
from jepsen_tpu_torch.device import resolve_device
from jepsen_tpu_torch.models import KERNEL_CAS, kernel_model
from jepsen_tpu_torch.ops import frontier_kernels, jitlin
from jepsen_tpu_torch.ops.jitlin import (
    EV_RETURN, JitLinKernel, _bucket, _dense_ok, matrix_check_batch)
from jepsen_tpu_torch.utils import bounded_pmap

logger = logging.getLogger("jepsen_tpu_torch.parallel")

# How the calling thread's most recent batch_check settled: "device" or
# "cpu" (jepsen_tpu/parallel/__init__.py:440-448).
_ROUTE = threading.local()


# copied from jepsen_tpu/parallel/__init__.py:77-94
def coerce_flag(value, knob: str = "checker_sharded") -> bool | None:
    """Tolerant bool knob coercion: None/'' unset; bools and 0/1 pass;
    yes/no/true/false/on/off strings work; garbage warns and reads as
    unset (the caller's default then applies)."""
    if value is None or value == "":
        return None
    if isinstance(value, bool):
        return value
    if isinstance(value, (int, float)) and value in (0, 1):
        return bool(value)
    if isinstance(value, str):
        s = value.strip().lower()
        if s in ("1", "true", "yes", "on"):
            return True
        if s in ("0", "false", "no", "off"):
            return False
    logger.warning("ignoring malformed %s=%r (want a bool)", knob, value)
    return None


def last_route() -> str:
    """The lane the calling thread's most recent batch_check took."""
    return getattr(_ROUTE, "value", "device")


def batch_check(streams: Sequence, capacity: int = 256, step_ids=None,
                init_state: int = 0, kernel: JitLinKernel | None = None,
                accelerator: str = "gpu", device=None) -> list:
    """Checks a batch of per-key event streams. Returns [(alive,
    died_event, overflow, peak)] per stream, as the reference's
    ``batch_check`` does.

    ``accelerator``: "gpu" (the card), "cpu" (the native/Python lane,
    bounded-thread-parallel over keys) or "auto": the CPU lane for a
    batch of fewer than AUTO_TPU_THRESHOLD events in all, the card
    otherwise (the reference's "auto" asks its measured cost model
    instead). The CPU lane takes the CAS register only: a batch of
    another spec keeps the device lane, with a warning when "cpu" was
    asked for. Verdicts do not depend on the lane; ``last_route()``
    records which one ran. ``kernel`` gives the spec and the device
    (default: the CAS register from ``init_state`` on ``device``)."""
    if accelerator not in ACCELERATORS:
        raise ValueError(f"accelerator {accelerator!r} not in "
                         f"{ACCELERATORS}")
    if kernel is None:
        kernel = JitLinKernel(step_ids=step_ids, init_state=init_state,
                              device=device)
    streams = list(streams)
    total_events = sum(len(s.kind) for s in streams)
    if accelerator == "cpu" or (accelerator == "auto"
                                and total_events < AUTO_TPU_THRESHOLD):
        cpu = _cpu_batch(streams, kernel, force=accelerator == "cpu")
        if cpu is not None:
            _ROUTE.value = "cpu"
            return cpu
    _ROUTE.value = "device"
    # the dense table's V is the batch's largest interned-state count
    # (every key is scanned at the batch's S and V, as the reference's
    # vmapped scan is); streams without an intern table take the sparse
    # list
    if all(getattr(s, "intern", None) is not None for s in streams):
        n_states = max(len(s.intern) for s in streams)
    else:
        n_states = None
    S_all = max(max(1, s.n_slots) for s in streams)
    if n_states is not None and S_all <= jitlin.MATRIX_MAX_SLOTS \
            and n_states <= jitlin.MATRIX_MAX_STATES:
        mv = (1 << S_all) * _bucket(n_states, floor=8)
        total_returns = sum(int((np.asarray(s.kind) == EV_RETURN).sum())
                            for s in streams)
        # the element budget binds per sub-batch (matrix_check_batch
        # splits above jitlin.MATRIX_SUB_KEYS keys), not on the whole batch
        sub = min(len(streams), jitlin.MATRIX_SUB_KEYS)
        if total_returns >= jitlin.MATRIX_MIN_RETURNS \
                and sub * mv * mv <= jitlin.MATRIX_MAX_ELEMS:
            results = matrix_check_batch(
                streams, step_ids=kernel.step_ids,
                init_state=kernel.init_state, num_states=n_states,
                device=kernel.device)
            undecided = [i for i, r in enumerate(results)
                         if not r[0] or r[2]]
            if undecided:
                redo = _scan_batch([streams[i] for i in undecided],
                                   capacity, kernel, n_states)
                for i, r in zip(undecided, redo):
                    results[i] = r
            return results
    return _scan_batch(streams, capacity, kernel, n_states)


# copied from jepsen_tpu/parallel/__init__.py:572-619, without the cost
# model
def _cpu_batch(streams, kernel, force: bool = False):
    """The exact host lane: the native C++ search key by key (ctypes
    releases the GIL, so bounded_pmap runs keys in parallel), the Python
    twin where it declines (more than 63 slots, its capacity, or an
    initial state other than id 0). None when the kernel's spec is not
    the CAS register: the device lane runs instead, with a warning when
    the caller ``force``d the CPU lane."""
    from jepsen_tpu_torch.checker.linear_cpu import check_stream
    from jepsen_tpu_torch.native import check_stream_native

    model = kernel_model(kernel.step_ids)
    if model is None or model[0] != KERNEL_CAS:
        if force:
            logger.warning("accelerator=cpu requested but the spec %r has "
                           "no host twin in batch_check; using the device "
                           "lane", model)
        return None
    init_state = kernel.init_state

    def one(stream):
        res = check_stream_native(stream) if init_state == 0 else None
        if res is None or res.valid == "unknown":
            res = check_stream(stream, init_state=init_state)
        return (res.valid is True, res.failed_event, False,
                res.configs_max)

    return bounded_pmap(one, streams)


# copied from jepsen_tpu/parallel/__init__.py:622-647, without the mesh
def _scan_batch(streams, capacity, kernel, n_states):
    """One key-batched frontier launch over ``streams``: the dense table
    when the batch's (S, states) is in its regime, else the capacity-K
    sparse list; one read-back of every key's results."""
    S = max(1, max(s.n_slots for s in streams))
    batch = frontier_kernels.batch_events(streams, S,
                                          resolve_device(kernel.device))
    if _dense_ok(S, n_states):
        out = frontier_kernels.frontier_dense_batch(
            batch, _bucket(n_states, floor=16), kernel.init_state,
            kernel.step_ids)
    else:
        out = frontier_kernels.frontier_sparse_batch(
            batch, capacity, kernel.init_state, kernel.step_ids)
    alive, died, ovf, peak = torch.stack(
        [x.to(torch.int32) for x in out]).cpu().numpy()
    return [(bool(alive[i]), int(died[i]), bool(ovf[i]), int(peak[i]))
            for i in range(len(streams))]
