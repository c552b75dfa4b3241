"""Key-batched checking of independent per-key register histories, and
the device mesh it may shard over (jepsen_tpu/parallel/__init__.py).

:func:`batch_check` checks B keys' event streams together. On the card
the key-batched transfer-matrix screen (``jitlin.matrix_check_batch``)
runs first when the batch is in its regime; the keys it leaves
undecided (not alive, or inexact) go to one key-batched frontier launch
(``frontier_dense_batch`` or ``frontier_sparse_batch``, one CTA a key),
whose results replace the screen's. The CPU lane searches the CAS
register key by key with the native C++ search, then the Python twin for
what it does not take; a batch of another spec keeps the device lane.
``"auto"`` asks the round-trip cost model (``pipeline.auto_route``).

A :class:`Mesh` is an ordered list of devices. With one, the batch's
keys (or one history's chunks) split into contiguous blocks, one a
device: each shard's tensors are its own, copied to its device, and its
kernels launch there; the results gather on the mesh's first device and
read back once. A mesh built by hand may repeat a device (``[cuda:0] *
4``, ``["cpu"] * 4`` in the tests): its shards then run one after
another on that device, which checks the sharded math but is no
speed-up. :func:`auto_mesh` takes only distinct CUDA devices, so on one
card it returns None and every cost-gated path runs on one device.

Not ported: the reference's device health, probe, shrink and regrow
protocol (``mark_device_failed`` through ``regrow_mesh``,
jepsen_tpu/parallel/__init__.py:125-318). An error of a shard
propagates. No environment variable is read: MESH_DEVICES and SHARDED
are module constants.
"""
from __future__ import annotations

import logging
import threading
import time
import types
from typing import Sequence

import numpy as np
import torch

from jepsen_tpu_torch.checker.linearizable import ACCELERATORS
from jepsen_tpu_torch.device import resolve_device
from jepsen_tpu_torch.models import KERNEL_CAS, kernel_model
from jepsen_tpu_torch.ops import frontier_kernels, jitlin
from jepsen_tpu_torch.ops.jitlin import (
    EV_NOOP, EV_RETURN, JitLinKernel, _bucket, _dense_ok, matrix_check_batch)
from jepsen_tpu_torch.utils import bounded_pmap

logger = logging.getLogger("jepsen_tpu_torch.parallel")

# How the calling thread's most recent batch_check settled: "device",
# "mesh" or "cpu" (jepsen_tpu/parallel/__init__.py:440-448).
_ROUTE = threading.local()

# The reference's JEPSEN_TPU_MESH_DEVICES (a cap on auto_mesh's width;
# None: no cap) and JEPSEN_TPU_SHARDED (the cost-gated sharded paths on
# or off), as module constants.
MESH_DEVICES: int | None = None
SHARDED = True


class Mesh:
    """A 1-D mesh: an ordered list of devices of one type (a device may
    repeat) and the name of its axis. Shard ``k`` of a sharded array
    lives on ``devices[k]``; results gather on ``devices[0]``."""

    def __init__(self, devices, axis: str = "keys"):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("Mesh: no devices")
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
            raise ValueError(f"Mesh: devices of one type, cuda or cpu, "
                             f"got {self.devices}")
        for d in set(self.devices):
            resolve_device(d)
        self.axis_name = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    def key(self) -> tuple:
        """The devices, in order and with repeats, and the axis name: a
        cache key."""
        return tuple(str(d) for d in self.devices), self.axis_name

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_name!r})"


def devices() -> list:
    """The distinct CUDA devices of this process ([] without a card)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def get_mesh(n_devices: int | None = None, axis: str = "keys") -> Mesh:
    """A mesh over the first ``n_devices`` CUDA devices (all by
    default)."""
    devs = devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, axis)


# One Mesh object per (width, axis).
_MESH_CACHE: dict = {}


# copied from jepsen_tpu/parallel/__init__.py:54-74
def coerce_devices(value, knob: str = "mesh_devices") -> int | None:
    """Tolerant device-count knob coercion: None/'' read as unset,
    numeric strings work, garbage warns and reads as unset."""
    if value is None or value == "":
        return None
    if isinstance(value, bool):
        logger.warning("ignoring bool %s=%r (want a device count)",
                       knob, value)
        return None
    try:
        n = int(float(value))
    except (TypeError, ValueError):
        logger.warning("ignoring malformed %s=%r (want an int)",
                       knob, value)
        return None
    return max(0, n)


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


# copied from jepsen_tpu/parallel/__init__.py:97-109
def sharding_knobs(test, opts) -> tuple:
    """The per-run sharding knob pair ``(checker_sharded flag,
    mesh_devices cap)`` from a checker's (test, opts), tolerantly
    coerced, opts over the test map (True forces the sharded path,
    False turns it off, None: SHARDED and the cost model)."""
    tmap = test if isinstance(test, dict) else {}
    flag = coerce_flag(opts.get("checker_sharded",
                                tmap.get("checker_sharded")))
    n = coerce_devices(opts.get("mesh_devices", tmap.get("mesh_devices")))
    return flag, n


def mesh_devices_limit() -> int | None:
    """The process-wide cap on a mesh's width (MESH_DEVICES)."""
    return coerce_devices(MESH_DEVICES, knob="MESH_DEVICES")


def sharded_enabled() -> bool:
    """Are the cost-gated sharded paths on (SHARDED)? The test map's
    ``checker_sharded`` overrides it per run."""
    return bool(SHARDED)


# copied from jepsen_tpu/parallel/__init__.py:321-351, without the
# failed-device filter
def auto_mesh(n_devices: int | None = None, axis: str = "keys"):
    """The cached mesh over the distinct CUDA devices a sharded dispatch
    should use, or None when fewer than 2 would take part.
    ``n_devices`` caps the width (the test map's ``mesh_devices``),
    MESH_DEVICES caps it for the process. The same Mesh object comes
    back for a width, so the per-mesh kernel caches stay warm."""
    devs = devices()
    n = len(devs)
    if n_devices is not None:
        n = min(n, int(n_devices))
    limit = mesh_devices_limit()
    if limit is not None:
        n = min(n, limit)
    if n < 2:
        return None
    key = (n, axis)
    mesh = _MESH_CACHE.get(key)
    if mesh is None or list(mesh.devices) != devs[:n]:
        mesh = _MESH_CACHE[key] = Mesh(devs[:n], axis)
    return mesh


# copied from jepsen_tpu/parallel/__init__.py:364-378
def sharded_mesh_for(total_events: int, n_devices: int | None = None):
    """The mesh a sharded dispatch should use for ``total_events`` of
    work, or None: sharding off, fewer than 2 devices, or the cost model
    says the batch is too small to pay the mesh's fixed costs
    (``pipeline.mesh_route``)."""
    if not sharded_enabled():
        return None
    mesh = auto_mesh(n_devices)
    if mesh is None:
        return None
    from jepsen_tpu_torch.parallel import pipeline
    if not pipeline.mesh_route(total_events, mesh.size, mesh.devices[0]):
        return None
    return mesh


def shard_leading(mesh: Mesh, *arrays) -> list:
    """``shard_chunked`` along the leading axis."""
    return shard_chunked(mesh, list(arrays), axis=0)


# copied from jepsen_tpu/parallel/__init__.py:386-416, one tensor a shard
def shard_chunked(mesh: Mesh, arrays, axis: int = 0) -> list:
    """Splits each array (numpy or CPU tensor) into ``mesh.size``
    contiguous blocks along ``axis`` and copies block k to
    ``mesh.devices[k]``, to a card from pinned memory without blocking,
    so the shards' uploads overlap each other and the work in flight.
    Returns, for each array, its list of shards; each shard is a tensor
    of its own, even where devices repeat. The axis must be a device
    multiple: the callers pad (``jitlin._matrix_plan``,
    :func:`pad_to_multiple`), never drop the sharding."""
    nd = mesh.size
    out = []
    for a in arrays:
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        if a.shape[axis] % nd:
            raise ValueError(
                f"axis {axis} length {a.shape[axis]} not divisible by "
                f"{nd} mesh devices — pad upstream (jitlin._matrix_plan /"
                f" parallel.pad_to_multiple)")
        out.append([jitlin._upload(np.ascontiguousarray(b), dev)
                    for b, dev in zip(np.split(a, nd, axis=axis),
                                      mesh.devices)])
    return out


def _noop_stream():
    """A padding key: one EV_NOOP event, which steps nothing (alive)."""
    z = np.zeros(1, np.int32)
    return types.SimpleNamespace(
        kind=np.full(1, EV_NOOP, np.int32), slot=z, f=z, a=z, b=z,
        op_index=z, n_slots=1, intern=None)


# copied from jepsen_tpu/parallel/__init__.py:419-435, on a list of streams
def pad_to_multiple(streams: list, multiple: int) -> tuple[list, int]:
    """Pads a key batch to a multiple of ``multiple`` keys with keys of
    one EV_NOOP event. Returns (streams, real_B)."""
    B = len(streams)
    rem = (-B) % multiple
    return list(streams) + [_noop_stream() for _ in range(rem)], B


def last_route() -> str:
    """The lane the calling thread's most recent batch_check took."""
    return getattr(_ROUTE, "value", "device")


# copied from jepsen_tpu/parallel/__init__.py:462-569
def batch_check(streams: Sequence, capacity: int = 256, step_ids=None,
                init_state: int = 0, kernel: JitLinKernel | None = None,
                accelerator: str = "gpu", device=None, mesh=None,
                mesh_devices: int | None = None) -> list:
    """Checks a batch of per-key event streams. Returns [(alive,
    died_event, overflow, peak)] per stream, as the reference's
    ``batch_check`` does.

    ``accelerator``: "gpu" (the card), "cpu" (the native/Python lane,
    bounded-thread-parallel over keys) or "auto": the cost model
    (``pipeline.auto_route``) takes the CPU lane when it beats the
    device's round-trip floor. The CPU lane takes the CAS register only:
    a batch of another spec keeps the device lane, with a warning when
    "cpu" was asked for. ``kernel`` gives the spec and the device
    (default: the CAS register from ``init_state`` on ``device``).

    ``mesh``: a :class:`Mesh` shards the keys over its devices (an
    explicit mesh is never routed to the CPU lane by "auto"); False
    forces one device; None asks ``sharded_mesh_for`` when the kernel's
    device is a card (``mesh_devices`` caps the width). Verdicts do not
    depend on the lane; ``last_route()`` records which one ran
    ("device", "mesh" or "cpu")."""
    if accelerator not in ACCELERATORS:
        raise ValueError(f"accelerator {accelerator!r} not in "
                         f"{ACCELERATORS}")
    if kernel is None:
        kernel = JitLinKernel(step_ids=step_ids, init_state=init_state,
                              device=device)
    streams = list(streams)
    explicit_mesh = mesh is not None and mesh is not False
    if accelerator == "cpu" or (accelerator == "auto"
                                and not explicit_mesh):
        cpu = _cpu_batch(streams, kernel, force=accelerator == "cpu")
        if cpu is not None:
            _ROUTE.value = "cpu"
            return cpu
    total_events = sum(len(s.kind) for s in streams)
    if mesh is False:
        mesh = None
    elif mesh is None and resolve_device(kernel.device).type == "cuda":
        # cost-gated: a small batch must not pay the mesh's fixed costs
        mesh = sharded_mesh_for(total_events, mesh_devices)
    _ROUTE.value = "device" if mesh is None else "mesh"
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
        # splits above jitlin.MATRIX_SUB_KEYS keys), or per shard: a
        # mesh pads the keys to a device multiple and holds B / nd a
        # device
        sub = (-(-len(streams) // mesh.size) if mesh is not None
               else min(len(streams), jitlin.MATRIX_SUB_KEYS))
        if total_returns >= jitlin.MATRIX_MIN_RETURNS \
                and sub * mv * mv <= jitlin.MATRIX_MAX_ELEMS:
            results = matrix_check_batch(
                streams, step_ids=kernel.step_ids,
                init_state=kernel.init_state, num_states=n_states,
                device=kernel.device, mesh=mesh)
            undecided = [i for i, r in enumerate(results)
                         if not r[0] or r[2]]
            if undecided:
                redo = _scan_batch([streams[i] for i in undecided],
                                   capacity, kernel, n_states, mesh)
                for i, r in zip(undecided, redo):
                    results[i] = r
            return results
    return _scan_batch(streams, capacity, kernel, n_states, mesh)


# copied from jepsen_tpu/parallel/__init__.py:572-619
def _cpu_batch(streams, kernel, force: bool = False):
    """The exact host lane: the native C++ search key by key (ctypes
    releases the GIL, so bounded_pmap runs keys in parallel), the Python
    twin where it declines (more than 63 slots, its capacity, or an
    initial state other than id 0). None when the kernel's spec is not
    the CAS register (the device lane runs instead, with a warning when
    the caller ``force``d the CPU lane), or, unless ``force``d, when the
    cost model routes the batch to the device. The measured rate feeds
    the cost model (``pipeline.observe_cpu_rate``)."""
    from jepsen_tpu_torch.checker.linear_cpu import check_stream
    from jepsen_tpu_torch.native import check_stream_native
    from jepsen_tpu_torch.parallel import pipeline

    model = kernel_model(kernel.step_ids)
    if model is None or model[0] != KERNEL_CAS:
        if force:
            logger.warning("accelerator=cpu requested but the spec %r has "
                           "no host twin in batch_check; using the device "
                           "lane", model)
        return None
    init_state = kernel.init_state
    total_events = sum(len(s.kind) for s in streams)
    if not force and pipeline.auto_route(total_events,
                                         kernel.device) != "cpu":
        return None

    def one(stream):
        res = check_stream_native(stream) if init_state == 0 else None
        if res is None or res.valid == "unknown":
            res = check_stream(stream, init_state=init_state)
        return (res.valid is True, res.failed_event, False,
                res.configs_max)

    t0 = time.perf_counter()
    out = bounded_pmap(one, streams)
    pipeline.observe_cpu_rate(total_events, time.perf_counter() - t0)
    return out


# copied from jepsen_tpu/parallel/__init__.py:622-647
def _scan_batch(streams, capacity, kernel, n_states, mesh=None):
    """The key-batched frontier scan over ``streams``: the dense table
    when the batch's (S, states) is in its regime, else the capacity-K
    sparse list. Without a mesh one launch on the kernel's device; with
    one, the keys padded to a device multiple (EV_NOOP keys) and one
    launch a shard on its device for its key block. One read-back of
    every key's results; the padding keys are dropped."""
    S = max(1, max(s.n_slots for s in streams))
    if mesh is None:
        blocks = [(streams, resolve_device(kernel.device))]
        real_b = len(streams)
    else:
        padded, real_b = pad_to_multiple(streams, mesh.size)
        per = len(padded) // mesh.size
        blocks = [(padded[k * per:(k + 1) * per], dev)
                  for k, dev in enumerate(mesh.devices)]
    first = blocks[0][1]
    outs = []
    for block, dev in blocks:
        batch = frontier_kernels.batch_events(block, S, dev)
        if _dense_ok(S, n_states):
            out = frontier_kernels.frontier_dense_batch(
                batch, _bucket(n_states, floor=16), kernel.init_state,
                kernel.step_ids)
        else:
            out = frontier_kernels.frontier_sparse_batch(
                batch, capacity, kernel.init_state, kernel.step_ids)
        outs.append(torch.stack([x.to(torch.int32) for x in out]).to(first))
    alive, died, ovf, peak = torch.cat(outs, dim=1).cpu().numpy()
    return [(bool(alive[i]), int(died[i]), bool(ovf[i]), int(peak[i]))
            for i in range(real_b)]
