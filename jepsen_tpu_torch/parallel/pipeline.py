"""Pipelined device dispatch and the round-trip cost model (the port of
jepsen_tpu/parallel/pipeline.py:1-431).

* :class:`DispatchPipeline` — a bounded-depth dispatch queue. Each
  ``submit(prep_fn, dispatch_fn)`` runs the host staging, enqueues the
  device work and records a ``torch.cuda.Event`` after it; when more than
  ``depth`` dispatches are outstanding, the OLDEST one's event is
  synchronized (delayed blocking), so at least two sub-batches stay in
  flight while device memory stays bounded. ``results()`` makes one
  device-to-host copy of every handle, in submission order.
* :class:`CostModel` — round trip against the CPU lane for
  ``accelerator="auto"``, and the mesh gate (``mesh_route``) from the
  measured per-width rates.

The pipeline counts its sub-batches, in-flight depth, overlap, stalls
and final fetch in the ``dispatch_*`` instruments of the telemetry
registry when one is live (``telemetry.use``), and keeps the same values
in :func:`last_stats`. The reference reads ``JEPSEN_TPU_RTT_S`` and
``JEPSEN_TPU_MESH_MIN_EVENTS``; the port reads no environment variable:
the round trip is a ``CostModel`` argument (or measured on the card) and
MESH_MIN_EVENTS a module constant. The reference's ``donate_ok`` has no
torch meaning (buffers are not donated) and is not ported.
"""
from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np
import torch

from jepsen_tpu_torch import telemetry
from jepsen_tpu_torch.device import resolve_device

# Stats of the calling thread's most recently completed pipeline
# (results() sets it); thread-local, so checks on threads do not clobber
# each other's.
_LAST_STATS = threading.local()


def last_stats() -> dict:
    """The calling thread's most recent pipeline stats ({} if none):
    ``queue``, ``batches`` (what ``dispatch_batches_total`` counted),
    ``inflight_peak`` (``dispatch_inflight_peak``), ``host_prep_s``,
    ``overlapped_prep_s``, ``overlap_frac`` (``dispatch_overlap_frac``),
    ``stall_s`` (``dispatch_stall_seconds``), ``sync_s``
    (``dispatch_sync_seconds``) and ``wall_s``."""
    return dict(getattr(_LAST_STATS, "value", {}))


# copied from jepsen_tpu/parallel/pipeline.py:64-92: the CPU lane's rate
# before any measured sample (events/s), the per-width device rates, the
# mesh gate's floor and its probe period
DEFAULT_CPU_EVENTS_PER_SEC = 100_000.0
_RTT_CACHE: dict = {}
_CPU_RATE: dict = {}
# measured checker throughput per mesh width: {n_devices: events/s EWMA}
# (n_devices = 1 is the single-device lane)
_DEVICE_RATE: dict = {}
# below this many events a batch with no measured rates skips the mesh
MESH_MIN_EVENTS = 1 << 16
# with no measured single-device rate, every Nth mesh-eligible batch runs
# on one device: the probe that lets mesh_route's comparison activate
MESH_PROBE_EVERY = 16
_MESH_PROBE_COUNT = 0


def measured_roundtrip_s(device=None) -> float:
    """One tiny host-to-card-to-host round trip on ``device`` (the CUDA
    device by default): 8 float32 values from pinned memory up and back,
    the median of 3 after a warm-up, cached per device — the fixed
    latency floor every device dispatch chain pays at least twice.
    Raises for a CPU device, which has no round trip to time: a caller
    without a card passes ``CostModel(roundtrip_s=...)``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"measured_roundtrip_s: {dev} is not a card; "
                         "pass CostModel(roundtrip_s=...)")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _RTT_CACHE:
        host = torch.zeros(8, dtype=torch.float32, pin_memory=True)

        def trip() -> float:
            t0 = time.perf_counter()
            host.to(dev, non_blocking=True).to("cpu")
            return time.perf_counter() - t0

        trip()  # warm-up: context, allocator
        _RTT_CACHE[dev] = sorted(trip() for _ in range(3))[1]
    return _RTT_CACHE[dev]


# copied from jepsen_tpu/parallel/pipeline.py:119-131
def observe_cpu_rate(n_events: int, seconds: float) -> None:
    """Feeds a measured CPU-lane sample into the cost model (EWMA) so
    routing tracks the actual host instead of the built-in default."""
    if seconds <= 0 or n_events <= 0:
        return
    rate = n_events / seconds
    prev = _CPU_RATE.get("events_per_sec")
    _CPU_RATE["events_per_sec"] = (rate if prev is None
                                   else 0.7 * prev + 0.3 * rate)


def cpu_events_per_sec() -> float:
    return _CPU_RATE.get("events_per_sec", DEFAULT_CPU_EVENTS_PER_SEC)


# copied from jepsen_tpu/parallel/pipeline.py:137-159
def observe_device_rate(n_devices: int, n_events: int,
                        seconds: float) -> None:
    """Feeds one measured device-lane sample into the per-mesh-width rate
    model (EWMA per width). Samples below a quarter of MESH_MIN_EVENTS
    are dropped: a tiny dispatch measures fixed overhead (the build, the
    staging, the round trip), not throughput."""
    if (seconds <= 0 or n_events < max(1, MESH_MIN_EVENTS // 4)
            or n_devices < 1):
        return
    rate = n_events / seconds
    prev = _DEVICE_RATE.get(n_devices)
    _DEVICE_RATE[n_devices] = (rate if prev is None
                               else 0.7 * prev + 0.3 * rate)


def device_events_per_sec(n_devices: int) -> float | None:
    """The measured EWMA rate at a mesh width, or None (no sample)."""
    return _DEVICE_RATE.get(n_devices)


# copied from jepsen_tpu/parallel/pipeline.py:167-250
class CostModel:
    """Round trip against the CPU lane for ``accelerator="auto"``.

    The device floor for a pipelined batch is about two round trips (the
    first dispatch's upload and the one read-back at the end). When the
    CPU lane's predicted time beats that floor, the device can only lose:
    route to the CPU. Device compute is not modeled; an under-estimate
    only means taking the device lane.

    ``roundtrip_s`` fixes the round trip; without it the model measures
    it on the batch's card (:func:`measured_roundtrip_s`), and a batch on
    the CPU device has none (0.0: the device lane)."""

    def __init__(self, roundtrip_s: float | None = None,
                 cpu_events_per_sec_: float | None = None):
        self._rtt = roundtrip_s
        self._cpu_rate = cpu_events_per_sec_

    def rtt(self, device=None) -> float:
        if self._rtt is not None:
            return self._rtt
        if resolve_device(device).type != "cuda":
            return 0.0
        return measured_roundtrip_s(device)

    def cpu_rate(self) -> float:
        return (self._cpu_rate if self._cpu_rate is not None
                else cpu_events_per_sec())

    def cpu_seconds(self, total_events: int) -> float:
        return total_events / max(self.cpu_rate(), 1e-9)

    def device_floor_seconds(self, device=None) -> float:
        return 2.0 * self.rtt(device)

    def route(self, total_events: int, device=None) -> str:
        """"cpu" when the CPU lane beats the device round-trip floor,
        else "device"."""
        return ("cpu" if self.cpu_seconds(total_events)
                < self.device_floor_seconds(device) else "device")

    def admission_budget_ops(self, seconds: float) -> float:
        """How many events the CPU lane can verify in ``seconds``."""
        return max(0.0, seconds) * self.cpu_rate()

    def mesh_route(self, total_events: int, n_devices: int,
                   device=None) -> bool:
        """Should a batch of ``total_events`` take the ``n_devices`` mesh?
        With measured rates at both widths, compare predicted times (the
        mesh also pays about one round trip more for its gather); without
        them, gate on MESH_MIN_EVENTS, and with no single-device rate
        measured every MESH_PROBE_EVERY-th eligible batch runs on one
        device as a probe, so the comparison can activate."""
        global _MESH_PROBE_COUNT
        if n_devices < 2:
            return False
        r1 = device_events_per_sec(1)
        rn = device_events_per_sec(n_devices)
        if r1 and rn:
            return (total_events / rn + self.rtt(device)
                    < total_events / r1)
        if total_events < MESH_MIN_EVENTS:
            return False
        if r1 is None:
            _MESH_PROBE_COUNT += 1
            if _MESH_PROBE_COUNT % MESH_PROBE_EVERY == 0:
                return False
        return True


# the process-default model; tests replace it
_DEFAULT_MODEL = CostModel()


def auto_route(total_events: int, device=None) -> str:
    """Module-level routing with the process-default cost model."""
    return _DEFAULT_MODEL.route(total_events, device)


def mesh_route(total_events: int, n_devices: int, device=None) -> bool:
    """Module-level mesh gate with the process-default cost model."""
    return _DEFAULT_MODEL.mesh_route(total_events, n_devices, device)


# ---------------------------------------------------------------------------
# the dispatch pipeline
# ---------------------------------------------------------------------------

def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return []


def _rebuild(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(t, it) for t in tree)
    return tree


def _record(handle):
    """A CUDA event recorded after the dispatch that made ``handle``, on
    the current stream of each card it lies on (None: nothing on a
    card)."""
    devs = {t.device for t in _leaves(handle) if t.device.type == "cuda"}
    events = []
    for dev in devs:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    return events or None


def _pending(handle, events) -> bool:
    """Is the dispatch still executing? A card's dispatch asks its
    events without blocking; an already finished dispatch must not count
    as overlap. Tensors on the CPU are done when they exist; other
    objects (test fakes) without ``is_ready`` count as pending."""
    if events is not None:
        return not all(ev.query() for ev in events)
    if _leaves(handle):
        return False
    is_ready = getattr(handle, "is_ready", None)
    return True if is_ready is None else not is_ready()


def _block(handle, events) -> None:
    """Blocks until a dispatch is done: its events, or a fake's
    ``block_until_ready``. A device fault propagates."""
    if events is not None:
        for ev in events:
            ev.synchronize()
        return
    bur = getattr(handle, "block_until_ready", None)
    if bur is not None:
        bur()


def _fetch(handles: list) -> list:
    """Every tensor of ``handles`` on the host, with one copy a card:
    the leaves' bytes are packed into one buffer on their card, copied
    once and split again. CPU tensors and other objects pass as they
    are."""
    leaves = _leaves(handles)
    host = {}
    by_dev: dict = {}
    for i, t in enumerate(leaves):
        if t.device.type == "cuda":
            by_dev.setdefault(t.device, []).append(i)
    for dev, idx in by_dev.items():
        parts, spans, off = [], [], 0
        for i in idx:
            b = leaves[i].contiguous().reshape(-1).view(torch.uint8)
            pad = (-b.numel()) % 8        # each part starts 8-aligned
            parts += [b, torch.zeros(pad, dtype=torch.uint8, device=dev)]
            spans.append((i, off, b.numel()))
            off += b.numel() + pad
        buf = torch.cat(parts).cpu()
        for i, o, n in spans:
            t = leaves[i]
            host[i] = buf[o:o + n].view(t.dtype).reshape(t.shape)
    return _rebuild(handles, iter(host.get(i, t)
                                  for i, t in enumerate(leaves)))


# copied from jepsen_tpu/parallel/pipeline.py:300-431, on torch handles
class DispatchPipeline:
    """Bounded-depth dispatch queue with occupancy accounting.

    ::

        pipe = DispatchPipeline(depth=2, name="matrix", device=dev)
        for sub in sub_batches:
            pipe.submit(lambda: pipe.stage(*host_grids(sub)),  # staging
                        dispatch)                              # enqueue
        outs = pipe.results()                                  # one copy

    ``prep_fn()`` returns the dispatch's arguments (a tuple, or a single
    value); ``dispatch_fn(*args)`` returns its handle (tensors, or tuples
    of them) without reading it back. With ``dispatch_fn=None``,
    ``prep_fn`` does both. Results come back in submission order, every
    tensor on the host."""

    def __init__(self, depth: int = 2, name: str = "dispatch",
                 device=None):
        self.depth = max(1, depth)
        self.name = name
        self.device = torch.device("cpu" if device is None else device)
        self._handles: list = []
        self._inflight: deque = deque()
        self._t0 = time.perf_counter()
        self._prep_s = 0.0
        self._overlap_prep_s = 0.0
        self._stall_s = 0.0
        self._inflight_peak = 0
        self._reg = telemetry.get_registry()

    def stage(self, *arrays):
        """``arrays`` (numpy or CPU tensors) on the pipeline's device: to
        a card as copies from pinned memory that do not block, so the
        upload overlaps the work in flight."""
        out = []
        for a in arrays:
            t = torch.from_numpy(np.ascontiguousarray(a)) \
                if isinstance(a, np.ndarray) else a
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out.append(t)
        return out

    def submit(self, prep_fn, dispatch_fn=None):
        """Stages one sub-batch and dispatches it. Returns its handle
        (also kept for results())."""
        # overlap is judged BEFORE prep runs, against dispatches still
        # executing
        was_computing = any(_pending(h, ev) for h, ev in self._inflight)
        t0 = time.perf_counter()
        staged = prep_fn()
        dt = time.perf_counter() - t0
        self._prep_s += dt
        if was_computing:
            self._overlap_prep_s += dt
        if len(self._inflight) >= self.depth:
            oldest = self._inflight.popleft()
            t1 = time.perf_counter()
            _block(*oldest)
            self._stall_s += time.perf_counter() - t1
        if dispatch_fn is None:
            handle = staged
        else:
            args = staged if isinstance(staged, tuple) else (staged,)
            handle = dispatch_fn(*args)
        self._handles.append(handle)
        self._inflight.append((handle, _record(handle)))
        self._inflight_peak = max(self._inflight_peak, len(self._inflight))
        # copied from jepsen_tpu/parallel/pipeline.py:370-381
        if self._reg.enabled:
            self._reg.counter(
                "dispatch_batches_total", "sub-batches dispatched",
                labels=("queue",)).inc(queue=self.name)
            self._reg.gauge(
                "dispatch_inflight", "dispatches currently in flight",
                labels=("queue",)).set(len(self._inflight), queue=self.name)
            self._reg.gauge(
                "dispatch_inflight_peak", "in-flight high-water",
                labels=("queue",)).set_max(self._inflight_peak,
                                           queue=self.name)
        return handle

    def results(self) -> list:
        """One copy a card of every submitted handle, in submission
        order; finalizes the occupancy stats. A device fault
        propagates."""
        t1 = time.perf_counter()
        out = _fetch(self._handles)
        sync_s = time.perf_counter() - t1
        wall = time.perf_counter() - self._t0
        overlap_frac = (self._overlap_prep_s / self._prep_s
                        if self._prep_s > 0 else 0.0)
        _LAST_STATS.value = {
            "queue": self.name,
            "batches": len(self._handles),
            "inflight_peak": self._inflight_peak,
            "host_prep_s": self._prep_s,
            "overlapped_prep_s": self._overlap_prep_s,
            "overlap_frac": overlap_frac,
            "stall_s": self._stall_s,
            "sync_s": sync_s,
            "wall_s": wall,
        }
        # copied from jepsen_tpu/parallel/pipeline.py:409-424
        if self._reg.enabled:
            self._reg.gauge(
                "dispatch_overlap_frac",
                "fraction of host staging hidden under device compute, "
                "last pipeline", labels=("queue",)
                ).set(overlap_frac, queue=self.name)
            self._reg.gauge(
                "dispatch_inflight", "dispatches currently in flight",
                labels=("queue",)).set(0, queue=self.name)
            self._reg.histogram(
                "dispatch_stall_seconds",
                "time blocked at the depth limit", labels=("queue",)
                ).observe(self._stall_s, queue=self.name)
            self._reg.histogram(
                "dispatch_sync_seconds", "final batched readback wait",
                labels=("queue",)).observe(sync_s, queue=self.name)
        self._inflight.clear()
        return out

    def stats(self) -> dict:
        """The finalized stats (valid after results())."""
        s = last_stats()
        return s if s.get("queue") == self.name else {}
