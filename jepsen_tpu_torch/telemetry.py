"""Runtime telemetry: a Prometheus-style metrics registry (the port of
jepsen_tpu/telemetry.py).

A thread-safe registry of Counters, Gauges and log-bucketed Histograms
with labels, a ``timer()`` context manager, timestamped events, and
exporters for the Prometheus text exposition format (``metrics.prom``)
and a JSONL snapshot (``metrics.json``). Every instrument and the
exporters are copies: the same calls give the same text.

Zero-cost disabled mode: the module-level default registry is
:data:`NULL`, whose instrument constructors hand back one shared no-op
instrument. Call sites fetch the registry once (``get_registry()``) and
test ``reg.enabled`` around hot blocks. A caller turns telemetry on with
``with telemetry.use(Registry()): ...`` (or ``install``); the port has no
run loop yet that installs one for a run.

Device helpers speak of the card the check ran on:
``device_memory_peak_bytes`` reads torch's caching allocator for a CUDA
device and returns None for any other device without touching
``torch.cuda``; ``profiler_trace`` records a ``torch.profiler`` trace.

Not ported, to come with the modules that use them: the flusher, the
thread-stack dump and the fault-window classifier (the run loop, its
watchdog and nemesis), ``device_memory_stats``, and the reference's
models of its dense f32 closure products with their published peak
(``matrix_modeled_flops``, ``matrix_phase_model``,
``combine_modeled_hbm_bytes``, ``set_device_peak_flops``): the port's
``chunk_product.cu`` computes no such products, so a gauge over them
would measure nothing of the port.
"""
from __future__ import annotations

import bisect as _bisect
import json
import logging
import math
import os
import tempfile
import threading
import time
from collections import deque
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Iterable

import torch

logger = logging.getLogger("jepsen_tpu_torch.telemetry")

# copied from jepsen_tpu/telemetry.py:43-543: the buckets, the instruments,
# and the registries and their exporters

# Log-spaced latency buckets: 1 µs .. ~275 s in x4 steps (20 bounds plus
# the +Inf overflow). Wide enough for SSH execs and JIT compiles, fine
# enough near the bottom for the interpreter's µs-scale scheduling.
DEFAULT_BUCKETS: tuple = tuple(1e-6 * 4.0 ** i for i in range(20))


def log_buckets(start: float, factor: float, count: int) -> tuple:
    """Explicit log-bucket constructor: ``start * factor**i``."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor ** i for i in range(count))


# ---------------------------------------------------------------------------
# Instruments
# ---------------------------------------------------------------------------

class _Family:
    """A named metric family: children keyed by label-value tuples."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels: Iterable[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self._children: dict = {}
        self._lock = threading.Lock()

    def _key(self, labels: dict) -> tuple:
        return tuple(str(labels.get(n, "")) for n in self.label_names)

    def _child(self, labels: dict):
        key = self._key(labels)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._new_child())
        return child

    def _new_child(self):
        raise NotImplementedError

    def _rows(self):
        """[(label_values, child)] snapshot, stable order."""
        with self._lock:
            return sorted(self._children.items())

    def clear(self) -> None:
        """Drops every child series. For per-snapshot-rebuilt label
        sets — the live daemon's capped ``{run}`` gauges re-rank which
        runs keep their own series on every poll, and a run that fell
        out of the top-K must stop exporting a stale value."""
        with self._lock:
            self._children.clear()


class Counter(_Family):
    """Monotone sum. ``inc(amount, **labels)``."""

    kind = "counter"

    def _new_child(self):
        return [0.0]

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        child = self._child(labels)
        with self._lock:
            child[0] += amount

    def cell(self, **labels) -> list:
        """The mutable ``[value]`` behind one child, for SINGLE-WRITER
        hot paths (the interpreter's scheduler thread): the caller does
        ``cell[0] += n`` with no lock. Snapshots still see it."""
        return self._child(labels)

    def value(self, **labels) -> float:
        return self._child(labels)[0]


class Gauge(_Family):
    """Point-in-time value. ``set/inc/dec/set_max``."""

    kind = "gauge"

    def _new_child(self):
        return [0.0]

    def set(self, value: float, **labels) -> None:
        self._child(labels)[0] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        child = self._child(labels)
        with self._lock:
            child[0] += amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def set_max(self, value: float, **labels) -> None:
        """High-water update: keeps the max of current and ``value``."""
        child = self._child(labels)
        with self._lock:
            if value > child[0]:
                child[0] = float(value)

    def cell(self, **labels) -> list:
        """Single-writer fast path; see Counter.cell."""
        return self._child(labels)

    def value(self, **labels) -> float:
        return self._child(labels)[0]


class _HistState:
    __slots__ = ("counts", "sum", "count", "min", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bucket (non-cumulative), last=+Inf
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf


class Histogram(_Family):
    """Log-bucketed distribution. ``observe(v, **labels)``; quantiles are
    estimated by linear interpolation inside the containing bucket."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", labels: Iterable[str] = (),
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labels)
        self.bounds = tuple(sorted(buckets))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")

    def _new_child(self):
        return _HistState(len(self.bounds) + 1)

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        i = _bisect.bisect_left(self.bounds, value)
        child = self._child(labels)
        with self._lock:
            child.counts[i] += 1
            child.sum += value
            child.count += 1
            if value < child.min:
                child.min = value
            if value > child.max:
                child.max = value

    def observer(self, **labels):
        """A SINGLE-WRITER observe closure bound to one child: skips the
        family lock and per-call child lookup (one bisect + five plain
        mutations). The interpreter's scheduler thread records µs-scale
        op latencies through this without measurably slowing the loop."""
        child = self._child(labels)
        bounds = self.bounds
        bl = _bisect.bisect_left

        def observe(value: float) -> None:
            child.counts[bl(bounds, value)] += 1
            child.sum += value
            child.count += 1
            if value < child.min:
                child.min = value
            if value > child.max:
                child.max = value

        return observe

    def quantile(self, q: float, **labels) -> float | None:
        """Bucket-interpolated quantile in [0, 1]; None when empty."""
        child = self._child(labels)
        if child.count == 0:
            return None
        rank = q * child.count
        cum = 0
        for i, c in enumerate(child.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else min(child.min, self.bounds[0])
                hi = self.bounds[i] if i < len(self.bounds) else child.max
                frac = (rank - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return child.max


class _Timer:
    """``with reg.timer("x_seconds"): ...`` — observes elapsed seconds."""

    __slots__ = ("_hist", "_labels", "_t0")

    def __init__(self, hist: Histogram, labels: dict):
        self._hist = hist
        self._labels = labels

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0, **self._labels)
        return False


# ---------------------------------------------------------------------------
# Registries
# ---------------------------------------------------------------------------

class Registry:
    """Thread-safe get-or-create family store + exporters."""

    enabled = True

    def __init__(self, max_events: int = 4096):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}
        self._events: deque = deque(maxlen=max_events)

    def _family(self, cls, name: str, help: str, labels: Iterable[str],
                **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = cls(name, help, labels, **kw)
                self._families[name] = fam
                return fam
        if not isinstance(fam, cls):
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}")
        if tuple(labels) and fam.label_names != tuple(labels):
            raise ValueError(
                f"metric {name!r} already registered with labels "
                f"{fam.label_names}, not {tuple(labels)}")
        return fam

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> Counter:
        return self._family(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> Gauge:
        return self._family(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._family(Histogram, name, help, labels, buckets=buckets)

    def timer(self, name: str, help: str = "", **labels) -> _Timer:
        hist = self.histogram(name, help, labels=tuple(labels))
        return _Timer(hist, labels)

    def event(self, name: str, **fields) -> None:
        """Timestamped event row (nemesis fault windows et al.); kept in a
        bounded deque, exported in metrics.json."""
        self._events.append({"type": "event", "name": name,
                             "time": time.time(), "fields": fields})

    # -- export ------------------------------------------------------------

    def snapshot(self) -> list[dict]:
        """One dict per (family, label-set) + one per event — the
        metrics.json rows."""
        out: list[dict] = []
        with self._lock:
            families = sorted(self._families.items())
        for name, fam in families:
            for key, child in fam._rows():
                labels = dict(zip(fam.label_names, key))
                row: dict[str, Any] = {"name": name, "type": fam.kind,
                                       "labels": labels}
                if fam.kind in ("counter", "gauge"):
                    row["value"] = child[0]
                else:
                    row.update({
                        "count": child.count,
                        "sum": round(child.sum, 9),
                        "min": None if child.count == 0 else child.min,
                        "max": None if child.count == 0 else child.max,
                        "buckets": [[le, c] for le, c in
                                    zip(list(fam.bounds) + ["+Inf"],
                                        child.counts) if c],
                    })
                    for q, label in ((0.5, "p50"), (0.95, "p95"),
                                     (0.99, "p99")):
                        v = fam.quantile(q, **labels)
                        if v is not None:
                            row[label] = round(v, 9)
                out.append(row)
        out.extend(self._events)
        return out

    def render_prom(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: list[str] = []
        with self._lock:
            families = sorted(self._families.items())
        for name, fam in families:
            if fam.help:
                lines.append(f"# HELP {name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key, child in fam._rows():
                labels = dict(zip(fam.label_names, key))
                if fam.kind in ("counter", "gauge"):
                    lines.append(f"{name}{_fmt_labels(labels)} {_fmt(child[0])}")
                    continue
                cum = 0
                for le, c in zip(list(fam.bounds) + ["+Inf"], child.counts):
                    cum += c
                    le_s = "+Inf" if le == "+Inf" else _fmt(le)
                    lines.append(
                        f"{name}_bucket{_fmt_labels({**labels, 'le': le_s})}"
                        f" {cum}")
                lines.append(f"{name}_sum{_fmt_labels(labels)} {_fmt(child.sum)}")
                lines.append(f"{name}_count{_fmt_labels(labels)} {child.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def export(self, dirpath, prefix: str = "metrics") -> None:
        """<prefix>.prom + <prefix>.json into ``dirpath``, atomically
        (the flusher races web readers; a half-written snapshot must
        never be served). Standalone re-analysis exports under a
        ``metrics-analyze`` prefix so it can't clobber the live run's
        snapshot (core.analyze)."""
        d = Path(dirpath)
        d.mkdir(parents=True, exist_ok=True)
        _atomic_write(d / f"{prefix}.prom", self.render_prom())
        _atomic_write(d / f"{prefix}.json", "".join(
            json.dumps(row, default=str) + "\n" for row in self.snapshot()))


class _NullTimer:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_TIMER = _NullTimer()


def _null_observe(value: float) -> None:
    pass


class _NullInstrument:
    """One shared no-op standing in for every instrument when disabled."""

    __slots__ = ()

    def inc(self, amount: float = 1.0, **labels) -> None:
        pass

    def dec(self, amount: float = 1.0, **labels) -> None:
        pass

    def set(self, value: float, **labels) -> None:
        pass

    def set_max(self, value: float, **labels) -> None:
        pass

    def observe(self, value: float, **labels) -> None:
        pass

    def cell(self, **labels) -> list:
        return [0.0]  # fresh throwaway: writes accumulate nowhere shared

    def observer(self, **labels):
        return _null_observe

    def value(self, **labels) -> float:
        return 0.0

    def quantile(self, q: float, **labels):
        return None

    def clear(self) -> None:
        pass


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry:
    """The disabled mode: every constructor returns the shared no-op."""

    enabled = False

    def counter(self, name: str, help: str = "", labels=()):
        return _NULL_INSTRUMENT

    def gauge(self, name: str, help: str = "", labels=()):
        return _NULL_INSTRUMENT

    def histogram(self, name: str, help: str = "", labels=(), buckets=()):
        return _NULL_INSTRUMENT

    def timer(self, name: str, help: str = "", **labels):
        return _NULL_TIMER

    def event(self, name: str, **fields) -> None:
        pass

    def snapshot(self) -> list[dict]:
        return []

    def render_prom(self) -> str:
        return ""

    def export(self, dirpath) -> None:
        pass


NULL = NullRegistry()

_REGISTRY: Registry | NullRegistry = NULL
_REGISTRY_LOCK = threading.Lock()


def get_registry() -> Registry | NullRegistry:
    """The currently installed registry (NULL when telemetry is off)."""
    return _REGISTRY


def install(registry: Registry | NullRegistry | None):
    """Swaps the process-global registry; returns the previous one so
    callers can restore it."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        prev = _REGISTRY
        _REGISTRY = registry if registry is not None else NULL
        return prev


@contextmanager
def use(registry: Registry | NullRegistry):
    prev = install(registry)
    try:
        yield registry
    finally:
        install(prev)


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in labels.items())
    return "{" + inner + "}"


def _atomic_write(path: Path, content: str) -> None:
    # unique tmp per writer: the flusher thread and an analyze-time
    # export may race on the same target, and a shared tmp name could
    # publish a torn file — the one thing this helper exists to prevent
    fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                               prefix=path.name + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(content)
            f.flush()
            # fsync before the rename: without it os.replace can publish
            # the durable name with its data still in the page cache, so
            # a power cut leaves a torn/empty snapshot — and analyze
            # REUSES live-status.json written through this helper
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# ---------------------------------------------------------------------------
# Device helpers: memory high-water, profiler
# ---------------------------------------------------------------------------

# the port's own: the reference reads jax.local_devices()[0].memory_stats()
# (jepsen_tpu/telemetry.py:648-668)
def device_memory_peak_bytes(device) -> int | None:
    """The allocator's high-water on a CUDA device, the value of
    ``torch.cuda.max_memory_allocated(device)`` (the reference's
    ``peak_bytes_in_use``); None for any other device, without touching
    ``torch.cuda``. Read from the allocator's nested stats: the flat dict
    that ``max_memory_allocated`` builds from them costs several times
    more on the host."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    try:
        stats = torch.cuda.memory_stats_as_nested_dict(dev)
        return int(stats.get("allocated_bytes", {}).get("all", {})
                   .get("peak", 0))
    except Exception:  # noqa: BLE001 — telemetry never takes a run down
        return None


# the file profiler_trace writes into its directory
PROFILE_NAME = "torch-profile.json"


# the port's own: the reference starts jax.profiler (jepsen_tpu/
# telemetry.py:766-785)
@contextmanager
def profiler_trace(dirpath):
    """A ``torch.profiler`` trace of the block (CPU activity, and the
    CUDA activity when a card is present), written as a Chrome trace to
    ``dirpath/PROFILE_NAME``. A profiler that cannot start or stop logs,
    and the block still runs."""
    prof = None
    try:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        Path(dirpath).mkdir(parents=True, exist_ok=True)
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception:  # noqa: BLE001
        logger.exception("torch.profiler trace unavailable; continuing")
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(str(Path(dirpath) / PROFILE_NAME))
            except Exception:  # noqa: BLE001
                logger.exception("torch.profiler trace stop failed")
