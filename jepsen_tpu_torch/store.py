"""Persistence of a run: ``store_dir/name/start_time/`` (the port of
jepsen_tpu/store.py, itself after jepsen/src/jepsen/store.clj).

What a stored re-check writes and reads: the run's directory and
``check.ckpt``'s place (checker/checkpoint.py), ``history.jsonl`` (one op
a line) with its human-readable ``history.txt``, and the ``history.npz``
sidecar, the serialized history IR (history_ir/sidecar.py) whose
``elle_*`` and ``lin_*`` columns let ``elle.list_append.check_stored``
and ``checker.linearizable.check_stored`` re-check a run without its
jsonl. A sidecar that is missing, predates the columns or fails to load
falls back to ``history.jsonl`` with a logged warning, counted in
``store_sidecar_load_failures_total`` when a registry is live. The run
loop's part: ``save_1`` (history, sidecar, test map) before analysis,
``save_2`` (results, test map) after, the ``latest``/``current`` links,
the loaders of a stored run, the artifact listings and the per-test
``jepsen.log``.
"""
from __future__ import annotations

import datetime
import json
import logging
import shutil
from pathlib import Path
from typing import Any

logger = logging.getLogger("jepsen_tpu_torch.store")

# copied from jepsen_tpu/store.py:22
BASE_DIR = "store"

# copied from jepsen_tpu/store.py:24-88
# Dropped before serialization (store.clj:160-168)
NONSERIALIZABLE_KEYS = {
    "db", "os", "net", "client", "checker", "nemesis", "generator", "model",
    "remote", "barrier", "tracer",
}

# Telemetry artifacts a run may leave next to history/results
# (see doc/observability.md): exported metrics, the span logs (the
# per-client trace.jsonl and the run-wide Perfetto trace.json), the
# live checker daemon's streaming verdict, and the jax.profiler trace
# dir.
TELEMETRY_FILES = ("metrics.prom", "metrics.json", "trace.jsonl",
                   "trace.json", "trace-derived.json",
                   "live-status.json")
PROFILE_DIR = "profile"

# Robustness forensics (doc/robustness.md): completions quarantined
# from reaped zombie workers, the stall watchdog's thread-stack dumps,
# the flight recorder's crash/stall dump (doc/observability.md "Causal
# trace"), and an interrupted check's durable checkpoint / the live
# daemon's restart snapshot (both cleared on completion — their
# PRESENCE marks an interrupted check/daemon). Present only when the
# run actually produced them.
FORENSIC_FILES = ("late.jsonl", "stall-threads.txt",
                  "flight-recorder.jsonl", "check.ckpt",
                  "live-session.ckpt")

# Anomaly forensics (doc/observability.md "Anomaly forensics"): the
# first-anomaly + minimal-witness artifact and its rendered timeline,
# written on INVALID verdicts (and by `jepsen-tpu explain`).
EXPLAIN_FILES = ("anomaly.json", "witness-timeline.html")


def _artifact_files(run_dir: Path, names) -> dict:
    """{artifact-name: Path} for whichever of ``names`` exist as files
    in a stored run directory (the shared probe behind each artifact
    family's helper)."""
    out: dict[str, Path] = {}
    for name in names:
        p = Path(run_dir) / name
        if p.is_file():
            out[name] = p
    return out


def telemetry_artifacts(run_dir: Path) -> dict:
    """{artifact-name: Path} for the telemetry files present in a stored
    run directory (the web UI links these alongside the classics)."""
    out = _artifact_files(run_dir, TELEMETRY_FILES)
    p = Path(run_dir) / PROFILE_DIR
    if p.is_dir():
        out[PROFILE_DIR] = p
    return out


def forensic_artifacts(run_dir: Path) -> dict:
    """{artifact-name: Path} for the robustness forensics present in a
    stored run directory (late.jsonl / stall-threads.txt)."""
    return _artifact_files(run_dir, FORENSIC_FILES)


def explain_artifacts(run_dir: Path) -> dict:
    """{artifact-name: Path} for the anomaly-forensics artifacts present
    in a stored run directory (anomaly.json / witness-timeline.html)."""
    return _artifact_files(run_dir, EXPLAIN_FILES)


# copied from jepsen_tpu/store.py:91-100
def base_dir(test: dict) -> Path:
    return Path(test.get("store_dir", BASE_DIR))


def test_dir(test: dict) -> Path:
    return base_dir(test) / str(test.get("name", "noop")) / str(test["start_time"])


def path(test: dict, *components) -> Path:
    return test_dir(test).joinpath(*[str(c) for c in components])


# copied from jepsen_tpu/store.py:103-107
def path_mk(test: dict, *components) -> Path:
    """path + mkdir -p of the parent (store.clj path!)."""
    p = path(test, *components)
    p.parent.mkdir(parents=True, exist_ok=True)
    return p


# the types _serializable returns as they are
_PLAIN = (str, int, float, bool, type(None))


# copied from jepsen_tpu/store.py:110-125, with one shortcut: a list of
# plain values (a read's payload) is copied as it is, where the reference
# walks each element to the same result
def _serializable(x: Any):
    if isinstance(x, dict):
        return {str(k): _serializable(v) for k, v in x.items()
                if not (isinstance(k, str) and k.startswith("_"))}
    if isinstance(x, (list, tuple)):
        if all(type(v) in _PLAIN for v in x):
            return list(x)
        return [_serializable(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted((_serializable(v) for v in x), key=repr)
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    if isinstance(x, Path):
        return str(x)
    import numpy as np
    if isinstance(x, np.generic):
        return x.item()
    return repr(x)


# copied from jepsen_tpu/store.py:128-133
def serializable_test(test: dict) -> dict:
    return _serializable({
        k: v for k, v in test.items()
        if k not in NONSERIALIZABLE_KEYS and not str(k).startswith("_")
        and k not in ("history", "results")
    })


# copied from jepsen_tpu/store.py:136-146
def write_history(test: dict) -> None:
    """history.jsonl: one op per line (store.clj:354-371). Also writes
    history.txt in the reference's human format."""
    from jepsen_tpu_torch.utils import op2str
    history = test.get("history") or []
    with open(path_mk(test, "history.jsonl"), "w") as f:
        for op in history:
            f.write(json.dumps(_serializable(op)) + "\n")
    with open(path_mk(test, "history.txt"), "w") as f:
        for op in history:
            f.write(op2str(op) + "\n")


# copied from jepsen_tpu/store.py:149-158
def first_client_f(history) -> str | None:
    """The first CLIENT op's ``:f`` — the cheap workload-shape probe of
    the columnar sidecar. Looks only at int-process ops: a nemesis op
    firing before the first client invoke must not mask the workload
    (the encoders themselves drop non-int-process ops)."""
    return next(
        (op.get("f") for op in history
         if isinstance(op.get("process"), int) and op.get("process") >= 0
         and op.get("f") is not None), None)


# copied from jepsen_tpu/store.py:161-179
def write_columnar(test: dict) -> None:
    """history.npz: the serialized history IR, checker-ready. The
    sidecar holds the canonical packed columns and the value intern
    table, plus the derived view products — ``elle_*`` Elle builder
    columns and ``lin_*`` register EventStream — so later re-checks run
    straight off arrays with no PyObject parse. The IR is the run's
    shared one (``history_ir.of``): a view its checkers already built
    (the register stream) is not built again, and its columns are built
    here on their first access."""
    from jepsen_tpu_torch import history_ir
    from jepsen_tpu_torch.history_ir import sidecar
    history = test.get("history") or []
    if not history:
        return
    dh = history_ir.of(test, history)
    if dh is None:  # ir_enabled: False still persists a sidecar
        dh = history_ir.DeviceHistory.from_ops(history)
    sidecar.save(path_mk(test, "history.npz"), dh)


# copied from jepsen_tpu/store.py:182-192
def load_columnar(test_name: str, timestamp: str, store_dir: str = BASE_DIR):
    """Reloads the .npz sidecar as a DeviceHistory (the history IR,
    sans Python op dicts — those live in history.jsonl)."""
    from jepsen_tpu_torch.history_ir import sidecar
    p = path({"name": test_name, "start_time": timestamp,
              "store_dir": store_dir}, "history.npz")
    return sidecar.load(p)


# copied from jepsen_tpu/store.py:195-211
def note_sidecar_load_failure(what: str, exc: BaseException | None = None) -> None:
    """A corrupt or unreadable history.npz sidecar fell back to the
    jsonl history: log it and bump ``store_sidecar_load_failures_total``,
    so that the fallback is visible instead of silent."""
    logger.warning("history.npz sidecar unreadable for %s (%r); "
                   "falling back to history.jsonl", what, exc)
    try:
        from jepsen_tpu_torch import telemetry
        reg = telemetry.get_registry()
        if reg.enabled:
            reg.counter(
                "store_sidecar_load_failures_total",
                "corrupt/unreadable history.npz sidecars that fell "
                "back to the jsonl history").inc()
    except Exception:  # noqa: BLE001 — telemetry never blocks a fallback
        logger.exception("sidecar-failure telemetry recording failed")


# copied from jepsen_tpu/store.py:214-223
def _load_prefixed(test_name: str, timestamp: str, store_dir: str,
                   prefix: str, probe_key: str) -> dict | None:
    import numpy as np
    p = path({"name": test_name, "start_time": timestamp,
              "store_dir": store_dir}, "history.npz")
    with np.load(p, allow_pickle=True) as z:
        if probe_key not in z:
            return None
        return {k[len(prefix):]: z[k] for k in z.files
                if k.startswith(prefix)}


# copied from jepsen_tpu/store.py:226-238
def load_elle_columns(test_name: str, timestamp: str,
                      store_dir: str = BASE_DIR) -> dict | None:
    """The stored Elle builder columns (``elle_*`` in history.npz), or
    None when the run predates them / the history wasn't storable."""
    return _load_prefixed(test_name, timestamp, store_dir, "elle_",
                          "elle_n_ok")


def load_linear_columns(test_name: str, timestamp: str,
                        store_dir: str = BASE_DIR) -> dict | None:
    """The stored register EventStream columns (``lin_*``), or None."""
    return _load_prefixed(test_name, timestamp, store_dir, "lin_",
                          "lin_n_slots")


# copied from jepsen_tpu/store.py:241-285
def write_results(test: dict) -> None:
    with open(path_mk(test, "results.json"), "w") as f:
        json.dump(_serializable(test.get("results")), f, indent=2)


def write_test(test: dict) -> None:
    with open(path_mk(test, "test.json"), "w") as f:
        json.dump(serializable_test(test), f, indent=2, default=repr)


def save_1(test: dict) -> dict:
    """Post-run save: history + test map, before analysis
    (store.clj:388-399, core.clj:395)."""
    write_history(test)
    write_columnar(test)
    write_test(test)
    update_symlinks(test)
    return test


def save_2(test: dict) -> dict:
    """Post-analysis save: results + rewrite test (store.clj:401-413)."""
    write_results(test)
    write_test(test)
    update_symlinks(test)
    return test


def update_symlinks(test: dict) -> None:
    """store/<name>/latest and store/current (store.clj:316-342)."""
    d = test_dir(test)
    for link in [base_dir(test) / str(test.get("name", "noop")) / "latest",
                 base_dir(test) / "current"]:
        try:
            link.parent.mkdir(parents=True, exist_ok=True)
            if link.is_symlink() or link.exists():
                link.unlink()
            link.symlink_to(d.resolve())
        except OSError:
            logger.debug("couldn't update symlink %s", link)


def load_results(test_name: str, timestamp: str, store_dir: str = BASE_DIR) -> dict:
    with open(Path(store_dir) / test_name / timestamp / "results.json") as f:
        return json.load(f)


# copied from jepsen_tpu/store.py:288-300
def load_history(test_name: str, timestamp: str, store_dir: str = BASE_DIR) -> list[dict]:
    """Reads history.jsonl, tolerating the torn final line a crash (or a
    disk-full save) can leave — a truncated tail is dropped with a
    warning instead of raising json.JSONDecodeError, so re-analysis of
    a damaged run still sees every complete op."""
    from jepsen_tpu_torch.journal import read_jsonl_tolerant
    p = Path(store_dir) / test_name / timestamp / "history.jsonl"
    ops, truncated = read_jsonl_tolerant(p)
    if truncated:
        logger.warning("history.jsonl at %s has a torn final line; "
                       "dropped it", p)
    return ops


# copied from jepsen_tpu/store.py:303-384
read_history = load_history


def load_test(test_name: str, timestamp: str, store_dir: str = BASE_DIR) -> dict:
    d = Path(store_dir) / test_name / timestamp
    with open(d / "test.json") as f:
        test = json.load(f)
    try:
        test["history"] = load_history(test_name, timestamp, store_dir)
    except FileNotFoundError:
        pass
    try:
        test["results"] = load_results(test_name, timestamp, store_dir)
    except FileNotFoundError:
        pass
    return test


def tests(test_name: str | None = None, store_dir: str = BASE_DIR) -> dict:
    """{name: {timestamp: path}} (store.clj:284-303)."""
    base = Path(store_dir)
    out: dict = {}
    if not base.exists():
        return out
    names = [test_name] if test_name else [p.name for p in base.iterdir()
                                           if p.is_dir() and p.name != "current"]
    for name in names:
        d = base / name
        if not d.is_dir():
            continue
        out[name] = {p.name: p for p in sorted(d.iterdir())
                     if p.is_dir() and p.name != "latest" and not p.is_symlink()}
    return out


def latest(store_dir: str = BASE_DIR):
    """Most recent test dir across all names (store.clj:305-314)."""
    best = None
    for name, runs in tests(store_dir=store_dir).items():
        for ts, p in runs.items():
            if best is None or ts > best[1]:
                best = (name, ts, p)
    return best


def delete(test_name: str | None = None, store_dir: str = BASE_DIR) -> None:
    """Deletes stored runs (store.clj:461-478)."""
    base = Path(store_dir)
    target = base / test_name if test_name else base
    if target.exists():
        shutil.rmtree(target)


def start_time() -> str:
    return datetime.datetime.now().strftime("%Y%m%dT%H%M%S.%f")[:-3]


_log_handler: dict = {}


def start_logging(test: dict) -> None:
    """Per-test jepsen.log file appender + console (store.clj:431-451)."""
    stop_logging()
    root = logging.getLogger("jepsen_tpu_torch")
    root.setLevel(logging.INFO)
    if not any(isinstance(h, logging.StreamHandler) for h in root.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s [%(threadName)s] %(name)s: %(message)s"))
        root.addHandler(sh)
    fh = logging.FileHandler(path_mk(test, "jepsen.log"))
    fh.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s [%(threadName)s] %(name)s: %(message)s"))
    root.addHandler(fh)
    _log_handler["fh"] = fh


def stop_logging() -> None:
    fh = _log_handler.pop("fh", None)
    if fh is not None:
        logging.getLogger("jepsen_tpu_torch").removeHandler(fh)
        fh.close()
