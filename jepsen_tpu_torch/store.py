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
``store_sidecar_load_failures_total`` when a registry is live. Not
ported: the results and test maps, the latest links and the artifact
listings.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any

logger = logging.getLogger("jepsen_tpu_torch.store")

# copied from jepsen_tpu/store.py:22
BASE_DIR = "store"


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
