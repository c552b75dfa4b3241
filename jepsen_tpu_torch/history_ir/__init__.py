"""The columnar history IR (jepsen_tpu/history_ir): one encoding of a
run's history, shared by its checkers and persisted as the
``history.npz`` sidecar.

``history_ir.of(test, history)`` is the checkers' whole interface: it
returns the run's shared :class:`DeviceHistory` — memoized on the test
map under ``_history_ir`` (underscore keys never serialize) — or None
when the IR is off (``ir_enabled: False``) or there is no test map to
share it through. Every checker then derives its encoding as a memoized
view (:mod:`.views`), so a run with several checkers encodes once;
:mod:`.sidecar` saves and loads the IR, :mod:`.builder` holds the live
sessions' incremental encoders.

The knob ``ir_enabled`` (test map, coerced by ``parallel.coerce_flag``,
default True): False gives every checker its own encode (the views are
the encoders, so the results are the same).

One change from the reference: :func:`of` builds nothing. Its IR
(:meth:`DeviceHistory.over`) builds the canonical columns on their first
access, which the checkers' views never make, so one check costs what it
costs without the IR, and an error of that build reaches the caller that
read a column (the sidecar, ``device_columns``). The reference builds
the columns in ``of`` and takes any exception there for a history it
cannot pack (None, and each checker encodes on its own).
"""
from __future__ import annotations

import threading

from jepsen_tpu_torch.history_ir.ir import CANONICAL_COLUMNS, DeviceHistory

__all__ = ["DeviceHistory", "CANONICAL_COLUMNS", "of", "enabled"]

# copied from jepsen_tpu/history_ir/__init__.py:42-128, without the WAL
# streamer
#: test-map key the shared IR memoizes under (underscore: never serialized)
ATTACH_KEY = "_history_ir"

# one lock for the attach-or-build race: composed checkers may ask for
# the IR at the same time
_ATTACH_LOCK = threading.Lock()


def enabled(test) -> bool:
    """The ``ir_enabled`` knob, tolerantly coerced (default True)."""
    from jepsen_tpu_torch.parallel import coerce_flag
    if not isinstance(test, dict):
        return True
    flag = coerce_flag(test.get("ir_enabled"), knob="ir_enabled")
    return True if flag is None else flag


def of(test, history) -> DeviceHistory | None:
    """The run's shared IR for ``history``, or None when disabled or
    when there's no test map to memoize on. Reuses the cached IR only
    when it was made for this exact history object (a re-indexed history
    is a new list, and a stale IR must never serve it). The IR holds the
    caller's list itself and builds its columns on first access."""
    if not isinstance(test, dict) or not enabled(test) or history is None:
        return None
    with _ATTACH_LOCK:
        cached = test.get(ATTACH_KEY)
        if isinstance(cached, DeviceHistory) and cached.ops is history:
            return cached
        dh = DeviceHistory.over(history)
        test[ATTACH_KEY] = dh
        return dh
