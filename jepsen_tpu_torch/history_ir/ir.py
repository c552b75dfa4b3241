"""The columnar history IR: :class:`DeviceHistory`.

One canonical struct-of-arrays encoding of a run's history
(jepsen_tpu/history_ir/ir.py): it promotes
:class:`jepsen_tpu_torch.history.ColumnarHistory` — the packed int
columns (type/process/f/time/index plus the invocation pairing) — with

* a **value-id column** and a value :class:`ValueIntern` table, so
  workload values are dense int32 ids;
* **memoized views** (:meth:`DeviceHistory.view`): each checker derives
  its encoding (register event stream, Elle builder columns; see
  :mod:`jepsen_tpu_torch.history_ir.views`) from the IR once.

Its ``.npz`` serialization is :mod:`jepsen_tpu_torch.history_ir.sidecar`.
The device placement of the canonical columns (the reference's
``device_columns``) is not ported.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from jepsen_tpu_torch.history import ColumnarHistory, Intern

# copied from jepsen_tpu/history_ir/ir.py:39-41
#: canonical packed-int column names, in sidecar order
CANONICAL_COLUMNS = ("types", "processes", "fs", "times", "indices",
                     "completion_of", "invocation_of", "value_ids")


# copied from jepsen_tpu/history_ir/ir.py:44-65
class ValueIntern(Intern):
    """Intern specialized for op *values*: unhashable values (lists —
    the universal op-value shape: cas pairs, txn micro-ops) key by a
    repr freeze like the base class, but the TABLE keeps the original
    value, so ``value(id)`` returns what the op actually carried and
    the sidecar's codec round-trip is faithful (the base class stores
    the marker tuple itself, which is fine for f-name interning but
    lossy for values)."""

    def id(self, v) -> int:
        try:
            i = self._ids.get(v)
            key = v
        except TypeError:  # unhashable: freeze the key, keep the value
            key = ("__unhashable__", repr(v))
            i = self._ids.get(key)
        if i is None:
            i = len(self.table)
            self._ids[key] = i
            self.table.append(v)
        return i


# copied from jepsen_tpu/history_ir/ir.py:68-113
@dataclass
class DeviceHistory(ColumnarHistory):
    """ColumnarHistory promoted to the one shared checker IR.

    All base columns keep their dtypes and semantics; ``value_ids``
    interns every op's ``value`` (id 0 = None) into ``intern``. Views
    are memoized on the instance, so each is derived once per IR.
    """

    value_ids: np.ndarray | None = None  # int32 into intern
    intern: Intern = field(default_factory=ValueIntern)
    _views: dict = field(default_factory=dict, repr=False, compare=False)
    _lock: threading.RLock = field(default_factory=threading.RLock,
                                   repr=False, compare=False)

    @classmethod
    def from_ops(cls, history: Sequence[dict],
                 intern: Intern | None = None) -> "DeviceHistory":
        dh = super().from_ops(history)
        dh.intern = intern or ValueIntern()
        vid = dh.intern.id
        dh.value_ids = np.fromiter((vid(v) for v in dh.values),
                                   np.int32, len(dh.values))
        return dh

    def view(self, key, build: Callable):
        """The memoized derived view for ``key`` (any hashable), built
        by ``build()`` exactly once. Concurrent checkers serialize on the
        first build and then share the product. A ``build`` that raises
        caches nothing."""
        with self._lock:
            if key not in self._views:
                self._views[key] = build()
            return self._views[key]

    def view_keys(self) -> tuple:
        with self._lock:
            return tuple(self._views)
