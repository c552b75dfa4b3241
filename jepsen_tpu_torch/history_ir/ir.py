"""The columnar history IR: :class:`DeviceHistory`.

One canonical struct-of-arrays encoding of a run's history
(jepsen_tpu/history_ir/ir.py): it promotes
:class:`jepsen_tpu_torch.history.ColumnarHistory` — the packed int
columns (type/process/f/time/index plus the invocation pairing) — with

* a **value-id column** and a value :class:`ValueIntern` table, so
  workload values are dense int32 ids;
* **memoized views** (:meth:`DeviceHistory.view`): each checker derives
  its encoding (register event stream, Elle build, set membership,
  per-key split; see :mod:`jepsen_tpu_torch.history_ir.views`) from the
  IR once;
* **lazy columns** (:meth:`DeviceHistory.over`): the run's shared IR
  builds its columns on their first access, so a check whose view reads
  only the ops pays no column build;
* **device placement** (:meth:`DeviceHistory.device_columns`): the
  canonical columns as torch tensors on one device, or padded and split
  over a :class:`jepsen_tpu_torch.parallel.Mesh`, memoized per device or
  mesh.

Its ``.npz`` serialization is :mod:`jepsen_tpu_torch.history_ir.sidecar`;
the live sessions' incremental encoders are
:mod:`jepsen_tpu_torch.history_ir.builder`.
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


#: what :meth:`DeviceHistory.from_ops` builds: a lazy IR's columns
_BUILT = CANONICAL_COLUMNS + ("f_table", "values", "intern")


# copied from jepsen_tpu/history_ir/ir.py:68-144, with lazy columns
@dataclass
class DeviceHistory(ColumnarHistory):
    """ColumnarHistory promoted to the one shared checker IR.

    All base columns keep their dtypes and semantics; ``value_ids``
    interns every op's ``value`` (id 0 = None) into ``intern``. Views
    and device placements are memoized on the instance, so each is
    derived once per IR.
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

    @classmethod
    def over(cls, history: list) -> "DeviceHistory":
        """An IR over the caller's ``history`` list itself whose columns
        are built by :meth:`from_ops` on their first access. The views
        that read only ``ops`` (every checker's encode) pay no column
        build, so a run's first check costs what it costs without the IR.
        An error of that build (a history the columns cannot pack)
        reaches whoever read the column."""
        dh = cls.__new__(cls)
        dh.ops = history
        dh._views = {}
        dh._lock = threading.RLock()
        return dh

    def __getattr__(self, name):
        # reached only for an attribute that is not set: a column of an
        # IR made by over() before its first build
        if name not in _BUILT or "ops" not in self.__dict__:
            raise AttributeError(name)
        with self._lock:
            if not self.columns_built():
                built = DeviceHistory.from_ops(self.ops)
                self.__dict__.update({k: getattr(built, k) for k in _BUILT})
        return self.__dict__[name]

    def columns_built(self) -> bool:
        return "types" in self.__dict__

    def __len__(self) -> int:
        return len(self.types) if self.columns_built() else len(self.ops)

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

    def device_columns(self, device=None, mesh=None) -> tuple[dict, int]:
        """The canonical int columns on the device, memoized per device
        or mesh: ``(columns, n_real)``. Without a mesh each column is one
        tensor on ``resolve_device(device)`` (the CUDA device by
        default). With a :class:`~jepsen_tpu_torch.parallel.Mesh` the op
        axis is padded to a multiple of its width and split by
        :func:`~jepsen_tpu_torch.parallel.shard_chunked`: each column is
        then the list of its shards, shard ``k`` on ``mesh.devices[k]``.
        Pad rows are 0, with ``processes`` and the pairing columns at -1
        (no checker semantics: consumers slice to ``n_real``). A mesh
        keys the memo by its device list, repeats included."""
        if mesh is None:
            from jepsen_tpu_torch.device import resolve_device
            dev = resolve_device(device)
            key = ("__device__", str(dev))
            return self.view(key, lambda: self._place(dev, None))
        key = ("__device__", mesh.key())
        return self.view(key, lambda: self._place(None, mesh))

    def _place(self, device, mesh) -> tuple[dict, int]:
        from jepsen_tpu_torch.ops.jitlin import _upload
        n = len(self)
        cols = {name: getattr(self, name) for name in CANONICAL_COLUMNS}
        if mesh is None:
            return {k: _upload(np.ascontiguousarray(v), device)
                    for k, v in cols.items()}, n
        from jepsen_tpu_torch import parallel
        rem = (-n) % mesh.size
        if rem:
            pad = {"processes": -1, "completion_of": -1,
                   "invocation_of": -1}
            cols = {k: np.concatenate(
                        [v, np.full(rem, pad.get(k, 0), v.dtype)])
                    for k, v in cols.items()}
        placed = parallel.shard_chunked(mesh, list(cols.values()))
        return dict(zip(cols, placed)), n
