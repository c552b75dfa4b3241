"""Value interning shared by the encoders and the checkers, and the
struct-of-arrays form of a history that the history IR promotes."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np

# copied from jepsen_tpu/history.py:22-25
INVOKE, OK, FAIL, INFO = "invoke", "ok", "fail", "info"
TYPES = (INVOKE, OK, FAIL, INFO)
TYPE_CODE = {t: i for i, t in enumerate(TYPES)}
NEMESIS_PROCESS = -1


# copied from jepsen_tpu/history.py:61-62
def is_client_op(o: dict) -> bool:
    return isinstance(o.get("process"), int) and o["process"] >= 0


# copied from jepsen_tpu/history.py:75-93
def pair_index(history: Sequence[dict]) -> tuple[np.ndarray, np.ndarray]:
    """For an indexed history, returns (completion_of, invocation_of) int32
    arrays: completion_of[i] is the index of the completion of invocation i
    (or -1); invocation_of[j] the inverse. Nemesis/info ops pair like client
    ops (an invoke by process p completes at p's next non-invoke op)."""
    n = len(history)
    completion_of = np.full(n, -1, dtype=np.int32)
    invocation_of = np.full(n, -1, dtype=np.int32)
    open_invoke: dict[Any, int] = {}
    for i, o in enumerate(history):
        p = o.get("process")
        if o.get("type") == INVOKE:
            open_invoke[p] = i
        else:
            j = open_invoke.pop(p, None)
            if j is not None:
                completion_of[j] = i
                invocation_of[i] = j
    return completion_of, invocation_of


# copied from jepsen_tpu/history.py:114-140
class Intern:
    """Interns arbitrary hashable values to dense int32 ids. id 0 is reserved
    for None (the 'no value' sentinel), so checkers can treat 0 as nil."""

    def __init__(self):
        self.table: list[Any] = [None]
        self._ids: dict[Any, int] = {None: 0}

    def id(self, v) -> int:
        try:
            i = self._ids.get(v)
        except TypeError:  # unhashable: fall back to repr key
            v = ("__unhashable__", repr(v))
            i = self._ids.get(v)
        if i is None:
            i = len(self.table)
            self._ids[v] = i
            self.table.append(v)
        return i

    def value(self, i: int):
        return self.table[i]

    def __len__(self):
        return len(self.table)


# copied from jepsen_tpu/history.py:143-217
@dataclass
class ColumnarHistory:
    """Struct-of-arrays history: the device-ready form.

    Columns are plain numpy; checkers move the slices they need to device.
    ``values`` keeps the original Python objects; workload-specific encoders
    (e.g. register read/write/cas int triples) build their own dense columns
    from them via :class:`Intern`.
    """

    types: np.ndarray        # int8, TYPE_CODE
    processes: np.ndarray    # int32, nemesis = -1
    fs: np.ndarray           # int32 into f_table
    times: np.ndarray        # int64 relative nanos
    indices: np.ndarray      # int32
    completion_of: np.ndarray  # int32, -1 if none
    invocation_of: np.ndarray  # int32, -1 if none
    f_table: list = field(default_factory=list)
    values: list = field(default_factory=list)
    ops: list = field(default_factory=list)  # original dicts (host-side)

    @classmethod
    def from_ops(cls, history: Sequence[dict]) -> "ColumnarHistory":
        history = list(history)
        n = len(history)
        f_intern = Intern()
        types = np.zeros(n, dtype=np.int8)
        processes = np.zeros(n, dtype=np.int32)
        fs = np.zeros(n, dtype=np.int32)
        times = np.zeros(n, dtype=np.int64)
        indices = np.arange(n, dtype=np.int32)
        values = []
        for i, o in enumerate(history):
            types[i] = TYPE_CODE.get(o.get("type"), 3)
            p = o.get("process")
            processes[i] = p if isinstance(p, int) else NEMESIS_PROCESS
            fs[i] = f_intern.id(o.get("f"))
            times[i] = o.get("time", 0) or 0
            idx = o.get("index")
            if idx is not None:
                indices[i] = idx
            values.append(o.get("value"))
        completion_of, invocation_of = pair_index(history)
        return cls(
            types=types, processes=processes, fs=fs, times=times,
            indices=indices, completion_of=completion_of,
            invocation_of=invocation_of, f_table=list(f_intern.table),
            values=values, ops=history,
        )

    def __len__(self) -> int:
        return len(self.types)

    def f_id(self, f) -> int:
        try:
            return self.f_table.index(f)
        except ValueError:
            return -1

    def mask_f(self, f) -> np.ndarray:
        return self.fs == self.f_id(f)

    @property
    def is_invoke(self) -> np.ndarray:
        return self.types == TYPE_CODE[INVOKE]

    @property
    def is_ok(self) -> np.ndarray:
        return self.types == TYPE_CODE[OK]

    @property
    def is_fail(self) -> np.ndarray:
        return self.types == TYPE_CODE[FAIL]

    @property
    def is_info(self) -> np.ndarray:
        return self.types == TYPE_CODE[INFO]
