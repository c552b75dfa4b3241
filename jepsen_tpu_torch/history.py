"""Value interning shared by the encoders and the checkers."""
from __future__ import annotations

from typing import Any


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
