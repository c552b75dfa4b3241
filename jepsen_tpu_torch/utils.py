"""Host helpers shared by the checkers."""
from __future__ import annotations

import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Iterable, Sequence


# copied from jepsen_tpu/utils/__init__.py:34-45
def atomic_write_json(path, value) -> None:
    """Durable atomic JSON write: tmp file + flush + fsync + rename, so
    readers never see a torn document and the content survives a crash."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(value, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# copied from jepsen_tpu/utils/__init__.py:196-203
def bounded_pmap(fn: Callable, coll: Iterable, bound: int | None = None) -> list:
    """Parallel map with a bounded worker pool (dom-top bounded-pmap)."""
    coll = list(coll)
    if not coll:
        return []
    bound = bound or min(32, len(coll))
    with ThreadPoolExecutor(max_workers=bound) as pool:
        return list(pool.map(fn, coll))


# copied from jepsen_tpu/utils/__init__.py:436-441
def quantile(sorted_xs: Sequence[float], q: float) -> float:
    """Nearest-rank quantile over a pre-sorted sequence."""
    if not sorted_xs:
        return math.nan
    i = min(len(sorted_xs) - 1, max(0, int(math.ceil(q * len(sorted_xs))) - 1))
    return sorted_xs[i]
