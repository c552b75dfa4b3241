"""Host helpers shared by the checkers."""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable


# copied from jepsen_tpu/utils/__init__.py:196-203
def bounded_pmap(fn: Callable, coll: Iterable, bound: int | None = None) -> list:
    """Parallel map with a bounded worker pool (dom-top bounded-pmap)."""
    coll = list(coll)
    if not coll:
        return []
    bound = bound or min(32, len(coll))
    with ThreadPoolExecutor(max_workers=bound) as pool:
        return list(pool.map(fn, coll))
