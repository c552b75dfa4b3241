"""Checker protocol: ``check(test, history, opts) -> {"valid?": ...}``
where valid? is True, False, or "unknown"; and the plumbing that merges
and composes checkers."""
from __future__ import annotations

import logging
from typing import Any

from jepsen_tpu_torch.utils import bounded_pmap

logger = logging.getLogger("jepsen_tpu_torch.checker")

# copied from jepsen_tpu/checker/__init__.py:27
VALID_PRIORITY = {False: 0, "unknown": 1, True: 2}


# copied from jepsen_tpu/checker/__init__.py:29-36
def merge_valid(valids) -> Any:
    """false > unknown > true (checker.clj:29-50)."""
    result = True
    for v in valids:
        v = "unknown" if v == "unknown" else bool(v) if isinstance(v, bool) else v
        if VALID_PRIORITY.get(v, 1) < VALID_PRIORITY.get(result, 1):
            result = v
    return result


# copied from jepsen_tpu/checker/__init__.py:39-44
class Checker:
    def check(self, test: dict, history: list[dict], opts: dict) -> dict:
        raise NotImplementedError

    def name(self) -> str:
        return type(self).__name__


# copied from jepsen_tpu/checker/__init__.py:47-53
def check_safe(checker: Checker, test: dict, history: list[dict],
               opts: dict | None = None) -> dict:
    """Exceptions become {'valid?': 'unknown'} (checker.clj:74-85)."""
    try:
        return checker.check(test, history, opts or {})
    except Exception as e:  # noqa: BLE001
        logger.exception("checker %s crashed", checker.name())
        return {"valid?": "unknown", "error": repr(e)}


# copied from jepsen_tpu/checker/__init__.py:56-71
class Compose(Checker):
    """A map of named checkers run in parallel; overall valid? merges
    (checker.clj:87-99)."""

    def __init__(self, checkers: dict[str, Checker]):
        self.checkers = checkers

    def check(self, test, history, opts):
        names = list(self.checkers)
        results = bounded_pmap(
            lambda n: check_safe(self.checkers[n], test, history, opts), names
        )
        by_name = dict(zip(names, results))
        return {
            "valid?": merge_valid(r.get("valid?") for r in results),
            **by_name,
        }


# copied from jepsen_tpu/checker/__init__.py:74-75
def compose(checkers: dict[str, Checker]) -> Checker:
    return Compose(checkers)
