"""Checker protocol: ``check(test, history, opts) -> {"valid?": ...}``
where valid? is True, False, or "unknown"."""
from __future__ import annotations


# copied from jepsen_tpu/checker/__init__.py:39-44
class Checker:
    def check(self, test: dict, history: list[dict], opts: dict) -> dict:
        raise NotImplementedError

    def name(self) -> str:
        return type(self).__name__
