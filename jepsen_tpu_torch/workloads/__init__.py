"""Reusable workload kits: generator + checker (+ final-generator) bundles
(the port of jepsen_tpu/workloads/).

Capability-equivalent to the reference's jepsen.tests.* namespaces
(jepsen/src/jepsen/tests/, SURVEY.md §2.2). A workload is a plain dict:

    {"generator": ..., "checker": ..., "final_generator": ...?, ...}

merged into a test map by suites; the "test = data" property is preserved
(SURVEY.md §5.6).

The port has the kits of :data:`PORTED`. The kits of :data:`UNPORTED`
wait for ROADMAP Queue 1 item 11; asking this package for one raises
``NotImplementedError``.
"""
from __future__ import annotations

import importlib

#: the ported kits, each imported here as the reference's package imports
#: its own (jepsen_tpu/workloads/__init__.py:13-23)
PORTED = ("append", "bank", "counter", "cp_lock", "long_fork",
          "lost_updates", "multi_key_acid", "mutex", "pause_workload",
          "queue_workload", "register", "set_workload", "single_key_acid",
          "transfer", "wr")

UNPORTED = ("adya", "causal", "causal_reverse", "comments",
            "crate_dirty_read", "cycle", "default_value", "delete_workload",
            "dgraph_sequential", "dirty_read", "dirty_reads",
            "fauna_internal", "fauna_monotonic", "fauna_multimonotonic",
            "ledger", "monotonic", "monotonic_key", "pages", "sequential",
            "table_workload", "upsert", "version_divergence")

for _name in PORTED:
    importlib.import_module(f"{__name__}.{_name}")

__all__ = list(PORTED)


def __getattr__(name: str):
    if name in UNPORTED:
        raise NotImplementedError(
            f"the workload kit {name!r} is not ported yet (ROADMAP Queue 1 "
            "item 11)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
