"""Lost-updates workload (reference:
crate/src/jepsen/crate/lost_updates.clj — a map of keys to integer sets
maintained by read-modify-write with the store's optimistic ``_version``
check; every acknowledged add must appear in the key's final read, so a
write that silently clobbers a concurrent one surfaces as a lost
element).

Op shapes (independent-lifted [k, v] values):
- ``{"f": "add", "value": [k, element]}`` — RMW the key's element list
  under a version guard (clients retry conflicts; exhausted retries
  fail the op)
- ``{"f": "read", "value": [k, elements]}`` — the key's current set

The port of jepsen_tpu/workloads/lost_updates.py.
"""
from __future__ import annotations

import itertools
import threading

from jepsen_tpu_torch import checker as chk
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import independent


# copied from jepsen_tpu/workloads/lost_updates.py:24-54
def generator(n_groups: int = 5, adds_per_key: int = 30):
    lock = threading.Lock()
    counter = itertools.count()

    def add(test, ctx):
        with lock:
            return {"f": "add", "value": next(counter)}

    def read(test, ctx):
        return {"f": "read", "value": None}

    def key_gen(k):
        # every thread in the group races RMW adds, then (after the
        # group drains — gen.phases barriers) each takes one final read
        # of the key (the reference's phases + each/once shape,
        # lost_updates.clj:130-136)
        return gen.phases(gen.limit(adds_per_key, gen.Fn(add)),
                          gen.each_thread(gen.once(gen.Fn(read))))

    return independent.concurrent_generator(n_groups, itertools.count(),
                                            key_gen)


def workload(test: dict | None = None, **_) -> dict:
    test = test or {}
    n = len(test.get("nodes") or []) or 5
    return {
        "lost-updates": True,  # client dispatch marker
        "generator": generator(n_groups=n),
        "checker": independent.checker(chk.set_checker()),
    }
