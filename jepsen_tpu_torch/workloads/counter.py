"""PN-counter workload (reference: the aerospike and yugabyte counter
tests — aerospike/src/aerospike/counter.clj, yugabyte counter clients —
over jepsen's counter checker, checker.clj:737-795).

Clients add random increments (and, when ``negative`` is set,
decrements) to one shared counter while readers poll it; every ok read
must fall inside the [sum-of-acknowledged, sum-of-attempted] window,
with indeterminate adds widening the window forever.

Op shapes: ``{"f": "add", "value": delta}`` and ``{"f": "read",
"value": None → int}``.

The port of jepsen_tpu/workloads/counter.py.
"""
from __future__ import annotations

from jepsen_tpu_torch import checker as chk
from jepsen_tpu_torch import generator as gen


# copied from jepsen_tpu/workloads/counter.py:19-42
def adds(negative: bool = False):
    def add(test, ctx):
        v = 1 + ctx.rng.randint(0, 4)
        if negative and ctx.rng.random() < 0.5:
            v = -v
        return {"f": "add", "value": v}

    return gen.Fn(add)


def reads():
    def read(test, ctx):
        return {"f": "read", "value": None}

    return gen.Fn(read)


def workload(test: dict | None = None, negative: bool = False,
             **_) -> dict:
    return {
        "counter": True,  # fake-client dispatch marker
        "generator": gen.mix([adds(negative), reads()]),
        "checker": chk.counter(),
    }
