"""Queue enqueue/dequeue workload (reference: the rabbitmq suite's queue
test — rabbitmq/src/jepsen/system/rabbitmq.clj — checked with
jepsen/src/jepsen/checker.clj:628-687 ``total-queue`` after
``expand-queue-drain-ops`` :594-626).

Clients enqueue unique integers and dequeue concurrently; the final
phase drains every node's queue so the total-queue multiset algebra
(what goes in must come out) is decidable. Dequeues of an empty queue
must complete as ``fail`` with ``value None``.

The port of jepsen_tpu/workloads/queue_workload.py.
"""
from __future__ import annotations

import itertools

from jepsen_tpu_torch import checker as chk
from jepsen_tpu_torch import generator as gen


# copied from jepsen_tpu/workloads/queue_workload.py:19-49
def enqueues():
    counter = itertools.count()

    def enqueue(test, ctx):
        return {"f": "enqueue", "value": next(counter)}

    return gen.Fn(enqueue)


def dequeues():
    def dequeue(test, ctx):
        return {"f": "dequeue", "value": None}

    return gen.Fn(dequeue)


def drains():
    """One drain per thread; clients loop dequeue-until-empty and report
    the drained elements as the op's value."""
    def drain(test, ctx):
        return {"f": "drain", "value": None}

    return gen.each_thread(gen.once(gen.Fn(drain)))


def workload(test: dict | None = None, **_) -> dict:
    return {
        "generator": gen.mix([enqueues(), dequeues()]),
        "final_generator": drains(),
        "checker": chk.total_queue(),
    }
