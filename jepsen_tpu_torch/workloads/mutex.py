"""Distributed mutex workload (reference: the rabbitmq suite's
Semaphore client, rabbitmq/src/jepsen/rabbitmq.clj:178-255 — a
one-message queue as a lock: holding the message is holding the mutex).

Each thread alternates acquire and release; the checker is
linearizability against the knossos mutex model (acquire of a held
lock / release of a free lock are inconsistent). A failed acquire
(lock busy) completes ``fail`` and is invisible to the model.

The port of jepsen_tpu/workloads/mutex.py.
"""
from __future__ import annotations

from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.models import Mutex


# copied from jepsen_tpu/workloads/mutex.py:17-29
def generator():
    return gen.each_thread(gen.cycle(gen.Seq([
        {"f": "acquire", "value": None},
        {"f": "release", "value": None},
    ])))


def workload(test: dict | None = None, accelerator: str = "auto",
             **_) -> dict:
    return {
        "generator": generator(),
        "checker": linearizable(model=Mutex(), accelerator=accelerator),
    }
