"""Set add/read workload (reference checkers: jepsen/src/jepsen/checker.clj
240-291 `set` and 461-592 `set-full`).

Clients add unique integers to a set; reads return the whole set. The
quick checker compares the final read against attempted adds; set-full
tracks every element's visibility window across all reads.

The port of jepsen_tpu/workloads/set_workload.py. Unlike the reference's
kit, whose set-full checks on the host unless asked, ``accelerator``
defaults to "auto" (the card, as ``checker.set_full`` does); it and
``device`` pass through to set-full's checker (the tests pass "cpu").
"""
from __future__ import annotations

import itertools

from jepsen_tpu_torch import checker as chk
from jepsen_tpu_torch import generator as gen


# copied from jepsen_tpu/workloads/set_workload.py:16-46
def adds():
    """Infinite unique-element add ops."""
    counter = itertools.count()

    def add(test, ctx):
        return {"f": "add", "value": next(counter)}

    return gen.Fn(add)


def reads(final: bool = False):
    def read(test, ctx):
        return {"f": "read", "value": None}

    # final reads: one per thread; the composing suite applies the
    # clients-only restriction (suites.compose_test owns that wrap)
    if final:
        return gen.each_thread(gen.once(gen.Fn(read)))
    return gen.Fn(read)


def workload(test: dict | None = None, full: bool = False,
             linearizable: bool = False, accelerator: str = "auto",
             device=None, **_) -> dict:
    return {
        "generator": adds() if full is False else gen.mix([adds(), reads()]),
        "final_generator": reads(final=True),
        "checker": (chk.set_full(linearizable=linearizable,
                                 accelerator=accelerator, device=device)
                    if full else chk.set_checker()),
    }
