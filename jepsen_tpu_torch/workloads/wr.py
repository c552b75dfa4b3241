"""Read-write-register transactional workload: thin wrapper over the
Elle-style rw-register checker (reference:
jepsen/src/jepsen/tests/cycle/wr.clj).

The port of jepsen_tpu/workloads/wr.py. ``device`` passes through to the
check (None: the card; the tests pass "cpu").
"""
from __future__ import annotations

from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.checker import Checker
from jepsen_tpu_torch.elle import rw_register


# copied from jepsen_tpu/workloads/wr.py:12-50
class WrChecker(Checker):
    def __init__(self, accelerator: str = "auto",
                 consistency_models=("strict-serializable",), device=None):
        self.accelerator = accelerator
        self.consistency_models = consistency_models
        self.device = device

    def name(self):
        return "elle-rw-register"

    def check(self, test, history, opts):
        from jepsen_tpu_torch import history_ir
        result = rw_register.check(
            history,
            accelerator=opts.get("accelerator", self.accelerator),
            consistency_models=opts.get("consistency_models",
                                        self.consistency_models),
            device=self.device, ir=history_ir.of(test, history))
        # same artifact surface as the list-append checker: per-anomaly
        # explanation files in the run's elle/ directory when invalid
        from jepsen_tpu_torch.elle import artifacts
        artifacts.write_for_test(test, result, opts, history=history)
        return result


def checker(**kw) -> Checker:
    return WrChecker(**kw)


def generator(**kw):
    return gen.Fn(rw_register.gen(**kw))


def workload(test: dict | None = None, accelerator: str = "auto",
             consistency_models=("strict-serializable",), device=None,
             **gen_kw) -> dict:
    return {
        "generator": generator(**gen_kw),
        "checker": checker(accelerator=accelerator,
                           consistency_models=consistency_models,
                           device=device),
    }
