"""List-append transactional workload: thin wrapper over the Elle-style
checker (reference: jepsen/src/jepsen/tests/cycle/append.clj — a thin
wrapper over elle.list-append/check + gen, append.clj:11-27).

The port of jepsen_tpu/workloads/append.py. ``device`` passes through to
the check (None: the card; the tests pass "cpu").
"""
from __future__ import annotations

from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.checker import Checker
from jepsen_tpu_torch.elle import list_append


# copied from jepsen_tpu/workloads/append.py:12-51
class AppendChecker(Checker):
    def __init__(self, accelerator: str = "auto",
                 consistency_models=("strict-serializable",), device=None):
        self.accelerator = accelerator
        self.consistency_models = consistency_models
        self.device = device

    def name(self):
        return "elle-list-append"

    def check(self, test, history, opts):
        from jepsen_tpu_torch import history_ir
        result = list_append.check(
            history,
            accelerator=opts.get("accelerator", self.accelerator),
            consistency_models=opts.get("consistency_models",
                                        self.consistency_models),
            device=self.device, ir=history_ir.of(test, history))
        # invalid check: leave human-readable per-anomaly explanation
        # files under store/<test>/<ts>/elle/ (the reference passes
        # elle :directory per test, append.clj:17-22)
        from jepsen_tpu_torch.elle import artifacts
        artifacts.write_for_test(test, result, opts, history=history)
        return result


def checker(**kw) -> Checker:
    return AppendChecker(**kw)


def generator(**kw):
    return gen.Fn(list_append.gen(**kw))


def workload(test: dict | None = None, accelerator: str = "auto",
             consistency_models=("strict-serializable",), device=None,
             **gen_kw) -> dict:
    return {
        "generator": generator(**gen_kw),
        "checker": checker(accelerator=accelerator,
                           consistency_models=consistency_models,
                           device=device),
    }
