"""Bank workload (reference: jepsen/src/jepsen/tests/bank.clj).

Accounts hold balances; transfers move money between them; every read of
all accounts must sum to the invariant total (snapshot-isolation test).
With ``negative_balances`` false, no read may show a negative balance.
The sum scan is a columnar O(n) reduction.

The port of jepsen_tpu/workloads/bank.py.
"""
from __future__ import annotations

import logging

from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.checker import Checker
from jepsen_tpu_torch.utils import int_keyed

# copied from jepsen_tpu/workloads/bank.py:16-156
logger = logging.getLogger("jepsen_tpu_torch.workloads.bank")


def read_op(test, ctx):
    return {"f": "read", "value": None}


def transfer(test, ctx):
    accts = test.get("accounts", list(range(8)))
    frm, to = ctx.rng.sample(list(accts), 2)
    return {"f": "transfer",
            "value": {"from": frm, "to": to,
                      "amount": 1 + ctx.rng.randint(0, test.get("max-transfer", 5) - 1)}}


def generator():
    return gen.mix([gen.Fn(read_op), gen.Fn(transfer)])


class BankChecker(Checker):
    """All ok reads sum to total-amount; optionally no negative balances
    (bank.clj:57-121)."""

    def __init__(self, negative_balances: bool = False):
        self.negative_balances = negative_balances

    def name(self):
        return "bank"

    def check(self, test, history, opts):
        total = test.get("total-amount", 0)
        accounts = set(test.get("accounts", list(range(8))))
        bad_reads = []
        read_count = 0
        for op in history:
            if op.get("type") != "ok" or op.get("f") != "read":
                continue
            read_count += 1
            # stored histories stringify account keys (store.jsonl →
            # analyze); normalize or every re-check sees phantom
            # "unexpected accounts"
            balances = int_keyed(op.get("value") or {})
            errs = []
            extra = set(balances) - accounts
            if extra:
                errs.append({"error": "unexpected-accounts",
                             "accounts": sorted(extra, key=str)})
            s = sum(balances.values())
            if s != total:
                errs.append({"error": "wrong-total", "total": s,
                             "expected": total})
            if not self.negative_balances:
                neg = {a: b for a, b in balances.items() if b < 0}
                if neg:
                    errs.append({"error": "negative-balance", "accounts": neg})
            if errs:
                bad_reads.append({"op": op, "errors": errs})
        return {
            "valid?": not bad_reads,
            "read-count": read_count,
            "error-count": len(bad_reads),
            "first-error": bad_reads[0] if bad_reads else None,
            "bad-reads": bad_reads[:10],
        }


class BankPlotter(Checker):
    """Balance-over-time plot (bank.clj:143-177 plotter): the total of
    all accounts seen by each ok read, one series per node (process mod
    node-count), with nemesis activity shaded. A healthy run draws one
    flat line at total-amount; anomalies show up as excursions."""

    def name(self):
        return "plot"

    def check(self, test, history, opts):
        try:
            points_by_node: dict[str, list[tuple[float, float]]] = {}
            nodes = test.get("nodes") or []
            for op in history:
                if op.get("type") != "ok" or op.get("f") != "read":
                    continue
                balances = op.get("value")
                if not isinstance(balances, dict):
                    continue
                p = op.get("process")
                node = (str(nodes[p % len(nodes)])
                        if nodes and isinstance(p, int) else str(p))
                total = sum(v for v in balances.values() if v is not None)
                points_by_node.setdefault(node, []).append(
                    (op.get("time", 0) / 1e9, total))
            if not points_by_node:
                return {"valid?": True}
            from jepsen_tpu_torch import store
            from jepsen_tpu_torch.checker.perf_plots import (
                _figure, _shade_nemesis)
            # the port's figures are Figures of their own, never pyplot's
            fig, ax = _figure()
            _shade_nemesis(ax, history)
            for node, pts in sorted(points_by_node.items()):
                xs = [x for x, _ in pts]
                ys = [y for _, y in pts]
                ax.plot(xs, ys, "x", ms=4, label=node)
            ax.set_xlabel("time (s)")
            ax.set_ylabel("Total of all accounts")
            ax.set_title(f"{test.get('name', 'test')} bank")
            ax.legend(loc="upper right", fontsize=8)
            d = opts.get("subdirectory")
            path = store.path_mk(test, *filter(None, [d, "bank.png"]))
            fig.savefig(path, bbox_inches="tight")
            return {"valid?": True, "plot": str(path)}
        except Exception:  # noqa: BLE001  plotting must not fail the test
            logger.exception("bank plot failed")
            return {"valid?": True}


def checker(negative_balances: bool = False) -> Checker:
    return BankChecker(negative_balances)


def plotter() -> Checker:
    return BankPlotter()


def workload(test: dict | None = None, negative_balances: bool = False,
             **_) -> dict:
    """Test bundle (bank.clj:179-192): supplies accounts/total defaults;
    the checker composes the snapshot-isolation check with the
    balance-over-time plot exactly like the reference's
    ``{:SI (checker) :plot (plotter)}``."""
    from jepsen_tpu_torch import checker as chk

    accounts = list(range(8))
    return {
        "accounts": accounts,
        # clients initialize each account to 10; reads must preserve the sum
        "total-amount": 10 * len(accounts),
        "max-transfer": 5,
        "generator": generator(),
        "checker": chk.compose({"SI": checker(negative_balances),
                                "plot": plotter()}),
    }
