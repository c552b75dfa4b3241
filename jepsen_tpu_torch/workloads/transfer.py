"""Bank-transfer-via-two-phase-commit workload (reference:
mongodb-smartos/src/jepsen/mongodb_smartos/transfer.clj — models the
MongoDB "perform two-phase commits" tutorial: each transfer is a
multi-step txn-document dance, full reads snapshot every account, and
``partial-read`` reads only accounts with no transaction in flight).

Op shapes (transfer.clj:148-173, 223-241):
- ``{"f": "read", "value": None}`` → ok ``{acct: balance, ...}`` over
  ALL accounts (no synchronization — may catch mid-transfer states).
- ``{"f": "partial-read", "value": None}`` → ok ``{acct: balance}``
  over accounts with empty pending-txn lists only.
- ``{"f": "transfer", "value": {"from": a, "to": b, "amount": m}}``.

The checker is the reference's knossos model check (transfer.clj:190-222
``Accounts``): the history must be linearizable against an account-map
model where a full read sees exactly the current balances, a partial
read's entries each match the model, and transfers move ``amount``
between accounts. Runs on the shared linearizable checker's WGL oracle.

The port of jepsen_tpu/workloads/transfer.py.
"""
from __future__ import annotations

from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.checker import Checker
from jepsen_tpu_torch.models import Inconsistent, Model, inconsistent
from jepsen_tpu_torch.utils import int_keyed

# copied from jepsen_tpu/workloads/transfer.py:27-131
DEFAULT_ACCOUNTS = 2
DEFAULT_BALANCE = 10
MAX_TRANSFER = 5


class Accounts(Model):
    """Account-map model (transfer.clj:190-212). Balances may go
    negative — the reference model places no floor; the invariant under
    test is read consistency, not solvency."""

    def __init__(self, balances: dict):
        self.balances = dict(balances)

    def step(self, op):
        f, v = op.get("f"), op.get("value")
        if f == "read":
            if v == self.balances:
                return self
            return inconsistent(f"can't read {v} from {self.balances}")
        if f == "partial-read":
            for acct, bal in (v or {}).items():
                if self.balances.get(acct) != bal:
                    return inconsistent(
                        f"{v} isn't consistent with {self.balances}")
            return self
        if f == "transfer":
            frm, to, amount = v["from"], v["to"], v["amount"]
            nxt = dict(self.balances)
            nxt[frm] = nxt.get(frm, 0) - amount
            nxt[to] = nxt.get(to, 0) + amount
            return Accounts(nxt)
        return inconsistent(f"unknown op {f}")

    def __eq__(self, other):
        return isinstance(other, Accounts) and \
            self.balances == other.balances

    def __hash__(self):
        return hash(tuple(sorted(self.balances.items())))

    def __repr__(self):
        return f"Accounts({self.balances})"


def _norm_op(op: dict) -> dict:
    """JSON round-trips (store.jsonl → analyze re-check) stringify dict
    keys; integer account ids come back as digit strings and would
    falsely convict every stored read against the int-keyed model."""
    v = op.get("value")
    if op.get("f") in ("read", "partial-read") and isinstance(v, dict):
        return {**op, "value": int_keyed(v)}
    return op


class TransferChecker(Checker):
    """Linearizability against the Accounts model via the shared WGL
    oracle (transfer.clj's knossos check)."""

    def __init__(self, accounts: list, starting_balance: int):
        self.init = {a: starting_balance for a in accounts}

    def name(self):
        return "transfer"

    def check(self, test, history, opts):
        from jepsen_tpu_torch.checker.linear_cpu import wgl
        client_ops = [_norm_op(op) for op in history
                      if isinstance(op.get("process"), int)]
        res = wgl(client_ops, Accounts(self.init))
        out = {"valid?": res.valid if res.valid == "unknown"
               else bool(res.valid),
               "op-count": len(client_ops),
               "algorithm": res.algorithm}
        if res.valid is False:
            out["failed-op-index"] = res.failed_op_index
            out["final-configs"] = res.final_configs
        return out


def generator(accounts: list, max_transfer: int = MAX_TRANSFER):
    def transfer(test, ctx):
        frm = ctx.rng.choice(accounts)
        to = ctx.rng.choice([a for a in accounts if a != frm] or [frm])
        return {"f": "transfer",
                "value": {"from": frm, "to": to,
                          "amount": ctx.rng.randint(1, max_transfer)}}

    return gen.mix([
        gen.Fn(lambda test, ctx: {"f": "read", "value": None}),
        gen.Fn(lambda test, ctx: {"f": "partial-read", "value": None}),
        gen.Fn(transfer),
    ])


def workload(test: dict | None = None,
             n_accounts: int = DEFAULT_ACCOUNTS,
             starting_balance: int = DEFAULT_BALANCE, **_) -> dict:
    accounts = list(range(n_accounts))
    return {
        "transfer": True,
        "transfer_accounts": accounts,
        "starting_balance": starting_balance,
        "generator": generator(accounts),
        "checker": TransferChecker(accounts, starting_balance),
    }
