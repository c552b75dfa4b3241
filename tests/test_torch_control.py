"""The port's shell DSL and grudge math against the JAX package's: one
table of cases, each computed by both packages from the same inputs (and,
for a random grudge, the same seeded ``random.Random``), equal."""
from __future__ import annotations

import random

import pytest

import jepsen_tpu.control.core as jcc
import jepsen_tpu.nemesis as jnem
import jepsen_tpu.nemesis.combined as jcomb
import jepsen_tpu_torch.control.core as tcc
import jepsen_tpu_torch.nemesis as tnem
import jepsen_tpu_torch.nemesis.combined as tcomb

NODES = ["n1", "n2", "n3", "n4", "n5"]
SEVEN = [f"n{i}" for i in range(1, 8)]


def _norm(x):
    """Grudge sets as sorted lists, so both packages' maps compare."""
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (set, frozenset)):
        return sorted(x)
    if isinstance(x, tuple):
        return [_norm(v) for v in x]
    return x


def _grudge_for(m, spec, nodes):
    comb = m["comb"]
    return comb.grudge_for({"nodes": nodes}, None, spec,
                           rng=random.Random(7))


CASES = {
    "escape-plain": lambda m: m["cc"].escape("ls"),
    "escape-space": lambda m: m["cc"].escape("a b"),
    "escape-quote": lambda m: m["cc"].escape("it's"),
    "escape-empty": lambda m: m["cc"].escape(""),
    "escape-int": lambda m: m["cc"].escape(42),
    "escape-list": lambda m: m["cc"].escape(["a", "b c", m["cc"].lit("$X")]),
    "escape-lit": lambda m: m["cc"].escape(m["cc"].lit("a && b")),
    "lit": lambda m: str(m["cc"].lit("x > y")),
    "join-cmd": lambda m: m["cc"].join_cmd(["echo", "a b", 3,
                                            m["cc"].lit("|"), "wc"]),
    "env": lambda m: str(m["cc"].env({"A": 1, "B": "x y", "C": ""})),
    "wrap-sudo-off": lambda m: m["cc"].wrap_sudo({}, "id"),
    "wrap-sudo-root": lambda m: m["cc"].wrap_sudo({"sudo": True}, "id -u"),
    "wrap-sudo-user": lambda m: m["cc"].wrap_sudo({"sudo": "jepsen"},
                                                  "echo 'hi'"),
    "wrap-cd-off": lambda m: m["cc"].wrap_cd({}, "ls"),
    "wrap-cd": lambda m: m["cc"].wrap_cd({"dir": "/tmp/a b"}, "ls"),
    "bisect": lambda m: m["nem"].bisect(NODES),
    "split-one": lambda m: m["nem"].split_one(NODES, random.Random(3)),
    "complete-grudge": lambda m: m["nem"].complete_grudge(
        [["n1", "n2"], ["n3"], ["n4", "n5"]]),
    "invert-grudge": lambda m: m["nem"].invert_grudge(
        m["nem"].complete_grudge([["n1"], ["n2", "n3", "n4", "n5"]])),
    "bridge": lambda m: m["nem"].bridge(NODES),
    "ring-perfect-5": lambda m: m["nem"].majorities_ring_perfect(NODES),
    "ring-perfect-7": lambda m: m["nem"].majorities_ring_perfect(SEVEN),
    "ring-stochastic": lambda m: m["nem"].majorities_ring_stochastic(
        SEVEN, rng=random.Random(5)),
    "halves": lambda m: m["nem"].partition_halves_grudge(NODES),
    "random-halves": lambda m: m["nem"].partition_random_halves_grudge(
        NODES, rng=random.Random(9)),
    "random-node": lambda m: m["nem"].partition_random_node_grudge(
        NODES, rng=random.Random(9)),
    "grudge-for-one": lambda m: _grudge_for(m, "one", NODES),
    "grudge-for-majority": lambda m: _grudge_for(m, "majority", NODES),
    "grudge-for-third": lambda m: _grudge_for(m, "minority-third", SEVEN),
    "grudge-for-ring": lambda m: _grudge_for(m, "majorities-ring", SEVEN),
    "grudge-for-random": lambda m: _grudge_for(m, None, NODES),
    "db-nodes": lambda m: [m["comb"].db_nodes(
        {"nodes": NODES}, None, spec, rng=random.Random(4))
        for spec in ("one", "minority", "majority", "minority-third", "all",
                     None, ["n2", "n4"])],
}

JAX = {"cc": jcc, "nem": jnem, "comb": jcomb}
PORT = {"cc": tcc, "nem": tnem, "comb": tcomb}


@pytest.mark.parametrize("case", sorted(CASES))
def test_control_and_grudges_equal_reference(case):
    assert _norm(CASES[case](PORT)) == _norm(CASES[case](JAX))


@pytest.mark.parametrize("exit_status", [0, 3])
def test_nonzero_exit_raises_like_reference(exit_status):
    for cc in (jcc, tcc):
        res = cc.Result(cmd="false", exit_status=exit_status, out="o",
                        err="e", host="n1")
        if exit_status == 0:
            assert cc.throw_on_nonzero_exit(res) is res
        else:
            with pytest.raises(cc.RemoteError) as e:
                cc.throw_on_nonzero_exit(res)
            assert (e.value.exit_status, e.value.host) == (3, "n1")
