"""Network manipulation (the port of jepsen_tpu/net.py; reference:
jepsen/src/jepsen/net.clj + net/proto.clj + control/net.clj).

The Net protocol cuts/heals/degrades links between db nodes — it breaks the
*system under test's* network, not the control plane. The port has the
protocol and ``NoopNet``, which a dummy-remote run uses; ``IPTables`` and
``IPFilter`` wait with the real remotes.
"""
from __future__ import annotations

import logging

logger = logging.getLogger("jepsen_tpu_torch.net")

# copied from jepsen_tpu/net.py:21-61


class Net:
    """net/proto.clj:5-12"""

    def drop(self, test: dict, src: str, dest: str) -> None:
        """Cuts the link src -> dest."""
        raise NotImplementedError

    def heal(self, test: dict) -> None:
        raise NotImplementedError

    def slow(self, test: dict, mean_ms: float = 50, variance_ms: float = 10) -> None:
        raise NotImplementedError

    def flaky(self, test: dict) -> None:
        raise NotImplementedError

    def fast(self, test: dict) -> None:
        raise NotImplementedError

    # PartitionAll extension (net.clj:101-111): apply a whole grudge at once
    def drop_all(self, test: dict, grudge: dict) -> None:
        """grudge: {node: iterable-of-nodes-to-snub}. Default: per-link."""
        for node, snubbed in grudge.items():
            for other in snubbed:
                self.drop(test, other, node)


def resolve_ip(test: dict, node: str) -> str:
    """Resolves a node name to an IP on the control node or via getent on
    the node itself (control/net.clj:19-40). Cached on the test map."""
    cache = test.setdefault("_ip_cache", {})
    if node in cache:
        return cache[node]
    import socket
    try:
        ip = socket.gethostbyname(node)
    except OSError:
        ip = node
    cache[node] = ip
    return ip


# copied from jepsen_tpu/net.py:152-172
class NoopNet(Net):
    """For dummy-remote runs: records grudges on the test map."""

    def drop(self, test, src, dest):
        test.setdefault("_net_log", []).append(("drop", src, dest))

    def drop_all(self, test, grudge):
        test.setdefault("_net_log", []).append(("drop-all", grudge))

    def heal(self, test):
        test.setdefault("_net_log", []).append(("heal",))

    def slow(self, test, mean_ms=50, variance_ms=10):
        test.setdefault("_net_log", []).append(("slow",))

    def flaky(self, test):
        test.setdefault("_net_log", []).append(("flaky",))

    def fast(self, test):
        test.setdefault("_net_log", []).append(("fast",))

