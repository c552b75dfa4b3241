"""Database automation protocols (the port of jepsen_tpu/db.py, after
jepsen/src/jepsen/db.clj). ``TcpdumpDB`` waits with the real remotes.

A DB sets up and tears down the system under test on each node. Optional
capability mixins mirror the reference's protocols: Process (db.clj:18-24),
Pause (:26-29), Primary (:31-38), LogFiles (:40-41). ``cycle`` runs
teardown -> setup across nodes with retries (db.clj:117-158).
"""
from __future__ import annotations

import logging
from typing import Iterable

logger = logging.getLogger("jepsen_tpu_torch.db")

# copied from jepsen_tpu/db.py:15-66, :118-178 (without TcpdumpDB)

CYCLE_TRIES = 3  # db.clj:117-119


class SetupFailed(Exception):
    """DB setup failed; the whole cycle should be retried."""


class DB:
    def setup(self, test: dict, node: str) -> None:
        """Installs and starts the DB on node."""

    def teardown(self, test: dict, node: str) -> None:
        """Removes the DB from node, including logs and data."""


class Process:
    """Start/kill the DB process abruptly (db.clj:18-24)."""

    def start(self, test: dict, node: str):
        raise NotImplementedError

    def kill(self, test: dict, node: str):
        raise NotImplementedError


class Pause:
    """SIGSTOP/SIGCONT-style pause (db.clj:26-29)."""

    def pause(self, test: dict, node: str):
        raise NotImplementedError

    def resume(self, test: dict, node: str):
        raise NotImplementedError


class Primary:
    """Single-primary systems (db.clj:31-38)."""

    def primaries(self, test: dict) -> list[str]:
        raise NotImplementedError

    def setup_primary(self, test: dict, node: str) -> None:
        """Called on (first nodes) after every node's setup."""


class LogFiles:
    """Paths of log files to download from nodes (db.clj:40-41)."""

    def log_files(self, test: dict, node: str) -> list[str]:
        return []


class NoopDB(DB, LogFiles):
    """A database that does nothing (jepsen.db/noop)."""


def cycle(test: dict, db: DB) -> None:
    """teardown! then setup! across all nodes in parallel (with control
    sessions bound, as the reference's on-nodes does), retried up to
    CYCLE_TRIES times on SetupFailed (db.clj:121-158, core.clj with-db).
    Suites synchronize between phases via core.synchronize."""
    from jepsen_tpu_torch import control
    nodes: Iterable[str] = test.get("nodes") or []
    for attempt in range(1, CYCLE_TRIES + 1):
        # a failed attempt may leave the setup barrier broken (Python
        # breaks a Barrier permanently on timeout/abort) — reset it so the
        # retry can actually synchronize
        barrier = test.get("barrier")
        if barrier is not None:
            barrier.reset()
        try:
            control.on_nodes(test, lambda n: db.teardown(test, n))
            control.on_nodes(test, lambda n: db.setup(test, n))
            if isinstance(db, Primary) and nodes:
                first = list(nodes)[0]
                control.on(first, test,
                           lambda: db.setup_primary(test, first))
            return
        except SetupFailed as e:
            if attempt == CYCLE_TRIES:
                raise
            logger.warning("DB setup failed (%r); retrying cycle (%d/%d)",
                           e, attempt, CYCLE_TRIES)


def teardown_all(test: dict, db: DB) -> None:
    from jepsen_tpu_torch import control
    control.on_nodes(test, lambda n: db.teardown(test, n))
