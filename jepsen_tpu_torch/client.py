"""DB client protocol (the port of jepsen_tpu/client.py, after
jepsen/src/jepsen/client.clj).

A Client runs operations against the system under test. Lifecycle:
``open`` (fresh connection for a process) -> ``setup`` (once) ->
``invoke`` per op -> ``teardown`` -> ``close`` (client.clj:9-34).
Clients marked ``reusable`` survive process crashes without reopening
(client.clj:29-44, used by the interpreter at interpreter.clj:33-67).
"""
from __future__ import annotations

import contextlib
from typing import Any

# copied from jepsen_tpu/client.py:15-126


class Client:
    reusable = False

    def open(self, test: dict, node: str) -> "Client":
        """Returns a client bound to a connection against node. Called once
        per process; must be re-entrant on fresh instances."""
        return self

    def setup(self, test: dict) -> None:
        """One-time database setup through this client."""

    def invoke(self, test: dict, op: dict) -> dict:
        """Applies op, returning its completion (type ok/fail/info).

        Deadline contract (doc/robustness.md): the interpreter bounds
        every invoke with a per-op deadline (``op['timeout_s']`` →
        ``test['op_timeout_s']`` → the interpreter's default). An
        invoke that outlives its deadline has an indeterminate ``info``
        completion synthesized for it and its worker replaced; whatever
        this method eventually returns is quarantined to the run's
        ``late.jsonl`` — never appended to history — and ``close`` is
        then called from this client's own (zombie) worker thread, never
        concurrently with a still-running invoke. The replacement worker
        calls ``open`` for a FRESH client while the hung invoke may
        still be blocked: ``open`` must hand out independently usable
        connections (its documented contract above); a client whose
        ``open`` returns a shared object must tolerate a concurrent
        invoke on it."""
        raise NotImplementedError

    def teardown(self, test: dict) -> None:
        """One-time cleanup."""

    def close(self, test: dict) -> None:
        """Releases this client's connection."""

    def supported_fs(self, test: dict) -> set | None:
        """The op ``:f`` surface this client implements, or None when
        unknown/unbounded. Preflight (the reference's analysis.preflight)
        checks every generator-emitted ``:f`` against this set BEFORE
        the run touches a node — a declared surface turns the classic
        history-full-of-``unknown-f`` misconfiguration into an instant
        structured diagnostic. Returning None skips the check (never
        guesses)."""
        return None


class NoopClient(Client):
    """Accepts every op (jepsen.client/noop)."""

    reusable = True

    def invoke(self, test, op):
        return {**op, "type": "ok"}


class Validate(Client):
    """Wraps a client, checking completions are well-formed
    (client.clj:64-114)."""

    def __init__(self, client: Client):
        self.client = client
        self.reusable = client.reusable

    def open(self, test, node):
        opened = self.client.open(test, node)
        if opened is None:
            raise ValueError(f"{self.client!r}.open returned None")
        v = Validate(opened)
        return v

    def setup(self, test):
        self.client.setup(test)

    def invoke(self, test, op):
        completion = self.client.invoke(test, op)
        problems = []
        if not isinstance(completion, dict):
            raise ValueError(f"client completion {completion!r} is not an op")
        if completion.get("type") not in ("ok", "fail", "info"):
            problems.append(f"bad type {completion.get('type')!r}")
        if completion.get("process") != op.get("process"):
            problems.append("completion process differs from invocation")
        if completion.get("f") != op.get("f"):
            problems.append("completion f differs from invocation")
        if problems:
            raise ValueError(f"invalid completion {completion!r} for {op!r}: {problems}")
        return completion

    def teardown(self, test):
        self.client.teardown(test)

    def close(self, test):
        self.client.close(test)


def validate(client: Client) -> Client:
    return Validate(client)


@contextlib.contextmanager
def with_client(client: Client, test: dict, node: str):
    """open -> yield -> close (client.clj:116-126)."""
    c = client.open(test, node)
    try:
        yield c
    finally:
        c.close(test)


def is_client(x: Any) -> bool:
    return isinstance(x, Client)
