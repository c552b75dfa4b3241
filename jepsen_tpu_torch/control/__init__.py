"""Control facade: scoped remote-execution state + the shell DSL (the
port of jepsen_tpu/control/__init__.py).

Reference: jepsen/src/jepsen/control.clj. The reference scopes connection
state in dynamic vars (*host* *session* *dir* *sudo*..., control.clj:39-53);
here a contextvar holds a per-thread/task ``Ctl`` record, so ``exec_``,
``upload``, ``cd``, ``su`` read ambient state exactly like the reference's
facade (:138-189, :203-224). ``on_nodes`` fans out over per-node cached
sessions with real_pmap (:295-311).
"""
from __future__ import annotations

import contextlib
import contextvars
import logging
import threading
from typing import Any, Callable, Iterable

from jepsen_tpu_torch.control.core import (
    Lit, Remote, RemoteError, Result, env, escape, join_cmd, lit,
    throw_on_nonzero_exit,
)
from jepsen_tpu_torch.control.dummy import DummyRemote

logger = logging.getLogger("jepsen_tpu_torch.control")

# copied from jepsen_tpu/control/__init__.py:28-224, with default_remote
# serving the dummy remote and an explicit test["remote"] only

_ctl: contextvars.ContextVar[dict | None] = contextvars.ContextVar("jepsen_ctl", default=None)


def _current() -> dict:
    c = _ctl.get()
    if c is None:
        raise RuntimeError("no control session bound; use with_session/on")
    return c


def conn_spec(test: dict, host: str) -> dict:
    """Builds a connection spec from test['ssh'] options
    (control.clj:55-70)."""
    ssh = dict(test.get("ssh") or {})
    return {
        "host": host,
        "username": ssh.get("username", "root"),
        "password": ssh.get("password"),
        "port": ssh.get("port"),
        "private_key_path": ssh.get("private_key_path"),
        "strict_host_key_checking": ssh.get("strict_host_key_checking", False),
        "dummy": ssh.get("dummy", False),
    }


def default_remote(test: dict) -> Remote:
    """Chooses the transport for a test: the dummy remote, or an explicit
    test['remote'] (control.clj:35-37). The SSH, scp, docker and k8s
    transports are not ported yet: a test map that needs one raises."""
    ssh = test.get("ssh") or {}
    if ssh.get("dummy"):
        return test.setdefault("_dummy_remote", DummyRemote())
    if test.get("remote") is not None:
        return test["remote"]
    raise NotImplementedError(
        "the port has only the dummy remote (ssh: {'dummy': True}) or an "
        "explicit test['remote']; the SSH, scp, docker and k8s remotes "
        "wait with ROADMAP Queue 1 item 11")


@contextlib.contextmanager
def with_session(host: str, session: Remote, test: dict | None = None):
    """Binds a connected session for the dynamic extent of the block
    (control.clj:236-262)."""
    token = _ctl.set({
        "host": host,
        "session": session,
        "dir": "/",
        "sudo": None,
        "trace": False,
        "test": test,
    })
    try:
        yield session
    finally:
        _ctl.reset(token)


def session_for(test: dict, node: str) -> Remote:
    """Connects (or returns a cached) session for node, cached on the test
    map (core.clj with-resources / control.clj:295-311 session caching)."""
    sessions = test.setdefault("_sessions", {})
    lock = test.setdefault("_sessions_lock", threading.Lock())
    with lock:
        s = sessions.get(node)
    if s is not None:
        return s
    remote = default_remote(test)
    s = remote.connect(conn_spec(test, node))
    with lock:
        sessions[node] = s
    return s


def disconnect_all(test: dict) -> None:
    for node, s in list((test.get("_sessions") or {}).items()):
        try:
            s.disconnect()
        except Exception:  # noqa: BLE001
            logger.exception("error disconnecting %s", node)
    test["_sessions"] = {}


# -- the shell DSL ---------------------------------------------------------

def exec_(*args, stdin: str | None = None) -> str:  # blocking: rpc
    """Runs a shell command on the current session, returning trimmed
    stdout; raises RemoteError on nonzero exit (control.clj:138-157).
    Annotated ``# blocking: rpc``: the lock-order rule flags any call
    that reaches this while holding a lock — a remote exec (bounded,
    but up to the transport timeout) must never run under one."""
    c = _current()
    cmd = join_cmd(args)
    ctx = {"dir": c["dir"], "sudo": c["sudo"], "stdin": stdin}
    if c.get("trace"):
        logger.info("[%s] %s", c["host"], cmd)
    res = c["session"].execute(ctx, cmd)
    throw_on_nonzero_exit(res)
    return res.out.strip()


def exec_star(*args, stdin: str | None = None) -> Result:  # blocking: rpc
    """Like exec_ but returns the full Result without raising."""
    c = _current()
    cmd = join_cmd(args)
    ctx = {"dir": c["dir"], "sudo": c["sudo"], "stdin": stdin}
    return c["session"].execute(ctx, cmd)


def upload(local_paths, remote_path) -> None:
    c = _current()
    c["session"].upload({"sudo": c["sudo"]}, local_paths, remote_path)


def download(remote_paths, local_path) -> None:
    c = _current()
    c["session"].download({"sudo": c["sudo"]}, remote_paths, local_path)


@contextlib.contextmanager
def cd(dir: str):
    c = _current()
    old = c["dir"]
    c["dir"] = dir
    try:
        yield
    finally:
        c["dir"] = old


@contextlib.contextmanager
def su(user: Any = True):
    """Sudo as root (or user) within the block (control.clj:203-218)."""
    c = _current()
    old = c["sudo"]
    c["sudo"] = user
    try:
        yield
    finally:
        c["sudo"] = old


sudo = su


@contextlib.contextmanager
def trace():
    c = _current()
    old = c["trace"]
    c["trace"] = True
    try:
        yield
    finally:
        c["trace"] = old


def current_host():
    return _current()["host"]


def on(node: str, test: dict, fn: Callable[[], Any]) -> Any:
    """Runs fn with a session bound to node (control.clj:272-281)."""
    session = session_for(test, node)
    with with_session(node, session, test):
        return fn()


def on_nodes(test: dict, fn: Callable[[str], Any],
             nodes: Iterable[str] | None = None) -> dict:
    """Runs (fn node) on each node in parallel; returns {node: result}
    (control.clj:295-311)."""
    from jepsen_tpu_torch.utils import real_pmap
    nodes = list(nodes if nodes is not None else (test.get("nodes") or []))

    def run_one(node):
        return node, on(node, test, lambda: fn(node))

    return dict(real_pmap(run_one, nodes))


@contextlib.contextmanager
def with_test_nodes(test: dict):
    """Connects sessions for every node; disconnects after
    (control.clj:313-319 + core.clj with-resources)."""
    try:
        from jepsen_tpu_torch.utils import real_pmap
        real_pmap(lambda n: session_for(test, n), list(test.get("nodes") or []))
        yield
    finally:
        disconnect_all(test)
