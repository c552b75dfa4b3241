"""The pluggable remote-execution transport (the port of
jepsen_tpu/control/core.py, after jepsen/src/jepsen/control/core.clj).

``Remote`` is the abstraction every transport implements
(control/core.clj:7-58): connect/disconnect/execute/upload/download.
Shell-escaping helpers mirror lit/escape/env/wrap-sudo (:60-153).
"""
from __future__ import annotations

import shlex
from dataclasses import dataclass, field
from typing import Any, Sequence

# copied from jepsen_tpu/control/core.py:15-124


class RemoteError(Exception):
    def __init__(self, msg, cmd=None, exit_status=None, out="", err="", host=None):
        super().__init__(msg)
        self.cmd = cmd
        self.exit_status = exit_status
        self.out = out
        self.err = err
        self.host = host

    def __repr__(self):
        return (f"RemoteError(host={self.host!r}, cmd={self.cmd!r}, "
                f"exit={self.exit_status!r}, err={self.err[:200]!r})")


@dataclass
class Result:
    cmd: str
    exit_status: int
    out: str
    err: str
    host: str | None = None


class Lit:
    """An unescaped literal shell fragment (control/core.clj lit)."""

    __slots__ = ("s",)

    def __init__(self, s: str):
        self.s = s

    def __str__(self):
        return self.s


def lit(s: str) -> Lit:
    return Lit(s)


def escape(arg: Any) -> str:
    """Shell-escapes one argument; Lit passes through
    (control/core.clj:67-110)."""
    if isinstance(arg, Lit):
        return arg.s
    if isinstance(arg, (list, tuple)):
        return " ".join(escape(a) for a in arg)
    s = str(arg)
    if s == "":
        return "''"
    return shlex.quote(s)


def join_cmd(args: Sequence[Any]) -> str:
    return " ".join(escape(a) for a in args)


def env(env_map: dict) -> Lit:
    """Renders an env-var prefix: env({'A': 1}) -> A=1
    (control/core.clj:112-140)."""
    return lit(" ".join(f"{k}={escape(v)}" for k, v in env_map.items()))


def wrap_sudo(ctx: dict, cmd: str) -> str:
    """Wraps a command in sudo -u / -S as per context
    (control/core.clj:142-153)."""
    sudo = ctx.get("sudo")
    if not sudo:
        return cmd
    user = "" if sudo is True else f"-u {escape(sudo)} "
    return f"sudo {user}-S -- sh -c {escape(cmd)}"


def wrap_cd(ctx: dict, cmd: str) -> str:
    d = ctx.get("dir")
    if d:
        return f"cd {escape(d)} && {cmd}"
    return cmd


class Remote:
    """Transport protocol (control/core.clj:7-58)."""

    def connect(self, conn_spec: dict) -> "Remote":
        """Returns a connected copy of this remote."""
        return self

    def disconnect(self) -> None:
        pass

    def execute(self, ctx: dict, cmd: str) -> Result:
        """Runs a shell command, returning a Result. ctx carries sudo/dir."""
        raise NotImplementedError

    def upload(self, ctx: dict, local_paths, remote_path) -> None:
        raise NotImplementedError

    def download(self, ctx: dict, remote_paths, local_path) -> None:
        raise NotImplementedError


def throw_on_nonzero_exit(res: Result) -> Result:
    """(control/core.clj:155-171)"""
    if res.exit_status != 0:
        raise RemoteError(
            f"command {res.cmd!r} on {res.host} exited {res.exit_status}: "
            f"{res.err[:500]}",
            cmd=res.cmd, exit_status=res.exit_status, out=res.out,
            err=res.err, host=res.host,
        )
    return res
