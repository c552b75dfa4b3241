"""Dummy remote: executes nothing, records everything (the port of
jepsen_tpu/control/dummy.py).

The reference's `:ssh {:dummy? true}` (control.clj:40, cli.clj:230
``--no-ssh``) lets the full run lifecycle execute with in-memory doubles —
the backbone of cluster-free integration tests (SURVEY.md §4 tier 2).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field

from jepsen_tpu_torch.control.core import Remote, Result


# copied from jepsen_tpu/control/dummy.py:15-35
@dataclass
class DummyRemote(Remote):
    host: str | None = None
    log: list = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def connect(self, conn_spec: dict) -> "DummyRemote":
        return DummyRemote(host=conn_spec.get("host"), log=self.log, _lock=self._lock)

    def execute(self, ctx: dict, cmd: str) -> Result:
        with self._lock:
            self.log.append(("exec", self.host, cmd))
        return Result(cmd=cmd, exit_status=0, out="", err="", host=self.host)

    def upload(self, ctx, local_paths, remote_path) -> None:
        with self._lock:
            self.log.append(("upload", self.host, local_paths, remote_path))

    def download(self, ctx, remote_paths, local_path) -> None:
        with self._lock:
            self.log.append(("download", self.host, remote_paths, local_path))
