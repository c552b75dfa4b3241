"""The C columnar parser (``columnar_ext.c``) as an extension module.

``columnar_ext.c`` walks PyObject histories through the CPython C API, so
it loads as a real extension module through importlib, not with ctypes.
It compiles with ``g++`` at first use into ``jepsen_tpu_torch/_build/``,
named by a hash of its source and flags; a module already built from the
same source is reused. A build that fails raises with the compiler's
output: the caller never gets None for a missing toolchain.
"""
from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent / "columnar_ext.c"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
#: the name the source's PyInit exports (PyInit__columnar_c_torch)
MODULE_NAME = "_columnar_c_torch"

_LOCK = threading.Lock()
_MOD = None


def _so_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"{MODULE_NAME}-{h.hexdigest()[:16]}.so"


# copied from jepsen_tpu/native/columnar_c.py:60-80, without the sanitizer
# variant and the build-directory variable, and without -march=native: a
# module built on one host stays loadable on another
def build() -> Path:
    """Compiles columnar_ext.c unless its module exists; returns its path.
    Raises with the compiler's output when g++ fails."""
    so = _so_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    # a per-process name: concurrent builds publish atomically
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    inc = sysconfig.get_paths()["include"]
    proc = subprocess.run(["g++", *GXX_FLAGS, f"-I{inc}", "-o", str(tmp),
                           str(SRC)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


# copied from jepsen_tpu/native/columnar_c.py:126-132
def _load(so: Path):
    loader = importlib.machinery.ExtensionFileLoader(MODULE_NAME, str(so))
    spec = importlib.util.spec_from_file_location(MODULE_NAME, str(so),
                                                 loader=loader)
    m = importlib.util.module_from_spec(spec)
    loader.exec_module(m)
    return m


def mod():
    """The loaded extension module, built at first use."""
    global _MOD
    with _LOCK:
        if _MOD is None:
            _MOD = _load(build())
        return _MOD
