"""The native C++ search (``wgl.cpp``): the checker's ``native-c`` rung and
the CPU lane of the key-batched check.

``wgl.cpp`` compiles with ``g++`` at first use into a shared library
under ``jepsen_tpu_torch/_build/``, named by a hash of its source and
flags, and loads with ctypes; a library already built from the same
source is reused. A build that fails raises with the compiler's output.
ctypes releases the GIL for the call, so keys searched on threads run
in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "wgl.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB = None


def _so_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libwgl-{h.hexdigest()[:16]}.so"


# copied from jepsen_tpu/native/__init__.py:44-65, without the sanitizer
# variant and the build-directory variable, and without -march=native: a
# library built on one host stays loadable on another
def build() -> Path:
    """Compiles wgl.cpp unless its library exists; returns its path.
    Raises with the compiler's output when g++ fails."""
    so = _so_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    # a per-process name: concurrent builds publish atomically
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib_ = ctypes.CDLL(str(build()))
            lib_.wgl_check.restype = ctypes.c_int
            lib_.wgl_check.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int64, ctypes.c_void_p,
            ]
            _LIB = lib_
        return _LIB


# copied from jepsen_tpu/native/__init__.py:120-156
def check_stream_native(stream, init_state: int = 0,
                        max_configs: int = 20_000_000):
    """Runs the C++ search over an EventStream. Returns a LinearResult
    (``"unknown"`` when more than ``max_configs`` configurations were
    live: the search's capacity), or None when the search does not take
    the stream (more than 63 slots). Either way the caller hands the
    stream to ``check_stream``."""
    from jepsen_tpu_torch.checker.linear_cpu import LinearResult

    cols = [np.ascontiguousarray(stream.kind, dtype=np.int8)] + [
        np.ascontiguousarray(x, dtype=np.int32)
        for x in (stream.slot, stream.f, stream.a, stream.b)]
    stats = np.zeros(3, np.int64)
    rc = lib().wgl_check(*(c.ctypes.data for c in cols), len(cols[0]),
                         init_state, 0, max_configs, stats.ctypes.data)
    died, peak = int(stats[0]), int(stats[1])
    if rc == -2:
        return None
    if rc == -1:
        return LinearResult(valid="unknown", configs_max=peak,
                            algorithm="jitlin-native")
    return LinearResult(
        valid=rc == 1,
        failed_event=died,
        failed_op_index=int(stream.op_index[died]) if died >= 0 else -1,
        configs_max=peak,
        algorithm="jitlin-native",
    )
