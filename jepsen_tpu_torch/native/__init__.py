"""The native C++ search (``wgl.cpp``): the checker's ``native-c`` rung and
the CPU lane of the key-batched check.

``wgl.cpp`` compiles with ``g++`` at first use into a shared library
under ``jepsen_tpu_torch/_build/``, named by a hash of its source and
flags, and loads with ctypes; a library already built from the same
source is reused. A build that fails raises with the compiler's output.
ctypes releases the GIL for the call, so keys searched on threads run
in parallel.

:func:`configure` takes the two native knobs as arguments (the reference
reads ``JEPSEN_NATIVE_BUILD_DIR`` and ``JEPSEN_TPU_NATIVE_SAN``): the
build directory, and the ASan+UBSan variant (:data:`SAN_FLAGS`), a
library of its own name that :func:`lib` loads only into a process that
preloads the ASan runtime (:func:`san_env` gives a child's environment)
and refuses to load otherwise. ``columnar_c.configure`` is its twin for
the C columnar module.
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
# copied from jepsen_tpu/native/__init__.py:29-30: the ASan+UBSan build
SAN_FLAGS = ("-O1", "-g", "-fno-omit-frame-pointer",
             "-fsanitize=address,undefined", "-fno-sanitize-recover=all")

_LOCK = threading.Lock()
_LIB = None
# the variant lib() loads; set by configure()
_SAN = False


def configure(build_dir=None, san: bool = False) -> None:
    """Sets where the library builds (None keeps :data:`BUILD_DIR`) and
    whether :func:`lib` loads the sanitizer variant; the next
    :func:`lib` call loads anew."""
    global BUILD_DIR, _SAN, _LIB
    with _LOCK:
        if build_dir is not None:
            BUILD_DIR = Path(build_dir)
        _SAN = bool(san)
        _LIB = None


def _flags(san: bool) -> tuple:
    return (*SAN_FLAGS, "-std=c++17", "-shared", "-fPIC") if san \
        else GXX_FLAGS


def _so_path(san: bool | None = None) -> Path:
    san = _SAN if san is None else san
    h = hashlib.sha256(SRC.read_bytes() + " ".join(_flags(san)).encode())
    stem = "libwgl-san" if san else "libwgl"
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


# copied from jepsen_tpu/native/__init__.py:33-65, with the build
# directory set by configure() and the variant an argument, and without
# -march=native: a library built on one host stays loadable on another
def build(san: bool | None = None) -> Path:
    """Compiles wgl.cpp unless its library exists; returns its path.
    ``san`` None builds the configured variant. Raises with the
    compiler's output when g++ fails."""
    san = _SAN if san is None else san
    so = _so_path(san)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    # a per-process name: concurrent builds publish atomically
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    proc = subprocess.run(["g++", *_flags(san), "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


# copied from jepsen_tpu/native/columnar_c.py:83-93
def asan_mapped() -> bool:
    """True when the ASan runtime is already loaded in THIS process
    (LD_PRELOAD). dlopen'ing a gcc -fsanitize=address .so without it
    doesn't fail politely — libasan calls Die() and takes the whole
    interpreter down, so the check must happen before the attempt."""
    try:
        with open("/proc/self/maps", "rb") as fh:
            return b"libasan" in fh.read()
    except OSError:
        return False


# copied from jepsen_tpu/native/columnar_c.py:96-123, without the
# JEPSEN_TPU_NATIVE_SAN variable: the child calls configure(san=True)
def san_env(base: dict | None = None) -> dict | None:
    """Environment for a child process that can load the sanitizer
    variants: LD_PRELOADs the ASan+UBSan runtimes and sets conservative
    sanitizer options. None when the runtimes can't be resolved.
    detect_leaks is off: interpreter-lifetime allocations dominate any
    exit report; the lane exists for OOB/UAF/UB."""
    libs = []
    for name in ("libasan.so", "libubsan.so"):
        try:
            p = subprocess.run(["g++", f"-print-file-name={name}"],
                               capture_output=True, text=True,
                               check=True).stdout.strip()
        except (OSError, subprocess.CalledProcessError):
            return None
        if not p or "/" not in p:
            return None
        libs.append(p)
    env = dict(base if base is not None else os.environ)
    env["LD_PRELOAD"] = ":".join(
        libs + [x for x in env.get("LD_PRELOAD", "").split(":") if x])
    env["ASAN_OPTIONS"] = env.get(
        "ASAN_OPTIONS", "detect_leaks=0:abort_on_error=1")
    env["UBSAN_OPTIONS"] = env.get(
        "UBSAN_OPTIONS", "halt_on_error=1:print_stacktrace=1")
    return env


def refuse_unpreloaded_san(what: str) -> None:
    """Raises unless the ASan runtime is mapped: a sanitizer build never
    loads into a process that would die on it, and never quietly turns
    into the plain build."""
    if not asan_mapped():
        raise RuntimeError(
            f"refusing to load the sanitizer build of {what}: the ASan "
            "runtime is not preloaded (run it in a child with san_env())")


def lib() -> ctypes.CDLL:
    """The loaded library, built at first use: the sanitizer variant
    when :func:`configure` asked for it."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            if _SAN:
                refuse_unpreloaded_san(SRC.name)
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
