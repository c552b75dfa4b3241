"""The C columnar parser (``columnar_ext.c``) as an extension module.

``columnar_ext.c`` walks PyObject histories through the CPython C API, so
it loads as a real extension module through importlib, not with ctypes.
It compiles with ``g++`` at first use into ``jepsen_tpu_torch/_build/``,
named by a hash of its source and flags; a module already built from the
same source is reused. A build that fails raises with the compiler's
output: the caller never gets None for a missing toolchain.
:func:`configure` sets the build directory and the ASan+UBSan variant,
as ``native.configure`` does for ``wgl.cpp``.
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

# copied from jepsen_tpu/native/columnar_c.py:41-43
SAN_FLAGS = ("-O1", "-g", "-fno-omit-frame-pointer",
             "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
             "-shared", "-fPIC")

_LOCK = threading.Lock()
_MOD = None
# the variant mod() loads; set by configure()
_SAN = False


def configure(build_dir=None, san: bool = False) -> None:
    """Sets where the module builds (None keeps :data:`BUILD_DIR`) and
    whether :func:`mod` loads the sanitizer variant; the next :func:`mod`
    call loads anew."""
    global BUILD_DIR, _SAN, _MOD
    with _LOCK:
        if build_dir is not None:
            BUILD_DIR = Path(build_dir)
        _SAN = bool(san)
        _MOD = None


def _so_path(san: bool | None = None) -> Path:
    san = _SAN if san is None else san
    flags = SAN_FLAGS if san else GXX_FLAGS
    h = hashlib.sha256(SRC.read_bytes() + " ".join(flags).encode())
    stem = f"{MODULE_NAME}-san" if san else MODULE_NAME
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


# copied from jepsen_tpu/native/columnar_c.py:49-80, with the build
# directory set by configure() and the variant an argument, and without
# -march=native: a module built on one host stays loadable on another
def build(san: bool | None = None) -> Path:
    """Compiles columnar_ext.c unless its module exists; returns its path.
    ``san`` None builds the configured variant. Raises with the
    compiler's output when g++ fails."""
    san = _SAN if san is None else san
    so = _so_path(san)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    # a per-process name: concurrent builds publish atomically
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    inc = sysconfig.get_paths()["include"]
    flags = SAN_FLAGS if san else GXX_FLAGS
    proc = subprocess.run(["g++", *flags, f"-I{inc}", "-o", str(tmp),
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
    """The loaded extension module, built at first use: the sanitizer
    variant when :func:`configure` asked for it."""
    global _MOD
    with _LOCK:
        if _MOD is None:
            if _SAN:
                from jepsen_tpu_torch.native import refuse_unpreloaded_san
                refuse_unpreloaded_san(SRC.name)
            _MOD = _load(build())
        return _MOD
