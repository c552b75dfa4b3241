"""Builds the Hopper kernels in ``csrc/`` and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, named by a hash of its source
and flags, under ``jepsen_tpu_torch/_build/``. All sources compile in
parallel (one ``nvcc`` each, all started together) at first use; a
library already built from the same source is reused. A build failure
raises with the compiler's output.

Every C entry takes its pointers and the CUDA stream as ``void*``,
enqueues its launches without synchronising, and returns the first
non-zero ``cudaGetLastError()`` of its launches (0 when all were taken).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the entries, by library
SIGNATURES = {
    "chunk_product": ("jt_chunk_product",
                      [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "chunk_combine": ("jt_chunk_combine",
                      [_P, _P, _P, _P, _I, _I, _I, _P]),
    "cluster_screen": ("jt_cluster_screen",
                       [_P, _P, _P, _P, _P, _I, _I, _P]),
    "frontier_dense": ("jt_frontier_dense",
                       [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "frontier_sparse": ("jt_frontier_sparse",
                        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _P]),
    "scc_trim": ("jt_scc_trim", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
}

_LOCK = threading.Lock()
_LIBS: dict = {}
# wall seconds of this process's builds and the compiler's resource
# report (-Xptxas -v) per source, for chip_smoke.py
build_seconds = 0.0
ptxas_report: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the kernels")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compiles every ``csrc/*.cu`` whose library is missing, all in
    parallel, and loads every library. Returns {name: ctypes.CDLL}."""
    global build_seconds
    with _LOCK:
        if _LIBS:
            return dict(_LIBS)
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        srcs = sorted(SRC_DIR.glob("*.cu"))
        jobs = []
        for src in srcs:
            out = _lib_path(src)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((src, out, tmp, proc))
        failed = []
        for src, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            ptxas_report[src.stem] = log
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for src in srcs:
            lib = ctypes.CDLL(str(_lib_path(src)))
            fn_name, argtypes = SIGNATURES[src.stem]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _LIBS[src.stem] = lib
        build_seconds += time.perf_counter() - t0
        return dict(_LIBS)


def library(name: str):
    """The loaded library built from ``csrc/<name>.cu``."""
    return build_all()[name]
