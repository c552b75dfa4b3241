"""What the scripts that time this checkout's kernels against another
checkout's share (``frontier_compare``, ``set_compare``,
``forensics_compare``; ``elle_compare`` takes :func:`build` too): the
build of both checkouts' sources, the call of each build in turns, the
profiler's device time of a launch, and the card's line.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path

TURNS = ("other", "this", "this", "other")


def build(roots: dict, out_dir: Path, names,
          signatures: dict | None = None) -> dict:
    """{(label, name): C entry} of the kernels ``names`` from each root's
    csrc, all compiled at once. ``signatures`` may give a (label, name)
    another (entry name, argtypes) than ``_build.SIGNATURES``: an earlier
    build's C signature. Each entry's library path is its ``lib_path``,
    the compiler's resource lines its ``ptxas``."""
    from jepsen_tpu_torch.ops import _build
    jobs = []
    for label, root in roots.items():
        for name in names:
            src = Path(root) / "jepsen_tpu_torch" / "ops" / "csrc" / \
                f"{name}.cu"
            lib = out_dir / f"lib{name}_{label}.so"
            jobs.append((label, name, lib, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                 str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    entries = {}
    for label, name, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {label} {name}:\n{log}")
        fn_name, argtypes = (signatures or {}).get(
            (label, name), _build.SIGNATURES[name])
        fn = getattr(ctypes.CDLL(str(lib)), fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fn.lib_path = lib
        fn.ptxas = [ln.strip() for ln in log.splitlines()
                    if re.search(r"Compiling entry|Used \d+ registers|"
                                 r"spill", ln)]
        entries[label, name] = fn
    return entries


def in_turns(call, labels, reps: int) -> dict:
    """{label: [ms, ms]}: ``call(label)`` timed by CUDA events over
    ``reps`` back-to-back calls, each after one warm-up call, in the
    order other, this, this, other (a label missing from ``labels`` is
    skipped)."""
    import torch
    times = {label: [] for label in labels}
    for label in TURNS:
        if label not in times:
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        call(label)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            call(label)
        end.record()
        torch.cuda.synchronize()
        times[label].append(start.elapsed_time(end) / reps)
    return times


def device_ms(fn, names, calls: int = 5):
    """The median over ``calls`` calls of ``fn()`` of the summed device
    time of each call's kernel launches whose name holds one of
    ``names`` (a string or a tuple of them), from ``torch.profiler``
    (taken again, up to three times, when a trace lacks some); None
    without them. Each call must launch each named kernel once."""
    import statistics
    import torch
    from torch.profiler import ProfilerActivity, profile
    names = (names,) if isinstance(names, str) else tuple(names)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and any(n in e.name for n in names)),
                     key=lambda e: e.time_range.start)
        if len(evs) == calls * len(names):
            us = [sum(e.time_range.end - e.time_range.start
                      for e in evs[i:i + len(names)])
                  for i in range(0, len(evs), len(names))]
            return statistics.median(us) / 1e3
    return None


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
