"""A run's first check on this checkout against another's, on one card:
``python3 -m jepsen_tpu_torch.history_ir.check_compare OTHER_ROOT
[REPEATS]``.

The histories are ``chip_smoke.py``'s: the 10k-op register headline
(5 processes, 5 values, seed 42), BASELINE config 3 (64 keys of 1k ops,
lifted) and the 700k-op long history of the headline's shape. They are
made once here and handed to each process in a pickle. For each checkout
in the order other, this, this, other (the whole order REPEATS times,
once by default), a process with the checkout first on its path builds
its kernels and, after one untimed call of each, times the call a user
makes, each on a fresh test map: ``linearizable(accelerator="gpu")
.check({}, h, {})`` on the headline (5 calls) and on the long history
(3), and ``independent.checker(linearizable(accelerator="gpu"))`` on
config 3 (3). Each call ends in a device sync. One JSON line a process
gives every call's seconds, their medians and the verdicts; every
verdict must be valid, from ``torch-matrix`` for the register checks.
A last JSON line gives each checkout's medians over its turns, and the
line after it the card's name and power limit as ``nvidia-smi`` prints
them. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import json
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

THIS_ROOT = Path(__file__).resolve().parents[2]
TURNS = ("other", "this", "this", "other")
N_OPS, N_PROCS, N_VALUES, SEED = 10_000, 5, 5, 42
IND_KEYS, IND_OPS = 64, 1000
LONG_OPS = 700_000
CALLS = {"headline": 5, "config3": 3, "long": 3}


def histories() -> dict:
    from jepsen_tpu_torch.histories import (independent_register_history,
                                            register_history)
    return {
        "headline": register_history(N_OPS, n_procs=N_PROCS, seed=SEED,
                                     n_values=N_VALUES),
        "config3": independent_register_history(IND_KEYS, IND_OPS),
        "long": register_history(LONG_OPS, n_procs=N_PROCS, seed=SEED,
                                 n_values=N_VALUES),
    }


def worker(root: str, job_path: str) -> int:
    """Times the checks with the checkout at ``root``; prints one JSON
    line."""
    sys.path[0] = root
    import torch
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    with open(job_path, "rb") as f:
        hs = pickle.load(f)
    lin = linearizable(accelerator="gpu")
    checkers = {"headline": lin, "config3": independent.checker(lin),
                "long": lin}
    out = {"root": root, "build_s": build_s, "s": {}, "median_s": {}}
    for case, n in CALLS.items():
        chk, h = checkers[case], hs[case]
        times = []
        for i in range(n + 1):
            t0 = time.perf_counter()
            res = chk.check({}, h, {})
            torch.cuda.synchronize()
            if i:
                times.append(time.perf_counter() - t0)
            if res["valid?"] is not True or (
                    case != "config3" and res["algorithm"] != "torch-matrix"):
                raise AssertionError(f"{root} {case}: {res}")
        out["s"][case] = times
        out["median_s"][case] = statistics.median(times)
    print(json.dumps(out), flush=True)
    return 0


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("check_compare: no CUDA device", file=sys.stderr)
        return 1
    other = str(Path(argv[0]).resolve())
    repeats = int(argv[1]) if len(argv) > 1 else 1
    roots = {"other": other, "this": str(THIS_ROOT)}
    medians = {k: {c: [] for c in CALLS} for k in roots}
    with tempfile.TemporaryDirectory() as tmp:
        job = Path(tmp) / "histories.pkl"
        t0 = time.perf_counter()
        with open(job, "wb") as f:
            pickle.dump(histories(), f, protocol=pickle.HIGHEST_PROTOCOL)
        print(json.dumps({"histories_s": time.perf_counter() - t0}),
              flush=True)
        for _ in range(repeats):
            for turn in TURNS:
                p = subprocess.run(
                    [sys.executable, __file__, "--worker", roots[turn],
                     str(job)], capture_output=True, text=True,
                    timeout=900)
                if p.returncode:
                    sys.stderr.write(p.stderr[-4000:])
                    raise SystemExit(f"{turn}: worker exit {p.returncode}")
                line = json.loads(p.stdout.strip().splitlines()[-1])
                for c in CALLS:
                    medians[turn][c].append(line["median_s"][c])
                print(json.dumps({"turn": turn, **line}), flush=True)
    print(json.dumps({"median_of_turns_s": {
        k: {c: statistics.median(v) for c, v in cs.items()}
        for k, cs in medians.items()}, "roots": roots}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        sys.exit(worker(sys.argv[2], sys.argv[3]))
    sys.exit(main(sys.argv[1:]))
