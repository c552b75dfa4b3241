"""The multi-process sharded trim of this checkout against another's, on
one card: ``python3 -m jepsen_tpu_torch.parallel.distributed_compare
OTHER_ROOT [REPEATS]``.

The graph is the dependency (ww, wr, rw) edges of the 50k-txn list-append
history with 50 crossed pairs (``histories.elle_history``, the edges
``chip_smoke.py``'s phase 15 trims), split in two halves. For each
checkout in the order other, this, this, other (the whole order REPEATS
times, once by default), a world of two processes on the card (gloo, a
``file://`` rendezvous; each process this file run as a script with the
checkout first on its path) runs that checkout's
``parallel.distributed.trim_to_cycles_distributed`` on its half: once to
build and warm up, then three timed calls (``trim_s``), then as many of
the checkout's ``_all_reduce`` calls on an int32 [2, n] tensor on the
card as the trim ran rounds (``reduce_s``: the gloo all-reduces alone).
One JSON line a world gives both ranks' times, rounds and launches; every
rank's mask must equal this checkout's one-process ``trim_to_cycles`` on
all the edges (on the CPU). The last line is the card's name and power
limit as ``nvidia-smi`` prints them. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

THIS_ROOT = Path(__file__).resolve().parents[2]
TURNS = ("other", "this", "this", "other")
WORLD = 2


def edges():
    """(n, src, dst) of the 50k-txn history's dependency edges."""
    from jepsen_tpu_torch.elle import columnar
    from jepsen_tpu_torch.histories import elle_history
    graph = columnar._build(elle_history(50_000, crossed_pairs=50))[0]
    codes, src, dst = graph.cols
    dep = codes <= 2
    return graph.n, src[dep], dst[dep]


def worker(root: str, job_path: str, rank: int) -> int:
    """One process of a world: joins it, trims its half with the
    checkout at ``root``, writes its results beside the job."""
    sys.path[0] = root
    import torch
    from jepsen_tpu_torch.ops import scc_kernels as sk
    from jepsen_tpu_torch.parallel import distributed
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    distributed.initialize(job["init"], WORLD, rank)
    try:
        n, dev = job["n_nodes"], job["device"]
        src, dst = job["edges"][rank]
        distributed.trim_to_cycles_distributed(n, src, dst, device=dev)
        trim_s, masks = [], []
        before = (sk.trim_partial_degrees.launches, sk.trim_update.launches)
        for _ in range(3):
            t0 = time.perf_counter()
            masks.append(distributed.trim_to_cycles_distributed(
                n, src, dst, device=dev))
            trim_s.append(time.perf_counter() - t0)
        partials = (sk.trim_partial_degrees.launches - before[0]) // 3
        rounds = (sk.trim_update.launches - before[1]) // 3
        rows = torch.zeros((2, n), dtype=torch.int32, device=dev)
        sync = (torch.cuda.synchronize if rows.is_cuda
                else (lambda: None))
        sync()
        t0 = time.perf_counter()
        for _ in range(rounds):
            distributed._all_reduce(rows)
        sync()
        out = {"trim_s": trim_s, "reduce_s": time.perf_counter() - t0,
               "rounds": rounds, "partial_launches": partials,
               "masks": masks}
    finally:
        distributed.dist.destroy_process_group()
    with open(f"{job_path}.{rank}.out", "wb") as f:
        pickle.dump(out, f)
    return 0


def world(root: Path, graph, tmp: str, device: str = "cuda") -> list:
    """Both ranks' results of one world running ``root``'s trim on
    ``device``."""
    n, src, dst = graph
    half = (len(src) + 1) // 2
    job = os.path.join(tmp, f"job{time.monotonic_ns()}.pkl")
    with open(job, "wb") as f:
        pickle.dump({"init": f"file://{job}.rendezvous", "n_nodes": n,
                     "device": device,
                     "edges": [(src[:half], dst[:half]),
                               (src[half:], dst[half:])]}, f)
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         str(root), job, str(r)], cwd=str(root),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"{root} rank {r} failed:\n{log[-3000:]}")
    res = []
    for r in range(WORLD):
        with open(f"{job}.{r}.out", "rb") as f:
            res.append(pickle.load(f))
    return res


def main(argv) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from jepsen_tpu_torch.ops.scc import trim_to_cycles
    roots = {"other": Path(argv[0]).resolve(), "this": THIS_ROOT}
    repeats = int(argv[1]) if len(argv) > 1 else 1
    graph = edges()
    want = trim_to_cycles(*graph, device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        for rep in range(repeats):
            for label in TURNS:
                t0 = time.perf_counter()
                res = world(roots[label], graph, tmp)
                wall_s = time.perf_counter() - t0
                for r, out in enumerate(res):
                    if not all(np.array_equal(m, want) for m in out["masks"]):
                        raise AssertionError(f"{label} rank {r}: the mask "
                                             "differs from one process's")
                print(json.dumps({
                    "checkout": label, "repeat": rep, "nodes": graph[0],
                    "edges": len(graph[1]), "equal": True,
                    "trim_s": [o["trim_s"] for o in res],
                    "reduce_s": [o["reduce_s"] for o in res],
                    "rounds": [o["rounds"] for o in res],
                    "partial_launches": [o["partial_launches"] for o in res],
                    "wall_s": wall_s}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker(sys.argv[2], sys.argv[3], int(sys.argv[4])))
    sys.exit(main(sys.argv[1:]))
