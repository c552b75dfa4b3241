"""Times this checkout's frontier kernels against another checkout's, on
one CUDA card.

    python3 -m jepsen_tpu_torch.ops.frontier_compare OTHER_ROOT

OTHER_ROOT is the root of another checkout of the repo (for example an
earlier commit unpacked by ``git archive`` into a directory that
``.gitignore`` lists). ``frontier_dense.cu`` and ``frontier_sparse.cu``
are built from both checkouts' ``jepsen_tpu_torch/ops/csrc`` with
``_build.NVCC_FLAGS`` (four ``nvcc``, all started together, into
``jepsen_tpu_torch/_build/compare``), and each C entry is called directly on the shapes
of ``chip_smoke.py``'s main paths (the corrupted headline's dense table,
the 10k-op fresh-value history's sparse list) and on its frontier cases
that take each kernel's CTA path. For each case both builds' results
must agree bit for bit (alive, died, the flag, peak and the final table
or list); then each build is timed by CUDA events over back-to-back
calls, in the order other, this, this, other, and one JSON line gives
both builds' two timings, this build's work on its warp path and in all
(``out[4:6]``, which an earlier build may leave at 0) and the results.
The cases step the CAS register; a build from before the kernels took a
model (no ``csrc/frontier_model.cuh``) is called through its own C
signature, without the model's three ints.
The last line is the card's name and power limit as ``nvidia-smi``
prints them. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

NAMES = ("frontier_dense", "frontier_sparse")
# the CAS register's (model, keys, values), the last ints of a build's
# entry that takes a model
CAS_MODEL = (0, 0, 0)


def model_free_signatures(root) -> dict:
    """{(label "other", name): signature} for a checkout whose frontier
    entries take no model (no csrc/frontier_model.cuh), else {}."""
    from jepsen_tpu_torch.ops import _build
    csrc = Path(root) / "jepsen_tpu_torch" / "ops" / "csrc"
    if (csrc / "frontier_model.cuh").exists():
        return {}
    out = {}
    for name in NAMES:
        fn_name, argtypes = _build.SIGNATURES[name]
        out["other", name] = (fn_name, argtypes[:-4] + argtypes[-1:])
    return out


def build(roots: dict, out_dir: Path, names=NAMES,
          signatures: dict | None = None) -> dict:
    """{(label, name): C entry} of the kernels ``names`` from each root's
    csrc, all compiled at once. ``signatures`` may give a (label, name)
    another (entry name, argtypes) than ``_build.SIGNATURES``: an earlier
    build's C signature."""
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
        entries[label, name] = fn
    return entries


def cases():
    """(case, kernel, history maker, dense table (S, V) or sparse K):
    chip_smoke.py's main-path shapes, then its frontier cases that take
    the CTA paths, and S = 7 at V = 32, the dense CTA path's smallest
    table."""
    from jepsen_tpu_torch.histories import corrupt_reads, register_history
    return [
        ("corrupted_headline", "frontier_dense", lambda: corrupt_reads(
            register_history(10_000, 5, 42, 5), n=2, seed=0), (5, 16)),
        ("valid_headline", "frontier_dense",
         lambda: register_history(10_000, 5, 42, 5), (5, 16)),
        ("s12", "frontier_dense", lambda: register_history(800, 12, 105, 4),
         (12, 16)),
        ("v256_s3", "frontier_dense",
         lambda: register_history(1000, 3, 106, 300), (3, 512)),
        ("s6_v512", "frontier_dense",
         lambda: register_history(1000, 6, 108, 300), (6, 512)),
        ("s7_v512", "frontier_dense",
         lambda: register_history(1000, 7, 109, 300), (7, 512)),
        ("s7_v16", "frontier_dense",
         lambda: register_history(1000, 7, 111, 5), (7, 16)),
        ("s7_v32", "frontier_dense",
         lambda: register_history(1000, 7, 112, 20), (7, 32)),
        ("fresh_values_10k", "frontier_sparse",
         lambda: register_history(10_000, 5, 42, 10 ** 9), 256),
        ("s12", "frontier_sparse", lambda: register_history(800, 12, 105, 4),
         256),
        ("s12", "frontier_sparse", lambda: register_history(800, 12, 105, 4),
         16),
        ("corrupted_s5", "frontier_sparse", lambda: corrupt_reads(
            register_history(1000, 5, 102, 5), n=2, seed=1), 256),
        ("fresh_values", "frontier_sparse",
         lambda: register_history(1000, 5, 107, 10 ** 9), 4),
    ]


def run_case(entries, kernel, history, shape, reps: int) -> dict:
    import numpy as np
    import torch
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    from jepsen_tpu_torch.ops.jitlin import _bucket
    st = encode_register_ops(history)
    ev = [torch.as_tensor(np.asarray(x), dtype=torch.int32, device="cuda")
          for x in (st.kind, st.slot, st.f, st.a, st.b)]
    E, S = ev[0].numel(), max(1, st.n_slots)
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "frontier_dense":
        St, V = shape
        V = max(V, _bucket(len(st.intern), floor=16))
        t_in = fk.init_table(St, V, 0, "cuda").to(torch.uint8)
        outs = [torch.empty_like(t_in)]
        args = [t_in]
        tail = (E, St, V)
        info = {"S": St, "V": V}
    else:
        m0, s0 = fk.init_frontier(shape, 0, "cuda")
        outs = [torch.empty_like(m0), torch.empty_like(s0)]
        args = [m0, s0]
        tail = (E, S, shape)
        info = {"S": S, "K": shape}
    res = {}

    from jepsen_tpu_torch.ops import _build
    n_args = len(_build.SIGNATURES[kernel][1])

    def call(label):
        out = torch.zeros(8, dtype=torch.int32, device="cuda")
        fn = entries[label, kernel]
        model = CAS_MODEL if len(fn.argtypes) == n_args else ()
        rc = fn(*(x.data_ptr() for x in ev + args + outs + [out]), *tail,
                *model, stream)
        if rc != 0:
            raise RuntimeError(f"{label} {kernel}: CUDA error {rc}")
        res[label] = (out, [x.clone() for x in outs])

    for label in ("other", "this"):
        call(label)
    torch.cuda.synchronize()
    (o_out, o_fr), (t_out, t_fr) = res["other"], res["this"]
    equal = (torch.equal(o_out[:4], t_out[:4])
             and all(torch.equal(x, y) for x, y in zip(o_fr, t_fr)))
    if not equal:
        raise AssertionError(f"{kernel} {info}: the builds differ: "
                             f"{o_out.tolist()} {t_out.tolist()}")
    times = {"other": [], "this": []}
    for label in ("other", "this", "this", "other"):
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
    return {"kernel": kernel, **info, "events": E,
            "result": t_out[:4].tolist(), "warp_work": int(t_out[4]),
            "work": int(t_out[5]), "other_ms": times["other"],
            "this_ms": times["this"]}


def main(argv) -> int:
    import torch
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("frontier_compare: no CUDA device", file=sys.stderr)
        return 1
    from jepsen_tpu_torch.ops import _build
    out_dir = _build.BUILD_DIR / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    entries = build({"other": argv[0],
                     "this": Path(__file__).resolve().parents[2]}, out_dir,
                    signatures=model_free_signatures(argv[0]))
    for case, kernel, make, shape in cases():
        row = run_case(entries, kernel, make(), shape, reps=5)
        print(json.dumps({"case": case, **row}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
