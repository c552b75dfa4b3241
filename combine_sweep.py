#!/usr/bin/env python3
"""Launch-shape sweeps of the Hopper kernels on one CUDA card.

    python3 combine_sweep.py              # the combine
    python3 combine_sweep.py --product    # the chunk product

The combine: builds ``jepsen_tpu_torch/ops/csrc/chunk_combine.cu`` with
each pair of fan-in (``kFanIn``: 2, 4, 8) and CTA target (``kCtasPerSm``:
2, 4, 8), runs each on the main path's headline chunk products (the
10k-op history of ``chip_smoke.py``) and on all-zero products of the same
shape (no OR work: the per-level floor).

The chunk product: builds ``chunk_product.cu`` with each pair of thread
count a CTA (``kThreads``: 32 to 512) and column words a warp
(``kWordsPerWarp``: 1, 2, 4), and runs each on the headline inputs and on
dense ones of the same shape (every slot pending at every step, every op
a write: the densest closure rows).

Each prints one JSON line per variant: bit equality with the plain
version, CUDA-event milliseconds per call (the C entry called directly,
so no Python wrapper time), and each kernel's device microseconds from
``torch.profiler``. The builds go to a temporary directory, one ``nvcc``
per variant, all started together. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import subprocess
import sys
import tempfile
from pathlib import Path

FAN_INS = (2, 4, 8)
CTAS_PER_SM = (2, 4, 8)
THREADS = (32, 64, 128, 256, 512)
WORDS_PER_WARP = (1, 2, 4)


def build_variants(name, consts, variants, tmp):
    """Builds ``csrc/<name>.cu`` once per variant, in parallel. ``consts``
    are the source's constant definitions (``"kFanIn = 4;"``); each
    variant is a tuple of values, one per constant. Returns {variant:
    the C entry, argtypes set}."""
    from jepsen_tpu_torch.ops import _build
    text = (_build.SRC_DIR / f"{name}.cu").read_text()
    for const in consts:
        if const not in text:
            raise AssertionError(f"{name}.cu has no '{const}'")
    jobs = {}
    for values in variants:
        src_text = text
        for const, value in zip(consts, values):
            src_text = src_text.replace(
                const, f"{const.split('=')[0]}= {value};")
        src = Path(tmp) / f"{name}_{'_'.join(map(str, values))}.cu"
        src.write_text(src_text)
        lib = src.with_suffix(".so")
        jobs[values] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    entry, argtypes = _build.SIGNATURES[name]
    for values, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {values}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[values] = fn
    return fns


def timed(call, ref, reps):
    """{equal, ms, kernels_us} of a no-argument ``call`` that returns its
    output; raises when the output differs from ``ref``."""
    import torch

    import chip_smoke as cs
    got = call()
    torch.cuda.synchronize()
    row = {"equal": bool(torch.equal(got, ref)), "ms": cs.cuda_ms(call, reps),
           "kernels_us": [round(us, 3) for _, us in cs.device_kernels(call)]}
    if not row["equal"]:
        raise AssertionError("a variant differs from the plain version")
    return row


def sweep_combine(hd, tmp):
    import torch

    from jepsen_tpu_torch.ops import matrix_kernels as mk
    S, V, C, MV = hd["S"], hd["V"], hd["C"], hd["MV"]
    P = mk.chunk_product(*hd["args"], S, V).reshape(1, C, MV, MV)
    tot0 = torch.eye(MV, dtype=torch.bfloat16, device="cuda")[None]
    tot0 = tot0.contiguous()
    inputs = {"headline": P, "zeros": torch.zeros_like(P)}
    refs = {k: mk.combine_product_torch(x, tot0) for k, x in inputs.items()}
    W = (MV + 31) // 32
    ws = torch.empty(((C + 1 + (C + 2) // 2) * MV * W,), dtype=torch.int32,
                     device="cuda")
    out = torch.empty((1, MV, MV), dtype=torch.bfloat16, device="cuda")
    yield {"C": C, "MV": MV, "p_ones_frac": P.float().mean().item()}
    fns = build_variants("chunk_combine", ("kFanIn = 4;", "kCtasPerSm = 4;"),
                         itertools.product(FAN_INS, CTAS_PER_SM), tmp)
    for (fan, ctas), fn in fns.items():
        row = {"fan_in": fan, "ctas_per_sm": ctas}
        for name, X in inputs.items():
            def call(X=X):
                rc = fn(*(ctypes.c_void_p(t.data_ptr())
                          for t in (X, tot0, out, ws)), 1, C, MV,
                        ctypes.c_void_p(
                            torch.cuda.current_stream().cuda_stream))
                if rc != 0:
                    raise RuntimeError(f"combine launch failed: {rc}")
                return out
            row[name] = timed(call, refs[name], 100)
        yield row


def sweep_product(hd, tmp):
    import chip_smoke as cs
    from jepsen_tpu_torch.ops import matrix_kernels as mk
    S, V, C, T = hd["S"], hd["V"], hd["C"], hd["T"]
    U = hd["args"][2].shape[0]
    inputs = {"headline": hd["args"],
              "dense": cs.random_chunk_inputs(S, V, T, C, U, 0, "write")}
    refs = {k: mk.chunk_product_torch(*a, S, V) for k, a in inputs.items()}
    yield {"S": S, "V": V, "MV": hd["MV"], "C": C, "T": T, "U": U,
           "ones_frac": {k: r.float().mean().item() for k, r in refs.items()}}
    fns = build_variants("chunk_product",
                         ("kThreads = 512;", "kWordsPerWarp = 2;"),
                         itertools.product(THREADS, WORDS_PER_WARP), tmp)
    for (threads, words), fn in fns.items():
        row = {"threads": threads, "words_per_warp": words}
        for name, args in inputs.items():
            row[name] = timed(cs.chunk_entry_call(fn, args, S, V),
                              refs[name], 50)
        yield row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("combine_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    from jepsen_tpu_torch.histories import register_history

    history = register_history(cs.N_OPS, n_procs=cs.N_PROCS, seed=cs.SEED,
                               n_values=cs.N_VALUES)
    hd = cs.headline_inputs(encode_register_ops(history))
    sweep = sweep_product if "--product" in sys.argv[1:] else sweep_combine
    print(json.dumps({"card": cs.nvidia_smi("name,power.limit")}),
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for row in sweep(hd, tmp):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
