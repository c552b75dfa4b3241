#!/usr/bin/env python3
"""Launch-shape sweep of the combine kernel on one CUDA card.

    python3 combine_sweep.py

Builds ``jepsen_tpu_torch/ops/csrc/chunk_combine.cu`` with each pair of
fan-in (``kFanIn``: 2, 4, 8) and CTA target (``kCtasPerSm``: 2, 4, 8),
runs each on the main path's headline chunk products (the 10k-op history
of ``chip_smoke.py``) and on all-zero products of the same shape (no OR
work: the per-level floor), and prints one JSON line per variant: bit
equality with the plain version, CUDA-event milliseconds per call (the C
entry called directly, so no Python wrapper time), and each kernel's
device microseconds from ``torch.profiler``. The builds go to a temporary
directory. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

FAN_INS = (2, 4, 8)
CTAS_PER_SM = (2, 4, 8)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("combine_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    from jepsen_tpu_torch.histories import register_history
    from jepsen_tpu_torch.ops import _build
    from jepsen_tpu_torch.ops import matrix_kernels as mk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    history = register_history(cs.N_OPS, n_procs=cs.N_PROCS, seed=cs.SEED,
                               n_values=cs.N_VALUES)
    hd = cs.headline_inputs(encode_register_ops(history))
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
    print(json.dumps({"card": smi, "C": C, "MV": MV,
                      "p_ones_frac": P.float().mean().item()}), flush=True)

    text = (_build.SRC_DIR / "chunk_combine.cu").read_text()
    for const in ("kFanIn = 4;", "kCtasPerSm = 4;"):
        if const not in text:
            raise AssertionError(f"chunk_combine.cu has no '{const}'")
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for fan in FAN_INS:
            for ctas in CTAS_PER_SM:
                src = Path(tmp) / f"combine_f{fan}_c{ctas}.cu"
                src.write_text(text.replace("kFanIn = 4;", f"kFanIn = {fan};")
                               .replace("kCtasPerSm = 4;",
                                        f"kCtasPerSm = {ctas};"))
                lib = src.with_suffix(".so")
                jobs[fan, ctas] = (lib, subprocess.Popen(
                    [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                     str(src)], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
        for (fan, ctas), (lib, proc) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {fan, ctas}:\n{log}")
            fn = ctypes.CDLL(str(lib)).jt_chunk_combine
            fn.argtypes = _build.SIGNATURES["chunk_combine"][1]
            fn.restype = ctypes.c_int
            row = {"fan_in": fan, "ctas_per_sm": ctas}
            for name, X in inputs.items():
                def call(X=X):
                    rc = fn(*(ctypes.c_void_p(t.data_ptr())
                              for t in (X, tot0, out, ws)), 1, C, MV,
                            ctypes.c_void_p(
                                torch.cuda.current_stream().cuda_stream))
                    if rc != 0:
                        raise RuntimeError(f"combine launch failed: {rc}")
                call()
                torch.cuda.synchronize()
                row[name] = {"equal": bool(torch.equal(out, refs[name])),
                             "ms": cs.cuda_ms(call, 100),
                             "kernels_us": [round(us, 3) for _, us in
                                            cs.device_kernels(call)]}
                if not row[name]["equal"]:
                    raise AssertionError(f"variant {row} differs")
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
