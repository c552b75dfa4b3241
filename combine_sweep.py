#!/usr/bin/env python3
"""Launch-shape sweeps of the Hopper kernels on one CUDA card.

    python3 combine_sweep.py              # the combine
    python3 combine_sweep.py --product    # the chunk product
    python3 combine_sweep.py --trim       # the Elle trim's peel
    python3 combine_sweep.py --screen     # the Elle screen's peel
    python3 combine_sweep.py --degrees    # the sharded trim's round grids

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

The trim: builds ``scc_trim.cu`` as it is; with its peel in one CTA for
every graph (``kOneCtaMaxNodes`` and ``kOneCtaMaxEdges`` past any size);
on the grid for every graph (both 0), never handing over to one CTA
(``kGridMinItems = 1``) or handing over below 1024 nodes a step; handing
over below 4096; with CTAs of 512 threads (``kThreads``); and with 2
atomics in flight a thread (``kBatch``). It runs each on the Elle
phases' trim inputs (``ops/elle_compare.py`` ``recorded_inputs``: the
global path's, the capped 5,000-node chain, the graphs of 2^16 nodes and
2^18 edges and of 2^19 nodes and 2^20 edges). The screen: builds
``cluster_screen.cu`` with ``kPeelWarps`` 1, 2, 4, 8 and 32 and runs
each on the wide window's two calls and 16 chain clusters of V = 1024.
The round: builds ``trim_degrees.cu`` with each CTA count an SM of the
degree pass's and the update's grids (``kBlocksPerSm``: 2, 4, 8, 16,
each CTA in a grid-stride loop) and runs the degree pass (accumulating,
as a round's shards do) and the update (its inputs restored before each
call) on ``ops/elle_compare.py``'s round cases: a shard of 2^18 edges of
the 2^19-node graph and of the global path's edges. Each variant's
results (the trim's mask and steps, the screen's flags, the round's
rows, mask, packed mask and flag) must equal the plain version's; a
variant that does not launch prints its error. Each case also gives its
launches' device microseconds from ``torch.profiler``.

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
        fn.lib_path = lib
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


def sweep_elle(kernel, tmp):
    """The trim's peel placements or the screen's peel warps, each on the
    Elle phases' inputs against the plain version."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from jepsen_tpu_torch.ops import elle_compare as ec
    from jepsen_tpu_torch.ops import scc_kernels as sk
    cases = {case: args for case, (k, args) in ec.recorded_inputs().items()
             if k == kernel}
    if kernel == "scc_trim":
        consts = ("kOneCtaMaxNodes = 1 << 17;", "kOneCtaMaxEdges = 1 << 17;",
                  "kGridMinItems = 1024;", "kThreads = 1024;", "kBatch = 4;")
        variants = [("1 << 17", "1 << 17", 1024, 1024, 4),
                    ("1 << 30", "1 << 30", 1024, 1024, 4),
                    (0, 0, 1, 1024, 4), (0, 0, 1024, 1024, 4),
                    ("1 << 17", "1 << 17", 4096, 1024, 4),
                    ("1 << 17", "1 << 17", 1024, 512, 4),
                    ("1 << 17", "1 << 17", 1024, 1024, 2)]
    else:
        consts = ("kPeelWarps = 4;",)
        variants = [(w,) for w in (1, 2, 4, 8, 32)]
    inputs, refs = {}, {}
    for case, args in cases.items():
        if kernel == "scc_trim":
            src, dst, valid, n = args
            cols = [torch.from_numpy(np.asarray(x)).cuda()
                    for x in (src.astype(np.int32), dst.astype(np.int32),
                              valid.astype(bool))]
            mask, steps = sk.scc_trim_torch(*cols, n, 512)
            refs[case] = (mask.to(torch.uint8), int(steps))
            inputs[case] = (*cols, n)
        else:
            cid, src, dst, B, V = args
            cols = [torch.from_numpy(np.asarray(x, np.int32)).cuda()
                    for x in (cid, src, dst)]
            valid = torch.ones(len(cid), dtype=torch.bool, device="cuda")
            refs[case] = (sk.cluster_screen_torch(*cols, valid, B, V)
                          .to(torch.uint8), None)
            inputs[case] = (*cols, B, V)
    yield {"kernel": kernel, "cases": list(inputs)}
    fns = build_variants(kernel, consts, variants, tmp)
    caller = ec.trim_caller if kernel == "scc_trim" else ec.screen_caller
    for values, fn in fns.items():
        row = dict(zip((c.split(" =")[0] for c in consts), values))
        for case, args in inputs.items():
            try:
                call, result = caller(fn, False, *args)
                call()
                torch.cuda.synchronize()
                got = result()
            except RuntimeError as err:
                row[case] = {"error": str(err)}
                continue
            equal = bool(torch.equal(got[0], refs[case][0])) and (
                kernel != "scc_trim" or got[1] == refs[case][1])
            if not equal:
                raise AssertionError(f"{kernel} {values} {case} differs "
                                     f"from the plain version")
            row[case] = {"equal": equal, "ms": ec.timed(call, 10),
                         "work": got[-1],
                         "kernels_us": [(k, round(us, 3)) for k, us in
                                        cs.device_kernels(call)]}
        yield row


def sweep_degrees(tmp):
    """The round's degree pass and update in each build, on the round
    cases, against the plain versions."""
    import torch

    import chip_smoke as cs
    from jepsen_tpu_torch.ops import _build
    from jepsen_tpu_torch.ops import elle_compare as ec
    from jepsen_tpu_torch.ops import scc_kernels as sk
    cases = {}
    for case, (src, dst, n) in ec.round_cases(ec.recorded_inputs()).items():
        s, d, w, act = ec.round_inputs(src, dst, n)
        bits = sk.pack_mask(act)
        rows = sk.trim_partial_degrees_torch(
            s, d, w, act, bits, torch.zeros((2, n), dtype=torch.int32,
                                            device="cuda"))
        want = (rows.clone(), act.clone(), bits.clone(),
                torch.zeros(2, dtype=torch.int32, device="cuda"))
        sk.trim_update_torch(want[0], None, want[1], want[2], want[3], 0)
        cases[case] = (s, d, w, act, bits, rows, want)
    yield {"cases": {k: {"nodes": v[3].numel(), "edges": v[0].numel()}
                     for k, v in cases.items()}}
    fns = build_variants("trim_degrees", ("kBlocksPerSm = 8;",),
                         [(k,) for k in (2, 4, 8, 16)], tmp)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    fn_name, argtypes = _build.UPDATE_SIGNATURES["trim_degrees"]
    for values, partial in fns.items():
        update = getattr(ctypes.CDLL(str(partial.lib_path)), fn_name)
        update.argtypes, update.restype = argtypes, ctypes.c_int
        row = {"kBlocksPerSm": values[0]}
        for case, (s, d, w, act, bits, rows, want) in cases.items():
            n, E = act.numel(), s.numel()
            deg = torch.zeros((2, n), dtype=torch.int32, device="cuda")

            def call_partial():
                rc = partial(s.data_ptr(), d.data_ptr(), w.data_ptr(),
                             bits.data_ptr(), E, n, deg.data_ptr(), stream)
                if rc != 0:
                    raise RuntimeError(f"trim_partial_degrees: {rc}")
            work = (rows.clone(), act.clone(), bits.clone(),
                    torch.zeros(2, dtype=torch.int32, device="cuda"))

            def restore():
                work[0].copy_(rows)
                work[1].copy_(act)
                work[3].zero_()

            def call_update():
                restore()
                rc = update(work[0].data_ptr(), None, 0, work[1].data_ptr(),
                            work[2].data_ptr(), n, work[3].data_ptr(), 0,
                            stream)
                if rc != 0:
                    raise RuntimeError(f"trim_update: {rc}")
            try:
                call_partial()
                call_update()
                torch.cuda.synchronize()
            except RuntimeError as err:
                row[case] = {"error": str(err)}
                continue
            if not torch.equal(deg, rows) or not all(
                    torch.equal(a, b) for a, b in zip(work, want)):
                raise AssertionError(f"trim_degrees {values} {case} "
                                     f"differs from the plain version")
            row[case] = {
                "equal": True, "partial_ms": cs.cuda_ms(call_partial, 50),
                "update_ms": cs.cuda_ms(call_update, 50),
                "restore_ms": cs.cuda_ms(restore, 50),
                "partial_kernels_us": [(k, round(us, 3)) for k, us in
                                       cs.device_kernels(call_partial)],
                "update_kernel_us": [(k, round(us, 3)) for k, us in
                                     cs.device_kernels(call_update)
                                     if "update_mask" in k]}
        yield row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("combine_sweep: no CUDA device", file=sys.stderr)
        return 1
    if "--degrees" in sys.argv[1:]:
        import chip_smoke as cs
        print(json.dumps({"card": cs.nvidia_smi("name,power.limit")}),
              flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            for row in sweep_degrees(tmp):
                print(json.dumps(row), flush=True)
        return 0
    if "--trim" in sys.argv[1:] or "--screen" in sys.argv[1:]:
        import chip_smoke as cs
        kernel = "scc_trim" if "--trim" in sys.argv[1:] else \
            "cluster_screen"
        print(json.dumps({"card": cs.nvidia_smi("name,power.limit")}),
              flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            for row in sweep_elle(kernel, tmp):
                print(json.dumps(row), flush=True)
        return 0
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
