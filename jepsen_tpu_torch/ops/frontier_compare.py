"""Times this checkout's frontier kernels against another checkout's, on
one CUDA card.

    python3 -m jepsen_tpu_torch.ops.frontier_compare OTHER_ROOT

OTHER_ROOT is the root of another checkout of the repo (for example an
earlier commit unpacked by ``git archive`` into a directory that
``.gitignore`` lists). ``frontier_dense.cu`` and ``frontier_sparse.cu``
are built from both checkouts' ``jepsen_tpu_torch/ops/csrc`` with
``_build.NVCC_FLAGS`` (four ``nvcc``, all started together, into
``jepsen_tpu_torch/_build/compare``), and each C entry is called directly
on the cases of :func:`cases`: the shapes of ``chip_smoke.py``'s main
paths and of its frontier cases that take each kernel's CTA path, with
the CAS register; the multi-register model's paths (the dense CTA path
at (3, 5), the dense warp path at (2, 3), the sparse list at S = 5 and
at S = 10) and keys of the 1,000-key multi-key-acid check at S = 7 to 10;
and the CAS register at each of those (S, V) or (S, K), the path's own
cost without the multi-register step. For each case both builds'
results must agree bit for bit (alive, died, the flag, peak and the
final table or list); then each build is timed by CUDA events over
back-to-back calls, in the order other, this, this, other, and one JSON
line gives both builds' two timings, this build's work on its warp path
and in all (``out[4:6]``, which an earlier build may leave at 0) and the
results. Each timing is split into the launch's fixed part (the same
call on an empty event stream: set-up and write-back) and, for the dense
table, the stream's invokes alone (the next-state tables and the
out-of-range flag; no return closes). A build from before the kernels
took a model (no ``csrc/frontier_model.cuh``) is called through its own
C signature, without the model's three ints, and skips the
multi-register cases. One ``sass`` line a build gives each kernel
instantiation's instruction count (``cuobjdump -sass``).
The last line is the card's name and power limit as ``nvidia-smi``
prints them. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

from jepsen_tpu_torch.ops.compare_common import build, card_line, in_turns

NAMES = ("frontier_dense", "frontier_sparse")
# the kernels' model codes (models.KERNEL_CAS, KERNEL_MULTI_REGISTER)
CAS, MULTI_REGISTER = 0, 1


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


def sass_counts(lib: Path) -> dict:
    """{kernel function: SASS instruction count} of a built library, by
    ``cuobjdump -sass`` (found beside ``nvcc``); {} without it."""
    from jepsen_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or str(
        Path(_build._nvcc()).parent / "cuobjdump")
    try:
        text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return {}
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[fn] += 1
    return counts


def _acid_key(S: int):
    """The first key of ``multi_key_acid_history(1000)`` whose stream has
    S slots, encoded: key g's sub-history is group g's txns
    (histories.multi_key_acid_history)."""
    from jepsen_tpu_torch.checker.linear_encode import (
        encode_multi_register_ops)
    from jepsen_tpu_torch.histories import multi_register_history
    for g in range(1000):
        st = encode_multi_register_ops(multi_register_history(
            20, 10, 3, 5, seed=2000 + g, n_readers=5))
        if st.n_slots == S:
            return st
    raise ValueError(f"no multi-key-acid key with {S} slots")


def cases():
    """(case, kernel, stream maker, dense table (S or None for the
    stream's, V) or sparse K, model (keys, values) or None for the CAS
    register): chip_smoke.py's main-path shapes, then its frontier cases
    that take the CTA paths, and S = 7 at V = 32, the dense CTA path's
    smallest table; the multi-register rows of chip_smoke.py's phase 11
    and keys of its 1,000-key check; the CAS register at those shapes."""
    from jepsen_tpu_torch.checker.linear_encode import (
        encode_multi_register_ops, encode_register_ops)
    from jepsen_tpu_torch.histories import (
        corrupt_reads, crash_late_writes, multi_register_history,
        register_history)

    def reg(*args):
        return lambda: encode_register_ops(register_history(*args))

    def mr(n, seed, shape=(3, 5), crash=False):
        def make():
            h = multi_register_history(n, 5, *shape, seed=seed)
            return encode_multi_register_ops(
                crash_late_writes(h) if crash else h, *shape)
        return make

    def crashed_reg(n, procs, seed, values, every):
        # every ``every``-th write or cas completion crashes
        def make():
            out, k = [], 0
            for op in register_history(n, procs, seed, values):
                op = dict(op)
                if op["type"] == "ok" and op["f"] != "read":
                    k += 1
                    if k % every == 0:
                        op["type"] = "info"
                out.append(op)
            return encode_register_ops(out)
        return make

    return [
        ("corrupted_headline", "frontier_dense", lambda: encode_register_ops(
            corrupt_reads(register_history(10_000, 5, 42, 5), n=2, seed=0)),
         (5, 16), None),
        ("valid_headline", "frontier_dense", reg(10_000, 5, 42, 5), (5, 16),
         None),
        ("s12", "frontier_dense", reg(800, 12, 105, 4), (12, 16), None),
        ("v256_s3", "frontier_dense", reg(1000, 3, 106, 300), (3, 512),
         None),
        ("s6_v512", "frontier_dense", reg(1000, 6, 108, 300), (6, 512),
         None),
        ("s7_v512", "frontier_dense", reg(1000, 7, 109, 300), (7, 512),
         None),
        ("s7_v16", "frontier_dense", reg(1000, 7, 111, 5), (7, 16), None),
        ("s7_v32", "frontier_dense", reg(1000, 7, 112, 20), (7, 32), None),
        ("fresh_values_10k", "frontier_sparse", reg(10_000, 5, 42, 10 ** 9),
         256, None),
        ("s12", "frontier_sparse", reg(800, 12, 105, 4), 256, None),
        ("s12", "frontier_sparse", reg(800, 12, 105, 4), 16, None),
        ("corrupted_s5", "frontier_sparse", lambda: encode_register_ops(
            corrupt_reads(register_history(1000, 5, 102, 5), n=2, seed=1)),
         256, None),
        ("fresh_values", "frontier_sparse", reg(1000, 5, 107, 10 ** 9), 4,
         None),
        # the multi-register model: chip_smoke.py phase 11's kernel rows
        # (1k txns, seed 43: the dense CTA path at (3, 5), S = 5; the
        # sparse list at S = 5 and, with late writes crashed, at S = 10)
        # and the dense warp path at (2, 3)
        ("mr_dense_cta_3x5", "frontier_dense", mr(1000, 43),
         (None, 256), (3, 5)),
        ("mr_dense_warp_2x3", "frontier_dense", mr(1000, 44, (2, 3)),
         (None, 16), (2, 3)),
        ("mr_sparse_s5", "frontier_sparse", mr(1000, 43), 256, (3, 5)),
        ("mr_sparse_s10", "frontier_sparse", mr(1000, 43, crash=True), 256,
         (3, 5)),
        # keys of the 1,000-key multi-key-acid check, as its rung launches
        # them: S <= 9 on the dense table (V = 256), S = 10 on the list
        ("mr_acid_s7", "frontier_dense", lambda: _acid_key(7), (None, 256),
         (3, 5)),
        ("mr_acid_s8", "frontier_dense", lambda: _acid_key(8), (None, 256),
         (3, 5)),
        ("mr_acid_s9", "frontier_dense", lambda: _acid_key(9), (None, 256),
         (3, 5)),
        ("mr_acid_s10", "frontier_sparse", lambda: _acid_key(10), 256,
         (3, 5)),
        # the CAS register at the multi-register rows' shapes and paths:
        # the path's own cost
        ("cas_s5_v256", "frontier_dense", reg(1000, 5, 121, 200), (5, 256),
         None),
        ("cas_s9_v256", "frontier_dense", reg(200, 9, 122, 200), (9, 256),
         None),
        ("cas_s5_v16", "frontier_dense", reg(1000, 5, 123, 5), (5, 16),
         None),
        ("cas_s5_k256", "frontier_sparse", reg(1000, 5, 124, 200), 256,
         None),
        ("cas_s10_k256", "frontier_sparse", crashed_reg(1000, 5, 125, 200, 70),
         256, None),
    ]


def run_case(entries, kernel, st, shape, model, reps: int) -> dict:
    import numpy as np
    import torch
    from jepsen_tpu_torch.ops import _build
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    from jepsen_tpu_torch.ops.jitlin import _bucket
    cols = [np.asarray(x, dtype=np.int32)
            for x in (st.kind, st.slot, st.f, st.a, st.b)]
    ev = [torch.as_tensor(x, device="cuda") for x in cols]
    inv = cols[0] == fk.EV_INVOKE
    ev_inv = [torch.as_tensor(np.ascontiguousarray(x[inv]), device="cuda")
              for x in cols]
    E, S = ev[0].numel(), max(1, st.n_slots)
    stream = torch.cuda.current_stream().cuda_stream
    dense = kernel == "frontier_dense"
    if dense:
        St, V = shape
        St = St or S
        V = max(V, _bucket(len(st.intern), floor=16))
        args = [fk.init_table(St, V, 0, "cuda").to(torch.uint8)]
        dims = (St, V)
        info = {"S": St, "V": V, "warp_path": fk.dense_warp_path(St, V)}
    else:
        args = list(fk.init_frontier(shape, 0, "cuda"))
        dims = (S, shape)
        info = {"S": S, "K": shape}
    code = (MULTI_REGISTER, *model) if model else (CAS, 0, 0)
    n_args = len(_build.SIGNATURES[kernel][1])
    labels = [k for k in ("other", "this") if (k, kernel) in entries and (
        not model or len(entries[k, kernel].argtypes) == n_args)]
    # each build's outputs: the final frontier and out[8], allocated once,
    # so that a timed call is the C entry's launch alone
    bufs = {k: ([torch.empty_like(x) for x in args],
                torch.zeros(8, dtype=torch.int32, device="cuda"))
            for k in labels}

    def call(label, cols=ev, n=E):
        fn = entries[label, kernel]
        fr, out = bufs[label]
        tail = code if len(fn.argtypes) == n_args else ()
        rc = fn(*(x.data_ptr() for x in cols + args + fr + [out]), n,
                *dims, *tail, stream)
        if rc != 0:
            raise RuntimeError(f"{label} {kernel}: CUDA error {rc}")

    for label in labels:
        call(label)
    torch.cuda.synchronize()
    t_out = bufs["this"][1]
    if "other" in bufs:
        (o_fr, o_out), (t_fr, _) = bufs["other"], bufs["this"]
        equal = (torch.equal(o_out[:4], t_out[:4])
                 and all(torch.equal(x, y) for x, y in zip(o_fr, t_fr)))
        if not equal:
            raise AssertionError(f"{kernel} {info}: the builds differ: "
                                 f"{o_out.tolist()} {t_out.tolist()}")
    row = {"kernel": kernel, "model": list(model) if model else "cas",
           **info, "events": E, "result": t_out[:4].tolist(),
           "warp_work": int(t_out[4]), "work": int(t_out[5])}

    for name, how in (("", ()), ("fixed_", (ev, 0)),
                      *((("invokes_", (ev_inv, int(inv.sum()))),)
                        if dense else ())):
        for label, t in in_turns(lambda label: call(label, *how), labels,
                                 reps).items():
            row[f"{label}_{name}ms"] = t
    return row


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
                    NAMES, signatures=model_free_signatures(argv[0]))
    for (label, name), fn in sorted(entries.items()):
        print(json.dumps({"sass": label, "library": name,
                          "instructions": sass_counts(fn.lib_path),
                          "ptxas": fn.ptxas}), flush=True)
    for case, kernel, make, shape, model in cases():
        st = make()
        reps = 5 if len(st.kind) > 1000 else 20
        row = run_case(entries, kernel, st, shape, model, reps=reps)
        print(json.dumps({"case": case, **row}), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
