"""Times this checkout's Elle kernels against another checkout's, on one
CUDA card.

    python3 -m jepsen_tpu_torch.ops.elle_compare OTHER_ROOT

OTHER_ROOT is the root of another checkout of the repo (for example an
earlier commit unpacked by ``git archive`` into a directory that
``.gitignore`` lists). ``scc_trim.cu`` and ``cluster_screen.cu`` are built
from both checkouts with ``frontier_compare.build`` (four ``nvcc``, all
started together), and each C entry is called directly on the inputs of
``chip_smoke.py``'s Elle phases: the trim on the global path's recorded
input, the 5,000-node chain (capped at 512 steps) and the seeded graphs
of 2^16 nodes and 2^18 edges and of 2^19 nodes and 2^20 edges; the
screen on the wide-window history's two
recorded calls and on 16 chain clusters of V = 1024.

An earlier build may have the earlier designs' C contracts, told apart by
its source: a trim whose scratch is the stamps int32[2n] and whose flags
must be zero before each call, and a screen whose entry (its signature is
carried here) takes the edges sorted by cluster with their offsets. Each
build is called as its own wrapper calls it, on the same unsorted card
columns: the earlier screen's sort (``torch.sort``, the gathers and
``torch.searchsorted``) and the earlier trim's zeroed scratch are part of
its call, and the earlier screen's C entry alone is timed too
(``other_entry_ms``). Both builds' results must agree bit for bit (the
trim's mask and steps, the screen's flags); then each is timed by CUDA
events over back-to-back calls, in the order other, this, this, other,
and one JSON line per case gives both builds' two timings and this
build's work count.

``trim_degrees.cu`` (the sharded trim's round) is compared the same way
when the other checkout has it: each entry on one of four edge shards of
the seeded graph of 2^19 nodes and 2^20 edges (2^18 edges, the shape of
``chip_smoke.py``'s ``trim_degrees_kernel`` line) and of the global
path's recorded edges, with a seeded mask (70 % active) and weights (5 %
padding). Each build is called as its own
wrapper calls it: an earlier build's degree pass takes a fresh row pair
(``torch.empty``) that its entry zeroes with two memsets, and its update
a fresh flag that its entry zeroes; this build's degree pass accumulates
into a kept pair and its update takes the mask's packed copy and a flag
slot. Each update call first restores its inputs (the rows, the mask,
the flags: ``restore_ms`` apart). The partial rows, the updated mask
and the flag must agree bit for bit; each line adds the profiler's
device ms of each build's kernel alone (``*_kernel_ms``).

The last line is the card's name and power limit as ``nvidia-smi``
prints them. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

NAMES = ("scc_trim", "cluster_screen")
_P, _I = ctypes.c_void_p, ctypes.c_int
# the earlier screen entry: (src, dst, valid, offs, out, B, V, stream),
# the edges sorted by cluster
EARLIER_SCREEN = ("jt_cluster_screen", [_P, _P, _P, _P, _P, _I, _I, _P])
# the earlier round entries: (src, dst, w, active, E, n, out_in, out_out,
# stream), zeroing their rows; (in, out, active, n, changed, stream)
EARLIER_PARTIAL = ("jt_trim_partial_degrees",
                   [_P, _P, _P, _P, _I, _I, _P, _P, _P])
EARLIER_UPDATE = ("jt_trim_update", [_P, _P, _P, _I, _P, _P])


def _source(root, name: str) -> Path:
    return Path(root) / "jepsen_tpu_torch" / "ops" / "csrc" / f"{name}.cu"


def earlier_design(root, name: str) -> bool:
    """Whether ``name``'s source under ``root`` has the earlier contract."""
    text = _source(root, name).read_text()
    if name == "trim_degrees":
        return "void* bits" not in text
    return ("stamp_in" in text if name == "scc_trim"
            else "void* scratch" not in text)


class recorded:
    """Within the block, records the arguments of every call that
    jepsen_tpu_torch.ops.scc makes to the Elle kernels' wrappers (in
    ``.calls[name]``); the calls still go to the wrappers."""

    def __enter__(self):
        import types
        from jepsen_tpu_torch.ops import scc, scc_kernels
        self.calls = {"cluster_screen_host": [], "scc_trim": []}

        def rec(name):
            def call(*args):
                self.calls[name].append(args)
                return getattr(scc_kernels, name)(*args)
            return call
        self._mod = scc
        scc.scc_kernels = types.SimpleNamespace(
            cluster_screen_host=rec("cluster_screen_host"),
            scc_trim=rec("scc_trim"))
        return self

    def __exit__(self, *exc):
        from jepsen_tpu_torch.ops import scc_kernels
        self._mod.scc_kernels = scc_kernels
        return False


def recorded_inputs():
    """The Elle phases' inputs: {case: ("scc_trim", (src, dst, valid, n))
    or ("cluster_screen", (cid, src, dst, B, V))}, numpy arrays, the
    global path's and the wide window's as the checks hand them over."""
    import numpy as np
    import jepsen_tpu_torch.elle as elle
    from jepsen_tpu_torch.elle import columnar, list_append
    from jepsen_tpu_torch.histories import (chain_clusters, elle_history,
                                            random_trim_graph)
    from jepsen_tpu_torch.ops import scc
    from jepsen_tpu_torch.ops.jitlin import _bucket
    with recorded() as rec:
        graph = columnar._build(elle_history(50_000, crossed_pairs=50))[0]
        graph.time_order = None
        elle.check_cycles(graph, accelerator="gpu")
        list_append.check(elle_history(50_000, crossed_pairs=50, wide=True),
                          accelerator="gpu")
    calls = rec.calls
    (ts, td, tv, tn, _), = calls["scc_trim"]
    out = {"global_path_input": ("scc_trim", tuple(
        x.cpu().numpy() for x in (ts, td, tv)) + (tn,))}

    def trim_case(n, src, dst):
        (s, d), valid = scc._padded((src, dst), len(src))
        return ("scc_trim", (s, d, valid, _bucket(n, floor=64)))
    out["chain_5000_capped"] = trim_case(5000, np.arange(4999),
                                         np.arange(1, 5000))
    out["random_64k_256k"] = trim_case(*random_trim_graph(16, 18, 42))
    out["random_512k_1m"] = trim_case(*random_trim_graph(19, 20, 42))
    for i, (cid, src, dst, B, V, _) in enumerate(
            calls["cluster_screen_host"]):
        out[f"wide_window_chunk{i}"] = ("cluster_screen",
                                        (cid, src, dst, B, V))
    out["chain_clusters_v1024"] = ("cluster_screen", (
        *chain_clusters(16, 1024, 42 + 1024, False), 16, 1024))
    return out


def trim_caller(entry, earlier, src, dst, valid, n):
    """A no-argument call of a trim entry as its wrapper makes it; returns
    (call, results)."""
    import torch
    E = src.numel()
    active = torch.empty(n, dtype=torch.uint8, device="cuda")
    if earlier:
        scratch = torch.zeros(2 * n, dtype=torch.int32, device="cuda")
    else:
        scratch = torch.empty(7 * n + 2 * E + 8, dtype=torch.int32,
                              device="cuda")
    flags = torch.zeros(8, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        if earlier:
            scratch.zero_()
            flags.zero_()
        rc = entry(src.data_ptr(), dst.data_ptr(), valid.data_ptr(),
                   active.data_ptr(), scratch.data_ptr(), flags.data_ptr(),
                   E, n, 512, stream)
        if rc != 0:
            raise RuntimeError(f"scc_trim: CUDA error {rc}")
    return call, lambda: (active.clone(), int(flags[3]),
                          None if earlier else flags[4:6].tolist())


def screen_caller(entry, earlier, cid, src, dst, B, V, presorted=False):
    """A no-argument call of a screen entry as its wrapper makes it (the
    earlier one with its sort; with ``presorted`` the sort is done once
    outside the call); returns (call, results)."""
    import torch
    valid = torch.ones(cid.numel(), dtype=torch.bool, device="cuda")
    out = torch.empty(B, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    if earlier:
        def prep():
            cid_s, order = torch.sort(cid, stable=True)
            offs = torch.searchsorted(
                cid_s, torch.arange(B + 1, dtype=torch.int32,
                                    device="cuda")).to(torch.int32)
            return (src[order].contiguous(), dst[order].contiguous(),
                    valid[order].contiguous(), offs)
        ready = prep() if presorted else None

        def call():
            s, d, ok, offs = ready if presorted else prep()
            rc = entry(s.data_ptr(), d.data_ptr(), ok.data_ptr(),
                       offs.data_ptr(), out.data_ptr(), B, V, stream)
            if rc != 0:
                raise RuntimeError(f"cluster_screen: CUDA error {rc}")
        return call, lambda: (out.clone(), None)
    scratch = torch.empty(2 * B + cid.numel() + 3, dtype=torch.int32,
                          device="cuda")

    def call():
        rc = entry(cid.data_ptr(), src.data_ptr(), dst.data_ptr(), None,
                   out.data_ptr(), scratch.data_ptr(), cid.numel(), B, V,
                   stream)
        if rc != 0:
            raise RuntimeError(f"cluster_screen: CUDA error {rc}")
    return call, lambda: (out.clone(), scratch[:2].tolist())


def timed(call, reps: int) -> float:
    import torch
    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run_case(entries, earlier, kernel, args, reps: int) -> dict:
    import numpy as np
    import torch
    if kernel == "scc_trim":
        src, dst, valid, n = args
        cols = [torch.from_numpy(np.asarray(x)).cuda()
                for x in (src.astype(np.int32), dst.astype(np.int32),
                          valid.astype(bool))]
        callers = {label: trim_caller(entries[label, kernel],
                                      earlier[label], *cols, n)
                   for label in ("other", "this")}
        info = {"nodes": n, "edges": int(valid.sum())}
    else:
        cid, src, dst, B, V = args
        cols = [torch.from_numpy(np.asarray(x, np.int32)).cuda()
                for x in (cid, src, dst)]
        callers = {label: screen_caller(entries[label, kernel],
                                        earlier[label], *cols, B, V)
                   for label in ("other", "this")}
        info = {"B": B, "V": V, "edges": len(cid)}
    res = {}
    for label, (call, result) in callers.items():
        call()
        torch.cuda.synchronize()
        res[label] = result()
    (o, *o_rest), (t, *t_rest) = res["other"], res["this"]
    if not torch.equal(o, t) or (kernel == "scc_trim"
                                 and o_rest[0] != t_rest[0]):
        raise AssertionError(f"{kernel} {info}: the builds differ")
    times = {"other": [], "this": []}
    for label in ("other", "this", "this", "other"):
        times[label].append(timed(callers[label][0], reps))
    row = {"kernel": kernel, **info, "other_ms": times["other"],
           "this_ms": times["this"], "work": t_rest[-1]}
    if kernel == "scc_trim":
        row.update(steps=t_rest[0], residue=int(t.sum()))
    else:
        row["flagged"] = int(t.sum())
        if earlier["other"]:
            entry_call, _ = screen_caller(entries["other", kernel], True,
                                          *cols, B, V, presorted=True)
            row["other_entry_ms"] = timed(entry_call, reps)
    return row


def round_inputs(src, dst, n, seed=42):
    """One of four shards of the edges ``(src, dst)`` on ``n`` nodes, on
    the card, with a seeded mask and weights: (src, dst, w, active)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    E = len(src) // 4
    cols = [torch.from_numpy(np.asarray(x[:E], np.int32)).cuda()
            for x in (src, dst)]
    w = torch.from_numpy((rng.random(E) < 0.95).astype(np.int32)).cuda()
    active = torch.from_numpy(rng.random(n) < 0.7).cuda()
    return (*cols, w, active)


def round_callers(fns, earlier, src, dst, w, active):
    """{"partial": (call, result), "update": (call, result)} of one build
    of ``trim_degrees.cu``, each entry called as its own wrapper calls it
    (``fns``: its two C entries); the update on the rows this build's
    degree pass leaves, its inputs restored before each call."""
    import torch
    from jepsen_tpu_torch.ops import scc_kernels as sk
    partial, update = fns
    n, E = active.numel(), src.numel()
    stream = torch.cuda.current_stream().cuda_stream
    bits = sk.pack_mask(active)
    bits_out = bits.clone()
    kept = torch.zeros((2, n), dtype=torch.int32, device="cuda")
    last = {}

    def call_partial():
        if earlier:
            out = torch.empty((2, n), dtype=torch.int32, device="cuda")
            rc = partial(src.data_ptr(), dst.data_ptr(), w.data_ptr(),
                         active.data_ptr(), E, n, out[0].data_ptr(),
                         out[1].data_ptr(), stream)
        else:
            out = kept
            rc = partial(src.data_ptr(), dst.data_ptr(), w.data_ptr(),
                         bits.data_ptr(), E, n, out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"trim_partial_degrees: CUDA error {rc}")
        last["deg"] = out

    kept.zero_()
    call_partial()
    rows = last["deg"].clone()
    deg, act = rows.clone(), active.clone()
    flags = torch.zeros(2, dtype=torch.int32, device="cuda")

    def restore():
        deg.copy_(rows)
        act.copy_(active)
        flags.zero_()

    def call_update():
        restore()
        if earlier:
            changed = torch.empty(1, dtype=torch.int32, device="cuda")
            rc = update(deg[0].data_ptr(), deg[1].data_ptr(),
                        act.data_ptr(), n, changed.data_ptr(), stream)
        else:
            changed = flags[:1]
            rc = update(deg.data_ptr(), None, 0, act.data_ptr(),
                        bits_out.data_ptr(), n, flags.data_ptr(), 0, stream)
        if rc != 0:
            raise RuntimeError(f"trim_update: CUDA error {rc}")
        last["changed"] = changed

    def update_result():
        call_update()
        torch.cuda.synchronize()
        return act.clone(), int(last["changed"].item())
    return {"partial": (call_partial, lambda: rows),
            "update": (call_update, update_result), "restore": restore}


def run_round_cases(entries, earlier, cases, reps: int):
    """Both builds' ``trim_degrees`` entries on each case: one JSON row
    per case and entry."""
    from jepsen_tpu_torch.ops.compare_common import device_ms, in_turns
    for case, (src, dst, n) in cases.items():
        inputs = round_inputs(src, dst, n)
        callers = {label: round_callers(entries[label], earlier[label],
                                        *inputs) for label in entries}
        for entry, kernel in (("partial", "partial_degrees"),
                              ("update", "update_mask")):
            res = {label: c[entry][1]() for label, c in callers.items()}
            o, t = res["other"], res["this"]
            same = (o[0].equal(t[0]) and o[1] == t[1]
                    if entry == "update" else o.equal(t))
            if not same:
                raise AssertionError(f"trim_degrees {entry} {case}: the "
                                     "builds differ")
            times = in_turns(lambda label: callers[label][entry][0](),
                             entries, reps)
            row = {"kernel": f"trim_degrees.{entry}", "case": case,
                   "nodes": n, "edges": inputs[0].numel(),
                   "other_ms": times["other"], "this_ms": times["this"],
                   **{f"{label}_kernel_ms": device_ms(
                       callers[label][entry][0], kernel)
                      for label in entries}}
            if entry == "update":
                row["restore_ms"] = in_turns(
                    lambda label: callers[label]["restore"](), ("this",),
                    reps)["this"]
                row["removed"] = int(inputs[3].sum()) - int(
                    res["this"][0].sum())
            print(json.dumps(row), flush=True)


def main(argv) -> int:
    import torch
    from jepsen_tpu_torch.ops import _build
    from jepsen_tpu_torch.ops.frontier_compare import build
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("elle_compare: no CUDA device", file=sys.stderr)
        return 1
    roots = {"other": argv[0], "this": Path(__file__).resolve().parents[2]}
    earlier = {(label, name): earlier_design(root, name)
               for label, root in roots.items() for name in NAMES}
    out_dir = _build.BUILD_DIR / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    entries = build(roots, out_dir, NAMES, {
        key: EARLIER_SCREEN for key, old in earlier.items()
        if old and key[1] == "cluster_screen"})
    inputs = recorded_inputs()
    for case, (kernel, args) in inputs.items():
        row = run_case(entries, {label: earlier[label, kernel]
                                 for label in roots}, kernel, args, reps=10)
        print(json.dumps({"case": case, **row}), flush=True)
    if all(_source(root, "trim_degrees").exists() for root in roots.values()):
        run_round_cases(*round_entries(roots, out_dir), round_cases(inputs),
                        reps=50)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


def round_entries(roots, out_dir):
    """Both builds' (partial, update) C entries of ``trim_degrees.cu`` and
    whether each has the earlier contract."""
    import ctypes as ct
    from jepsen_tpu_torch.ops import _build
    from jepsen_tpu_torch.ops.frontier_compare import build
    earlier = {label: earlier_design(root, "trim_degrees")
               for label, root in roots.items()}
    partial = build(roots, out_dir, ("trim_degrees",), {
        (label, "trim_degrees"): EARLIER_PARTIAL
        for label, old in earlier.items() if old})
    entries = {}
    for label in roots:
        fn_name, argtypes = (EARLIER_UPDATE if earlier[label]
                             else _build.UPDATE_SIGNATURES["trim_degrees"])
        fn = getattr(ct.CDLL(str(partial[label, "trim_degrees"].lib_path)),
                     fn_name)
        fn.argtypes, fn.restype = argtypes, ct.c_int
        entries[label] = (partial[label, "trim_degrees"], fn)
    return entries, earlier


def round_cases(inputs) -> dict:
    """{case: (src, dst, n)}: the 2^19-node graph of 2^20 edges and the
    global path's recorded valid edges."""
    from jepsen_tpu_torch.histories import random_trim_graph
    src, dst, valid, n = inputs["global_path_input"][1]
    n_r, src_r, dst_r = random_trim_graph(19, 20, 42)
    return {"random_512k_1m": (src_r, dst_r, n_r),
            "global_path_input": (src[valid], dst[valid], n)}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
