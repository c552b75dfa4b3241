"""Times this checkout's set-classify kernel against another checkout's,
on one CUDA card.

    python3 -m jepsen_tpu_torch.ops.set_compare OTHER_ROOT

OTHER_ROOT is the root of another checkout of the repo (for example an
earlier commit unpacked by ``git archive`` into a directory that
``.gitignore`` lists). ``set_classify.cu`` is built from both checkouts'
``jepsen_tpu_torch/ops/csrc`` with ``_build.NVCC_FLAGS`` (two ``nvcc``,
started together, into ``jepsen_tpu_torch/_build/compare``), and each C
entry is called directly on the card inputs of :func:`cases`, each case
with every element's add acknowledged (``known`` is the add-ok time: no
ascending scan) and with a seeded third of them unacknowledged. A build
whose entry takes no ``order`` (the rows' indices sorted by read time)
is called through that earlier signature. For each case both builds'
outputs (code, stale, latency) must equal each other and the plain
version's bit for bit; then each build is timed by CUDA events over
back-to-back calls, in the order other, this, this, other, and by
``torch.profiler`` (the kernel's device time alone, without the host's
dispatch between calls), and one JSON line gives both builds' timings,
the byte bound (``setscan.kernel_bytes`` at 3.35 TB/s) and each build's
share of it. One ``ptxas`` line a build gives the compiler's resource
report. The last line is the card's name and power limit as
``nvidia-smi`` prints them. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import re
import sys
from pathlib import Path

from jepsen_tpu_torch.ops.compare_common import (
    build, card_line, device_ms, in_turns)

PEAK_BYTES = 3.35e12
# the C entry before it took the rows' order: words, t_read, invoke_t,
# ok_t, has_ok, code, stale, latency, R, W, E, stream
_P, _I = ctypes.c_void_p, ctypes.c_int
ORDERLESS = ("jt_set_classify", [_P] * 8 + [_I] * 3 + [_P])


def takes_order(root) -> bool:
    """Whether the checkout's ``jt_set_classify`` takes ``order``."""
    src = (Path(root) / "jepsen_tpu_torch" / "ops" / "csrc" /
           "set_classify.cu").read_text()
    m = re.search(r'jt_set_classify\(([^)]*)\)', src)
    return bool(m and "order" in m.group(1))


def random_inputs(R: int, E: int, seed: int, ok_share: float = 0.67,
                  ties: int = 0):
    """Seeded classify inputs of chip_smoke.py's phase 10: random words
    (about a quarter of the bits set, padding bits past E too), float64
    read and add times of nanosecond size past 10^11, unsorted; each add
    acknowledged with probability ``ok_share``. ``ties`` > 0 draws the
    read times from that many values only."""
    import numpy as np
    rng = np.random.default_rng(seed)
    W = -(-E // 32)
    words = rng.integers(0, 1 << 32, (R, W), dtype=np.uint32)
    words &= rng.integers(0, 1 << 32, (R, W), dtype=np.uint32)
    if ties:
        t_read = 10 ** 11 + rng.integers(0, ties, R) * 10 ** 6
    else:
        t_read = 10 ** 11 + rng.integers(0, 10 ** 9, R)
    invoke_t = (10 ** 11 + rng.integers(0, 10 ** 9, E)).astype(np.float64)
    ok_t = invoke_t + rng.integers(0, 10 ** 6, E)
    has_ok = rng.random(E) < ok_share
    return (words.view(np.int32), t_read.astype(np.float64), invoke_t, ok_t,
            has_ok)


def config4_inputs(reverse: bool = False):
    """The set-full main path's classify inputs: config 4's valid
    history (20,000 elements, a read every 50 adds) as
    ``set_full_columns`` encodes it, packed; ``reverse`` lists the reads
    last first."""
    import numpy as np
    from jepsen_tpu_torch.histories import set_full_history
    from jepsen_tpu_torch.history_ir import views
    from jepsen_tpu_torch.ops import setscan
    enc = views.set_full_columns(set_full_history(20_000, 50))
    member, t_read = enc["member"], enc["read_t"]
    if reverse:
        member, t_read = member[::-1], t_read[::-1]
    return (setscan.pack_member(np.ascontiguousarray(member)),
            np.ascontiguousarray(t_read, np.float64), enc["invoke_t"],
            enc["ok_t"], enc["has_ok"])


def drop_oks(inputs, seed: int):
    """The inputs with a seeded third of the add-oks removed."""
    import numpy as np
    words, t_read, invoke_t, ok_t, has_ok = inputs
    keep = np.random.default_rng(seed).random(len(has_ok)) >= 1 / 3
    return words, t_read, invoke_t, ok_t, np.asarray(has_ok, bool) & keep


def cases():
    """(case, maker of host inputs, every add acknowledged):
    chip_smoke.py's four shapes and config 4's main-path inputs; config 4
    with its reads last first; 400 x 20,000 with the read times drawn
    from 8 values; a tall, narrow 4,096 x 96; and 400 reads at two and
    four times config 4's width."""
    return [
        ("random_1x1", lambda: random_inputs(1, 1, 100, 1.0)),
        ("random_7x33", lambda: random_inputs(7, 33, 101, 1.0)),
        ("random_400x20000", lambda: random_inputs(400, 20_000, 102, 1.0)),
        ("random_2048x262144",
         lambda: random_inputs(2048, 262_144, 103, 1.0)),
        ("config4_main_path", config4_inputs),
        ("config4_reversed", lambda: config4_inputs(reverse=True)),
        ("tied_400x20000",
         lambda: random_inputs(400, 20_000, 104, 1.0, ties=8)),
        ("tall_4096x96", lambda: random_inputs(4096, 96, 105, 1.0)),
        ("random_400x40000", lambda: random_inputs(400, 40_000, 106, 1.0)),
        ("random_400x80000", lambda: random_inputs(400, 80_000, 107, 1.0)),
    ]


def card_inputs(inputs):
    """Host inputs -> card tensors (words, t_read, order, invoke_t, ok_t,
    has_ok), ``order`` the rows' indices sorted stably by read time."""
    import numpy as np
    import torch
    words, t_read, invoke_t, ok_t, has_ok = inputs
    order = np.argsort(t_read, kind="stable").astype(np.int32)
    return [torch.from_numpy(np.ascontiguousarray(x)).to("cuda")
            for x in (words, t_read, order, invoke_t, ok_t,
                      np.asarray(has_ok, np.uint8))]


def run_case(entries, cols, E: int, reps: int) -> dict:
    """Both builds on the card inputs ``cols``: bit-equal to each other and
    to the plain version, then timed other, this, this, other."""
    import torch
    from jepsen_tpu_torch.ops import setscan
    words, t_read, order, invoke_t, ok_t, has_ok = cols
    R, W = words.shape
    stream = torch.cuda.current_stream().cuda_stream
    outs = {label: (torch.empty(E, dtype=torch.int32, device="cuda"),
                    torch.empty(E, dtype=torch.uint8, device="cuda"),
                    torch.empty(E, dtype=torch.float64, device="cuda"))
            for label in entries}

    # each build's arguments, made once, so that a timed call is the C
    # entry's launch alone
    call_args = {
        label: (*(x.data_ptr() for x in (
            (words, t_read, order, invoke_t, ok_t, has_ok) if fn.takes_order
            else (words, t_read, invoke_t, ok_t, has_ok)) + outs[label]),
            R, W, E, stream)
        for label, fn in entries.items()}

    def call(label):
        rc = entries[label](*call_args[label])
        if rc != 0:
            raise RuntimeError(f"{label} set_classify: CUDA error {rc}")

    for label in entries:
        call(label)
    want = setscan.classify_plain(words, t_read, invoke_t, ok_t, has_ok, E)
    torch.cuda.synchronize()
    for label, (code, stale, latency) in outs.items():
        if not (torch.equal(code, want[0])
                and torch.equal(stale.bool(), want[1])
                and torch.equal(latency, want[2])):
            raise AssertionError(f"{label} set_classify ({R} x {E}) differs "
                                 f"from the plain version")
    times = in_turns(call, entries, reps)
    nbytes = setscan.kernel_bytes(R, E)
    bound = nbytes / PEAK_BYTES * 1e3
    row = {"R": R, "E": E, "W": W, "acked": int(has_ok.sum()),
           "bytes": nbytes, "bound_ms": bound,
           "codes": torch.bincount(want[0], minlength=3).tolist(),
           "stale": int(want[1].sum())}
    for label in entries:
        t = times[label]
        ms = sum(t) / len(t)
        row.update({f"{label}_ms": t, f"{label}_share": bound / ms,
                    f"{label}_gbps": nbytes / ms / 1e6,
                    f"{label}_device_ms": device_ms(lambda: call(label),
                                                    "set_classify")})
    return row


def main(argv) -> int:
    import torch
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("set_compare: no CUDA device", file=sys.stderr)
        return 1
    from jepsen_tpu_torch.ops import _build
    out_dir = _build.BUILD_DIR / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    roots = {"other": argv[0], "this": Path(__file__).resolve().parents[2]}
    signatures = {(label, "set_classify"): ORDERLESS
                  for label, root in roots.items() if not takes_order(root)}
    built = build(roots, out_dir, ("set_classify",),
                  signatures=signatures)
    entries = {}
    for (label, _), fn in sorted(built.items()):
        fn.takes_order = (label, "set_classify") not in signatures
        entries[label] = fn
        print(json.dumps({"ptxas": label, "takes_order": fn.takes_order,
                          "report": fn.ptxas}), flush=True)
    for case, make in cases():
        base = make()
        for acked, inputs in (("all", base), ("two_thirds",
                                              drop_oks(base, 7))):
            cols = card_inputs(inputs)
            E = len(inputs[2])
            reps = 10 if cols[0].numel() > 1 << 22 else 50
            row = run_case(entries, cols, E, reps)
            print(json.dumps({"case": case, "add_oks": acked, **row}),
                  flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
