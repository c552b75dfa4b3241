"""The set-full classify (BASELINE config 4): a wrapper around the
hand-written Hopper kernel ``csrc/set_classify.cu`` and its plain torch
version (jepsen_tpu/ops/setscan.py).

A history becomes a reads x elements membership matrix, bit-packed
(bit j of word w of a row is element 32 w + j), plus the reads' invoke
times and each element's add-invoke and add-ok times. Every element's
verdict (stable, lost or never-read), whether a read saw it stale, and
its visibility latency are masked min/max reductions over the matrix's
rows, for all elements at once.

Times are float64: the reference's float32 cannot tell two nanosecond
times about 8 us apart near 100 s. The kernel walks the rows in time
order, so each call also gives it ``order``, the rows' indices sorted
stably by read time (:func:`read_order`): the host entry sorts with
numpy and uploads the order with the other columns; the tensor wrapper
sorts on the tensors' device. The wrapper takes the plain version only
for tensors on the CPU; for CUDA tensors it makes one C call, which
enqueues one launch, or raises. Shapes are not bucketed: the kernel
needs no compile cache.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from jepsen_tpu_torch.ops.matrix_kernels import _check_launch, _ptr, _stream

# copied from jepsen_tpu/ops/setscan.py:24
STABLE, LOST, NEVER_READ = 0, 1, 2

# the plain version unpacks at most this many cells at a time
PLAIN_MAX_CELLS = 1 << 24

# the calling thread's last classify_elements: seconds of each phase
_LAST = threading.local()


def last_kernel_seconds() -> float:
    """The kernel's time in the calling thread's last
    :func:`classify_elements` call: CUDA-event time on the card, the
    plain version's host time on the CPU."""
    return last_phase_seconds().get("kernel", 0.0)


def last_phase_seconds() -> dict:
    """The calling thread's last :func:`classify_elements` call, in
    seconds: ``pack`` (host clock: packing into the pinned buffer),
    ``upload``, ``kernel`` and ``readback`` (CUDA events on the card)."""
    return dict(getattr(_LAST, "value", {}))


def n_words(n_elements: int) -> int:
    return (n_elements + 31) // 32


def pack_member(member: np.ndarray) -> np.ndarray:
    """bool [R, E] -> int32 [R, ceil(E / 32)]: bit j of word w is element
    32 w + j (little-endian ``packbits`` bytes, padded to whole words)."""
    R, E = member.shape
    packed = np.zeros((R, 4 * n_words(E)), dtype=np.uint8)
    packed[:, :(E + 7) // 8] = np.packbits(member, axis=1, bitorder="little")
    return packed.view("<i4")


def kernel_bytes(n_reads: int, n_elements: int) -> int:
    """The bytes the function must move: the packed words, the read
    times and the element columns in (4 R W + 8 R + 17 E), the code,
    stale flag and latency out (13 E)."""
    return 4 * n_reads * n_words(n_elements) + 8 * n_reads + 30 * n_elements


def read_order(t_read):
    """The rows' indices sorted stably by read time (tied rows keep their
    order), int32: numpy in, numpy out; a tensor in, a tensor on its
    device out."""
    if isinstance(t_read, torch.Tensor):
        return torch.argsort(t_read, stable=True).to(torch.int32)
    return np.argsort(np.asarray(t_read, np.float64),
                      kind="stable").astype(np.int32)


def _check_inputs(words, t_read, invoke_t, ok_t, has_ok, n_elements: int):
    R = words.shape[0] if words.ndim == 2 else -1
    if not (words.ndim == 2 and R >= 1
            and words.shape[1] == n_words(n_elements)
            and tuple(t_read.shape) == (R,)
            and tuple(invoke_t.shape) == tuple(ok_t.shape)
            == tuple(has_ok.shape) == (n_elements,)):
        raise ValueError(
            f"set_classify: words [R >= 1, ceil(E / 32)], t_read [R] and "
            f"the element columns [E] with E = {n_elements}; got "
            f"{tuple(words.shape)}, {tuple(t_read.shape)}, "
            f"{tuple(invoke_t.shape)}, {tuple(ok_t.shape)}, "
            f"{tuple(has_ok.shape)}")


def _launch(words, t_read, invoke_t, ok_t, has_ok, n_elements: int,
            order=None):
    """One C call on CUDA tensors: uint8 [13 E] on the card holding
    latency f64 [E], code int32 [E] and stale uint8 [E], in that order.
    ``order`` is :func:`read_order` of ``t_read``, made here when not
    given."""
    dev = words.device
    if order is None:
        order = read_order(t_read)
    cols = (words, t_read, order, invoke_t, ok_t, has_ok)
    want = (torch.int32, torch.float64, torch.int32, torch.float64,
            torch.float64, torch.uint8)
    for x, dt in zip(cols, want):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"set_classify: columns must be contiguous "
                             f"{[str(d) for d in want]} on {dev}, got "
                             f"{[(str(c.dtype), str(c.device)) for c in cols]}")
    E = n_elements
    out = torch.empty((13 * E,), dtype=torch.uint8, device=dev)
    if E == 0:
        return out
    code, stale, latency = _split(out, E)
    from jepsen_tpu_torch.ops import _build
    lib = _build.library("set_classify")
    rc = lib.jt_set_classify(*(_ptr(x) for x in cols), _ptr(code),
                             _ptr(stale), _ptr(latency), words.shape[0],
                             words.shape[1], E, _stream(dev))
    _check_launch(rc, "set_classify")
    set_classify.launches += 1
    return out


def _split(out, E: int):
    """(code int32, stale uint8, latency f64) views of a [13 E] buffer."""
    return (out[8 * E:12 * E].view(torch.int32), out[12 * E:],
            out[:8 * E].view(torch.float64))


def set_classify(words, t_read, invoke_t, ok_t, has_ok, n_elements: int):
    """Each element's set-full verdict.

    words int32 [R, ceil(E / 32)] (the packed membership matrix; R >= 1),
    t_read f64 [R] (each read's invoke time), invoke_t and ok_t f64 [E],
    has_ok bool or uint8 [E] -> (code int32 [E], stale bool [E], latency
    f64 [E]), what jepsen_tpu/ops/setscan.py:72-104 computes: code 0
    stable, 1 lost, 2 never-read; latency is meaningful where code is
    stable. Times must be finite. On the card one C call of
    ``csrc/set_classify.cu``, counted in ``set_classify.launches``,
    after :func:`read_order` sorts the rows on the card."""
    _check_inputs(words, t_read, invoke_t, ok_t, has_ok, n_elements)
    if words.device.type == "cpu":
        return classify_plain(words, t_read, invoke_t, ok_t, has_ok,
                              n_elements)
    if words.device.type != "cuda":
        raise ValueError(f"set_classify: unsupported device {words.device}")
    code, stale, latency = _split(
        _launch(words, t_read, invoke_t, ok_t, has_ok.view(torch.uint8),
                n_elements), n_elements)
    return code, stale.view(torch.bool), latency


set_classify.launches = 0


def classify_plain(words, t_read, invoke_t, ok_t, has_ok, n_elements: int,
                   max_cells: int = PLAIN_MAX_CELLS):
    """Plain torch version of :func:`set_classify`: the reductions of
    jepsen_tpu/ops/setscan.py:72-104 over the unpacked matrix, with
    float64 times and +-inf for the empty min and max, over tensors on
    ``words``' device, ``max_cells`` cells of the matrix at a time."""
    dev = words.device
    R, W = words.shape
    E = n_elements
    t = t_read.to(torch.float64)[:, None]
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    code = torch.empty((E,), dtype=torch.int32, device=dev)
    stale = torch.empty((E,), dtype=torch.bool, device=dev)
    latency = torch.empty((E,), dtype=torch.float64, device=dev)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
    step = max(1, max_cells // (32 * R))
    for w0 in range(0, W, step):
        e0, e1 = 32 * w0, min(E, 32 * (w0 + step))
        member = ((words[:, w0:w0 + step, None] >> shifts) & 1).reshape(
            R, -1)[:, :e1 - e0].bool()
        hok = has_ok[e0:e1].bool()
        first_seen = torch.where(member, t, inf).amin(dim=0)
        known = torch.where(hok, ok_t[e0:e1].to(torch.float64), first_seen)
        later = t >= known[None, :]
        any_later = later.any(dim=0)
        lp = torch.where(later & member, t, -inf).amax(dim=0)
        la = torch.where(later & ~member, t, -inf).amax(dim=0)
        has_present, has_absent = lp > -inf, la > -inf
        lost = has_absent & (~has_present | (la > lp))
        never_read = (known >= inf) | ~any_later
        c = torch.where(never_read, NEVER_READ,
                        torch.where(lost, LOST, STABLE)).to(torch.int32)
        code[e0:e1] = c
        stale[e0:e1] = (c == STABLE) & has_absent
        d = torch.where(has_absent, la, known) - invoke_t[e0:e1].to(
            torch.float64)
        latency[e0:e1] = torch.where(d > 0, d, torch.zeros_like(d))
    return code, stale, latency


def pinned_inputs(words, t_read, invoke_t, ok_t, has_ok):
    """Host classify inputs (``words`` packed) and their :func:`read_order`
    in one pinned uint8 buffer: t_read, invoke_t and ok_t (float64, so
    each stays 8-byte aligned), the words, the order, has_ok. Returns
    (buffer, the [7] byte offsets)."""
    cols = (np.asarray(t_read, np.float64), np.asarray(invoke_t, np.float64),
            np.asarray(ok_t, np.float64), np.asarray(words, np.int32),
            read_order(t_read), np.asarray(has_ok, np.uint8))
    offs = np.concatenate([[0], np.cumsum([a.nbytes for a in cols])])
    host = torch.empty((int(offs[-1]),), dtype=torch.uint8, pin_memory=True)
    h = host.numpy()
    for a, lo, hi in zip(cols, offs[:-1], offs[1:]):
        h[lo:hi] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    return host, offs.tolist()


def card_views(buf, offs, n_reads: int):
    """The :func:`set_classify` inputs (words, t_read, invoke_t, ok_t,
    has_ok) and the rows' order, as views of a copy of a
    :func:`pinned_inputs` buffer: (inputs, order)."""
    t_read, invoke_t, ok_t, words, order, has_ok = (
        buf[lo:hi] for lo, hi in zip(offs[:-1], offs[1:]))
    return ((words.view(torch.int32).view(n_reads, -1),
             t_read.view(torch.float64), invoke_t.view(torch.float64),
             ok_t.view(torch.float64), has_ok), order.view(torch.int32))


def classify_elements(member: np.ndarray, t_read: np.ndarray,
                      invoke_t: np.ndarray, ok_t: np.ndarray,
                      has_ok: np.ndarray, device=None):
    """Host arrays in, numpy (code int32 [E], stale bool [E], latency f64
    [E]) out, for E = len(invoke_t) elements (``member`` may carry padding
    columns past E). On the card the packed matrix and the columns go up
    in one pinned buffer with the rows' order, one kernel launch
    classifies every element, and the three results come back in one
    copy; ``device="cpu"`` runs the plain version. ``device`` None is the
    CUDA device."""
    from jepsen_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    E = len(invoke_t)
    R = member.shape[0]
    t0 = time.perf_counter()
    words = pack_member(np.asarray(member, dtype=bool)[:, :E])
    cols = (np.asarray(t_read, np.float64), np.asarray(invoke_t, np.float64),
            np.asarray(ok_t, np.float64))
    hok = np.asarray(has_ok, dtype=np.uint8)
    if dev.type == "cpu" or E == 0:
        t1 = time.perf_counter()
        code, stale, latency = set_classify(
            torch.from_numpy(words), *(torch.from_numpy(c) for c in cols),
            torch.from_numpy(hok), E)
        _LAST.value = {"pack": t1 - t0, "upload": 0.0,
                       "kernel": time.perf_counter() - t1, "readback": 0.0}
        return code.numpy(), stale.numpy(), latency.numpy()
    host, offs = pinned_inputs(words, *cols, hok)
    t1 = time.perf_counter()
    stream = torch.cuda.current_stream(dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record(stream)
    args, order = card_views(host.to(dev, non_blocking=True), offs, R)
    ev[1].record(stream)
    out = _launch(*args, E, order=order)
    ev[2].record(stream)
    back = torch.empty((13 * E,), dtype=torch.uint8, pin_memory=True)
    back.copy_(out, non_blocking=True)
    ev[3].record(stream)
    ev[3].synchronize()
    _LAST.value = {"pack": t1 - t0,
                   "upload": ev[0].elapsed_time(ev[1]) / 1e3,
                   "kernel": ev[1].elapsed_time(ev[2]) / 1e3,
                   "readback": ev[2].elapsed_time(ev[3]) / 1e3}
    b = back.numpy()
    return (b[8 * E:12 * E].view(np.int32).copy(),
            b[12 * E:].astype(bool), b[:8 * E].view(np.float64).copy())
