"""The anomaly-forensics kernels: wrappers around the hand-written Hopper
kernels ``csrc/prefix_alive.cu`` and ``csrc/window_rescan.cu``, and their
plain torch versions.

Both replace parts of the reference's ``_build_forensics_kernel``
(jepsen_tpu/ops/jitlin.py:1584), which ``jitlin.matrix_localize`` and the
witness shrink (``checker/explain.py``) drive:

* :func:`prefix_alive` — the first dead prefix of a chain of chunk
  products (``prefix_alive``, jitlin.py:1623), as the frontier at every
  chunk's entry, bit-packed;
* :func:`window_rescan` — one chunk's returns applied to a frontier
  vector for each of K candidates (``vec_batch``, jitlin.py:1640-1665):
  the first dead return and the inexact flag a candidate. A caller that
  rescans one chunk for several candidate batches (the witness shrink)
  derives the chunk's operands once (:class:`RescanChunk`) and launches
  with :func:`window_rescan_chunk`.

Every value here is boolean, so kernel and plain version agree bit for
bit. A wrapper takes its plain version only for tensors that lie on the
CPU; for CUDA tensors it launches its kernel or raises, and it never
falls back. Each kernel's launches are counted in a plain int attribute
(``prefix_alive.launches``, ``window_rescan.launches``). Neither wrapper
reads anything back from the card: the rescan kernel marks an op id or
slot out of range in ``first`` (:data:`RESCAN_BAD`), and
:func:`read_first`, the readers' way to the host, raises on it.

A packed frontier holds configuration i (= mask * V + state) as bit
i % 32 of word i // 32, in int32 words (the bits of uint32 words); W =
ceil(MV / 32).
"""
from __future__ import annotations

import torch

from jepsen_tpu_torch.ops.matrix_kernels import (
    _aligned, _check_launch, _is_pow2, _ptr, _stream)

# prefix_alive takes every operator dimension matrix_ok admits: 2^8
# masks x 16 states
PREFIX_MAX_MV = 4096
# window_rescan keeps a mask's states in one 32-bit word and a mask a
# thread of a 256-thread CTA; up to 5 slots (32 masks) a candidate is a
# warp, a mask a lane (csrc/window_rescan.cu kWarpMaxSlots)
RESCAN_MAX_SLOTS = 8
RESCAN_MAX_V = 32
RESCAN_WARP_MAX_SLOTS = 5
# first[k] of a candidate that met an op id or a valid return's slot out
# of range (csrc/window_rescan.cu kRescanBad)
RESCAN_BAD = -2


def _words(MV: int) -> int:
    return (MV + 31) // 32


_POW2: dict = {}


def _pow2(device) -> torch.Tensor:
    """[32] int32: bit i's value as an int32 (2^31 as -2^31), so that the
    int32 sum of a word's distinct bits is exact."""
    key = str(device)
    t = _POW2.get(key)
    if t is None:
        t = torch.tensor([1 << i for i in range(31)] + [-(1 << 31)],
                         dtype=torch.int32, device=device)
        _POW2[key] = t
    return t


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """[..., MV] 0/1 -> [..., W] int32 words, bit i % 32 of word i // 32
    set when x[..., i] > 0."""
    MV = x.shape[-1]
    W = _words(MV)
    b = (x > 0).to(torch.int32)
    if MV > 32 and W * 32 != MV:
        b = torch.nn.functional.pad(b, (0, W * 32 - MV))
    n = min(MV, 32)
    b = b.reshape(*x.shape[:-1], W, n)
    return (b * _pow2(x.device)[:n]).sum(dim=-1, dtype=torch.int32)


def unpack_bits(words: torch.Tensor, MV: int) -> torch.Tensor:
    """[..., W] int32 words -> [..., MV] bool, the inverse of
    :func:`pack_bits`."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    b = ((words.to(torch.int64) & 0xFFFFFFFF)[..., None] >> shifts) & 1
    return b.reshape(*words.shape[:-1], -1)[..., :MV].to(torch.bool)


# ---------------------------------------------------------------------------
# prefix_alive
# ---------------------------------------------------------------------------

def prefix_alive(P, v0):
    """The frontier through a chain of chunk products.

    P [C, MV, MV] 0/1 (bf16 on the card; an entry counts when > 0), v0
    [MV] 0/1 -> (alive [C] bool, w [C + 1, W] int32 words) with w[0] =
    v0, w[c + 1] = (P[c] @ w[c] > 0) and alive[c] = any(w[c + 1]): the
    later chunk applies on the left, as ``_kernel_math.make_step``
    composes. ``alive`` is the reference's ``prefix_alive`` verdict and
    w[c] its ``prefix[c - 1] @ v0 > 0`` (jitlin.py:1623-1636, 1769-1775).
    On the card one launch packs each chunk transposed over every SM
    and one CTA, or one thread-block cluster, chains the frontier
    (``csrc/prefix_alive.cu``; :func:`prefix_plan` says which)."""
    if P.device.type == "cpu":
        return prefix_alive_torch(P, v0)
    if P.device.type != "cuda":
        raise ValueError(f"prefix_alive: unsupported device {P.device}")
    if P.dim() != 3 or P.shape[1] != P.shape[2]:
        raise ValueError(f"prefix_alive: P must be [C, MV, MV], got "
                         f"{tuple(P.shape)}")
    C, MV, _ = P.shape
    if tuple(v0.shape) != (MV,):
        raise ValueError(f"prefix_alive: v0 {tuple(v0.shape)} against "
                         f"MV = {MV}")
    if not _is_pow2(MV) or not 8 <= MV <= PREFIX_MAX_MV:
        raise ValueError(f"prefix_alive: MV={MV} outside the kernel (a "
                         f"power of two, 8 <= MV <= {PREFIX_MAX_MV})")
    if v0.device != P.device:
        raise ValueError("prefix_alive: inputs on different devices")
    dev = P.device
    W = _words(MV)
    alive = torch.empty((C,), dtype=torch.int32, device=dev)
    w = torch.empty((C + 1, W), dtype=torch.int32, device=dev)
    if C == 0:
        w.copy_(pack_bits(v0)[None])
        return alive.to(torch.bool), w
    # the pack reads bf16 rows with 16-byte loads
    Pb = _aligned(P.to(torch.bfloat16).contiguous())
    v0w = pack_bits(v0).contiguous()
    ws = torch.empty((C * MV * W,), dtype=torch.int32, device=dev)
    from jepsen_tpu_torch.ops import _build
    lib = _build.library("prefix_alive")
    with torch.cuda.device(dev):
        rc = lib.jt_prefix_alive(_ptr(Pb), _ptr(v0w), _ptr(alive), _ptr(w),
                                 _ptr(ws), C, MV, _stream(dev))
    _check_launch(rc, "prefix_alive")
    prefix_alive.launches += 1
    return alive.to(torch.bool), w


prefix_alive.launches = 0


def prefix_plan(C: int, MV: int, entry=None) -> dict:
    """The chain's launch plan at (C, MV), from the C entry
    ``jt_prefix_alive_plan`` (this checkout's build, or ``entry``):
    ``design`` "warp" (one warp chains from a ring of shared-memory
    stages that a second warp keeps filled), "ring" (a cluster's CTAs,
    each its slice of the columns from such a ring) or "global" (a
    cluster's CTAs read their slices from global memory), the CTAs a
    cluster, the stages, threads a CTA and columns a thread, the partial
    frontiers a CTA writes a step and its dynamic shared bytes."""
    import ctypes
    if entry is None:
        from jepsen_tpu_torch.ops import _build
        entry = _build.library("prefix_alive").jt_prefix_alive_plan
    out = (ctypes.c_int32 * 6)()
    rc = entry(C, MV, ctypes.cast(out, ctypes.c_void_p))
    _check_launch(rc, "prefix_alive plan")
    nc, stages, threads, cols, nslot, smem = out
    design = "warp" if nslot == 0 else "ring" if stages else "global"
    return {"design": design, "cluster": nc,
            "stages": stages, "threads": threads, "cols_per_thread": cols,
            "slots": nslot, "smem_bytes": smem}


def prefix_alive_torch(P, v0):
    """Plain torch version of :func:`prefix_alive`: C float32
    matrix-vector products with a > 0 threshold after each (counts <=
    4096 are exact)."""
    w = (v0 > 0).to(torch.float32)
    ws = [w]
    for c in range(P.shape[0]):
        w = (torch.mv((P[c] > 0).to(torch.float32), w) > 0).to(
            torch.float32)
        ws.append(w)
    frontiers = torch.stack(ws)
    return frontiers[1:].any(dim=1), pack_bits(frontiers)


# ---------------------------------------------------------------------------
# window_rescan
# ---------------------------------------------------------------------------

def window_rescan(pend, valid, ids, mtT, oob, slots, v):
    """Each candidate's first dead return over one chunk.

    pend [K, T, S] 0/1 and valid [K, T] 0/1 (a candidate's masks), ids
    [T, S] int (indices into mtT), mtT [U, V, V] 0/1 (mtT[u, w, v]: v ->
    w, the chunk product's table), oob [U] bool (the op has a transition
    leaving [0, V)), slots [T] int in [0, S), v [MV] 0/1 with MV = 2^S V
    -> (first [K] int32, inexact [K] bool): first[k] the first return
    after which no configuration reachable from v is alive (-1: none),
    inexact[k] whether a valid return has a pending op flagged in oob —
    the reference's ``vec_batch`` (jitlin.py:1640-1665). On the card the
    chunk's operands are derived (:class:`RescanChunk`) and one launch
    rescans every candidate (``csrc/window_rescan.cu``); an op id or a
    valid return's slot out of range gives ``first`` = :data:`RESCAN_BAD`,
    on which :func:`read_first` raises. On the CPU it raises here."""
    return window_rescan_chunk(pend, valid,
                               RescanChunk(ids, mtT, oob, slots, v))


window_rescan.launches = 0


class RescanChunk:
    """One chunk's rescan operands, derived once for any number of
    candidate batches: the arguments of :func:`window_rescan` past the
    masks, and on the card the kernel's forms of them — ids and slots
    int32, the op words ``nxt`` [U, V] (bit w of nxt[u, v]: v -> w), oob
    as bytes and the start frontier packed (``vw``, :func:`pack_bits`, or
    ``v_words`` where the caller has v packed). Nothing is read back."""

    def __init__(self, ids, mtT, oob, slots, v, v_words=None):
        if ids.dim() != 2 or mtT.dim() != 3:
            raise ValueError(f"window_rescan: ids [T, S] and mtT [U, V, V], "
                             f"got {tuple(ids.shape)} {tuple(mtT.shape)}")
        T, S = ids.shape
        U, V = mtT.shape[0], mtT.shape[1]
        if not 1 <= S <= RESCAN_MAX_SLOTS or not 1 <= V <= RESCAN_MAX_V:
            raise ValueError(f"window_rescan: S={S}, V={V} outside the "
                             f"kernel (S <= {RESCAN_MAX_SLOTS}, V <= "
                             f"{RESCAN_MAX_V})")
        if (tuple(mtT.shape) != (U, V, V) or tuple(oob.shape) != (U,)
                or tuple(slots.shape) != (T,)
                or tuple(v.shape) != ((1 << S) * V,)):
            raise ValueError("window_rescan: inconsistent shapes "
                             f"{tuple(ids.shape)} {tuple(mtT.shape)} "
                             f"{tuple(oob.shape)} {tuple(slots.shape)} "
                             f"{tuple(v.shape)}")
        self.device = ids.device
        for x in (mtT, oob, slots, v):
            if x.device != self.device:
                raise ValueError("window_rescan: inputs on different "
                                 "devices")
        if T == 0:
            raise ValueError("window_rescan: a chunk of no returns")
        self.T, self.S, self.V, self.U = T, S, V, U
        self.ids, self.mtT, self.oob, self.slots, self.v = (
            ids, mtT, oob, slots, v)
        if self.device.type == "cuda":
            self.ids = ids.to(torch.int32).contiguous()
            self.slots = slots.to(torch.int32).contiguous()
            # bit w of nxt[u, v]: mtT[u, w, v] > 0 (V <= 32: one word)
            self.nxt = torch.where(mtT > 0, _pow2(mtT.device)[:V, None],
                                   0).sum(dim=1, dtype=torch.int32)
            self.oob8 = _bytes(oob)
            self.vw = (pack_bits(v) if v_words is None
                       else v_words.to(torch.int32)).contiguous()


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """A 0/1 tensor as contiguous uint8 bytes (a view of a bool one)."""
    x = x if x.dtype == torch.bool else x > 0
    return x.contiguous().view(torch.uint8)


def rescan_entry_operands(pend, valid, chunk: RescanChunk):
    """The rescan kernel's inputs in the order of the C entry
    ``jt_window_rescan``: pend and valid as bytes, then the chunk's ids,
    slots, op words, oob bytes and packed start."""
    return (_bytes(pend), _bytes(valid), chunk.ids, chunk.slots, chunk.nxt,
            chunk.oob8, chunk.vw)


def window_rescan_chunk(pend, valid, chunk: RescanChunk):
    """:func:`window_rescan` of the candidates' masks pend [K, T, S] and
    valid [K, T] over a chunk whose operands are derived: one launch on
    the card, nothing read back."""
    if pend.dim() != 3 or tuple(pend.shape[1:]) != (chunk.T, chunk.S) \
            or tuple(valid.shape) != tuple(pend.shape[:2]):
        raise ValueError(f"window_rescan: masks {tuple(pend.shape)} "
                         f"{tuple(valid.shape)} against T = {chunk.T}, "
                         f"S = {chunk.S}")
    if pend.device.type == "cpu" and chunk.device.type == "cpu":
        val = valid > 0
        if bool(((chunk.ids < 0) | (chunk.ids >= chunk.U)).any()
                | (val & ((chunk.slots < 0)
                          | (chunk.slots >= chunk.S))[None]).any()):
            raise ValueError("window_rescan: an op id or slot out of range")
        # an invalid return's slot is never read; the plain version
        # indexes with every slot
        return window_rescan_torch(pend, valid, chunk.ids, chunk.mtT,
                                   chunk.oob,
                                   chunk.slots.clamp(0, chunk.S - 1),
                                   chunk.v)
    if pend.device.type != "cuda":
        raise ValueError(f"window_rescan: unsupported device {pend.device}")
    if pend.device != chunk.device or valid.device != chunk.device:
        raise ValueError("window_rescan: inputs on different devices")
    K = pend.shape[0]
    dev = pend.device
    first = torch.empty((K,), dtype=torch.int32, device=dev)
    inexact = torch.empty((K,), dtype=torch.uint8, device=dev)
    if K == 0:
        return first, inexact.view(torch.bool)
    operands = rescan_entry_operands(pend, valid, chunk)
    from jepsen_tpu_torch.ops import _build
    lib = _build.library("window_rescan")
    with torch.cuda.device(dev):
        rc = lib.jt_window_rescan(*(_ptr(x) for x in operands), _ptr(first),
                                  _ptr(inexact), K, chunk.T, chunk.S,
                                  chunk.V, chunk.U, _stream(dev))
    _check_launch(rc, "window_rescan")
    window_rescan.launches += 1
    return first, inexact.view(torch.bool)


def read_first(first: torch.Tensor):
    """``first`` of :func:`window_rescan` on the host (numpy int32);
    raises ValueError where the kernel met an op id or slot out of
    range."""
    out = first.cpu().numpy()
    if (out == RESCAN_BAD).any():
        raise ValueError("window_rescan: an op id or slot out of range")
    return out


def window_rescan_torch(pend, valid, ids, mtT, oob, slots, v):
    """Plain torch version of :func:`window_rescan`: the K candidates as
    the batch of ``_kernel_math.make_step``, the frontier a [K, MV, 1]
    matrix, in float32 with a > 0 threshold after every product — the
    reference's ``_vec_scan`` with the vmap written out."""
    from jepsen_tpu_torch.ops.jitlin import _kernel_math

    K, T, S = pend.shape
    V = mtT.shape[1]
    dev = pend.device
    math = _kernel_math(S, V, None, K, dev)
    step = math.make_step((mtT > 0).to(torch.float32).transpose(1, 2),
                          (oob > 0).to(dev))
    P = (v > 0).to(torch.float32).reshape(1, math.MV, 1).expand(
        K, math.MV, 1)
    inexact = torch.zeros((K,), dtype=torch.bool, device=dev)
    alive = []
    for t in range(T):
        P, inexact = step((P, inexact),
                          (pend[:, t] > 0, ids[t][None].expand(K, S),
                           slots[t].reshape(1).expand(K),
                           valid[:, t] > 0))
        alive.append((P[:, :, 0] > 0).any(dim=1))
    alive = torch.stack(alive, dim=1)                    # [K, T]
    dead = ~alive
    first = torch.where(dead.any(dim=1),
                        dead.to(torch.int32).argmax(dim=1).to(torch.int32),
                        torch.full((K,), -1, dtype=torch.int32,
                                   device=dev))
    return first, inexact
