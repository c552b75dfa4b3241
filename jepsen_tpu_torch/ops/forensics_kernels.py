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
  the first dead return and the inexact flag a candidate.

Every value here is boolean, so kernel and plain version agree bit for
bit. A wrapper takes its plain version only for tensors that lie on the
CPU; for CUDA tensors it launches its kernel or raises, and it never
falls back. Each wrapper counts its kernel launches in a plain int
attribute (``prefix_alive.launches``, ``window_rescan.launches``).

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
# thread of a 256-thread CTA
RESCAN_MAX_SLOTS = 8
RESCAN_MAX_V = 32


def _words(MV: int) -> int:
    return (MV + 31) // 32


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """[..., MV] 0/1 -> [..., W] int32 words, bit i % 32 of word i // 32
    set when x[..., i] > 0."""
    MV = x.shape[-1]
    W = _words(MV)
    b = (x > 0).to(torch.int64)
    if W * 32 != MV:
        b = torch.nn.functional.pad(b, (0, W * 32 - MV))
    b = b.reshape(*x.shape[:-1], W, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    words = (b << shifts).sum(dim=-1)
    return torch.where(words >= (1 << 31), words - (1 << 32),
                       words).to(torch.int32)


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
    On the card one launch packs the chunks over every SM and one CTA
    chains the frontier (``csrc/prefix_alive.cu``)."""
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
    the reference's ``vec_batch`` (jitlin.py:1640-1665). On the card one
    CTA a candidate steps the frontier as a state set a mask in shared
    memory (``csrc/window_rescan.cu``)."""
    if pend.device.type == "cpu":
        return window_rescan_torch(pend, valid, ids, mtT, oob, slots, v)
    if pend.device.type != "cuda":
        raise ValueError(f"window_rescan: unsupported device {pend.device}")
    if pend.dim() != 3:
        raise ValueError(f"window_rescan: pend must be [K, T, S], got "
                         f"{tuple(pend.shape)}")
    K, T, S = pend.shape
    U, V = mtT.shape[0], mtT.shape[1]
    MV = (1 << S) * V
    if not 1 <= S <= RESCAN_MAX_SLOTS or not 1 <= V <= RESCAN_MAX_V:
        raise ValueError(f"window_rescan: S={S}, V={V} outside the kernel "
                         f"(S <= {RESCAN_MAX_SLOTS}, V <= {RESCAN_MAX_V})")
    if (tuple(valid.shape) != (K, T) or tuple(ids.shape) != (T, S)
            or tuple(mtT.shape) != (U, V, V) or tuple(oob.shape) != (U,)
            or tuple(slots.shape) != (T,) or tuple(v.shape) != (MV,)):
        raise ValueError("window_rescan: inconsistent shapes "
                         f"{tuple(pend.shape)} {tuple(valid.shape)} "
                         f"{tuple(ids.shape)} {tuple(mtT.shape)} "
                         f"{tuple(oob.shape)} {tuple(slots.shape)} "
                         f"{tuple(v.shape)}")
    dev = pend.device
    for x in (valid, ids, mtT, oob, slots, v):
        if x.device != dev:
            raise ValueError("window_rescan: inputs on different devices")
    if T == 0:
        raise ValueError("window_rescan: a chunk of no returns")
    first = torch.empty((K,), dtype=torch.int32, device=dev)
    inexact = torch.empty((K,), dtype=torch.int32, device=dev)
    if K == 0:
        return first, inexact.to(torch.bool)
    val = valid > 0
    # the kernel indexes with these unchecked
    if bool((((ids < 0) | (ids >= U)).any()
             | (val & ((slots < 0) | (slots >= S))[None]).any()).item()):
        raise ValueError("window_rescan: an op id or slot out of range")
    operands = rescan_operands(pend, valid, ids, mtT, oob, slots, v)
    from jepsen_tpu_torch.ops import _build
    lib = _build.library("window_rescan")
    with torch.cuda.device(dev):
        rc = lib.jt_window_rescan(*(_ptr(x) for x in operands), _ptr(first),
                                  _ptr(inexact), K, T, S, V, _stream(dev))
    _check_launch(rc, "window_rescan")
    window_rescan.launches += 1
    return first, inexact.to(torch.bool)


window_rescan.launches = 0


def rescan_operands(pend, valid, ids, mtT, oob, slots, v):
    """The rescan kernel's operands, in the order of the C entry
    ``jt_window_rescan``, all int32 and contiguous: the pending bits of a
    valid return [K, T] (0 for an invalid one), its returning slot [K, T]
    (-1 for an invalid one), the op ids [T, S], each op's transition rows
    nxt[u, v] = {w : v -> w} [U, V], the oob flags [U] and the start
    vector as a state set a mask [M]."""
    K, T, S = pend.shape
    V = mtT.shape[1]
    dev = pend.device
    val = valid > 0
    bits = torch.arange(S, dtype=torch.int32, device=dev)
    pm = (((pend > 0) & val[..., None]).to(torch.int32) << bits).sum(
        dim=2, dtype=torch.int32)
    rs = torch.where(val, slots.to(torch.int32)[None].expand(K, T),
                     torch.full((K, T), -1, dtype=torch.int32, device=dev))
    vbits = torch.arange(V, dtype=torch.int64, device=dev)
    nxt = ((mtT > 0).to(torch.int64) << vbits[None, :, None]).sum(dim=1)
    vset = ((v.reshape(-1, V) > 0).to(torch.int64) << vbits).sum(dim=1)

    def as_i32(x):
        return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)

    return (pm.contiguous(), rs.contiguous(),
            ids.to(torch.int32).contiguous(), as_i32(nxt).contiguous(),
            (oob > 0).to(torch.int32).contiguous(), as_i32(vset).contiguous())


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
