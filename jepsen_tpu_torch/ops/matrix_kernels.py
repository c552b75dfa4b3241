"""The transfer-matrix chunk product and chunk combine: wrappers around
the hand-written Hopper kernels in ``csrc/``, their plain torch
versions, and the numpy oracles they are held against.

Every matrix here is a boolean reachability operator: entries are 0 or 1
and every product is thresholded back to 0/1, so kernel, plain version
and oracle agree bit for bit.

A wrapper takes its plain version only for tensors that lie on the CPU.
For CUDA tensors it launches its kernel or raises; it never falls back.
Each wrapper counts its kernel launches in a plain int attribute
(``chunk_product.launches``, ``combine_product.launches``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

# The chunk product keeps one bit-packed [MV, MV] matrix resident in
# shared memory (32 KB at MV = 512), the combine at most three; the
# counterpart of
# jepsen_tpu/ops/pallas_matrix.py:98 PALLAS_MAX_MV.
KERNEL_MAX_MV = 512
KERNEL_MAX_SLOTS = 8
# V states per mask block: a block must sit inside one 32-bit word
KERNEL_MAX_V = 32


def _is_pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def _check_launch(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------------------
# chunk product
# ---------------------------------------------------------------------------

def chunk_product(pend, ids, mtT, slots, valid, S: int, V: int,
                  checked: bool = False):
    """Per-chunk composed operator product over T returns.

    pend [T,G,S] (0/1), ids [T,G,S] int (indices into mtT), mtT [U,V,V]
    (0/1, mtT[u, w, v] = transition v -> w), slots [T,G] int in [0, S),
    valid [T,G] (0/1) -> P [G, MV, MV] bf16 0/1 with MV = 2^S * V — the
    layout of jepsen_tpu/ops/pallas_matrix.py ``_build``. On the card each
    return's closure is computed row by row in level order on one
    bit-packed matrix in shared memory, with no matrix products
    (``csrc/chunk_product.cu``). ``checked``: the caller has checked the
    op ids and slots on the host before the upload, so the wrapper reads
    nothing back from the card (the matrix path's grids,
    ``jitlin._matrix_grids``)."""
    if pend.device.type == "cpu":
        return chunk_product_torch(pend, ids, mtT, slots, valid, S, V)
    if pend.device.type != "cuda":
        raise ValueError(f"chunk_product: unsupported device {pend.device}")
    T, G, S_in = pend.shape
    U = mtT.shape[0]
    MV = (1 << S) * V
    if S_in != S or S > KERNEL_MAX_SLOTS:
        raise ValueError(f"chunk_product: S={S} (pend has {S_in} slots, "
                         f"kernel takes <= {KERNEL_MAX_SLOTS})")
    if not _is_pow2(V) or V > KERNEL_MAX_V or not 8 <= MV <= KERNEL_MAX_MV:
        raise ValueError(f"chunk_product: V={V}, MV={MV} outside the "
                         f"kernel (V a power of two <= {KERNEL_MAX_V}, "
                         f"8 <= MV <= {KERNEL_MAX_MV})")
    if (tuple(ids.shape) != (T, G, S) or tuple(slots.shape) != (T, G)
            or tuple(valid.shape) != (T, G)
            or tuple(mtT.shape) != (U, V, V)):
        raise ValueError("chunk_product: inconsistent shapes "
                         f"{tuple(pend.shape)} {tuple(ids.shape)} "
                         f"{tuple(mtT.shape)} {tuple(slots.shape)} "
                         f"{tuple(valid.shape)}")
    dev = pend.device
    for x in (ids, mtT, slots, valid):
        if x.device != dev:
            raise ValueError("chunk_product: inputs on different devices")
    # the kernel indexes with these unchecked
    if not checked and bool((((ids < 0) | (ids >= U)).any()
             | ((valid > 0) & ((slots < 0) | (slots >= S))).any()).item()):
        raise ValueError("chunk_product: an op id or slot out of range")
    operands = chunk_operands(pend, ids, mtT, slots, valid, S, V)
    out = torch.empty((G, MV, MV), dtype=torch.bfloat16, device=dev)
    if G == 0:
        return out
    from jepsen_tpu_torch.ops import _build
    lib = _build.library("chunk_product")
    with torch.cuda.device(dev):
        rc = lib.jt_chunk_product(*(_ptr(x) for x in operands), _ptr(out),
                                  T, G, S, V, _stream(dev))
    _check_launch(rc, "chunk_product")
    chunk_product.launches += 1
    return out


chunk_product.launches = 0


def chunk_operands(pend, ids, mtT, slots, valid, S: int, V: int):
    """The chunk-product kernel's compact operands, in the order of the C
    entry ``jt_chunk_product``: the pending set as a bitmask per step
    [T, G], the returning slot (-1 for a padding step) [T, G], the op ids
    [T, G, S], and each uop's transition rows as V-bit words mtbits[u, w]
    = {v : mtT[u, w, v] > 0} [U, V], all int32 and contiguous."""
    dev = pend.device
    bits = torch.arange(S, dtype=torch.int32, device=dev)
    pmask = ((pend > 0).to(torch.int32) << bits).sum(
        dim=2, dtype=torch.int32).contiguous()
    sv = torch.where(valid > 0, slots.to(torch.int32),
                     torch.full_like(slots, -1, dtype=torch.int32))
    sv = sv.contiguous()
    vbits = torch.arange(V, dtype=torch.int64, device=dev)
    words = ((mtT > 0).to(torch.int64) << vbits).sum(dim=2)
    mtbits = torch.where(words >= (1 << 31), words - (1 << 32),
                         words).to(torch.int32).contiguous()
    return pmask, sv, ids.to(torch.int32).contiguous(), mtbits


def chunk_product_torch(pend, ids, mtT, slots, valid, S: int, V: int):
    """Plain torch version of :func:`chunk_product`: the
    ``_kernel_math.make_step`` loop over the T returns, in float32 with a
    > 0 threshold after every product (counts <= 4096 are exact)."""
    from jepsen_tpu_torch.ops.jitlin import _kernel_math

    T, G, _ = pend.shape
    dev = pend.device
    math = _kernel_math(S, V, None, G, dev)
    mt_tab = (mtT > 0).to(torch.float32).transpose(1, 2)
    oob_tab = torch.zeros(mt_tab.shape[0], dtype=torch.bool, device=dev)
    step = math.make_step(mt_tab, oob_tab)
    P = math.eye.expand(G, math.MV, math.MV)
    inexact = torch.zeros(G, dtype=torch.bool, device=dev)
    for t in range(T):
        P, inexact = step((P, inexact),
                          (pend[t] > 0, ids[t], slots[t], valid[t] > 0))
    return P.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# chunk combine
# ---------------------------------------------------------------------------

def combine_product(P, tot0):
    """total[b] = P[b, C-1] @ ... @ P[b, 0] @ tot0[b], thresholded > 0
    after every product. P [B, C, MV, MV] 0/1 (bf16), tot0 [B, MV, MV]
    0/1 (bf16) -> total [B, MV, MV] bf16 — the layout of
    jepsen_tpu/ops/pallas_matrix.py ``_build_combine``. On the card the
    products are bit-packed into a workspace and multiplied as a tree
    spread over all SMs (``csrc/chunk_combine.cu``)."""
    if P.device.type == "cpu":
        return combine_product_torch(P, tot0)
    if P.device.type != "cuda":
        raise ValueError(f"combine_product: unsupported device {P.device}")
    B, C, MV, MV2 = P.shape
    if MV != MV2 or tuple(tot0.shape) != (B, MV, MV):
        raise ValueError(f"combine_product: shapes {tuple(P.shape)} and "
                         f"{tuple(tot0.shape)} do not chain")
    if not _is_pow2(MV) or not 8 <= MV <= KERNEL_MAX_MV:
        raise ValueError(f"combine_product: MV={MV} outside the kernel "
                         f"(a power of two, 8 <= MV <= {KERNEL_MAX_MV})")
    if tot0.device != P.device:
        raise ValueError("combine_product: inputs on different devices")
    dev = P.device
    # the kernel reads bf16 rows with 16-byte loads
    Pb = _aligned(P.to(torch.bfloat16).contiguous())
    tb = _aligned(tot0.to(torch.bfloat16).contiguous())
    out = torch.empty((B, MV, MV), dtype=torch.bfloat16, device=dev)
    if B == 0:
        return out
    # bit-packed [MV, W] nodes: the C + 1 leaves per key, and the
    # ping-pong buffer for the tree's first level (sized for a fan-in of
    # 2, enough for any)
    W = (MV + 31) // 32
    ws = torch.empty((B * (C + 1 + (C + 2) // 2) * MV * W,),
                     dtype=torch.int32, device=dev)
    from jepsen_tpu_torch.ops import _build
    lib = _build.library("chunk_combine")
    with torch.cuda.device(dev):
        rc = lib.jt_chunk_combine(_ptr(Pb), _ptr(tb), _ptr(out), _ptr(ws),
                                  B, C, MV, _stream(dev))
    _check_launch(rc, "combine_product")
    combine_product.launches += 1
    return out


combine_product.launches = 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def combine_product_torch(P, tot0):
    """Plain torch version of :func:`combine_product`: the sequential
    chain in float32 with a > 0 threshold after every product."""
    acc = (tot0 > 0).to(torch.float32)
    for c in range(P.shape[1]):
        acc = (torch.matmul((P[:, c] > 0).to(torch.float32), acc)
               > 0).to(torch.float32)
    return acc.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# numpy oracles
# ---------------------------------------------------------------------------

# copied from jepsen_tpu/ops/pallas_matrix.py:200-231
def _static_tables(S: int, V: int):
    """Host-side static operator tables for (S, V), expanded from the
    receiver/kill bit tables (jitlin.receiver_kill_tables):

    - Rexp [S, MV, MV]: receiver map R_s block-expanded
    - Kexp [S, MV, MV]: the closure-then-kill row gather+mask as a
      matrix (A = Kexp_s @ B  ==  B rows gathered at kill_idx_s, masked)
    - U1 [MV, V], U2 [V, MV]: the tiling maps (U1 @ X @ U2 repeats a
      [V, V] X over every block)
    """
    from jepsen_tpu_torch.ops.jitlin import receiver_kill_tables

    M = 1 << S
    MV = M * V
    rows = np.arange(MV)
    ww = rows % V
    receiver, kill_idx, kill_mask = receiver_kill_tables(S, V)

    Rexp = np.stack([receiver[t][rows // V][:, rows // V]
                     for t in range(S)]).astype(np.float32)
    Kexp = np.zeros((S, MV, MV), np.float32)
    for s in range(S):
        Kexp[s, rows, kill_idx[s]] = kill_mask[s]

    U1 = np.zeros((MV, V), np.float32)
    U1[rows, ww] = 1.0
    U2 = np.zeros((V, MV), np.float32)
    U2[ww, rows] = 1.0
    return Rexp, Kexp, U1, U2


# copied from jepsen_tpu/ops/pallas_matrix.py:656-681
def _oracle_product(S, V, pend, ids, mtT, slots, valid):
    """Numpy replay of the factored chunk product — the independent
    reference every chunk-product version must reproduce bit for bit."""
    MV = (1 << S) * V
    T, G = slots.shape
    Rexp, Kexp, U1, U2 = _static_tables(S, V)
    eye = np.eye(MV, dtype=np.float32)
    n_sq = 0
    while (1 << n_sq) < S:
        n_sq += 1
    P = np.broadcast_to(eye, (G, MV, MV)).copy()
    for t in range(T):
        for g in range(G):
            L = np.zeros((MV, MV), np.float32)
            for s in range(S):
                L += (pend[t, g, s]
                      * Rexp[s] * (U1 @ mtT[ids[t, g, s]] @ U2))
            Bm = ((L + eye) > 0).astype(np.float32)
            for _ in range(n_sq):
                Bm = ((Bm @ Bm) > 0).astype(np.float32)
            A = ((Kexp[slots[t, g]] @ Bm) > 0).astype(np.float32)
            if not valid[t, g]:
                A = eye
            P[g] = ((A @ P[g]) > 0).astype(np.float32)
    return P


# copied from jepsen_tpu/ops/pallas_matrix.py:853-862
def _combine_oracle(P, tot0):
    B, C, MV, _ = P.shape
    out = np.zeros((B, MV, MV), np.float32)
    for b in range(B):
        acc = np.asarray(tot0[b], np.float32)
        for c in range(C):
            acc = ((np.asarray(P[b, c], np.float32) @ acc)
                   > 0).astype(np.float32)
        out[b] = acc
    return out
