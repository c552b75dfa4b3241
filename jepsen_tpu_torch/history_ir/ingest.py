"""Host ingest spine: the C WAL tail → parse → live encode → frontier
path (jepsen_tpu/history_ir/ingest.py).

The WAL hot loop (newline scan, JSON parse, live register encode,
frontier absorb) runs in the C extension (``native/columnar_ext.c``,
built by ``native/columnar_c.py``) and, on the inputs that extension
declines, in the pure-Python twins. This module is the dispatch layer.

Dispatch is by input regime only. The C either does the work or returns
"not mine", and the Python twin then runs from untouched state:

* an encoder outside :func:`_encoder_eligible` (custom ``encode_args``,
  an intern table of another class): the per-op Python loops;
* an encode bail (an exotic value, an unknown ``f``): the C leaves the
  cursor AT the offending op, and the Python twin resumes, and raises,
  from there;
* :func:`frontier_absorb` getting ``None`` from the C (more than 63
  slots, a blown-up config set, a non-int column) or ``("dead", e)``:
  the C works on copies, so the twin replays the chunk for the failure
  payload (``failed_event``, ``final_configs``);
* a stream backed by numpy arrays, or a model other than the CAS
  register: the Python loop.

Each miss of the live path counts under its reason in
``native_ingest_fallback_total{reason}`` of the port's telemetry
registry (``regime``, ``encode-bail``, ``frontier-bail``,
``frontier-dead``), as ``check_stream_native`` returning None above 63
slots hands a check to the twin. The last bullet's streams are not
counted, as in the reference: they are the batch checks' one-shot
``check_stream`` over numpy columns and the other models' sessions,
which never reach the C, and a count there would add a family to every
CPU check's registry.

Changes from the reference: there is no ``ingest_native`` knob and no
environment twin, no differential probe at first use with its latch,
no sanitizer variant, and no "build", "probe" or "san-unavailable"
fallback. The extension builds with ``g++`` at first use and a failed
build raises with the compiler's output. ``encoder_add`` and the C
``register_add`` behind it are left out: ``encoder_add_encode`` declines
on exactly the inputs they decline on, so only the reference's probe
reached them. ``builder_extend`` and
``sim_lane`` are not ported (their callers, ``IncrementalHistoryBuilder``
and the simulated scheduler, are not in the port), nor is
``ingest_burst``, whose one caller is the fleet receiver; each C entry
pauses the cyclic GC for its own call.

Bit-identity contract: every native entry point either mutates the SAME
Python-level state its twin owns (the encoder's dicts and lists) in the
twin's exact order, or works on copies and lets the caller replay the
twin from untouched state. ``tests/test_torch_ingest.py`` holds both
paths against each other and against the JAX package's ingest.
"""
from __future__ import annotations

import json

from jepsen_tpu_torch.checker.linear_encode import (
    EV_INVOKE, EV_NOOP, EV_RETURN)
from jepsen_tpu_torch.models import CAS_F_CAS, CAS_F_READ, CAS_F_WRITE
from jepsen_tpu_torch.native import columnar_c

# the C hardcodes the event kinds and the register's f codes
if (EV_INVOKE, EV_RETURN, EV_NOOP) != (0, 1, 2) or \
        (CAS_F_READ, CAS_F_WRITE, CAS_F_CAS) != (0, 1, 2):
    raise ImportError("native/columnar_ext.c hardcodes EV_* and CAS_F_* "
                      "as 0, 1, 2")

# sentinels for the per-line fallback protocol (see _line_fallback)
_SKIP = object()  # whitespace-only line: skipped, not counted
_TORN = object()  # undecodable line: torn, counted


# copied from jepsen_tpu/history_ir/ingest.py:100-109
def fallback_count(reason: str, n: int = 1) -> None:
    """Bumps ``native_ingest_fallback_total{reason}`` in the installed
    registry (a no-op under the null registry)."""
    from jepsen_tpu_torch import telemetry
    telemetry.get_registry().counter(
        "native_ingest_fallback_total",
        "ingest work that fell back to the Python path",
        labels=("reason",)).inc(n, reason=reason)


# -- per-line fallback (shared with the C scanner) ----------------------

# copied from jepsen_tpu/history_ir/ingest.py:243-253
def _line_fallback(line: bytes):
    """Decides parse/skip/torn for a line the C parser bailed on, with
    WalTailer.poll's tolerant semantics: decode with replacement, skip
    whitespace-only lines silently, count undecodable lines torn."""
    s = line.decode("utf-8", "replace")
    if not s or s.isspace():
        return _SKIP
    try:
        return json.loads(s)
    except json.JSONDecodeError:
        return _TORN


# copied from jepsen_tpu/history_ir/ingest.py:256-268, without the
# Python twin's branch: every chunk goes through the C scanner, which
# hands the lines it cannot parse exactly to _line_fallback
def parse_wal_chunk(chunk: bytes, final: bool = False):
    """``(ops, consumed, torn, truncated)`` for a raw WAL byte chunk,
    the same as ``journal.parse_wal_chunk_py``'s. ``consumed`` covers
    exactly the newline-terminated prefix (plus the dropped tail when
    ``final``), so the caller's offset/prefix-sha cursor advances as
    the Python reader's would."""
    ops, consumed, torn, truncated = columnar_c.mod().ingest_chunk(
        chunk, final, _line_fallback, _SKIP, _TORN)
    return ops, consumed, torn, bool(truncated)


# -- encoder / frontier adapters -----------------------------------------

# copied from jepsen_tpu/history_ir/ingest.py:296-298
def _encoder_eligible(enc) -> bool:
    from jepsen_tpu_torch.history import Intern
    return bool(enc._default_args) and type(enc.intern) is Intern


def _add_state(enc) -> tuple:
    return (enc._ops, enc._open_inv, enc._outcome, enc.add)


def _encode_state(enc) -> tuple:
    s = enc.stream
    return (enc._ops, enc._outcome, enc._open_by_process, enc._free_slots,
            s.kind, s.slot, s.f, s.a, s.b, s.op_index,
            enc.intern._ids, enc.intern.table,
            enc._next, enc._next_slot, s.n_slots, enc._finalized)


# copied from jepsen_tpu/history_ir/ingest.py:312-341, with the
# ``regime`` count of the reference's encoder_add (:301-309), which the
# port leaves out: it declines on exactly the inputs this declines on
def encoder_add_encode(enc, ops: list, start: int = 0) -> bool:
    """Fused LiveRegisterEncoder.add_many + encode_resolved: the
    chunk's op dicts are classified once in C, with the add pass's
    field reads feeding the encoder directly. Encoding eagerly here is
    observationally identical — encode_resolved is a deterministic
    cursor advance over ``_ops``, so running it at add time instead of
    at the next verdict lands in the same state. False = caller runs
    the per-op Python add twin (and encoding stays lazy)."""
    if not isinstance(ops, list) or not _encoder_eligible(enc):
        fallback_count("regime")
        return False
    s = enc.stream
    nxt, next_slot, n_slots, enc_ran, bailed = \
        columnar_c.mod().register_add_encode(ops, start, _add_state(enc),
                                             _encode_state(enc))
    if enc_ran:
        enc._next, enc._next_slot, s.n_slots = nxt, next_slot, n_slots
        if bailed:
            # cursor is AT the offending op; the next encode_resolved
            # resumes (and raises) through the Python twin from there
            fallback_count("encode-bail")
    return True


# copied from jepsen_tpu/history_ir/ingest.py:344-362
def encoder_encode(enc) -> bool:
    """LiveRegisterEncoder.encode_resolved, natively. Advances the
    encoder's cursor/slots in place; a mid-stream bail leaves the
    cursor AT the offending op so the Python twin resumes (and raises)
    from bit-identical state. False = caller runs the twin."""
    if not _encoder_eligible(enc):
        fallback_count("regime")
        return False
    s = enc.stream
    nxt, next_slot, n_slots, bailed = columnar_c.mod().register_encode(
        _encode_state(enc))
    enc._next, enc._next_slot, s.n_slots = nxt, next_slot, n_slots
    if bailed:
        fallback_count("encode-bail")
        return False  # twin resumes from enc._next
    return True


# copied from jepsen_tpu/history_ir/ingest.py:365-401
def frontier_absorb(fs, stream, start: int, end: int | None = None) -> bool:
    """FrontierSession.absorb on the native path. Returns True when the
    session state advanced natively; False when the caller must run
    the Python twin (a step other than the CAS register's, a numpy
    stream, a regime miss or config blow-up, or a frontier death — the
    C works on copies, so the twin replays from untouched state and
    produces the identical failure forensics)."""
    if fs.failure is not None:
        return False
    from jepsen_tpu_torch.checker.linear_cpu import cas_register_step_py
    if fs.step is not cas_register_step_py:
        return False
    kind = stream.kind
    if not isinstance(kind, list):
        return False  # numpy-backed streams take the Python loop
    if end is None:
        end = len(kind)
    out = columnar_c.mod().frontier_absorb(
        fs.configs, fs.cur, fs.cur_idx, fs.pending_mask, kind, stream.slot,
        stream.f, stream.a, stream.b, stream.op_index, start, end,
        fs.configs_max)
    if out is None:
        fallback_count("frontier-bail")
        return False
    if len(out) == 2 and out[0] == "dead":
        fallback_count("frontier-dead")
        return False  # twin replays for the failure payload
    configs, cur, cur_idx, pending, cmax, _seen = out
    fs.configs = configs
    fs.cur = cur
    fs.cur_idx = cur_idx
    fs.pending_mask = pending
    fs.configs_max = cmax
    fs.events_absorbed = end
    return True
