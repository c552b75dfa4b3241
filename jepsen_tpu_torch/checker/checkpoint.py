"""Durable checker checkpoints: a long check survives its own death.

Copied from jepsen_tpu/checker/checkpoint.py. The long-running checks —
the segmented transfer-matrix chain (``ops/jitlin.matrix_check_segmented``),
the segmented frontier scan (``ops/jitlin.segmented_check``) and the
exact CPU frontier (``checker/linear_cpu.FrontierSession``) — persist
their small carry to an fsynced ``check.ckpt`` under the run's store
directory (``store.path(test, "check.ckpt")``), and the next check of the
same history resumes from a valid checkpoint instead of restarting from
zero. Resumption is bit-identical to an uninterrupted check: every carry
(a composed 0/1 operator product, a frontier) is exact state the
uninterrupted check holds at the same cut.

Checkpoint schema (one JSON document, atomic tmp+flush+fsync+rename),
the reference's at :data:`VERSION` = 1:

* ``version``; ``kind`` — ``matrix`` (the chain's ``tot0`` carry),
  ``frontier`` (the segmented scan's dense table or sparse mask/state
  pair) or ``frontier-session`` (the CPU frontier's configuration set);
* ``config`` — the knob and shape fingerprint the writer ran under; any
  drift discards the checkpoint. It names the step function the carry
  was built under (:func:`step_identity`), which differs between this
  package and the JAX package, so a checkpoint of one never resumes in
  the other;
* ``events_done`` / ``segment`` — how far the consumed prefix reaches;
* ``prefix_hash`` — sha256 over the encoded columns up to
  ``events_done``;
* ``carry`` — the state itself; 0/1 matrices are bit-packed.

Validity (:func:`load_resume`): version, kind and exact ``config``
match, ``events_done`` within the stream, prefix hash match. Anything
else is discarded, with a warning and the file cleared, and the check
restarts from zero. ``resume_check: False`` in the test map opts out of
resuming; ``check_ckpt_interval`` (seconds, ``<= 0`` disables) throttles
writing. Neither has an environment twin here. A settled check clears
its checkpoint.

A carry arrives as a torch tensor, on the card a bf16 one that numpy
cannot take: :func:`host_array` moves it to a float32 (or its own
integer) numpy array before it is encoded. Checkpointing never fails a
check: a state that cannot be built, or a disk that cannot be written,
is logged and the check goes on. Not ported: the resume and write
counters and the staleness gauge, and the trace instants (ROADMAP
Queue 1 item 9); :func:`count_resume` logs.
"""
from __future__ import annotations

import base64
import hashlib
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger("jepsen_tpu_torch.checker.checkpoint")

CKPT_NAME = "check.ckpt"
VERSION = 1
DEFAULT_CKPT_INTERVAL_S = 5.0

# chunk size for the checkpointed exact CPU frontier: absorb this many
# events between checkpoint opportunities (the frontier can cut
# anywhere: its state carries the open ops)
FRONTIER_CHUNK_EVENTS = 65_536


# ---------------------------------------------------------------------------
# Knobs (jepsen_tpu/checker/checkpoint.py:81-115, test map only)
# ---------------------------------------------------------------------------

def ckpt_interval(test) -> float | None:
    """Seconds between checkpoint persists (``check_ckpt_interval`` in
    the test map), or None when checkpointing is disabled (``<= 0``).
    Garbage warns and falls back to the default."""
    tmap = test if isinstance(test, dict) else {}
    raw = tmap.get("check_ckpt_interval")
    if raw is None or raw == "":
        return DEFAULT_CKPT_INTERVAL_S
    try:
        if isinstance(raw, bool):
            raise ValueError("bool is not an interval")
        v = float(raw)
    except (TypeError, ValueError):
        logger.warning("ignoring malformed check_ckpt_interval=%r; using "
                       "default %r", raw, DEFAULT_CKPT_INTERVAL_S)
        return DEFAULT_CKPT_INTERVAL_S
    return None if v <= 0 else v


def resume_enabled(test) -> bool:
    """Should a valid checkpoint be resumed from? ``resume_check`` in
    the test map (default True)."""
    from jepsen_tpu_torch.parallel import coerce_flag
    tmap = test if isinstance(test, dict) else {}
    flag = coerce_flag(tmap.get("resume_check"), knob="resume_check")
    return True if flag is None else flag


# ---------------------------------------------------------------------------
# Stream prefix hashing (jepsen_tpu/checker/checkpoint.py:122-147)
# ---------------------------------------------------------------------------

def step_identity(fn) -> str:
    """A stable identity for the model step a carry was built under: part
    of the checkpoint's config fingerprint, since the prefix hash covers
    only the encoded columns, which do not depend on the model."""
    mod = getattr(fn, "__module__", None) or type(fn).__module__
    qn = getattr(fn, "__qualname__", None) or type(fn).__qualname__
    return f"{mod}.{qn}"


def stream_prefix_hash(stream, end: int) -> str:
    """sha256 over the encoded stream columns (kind/slot/f/a/b, in their
    own dtypes) up to event ``end``. ``op_index`` is left out: it is
    diagnostics, not checked content."""
    h = hashlib.sha256()
    for name in ("kind", "slot", "f", "a", "b"):
        col = np.ascontiguousarray(np.asarray(getattr(stream, name))[:end])
        h.update(col.tobytes())
        h.update(b"|")
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Array codecs (jepsen_tpu/checker/checkpoint.py:154-178)
# ---------------------------------------------------------------------------

def host_array(a) -> np.ndarray:
    """``a`` as a numpy array on the host: a torch tensor is copied off
    its device, a floating one (the bf16 matrix carry) as float32, a
    uint32 one as uint32."""
    if isinstance(a, torch.Tensor):
        t = a.detach()
        if t.is_floating_point():
            t = t.float()
        if t.dtype == torch.uint32:
            # the sparse frontier's masks: torch's unsigned types take few
            # operations, so they go through int64
            return t.to(torch.int64).cpu().numpy().astype(np.uint32)
        return t.cpu().numpy()
    return np.asarray(a)


def encode_array(a) -> dict:
    """A numpy array or torch tensor as a JSON-serializable dict. Arrays
    whose entries are exactly 0/1 — the matrix ``tot0`` product, the
    dense frontier table — pack to one bit per entry."""
    a = host_array(a)
    if a.dtype == bool or (a.size and
                           np.isin(a.astype(np.float32), (0.0, 1.0)).all()) \
            or (not a.size):
        bits = np.packbits((a.astype(np.float32) > 0).reshape(-1)
                           if a.dtype != bool else a.reshape(-1))
        return {"enc": "bits", "shape": list(a.shape),
                "b64": base64.b64encode(bits.tobytes()).decode("ascii")}
    a = np.ascontiguousarray(a)
    return {"enc": "raw", "shape": list(a.shape), "dtype": str(a.dtype),
            "b64": base64.b64encode(a.tobytes()).decode("ascii")}


def decode_array(d: dict) -> np.ndarray:
    raw = base64.b64decode(d["b64"])
    shape = tuple(int(x) for x in d["shape"])
    if d["enc"] == "bits":
        n = int(np.prod(shape)) if shape else 1
        bits = np.unpackbits(np.frombuffer(raw, np.uint8), count=n)
        return bits.reshape(shape).astype(np.float32)
    return np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(shape)


# ---------------------------------------------------------------------------
# The store and the resume rules (jepsen_tpu/checker/checkpoint.py:185-343)
# ---------------------------------------------------------------------------

class CheckpointStore:
    """One run's ``check.ckpt``: interval-gated atomic persists of a
    resumable check's carry.

    ``maybe_save`` takes a zero-argument state builder, so that the cost
    of bringing the carry to the host (a device sync for the matrix
    ``tot0``) is paid only when the interval has elapsed. The interval
    clock starts at construction, so a check shorter than one interval
    writes nothing."""

    def __init__(self, path, interval_s: float | None = DEFAULT_CKPT_INTERVAL_S,
                 resume: bool = True, guard=None):
        self.path = Path(path)
        self.interval_s = interval_s
        self.resume = resume
        # guard() -> bool: a fencing hook, checked right before every
        # persist, so that a checker whose claim on the run went stale
        # cannot overwrite a newer owner's checkpoint with an older carry.
        # None never fences.
        self.guard = guard
        self.fenced = False
        self._last_save = time.monotonic()
        self._last_events = 0
        self.writes = 0

    # -- writing --------------------------------------------------------

    def due(self) -> bool:
        return (self.interval_s is not None
                and time.monotonic() - self._last_save >= self.interval_s)

    def maybe_save(self, make_state, events_done: int) -> bool:
        """Persists ``make_state()`` when the write interval has
        elapsed."""
        if not self.due():
            return False
        try:
            state = make_state()
        except Exception:  # noqa: BLE001 — checkpointing never fails a check
            logger.exception("checkpoint state build failed; skipping")
            return False
        return self.save(state, events_done=events_done)

    def save(self, state: dict, events_done: int | None = None) -> bool:
        from jepsen_tpu_torch.utils import atomic_write_json
        if self.guard is not None and not self.guard():
            self.fenced = True
            logger.warning("checkpoint write to %s fenced: the run's "
                           "claim went stale (a newer owner has it)",
                           self.path)
            return False
        doc = dict(state)
        doc.setdefault("version", VERSION)
        doc["wrote_at"] = time.time()
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            atomic_write_json(self.path, doc)
        except Exception:  # noqa: BLE001 — a full disk must not fail the check
            logger.exception("checker checkpoint write failed; continuing "
                             "unresumably")
            return False
        self._last_save = time.monotonic()
        if events_done is not None:
            self._last_events = int(events_done)
        self.writes += 1
        return True

    # -- reading --------------------------------------------------------

    def load(self) -> dict | None:
        try:
            with open(self.path, encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def clear(self) -> None:
        """Removes the checkpoint: a settled check must not leave a stale
        carry for the next check to trust."""
        try:
            self.path.unlink(missing_ok=True)
        except OSError:
            logger.exception("couldn't clear %s", self.path)


def count_resume(source: str) -> None:
    """A check resumed from a durable checkpoint (``ckpt``) or from an
    in-process carry (``carry``). The reference counts it in
    ``checker_resume_total{source}``; here it is logged."""
    logger.info("check resumed from %s", source)


def load_resume(store: CheckpointStore | None, kind: str, config: dict,
                stream) -> dict | None:
    """The validated resume state for ``stream``, or None.

    Validity: version, kind and exact config match, ``events_done``
    within the stream, and the prefix hash over the stream matching the
    writer's. Any mismatch discards the checkpoint (a warning, the file
    cleared): knob drift or another history restarts, never composes over
    a foreign carry."""
    if store is None or not store.resume:
        return None
    state = store.load()
    if state is None:
        return None
    label = store.path
    if state.get("version") != VERSION or state.get("kind") != kind:
        logger.warning("discarding %s: version/kind mismatch (%r/%r vs "
                       "%r/%r)", label, state.get("version"),
                       state.get("kind"), VERSION, kind)
        store.clear()
        return None
    if state.get("config") != config:
        logger.warning("discarding %s: knob/config drift (%r vs %r)",
                       label, state.get("config"), config)
        store.clear()
        return None
    end = state.get("events_done")
    if not isinstance(end, int) or end < 0 or end > len(stream.kind):
        logger.warning("discarding %s: events_done=%r outside the stream",
                       label, end)
        store.clear()
        return None
    if stream_prefix_hash(stream, end) != state.get("prefix_hash"):
        logger.warning("discarding %s: consumed-prefix hash mismatch — "
                       "the stored carry summarizes a different history",
                       label)
        store.clear()
        return None
    return state


# ---------------------------------------------------------------------------
# Matrix carry -> CPU frontier (jepsen_tpu/checker/checkpoint.py:350-383)
# ---------------------------------------------------------------------------

def frontier_from_matrix_carry(carry: dict, step, init_state: int,
                               algorithm: str = "jitlin-cpu(resumed)"):
    """A :class:`~jepsen_tpu_torch.checker.linear_cpu.FrontierSession`
    seeded from a segmented transfer-matrix carry, or None when the carry
    can't seed one.

    At a quiescent cut every live row of the composed operator product
    has mask 0, so the frontier the CPU twin holds at the same cut is
    ``{(0, state) : tot0[0][0*V + state, init_state] > 0}``. A dead carry
    (the matrix verdict settles it) and one with a live row of non-zero
    mask (not at a quiescent cut) are declined."""
    from jepsen_tpu_torch.checker.linear_cpu import FrontierSession
    try:
        tot = host_array(carry["tot0"]).astype(np.float32)
        V = int(carry["V"])
        events_done = int(carry["events_done"])
        mv = tot.shape[-1]
    except (AttributeError, IndexError, KeyError, TypeError, ValueError):
        return None
    vec = tot.reshape(-1, mv, mv)[0][:, init_state]
    live = np.nonzero(vec > 0)[0]
    if live.size == 0:
        return None  # dead carry: the matrix verdict already settled it
    if (live // V != 0).any():
        logger.warning("matrix carry at event %d is not at a quiescent "
                       "cut; declining the frontier handoff", events_done)
        return None
    fs = FrontierSession(step=step, init_state=init_state,
                         algorithm=algorithm)
    fs.configs = {(0, int(r % V)) for r in live}
    fs.events_absorbed = events_done
    return fs


# ---------------------------------------------------------------------------
# Checkpointed exact CPU frontier (jepsen_tpu/checker/checkpoint.py:390-439)
# ---------------------------------------------------------------------------

def checkpointed_check_stream(stream, step, init_state: int,
                              store: CheckpointStore,
                              algorithm: str = "jitlin-cpu",
                              session=None):
    """The exact CPU frontier check with durable checkpoints: absorbs the
    stream in :data:`FRONTIER_CHUNK_EVENTS` chunks through a
    :class:`FrontierSession`, persisting its snapshot between chunks when
    the write interval elapses, and resuming a valid
    ``frontier-session`` checkpoint instead of starting over.
    Bit-identical to a one-shot ``check_stream``. ``session`` overrides
    the starting session (a matrix carry's hand-off)."""
    from jepsen_tpu_torch.checker.linear_cpu import FrontierSession
    config = {"path": "frontier-cpu", "init_state": int(init_state),
              "algorithm": algorithm, "step": step_identity(step)}
    fs = session
    if fs is None:
        state = load_resume(store, "frontier-session", config, stream)
        if state is not None:
            fs = FrontierSession.restore(state.get("carry") or {},
                                         step=step, init_state=init_state,
                                         algorithm=algorithm)
            if fs is not None:
                count_resume("ckpt")
                logger.info("resuming exact CPU frontier from %s at "
                            "event %d/%d", store.path,
                            fs.events_absorbed, len(stream.kind))
    if fs is None:
        fs = FrontierSession(step=step, init_state=init_state,
                             algorithm=algorithm)
    n = len(stream.kind)
    pos = fs.events_absorbed
    while pos < n:
        end = min(n, pos + FRONTIER_CHUNK_EVENTS)
        res = fs.absorb(stream, start=pos, end=end)
        pos = end
        if res.valid is False:
            break
        if pos < n:
            def make_state(fs=fs, pos=pos):
                snap = fs.snapshot()
                if snap is None:
                    raise ValueError("frontier session not snapshotable")
                return {"kind": "frontier-session", "config": config,
                        "events_done": pos, "segment": pos
                        // FRONTIER_CHUNK_EVENTS,
                        "prefix_hash": stream_prefix_hash(stream, pos),
                        "carry": snap}
            store.maybe_save(make_state, pos)
    return fs.result()
