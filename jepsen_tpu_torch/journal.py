"""Reading a run's jsonl files back (jepsen_tpu/journal.py).

:func:`read_jsonl_tolerant` is what ``store.load_history`` reads
``history.jsonl`` through. :class:`WalTailer` reads a run's write-ahead
journal (``history.wal.jsonl``) incrementally, poll by poll, for the
live checker sessions (:mod:`jepsen_tpu_torch.live`); it parses through
the C chunk scanner (``history_ir.ingest.parse_wal_chunk`` over
``native/columnar_ext.c`` ``ingest_chunk``), which gives what
:func:`parse_wal_chunk_py`, its Python twin, gives. The writer side,
``Journal`` and ``ForensicLog``, is not ported.
"""
from __future__ import annotations

import hashlib
import json
import logging
from pathlib import Path

logger = logging.getLogger("jepsen_tpu_torch.journal")

# copied from jepsen_tpu/journal.py:44
WAL_NAME = "history.wal.jsonl"


# copied from jepsen_tpu/journal.py:344-370
def read_jsonl_tolerant(path) -> tuple[list[dict], bool]:
    """Parses a jsonl file, tolerating the torn final line a crash (or a
    file-truncate nemesis aimed at ourselves) leaves behind. Returns
    ``(rows, truncated)`` — ``truncated`` is True when a final partial
    line was dropped. A malformed *interior* line — a crash during
    interleaved writers, a disk hiccup — is logged and skipped WITHOUT
    discarding the valid lines after it: one tear costs one op, never
    the rest of the journal."""
    rows: list[dict] = []
    truncated = False
    with open(path, encoding="utf-8", errors="replace") as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rows.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1 and not line.endswith("\n"):
                truncated = True
                logger.debug("dropped torn final jsonl line in %s", path)
            else:
                logger.warning("skipping malformed jsonl line %d in %s",
                               i + 1, path)
    # a last line without its newline parsed fine only if the tear
    # happened to land on a document boundary; count it as complete
    return rows, truncated


# copied from jepsen_tpu/journal.py:373-615, parsing with
# parse_wal_chunk_py
def parse_wal_chunk_py(chunk: bytes, final: bool = False):
    """The Python twin of the C ``ingest_chunk`` scanner
    (``history_ir.ingest.parse_wal_chunk``): the WAL chunk protocol.

    Takes the raw bytes read from a WAL at some resume cursor and
    returns ``(ops, consumed, torn, truncated)``:

    * ``ops`` — the parsed documents of every complete (newline-
      terminated) line, in order; whitespace-only lines skipped.
    * ``consumed`` — bytes the caller's cursor may advance past: the
      newline-terminated prefix, plus the dropped unterminated tail
      when ``final``. Never lands mid-line, so ``(offset, prefix_sha)``
      stays a valid resume token at every chunk boundary.
    * ``torn`` — newline-terminated lines that didn't parse (interior
      tears), plus the dropped tail when ``final`` truncates one.
    * ``truncated`` — True when ``final`` dropped an unterminated
      in-progress final line.
    """
    ops: list = []
    torn = 0
    nl = chunk.rfind(b"\n")
    pos = nl + 1  # bytes of newline-terminated (complete) lines
    loads = json.loads
    if pos:
        # fast path: the whole complete portion as ONE json array
        # (~2.7x a per-line loop); tolerant per-line path only when
        # something in the chunk doesn't parse
        body = chunk[:nl]
        text = None
        try:
            # strict decode BEFORE the one-array parse: json.loads on
            # raw bytes decodes with surrogatepass, so a chunk of
            # all-valid lines would keep raw lone-surrogate bytes as
            # surrogates while the same line next to a torn neighbor
            # (or read through WalTailer/read_jsonl_tolerant) gets
            # U+FFFD replacement — parse results must not depend on
            # neighboring lines (found by fuzz-native, exec seed 0:271).
            # Join with ",\n", NOT ",": a torn line with an unbalanced
            # quote would otherwise swallow bare-comma separators into
            # its string literal and weld neighboring lines into one
            # bogus document; keeping the newline makes that a raw
            # control char inside a string, which strict JSON rejects
            # (seed 0:2712)
            text = body.decode("utf-8")
            ops = loads("[" + text.replace("\n", ",\n") + "]")
            # the fast path is only trustworthy when every line maps to
            # exactly ONE array element. Torn lines can weld through a
            # *structural* position — ",\n" between two halves of a
            # split numeric array is legal JSON whitespace, so
            # "[...,1" + "37,...]" parses as one bogus document (seed
            # 0:90681) — and a single line holding two documents
            # ("{...},{...}", a mid-line splice) parses as two elements
            # where the per-line contract says one torn line. Either
            # direction changes the element count, so a count mismatch
            # drops to the tolerant per-line path.
            fast_ok = len(ops) == text.count("\n") + 1
        except (json.JSONDecodeError, UnicodeDecodeError):
            fast_ok = False
        if not fast_ok:
            ops = []
            if text is None:
                text = body.decode("utf-8", "replace")
            for line in text.split("\n"):
                if not line or line.isspace():
                    continue
                try:
                    ops.append(loads(line))
                except json.JSONDecodeError:
                    torn += 1
                    logger.debug("torn jsonl line in chunk (%.80r)", line)
    consumed = pos
    truncated = False
    if final and pos < len(chunk):
        # unterminated tail at end-of-run: permanently torn
        truncated = True
        torn += 1
        consumed = len(chunk)
    return ops, consumed, torn, truncated


class WalTailer:
    """Incremental offset-tracking WAL reader for the live checker
    (doc/observability.md "Live checking").

    ``poll()`` returns the ops appended since the last poll. The tailer
    remembers the byte offset of the last fully-parsed line, so each
    poll reads only the new tail:

    * an **in-progress final line** (no trailing newline yet — the
      writer is mid-``write``) is left unread; the offset does not
      advance past it, so the next poll resumes at its start and picks
      it up once the writer finishes the line;
    * a **newline-terminated line that doesn't parse** (a torn line
      *mid-file*: crash during interleaved writers, disk damage) is
      logged, counted in ``torn_skipped``, and skipped — the valid
      lines after it are still delivered;
    * ``finalize()`` drains everything and additionally drops a
      still-unterminated final partial line (the run is over; nobody
      will complete it), setting ``truncated_tail``.

    A missing file reads as zero new ops (the run may not have opened
    its journal yet, or `core.run` already discarded it after save_1 —
    the tracker falls over to history.jsonl in that case)."""

    def __init__(self, path):
        self.path = Path(path)
        self.offset = 0
        self.lines_read = 0
        self.torn_skipped = 0
        self.truncated_tail = False
        # running digest of every byte the offset has advanced past —
        # the live daemon's restart snapshots record it so a resumed
        # tailer can prove it is continuing the SAME file (divergence-
        # checked adoption, doc/robustness.md "Resumable checks and the
        # elastic mesh"). Maintained LAZILY: hashing 30-60ns/op on the
        # ingest hot loop for a digest that is only read at snapshot
        # points would cost real throughput, and the consumed prefix of
        # an append-only WAL never changes — so poll() just advances
        # the offset and prefix_sha() catches the digest up from the
        # file on demand.
        self._sha = hashlib.sha256()
        self._sha_pos = 0  # bytes already folded into _sha

    def prefix_sha(self) -> str:
        """sha256 of the bytes consumed so far (everything before
        ``offset``)."""
        if self._sha_pos < self.offset:
            try:
                with open(self.path, "rb") as f:
                    f.seek(self._sha_pos)
                    remaining = self.offset - self._sha_pos
                    while remaining > 0:
                        chunk = f.read(min(1 << 20, remaining))
                        if not chunk:
                            break  # truncated under us; digest of what
                        self._sha.update(chunk)
                        self._sha_pos += len(chunk)
                        remaining -= len(chunk)
            except OSError:
                pass
        return self._sha.hexdigest()

    def seek(self, offset: int, lines_read: int = 0,
             torn_skipped: int = 0, prefix_sha: str | None = None) -> bool:
        """Repositions a FRESH tailer at a snapshot's offset — the
        restart path. Verifies the snapshot's ``prefix_sha`` against
        the file's actual first ``offset`` bytes before adopting;
        a mismatch (truncated/rewritten WAL, a different run reusing
        the dir) returns False and leaves the tailer at 0, so the
        caller re-ingests from scratch instead of trusting a stale
        cursor."""
        offset = int(offset)
        h = hashlib.sha256()
        try:
            with open(self.path, "rb") as f:
                remaining = offset
                while remaining > 0:
                    chunk = f.read(min(1 << 20, remaining))
                    if not chunk:
                        return False  # file shorter than the snapshot
                    h.update(chunk)
                    remaining -= len(chunk)
        except OSError:
            return False
        if prefix_sha is not None and h.hexdigest() != prefix_sha:
            return False
        self.offset = offset
        self.lines_read = int(lines_read)
        self.torn_skipped = int(torn_skipped)
        self._sha = h
        self._sha_pos = offset
        return True

    def _read_new(self) -> bytes:
        try:
            with open(self.path, "rb") as f:
                f.seek(self.offset)
                return f.read()
        except OSError:
            return b""

    def poll(self, final: bool = False) -> list[dict]:
        chunk = self._read_new()
        if not chunk:
            return []
        # the hot loop is the C scanner's (native/columnar_ext.c
        # ingest_chunk), which hands a line it cannot parse exactly to
        # json.loads; parse_wal_chunk_py gives the same four values
        from jepsen_tpu_torch.history_ir import ingest
        ops, consumed, torn, truncated = ingest.parse_wal_chunk(
            chunk, final=final)
        self.lines_read += len(ops)
        if torn:
            self.torn_skipped += torn
            interior = torn - (1 if truncated else 0)
            if interior:
                logger.warning("live tail: skipped %d torn jsonl "
                               "line(s) in %s", interior, self.path)
        # the offset only ever advances past newline-terminated lines
        # (plus the dropped tail when final); the prefix digest catches
        # up lazily from the file (seek() verifies it)
        self.offset += consumed
        if truncated:
            self.truncated_tail = True
            logger.warning("live tail: dropped unterminated final line "
                           "in %s", self.path)
        return ops

    def poll_bytes(self) -> bytes:
        """Raw shipping twin of :meth:`poll`: the newline-terminated
        bytes appended since the last poll, advancing ``offset`` /
        ``lines_read`` / the prefix digest in lockstep — WITHOUT
        parsing. The fleet ingest plane ships these bytes verbatim, so
        the receiver's file is a byte-identical prefix of the source
        WAL and its checker verdicts match the local path bit for bit
        (doc/observability.md "Fleet plane").

        The torn-boundary contract is inherited: an in-progress final
        line (no trailing newline yet) is left unread, so a shipped
        chunk never ends mid-document and ``(offset, prefix_sha())``
        stays a valid resume token at every chunk boundary."""
        chunk = self._read_new()
        if not chunk:
            return b""
        nl = chunk.rfind(b"\n")
        if nl < 0:
            return b""  # only an in-progress line so far: ship nothing
        body = chunk[:nl + 1]
        self.lines_read += body.count(b"\n")
        self.offset += len(body)
        return body

    def finalize(self) -> list[dict]:
        return self.poll(final=True)


def read_wal(path) -> tuple[list[dict], bool]:
    """The ops recovered from a journal, plus the torn-tail flag."""
    return read_jsonl_tolerant(path)


def wal_path(test: dict):
    from jepsen_tpu_torch import store
    return store.path(test, WAL_NAME)
