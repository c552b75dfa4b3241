"""Reading a run's jsonl files back (jepsen_tpu/journal.py): only
:func:`read_jsonl_tolerant`, which ``store.load_history`` reads
``history.jsonl`` through. The write-ahead journal itself is not
ported."""
from __future__ import annotations

import json
import logging

logger = logging.getLogger("jepsen_tpu_torch.journal")


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
