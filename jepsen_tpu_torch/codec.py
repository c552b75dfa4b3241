"""Value <-> bytes codec: canonical JSON (the reference's
jepsen/src/jepsen/codec.clj uses EDN). It serializes the history IR's
value intern table into the ``history.npz`` sidecar (``val_table``, one
row an interned value; :func:`jepsen_tpu_torch.history_ir.sidecar
.intern_to_rows`)."""
from __future__ import annotations

import json
from typing import Any


# copied from jepsen_tpu/codec.py:19-23
def encode(value: Any) -> bytes:
    """(codec.clj:9-18)"""
    if value is None:
        return b""
    return json.dumps(value, sort_keys=True, separators=(",", ":")).encode()


# copied from jepsen_tpu/codec.py:26-30
def decode(data: bytes | None) -> Any:
    """(codec.clj:20-28)"""
    if data is None or len(data) == 0:
        return None
    return json.loads(data.decode())
