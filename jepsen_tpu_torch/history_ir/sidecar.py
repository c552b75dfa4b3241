"""The history IR's ``.npz`` sidecar (jepsen_tpu/history_ir/sidecar.py).

``store.write_columnar``/``store.load_columnar`` delegate here: the
``history.npz`` sidecar next to ``history.jsonl`` is the serialized
:class:`~jepsen_tpu_torch.history_ir.ir.DeviceHistory` — canonical packed
columns, the value intern table (each value canonical-JSON-encoded by
:mod:`jepsen_tpu_torch.codec`), plus the derived view products that make
re-checks a pure array pipeline:

* ``elle_*`` — the Elle builder columns
  (:func:`jepsen_tpu_torch.history_ir.views.elle_columns`), read by
  ``elle.columnar.check_columns``;
* ``lin_*`` — the register EventStream
  (:func:`~jepsen_tpu_torch.history_ir.views.register_stream` through
  :func:`stream_to_columns`), read by
  ``checker.linearizable.check_stored``.

Both packages write the same keys, arrays and ``val_table`` rows, and
nothing in the file names the package that wrote it: a sidecar written
by either loads in the other. The port deflates at level 1, the
reference at numpy's level 6.

=================  ========================================================
key                contents
=================  ========================================================
``types``..        the canonical int columns (ir.CANONICAL_COLUMNS order);
``value_ids``      ``value_ids`` int32 into the intern table
``f_table``        object array of f names
``val_table``      object array of canonical-JSON-encoded intern values
                   (ids 1.., id 0 = None implicit); absent when any value
                   is not JSON-encodable
``elle_*``         Elle builder columns (integer regime only)
``lin_*``          register EventStream columns (register shape only)
=================  ========================================================
"""
from __future__ import annotations

import logging
import os
import zipfile

import numpy as np

from jepsen_tpu_torch.history import Intern
from jepsen_tpu_torch.history_ir.ir import CANONICAL_COLUMNS, DeviceHistory

logger = logging.getLogger("jepsen_tpu_torch.history_ir")


# copied from jepsen_tpu/history_ir/sidecar.py:55-66
def intern_to_rows(intern: Intern) -> list[str] | None:
    """The intern table (ids 1..) as canonical-JSON rows, or None when
    any value isn't codec-encodable (the sidecar then omits the value
    columns; history.jsonl remains authoritative for values)."""
    from jepsen_tpu_torch import codec
    rows = []
    for v in intern.table[1:]:
        try:
            rows.append(codec.encode(v).decode("utf-8"))
        except (TypeError, ValueError, UnicodeDecodeError):
            return None
    return rows


# copied from jepsen_tpu/history_ir/sidecar.py:69-90
def intern_from_rows(rows) -> Intern:
    """Rebuilds the value Intern from :func:`intern_to_rows` output.

    Ids are POSITIONAL: each row appends at its own index, never
    deduplicates — two distinct ids whose canonical-JSON rows collide
    (a tuple and a list with equal contents, dicts differing only in
    key order) must keep their ids, or every ``value_ids`` entry after
    the collision would point at the wrong value. The lookup map gets
    the first occurrence, so later ``id()`` calls stay consistent."""
    from jepsen_tpu_torch import codec
    from jepsen_tpu_torch.history_ir.ir import ValueIntern
    intern = ValueIntern()
    for row in rows:
        v = codec.decode(str(row).encode("utf-8"))
        i = len(intern.table)
        intern.table.append(v)
        try:
            intern._ids.setdefault(v, i)
        except TypeError:
            intern._ids.setdefault(("__unhashable__", repr(v)), i)
    return intern


# copied from jepsen_tpu/history_ir/sidecar.py:98-116
def stream_to_columns(stream) -> dict | None:
    """The stream as plain persistable arrays (the ``lin_*`` sidecar
    keys), or None when the intern table holds non-int values (beyond
    the id-0 None sentinel) — those can't round-trip through an int64
    column."""
    vals = stream.intern.table[1:]
    if not all(type(v) is int for v in vals):
        return None
    return {
        "kind": np.asarray(stream.kind, np.int8),
        "slot": np.asarray(stream.slot, np.int32),
        "f": np.asarray(stream.f, np.int32),
        "a": np.asarray(stream.a, np.int32),
        "b": np.asarray(stream.b, np.int32),
        "op_index": np.asarray(stream.op_index, np.int32),
        "n_slots": np.int64(stream.n_slots),
        "n_ops": np.int64(stream.n_ops),
        "intern_table": np.asarray(vals, np.int64),
    }


# copied from jepsen_tpu/history_ir/sidecar.py:119-135
def stream_from_columns(cols: dict):
    """Rebuilds an EventStream from stream_to_columns' product (the
    ``lin_*`` column dict either package persists)."""
    from jepsen_tpu_torch.checker.linear_encode import EventStream
    intern = Intern()
    for v in np.asarray(cols["intern_table"]).tolist():
        intern.id(int(v))
    return EventStream(
        kind=np.asarray(cols["kind"], np.int8),
        slot=np.asarray(cols["slot"], np.int32),
        f=np.asarray(cols["f"], np.int32),
        a=np.asarray(cols["a"], np.int32),
        b=np.asarray(cols["b"], np.int32),
        op_index=np.asarray(cols["op_index"], np.int32),
        n_slots=int(cols["n_slots"]),
        n_ops=int(cols["n_ops"]),
        intern=intern,
    )


# copied from jepsen_tpu/history_ir/sidecar.py:143-169
def derived_view_arrays(dh: DeviceHistory) -> dict:
    """The ``elle_*``/``lin_*`` view products worth persisting for this
    history's shape, derived through the IR's memoized views (so a run
    whose checkers already built them pays nothing here)."""
    from jepsen_tpu_torch.history_ir import views
    extra: dict = {}
    try:
        ecols = views.elle_columns(dh)
        if ecols is not None:
            extra.update({f"elle_{k}": v for k, v in ecols.items()})
    except Exception:  # noqa: BLE001 - the sidecar is an optimization
        logger.warning("elle sidecar columns failed; omitting them",
                       exc_info=True)
    # single-register histories additionally persist the encoded
    # EventStream (lin_* keys) so linearizability re-checks skip the
    # jsonl + re-encoding (checker/linearizable.check_stored). Cheap
    # shape probe first: the encoder's pairing pre-pass is a full O(n)
    # walk and must not run on every non-register history
    from jepsen_tpu_torch.store import first_client_f
    if first_client_f(dh.ops) in ("read", "write", "cas"):
        try:
            lcols = stream_to_columns(views.register_stream(dh))
            if lcols is not None:
                extra.update({f"lin_{k}": v for k, v in lcols.items()})
        except Exception:  # noqa: BLE001 - wrong shape after all
            logger.warning("register sidecar columns failed; omitting "
                           "them", exc_info=True)
    return extra


def _savez(path, arrays: dict) -> None:
    """``np.savez_compressed(path, **arrays)`` at deflate level 1: the
    same archive of ``.npy`` members, which ``np.load`` reads alike, written
    several times faster than at numpy's level 6 for a slightly larger
    file (the 50k-txn list-append sidecar: about 8 % larger)."""
    path = os.fspath(path)
    if not path.endswith(".npz"):
        path += ".npz"
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED,
                         compresslevel=1, allowZip64=True) as zf:
        for name, a in arrays.items():
            with zf.open(f"{name}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(a),
                                          allow_pickle=True)


# copied from jepsen_tpu/history_ir/sidecar.py:172-185, written at deflate
# level 1 (_savez)
def save(path, dh: DeviceHistory) -> None:
    """Writes the IR (canonical columns + intern table + derived view
    products) as the ``history.npz`` sidecar at ``path``."""
    arrays = {name: getattr(dh, name) for name in CANONICAL_COLUMNS
              if getattr(dh, name) is not None}
    arrays["f_table"] = np.asarray(dh.f_table, dtype=object)
    rows = intern_to_rows(dh.intern)
    if rows is not None:
        arrays["val_table"] = np.asarray(rows, dtype=object)
    else:
        # values not JSON-encodable: the id column is meaningless
        # without its table
        arrays.pop("value_ids", None)
    arrays.update(derived_view_arrays(dh))
    _savez(path, arrays)


# copied from jepsen_tpu/history_ir/sidecar.py:188-207
def load(path) -> DeviceHistory:
    """Reloads a sidecar as a DeviceHistory (sans Python op dicts —
    those live in history.jsonl). Archives from before the IR degrade
    gracefully: missing ``val_table`` loads an empty intern, missing
    ``f_table`` degrades to int f codes only."""
    with np.load(path, allow_pickle=True) as z:
        f_table = ([None if x is None else str(x) for x in z["f_table"]]
                   if "f_table" in z else [])
        intern = (intern_from_rows(z["val_table"])
                  if "val_table" in z else Intern())
        return DeviceHistory(
            types=z["types"], processes=z["processes"], fs=z["fs"],
            times=z["times"], indices=z["indices"],
            completion_of=z["completion_of"],
            invocation_of=z["invocation_of"],
            f_table=f_table,
            value_ids=(z["value_ids"] if "value_ids" in z else None),
            intern=intern)
