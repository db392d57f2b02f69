"""Directory tables — files as catalog objects (the dirtable analog).

The reference's directory tables store uploaded files in table-managed
storage and expose one metadata row per file (relative_path, size,
last_modified, md5), loaded via gpdirtableload and read through UDFs.
Analog: files live under ``<store>/_dirtab/<table>/``; the catalog entry
is a metadata relation refreshed from the filesystem at every
referencing statement (planner.py hook), so SQL sees uploads
immediately; content IO goes through the Session API
(``dir_upload`` / ``dir_read`` / ``dir_remove``). Under TDE
(storage.encryption_key) file contents encrypt at rest like any other
store data.
"""

from __future__ import annotations

import hashlib
import os
import time

import numpy as np

from cloudberry_tpu_torch import types as T


class DirTableError(RuntimeError):
    pass


SCHEMA = T.Schema.of(relative_path=T.STRING, size=T.INT64,
                     last_modified=T.STRING, md5=T.STRING)


def _root(session, table: str) -> str:
    if session.store is None:
        raise DirTableError(
            "directory tables need durable storage (storage.root)")
    return os.path.join(session.store.root, "_dirtab", table.lower())


def _safe(table: str, rel: str) -> str:
    rel = rel.strip("/")
    if not rel or ".." in rel.split("/"):
        raise DirTableError(f"bad relative path {rel!r}")
    return rel


def create(session, name: str) -> None:
    from cloudberry_tpu_torch.catalog.catalog import DistributionPolicy

    os.makedirs(_root(session, name), exist_ok=True)
    # metadata relation: ephemeral catalog entry (durable=False) — the
    # DIRECTORY is the durable state; rows re-derive from it per statement
    t = session.catalog.create_table(name, SCHEMA,
                                     DistributionPolicy.random(),
                                     durable=False)
    t.directory = {"table": name.lower()}


def upload(session, table: str, rel: str, data: bytes) -> str:
    from cloudberry_tpu_torch.storage import iofault

    root = _root(session, table)
    if not os.path.isdir(root):
        raise DirTableError(f"unknown directory table {table!r}")
    rel = _safe(table, rel)
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cipher = session.store.cipher
    # durable like any other store write: an upload the catalog row will
    # advertise must survive a crash (and IO faults surface typed)
    iofault.durable_write(
        path, cipher.encrypt(data) if cipher is not None else data)
    return rel


def read(session, table: str, rel: str) -> bytes:
    from cloudberry_tpu_torch.lifecycle import StorageIOError
    from cloudberry_tpu_torch.storage import iofault

    path = os.path.join(_root(session, table), _safe(table, rel))
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        raise DirTableError(f"no file {rel!r} in directory table {table!r}")
    except OSError as e:
        # an EIO is NOT "no such file" — surface it as the retryable
        # storage fault it is, and count it
        iofault.note_io_error(path, e)
        raise StorageIOError(f"{path}: {e}") from e
    cipher = session.store.cipher
    return cipher.decrypt(raw) if cipher is not None else raw


def remove(session, table: str, rel: str) -> None:
    from cloudberry_tpu_torch.lifecycle import StorageIOError
    from cloudberry_tpu_torch.storage import iofault

    path = os.path.join(_root(session, table), _safe(table, rel))
    try:
        os.remove(path)
    except FileNotFoundError:
        raise DirTableError(f"no file {rel!r} in directory table {table!r}")
    except OSError as e:
        iofault.note_io_error(path, e)
        raise StorageIOError(f"{path}: {e}") from e


def refresh(session, t) -> None:
    """Re-derive the metadata rows from the directory (statement-start
    hook). md5 is of the DECRYPTED content — the identity of what the
    user uploaded, stable across key rotation."""
    root = _root(session, t.directory["table"])
    cipher = session.store.cipher
    rows = []
    for dirpath, _, files in os.walk(root):
        for fname in sorted(files):
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, "rb") as f:
                raw = f.read()
            if cipher is not None:
                raw = cipher.decrypt(raw)
            st = os.stat(path)
            rows.append((rel, len(raw),
                         time.strftime("%Y-%m-%d %H:%M:%S",
                                       time.gmtime(st.st_mtime)),
                         hashlib.md5(raw).hexdigest()))
    rows.sort()
    data = {
        "relative_path": np.asarray([r[0] for r in rows], dtype=object),
        "size": np.asarray([r[1] for r in rows], dtype=np.int64),
        "last_modified": np.asarray([r[2] for r in rows], dtype=object),
        "md5": np.asarray([r[3] for r in rows], dtype=object),
    }
    from cloudberry_tpu_torch.columnar.batch import encode_column

    enc = {}
    for f in SCHEMA.fields:
        arr = data[f.name]
        enc[f.name] = encode_column(arr, f, t.dicts) \
            if f.dtype == T.DType.STRING else arr
    t._loading = True  # metadata rows never persist — the directory is
    try:              # the durable state
        t.set_data(enc, t.dicts)
    finally:
        t._loading = False
