"""Foreign data wrappers — external engines as scannable tables.

The reference's FDW layer lets a foreign server answer scans through a
per-server access driver (PostgreSQL FDW API; the reference ships
gp2gp/jdbc-style wrappers in contrib). Same shape here, sized for this
engine's statement model: a FOREIGN TABLE re-fetches from its server at
every referencing statement (like external tables, planner.py
_refresh_referenced_externals), so queries always see the source's
current rows; everything downstream — distribution, pruning, joins —
treats the fetched batch as an ordinary table.

``register_fdw(name, reader)`` is also the CustomScan-style extension
hook: a reader is any callable (options, schema) -> iterable of row
tuples, so plugging an arbitrary compute source in takes three lines.

Built-in servers:
- ``sqlite``: reads a table or arbitrary query from a SQLite database
  (stdlib sqlite3) — OPTIONS (database '/path/db', table 't') or
  (database '...', query 'select ...').
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np

from cloudberry_tpu_torch import types as T


class FdwError(RuntimeError):
    pass


_SERVERS: dict[str, Callable] = {}


def register_fdw(name: str, reader: Callable[[dict, object],
                                             Iterable[tuple]]) -> None:
    """Register a foreign server: reader(options, schema) -> row tuples."""
    _SERVERS[name.lower()] = reader


def known_servers() -> list[str]:
    return sorted(_SERVERS)


def fetch_foreign(session, t) -> None:
    """(Re)load a foreign table from its server — called at statement
    start for referenced foreign tables."""
    spec = t.foreign
    reader = _SERVERS.get(spec["server"])
    if reader is None:
        raise FdwError(f"unknown foreign server {spec['server']!r} "
                       f"(known: {', '.join(known_servers())})")
    try:
        rows = list(reader(spec["options"], t.schema))
    except FdwError:
        raise
    except Exception as e:  # noqa: BLE001 — driver errors surface as FDW
        raise FdwError(f"foreign table {t.name!r}: {type(e).__name__}: {e}")
    data, validity = rows_to_columns(rows, t.schema, t.dicts)
    t._loading = True  # ephemeral: foreign rows never persist to the store
    try:
        t.set_data(data, t.dicts, validity=validity)
    finally:
        t._loading = False


def rows_to_columns(rows: list[tuple], schema, dicts):
    """Typed python row tuples -> columnar arrays + validity masks
    (NULLs canonicalize later in set_data)."""
    from cloudberry_tpu_torch.columnar.batch import encode_column

    n = len(rows)
    data: dict[str, np.ndarray] = {}
    validity: dict[str, np.ndarray] = {}
    for i, f in enumerate(schema.fields):
        vals = [r[i] if i < len(r) else None for r in rows]
        isnull = np.asarray([v is None for v in vals], dtype=np.bool_)
        if isnull.any() and not f.nullable:
            raise FdwError(f"NULL in NOT NULL foreign column {f.name!r}")
        try:
            if f.dtype == T.DType.DECIMAL:
                scale = 10 ** f.type.scale
                arr = np.asarray(
                    [0 if v is None else int(round(float(v) * scale))
                     for v in vals], dtype=np.int64)
            elif f.dtype in (T.DType.INT32, T.DType.INT64):
                arr = np.asarray([0 if v is None else int(v)
                                  for v in vals]).astype(f.type.np_dtype)
            elif f.dtype == T.DType.FLOAT64:
                arr = np.asarray([0.0 if v is None else float(v)
                                  for v in vals], dtype=np.float64)
            elif f.dtype == T.DType.DATE:
                arr = np.asarray(
                    [0 if v is None else T.date_to_days(str(v))
                     for v in vals]).astype(f.type.np_dtype)
            else:
                arr = encode_column(
                    np.asarray(["" if v is None else str(v)
                                for v in vals], dtype=object), f, dicts)
        except (ValueError, TypeError, OverflowError) as e:
            raise FdwError(f"bad foreign value for column {f.name!r}: {e}")
        data[f.name] = arr
        if isnull.any():
            validity[f.name] = ~isnull
    if not data and n:
        raise FdwError("foreign schema has no columns")
    return data, validity


# ------------------------------------------------------- built-in servers


def _sqlite_reader(options: dict, schema) -> Iterable[tuple]:
    import sqlite3

    db = options.get("database")
    if not db:
        raise FdwError("sqlite server needs OPTIONS (database '...')")
    query = options.get("query")
    if query is None:
        table = options.get("table")
        if not table:
            raise FdwError("sqlite server needs a table or query option")
        if not table.replace("_", "").isalnum():
            raise FdwError(f"bad sqlite table name {table!r}")
        cols = ", ".join(f.name for f in schema.fields)
        query = f"SELECT {cols} FROM {table}"  # noqa: S608 — name checked
    con = sqlite3.connect(f"file:{db}?mode=ro", uri=True)
    try:
        yield from con.execute(query)
    finally:
        con.close()


register_fdw("sqlite", _sqlite_reader)
