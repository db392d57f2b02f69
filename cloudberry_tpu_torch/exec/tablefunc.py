"""Set-returning table functions — the Function Scan / TableFunction
node analog (reference: src/backend/executor/nodeFunctionscan.c, the
TableFunction executor node).

A table function evaluates HOST-SIDE at bind time — its arguments are
constants, as in the JAX package, whose one-program model has no per-row
function scans — and materializes as a TRANSIENT replicated table: every
segment sees the full rows, the General locus the reference gives
function scans, so joins against it need no motion. Rows refresh at every
referencing statement (the JAX package's foreign-table re-fetch
discipline), so non-deterministic functions always show current output;
a statement over function rows never enters the statement cache or the
generic plans (``Session._any_external``).

``register_table_function(name, fn)`` is the extension hook (the
CustomScan-style surface): fn is any callable
``(*args) -> dict[str, np.ndarray]`` — or a bare ndarray, which names
its single column after the function. Strings may come as object
arrays; they dictionary-encode here.

Built-ins: ``generate_series(start, stop [, step])`` (inclusive stop,
PG semantics).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from cloudberry_tpu_torch import types as T
from cloudberry_tpu_torch.columnar.dictionary import StringDictionary
from cloudberry_tpu_torch.types import Schema

_FUNCS: dict[str, Callable] = {}


def register_table_function(name: str, fn: Callable) -> None:
    _FUNCS[name.lower()] = fn


def lookup(name: str):
    return _FUNCS.get(name.lower())


def known_functions() -> list[str]:
    return sorted(_FUNCS)


def _field_type(name: str, arr: np.ndarray):
    k = arr.dtype.kind
    if k == "b":
        return T.BOOL
    if k in "iu":
        return T.INT64 if arr.dtype.itemsize > 4 else T.INT32
    if k == "f":
        return T.FLOAT64
    if k in "OU":
        return T.STRING
    raise ValueError(
        f"table function column {name!r}: unsupported dtype {arr.dtype}")


# bind-time materialization guards: the binder runs BEFORE admission,
# so table functions get their own host-memory cap and a bounded pool
# of transient tables (module attrs — adjustable by embedders)
MAX_RESULT_BYTES = 1 << 30
MAX_TRANSIENT_TABLES = 16


def begin_statement(catalog) -> None:
    """Reset the CURRENT THREAD's per-statement pin set. Tables
    materialized while one statement binds must survive until that
    statement plans — FIFO eviction alone would drop an early function
    table when a single query references >= MAX_TRANSIENT_TABLES
    distinct calls, leaving a later scan pointing at a removed catalog
    entry. Pins are keyed by thread because a shared-session server
    binds concurrent SELECTs on one catalog under a shared read lock;
    a global set would let statement B's reset unpin statement A's
    tables mid-bind. Entries for finished threads are pruned here so a
    dead thread's pins cannot exhaust the pool."""
    import threading

    pins = catalog.__dict__.setdefault("_tf_pinned", {})
    live = {t.ident for t in threading.enumerate()}
    for tid in list(pins):
        if tid not in live:
            pins.pop(tid, None)
    pins[threading.get_ident()] = set()


def _pin(catalog, tname: str) -> None:
    import threading

    pins = catalog.__dict__.setdefault("_tf_pinned", {})
    pins.setdefault(threading.get_ident(), set()).add(tname)


def _evict_transients(catalog) -> None:
    pins = getattr(catalog, "_tf_pinned", None) or {}
    # honor EVERY live statement's pins, not just this thread's
    pinned = set().union(*pins.values()) if pins else frozenset()
    total = sum(1 for n in catalog.tables if n.startswith("$tf_"))
    tfs = [n for n in catalog.tables
           if n.startswith("$tf_") and n not in pinned]
    while total >= MAX_TRANSIENT_TABLES:
        if not tfs:
            raise ValueError(
                "statement references more than "
                f"{MAX_TRANSIENT_TABLES} distinct table-function "
                "results (the transient-table pool size); raise "
                "cloudberry_tpu_torch.exec.tablefunc.MAX_TRANSIENT_TABLES")
        # FIFO (dict preserves insertion order). No SQL name can spell a
        # $-prefixed table, so direct removal needs no ddl bump
        del catalog.tables[tfs.pop(0)]
        total -= 1


def materialize(catalog, fname: str, fn: Callable, vals: list) -> str:
    """Run the function and (re)materialize its transient table; returns
    the catalog name."""
    from cloudberry_tpu_torch.catalog.catalog import DistributionPolicy

    fname = fname.lower()
    cols = fn(*vals)
    if isinstance(cols, np.ndarray):
        cols = {fname: cols}
    # SQL identifiers lowercase in the lexer: an uppercase column name
    # would be unreachable from any query
    cols = {k.lower(): np.asarray(v) for k, v in cols.items()}
    if not cols:
        raise ValueError(f"table function {fname!r} returned no columns")
    ns = {len(v) for v in cols.values()}
    if len(ns) != 1:
        raise ValueError(
            f"table function {fname!r}: ragged column lengths {sorted(ns)}")
    total = 0
    for v in cols.values():
        if v.dtype.kind in "OU":
            # object arrays report pointer size as nbytes; measure the
            # actual string payload, stopping once the cap is blown
            for x in v:
                total += len(str(x))
                if total > MAX_RESULT_BYTES:
                    break
        else:
            total += v.nbytes
        if total > MAX_RESULT_BYTES:
            raise ValueError(
                f"table function {fname!r}: result exceeds the "
                f"{MAX_RESULT_BYTES >> 20} MiB cap — function rows "
                "materialize host-side at bind time")

    data: dict[str, np.ndarray] = {}
    dicts: dict[str, StringDictionary] = {}
    fields = []
    for cname, arr in cols.items():
        t = _field_type(cname, arr)
        if t is T.STRING:
            d = StringDictionary()
            data[cname] = d.encode(arr.astype(object))
            dicts[cname] = d
        else:
            data[cname] = arr
        fields.append((cname, t))

    tname = "$tf_" + fname + "_" + format(
        abs(hash((fname,) + tuple(map(repr, vals)))) % (1 << 40), "x")
    schema = Schema.of(**dict(fields))
    t = catalog.tables.get(tname)
    if t is not None and [(f.name, f.type) for f in t.schema.fields] != \
            [(f.name, f.type) for f in schema.fields]:
        # the function was re-registered with a different output shape:
        # the old transient table's schema would lie to the scan
        del catalog.tables[tname]
        t = None
    if t is not None:
        # refresh the FIFO position: a reused table must not be the next
        # eviction victim while the current statement still binds it
        catalog.tables[tname] = catalog.tables.pop(tname)
    if t is None:
        _evict_transients(catalog)
        t = catalog.create_table(tname, schema,
                                 DistributionPolicy.replicated(),
                                 durable=False, bump=False)
        # statements over function rows never enter the statement cache
        # (session._any_external): the function re-runs per statement,
        # like a foreign table's re-fetch
        t._tablefunc = True
    _pin(catalog, tname)  # current statement's bind must not evict it
    t._loading = True  # ephemeral: function rows never persist
    try:
        t.set_data(data, dicts)
    finally:
        t._loading = False
    return tname


_SERIES_CAP = 100_000_000


def generate_series(start, stop, step=1):
    if start is None or stop is None or step is None:
        # strict function, NULL argument -> zero rows (PG semantics)
        return {"generate_series": np.zeros(0, dtype=np.int64)}
    for v in (start, stop, step):
        if float(v) != int(v):
            raise ValueError("generate_series: integer arguments required")
    start, stop, step = int(start), int(stop), int(step)
    if step == 0:
        raise ValueError("generate_series: step must not be zero")
    count = max(0, (stop - start) // step + 1)
    if count > _SERIES_CAP:
        raise ValueError(
            f"generate_series: {count} rows exceeds the cap {_SERIES_CAP}")
    end = stop + (1 if step > 0 else -1)
    return {"generate_series": np.arange(start, end, step,
                                         dtype=np.int64)}


register_table_function("generate_series", generate_series)
