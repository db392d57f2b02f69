"""Statement planning + DDL/DML execution.

The dispatch analog of exec_simple_query (src/backend/tcop/postgres.c:1655):
DDL executes directly against the catalog; SELECT goes binder → plan
rewrites (predicate pushdown and column pruning, storage-scan pruning,
the packed-key proof, point lookups, the join-index annotation) →
executable plan. DML — INSERT, COPY FROM/TO with single-row error
handling, DELETE, UPDATE, INSERT … SELECT, CREATE TABLE AS — runs its
synthetic queries through the same executor (``_run_internal``).

This port runs one segment, so there is no distribution pass. The
reference's ``_run_internal`` also takes an admission slot; the port has
no admission control yet. Statements that need modules outside the port
(transactions, matviews, external/foreign/directory tables, resource
queues, cursors, CLUSTER) raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from cloudberry_tpu_torch import types as T
from cloudberry_tpu_torch.catalog.catalog import DistributionPolicy
from cloudberry_tpu_torch.plan import nodes as N
from cloudberry_tpu_torch.plan.binder import BindError, Binder
from cloudberry_tpu_torch.sql import ast
from cloudberry_tpu_torch.types import Field, Schema


@dataclass
class PlanResult:
    is_ddl: bool = False
    ddl_result: Any = None
    plan: Optional[N.PlanNode] = None


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not yet ported to "
                              "cloudberry_tpu_torch")


def plan_statement(stmt: ast.Node, session, params: dict,
                   explain_only: bool = False) -> PlanResult:
    catalog = session.catalog

    if isinstance(stmt, ast.CreateTable):
        if stmt.name.lower() in catalog.views:
            raise BindError(f"{stmt.name!r} already exists as a view")
        fields = []
        for c in stmt.columns:
            t = T.SQL_TYPE_MAP.get(c.type_name)
            if t is None:
                raise BindError(f"unknown type {c.type_name!r}")
            if t.base == T.DType.DECIMAL and c.scale is not None:
                t = T.DECIMAL(c.scale)
            fields.append(Field(c.name, t, nullable=not c.not_null))
        policy = {
            "hash": DistributionPolicy.hashed(*stmt.dist_keys),
            "replicated": DistributionPolicy.replicated(),
            "random": DistributionPolicy.random(),
        }[stmt.distribution]
        catalog.create_table(stmt.name, Schema(tuple(fields)), policy,
                             if_not_exists=stmt.if_not_exists,
                             partition_spec=stmt.partition)
        return PlanResult(is_ddl=True, ddl_result=f"CREATE TABLE {stmt.name}")

    if isinstance(stmt, ast.CreateTableAs):
        return PlanResult(is_ddl=True, ddl_result=_ctas(session, stmt))

    if isinstance(stmt, ast.CreateSequence):
        try:
            catalog.create_sequence(stmt.name, stmt.start, stmt.increment,
                                    if_not_exists=stmt.if_not_exists)
        except ValueError as e:
            raise BindError(str(e))
        return PlanResult(is_ddl=True,
                          ddl_result=f"CREATE SEQUENCE {stmt.name}")

    if isinstance(stmt, ast.DropSequence):
        try:
            catalog.drop_sequence(stmt.name, if_exists=stmt.if_exists)
        except KeyError as e:
            raise BindError(str(e.args[0]))
        return PlanResult(is_ddl=True,
                          ddl_result=f"DROP SEQUENCE {stmt.name}")

    if isinstance(stmt, ast.CreateView):
        if stmt.name.lower() in catalog.tables:
            raise BindError(f"{stmt.name!r} already exists as a table")
        if stmt.name.lower() in catalog.views:
            raise BindError(f"view {stmt.name!r} already exists "
                            "(no OR REPLACE yet)")
        catalog.views[stmt.name.lower()] = stmt.query
        catalog.bump_ddl()
        return PlanResult(is_ddl=True, ddl_result=f"CREATE VIEW {stmt.name}")

    if isinstance(stmt, ast.DropView):
        if stmt.name.lower() not in catalog.views:
            if stmt.if_exists:
                return PlanResult(is_ddl=True, ddl_result="DROP VIEW")
            raise BindError(f"unknown view {stmt.name!r}")
        del catalog.views[stmt.name.lower()]
        catalog.bump_ddl()
        return PlanResult(is_ddl=True, ddl_result=f"DROP VIEW {stmt.name}")

    if isinstance(stmt, ast.DropTable):
        catalog.drop_table(stmt.name, if_exists=stmt.if_exists)
        return PlanResult(is_ddl=True, ddl_result=f"DROP TABLE {stmt.name}")

    if isinstance(stmt, ast.InsertValues):
        res = _insert_values(catalog, stmt)
        _maintain(session, stmt.table)
        return PlanResult(is_ddl=True, ddl_result=res)

    if isinstance(stmt, ast.Explain):
        inner = stmt.stmt
        if isinstance(inner, ast.Select) and not inner.from_refs:
            # plain EXPLAIN has no side effects: fold sequence calls to a
            # placeholder WITHOUT allocating (PostgreSQL semantics)
            inner = _fold_sequence_calls(catalog, inner, allocate=False)
        binder = Binder(catalog)
        plan = binder.bind_query(inner)
        plan = _optimize(plan, session)
        return PlanResult(is_ddl=True, ddl_result=plan.explain())

    if isinstance(stmt, (ast.Select, ast.SetOp, ast.WithQuery)):
        if isinstance(stmt, ast.Select) and not stmt.from_refs:
            # FROM-less sequence calls evaluate host-side at the QD — the
            # coordinator owns the number line (sequence.c '?' protocol).
            stmt = _fold_sequence_calls(catalog, stmt,
                                        allocate=not explain_only)
        binder = Binder(catalog)
        plan = binder.bind_query(stmt)
        return PlanResult(plan=_optimize(plan, session))

    if isinstance(stmt, ast.Analyze):
        t = catalog.table(stmt.table)
        ndv = t.analyze()
        return PlanResult(is_ddl=True,
                          ddl_result=f"ANALYZE {stmt.table} "
                                     f"({len(ndv)} columns)")

    if isinstance(stmt, ast.TxnStmt):
        _not_ported(f"transaction control ({stmt.kind.upper()})")

    if isinstance(stmt, ast.CopyFrom):
        res = _copy_from(session, stmt)
        _maintain(session, stmt.table)
        return PlanResult(is_ddl=True, ddl_result=res)

    if isinstance(stmt, ast.CopyTo):
        return PlanResult(is_ddl=True, ddl_result=_copy_to(session, stmt))

    if isinstance(stmt, ast.Delete):
        res = _delete(session, stmt)
        _maintain(session, stmt.table)
        return PlanResult(is_ddl=True, ddl_result=res)

    if isinstance(stmt, ast.Update):
        res = _update(session, stmt)
        _maintain(session, stmt.table)
        return PlanResult(is_ddl=True, ddl_result=res)

    if isinstance(stmt, ast.InsertSelect):
        res = _insert_select(session, stmt)
        _maintain(session, stmt.table)
        return PlanResult(is_ddl=True, ddl_result=res)

    _not_ported(f"statement {type(stmt).__name__}")


def _maintain(session, table_name: str) -> None:
    """Post-DML hook: the autostats trigger point (autostats.c:283). The
    reference also maintains materialized views here; the port has none
    yet, so that part has nothing to do."""
    _maybe_autostats(session, table_name)


def _maybe_autostats(session, table_name: str) -> None:
    """Auto-ANALYZE after DML (gp_autostats_mode): "on_no_stats" analyzes
    the first time a never-analyzed table is written; "on_change" when the
    row count drifted past autostats_threshold since the last ANALYZE.
    Cold tables are skipped — auto-analyzing would pull the whole table
    into RAM for a statement that never needed it."""
    mode = session.config.planner.autostats
    if mode == "none":
        return
    t = session.catalog.tables.get(table_name.lower())
    if t is None or t.cold:
        return
    ar = t.stats.analyzed_rows
    if ar < 0:
        t.analyze()
        return
    if mode == "on_change":
        thresh = session.config.planner.autostats_threshold
        if abs(int(t.num_rows) - ar) > max(1.0, ar * thresh):
            t.analyze()


def _run_internal(session, query: ast.Node):
    """Plan + execute a synthetic query (DML rewrite machinery). The
    reference runs it under the same admission control and statement
    slot as user queries; the port has no admission control yet."""
    from cloudberry_tpu_torch.exec.executor import execute

    binder = Binder(session.catalog)
    plan = _optimize(binder.bind_query(query), session)
    return execute(plan, session)


def _copy_from(session, stmt: ast.CopyFrom) -> str:
    """Delimited-file ingest (the COPY / gpfdist load path): numeric and
    decimal columns parse through the native C++ codec
    (cloudberry_tpu_torch.native), strings/dates through the host splitter."""
    from cloudberry_tpu_torch.utils.faultinject import fault_point

    fault_point("copy_from")
    from cloudberry_tpu_torch import native

    table = session.catalog.table(stmt.table)
    table.ensure_loaded()
    with open(stmt.path, "rb") as fh:
        buf = fh.read()
    if stmt.header:
        nl = buf.find(b"\n")
        buf = buf[nl + 1:] if nl >= 0 else b""
    d = stmt.delimiter
    db = d.encode()
    if stmt.reject_limit is not None:
        return _copy_from_sreh(session, table, stmt, buf, db)
    # NULLs in the file (\N, or an empty field for non-string columns) need
    # per-row masks: take the host text path. The conservative byte probe
    # keeps the native fast path for files that can't contain NULLs.
    if (b"\\N" in buf or db + db in buf or buf.startswith(db)
            or b"\n" + db in buf or db + b"\n" in buf or buf.endswith(db)):
        return _copy_from_text(table, buf, db)
    fields = table.schema.fields
    text_cols: dict[int, list] = {}
    need_text = [i for i, f in enumerate(fields)
                 if f.dtype in (T.DType.STRING, T.DType.DATE,
                                T.DType.BOOL, T.DType.FLOAT64)]
    if need_text:
        db = d.encode()
        rows = [ln.split(db) for ln in buf.splitlines() if ln]
        for i in need_text:
            try:
                text_cols[i] = [r[i].decode() for r in rows]
            except IndexError:
                raise BindError(
                    f"COPY: a line has fewer than {i + 1} columns")
    parsed: dict[str, np.ndarray] = {}
    n_rows = None
    for i, f in enumerate(fields):
        if f.dtype in (T.DType.INT32, T.DType.INT64):
            arr = native.parse_int64_column(buf, i, d).astype(f.type.np_dtype)
        elif f.dtype == T.DType.DECIMAL:
            # already int64 fixed-point at the field's scale (physical form)
            arr = native.parse_decimal_column(buf, i, f.type.scale, d)
        else:  # FLOAT/BOOL/STRING/DATE through the shared text parser
            arr = _parse_text_column(text_cols[i], f, table)
        if n_rows is None:
            n_rows = len(arr)
        elif len(arr) != n_rows:
            raise BindError(
                f"COPY: column {f.name!r} parsed {len(arr)} rows, "
                f"expected {n_rows} (malformed file?)")
        old = table.data.get(f.name)
        parsed[f.name] = arr if old is None or len(old) == 0 \
            else np.concatenate([old, arr])
    # the file itself carries no NULLs on this path, but appended rows must
    # EXTEND any existing validity masks, not erase them
    new_valid = {c: np.concatenate([v, np.ones(n_rows or 0, dtype=np.bool_)])
                 for c, v in table.validity.items()}
    table.set_data(parsed, table.dicts, validity=new_valid,
                   appended=n_rows or 0)
    return f"COPY {n_rows or 0}"


def _parse_text_column(vals, f, table) -> np.ndarray:
    """One COPY column from text values — shared by the native fast path
    (float/bool/string/date columns) and the NULL-bearing text path."""
    from cloudberry_tpu_torch.columnar.batch import encode_column

    try:
        if f.dtype in (T.DType.INT32, T.DType.INT64):
            return np.asarray([int(v) for v in vals]) \
                .astype(f.type.np_dtype)
        if f.dtype == T.DType.DECIMAL:
            return np.asarray([_exact_decimal(v, f.type.scale)
                               for v in vals], dtype=np.int64)
        if f.dtype == T.DType.FLOAT64:
            return np.asarray([float(v) for v in vals])
        if f.dtype == T.DType.BOOL:
            out = []
            for v in vals:
                lv = str(v).lower()
                if lv in ("t", "true", "1"):
                    out.append(True)
                elif lv in ("f", "false", "0"):
                    out.append(False)
                else:
                    raise BindError(
                        f"COPY: malformed boolean {v!r} in column "
                        f"{f.name!r}")
            return np.asarray(out)
        return encode_column(np.asarray(vals, dtype=object), f, table.dicts)
    except ValueError as e2:
        raise BindError(
            f"COPY: malformed value in column {f.name!r}: {e2}")


def _sreh_convert(tok_b: bytes, f):
    """One field of one row → physical value or None (NULL); raises
    ValueError on a malformed token (the per-row reject decision)."""
    from cloudberry_tpu_torch.types import date_to_days

    tok = tok_b.decode()
    if tok_b == b"\\N" or (tok == "" and f.dtype != T.DType.STRING):
        if not f.nullable:
            raise ValueError(f"null value in NOT NULL column {f.name!r}")
        return None
    if f.dtype in (T.DType.INT32, T.DType.INT64):
        v = int(tok)
        bits = 31 if f.dtype == T.DType.INT32 else 63
        if not -(1 << bits) <= v < (1 << bits):
            raise ValueError(f"value {tok} out of range for {f.name!r}")
        return v
    if f.dtype == T.DType.DECIMAL:
        v = _exact_decimal(tok, f.type.scale)
        if not -(1 << 63) <= v < (1 << 63):
            raise ValueError(f"value {tok} out of range for {f.name!r}")
        return v
    if f.dtype == T.DType.FLOAT64:
        return float(tok)
    if f.dtype == T.DType.BOOL:
        lv = tok.lower()
        if lv in ("t", "true", "1"):
            return True
        if lv in ("f", "false", "0"):
            return False
        raise ValueError(f"malformed boolean {tok!r}")
    if f.dtype == T.DType.DATE:
        return date_to_days(tok)
    return tok  # STRING


def _copy_from_sreh(session, table, stmt: ast.CopyFrom, buf: bytes,
                    db: bytes) -> str:
    """COPY with single-row error handling (cdbsreh.c): malformed rows are
    rejected (and logged with LOG ERRORS) instead of aborting, until the
    SEGMENT REJECT LIMIT trips — then the whole load aborts with nothing
    appended (validation precedes the single set_data)."""
    from cloudberry_tpu_torch.columnar.batch import encode_column

    fields = table.schema.fields
    good: list[list] = []
    errors: list[dict] = []
    lines = [ln for ln in buf.splitlines() if ln]
    limit = stmt.reject_limit

    def tripped() -> bool:
        if stmt.reject_percent:
            return len(errors) * 100 > limit * max(len(lines), 1)
        # cdbsreh.c aborts when the reject count REACHES the limit
        return len(errors) >= limit

    for lineno, ln in enumerate(lines, start=1 + int(stmt.header)):
        toks = ln.split(db)
        if len(toks) != len(fields):
            errors.append({"line": lineno,
                           "errmsg": f"expected {len(fields)} columns, "
                                     f"got {len(toks)}",
                           "rawdata": ln.decode(errors="replace")})
            continue
        try:
            good.append([_sreh_convert(t, f)
                         for t, f in zip(toks, fields)])
        except (ValueError, BindError, OverflowError) as e:
            errors.append({"line": lineno, "errmsg": str(e),
                           "rawdata": ln.decode(errors="replace")})
    if not stmt.reject_percent and tripped():
        raise BindError(
            f"COPY: segment reject limit {limit} reached "
            f"({len(errors)} rejected rows); load aborted")
    if stmt.reject_percent and tripped():
        raise BindError(
            f"COPY: segment reject limit {limit} PERCENT exceeded "
            f"({len(errors)}/{len(lines)} rejected); load aborted")

    n_rows = len(good)
    parsed, new_valid = {}, {}
    for i, f in enumerate(fields):
        vals = [r[i] for r in good]
        isnull = np.asarray([v is None for v in vals], dtype=np.bool_)
        if f.dtype == T.DType.STRING:
            arr = encode_column(
                np.asarray([v if v is not None else "" for v in vals],
                           dtype=object), f, table.dicts)
        else:
            arr = np.asarray([0 if v is None else v for v in vals]) \
                .astype(f.type.np_dtype) if vals else \
                np.zeros(0, dtype=f.type.np_dtype)
        old = table.data.get(f.name)
        n_old = len(old) if old is not None else 0
        parsed[f.name] = arr if n_old == 0 else np.concatenate([old, arr])
        old_v = table.validity.get(f.name)
        if isnull.any() or old_v is not None:
            if old_v is None:
                old_v = np.ones(n_old, dtype=np.bool_)
            new_valid[f.name] = np.concatenate([old_v, ~isnull]) \
                if n_old else ~isnull
    table.set_data(parsed, table.dicts, validity=new_valid,
                   appended=n_rows)
    if stmt.log_errors and errors:
        session.copy_errors.setdefault(table.name, []).extend(errors)
    if errors:
        return f"COPY {n_rows} (rejected {len(errors)} rows)"
    return f"COPY {n_rows}"


def _copy_from_text(table, buf: bytes, db: bytes) -> str:
    """COPY FROM host text path with NULL support: \\N is NULL everywhere;
    an empty field is NULL for non-string columns (empty string is a value
    for strings, matching PostgreSQL text-format COPY)."""
    fields = table.schema.fields
    rows = [ln.split(db) for ln in buf.splitlines() if ln]
    n_rows = len(rows)
    parsed = {}
    new_valid = {}
    for i, f in enumerate(fields):
        try:
            toks = [r[i] for r in rows]
        except IndexError:
            raise BindError(f"COPY: a line has fewer than {i + 1} columns")
        if f.dtype == T.DType.STRING:
            isnull = np.asarray([t == b"\\N" for t in toks], dtype=np.bool_)
        else:
            isnull = np.asarray([t in (b"", b"\\N") for t in toks],
                                dtype=np.bool_)
        if isnull.any() and not f.nullable:
            raise BindError(f"COPY: NULL in NOT NULL column {f.name!r}")
        vals = [_NULL_FILL[f.dtype] if m else t.decode()
                for t, m in zip(toks, isnull)]
        arr = _parse_text_column(vals, f, table)
        old = table.data.get(f.name)
        n_old = len(old) if old is not None else 0
        parsed[f.name] = arr if n_old == 0 else np.concatenate([old, arr])
        old_v = table.validity.get(f.name)
        if isnull.any() or old_v is not None:
            if old_v is None:
                old_v = np.ones(n_old, dtype=np.bool_)
            new_valid[f.name] = np.concatenate([old_v, ~isnull]) \
                if n_old else ~isnull
    table.set_data(parsed, table.dicts, validity=new_valid,
                   appended=n_rows)
    return f"COPY {n_rows}"


def _copy_to(session, stmt: ast.CopyTo) -> str:
    """Delimited-file unload (COPY TO / writable-external analog).
    Decimals format from their raw int64 fixed-point (never through float,
    which would round past 2^53); values containing the delimiter or a
    newline are rejected rather than silently corrupting the file."""
    from cloudberry_tpu_torch.types import days_to_date

    table = session.catalog.table(stmt.table)
    table.ensure_loaded()
    n = table.num_rows
    d = stmt.delimiter
    cols = []
    for f in table.schema.fields:
        arr = table.data[f.name]
        if f.dtype == T.DType.DECIMAL:
            cols.append([_fmt_decimal(int(v), f.type.scale) for v in arr])
        elif f.dtype == T.DType.DATE:
            cols.append([str(days_to_date(int(v))) for v in arr])
        elif f.dtype == T.DType.STRING:
            values = table.dicts[f.name].values if f.name in table.dicts \
                else []
            out = []
            for code in arr:
                v = values[code]
                if d in v or "\n" in v:
                    raise BindError(
                        f"COPY TO: value in column {f.name!r} contains the "
                        "delimiter or a newline; choose another DELIMITER")
                out.append(v)
            cols.append(out)
        elif f.dtype == T.DType.FLOAT64:
            cols.append([repr(float(v)) for v in arr])
        else:
            cols.append([str(v) for v in arr])
    for idx, f in enumerate(table.schema.fields):
        vm = table.validity.get(f.name)
        if vm is not None:
            col = cols[idx]
            for i in np.nonzero(~np.asarray(vm))[0]:
                col[i] = "\\N"
    with open(stmt.path, "w") as fh:
        if stmt.header:
            fh.write(d.join(table.schema.names) + "\n")
        for i in range(n):
            fh.write(d.join(c[i] for c in cols) + "\n")
    return f"COPY {n}"


def _fmt_decimal(raw: int, scale: int) -> str:
    if scale == 0:
        return str(raw)
    sign = "-" if raw < 0 else ""
    raw = abs(raw)
    return f"{sign}{raw // 10 ** scale}.{raw % 10 ** scale:0{scale}d}"


def _eval_aligned(session, table_name: str, items: list):
    """Run ``SELECT items FROM table`` (no WHERE — every row, exactly once)
    and return (columns, validity, dicts) ALIGNED to the table's canonical
    host row order.

    This is the DML read path: only the expressions DML actually needs flow
    through the executor — never the whole table. At one segment a RAM
    table scans in its row order and a cold table's scan reads its
    partitions in manifest order, which is the order ``ensure_loaded``
    lays them out in — canonical row order either way (the JAX package's
    distributed un-permutation is not needed)."""
    q = ast.Select(items=items, from_refs=[ast.TableName(table_name)])
    batch = _run_internal(session, q)
    sel = np.asarray(batch.sel)
    cols = {f.name: np.asarray(batch.columns[f.name])[sel]
            for f in batch.schema.fields}
    valid = {n: np.asarray(v).astype(np.bool_)[sel]
             for n, v in batch.validity.items()}
    t = session.catalog.table(table_name)
    n = t.num_rows
    for name, arr in cols.items():
        if len(arr) != n:
            raise BindError(
                f"DML row evaluation returned {len(arr)} rows for "
                f"{table_name!r} ({n} rows) — internal error")
    return cols, valid, dict(batch.dicts)


def _delete(session, stmt: ast.Delete) -> str:
    """DELETE = keep the complement (delete-and-rewrite over immutable
    columns — the visimap-style store path lives in storage/table_store).
    Only the PREDICATE flows through the executor (nodeSplitUpdate.c's
    discipline of shipping decisions, not payloads): survivors are sliced
    from the canonical host arrays, so peak extra memory is one bool column
    plus the survivor arrays — independent of column count."""
    from cloudberry_tpu_torch.utils.faultinject import fault_point

    fault_point("dml_delete")
    table = session.catalog.table(stmt.table)
    table.ensure_loaded()
    before = table.num_rows
    if stmt.where is None:
        table.set_data({f.name: np.zeros(0, dtype=f.type.np_dtype)
                        for f in table.schema.fields}, table.dicts)
        return f"DELETE {before}"
    # DELETE removes rows where the predicate is TRUE; a NULL predicate
    # KEEPS the row (3VL) — so keep NOT pred OR pred IS NULL
    keep_expr = ast.BinOp("or", ast.UnaryOp("not", stmt.where),
                          ast.IsNull(stmt.where, False))
    cols, _, _ = _eval_aligned(session, stmt.table,
                               [ast.SelectItem(keep_expr, "keep")])
    keep = cols["keep"].astype(np.bool_)
    new_data = {f.name: table.data[f.name][keep]
                for f in table.schema.fields}
    new_valid = {c: np.asarray(v)[keep]
                 for c, v in table.validity.items()}
    table.set_data(new_data, table.dicts, validity=new_valid)
    return f"DELETE {before - int(keep.sum())}"


_TYPE_NAME = {T.DType.BOOL: ("boolean", None), T.DType.INT32: ("integer", None),
              T.DType.INT64: ("bigint", None),
              T.DType.FLOAT64: ("double", None),
              T.DType.DATE: ("date", None), T.DType.STRING: ("text", None)}


def _update(session, stmt: ast.Update) -> str:
    """UPDATE col = CASE WHEN pred THEN expr ELSE col END — but ONLY the
    SET columns (plus the predicate) flow through the executor; untouched
    columns pass to set_data as the SAME host arrays, copy-free (the
    nodeSplitUpdate.c role: ship the changed values, not the table). The
    result re-shards lazily if a distribution key changed (version bump
    invalidates the shard cache)."""
    from cloudberry_tpu_torch.utils.faultinject import fault_point

    fault_point("dml_update")
    table = session.catalog.table(stmt.table)
    table.ensure_loaded()
    set_cols = {c for c, _ in stmt.sets}
    unknown = set_cols - set(table.schema.names)
    if unknown:
        raise BindError(f"UPDATE of unknown column(s) {sorted(unknown)}")
    items = []
    sets = dict(stmt.sets)
    set_fields = [f for f in table.schema.fields if f.name in set_cols]
    for f in set_fields:
        src: ast.ExprNode = ast.Name((f.name,))
        expr = sets[f.name]
        if stmt.where is not None:
            val = ast.CaseExpr([(stmt.where, expr)], src)
        elif f.dtype == T.DType.STRING:
            # CASE wrapper even without WHERE: the string-CASE binder is
            # what assigns dictionary codes to string literals
            val = ast.CaseExpr([(ast.BoolLit(True), expr)], src)
        else:
            val = expr
        if f.dtype == T.DType.DECIMAL:
            val = ast.CastExpr(val, "decimal", f.type.scale)
        elif f.dtype != T.DType.STRING:
            tname, _ = _TYPE_NAME[f.dtype]
            val = ast.CastExpr(val, tname)
        items.append(ast.SelectItem(val, f.name))
    if stmt.where is not None:
        items.append(ast.SelectItem(stmt.where, "$updated"))
    cols, valid, qdicts = _eval_aligned(session, stmt.table, items)
    n = table.num_rows
    if stmt.where is not None:
        upd = cols["$updated"].astype(np.bool_)
        if "$updated" in valid:  # NULL predicate updates nothing (3VL)
            upd &= valid["$updated"]
        n_upd = int(upd.sum())
    else:
        n_upd = n
    new_data = dict(table.data)  # untouched columns: same arrays, no copy
    new_valid = dict(table.validity)
    dicts = dict(table.dicts)
    for f in set_fields:
        # the query may have produced codes in a NEW dictionary (string
        # CASE/literal): adopt it — old codes stay valid only because it
        # extends the old one, which _bind_string_case guarantees
        if f.dtype == T.DType.STRING and f.name in qdicts:
            dicts[f.name] = qdicts[f.name]
        new_data[f.name] = cols[f.name].astype(f.type.np_dtype)
        vm = valid.get(f.name)
        if vm is not None:
            new_valid[f.name] = vm
        else:
            new_valid.pop(f.name, None)  # column is now fully valid
    table.set_data(new_data, dicts, validity=new_valid)
    return f"UPDATE {n_upd}"


def _ctas(session, stmt: ast.CreateTableAs) -> str:
    """CREATE TABLE AS: materialize the query, derive the schema from its
    output fields, place per the DISTRIBUTED clause."""
    if stmt.name.lower() in session.catalog.views:
        raise BindError(f"{stmt.name!r} already exists as a view")
    if stmt.name.lower() in session.catalog.tables:
        if stmt.if_not_exists:
            return f"CREATE TABLE {stmt.name} (exists, skipped)"
        raise BindError(f"table {stmt.name!r} already exists")
    batch = _run_internal(session, stmt.query)
    policy = {
        "hash": DistributionPolicy.hashed(*stmt.dist_keys),
        "replicated": DistributionPolicy.replicated(),
        "random": DistributionPolicy.random(),
    }[stmt.distribution]
    if stmt.distribution == "hash":
        missing = set(stmt.dist_keys) - set(batch.schema.names)
        if missing:
            raise BindError(f"distribution key(s) {sorted(missing)} not in "
                            "the query output")
    t = session.catalog.create_table(stmt.name, batch.schema, policy)
    sel = np.asarray(batch.sel)
    data, validity = {}, {}
    for f in batch.schema.fields:
        data[f.name] = np.asarray(batch.columns[f.name])[sel] \
            .astype(f.type.np_dtype)
        vm = batch.validity.get(f.name)
        if vm is not None:
            validity[f.name] = np.asarray(vm).astype(np.bool_)[sel]
    t.set_data(data, dict(batch.dicts), validity=validity)
    return f"SELECT {int(sel.sum())}"


def _physical_convert(arr: np.ndarray, qf, f, qdicts, table) -> np.ndarray:
    """Query-output physical column → target table physical column. Same
    dtype (and, for decimals, same scale; for strings, the same dictionary)
    copies raw physical values — digit-exact for decimals, where a decode
    round-trip through float would lose precision past 2^53. Everything
    else funnels through the shared decode/encode pair."""
    from cloudberry_tpu_torch.columnar.batch import decode_column, encode_column

    if qf.dtype == f.dtype:
        if f.dtype == T.DType.DECIMAL:
            d = f.type.scale - qf.type.scale
            if d == 0:
                return arr.astype(np.int64)
            if d > 0:
                a = arr.astype(np.int64)
                limit = (2 ** 63 - 1) // 10 ** d
                if len(a) and int(np.abs(a).max()) > limit:
                    raise BindError(
                        f"INSERT: value out of range for column "
                        f"{f.name!r} (DECIMAL scale {f.type.scale})")
                return a * np.int64(10 ** d)
            # downscale: round half away from zero, matching numeric
            div = np.int64(10 ** (-d))
            a = arr.astype(np.int64)
            lo = np.iinfo(np.int64).min
            if len(a) and bool((a == lo).any()):
                # |int64.min| overflows np.abs — route those lanes
                # through exact Python ints
                out = np.empty(len(a), dtype=np.int64)
                dv = int(div)
                for i, v in enumerate(a):
                    av, neg = abs(int(v)), int(v) < 0
                    qq, rr = divmod(av, dv)
                    qq += 2 * rr >= dv
                    out[i] = -qq if neg else qq
                return out
            q, r = np.divmod(np.abs(a), div)
            q = q + (2 * r >= div)
            return np.where(arr < 0, -q, q)
        if f.dtype == T.DType.STRING:
            qd = qdicts.get(qf.name)
            td = table.dicts.get(f.name)
            if qd is not None and qd is td:
                return arr.astype(f.type.np_dtype)
        else:
            return arr.astype(f.type.np_dtype)
    vals = decode_column(np.asarray(arr), qf, qdicts)
    return encode_column(np.asarray(vals), f, table.dicts)


def _insert_select(session, stmt: ast.InsertSelect) -> str:
    """INSERT ... SELECT appends the query's PHYSICAL columns directly —
    no pandas round-trip: dictionary codes translate only when the query
    produced a different dictionary, decimals at the target scale copy raw
    int64 (exact), and validity masks carry over as-is."""
    from cloudberry_tpu_torch.utils.faultinject import fault_point

    fault_point("dml_insert_select")
    table = session.catalog.table(stmt.table)
    cols = stmt.columns or table.schema.names
    if list(cols) != list(table.schema.names):
        raise BindError("INSERT ... SELECT must target all columns in "
                        "schema order (no defaults yet)")
    table.ensure_loaded()
    batch = _run_internal(session, stmt.query)
    if len(batch.schema.fields) != len(table.schema.fields):
        raise BindError(
            f"INSERT arity mismatch: query returns "
            f"{len(batch.schema.fields)} columns, table has "
            f"{len(table.schema.fields)}")
    sel = np.asarray(batch.sel)
    new_rows = int(sel.sum())
    new_data = {}
    new_valid = {}
    for f, qf in zip(table.schema.fields, batch.schema.fields):
        arr = np.asarray(batch.columns[qf.name])[sel]
        vm = batch.validity.get(qf.name)
        isna = ~np.asarray(vm).astype(np.bool_)[sel] if vm is not None \
            else np.zeros(new_rows, dtype=np.bool_)
        if isna.any():
            if not f.nullable:
                raise BindError(
                    f"INSERT: NULL in NOT NULL column {f.name!r}")
            if f.dtype == T.DType.STRING:
                # NULL lanes may hold out-of-dictionary codes (e.g. -1
                # from CASE NULL branches): clamp before any translation
                arr = np.where(isna, 0, arr)
        arr = _physical_convert(arr, qf, f, batch.dicts, table)
        old = table.data.get(f.name)
        n_old = len(old) if old is not None else 0
        new_data[f.name] = arr if n_old == 0 \
            else np.concatenate([old, arr])
        old_v = table.validity.get(f.name)
        if isna.any() or old_v is not None:
            if old_v is None:
                old_v = np.ones(n_old, dtype=np.bool_)
            new_valid[f.name] = np.concatenate([old_v, ~isna]) \
                if n_old else ~isna
    table.set_data(new_data, table.dicts, validity=new_valid,
                   appended=new_rows)
    return f"INSERT {new_rows}"


def _optimize(plan: N.PlanNode, session) -> N.PlanNode:
    """The single-segment branch of the reference's rewrites: predicate
    pushdown + column pruning, storage-scan binding (cold tables read
    pruned partitions), the 32-bit packed-key proof that gates the
    probe-join kernel, point lookups on big RAM tables, and — last, so
    the specs see final capacities — the join-index annotation."""
    from cloudberry_tpu_torch.exec.joinindex import annotate_join_index
    from cloudberry_tpu_torch.plan.cost import annotate_pack_bits
    from cloudberry_tpu_torch.plan.pointlookup import optimize_point_lookups
    from cloudberry_tpu_torch.plan.prune import prune_plan
    from cloudberry_tpu_torch.plan.scanprune import apply_storage_scans

    plan = prune_plan(plan)
    apply_storage_scans(plan, session)
    annotate_pack_bits(plan, session.catalog)
    optimize_point_lookups(plan, session)
    annotate_join_index(plan, session)
    return plan


_NULL = object()   # sentinel for a NULL literal in VALUES

_NULL_FILL = {T.DType.BOOL: False, T.DType.INT32: "0", T.DType.INT64: "0",
              T.DType.FLOAT64: "0", T.DType.DECIMAL: "0",
              T.DType.DATE: "1970-01-01", T.DType.STRING: ""}


def _insert_values(catalog, stmt: ast.InsertValues) -> str:
    from cloudberry_tpu_torch.columnar.batch import encode_column

    table = catalog.table(stmt.table)
    table.ensure_loaded()  # appends need the existing rows in RAM
    cols = stmt.columns or table.schema.names
    if set(cols) != set(table.schema.names):
        raise BindError("INSERT must target all columns (no defaults yet)")
    by_col: dict[str, list] = {c: [] for c in cols}
    for row in stmt.rows:
        if len(row) != len(cols):
            raise BindError("INSERT row arity mismatch")
        for c, v in zip(cols, row):
            sv = _eval_sequence_call(catalog, v)
            by_col[c].append(str(sv) if sv is not None
                             else _literal_value(v))
    new_data = {}
    new_valid = {}
    for f in table.schema.fields:
        raw = by_col[f.name]
        isnull = np.asarray([v is _NULL for v in raw], dtype=np.bool_)
        if isnull.any():
            if not f.nullable:
                raise BindError(
                    f"INSERT: NULL in NOT NULL column {f.name!r}")
            raw = [_NULL_FILL[f.dtype] if v is _NULL else v for v in raw]
        try:
            if f.dtype == T.DType.DECIMAL:
                # exact fixed-point from the literal TEXT — a float
                # round-trip loses precision beyond 2^53
                arr = np.asarray(
                    [_exact_decimal(v, f.type.scale) for v in raw],
                    dtype=np.int64)
            elif f.dtype in (T.DType.INT32, T.DType.INT64):
                arr = np.asarray([_int_literal(v) for v in raw]) \
                    .astype(f.type.np_dtype)
            elif f.dtype == T.DType.FLOAT64:
                arr = np.asarray([float(v) for v in raw])
            else:
                arr = encode_column(np.asarray(raw), f, table.dicts)
        except (ValueError, TypeError, OverflowError) as e2:
            raise BindError(
                f"INSERT: bad literal for column {f.name!r}: {e2}")
        old = table.data.get(f.name)
        n_old = len(old) if old is not None else 0
        new_data[f.name] = arr if n_old == 0 \
            else np.concatenate([old, arr])
        old_v = table.validity.get(f.name)
        if isnull.any() or old_v is not None:
            if old_v is None:
                old_v = np.ones(n_old, dtype=np.bool_)
            new_valid[f.name] = np.concatenate([old_v, ~isnull]) \
                if n_old else ~isnull
    table.set_data(new_data, table.dicts, validity=new_valid,
                   appended=len(stmt.rows))
    return f"INSERT {len(stmt.rows)}"


def _exact_decimal(v, scale: int) -> int:
    """Literal text/int → int64 fixed-point, digit-exact."""
    text = str(v)
    neg = text.startswith("-")
    if neg:
        text = text[1:]
    if "e" in text.lower():
        raise BindError("scientific notation not supported for DECIMAL "
                        "literals (write the digits out)")
    whole, _, frac = text.partition(".")
    frac_digits = frac + "0" * (scale + 1)
    kept, next_digit = frac_digits[:scale], frac_digits[scale]
    out = int(whole or "0") * 10 ** scale + (int(kept) if kept else 0)
    if next_digit >= "5":
        out += 1  # round half up, matching PostgreSQL numeric
    return -out if neg else out


def _int_literal(v) -> int:
    """Literal → int: digit-exact for plain integers (no float round-trip:
    2^53-adjacent bigints must survive), half-away-from-zero rounding for
    fractional text, float only for exponent forms."""
    text = str(v)
    try:
        return int(text)
    except ValueError:
        pass
    if "e" in text.lower():
        import math

        x = float(text)
        return int(math.floor(x + 0.5)) if x >= 0 else \
            int(math.ceil(x - 0.5))
    return _exact_decimal(text, 0)  # digit-exact, rounds half up


_SEQ_FUNCS = ("nextval", "currval", "setval")


def _signed_int_lit(e: ast.ExprNode):
    """Integer from a NumberLit or a negated NumberLit, else None."""
    if isinstance(e, ast.NumberLit):
        try:
            return int(e.text)
        except ValueError:
            return None
    if isinstance(e, ast.UnaryOp) and e.op == "-":
        v = _signed_int_lit(e.operand)
        return -v if v is not None else None
    return None


def _eval_sequence_call(catalog, e: ast.ExprNode):
    """Evaluate nextval/currval/setval('name'[, n]) host-side, or None if
    ``e`` is not a sequence call. Allocation goes through the durable
    store's locked number line when one is bound (catalog.seq_* )."""
    if not (isinstance(e, ast.FuncCall) and e.name in _SEQ_FUNCS):
        return None
    if not e.args or not isinstance(e.args[0], ast.StringLit):
        raise BindError(f"{e.name}() takes a quoted sequence name")
    name = e.args[0].value
    try:
        if e.name == "nextval":
            return catalog.seq_nextval(name)
        if e.name == "currval":
            return catalog.seq_currval(name)
        val = _signed_int_lit(e.args[1]) if len(e.args) == 2 else None
        if val is None:
            raise BindError("setval('name', value) takes an integer value")
        return catalog.seq_setval(name, val)
    except KeyError as k:
        raise BindError(str(k.args[0]))
    except ValueError as v:
        raise BindError(str(v))


def _fold_sequence_calls(catalog, sel: ast.Select,
                         allocate: bool = True) -> ast.Select:
    """Replace sequence calls in a FROM-less select list with the values
    they evaluate to (each call evaluated exactly once, left to right).
    ``allocate=False`` (plain EXPLAIN): a zero placeholder binds the same
    plan shape with NO state change — EXPLAIN never consumes values."""
    if not any(isinstance(i.expr, ast.FuncCall)
               and i.expr.name in _SEQ_FUNCS for i in sel.items):
        return sel
    items = []
    for i, item in enumerate(sel.items):
        if not allocate and isinstance(item.expr, ast.FuncCall) \
                and item.expr.name in _SEQ_FUNCS:
            alias = item.alias or item.expr.name
            items.append(ast.SelectItem(ast.NumberLit("0"), alias))
            continue
        v = _eval_sequence_call(catalog, item.expr)
        if v is None:
            items.append(item)
        else:
            alias = item.alias or item.expr.name
            items.append(ast.SelectItem(ast.NumberLit(str(v)), alias))
    return ast.Select(items=items, from_refs=sel.from_refs,
                      where=sel.where, group_by=sel.group_by,
                      having=sel.having, order_by=sel.order_by,
                      limit=sel.limit, offset=sel.offset,
                      distinct=sel.distinct)


def _literal_value(e: ast.ExprNode):
    if isinstance(e, ast.NumberLit):
        # keep numeric literal TEXT so decimal targets stay digit-exact
        return e.text
    if isinstance(e, ast.StringLit):
        return e.value
    if isinstance(e, ast.DateLit):
        return e.value
    if isinstance(e, ast.BoolLit):
        return e.value
    if isinstance(e, ast.NullLit):
        return _NULL
    if isinstance(e, ast.UnaryOp) and e.op == "-":
        inner = _literal_value(e.operand)
        return f"-{inner}" if isinstance(inner, str) else -inner
    raise BindError("INSERT VALUES must be literals")

