"""Statement planning + DDL/DML execution.

The dispatch analog of exec_simple_query (src/backend/tcop/postgres.c:1655):
DDL executes directly against the catalog; SELECT goes binder → plan
rewrites → executable plan. This port runs one segment over RAM tables, so
the distribution pass, storage scan pruning, point lookups and the
join-index annotation are not part of it; statements that need modules
outside the port (COPY, UPDATE/DELETE, matviews, external/foreign/directory
tables, resource queues, cursors, CLUSTER) raise ``NotImplementedError``.
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
        _maybe_autostats(session, stmt.table)
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

    _not_ported(f"statement {type(stmt).__name__}")


def _maybe_autostats(session, table_name: str) -> None:
    """Auto-ANALYZE after DML (gp_autostats_mode): "on_no_stats" analyzes
    the first time a never-analyzed table is written; "on_change" when the
    row count drifted past autostats_threshold since the last ANALYZE."""
    mode = session.config.planner.autostats
    if mode == "none":
        return
    t = session.catalog.tables.get(table_name.lower())
    if t is None:
        return
    ar = t.stats.analyzed_rows
    if ar < 0:
        t.analyze()
        return
    if mode == "on_change":
        thresh = session.config.planner.autostats_threshold
        if abs(int(t.num_rows) - ar) > max(1.0, ar * thresh):
            t.analyze()


def _optimize(plan: N.PlanNode, session) -> N.PlanNode:
    """Single-segment RAM-table rewrites: predicate pushdown + column
    pruning, then the 32-bit packed-key proof that gates the probe-join
    kernel. The JAX package's storage-scan pruning, point lookups and
    join-index annotation change no result and are left out."""
    from cloudberry_tpu_torch.plan.cost import annotate_pack_bits
    from cloudberry_tpu_torch.plan.prune import prune_plan

    plan = prune_plan(plan)
    annotate_pack_bits(plan, session.catalog)
    return plan


_NULL = object()   # sentinel for a NULL literal in VALUES

_NULL_FILL = {T.DType.BOOL: False, T.DType.INT32: "0", T.DType.INT64: "0",
              T.DType.FLOAT64: "0", T.DType.DECIMAL: "0",
              T.DType.DATE: "1970-01-01", T.DType.STRING: ""}


def _insert_values(catalog, stmt: ast.InsertValues) -> str:
    from cloudberry_tpu_torch.columnar.batch import encode_column

    table = catalog.table(stmt.table)
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

