"""Materialized views: AQUMV query rewrite + incremental maintenance.

Three reference subsystems re-expressed for this engine:

- CREATE/REFRESH/DROP MATERIALIZED VIEW (src/backend/commands/matview.c):
  the view body materializes into an ordinary table through the same
  machinery as CREATE TABLE AS; the defining query persists in the store's
  ``_MATVIEWS.json`` so every session on a root sees the same definitions.

- AQUMV — answer-query-using-matview (optimizer/plan/aqumv.c): a SELECT
  whose shape is subsumed by a FRESH aggregate matview rewrites to read the
  matview instead of the base table: group keys a subset of the view's,
  predicates over view keys only, and each aggregate derivable by
  re-aggregation (sum of sums, sum of counts, min of mins, max of maxs) —
  correct because the view partitions base rows by its full key set.

- IVM — incremental view maintenance (matview.c IMMV triggers,
  gp_matview_aux): CREATE INCREMENTAL MATERIALIZED VIEW restricts the body
  to one-table aggregates over NOT NULL keys/args; INSERT/COPY then merge
  the appended rows' delta aggregation into the stored view (no triggers —
  the DML paths call ``maintain_on_append`` directly, this engine's
  statement loop being single-process). UPDATE/DELETE merge the
  (subtract, add) delta frames the planner captures (``maintain_on_dml``)
  and fall back to an immediate full refresh where the delta cannot
  express the result (min/max, float sums, no count); transaction
  ROLLBACK conservatively marks every view stale (AQUMV then skips them
  until refreshed).

In the port the views' rows are host arrays like every table's: the
merges run in pandas over numpy, never over tensors, and the view's
table is uploaded to the device when a statement scans it.

Shape analysis and the delta merge run host-side on the PHYSICAL column
representation (int64 fixed-point decimals, day-number dates), so
re-aggregation is bit-exact; string keys decode through their side's
dictionary for the merge and re-encode into the view's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from cloudberry_tpu_torch.sql import ast

_AGG_FUNCS = ("sum", "count", "min", "max")


@dataclass
class MatViewDef:
    name: str
    sql: str                      # defining query text (re-parsed on load)
    query: ast.Node               # parsed defining query
    incremental: bool = False
    # aggregate shape (None = opaque body: refresh-only, no AQUMV/IVM)
    base_table: Optional[str] = None
    keys: list = field(default_factory=list)   # [(mv_alias, base_col)]
    aggs: list = field(default_factory=list)   # [(mv_alias, func, argcol)]
    # freshness: the base table's in-session _version as of the last
    # materialize/maintain; None = stale (AQUMV skips)
    fresh_token: Optional[int] = None
    base_store_version: int = 0


class MatViewError(ValueError):
    pass


# --------------------------------------------------------------- definition


def analyze_shape(q: ast.Node):
    """(base_table, keys, aggs) when the body is a one-table aggregate the
    rewriter/maintainer understands, else (None, [], [])."""
    if not isinstance(q, ast.Select) or q.distinct or q.having is not None \
            or q.where is not None or q.limit is not None or q.offset:
        return None, [], []
    if len(q.from_refs) != 1 or not isinstance(q.from_refs[0], ast.TableName):
        return None, [], []
    base = q.from_refs[0].name
    group_names = []
    for g in q.group_by:
        if not (isinstance(g, ast.Name) and len(g.parts) == 1):
            return None, [], []
        group_names.append(g.parts[0])
    keys, aggs = [], []
    for item in q.items:
        e = item.expr
        if isinstance(e, ast.Name) and len(e.parts) == 1 \
                and e.parts[0] in group_names:
            keys.append((item.alias or e.parts[0], e.parts[0]))
        elif isinstance(e, ast.FuncCall) and e.name in _AGG_FUNCS \
                and not e.distinct:
            if e.star or not e.args:
                if e.name != "count":
                    return None, [], []
                aggs.append((item.alias or "count", "count", None))
            elif isinstance(e.args[0], ast.Name) and len(e.args[0].parts) == 1:
                aggs.append((item.alias or f"{e.name}_{e.args[0].parts[0]}",
                             e.name, e.args[0].parts[0]))
            else:
                return None, [], []
        else:
            return None, [], []
    if len(keys) != len(group_names) or not aggs:
        return None, [], []
    return base, keys, aggs


def _check_incremental(session, d: MatViewDef) -> None:
    """INCREMENTAL views need the exact-delta property: a recognized
    aggregate shape over NOT NULL keys and args, with no string aggregate
    arguments (string extremes compare by collation — not mergeable on
    physical codes)."""
    from cloudberry_tpu_torch.types import DType

    if d.base_table is None:
        raise MatViewError(
            "INCREMENTAL MATERIALIZED VIEW requires a one-table "
            "sum/count/min/max aggregate body (the IMMV restriction)")
    try:
        t = session.catalog.table(d.base_table)
    except KeyError:
        raise MatViewError(f"unknown table {d.base_table!r}")
    for _, col in d.keys:
        if t.schema.field(col).nullable:
            raise MatViewError(
                f"INCREMENTAL view key {col!r} must be NOT NULL")
    for _, func, col in d.aggs:
        if col is None:
            continue
        f = t.schema.field(col)
        if f.nullable:
            raise MatViewError(
                f"INCREMENTAL view aggregate argument {col!r} must be "
                "NOT NULL")
        if func in ("min", "max") and f.dtype == DType.STRING:
            raise MatViewError(
                "INCREMENTAL min/max over a string column is not "
                "maintainable (collation vs code order)")


def create_matview(session, stmt) -> str:
    cat = session.catalog
    name = stmt.name.lower()
    if name in cat.tables or name in cat.views:
        raise MatViewError(f"{stmt.name!r} already exists")
    base, keys, aggs = analyze_shape(stmt.query)
    d = MatViewDef(name, getattr(stmt, "_sql_text", ""), stmt.query,
                   stmt.incremental, base, keys, aggs)
    if stmt.incremental:
        _check_incremental(session, d)
    _materialize(session, d)
    cat.matviews[name] = d
    _persist_defs(session)
    cat.bump_ddl()
    kind = "INCREMENTAL MATERIALIZED VIEW" if stmt.incremental \
        else "MATERIALIZED VIEW"
    return f"CREATE {kind} {stmt.name}"


def drop_matview(session, name: str, if_exists: bool = False) -> str:
    cat = session.catalog
    name = name.lower()
    if name not in cat.matviews:
        if if_exists:
            return "DROP MATERIALIZED VIEW"
        raise MatViewError(f"unknown materialized view {name!r}")
    del cat.matviews[name]
    if name in cat.tables:
        cat.drop_table(name)
    _persist_defs(session)
    cat.bump_ddl()
    return f"DROP MATERIALIZED VIEW {name}"


def refresh_matview(session, name: str) -> str:
    from cloudberry_tpu_torch.utils.faultinject import fault_point

    fault_point("matview_refresh")
    cat = session.catalog
    name = name.lower()
    d = cat.matviews.get(name)
    if d is None:
        raise MatViewError(f"unknown materialized view {name!r}")
    if name in cat.tables:
        cat.drop_table(name)
    _materialize(session, d)
    _persist_defs(session)
    cat.bump_ddl()
    return f"REFRESH MATERIALIZED VIEW {name}"


def _materialize(session, d: MatViewDef) -> None:
    """Run the defining query and store the result as the view's table."""
    from cloudberry_tpu_torch.catalog.catalog import DistributionPolicy
    from cloudberry_tpu_torch.plan.planner import _run_internal

    batch = _run_internal(session, d.query)
    t = session.catalog.create_table(d.name, batch.schema,
                                     DistributionPolicy.random())
    sel = np.asarray(batch.sel)
    data, validity = {}, {}
    for f in batch.schema.fields:
        data[f.name] = np.asarray(batch.columns[f.name])[sel] \
            .astype(f.type.np_dtype)
        vm = batch.validity.get(f.name)
        if vm is not None:
            validity[f.name] = np.asarray(vm).astype(np.bool_)[sel]
    t.set_data(data, dict(batch.dicts), validity=validity)
    d.fresh_token = _base_token(session, d)
    if session.store is not None and d.base_table:
        d.base_store_version = session.store.current_version(d.base_table)


def _base_token(session, d: MatViewDef):
    if d.base_table is None:
        return None
    try:
        return getattr(session.catalog.table(d.base_table), "_version", None)
    except KeyError:
        return None


# -------------------------------------------------------------- persistence


def _persist_defs(session) -> None:
    if session.store is None:
        return
    if not session.store.autocommit:
        # inside BEGIN..COMMIT: definitions must not outlive a ROLLBACK —
        # Session.txn flushes them after the store commit succeeds
        session._matviews_dirty = True
        return
    session.store.save_matviews({
        n: {"sql": d.sql, "incremental": d.incremental,
            "base_store_version": d.base_store_version}
        for n, d in session.catalog.matviews.items()})


def load_defs(session) -> None:
    """Register store-persisted definitions (session start / store sync).
    Freshness carries over only when the base table's store version still
    matches what the definition last saw."""
    if session.store is None:
        return
    from cloudberry_tpu_torch.sql.parser import parse_sql

    for name, j in session.store.load_matviews().items():
        try:
            ddl = parse_sql(j["sql"])
        except Exception:
            continue
        if not isinstance(ddl, ast.CreateMatView):
            continue
        q = ddl.query
        base, keys, aggs = analyze_shape(q)
        d = MatViewDef(name, j["sql"], q, ddl.incremental,
                       base, keys, aggs,
                       base_store_version=j.get("base_store_version", 0))
        if base is not None and session.store.current_version(base) \
                == d.base_store_version:
            d.fresh_token = _base_token(session, d)
        session.catalog.matviews[name] = d


# -------------------------------------------------------------- maintenance


def maintain_on_append(session, table_name: str, n_new: int) -> None:
    """INSERT/COPY hook: merge the appended rows' delta aggregation into
    every INCREMENTAL view on this base; others go stale."""
    if n_new <= 0:
        return
    from cloudberry_tpu_torch.utils.faultinject import fault_point

    fault_point("matview_maintain")
    changed = False
    for d in list(session.catalog.matviews.values()):
        if d.base_table != table_name.lower():
            continue
        if not d.incremental:
            d.fresh_token = None
            continue
        _merge_delta(session, d, n_new)
        d.fresh_token = _base_token(session, d)
        if session.store is not None:
            d.base_store_version = session.store.current_version(
                d.base_table)
            changed = True
    if changed:
        _persist_defs(session)


def maintain_full(session, table_name: str) -> None:
    """UPDATE/DELETE hook without captured deltas: re-materialize
    INCREMENTAL views (correct for any DML), mark plain views stale."""
    for d in list(session.catalog.matviews.values()):
        if d.base_table != table_name.lower():
            continue
        if d.incremental:
            refresh_matview(session, d.name)
        else:
            d.fresh_token = None


def delta_columns(session, table_name: str):
    """Union of key/argument columns the INCREMENTAL views on this base
    need for a DML delta, or None when none watch it (the DML paths then
    skip the capture entirely)."""
    need: set = set()
    found = False
    for d in session.catalog.matviews.values():
        if d.base_table == table_name.lower() and d.incremental:
            found = True
            need.update(c for _, c in d.keys)
            need.update(c for _, _, c in d.aggs if c is not None)
    return sorted(need) if found else None


def maintain_on_dml(session, table_name: str, sub, add) -> None:
    """UPDATE/DELETE hook WITH captured delta frames — the IMMV delta
    discipline (reference: src/backend/commands/matview.c:594-640,
    IVM_immediate_maintenance's old/new transition tables): subtract the
    old rows' contribution, add the new rows'. A view falls back to a
    full re-materialization when its aggregates are not invertible
    under deletion (min/max), when a sum runs on floats (subtraction
    would break the bit-exact discipline int64/decimal deltas keep), or
    when it carries no count (an emptied group would be undetectable) —
    correctness always wins over incrementality."""
    from cloudberry_tpu_torch.utils.faultinject import fault_point

    fault_point("matview_maintain")
    changed = False
    for d in list(session.catalog.matviews.values()):
        if d.base_table != table_name.lower():
            continue
        if not d.incremental:
            d.fresh_token = None
            continue
        if _delta_invertible(session, d) \
                and _merge_dml_delta(session, d, sub, add):
            d.fresh_token = _base_token(session, d)
            if session.store is not None:
                d.base_store_version = session.store.current_version(
                    d.base_table)
                changed = True
        else:
            refresh_matview(session, d.name)
    if changed:
        _persist_defs(session)


def _delta_invertible(session, d: MatViewDef) -> bool:
    from cloudberry_tpu_torch.types import DType

    if any(f in ("min", "max") for _, f, _ in d.aggs):
        return False  # deletion cannot un-take an extreme
    if not any(f == "count" for _, f, _ in d.aggs):
        return False  # emptied groups would be undetectable
    base = session.catalog.table(d.base_table)
    for _, f, c in d.aggs:
        if f == "sum" and c is not None:
            fld = next(x for x in base.schema.fields if x.name == c)
            if fld.dtype == DType.FLOAT64:
                return False  # float subtraction is not bit-exact
    return True


def _merge_dml_delta(session, d: MatViewDef, sub, add) -> bool:
    """Signed delta merge: every affected row contributes ±1 to counts
    and ±value to sums, grouped by the view keys; groups whose count
    reaches zero leave the view. False = the delta cannot express the
    result (a keyless view emptied out: its sums become SQL NULL, which
    only a re-materialization produces) — the caller refreshes."""
    import pandas as pd

    from cloudberry_tpu_torch.columnar.batch import encode_column
    from cloudberry_tpu_torch.types import DType

    key_aliases = [a for a, _ in d.keys]
    key_cols = [c for _, c in d.keys]
    parts = []
    for df, sign in ((sub, -1), (add, 1)):
        if df is None or not len(df):
            continue
        p = pd.DataFrame({a: df[c].to_numpy()
                          for a, c in zip(key_aliases, key_cols)})
        for alias, func, col in d.aggs:
            p[alias] = sign if func == "count" \
                else sign * df[col].to_numpy()
        parts.append(p)
    mv = session.catalog.table(d.name)
    mv.ensure_loaded()
    if not parts:
        return True  # zero affected rows: the view already matches
    delta = pd.concat(parts, ignore_index=True)
    agg_aliases = [a for a, _, _ in d.aggs]
    if key_aliases:
        dagg = delta.groupby(key_aliases, sort=False)[agg_aliases] \
            .sum().reset_index()
    else:
        dagg = delta[agg_aliases].sum().to_frame().T

    mv_df = _frame(mv, [f.name for f in mv.schema.fields], 0, mv.num_rows)
    merged = pd.concat([mv_df, dagg], ignore_index=True)
    if key_aliases:
        merged = merged.groupby(key_aliases, sort=False)[agg_aliases] \
            .sum().reset_index()
    else:
        merged = merged[agg_aliases].sum().to_frame().T
    count_alias = next(a for a, f, _ in d.aggs if f == "count")
    if key_aliases:
        merged = merged[merged[count_alias] > 0]
    elif int(merged[count_alias].iloc[0]) == 0:
        return False  # emptied keyless view: sums must become NULL

    data = {}
    for f in mv.schema.fields:
        arr = merged[f.name].to_numpy()
        data[f.name] = encode_column(arr, f, mv.dicts) \
            if f.dtype == DType.STRING else arr.astype(f.type.np_dtype)
    mv.set_data(data, mv.dicts)
    return True


def invalidate_all(session) -> None:
    """Transaction ROLLBACK: data snapshots restored under the views'
    feet — every view is conservatively stale until refreshed."""
    for d in session.catalog.matviews.values():
        d.fresh_token = None


def _frame(table, cols: list[str], lo: int, hi: int):
    """Physical-representation DataFrame slice (strings decoded)."""
    import pandas as pd

    out = {}
    for c in cols:
        arr = table.data[c][lo:hi]
        d = table.dicts.get(c)
        if d is not None:
            arr = np.asarray(d.values, dtype=object)[arr]
        out[c] = arr
    return pd.DataFrame(out)


def _merge_delta(session, d: MatViewDef, n_new: int) -> None:
    import pandas as pd

    from cloudberry_tpu_torch.columnar.batch import encode_column

    base = session.catalog.table(d.base_table)
    base.ensure_loaded()
    mv = session.catalog.table(d.name)
    mv.ensure_loaded()
    n = base.num_rows
    need = [c for _, c in d.keys] + sorted(
        {c for _, _, c in d.aggs if c is not None})
    delta = _frame(base, need, n - n_new, n)
    key_aliases = [a for a, _ in d.keys]
    delta = delta.rename(columns=dict(zip([c for _, c in d.keys],
                                          key_aliases)))

    # per-key delta aggregation on physical values (bit-exact)
    gb = delta.groupby(key_aliases, sort=False) if key_aliases else None
    parts = {}
    for alias, func, col in d.aggs:
        if func == "count":
            s = gb.size() if gb is not None else pd.Series([len(delta)])
        else:
            s = getattr(gb[col] if gb is not None else delta[col], func)()
            if gb is None:
                s = pd.Series([s])
        parts[alias] = s
    dagg = pd.DataFrame(parts)
    if key_aliases:
        dagg = dagg.reset_index()

    mv_df = _frame(mv, [f.name for f in mv.schema.fields], 0, mv.num_rows)
    merged = pd.concat([mv_df, dagg], ignore_index=True)
    if key_aliases:
        g2 = merged.groupby(key_aliases, sort=False)
        rules = {a: ("sum" if f in ("sum", "count") else f)
                 for a, f, _ in d.aggs}
        merged = g2.agg(rules).reset_index()
    else:
        rules = {a: ("sum" if f in ("sum", "count") else f)
                 for a, f, _ in d.aggs}
        merged = merged.agg(rules).to_frame().T

    from cloudberry_tpu_torch.types import DType

    data = {}
    for f in mv.schema.fields:
        arr = merged[f.name].to_numpy()
        data[f.name] = encode_column(arr, f, mv.dicts) \
            if f.dtype == DType.STRING else arr.astype(f.type.np_dtype)
    mv.set_data(data, mv.dicts)


# ------------------------------------------------------------------- AQUMV


def aqumv_rewrite(session, sel: ast.Select):
    """Try to answer ``sel`` from a fresh matview; returns (select,
    view_name_or_None)."""
    cat = session.catalog
    if not cat.matviews or len(sel.from_refs) != 1 \
            or not isinstance(sel.from_refs[0], ast.TableName) or sel.distinct:
        return sel, None
    base = sel.from_refs[0].name.lower()
    for d in cat.matviews.values():
        if d.base_table != base or d.fresh_token is None:
            continue
        if d.name not in cat.tables:
            continue  # definition without a table (e.g. rolled-back CREATE)
        if d.fresh_token != _base_token(session, d):
            continue  # base moved since the view last materialized
        out = _try_rewrite(sel, d)
        if out is not None:
            return out, d.name
    return sel, None


def _try_rewrite(sel: ast.Select, d: MatViewDef):
    key_of = {c: a for a, c in d.keys}          # base col -> mv alias
    agg_of = {}                                  # (func, argcol) -> mv alias
    for alias, func, col in d.aggs:
        agg_of[(func, col)] = alias

    group_cols = []
    for g in sel.group_by:
        if not (isinstance(g, ast.Name) and len(g.parts) == 1
                and g.parts[0] in key_of):
            return None
        group_cols.append(g.parts[0])
    if sel.where is not None \
            and not _refs_only(sel.where, set(key_of)):
        return None

    items = []
    item_aliases = set()
    for item in sel.items:
        e = item.expr
        if isinstance(e, ast.Name) and len(e.parts) == 1 \
                and e.parts[0] in key_of and e.parts[0] in group_cols:
            alias = item.alias or e.parts[0]
            items.append(ast.SelectItem(ast.Name((key_of[e.parts[0]],)),
                                        alias))
            item_aliases.add(alias)
            continue
        rw = _rewrite_agg(e, key_of, agg_of, global_agg=not group_cols)
        if rw is None:
            return None
        alias = item.alias or _agg_name(e)
        items.append(ast.SelectItem(rw, alias))
        if alias:
            item_aliases.add(alias)

    def rw_post(e):
        """HAVING / ORDER BY exprs: aggregates re-derive from the view,
        key names rename, output aliases stay; None = not rewritable."""
        if isinstance(e, ast.Name) and len(e.parts) == 1:
            if e.parts[0] in item_aliases:
                return e
            if e.parts[0] in key_of:
                return ast.Name((key_of[e.parts[0]],))
            return None
        if isinstance(e, ast.FuncCall) and e.name in _AGG_FUNCS:
            return _rewrite_agg(e, key_of, agg_of,
                                global_agg=not group_cols)
        if isinstance(e, (ast.ScalarSubquery, ast.InSubquery, ast.Exists)):
            return None
        if not isinstance(e, ast.Node):
            return e
        out = e.__class__(**vars(e))
        for k, v in vars(e).items():
            if isinstance(v, ast.ExprNode):
                r = rw_post(v)
                if r is None:
                    return None
                setattr(out, k, r)
            elif isinstance(v, list):
                new = []
                for x in v:
                    if isinstance(x, ast.ExprNode):
                        r = rw_post(x)
                        if r is None:
                            return None
                        new.append(r)
                    else:
                        new.append(x)
                setattr(out, k, new)
        return out

    having = None
    if sel.having is not None:
        having = rw_post(sel.having)
        if having is None:
            return None
    order_by = []
    for oi in sel.order_by:
        r = rw_post(oi.expr)
        if r is None:
            return None
        order_by.append(ast.OrderItem(r, oi.ascending))
    return ast.Select(
        items=items,
        from_refs=[ast.TableName(d.name)],
        where=_rename(sel.where, key_of) if sel.where is not None else None,
        group_by=[ast.Name((key_of[c],)) for c in group_cols],
        having=having, order_by=order_by,
        limit=sel.limit, offset=sel.offset)


def _agg_name(e: ast.ExprNode) -> Optional[str]:
    return e.name if isinstance(e, ast.FuncCall) else None


def _rewrite_agg(e: ast.ExprNode, key_of, agg_of, global_agg: bool):
    """sum(x)→sum(mv.sum_x); count→sum(mv.count) [coalesced to 0 for a
    global aggregate over a possibly-empty view]; min/max→min/max of the
    view's extreme. None = not derivable."""
    if not (isinstance(e, ast.FuncCall) and e.name in _AGG_FUNCS
            and not e.distinct):
        return None
    if e.star or not e.args:
        col = None
    elif isinstance(e.args[0], ast.Name) and len(e.args[0].parts) == 1:
        col = e.args[0].parts[0]
    else:
        return None
    alias = agg_of.get((e.name, col))
    if alias is None:
        return None
    inner = ast.Name((alias,))
    if e.name in ("min", "max"):
        return ast.FuncCall(e.name, [inner])
    out = ast.FuncCall("sum", [inner])
    if e.name == "count" and global_agg:
        out = ast.FuncCall("coalesce", [out, ast.NumberLit("0")])
    return out


def _refs_only(e: ast.ExprNode, allowed: set) -> bool:
    if isinstance(e, ast.Name):
        return len(e.parts) == 1 and e.parts[0] in allowed
    if isinstance(e, (ast.ScalarSubquery, ast.InSubquery, ast.Exists)):
        return False
    ok = True
    for v in vars(e).values():
        if isinstance(v, ast.ExprNode):
            ok = ok and _refs_only(v, allowed)
        elif isinstance(v, (list, tuple)):
            for x in v:
                if isinstance(x, ast.ExprNode):
                    ok = ok and _refs_only(x, allowed)
    return ok


def _rename(e: ast.ExprNode, key_of: dict):
    if isinstance(e, ast.Name) and len(e.parts) == 1 \
            and e.parts[0] in key_of:
        return ast.Name((key_of[e.parts[0]],))
    if not isinstance(e, ast.Node):
        return e
    out = e.__class__(**vars(e))
    for k, v in vars(e).items():
        if isinstance(v, ast.ExprNode):
            setattr(out, k, _rename(v, key_of))
        elif isinstance(v, list):
            setattr(out, k, [
                _rename(x, key_of) if isinstance(x, ast.ExprNode) else x
                for x in v])
    return out
