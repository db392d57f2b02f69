"""Storage scan binding: cold-table scans → pruned micro-partition reads.

The planner move PAX makes with sparse filters (contrib/pax_storage
micro_partition_stats.cc) and the executor makes with PartitionSelector
(nodePartitionSelector.c): predicate ranges and equality literals reach the
storage layer BEFORE any column bytes move, so whole files are skipped by
manifest min/max (no IO) and footer bloom filters (footer-only IO), and only
the scan's referenced columns are ever read host-side — then only the
surviving rows transfer to the device.

Runs after predicate pushdown + column pruning (plan/prune.py), so filters
sit directly on scans and column_map is already narrowed.
"""

from __future__ import annotations

from cloudberry_tpu_torch.plan import expr as ex
from cloudberry_tpu_torch.plan import nodes as N
from cloudberry_tpu_torch.types import DType

_RANGE_TYPES = (DType.INT32, DType.INT64, DType.DECIMAL, DType.DATE,
                DType.FLOAT64)


def apply_storage_scans(plan: N.PlanNode, session) -> None:
    """Bind every cold-table scan to its pruned partition list (the port
    runs one segment: the JAX package's distributed placement path does
    not apply)."""
    store = getattr(session.catalog, "store", None)
    if store is None:
        return
    _walk(plan, (), session, store)


def _walk(node: N.PlanNode, preds: tuple, session, store) -> None:
    if isinstance(node, N.PFilter):
        # WHERE predicates are where scalar subqueries usually live — their
        # plans' cold scans need binding too
        for sub in ex.walk(node.predicate):
            if isinstance(sub, ex.SubqueryScalar):
                _walk(sub.plan, (), session, store)
        _walk(node.child, preds + (node.predicate,), session, store)
        return
    if isinstance(node, N.PScan):
        if node.table_name == "$dual" or hasattr(node, "_store_parts"):
            return
        t = session.catalog.table(node.table_name)
        if t.cold:
            _bind_scan(node, preds, t, store)
        return
    for e in _exprs_of(node):
        for sub in ex.walk(e):
            if isinstance(sub, ex.SubqueryScalar):
                _walk(sub.plan, (), session, store)
    for c in node.children():
        _walk(c, (), session, store)
    if isinstance(node, N.PJoin):
        # children are bound — partition-selector elimination can now see
        # the probe scan's surviving partition list
        _dynamic_eliminate(node, session, store)


def _exprs_of(node: N.PlanNode):
    yield from N.node_exprs(node)


def _bind_scan(node: N.PScan, preds: tuple, t, store) -> None:
    rev = {out: phys for phys, out in node.column_map.items()}
    ranges: dict[str, tuple] = {}
    eqs: dict[str, object] = {}
    for p in preds:
        for c in _conjuncts(p):
            got = _simple_cmp(c, rev)
            if got is None:
                continue
            col, op, val = got
            if op == "=":
                eqs[col] = val
                continue
            lo, hi = ranges.get(col, (None, None))
            if op in (">", ">="):
                # strict bounds tighten by 1 on integral literals (exact
                # partition elimination); floats stay conservative
                v = val + 1 if op == ">" and isinstance(val, int) else val
                lo = v if lo is None else max(lo, v)
            else:
                v = val - 1 if op == "<" and isinstance(val, int) else val
                hi = v if hi is None else min(hi, v)
            ranges[col] = (lo, hi)
    parts, report = store.select_partitions(t.name, ranges, eqs)
    rows = sum(p["num_rows"] - len(p["deleted"]) for p in parts)
    node._store_parts = parts
    node._prune_report = report
    node._input_key = f"{node.table_name}#{id(node)}"
    node.capacity = max(rows, 1)
    node.num_rows = rows


def _dynamic_eliminate(join: N.PJoin, session, store) -> None:
    """Join-driven partition elimination (the PartitionSelector /
    Dynamic*Scan analog, nodePartitionSelector.c): for an inner/semi join
    probing a PARTITION BY table on its partition column, run the (small)
    build side host-side FIRST, collect its distinct join-key values, and
    drop probe partitions no value can touch — manifest min/max, then
    footer blooms — before any fact-column IO.

    Only join kinds that discard unmatched probe rows are eligible (a LEFT
    join preserves them, so eliminating probe partitions would drop rows —
    the same restriction the reference's selector has). In this engine's
    plan-time-feeds-the-program model, "executor runtime" for the selector
    is plan time: the build subtree compiles and runs as its own small
    program, exactly like the reference runs the selector subtree before
    the dynamic scan."""
    limit = session.config.storage.partition_selector_max_build
    if limit <= 0 or join.kind not in ("inner", "semi"):
        return
    # probe side: PFilter chains preserve field names; anything else stops
    scan = join.probe
    while isinstance(scan, N.PFilter):
        scan = scan.child
    if not isinstance(scan, N.PScan) or not hasattr(scan, "_store_parts"):
        return
    t = session.catalog.table(scan.table_name)
    spec = t.partition_spec
    if spec is None:
        return
    out_name = scan.column_map.get(spec[1])
    if out_name is None:
        return
    key_i = next((i for i, k in enumerate(join.probe_keys)
                  if isinstance(k, ex.ColumnRef) and k.name == out_name),
                 None)
    if key_i is None:
        return
    from cloudberry_tpu_torch.plan.binder import _plan_capacity

    if _plan_capacity(join.build) > limit:
        return
    values = _eval_build_keys(join.build, join.build_keys[key_i], session)
    if values is None:
        return
    kept, n_dropped = _filter_parts_by_values(
        store, t.name, scan._store_parts, spec[1], values)
    if n_dropped == 0:
        return
    scan._store_parts = kept
    scan._prune_report["skipped_dynamic"] = \
        scan._prune_report.get("skipped_dynamic", 0) + n_dropped
    rows = sum(p["num_rows"] - len(p["deleted"]) for p in kept)
    scan.capacity = max(rows, 1)
    scan.num_rows = rows


def _eval_build_keys(build: N.PlanNode, key_expr: ex.Expr, session):
    """Distinct build-side join-key values, by compiling and running the
    build subtree as its own program (the selector execution)."""
    import numpy as np

    from cloudberry_tpu_torch.exec import executor as X

    proj = N.PProject(build, [("$pskey", key_expr)])
    proj.fields = [N.PlanField("$pskey", key_expr.dtype, None)]
    try:
        exe = X.compile_plan(proj, session)
        cols, sel, checks = exe.fn(X.prepare_inputs(exe, session))
        X.raise_checks(checks)
        vals = cols["$pskey"][sel].cpu().numpy()
    except Exception:
        return None  # elimination is an optimization — never fail the query
    return np.unique(vals)


def _filter_parts_by_values(store, table: str, parts, col: str, values):
    """Partitions a value set can touch: manifest min/max first (no IO),
    then footer bloom membership for any surviving value (shared primitive
    TableStore.bloom_may_match — one footer read per partition)."""
    kept, dropped = [], 0
    for part in parts:
        st = part.get("stats", {}).get(col)
        cand = values
        if st is not None:
            cand = values[(values >= st[0]) & (values <= st[1])]
            if len(cand) == 0:
                dropped += 1
                continue
        # bloom checks read the footer — bound the per-partition work
        if len(cand) <= 64 and not store.bloom_may_match(
                table, part, {col: cand.tolist()}):
            dropped += 1
            continue
        kept.append(part)
    return kept, dropped


def _conjuncts(e: ex.Expr):
    if isinstance(e, ex.BinOp) and e.op == "and":
        yield from _conjuncts(e.left)
        yield from _conjuncts(e.right)
    else:
        yield e


def _simple_cmp(e: ex.Expr, rev: dict):
    """column <op> literal over a range-comparable physical type, in either
    orientation; returns (phys_col, op, value) or None."""
    if not isinstance(e, ex.BinOp) or e.op not in ("=", "<", "<=", ">", ">="):
        return None
    l, r = e.left, e.right
    op = e.op
    if isinstance(r, ex.ColumnRef) and isinstance(l, ex.Literal):
        l, r = r, l
        op = {"=": "=", "<": ">", "<=": ">=", ">": "<", ">=": "<="}[op]
    if not (isinstance(l, ex.ColumnRef) and isinstance(r, ex.Literal)):
        return None
    phys = rev.get(l.name)
    if phys is None or l.dtype.base not in _RANGE_TYPES:
        return None
    if not isinstance(r.value, (int, float)):
        return None
    return phys, op, r.value
