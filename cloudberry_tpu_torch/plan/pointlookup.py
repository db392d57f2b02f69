"""Point-lookup acceleration — the index / AO block-directory analog.

The reference answers `WHERE k = const` point queries through btree
indexes or the append-only block directory
(src/backend/access/appendonly/appendonlyblockdirectory.c): direct
dispatch routes the statement to one segment, and the index narrows the
scan to the few matching blocks. Here direct dispatch already routes to
one shard, but the scan then reads the WHOLE shard. The TPU-native
analog is a host-side sorted-key sidecar: a cached argsort of the
column (built lazily on first point lookup, invalidated by the table
version), searchsorted at PLAN time to the matching row positions, and
the scan re-bound to exactly those rows — the device program then
touches O(matches) rows instead of the shard.

Scope: equality conjuncts against literals, RAM-resident tables above a
size floor, on the single-program paths (one segment, or a
direct-dispatched statement's shard; the multi-segment gang reads whole
shards by construction — its point path IS direct dispatch). Stored
(micro-partition) scans keep their own pruning (plan/scanprune.py:
manifest min/max + blooms play the block-directory role there).

The JAX package slices the matched rows on the host and uploads them at
every statement. The port already holds the table on the device
(``Session.device_table``), so the executor gathers the same rows there
with an index tensor (exec/executor.py ``point_scan_slice``): the same
rows, in the same order, at the same scan capacity, with fewer bytes
moved.

The filter stays in the plan: re-filtering the slice is one fused
mask over O(matches) rows and keeps every other conjunct exact.
"""

from __future__ import annotations

import numpy as np

from cloudberry_tpu_torch.plan import expr as ex
from cloudberry_tpu_torch.plan import nodes as N

MIN_ROWS = 32_768        # below this a full masked scan is already cheap
_INDEX_CACHE_MAX = 8


def optimize_point_lookups(plan: N.PlanNode, session) -> None:
    """Re-bind eligible Filter→Scan patterns to sorted-sidecar row
    slices. Mutates scans in place (capacity, num_rows, _point_rows)."""
    if not getattr(session.config.planner, "enable_point_lookup", True):
        return
    seg = getattr(plan, "_direct_segment", None)
    if session.config.n_segments > 1 and seg is None:
        # the multi-segment gang reads whole shards by construction: its
        # point path IS direct dispatch
        return

    def visit(node: N.PlanNode) -> None:
        if isinstance(node, N.PFilter):
            scan = node.child
            while isinstance(scan, N.PFilter):
                scan = scan.child
            if isinstance(scan, N.PScan) \
                    and not hasattr(scan, "_store_parts") \
                    and not hasattr(scan, "_point_rows") \
                    and scan.table_name != "$dual":
                _try_bind(node, scan, session, seg)
        for c in node.children():
            visit(c)
        for e in N.node_exprs(node):
            for sub in ex.walk(e):
                if isinstance(sub, ex.SubqueryScalar):
                    visit(sub.plan)

    visit(plan)


def _eq_conjuncts(pred: ex.Expr):
    """Yield (column name, literal value) for every top-level equality
    conjunct comparing a bare column to a literal."""
    if isinstance(pred, ex.BinOp) and pred.op == "and":
        yield from _eq_conjuncts(pred.left)
        yield from _eq_conjuncts(pred.right)
        return
    if isinstance(pred, ex.BinOp) and pred.op == "=":
        l, r = pred.left, pred.right
        if isinstance(r, ex.ColumnRef) and isinstance(l, ex.Literal):
            l, r = r, l
        if isinstance(l, ex.ColumnRef) and isinstance(r, ex.Literal) \
                and not isinstance(r.value, str):
            yield l.name, r.value


def _try_bind(filt: N.PFilter, scan: N.PScan, session, seg) -> None:
    table = session.catalog.table(scan.table_name)
    if table.policy.kind == "replicated":
        seg_eff = None  # replicated tables read whole on any segment
    else:
        seg_eff = seg
    rows_total = table.num_rows if seg_eff is None else None
    if rows_total is not None and rows_total < MIN_ROWS:
        return
    out_to_phys = {out: phys for phys, out in scan.column_map.items()}
    for cname, value in _eq_conjuncts(filt.predicate):
        phys = out_to_phys.get(cname)
        if phys is None:
            continue
        # NULL rows never satisfy an equality: restrict to the valid
        # rows only when the column carries a mask (the canonical-zero
        # encoding would otherwise alias value 0)
        rows = _lookup(session, scan.table_name, phys, seg_eff, value)
        if rows is None:
            continue
        scan._point_undo = (scan.capacity, scan.num_rows)
        scan._point_rows = rows
        scan._point_col = cname
        scan._input_key = f"$pt{id(scan)}"
        scan.capacity = max(len(rows), 1)
        scan.num_rows = len(rows)
        return


def _lookup(session, tname: str, phys: str, seg, value):
    """Row positions (within the table / the segment's shard) whose
    ``phys`` column equals ``value``, via the cached sorted sidecar;
    None when the column cannot index (shard below the floor, non-1d)."""
    table = session.catalog.table(tname)
    table.ensure_loaded()
    if seg is None:
        col = np.asarray(table.data[phys])
        valid = table.validity.get(phys)
    else:
        st = session.sharded_table(tname)
        nrows = int(st.counts[seg])
        # the shard buffer is zero-padded past its count: padding rows
        # must never match (a k = 0 probe would return phantom rows)
        col = np.asarray(st.columns[phys][seg])[:nrows]
        valid = st.columns.get(f"$nn:{phys}")
        if valid is not None:
            valid = valid[seg][:nrows]
    if col.ndim != 1 or len(col) < MIN_ROWS:
        return None
    version = getattr(table, "_version", 0)
    key = (tname, phys, seg, version)
    cache = session.__dict__.setdefault("_point_index_cache", {})
    hit = cache.get(key)
    if hit is None:
        order = np.argsort(col, kind="stable")
        if len(cache) >= _INDEX_CACHE_MAX:
            cache.pop(next(iter(cache)))
        hit = cache[key] = (order, col[order])
    order, sorted_vals = hit
    try:
        lo = np.searchsorted(sorted_vals, value, side="left")
        hi = np.searchsorted(sorted_vals, value, side="right")
    except TypeError:
        return None
    if (hi - lo) > max(4096, len(col) >> 6):
        # not a POINT: a key-like equality matches O(1) rows; a flag or
        # category column matching a visible fraction of the table is
        # better served by the masked scan (no host gather, and plan
        # shapes stay stable for the golden snapshots)
        return None
    rows = np.sort(order[lo:hi])
    if valid is not None and len(rows):
        rows = rows[np.asarray(valid)[rows]]
    return rows



def unbind_point_lookups(plan: N.PlanNode) -> None:
    """Restore point-bound scans to full scans (the tiled planner streams
    whole tables by table name; a $pt-keyed sliced scan would miss its
    input there)."""
    from cloudberry_tpu_torch.exec.executor import scans_of

    for s in scans_of(plan):
        undo = getattr(s, "_point_undo", None)
        if undo is not None:
            s.capacity, s.num_rows = undo
            for attr in ("_point_rows", "_point_col", "_input_key",
                         "_point_undo"):
                if hasattr(s, attr):
                    delattr(s, attr)
