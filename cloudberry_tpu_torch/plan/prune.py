"""Plan rewrites that run before distribution:

- predicate pushdown through projections (qual pushdown): a filter whose
  columns are simple renames in the projection below moves under it —
  filters reach scans, which unlocks direct dispatch through views and
  shrinks every downstream intermediate;
- column pruning — the targetlist-narrowing the reference's planner does
  (and PAX's column projection exploits, SURVEY §2.5): each node keeps only
  the columns its ancestors actually use. On TPU this directly cuts HBM
  traffic — every pruned column is one less array scanned, gathered through
  joins, permuted by sorts, and shuffled by motions.
"""

from __future__ import annotations

from cloudberry_tpu_torch.plan import expr as ex
from cloudberry_tpu_torch.plan import nodes as N


def prune_plan(plan: N.PlanNode) -> N.PlanNode:
    plan = _pushdown(plan)
    _prune(plan, set(plan.names))
    return plan


def _pushdown(node: N.PlanNode) -> N.PlanNode:
    """Move PFilter under PProject when every referenced column is a plain
    rename (ColumnRef) in the projection."""
    if isinstance(node, N.PShare):
        # shared subtree: rewrite ONCE (every PShare holds the same child);
        # filters above a PShare never push into it — other consumers see
        # the same materialization
        done = getattr(node.child, "_pushdown_done", None)
        if done is None:
            done = _pushdown(node.child)
            node.child._pushdown_done = done
            done._pushdown_done = done
        node.child = done
        return node
    # rewrite children first
    if isinstance(node, N.PFilter):
        node.child = _pushdown(node.child)
        child = node.child
        if isinstance(child, N.PProject):
            renames = {n: e for n, e in child.exprs
                       if isinstance(e, ex.ColumnRef)}
            used = ex.columns_used(node.predicate)
            if used <= set(renames):
                new_pred = _substitute_cols(
                    node.predicate, {n: renames[n] for n in used})
                inner = N.PFilter(child.child, new_pred)
                inner.fields = list(child.child.fields)
                child.child = _pushdown(inner)
                return child
        return node
    for attr in ("child", "build", "probe"):
        c = getattr(node, attr, None)
        if c is not None:
            setattr(node, attr, _pushdown(c))
    if isinstance(node, N.PConcat):
        node.inputs = [_pushdown(c) for c in node.inputs]
    return node


def _substitute_cols(e: ex.Expr, mapping: dict[str, ex.Expr]) -> ex.Expr:
    def fn(n):
        if isinstance(n, ex.ColumnRef):
            return mapping.get(n.name)
        if isinstance(n, ex.IsValid):
            # mask references rewrite with the projection's renames too
            new = []
            for m in n.mask_names:
                t = mapping.get(m)
                if not isinstance(t, ex.ColumnRef):
                    return None
                new.append(t.name)
            return ex.IsValid(tuple(new), n.negate)
        return None

    return ex.rewrite(e, fn)


def _expr_cols(e: ex.Expr) -> set[str]:
    out = ex.columns_used(e)
    for node in ex.walk(e):
        v = getattr(node, "_null_expr", None)
        if v is not None:
            out |= ex.columns_used(v)
        if isinstance(node, ex.SubqueryScalar):
            _prune(node.plan, set(node.plan.names))
    return out


def _with_field_masks(node: N.PlanNode, req: set[str]) -> set[str]:
    """A required field drags its validity mask columns along."""
    out = set(req)
    for f in node.fields:
        if f.name in out:
            out.update(f.masks)
    return out


def _prune(node: N.PlanNode, req: set[str]) -> None:
    if isinstance(node, N.PScan):
        req = _with_field_masks(node, req)
        node.column_map = {phys: out for phys, out in node.column_map.items()
                           if out in req}
        node.mask_map = {phys: out for phys, out in node.mask_map.items()
                         if out in req}
        node.fields = [f for f in node.fields if f.name in req]
        return

    if isinstance(node, N.PShare):
        # consumers may need different column subsets of the shared
        # subplan: keep its full output (materialize-once trade-off)
        if not getattr(node.child, "_share_pruned", False):
            node.child._share_pruned = True
            _prune(node.child, set(node.child.names))
        return

    if isinstance(node, N.PFilter):
        _prune(node.child, req | _expr_cols(node.predicate))
        return

    if isinstance(node, N.PProject):
        req = _with_field_masks(node, req)
        node.exprs = [(n, e) for n, e in node.exprs if n in req]
        node.fields = [f for f in node.fields if f.name in req]
        child_req = set()
        for _, e in node.exprs:
            child_req |= _expr_cols(e)
        _prune(node.child, child_req)
        return

    if isinstance(node, N.PJoin):
        req = _with_field_masks(node, req)
        build_req = set()
        probe_req = set()
        for k in node.build_keys:
            build_req |= _expr_cols(k)
        for k in node.probe_keys:
            probe_req |= _expr_cols(k)
        if node.build_key_valid is not None:
            build_req |= _expr_cols(node.build_key_valid)
        if node.probe_key_valid is not None:
            probe_req |= _expr_cols(node.probe_key_valid)
        if node.residual is not None:
            rcols = _expr_cols(node.residual)
            build_names = set(node.build.names)
            build_req |= rcols & build_names
            probe_req |= rcols - build_names
        node.build_payload = [c for c in node.build_payload
                              if c in req or c in
                              (_expr_cols(node.residual)
                               if node.residual is not None else ())]
        build_req |= set(node.build_payload)
        probe_req |= req - set(node.build_payload) - {node.match_name}
        probe_req &= set(node.probe.names)
        _prune(node.build, build_req)
        _prune(node.probe, probe_req)
        node.fields = [f for f in node.fields
                       if f.name in req or f.name in node.build_payload]
        return

    if isinstance(node, N.PAgg):
        child_req = set()
        for _, e in node.group_keys:
            child_req |= _expr_cols(e)
        for _, c in node.aggs:
            if c.arg is not None:
                child_req |= _expr_cols(c.arg)
        _prune(node.child, child_req)
        return

    if isinstance(node, N.PSort):
        child_req = set(req)
        for e, _ in node.keys:
            child_req |= _expr_cols(e)
        _prune(node.child, child_req)
        return

    if isinstance(node, N.PLimit):
        _prune(node.child, set(req))
        return

    if isinstance(node, N.PMotion):
        child_req = _with_field_masks(node, set(req))
        for e in node.hash_keys:
            child_req |= _expr_cols(e)
        _prune(node.child, child_req)
        node.fields = [f for f in node.fields if f.name in child_req]
        return

    if isinstance(node, N.PWindow):
        child_req = req - {n for n, _, _ in node.calls}
        for e in node.partition_keys:
            child_req |= _expr_cols(e)
        for e, _ in node.order_keys:
            child_req |= _expr_cols(e)
        for _, _, arg in node.calls:
            if arg is not None:
                child_req |= _expr_cols(arg)
        for vexpr in (node.valids or ()):
            if vexpr is not None:
                child_req |= _expr_cols(vexpr)
        _prune(node.child, child_req)
        return

    if isinstance(node, N.PConcat):
        for c in node.inputs:
            _prune(c, set(req))
        return

    # unknown/leaf nodes: nothing to prune
    return
