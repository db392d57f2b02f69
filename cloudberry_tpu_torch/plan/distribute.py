"""The aggregate split of the distribution pass — the part of the JAX
package's plan/distribute.py that the single-segment tiled executor needs.

Tiled aggregation (exec/tiled.py) is the two-stage aggregate of a
distributed plan run over tiles instead of segments: each tile computes
partial aggregates, the partials merge associatively into an accumulator,
and a finalize projection restores the original output schema (avg =
sum / count). The split and the finalize projection are copies of the JAX
package's, so both engines build the same partial plans. The rest of the
distribution pass (motions, sharding, direct dispatch) belongs to
multi-segment execution, which the port does not carry.
"""

from __future__ import annotations

from cloudberry_tpu_torch.plan import expr as ex
from cloudberry_tpu_torch.plan import nodes as N
from cloudberry_tpu_torch.types import FLOAT64, INT64


def _all_exprs(plan: N.PlanNode):
    """Every expression of every node of ``plan`` (children included)."""
    yield from N.node_exprs(plan)
    for c in plan.children():
        yield from _all_exprs(c)


def _split_aggs(aggs):
    """(partial_aggs, final_merge_aggs, finalize_exprs) — how each aggregate
    decomposes across the merge boundary (the reference's combine
    functions / multi-stage Aggref splitting)."""
    partial: list[tuple[str, ex.AggCall]] = []
    final: list[tuple[str, ex.AggCall]] = []
    finalize: dict[str, tuple[str, str]] = {}  # out name -> (sum, count)
    for name, call in aggs:
        if call.func in ("sum", "min", "max"):
            partial.append((name, call))
            merge = "sum" if call.func == "sum" else call.func
            final.append((name, ex.AggCall(
                merge, ex.ColumnRef(name, call.dtype))))
        elif call.func == "count":
            partial.append((name, call))
            final.append((name, ex.AggCall(
                "sum", ex.ColumnRef(name, INT64))))
        elif call.func == "avg":
            s, c = f"{name}$s", f"{name}$c"
            assert call.arg is not None
            partial.append((s, ex.AggCall("sum", call.arg)))
            partial.append((c, ex.AggCall("count", call.arg)))
            final.append((s, ex.AggCall(
                "sum", ex.ColumnRef(s, call.arg.dtype))))
            final.append((c, ex.AggCall("sum", ex.ColumnRef(c, INT64))))
            finalize[name] = (s, c)
        else:
            raise ValueError(f"cannot distribute aggregate {call.func}")
    return partial, final, finalize


def _finalize_project(final: N.PlanNode, node: N.PAgg,
                      finalize) -> N.PlanNode:
    """Restore the original agg output schema (avg = sum/count)."""
    if not finalize:
        final_names = {f.name for f in final.fields}
        assert {f.name for f in node.fields} <= final_names
        proj_exprs = [(f.name, _field_ref(final, f.name))
                      for f in node.fields]
    else:
        proj_exprs = []
        for f in node.fields:
            if f.name in finalize:
                s, c = finalize[f.name]
                sf = _field_ref(final, s)
                cf = _field_ref(final, c)
                proj_exprs.append((f.name, ex.BinOp(
                    "/", ex.Cast(sf, FLOAT64), ex.Cast(cf, FLOAT64),
                    FLOAT64)))
            else:
                proj_exprs.append((f.name, _field_ref(final, f.name)))
    proj = N.PProject(final, proj_exprs)
    proj.fields = list(node.fields)
    return proj


def _field_ref(plan: N.PlanNode, name: str) -> ex.ColumnRef:
    f = plan.field(name)
    c = ex.ColumnRef(f.name, f.type)
    if f.sdict is not None:
        object.__setattr__(c, "_sdict", f.sdict)
    return c
