"""Resource governance — the per-query memory budget (admission estimate).

The reference tracks per-segment virtual memory in chunks with a red zone
(vmem_tracker.c:94, redzone_handler.c). Here memory is PREDICTABLE — every
node's capacity and column widths are static at plan time — so admission
is a plan-time estimate (the sum of live intermediate arrays, an upper
bound analogous to per-operator memory quotas) that refuses a query whose
estimate exceeds ``resource.query_mem_bytes`` before it runs. The session
then re-plans the refused statement as a stream of tiles (exec/tiled.py).

The estimate is the JAX package's, integer for integer: the tiled planner's
tile size, mode and accumulator capacity all follow from it, so both
engines take the same decisions on the same plan. The JAX package's
concurrency slots, engine-wide red line and runaway termination are not
carried yet.
"""

from __future__ import annotations

from dataclasses import dataclass

from cloudberry_tpu_torch.plan import nodes as N


class ResourceError(RuntimeError):
    pass


@dataclass
class MemoryEstimate:
    peak_bytes: int
    per_node: list[tuple[str, int]]


def estimate_plan_memory(plan: N.PlanNode) -> MemoryEstimate:
    """Upper-bound device bytes for one query: the sum over nodes of
    capacity × Σ column widths (+ the selection mask). An over-estimate
    (the eager operators free some intermediates) but shape-exact — the
    point is a hard admission bound, not a profile."""
    per_node: list[tuple[str, int]] = []
    total = 0

    def width(node: N.PlanNode) -> int:
        w = 1  # selection mask
        for f in node.fields:
            w += f.type.np_dtype.itemsize
        return w

    def cap_of(node: N.PlanNode) -> int:
        if isinstance(node, N.PScan):
            return node.capacity
        if isinstance(node, N.PAgg):
            return node.capacity
        if isinstance(node, N.PMotion):
            return node.out_capacity or cap_of(node.child)
        if isinstance(node, N.PJoin):
            if not node.unique_build:
                return node.out_capacity
            return cap_of(node.probe)
        if isinstance(node, N.PConcat):
            return sum(cap_of(c) for c in node.inputs)
        kids = node.children()
        return max((cap_of(c) for c in kids), default=1)

    def rec(node: N.PlanNode):
        nonlocal total
        b = cap_of(node) * width(node)
        per_node.append((node.title(), b))
        total += b
        for c in node.children():
            rec(c)

    rec(plan)
    return MemoryEstimate(total, per_node)


def check_admission(plan: N.PlanNode, session) -> MemoryEstimate:
    """The plan's estimate, or ``ResourceError`` when it exceeds the
    session's ``resource.query_mem_bytes``."""
    from cloudberry_tpu_torch.utils.faultinject import fault_point

    fault_point("admission_check")
    est = estimate_plan_memory(plan)
    budget = session.config.resource.query_mem_bytes
    if est.peak_bytes > budget:
        top = sorted(est.per_node, key=lambda x: -x[1])[:3]
        raise ResourceError(
            f"query memory estimate {est.peak_bytes >> 20} MiB exceeds the "
            f"per-query budget {budget >> 20} MiB "
            f"(largest nodes: {top}); raise "
            "config.resource.query_mem_bytes or reduce capacities")
    return est
