"""Parallel retrieve cursors — the endpoint subsystem analog.

Reference: ``DECLARE c PARALLEL RETRIEVE CURSOR FOR ...`` leaves each
segment's result slice ON the segment as a named endpoint; clients open
retrieve-mode connections per endpoint and drain them in parallel with
token auth (src/backend/cdb/endpoint/README, cdbendpoint.c:31-143,
cdbendpointretrieve.c). The point: result extraction scales with segments
instead of funneling through the QD.

Here: the cursor's query runs with the FINAL GATHER MOTION stripped (when
the plan allows — only row-wise Project/Filter may sit above it, the
``GetParallelCursorEndpointPosition`` decision) on the session's gang of
segment lowerers (exec/dist_executor.py), so each segment's rows become
one endpoint. Plans whose top requires a singleton (global
Sort/Limit/aggregate) fall back to ONE endpoint at the coordinator — the
reference's ON_ENTRY position. Endpoints hold host batches (the selected
rows only, as every result of the port) until CLOSE; their bytes stay
reserved against the engine-wide red line. Clients retrieve per endpoint
(``Session.retrieve``), in parallel across threads, authenticated by the
cursor's token (the EndpointTokenHash analog).
"""

from __future__ import annotations

import threading
import uuid
from dataclasses import dataclass, field

import numpy as np

from cloudberry_tpu_torch.plan import nodes as N


class CursorError(ValueError):
    pass


@dataclass
class Endpoint:
    segment: int
    batch: object           # ColumnBatch holding this shard's rows
    pos: int = 0            # rows already retrieved
    _decoded: dict | None = None   # decode-once cache (O(limit) chunks)
    _lock: object = field(default_factory=threading.Lock)

    @property
    def rows_total(self) -> int:
        return self.batch.num_rows()

    def decoded(self) -> dict:
        if self._decoded is None:
            self._decoded = self.batch.decoded_columns()
        return self._decoded


@dataclass
class ParallelCursor:
    name: str
    token: str
    endpoints: list = field(default_factory=list)
    parallel: bool = True   # False = ON_ENTRY fallback (one endpoint)
    vmem_id: int = 0        # lifetime reservation for the held results

    def info(self) -> dict:
        return {"cursor": self.name, "token": self.token,
                "parallel": self.parallel,
                "endpoints": [{"segment": e.segment,
                               "rows": e.rows_total - e.pos}
                              for e in self.endpoints]}


def declare(session, name: str, query_ast) -> dict:
    """Execute the cursor's query, keeping results per segment when the
    plan shape allows; registers the endpoints on the session."""
    from cloudberry_tpu_torch.exec import executor as X
    from cloudberry_tpu_torch.exec.resource import check_admission
    from cloudberry_tpu_torch.plan.binder import Binder
    from cloudberry_tpu_torch.plan.planner import _optimize

    name = name.lower()
    if name in session.parallel_cursors:
        raise CursorError(f"cursor {name!r} already exists")
    plan = _optimize(Binder(session.catalog, session.config)
                     .bind_query(query_ast), session)
    # the cursor's query is a statement like any other: per-query budget,
    # queue slot (MAX_COST, priority) and vmem reservation all apply
    est = check_admission(plan, session)
    nseg = session.config.n_segments
    endpoints: list[Endpoint] = []
    parallel = False
    with session._gate, session._admitted(est.peak_bytes):
        if nseg > 1 and getattr(plan, "_direct_segment", None) is None:
            stripped = _strip_top_gather(plan)
            if stripped is not None:
                from cloudberry_tpu_torch.exec.dist_executor import (
                    compile_segments, prepare_dist_inputs,
                    record_jf_counters, record_motion_stats, stats_to_host)
                from cloudberry_tpu_torch.plan.feedback import fold_plan

                X.build_kernels(session)
                fn = compile_segments(stripped, session)
                outs, checks, stats = fn(
                    prepare_dist_inputs(stripped, session))
                stats = stats_to_host(stats)
                record_motion_stats(stripped, stats, session=session)
                X.raise_checks(checks)
                record_jf_counters(stats,
                                   getattr(session, "stmt_log", None))
                fold_plan(session, stripped)
                for s, (cols, sel) in enumerate(outs):
                    endpoints.append(Endpoint(
                        s, X.make_batch(stripped, cols, sel)))
                parallel = True
        if not endpoints:
            # ON_ENTRY fallback: the top demands a singleton (global sort/
            # limit/aggregate) — one endpoint at the coordinator (the
            # gang's gathered result at n_segments > 1)
            endpoints = [Endpoint(0, X.execute(plan, session))]
    cur = ParallelCursor(name, uuid.uuid4().hex, endpoints, parallel)
    # endpoints HOLD their result rows until CLOSE — that memory stays
    # reserved against the engine-wide red line for the cursor's lifetime
    held = sum(int(np.asarray(a).nbytes)
               for e in endpoints for a in e.batch.columns.values())
    cur.vmem_id = next(session._stmt_ids)
    session._vmem.reserve(cur.vmem_id, held, timeout_s=10)
    session.parallel_cursors[name] = cur
    return cur.info()


def retrieve(session, name: str, segment: int, limit: int | None = None,
             token: str | None = None) -> dict:
    """Drain (up to ``limit``) rows from one endpoint — the RETRIEVE
    command. ``token`` must match when given."""
    from cloudberry_tpu_torch.utils.faultinject import fault_point

    fault_point("endpoint_drain")
    cur = session.parallel_cursors.get(name.lower())
    if cur is None:
        raise CursorError(f"unknown cursor {name!r}")
    if token is not None and token != cur.token:
        raise CursorError("invalid endpoint token")
    ep = next((e for e in cur.endpoints if e.segment == segment), None)
    if ep is None:
        raise CursorError(f"cursor {name!r} has no endpoint for segment "
                          f"{segment}")
    # one position per endpoint: concurrent retrieve-mode clients must
    # never receive the same rows (the reference allows ONE retrieving
    # session per endpoint; this lock enforces the same exclusivity)
    with ep._lock:
        cols = ep.decoded()
        names = list(cols)
        arrays = list(cols.values())
        total = len(arrays[0]) if arrays else 0
        hi = total if limit is None else min(ep.pos + max(limit, 0), total)
        rows = [[a[i] for a in arrays] for i in range(ep.pos, hi)]
        ep.pos = hi
    return {"columns": names, "rows": rows,
            "remaining": total - hi, "segment": segment}


def close_cursor(session, name: str) -> str:
    cur = session.parallel_cursors.pop(name.lower(), None)
    if cur is None:
        raise CursorError(f"unknown cursor {name!r}")
    session._vmem.release(cur.vmem_id)
    return f"CLOSE {name}"


def _strip_top_gather(plan: N.PlanNode):
    """Splice out the top gather motion when only row-wise nodes sit above
    it; None when the plan's top genuinely needs a singleton."""
    spine = []
    node = plan
    while isinstance(node, (N.PProject, N.PFilter)):
        spine.append(node)
        node = node.child
    if not (isinstance(node, N.PMotion) and node.kind == "gather"
            and not node.pre_compact):
        return None
    child = node.child
    if not spine:
        return child
    spine[-1].child = child
    for up in spine:
        up.sharding = child.sharding
    return plan
