"""Catalog metadata snapshots for thin clients — the pg_catalog role.

The reference's MCP server answers metadata questions with catalog SQL
(mcp-server/src/cbmcp/database.py: information_schema / pg_class joins);
here the catalog IS in-process state, so metadata is read directly and
shipped as JSON-safe dicts. Consumed by the wire protocol's {"meta": ...}
request (serve/server.py) and by the MCP server (serve/mcp.py).
"""

from __future__ import annotations


def _policy(t) -> str:
    p = t.policy
    if p.kind == "hashed":
        return f"DISTRIBUTED BY ({', '.join(p.keys)})"
    return f"DISTRIBUTED {p.kind.upper()}"


def _table_row(name: str, t) -> dict:
    return {
        "name": name,
        "columns": len(t.schema.fields),
        "rows": int(t.num_rows),
        "distribution": _policy(t),
        "partitioned": t.partition_spec is not None,
        "cold": bool(getattr(t, "cold", False)),
        "external": bool(getattr(t, "external", None)),
    }


def _int_arg(kind: str, arg, default: int) -> int:
    """Integer limit argument with a clear wire error for bad input (a
    client copying the "prom" arg onto the wrong verb should read WHY)."""
    if arg is None or arg == "":
        return default
    try:
        return int(arg)
    except (TypeError, ValueError):
        raise ValueError(
            f"meta {kind!r} takes an integer limit argument, "
            f"got {arg!r}") from None


def describe(session, kind: str, arg=None):
    """One metadata answer. Kinds: tables | columns | stats | views |
    matviews | sequences | info | activity | sched | tenants |
    metrics | statements | trace | progress | flight | topology |
    ingest | compaction | summary."""
    # metadata must see other sessions' committed DDL — a thin client may
    # only ever ask metadata questions, so sync here, not just in sql()
    session._sync_store()
    cat = session.catalog
    if kind == "tables":
        return [_table_row(n, t) for n, t in sorted(cat.tables.items())]
    if kind == "columns":
        t = cat.table(str(arg))
        uniq = t.stats.unique or {}
        return [{"name": f.name, "type": str(f.type),
                 # DECLARED nullability (information_schema semantics) —
                 # the in-RAM validity mask is absent for cold tables and
                 # says nothing about the declaration
                 "nullable": bool(f.nullable),
                 "unique": bool(uniq.get(f.name, False))}
                for f in t.schema.fields]
    if kind == "stats":
        t = cat.table(str(arg))
        return {
            "rows": int(t.num_rows),
            "ndv": {c: int(v) for c, v in (t.stats.ndv or {}).items()},
            "min_max": {c: [float(lo), float(hi)]
                        for c, (lo, hi) in (t.stats.min_max or {}).items()},
            "distribution": _policy(t),
        }
    if kind == "views":
        return sorted(cat.views)
    if kind == "matviews":
        return [{"name": n,
                 "base_table": getattr(d, "base_table", None),
                 "incremental": bool(getattr(d, "incremental", False)),
                 "fresh": getattr(d, "fresh_token", None) is not None}
                for n, d in sorted(cat.matviews.items())]
    if kind == "sequences":
        return sorted(getattr(cat, "sequences", {}) or ())
    if kind == "info":
        breaker = getattr(session, "_breaker", None)
        return {
            "engine": "cloudberry_tpu_torch",
            "n_segments": int(session.config.n_segments),
            "durable": session.store is not None,
            "tables": len(cat.tables),
            "views": len(cat.views),
            "matviews": len(cat.matviews),
            # admission circuit breaker (lifecycle.py): closed | open
            # (read-only-degraded) | half-open, with trip counters
            "breaker": breaker.snapshot() if breaker is not None else None,
            # mid-statement recovery (exec/recovery.py): device-loss
            # retries, tile checkpoints/resumes, and the replay cost
            "recovery": {k: session.stmt_log.counter(k) for k in (
                "recoveries", "tile_checkpoints", "tile_resumes",
                "tiles_replayed", "tile_resume_declined",
                "tile_ckpt_failed", "recovery_wall_ms",
                "watchdog_timeouts")},
        }
    if kind == "sched":
        # scheduler observability: queue depth / batch occupancy from the
        # micro-batch dispatcher (when one is attached) plus the engine's
        # compile-hit / parameterization counters (sched/paramplan.py via
        # exec/instrument.py StatementLog) and the shared cache tier's
        # scope (sched/sharedcache.py)
        from cloudberry_tpu_torch.sched import sharedcache

        disp = getattr(session, "_dispatcher", None)
        return {
            "generic_plans": bool(session.config.sched.generic_plans),
            "dispatcher": disp.snapshot() if disp is not None else None,
            "counters": session.stmt_log.counter_snapshot(),
            "shared_cache": sharedcache.tier_snapshot(session),
        }
    if kind == "tenants":
        # per-tenant workload governance (sched/tenancy.py): weights,
        # queue depth, running/served/rejected counters, queue-wait
        # stats, and the weight-normalized fairness index
        sched = getattr(session, "_tenancy", None)
        if sched is None:
            disp = getattr(session, "_dispatcher", None)
            sched = getattr(disp, "tenancy", None) if disp else None
        if sched is None:
            return {"enabled": False}
        return {"enabled": True,
                "groups": sched.snapshot(),
                "fairness_index": round(sched.fairness_index(), 4)}
    if kind == "metrics":
        # engine-wide metrics registry (obs/metrics.py): counters,
        # gauges, log2-bucket histograms. Every engine memory-holder
        # gauge refreshes at READ time (obs/capacity.py) so the
        # snapshot shows where host+device memory actually sits.
        # arg="prom" returns the Prometheus-style text exposition
        # instead of the JSON snapshot.
        from cloudberry_tpu_torch.obs import capacity

        capacity.refresh_gauges(session)
        if arg == "prom":
            return session.stmt_log.registry.exposition()
        return session.stmt_log.registry.snapshot()
    if kind == "progress":
        # live statement progress (obs/progress.py): every active
        # statement's monotone tiles/rows fraction — the
        # pg_stat_progress_* role
        return {"statements": session.stmt_log.progress_rows()}
    if kind == "flight":
        # slow-statement flight recorder (obs/flightrec.py): the most
        # recent captured debug bundles, newest first; arg bounds how
        # many ship (bundles embed plans + traces — they are not small)
        return {"flights": session.stmt_log.flights(
            _int_arg(kind, arg, 8))}
    if kind == "topology":
        # versioned cluster topology (parallel/topology.py): the
        # serving epoch, any pending change + its rebalance progress
        # (moved rows vs the jump-hash minimal-movement bound), flip /
        # promotion counters, and the recent epoch history — the
        # gp_segment_configuration + gpexpand-status role
        topo = getattr(session, "_topology", None)
        if topo is None:
            return {"enabled": False}
        out = topo.snapshot()
        out["enabled"] = True
        return out
    if kind == "ingest":
        # streaming ingest plane (storage/ingest.py): buffer occupancy
        # per (table, tenant), flush thresholds, drain state, and the
        # append/flush/backpressure counter story — the write-plane
        # half of the AO-table dashboard
        ing = getattr(session, "_ingest", None)
        if ing is None:
            return {"enabled": False}
        return ing.snapshot()
    if kind == "compaction":
        # background compaction (storage/compact.py): per-table
        # delta-partition census against the bounded invariant, worker
        # state, and the chunk/conflict/journal counters — the VACUUM
        # progress role
        comp = getattr(session, "_compactor", None)
        if comp is None:
            return {"enabled": False}
        return comp.snapshot()
    if kind == "statements":
        # pg_stat_statements analog (obs/statements.py): per-skeleton
        # calls / wall / rows / compiles / generic-hit rate / wire
        # bytes, heaviest first; arg bounds the row count
        return session.stmt_log.statements.snapshot(
            _int_arg(kind, arg, 50))
    if kind == "trace":
        # statement trace spans (obs/trace.py): the most recent
        # completed span trees, newest first, plus the assembled
        # Chrome-trace document (Perfetto-loadable); arg bounds how
        # many traces ship
        from cloudberry_tpu_torch.obs.trace import chrome_trace

        traces = session.stmt_log.traces(_int_arg(kind, arg, 8))
        return {"traces": traces, "chrome": chrome_trace(traces)}
    if kind == "activity":
        # pg_stat_activity role: running + recent statements across every
        # backend of this server (one shared StatementLog)
        return {"active": session.stmt_log.activity(),
                "recent": session.stmt_log.recent(
                    int(arg) if arg else 50)}
    if kind == "summary":
        return {n: {"rows": int(t.num_rows),
                    "columns": [f.name for f in t.schema.fields]}
                for n, t in sorted(cat.tables.items())}
    raise ValueError(f"unknown meta kind {kind!r}")
