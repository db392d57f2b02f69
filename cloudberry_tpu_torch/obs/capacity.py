"""Capacity accounting — where the bytes go, per statement and per holder.

Theseus (PAPERS.md) makes data-movement/memory accounting the core of
its scheduling story, and a device-memory-bound SQL engine must SEE
memory pressure before it can govern it. This module is the second
observability layer's memory plane:

- **per-statement device bytes**: ``plan_device_bytes`` walks a compiled
  statement's plan exactly the way the admission estimator does
  (capacity × Σ dtype widths per node — program inputs, intermediates
  and outputs are all shape-static) and ADDS the two costs admission
  does not itemize: packed-wire motion buffers (the (cap, W) uint32
  staging arrays, exec/kernels.py wire_layout) and redistribute rung
  capacities (bucket_cap × nseg receive buffers). Every dispatched
  statement records its estimate into the ``stmt_device_bytes`` (peak)
  and ``stmt_live_bytes`` (largest single node — the lower bound XLA
  cannot fuse away) histograms, plus the engine-wide
  ``stmt_device_bytes_peak`` high-water gauge;

- **engine memory gauges**: ``refresh_gauges`` snapshots every
  engine-wide memory holder — the shared plan-cache tier (generic
  skeletons / rung executables / join indexes, sched/sharedcache.py),
  RecoveryStore checkpoint pins (host bytes), the trace and flight
  rings, the statements table, the dispatcher queue, the per-session
  statement/store-scan caches — as ``mem_*`` gauges, so
  ``meta "metrics"`` answers "where does host+device memory actually
  sit" without a debugger. Gauges refresh at READ time (the meta verb
  calls this), so the steady-state hot path pays nothing.

Gauge writes live HERE by contract (the JAX package's graftlint
``obs-gauge-home`` rule): a point-in-time gauge scattered across the
engine goes stale invisibly; one refresh site cannot.

The wire and rung terms count the motions of distributed plans; the
two-level exchange's staging (hierarchical motions) is not ported and
raises if reached. Device bytes of tensors count through their storage
(``nbytes_of``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def _wire_row_bytes(node) -> int:
    """Bytes one row costs on a motion's wire: the packed-wire layout
    width when the dtypes pack (one flag word per 32 of the validity bit
    and the bool columns, then whole 32-bit words for 4- and 8-byte
    columns — the JAX package's ``kernels.wire_layout``), else the raw
    per-column itemsize sum (+1 for the validity mask) — the same
    fallback EXPLAIN ANALYZE's motion annotation uses."""
    dtypes = [np.dtype(f.type.np_dtype) for f in node.child.fields]
    n_bool = sum(1 for d in dtypes if d == np.bool_)
    wides = [d.itemsize for d in dtypes if d != np.bool_]
    if any(size not in (4, 8) for size in wides):
        return sum(d.itemsize for d in dtypes) + 1
    words = max(1, -(-(1 + n_bool) // 32)) + sum(s // 4 for s in wides)
    return 4 * words


def two_level_staging_bytes(node, row_bytes: int | None = None) -> int:
    """Per-segment staging bytes of the TWO-LEVEL exchange (the JAX
    package's parallel/transport.py hier_all_to_all); zero for unstamped
    (flat) motions. Hierarchical motions come with the distributed
    executor, which is not ported."""
    hh = int(getattr(node, "hier_hosts", 0) or 0)
    hb = int(getattr(node, "host_bucket_cap", 0) or 0)
    if hh < 2 or hb <= 0:
        return 0
    raise NotImplementedError(
        "two-level exchange staging: the distributed executor is not "
        "yet ported")


def plan_device_bytes(plan, session=None) -> dict:
    """Itemized device-byte estimate for one compiled statement.

    Returns ``{"peak_bytes", "live_bytes", "wire_bytes", "rung_rows",
    "nodes"}``: peak is the admission estimator's
    all-intermediates-live upper bound PLUS the wire staging buffers
    (including the two-level exchange's lane/host-block staging when a
    motion is stamped hierarchical); live is the largest single node
    (the floor no fusion removes); rung_rows totals redistribute
    receive capacities (bucket_cap over every destination) — the
    skew-governed share of the peak."""
    from cloudberry_tpu_torch.exec.executor import all_nodes
    from cloudberry_tpu_torch.exec.resource import estimate_plan_memory
    from cloudberry_tpu_torch.plan import nodes as N

    est = estimate_plan_memory(plan)
    live = max((b for _, b in est.per_node), default=0)
    wire = 0
    rung_rows = 0
    seen: set = set()
    for node in all_nodes(plan):
        if not isinstance(node, N.PMotion) or id(node) in seen:
            continue
        seen.add(id(node))
        rows = max(int(node.out_capacity or 0), 0)
        rb = _wire_row_bytes(node)
        wire += rows * rb
        if node.kind == "redistribute":
            rung_rows += rows  # bucket_cap × nseg by construction
            wire += two_level_staging_bytes(node, rb)
    return {
        "peak_bytes": int(est.peak_bytes + wire),
        "live_bytes": int(live),
        "wire_bytes": int(wire),
        "rung_rows": int(rung_rows),
        "nodes": len(est.per_node),
    }


def observe_stmt_bytes(log, peak_bytes: int, live_bytes: int = 0,
                       wire_bytes: int = 0) -> None:
    """Record one statement's device-byte estimate on the engine
    registry (histograms + the peak high-water gauge). No-op when the
    telemetry plane is off — the cached-statement hot path calls this
    with its cached admission cost."""
    if log is None or not getattr(log, "obs_enabled", False):
        return
    reg = log.registry
    reg.observe("stmt_device_bytes", int(peak_bytes))
    if live_bytes:
        reg.observe("stmt_live_bytes", int(live_bytes))
    if wire_bytes:
        reg.observe("stmt_wire_bytes", int(wire_bytes))
    reg.gauge_max("stmt_device_bytes_peak", int(peak_bytes))


def record_statement(log, plan, session, est=None) -> None:
    """Full itemized recording for a freshly planned statement. ``est``
    reuses the admission estimate when the caller already paid for it
    (the plan walk here only adds the wire/rung pass)."""
    if log is None or not getattr(log, "obs_enabled", False):
        return
    d = plan_device_bytes(plan, session)
    if est is not None:
        # the admission bound is the authoritative intermediates term;
        # the walk above re-derives it — keep whichever is larger so a
        # drift between the two never UNDER-reports
        d["peak_bytes"] = max(d["peak_bytes"],
                              int(est.peak_bytes) + d["wire_bytes"])
    observe_stmt_bytes(log, d["peak_bytes"], d["live_bytes"],
                       d["wire_bytes"])


def record_tiled(log, report: dict) -> None:
    """Tiled (out-of-core) statements: the carried working set — tile
    step intermediates plus the accumulator — IS the device peak; the
    report already itemizes it (exec/tiled.py _refresh_report). The
    scan pipeline's bounded prefetch queue (exec/scanpipe.py) pins
    prefetch_tiles × one tile's host working set on top — charged here
    (``est_pipeline_bytes``) so the staging memory is visible in the
    same histograms as the device estimate."""
    if log is None or not getattr(log, "obs_enabled", False):
        return
    peak = int(report.get("est_step_bytes", 0))
    fin = int(report.get("est_finalize_bytes", 0))
    pipe = int(report.get("est_pipeline_bytes", 0))
    # HBM buffer-pool residency for the streamed table
    # (exec/bufferpool.py, report stamp est_bufpool_bytes): charged
    # next to the pipeline's staging bytes — resident chunks occupy
    # device memory alongside the statement's working set
    bufp = int(report.get("est_bufpool_bytes", 0))
    observe_stmt_bytes(log, max(peak, fin) + pipe + bufp)


def record_tile_dispatch(log, report: dict) -> None:
    """POST-run gauge for the windowed tile dispatcher
    (exec/tilepipe.py): the statement's in-flight high-water mark,
    read off the freshly stamped report — record_tiled above runs at
    DISPATCH time when the report still carries the previous run's
    numbers. window=1 (the legacy loop) writes nothing, so the gauge
    only exists where a window was actually open."""
    if log is None or not getattr(log, "obs_enabled", False):
        return
    if int(report.get("tile_window", 1)) > 1:
        log.registry.gauge_max("tile_inflight",
                               float(report.get("inflight_depth", 0)))


# --------------------------------------------------------- memory gauges


def nbytes_of(obj) -> int:
    """Recursive byte count over numpy arrays and torch tensors nested in
    dicts/lists/tuples — the checkpoint-pin and cache accounting
    primitive. A tensor counts its whole storage (host or device bytes,
    wherever it lies). Non-array leaves count zero (closures have no
    portable size; they are counted as ENTRIES)."""
    if isinstance(obj, torch.Tensor):
        return int(obj.untyped_storage().nbytes())
    nb = getattr(obj, "nbytes", None)
    if nb is not None and isinstance(nb, (int, np.integer)):
        return int(nb)
    if isinstance(obj, dict):
        return sum(nbytes_of(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(nbytes_of(v) for v in obj)
    return 0


def refresh_gauges(session) -> dict:
    """Refresh every memory-holder gauge the port has on the session's
    registry and return the values: the generic-plan skeletons, the
    join-index cache and the buffer pool of the session's cache scope,
    the session's statement cache and store-scan cache, the recovery
    store's checkpoint pins, the trace and flight rings and the
    statements table; and the topology plane's epoch, segment count,
    rebalance fraction (1.0 when no change is pending) and moved bytes.
    ``*_bytes`` gauges are bytes measured from the live arrays: device
    bytes for the join index, the pool and the scan cache, host bytes for
    the checkpoint pins; the dispatcher's queue depth and the ingest
    buffers' host bytes. The port has no rung cache (sched/sharedcache.py;
    a stacked runner is a closure). The compactor's last pass gives the
    worst per-table delta-partition count. Per-connection
    server backends anchor on the SERVING session (``_obs_root``), so the
    session-private holders (statement and store-scan caches) report
    stable values, not whichever backend answered the meta request."""
    session = getattr(session, "_obs_root", session)
    log = getattr(session, "stmt_log", None)
    if log is None:
        return {}
    vals: dict[str, float] = {}

    scope = getattr(session, "_cache_scope", None)
    if scope is not None:
        with scope.generic_lock:
            vals["mem_plan_cache_skeletons"] = len(scope.generic)
        with scope.joinindex_lock:
            vals["mem_join_index_entries"] = len(scope.joinindex)
            vals["mem_join_index_bytes"] = sum(
                nbytes_of(v) for v in scope.joinindex.values())
        pool = getattr(scope, "bufferpool", None)
        if pool is not None:
            psnap = pool.snapshot()
            vals["mem_bufpool_bytes"] = psnap["bytes"]
            vals["mem_bufpool_entries"] = psnap["entries"]
            vals["mem_bufpool_max_bytes"] = psnap["max_bytes"]
    rec = getattr(session, "_recovery", None)
    if rec is not None:
        vals["mem_recovery_pins_bytes"] = rec.pinned_bytes()
        vals["mem_recovery_pins"] = rec.pinned_count()
    rings = log.ring_sizes()
    vals["mem_trace_ring_entries"] = rings["traces"]
    vals["mem_flight_ring_entries"] = rings["flights"]
    vals["mem_statement_rows"] = len(log.statements)
    disp = getattr(session, "_dispatcher", None)
    if disp is not None:
        vals["mem_dispatcher_queue_depth"] = disp.queue_depth()
    ing = getattr(session, "_ingest", None)
    if ing is not None:
        vals["mem_ingest_buffer_bytes"] = ing.buffered_bytes()
    stmt_cache = getattr(session, "_stmt_cache", None)
    if stmt_cache is not None:
        vals["mem_stmt_cache_entries"] = len(stmt_cache)
    scan_cache = getattr(session, "_store_scan_cache", None)
    if scan_cache is not None:
        lock = getattr(session, "_store_scan_lock", None)
        with lock if lock is not None else contextlib.nullcontext():
            entries = list(scan_cache.values())
        vals["mem_store_scan_bytes"] = nbytes_of(entries)
        vals["mem_store_scan_entries"] = len(entries)
    # versioned topology (parallel/topology.py): the serving epoch, the
    # in-flight rebalance's fraction and the bytes rebalances moved
    topo = getattr(session, "_topology", None)
    if topo is not None:
        snap = topo.snapshot()
        vals["topo_epoch"] = snap["epoch"]
        vals["topo_nseg"] = snap["nseg"]
        reb = snap.get("rebalance")
        vals["topo_rebalance_fraction"] = reb["fraction"] if reb else 1.0
        vals["topo_moved_bytes"] = float(log.counter("topo_moved_bytes"))
    # the bounded-invariant needle (storage/compact.py): the worst
    # per-table delta-partition count from the compactor's last pass
    comp = getattr(session, "_compactor", None)
    if comp is not None:
        vals["compact_delta_parts_max"] = comp.delta_parts_gauge()
    for name, v in vals.items():
        log.registry.gauge(name, v)
    return vals
