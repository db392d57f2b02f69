"""Join-index cache — sorted-build reuse across statements.

Every sorted-build join pays a sort of its build side per execution
(exec/kernels.py ``build_sort``) even though build sides are usually
dimension tables identical across statements. This module runs that
``build_sort`` once on the table's device copy (``Session.device_table``),
laid out as the build scan presents it, and caches its output — (stable
sort order, sorted packed keys, packing ranges) — in an LRU of the
session's cache scope (sched/sharedcache.py), keyed by (table version
token, key columns, pack bits, topology epoch, device). The JAX package
builds the same index with a numpy mirror on the host; the port's table
already lives on the device, so it sorts there. The index rides next to
the tables as an extra input (``$jix:…``), and the join lowering skips
the build-side sort when it finds it: a repeated statement uploads
nothing and sorts nothing. Any write bumps the table version, which
changes the key — the version machinery IS the invalidation contract.

Eligible joins (``annotate_join_index``, stamped after distribution):
the build subtree is a bare full-table scan of a RAM table (optionally
under PShare), or that scan under a plain broadcast motion — the gathered
buffer's row order is deterministic (shard-major), so the index can be
built over the same layout; every build key is a plain ColumnRef onto a
scanned column, and there is no build-side key-validity expression
(NULL-key masking would change the masked sort order at run time). Pruned
store scans and point-lookup slices change their row set per statement,
so they keep the in-program sort. Joins the probe-join kernel takes never
consult the index (the kernel runs first).

Layouts (``JoinIndexSpec.mode``), as in the JAX package: 'table' (the
whole table, or ONE shard under direct dispatch), 'shard' (a colocated
distributed build: one index per segment, over that segment's shard) and
'gathered' (a broadcast build: one index over the segment-major gathered
buffer, each shard a selected prefix).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from cloudberry_tpu_torch.plan import expr as ex
from cloudberry_tpu_torch.plan import nodes as N


@dataclass(frozen=True)
class JoinIndexSpec:
    """One eligible join's cached-index contract: the input key (shared
    by every join wanting the same index) and the build scan's layout."""

    key: str          # input key ("$jix:…")
    table: str
    phys: tuple       # physical key column names, join-key order
    bits: int         # PJoin.pack_bits
    capacity: int     # build scan rows (its capacity)
    mode: str = "table"   # 'table' | 'shard' | 'gathered'


# ------------------------------------------------------------- annotation


def annotate_join_index(plan: N.PlanNode, session) -> None:
    """Stamp every eligible PJoin with its JoinIndexSpec (``_jix``); input
    assembly then feeds the cached index and the join lowering skips the
    build-side sort."""
    if session.config.join_filter.index_cache <= 0:
        return
    from cloudberry_tpu_torch.exec import executor as X

    nseg = session.config.n_segments
    direct = getattr(plan, "_direct_segment", None) is not None
    for node in X.all_nodes(plan):
        if isinstance(node, N.PJoin) and not hasattr(node, "_jix"):
            spec = _build_spec(node, session, nseg, direct)
            if spec is not None:
                node._jix = spec


def _build_spec(node: N.PJoin, session, nseg: int = 1,
                direct: bool = False):
    from cloudberry_tpu_torch.exec.executor import keyed_scan

    if node.build_key_valid is not None:
        return None
    build = node.build
    mode = "table"
    while isinstance(build, N.PShare):
        build = build.child
    if isinstance(build, N.PMotion):
        if build.kind != "broadcast" or build.pre_compact:
            return None
        mode = "gathered"
        build = build.child
    while isinstance(build, N.PShare):
        build = build.child
    if not isinstance(build, N.PScan) or build.table_name == "$dual":
        return None
    if keyed_scan(build) or hasattr(build, "_point_col"):
        # pruned store reads / point slices change their row set per
        # statement — the table version cannot key their layout
        return None
    try:
        t = session.catalog.table(build.table_name)
    except KeyError:
        return None
    rev = {out: p for p, out in build.column_map.items()}
    phys = []
    for k in node.build_keys:
        if not isinstance(k, ex.ColumnRef):
            return None
        p = rev.get(k.name)
        if p is None:
            return None
        phys.append(p)
    if mode == "table" and nseg > 1 and not direct \
            and t.policy.kind != "replicated":
        # distributed colocated build: the fragment is this segment's
        # shard — one index per segment
        mode = "shard"
    key = (f"$jix:{build.table_name}:{','.join(phys)}:"
           f"{node.pack_bits}:{mode}")
    return JoinIndexSpec(key, build.table_name, tuple(phys),
                         node.pack_bits, build.capacity, mode)


def strip_join_index(plan: N.PlanNode) -> None:
    """Remove every join-index annotation (tiled intake): the tiled
    prelude and step programs assemble their own inputs, so a join there
    sorts its build side in-program."""
    from cloudberry_tpu_torch.exec import executor as X

    for node in X.all_nodes(plan):
        if isinstance(node, N.PJoin) and hasattr(node, "_jix"):
            del node._jix


def stash_join_index(plan: N.PlanNode) -> list:
    """(node, spec) pairs for every annotated join. Tiled planning strips
    speculatively before it knows it can execute the plan — a decline
    restores these (restore_join_index) so the one-shot fallback keeps
    the cached index."""
    from cloudberry_tpu_torch.exec import executor as X

    return [(n, n._jix) for n in X.all_nodes(plan)
            if isinstance(n, N.PJoin) and hasattr(n, "_jix")]


def restore_join_index(stash) -> None:
    for node, spec in stash:
        node._jix = spec


def jix_specs_of(plan: N.PlanNode) -> list[JoinIndexSpec]:
    """Deduped (by input key) specs of every annotated join in the plan."""
    from cloudberry_tpu_torch.exec import executor as X

    seen: set[str] = set()
    out = []
    for node in X.all_nodes(plan):
        spec = getattr(node, "_jix", None) \
            if isinstance(node, N.PJoin) else None
        if spec is not None and spec.key not in seen:
            seen.add(spec.key)
            out.append(spec)
    return out


# ------------------------------------------------- shared-scope LRU


def _cache(session):
    from cloudberry_tpu_torch.sched import sharedcache

    scope = sharedcache.scope_for(session)
    return scope.joinindex, scope.joinindex_lock


def index_key(session, spec: JoinIndexSpec, segment=None) -> tuple:
    """The cache key of one spec's index in this session: the table's
    content-stable version token, the key layout (mode, segment count,
    direct-dispatch segment), the topology epoch (an index laid out under
    a pre-cutover epoch can never serve after the flip), and the device
    the index tensors live on."""
    from cloudberry_tpu_torch.sched import sharedcache

    return (sharedcache.table_key(session, spec.table), spec.phys,
            spec.bits, spec.capacity, spec.mode,
            session.config.n_segments, segment,
            sharedcache.topology_token(session),
            sharedcache.device_token(session))


def _cached_index(session, spec: JoinIndexSpec, segment=None):
    """The spec's index tensors from the scope LRU, built on miss: a dict
    of tensors, or for 'shard' mode a list of per-segment dicts."""
    t = session.catalog.table(spec.table)
    t.ensure_loaded()
    key = index_key(session, spec, segment)
    cache, lock = _cache(session)
    with lock:
        hit = cache.pop(key, None)
        if hit is not None:
            cache[key] = hit  # LRU touch
    log = getattr(session, "stmt_log", None)
    if hit is not None:
        if log is not None:
            log.bump("join_index_hits")
        return hit
    hit = _build_index(session, spec, t, segment)
    if log is not None:
        log.bump("join_index_builds")
    limit = max(session.config.join_filter.index_cache, 1)
    with lock:
        while len(cache) >= limit:
            cache.pop(next(iter(cache)))
        cache[key] = hit
    return hit


def _sorted_index(cols, sel, bits: int) -> dict:
    from cloudberry_tpu_torch.exec import kernels as K

    order, skeys, ranges = K.build_sort(cols, sel, bits)
    out = {"order": order, "skeys": skeys}
    for i, (lo, span) in enumerate(ranges):
        out[f"lo{i}"] = lo
        out[f"span{i}"] = span
    return out


def _build_index(session, spec: JoinIndexSpec, t, segment=None):
    """``kernels.build_sort`` of the build's key columns on the device, as
    the build presents them. 'table': the table's rows (or the
    direct-dispatched shard's), zero-padded to the scan's capacity (an
    empty table scans one zero row), rows past the count unselected.
    'shard': one index per segment over its shard row. 'gathered': one
    index over the segment-major concatenation of the shards, each shard
    a selected prefix."""
    if spec.mode in ("shard", "gathered") or (
            segment is not None and t.policy.kind != "replicated"):
        ds = session.device_shards(spec.table)
        cap = ds.capacity
        ar = torch.arange(cap, device=session.device)
        if spec.mode == "shard":
            return [_sorted_index([ds.columns[p][s] for p in spec.phys],
                                  ar < int(ds.counts_host[s]), spec.bits)
                    for s in range(ds.nseg)]
        if spec.mode == "gathered":
            sel = torch.cat([ar < int(ds.counts_host[s])
                             for s in range(ds.nseg)])
            return _sorted_index([ds.columns[p].reshape(-1)
                                  for p in spec.phys], sel, spec.bits)
        return _sorted_index([ds.columns[p][segment] for p in spec.phys],
                             ar < int(ds.counts_host[segment]), spec.bits)
    data = session.device_table(spec.table)
    cap = max(spec.capacity, t.num_rows, 1)
    cols = []
    for p in spec.phys:
        c = data[p]
        if c.shape[0] < cap:
            c = torch.cat([c, c.new_zeros(cap - c.shape[0])])
        cols.append(c)
    sel = torch.arange(cap, device=session.device) < t.num_rows
    return _sorted_index(cols, sel, spec.bits)


# -------------------------------------------------------- input assembly


def join_index_inputs(plan: N.PlanNode, session, segment=None) -> dict:
    """{input key: index tensors} for every annotated join — the single /
    direct-dispatch input assembly chokepoint (exec/executor.py
    prepare_inputs)."""
    return {spec.key: _cached_index(session, spec, segment)
            for spec in jix_specs_of(plan)}


def dist_join_index_inputs(plan: N.PlanNode, session) -> list:
    """Per-segment {input key: index tensors} for the distributed gang:
    'shard'-mode indexes split by segment, 'table'/'gathered' ones shared
    by every segment (the reference's replicated inputs)."""
    nseg = session.config.n_segments
    out = [dict() for _ in range(nseg)]
    for spec in jix_specs_of(plan):
        arrs = _cached_index(session, spec, None)
        for s in range(nseg):
            out[s][spec.key] = arrs[s] if spec.mode == "shard" else arrs
    return out
