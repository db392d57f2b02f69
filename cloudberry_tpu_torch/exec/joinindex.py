"""Join-index cache — sorted-build reuse across statements.

Every sorted-build join pays a sort of its build side per execution
(exec/kernels.py ``build_sort``) even though build sides are usually
dimension tables identical across statements. This module runs that
``build_sort`` once on the table's device copy (``Session.device_table``),
laid out as the build scan presents it, and caches its output — (stable
sort order, sorted packed keys, packing ranges) — in an LRU of the
session's cache scope (sched/sharedcache.py), keyed by (table version
token, key columns, pack bits, device). The JAX package builds the same
index with a numpy mirror on the host; the port's table already lives on
the device, so it sorts there. The index rides next to the tables as an
extra input (``$jix:…``), and the join lowering skips the build-side sort
when it finds it: a repeated statement uploads nothing and sorts nothing.
Any write bumps the table version, which changes the key — the version
machinery IS the invalidation contract.

Eligible joins (``annotate_join_index``): the build subtree is a bare
full-table scan of a RAM table (optionally under PShare), every build key
is a plain ColumnRef onto a scanned column, and there is no build-side
key-validity expression (NULL-key masking would change the masked sort
order at run time). Pruned store scans and point-lookup slices change
their row set per statement, so they keep the in-program sort. Joins the
probe-join kernel takes never consult the index (the kernel runs first).

The JAX package's 'shard' and 'gathered' layouts belong to multi-segment
execution, which the port does not carry: every index here is a whole
table's ('table' mode).
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


# ------------------------------------------------------------- annotation


def annotate_join_index(plan: N.PlanNode, session) -> None:
    """Stamp every eligible PJoin with its JoinIndexSpec (``_jix``); input
    assembly then feeds the cached index and the join lowering skips the
    build-side sort."""
    if session.config.join_filter.index_cache <= 0:
        return
    from cloudberry_tpu_torch.exec import executor as X

    for node in X.all_nodes(plan):
        if isinstance(node, N.PJoin) and not hasattr(node, "_jix"):
            spec = _build_spec(node, session)
            if spec is not None:
                node._jix = spec


def _build_spec(node: N.PJoin, session):
    from cloudberry_tpu_torch.exec.executor import keyed_scan

    if node.build_key_valid is not None:
        return None
    build = node.build
    while isinstance(build, N.PShare):
        build = build.child
    if not isinstance(build, N.PScan) or build.table_name == "$dual":
        return None
    if keyed_scan(build) or hasattr(build, "_point_col"):
        # pruned store reads / point slices change their row set per
        # statement — the table version cannot key their layout
        return None
    try:
        session.catalog.table(build.table_name)
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
    key = (f"$jix:{build.table_name}:{','.join(phys)}:"
           f"{node.pack_bits}:table")
    return JoinIndexSpec(key, build.table_name, tuple(phys),
                         node.pack_bits, build.capacity)


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


def index_key(session, spec: JoinIndexSpec) -> tuple:
    """The cache key of one spec's index in this session: the table's
    content-stable version token, the key layout, and the device the
    index tensors live on."""
    from cloudberry_tpu_torch.sched import sharedcache

    return (sharedcache.table_key(session, spec.table), spec.phys,
            spec.bits, spec.capacity, sharedcache.device_token(session))


def _cached_index(session, spec: JoinIndexSpec) -> dict:
    """The spec's index tensors from the scope LRU, built on miss."""
    t = session.catalog.table(spec.table)
    t.ensure_loaded()
    key = index_key(session, spec)
    cache, lock = _cache(session)
    with lock:
        hit = cache.pop(key, None)
        if hit is not None:
            cache[key] = hit  # LRU touch
    counters = getattr(session, "counters", None)
    if hit is not None:
        if counters is not None:
            counters.bump("join_index_hits")
        return hit
    hit = _build_index(session, spec, t)
    if counters is not None:
        counters.bump("join_index_builds")
    limit = max(session.config.join_filter.index_cache, 1)
    with lock:
        while len(cache) >= limit:
            cache.pop(next(iter(cache)))
        cache[key] = hit
    return hit


def _build_index(session, spec: JoinIndexSpec, t) -> dict:
    """``kernels.build_sort`` of the table's key columns on the device, as
    the build scan presents them: the table's rows, zero-padded to the
    scan's capacity (an empty table scans one zero row), rows past the
    count unselected."""
    from cloudberry_tpu_torch.exec import kernels as K

    data = session.device_table(spec.table)
    cap = max(spec.capacity, t.num_rows, 1)
    cols = []
    for p in spec.phys:
        c = data[p]
        if c.shape[0] < cap:
            c = torch.cat([c, c.new_zeros(cap - c.shape[0])])
        cols.append(c)
    sel = torch.arange(cap, device=session.device) < t.num_rows
    order, skeys, ranges = K.build_sort(cols, sel, spec.bits)
    out = {"order": order, "skeys": skeys}
    for i, (lo, span) in enumerate(ranges):
        out[f"lo{i}"] = lo
        out[f"span{i}"] = span
    return out


# -------------------------------------------------------- input assembly


def join_index_inputs(plan: N.PlanNode, session) -> dict:
    """{input key: index tensors} for every annotated join — the input
    assembly chokepoint (exec/executor.py prepare_inputs)."""
    return {spec.key: _cached_index(session, spec)
            for spec in jix_specs_of(plan)}
