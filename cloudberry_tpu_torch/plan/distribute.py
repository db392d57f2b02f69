"""Distribution pass — the cdbllize/cdbpath analog.

Walks the bound plan bottom-up, assigns a Sharding to every node (the
CdbPathLocus discipline, cdbpathlocus.h:41-68) and inserts PMotion nodes
exactly where the reference's planner inserts Motions:

- joins: colocated if both sides hash-partitioned on corresponding join keys
  (cdbpath_motion_for_join, cdbpath.c:1346); else broadcast the small side
  (BROADCAST motion) or redistribute (HASH motion) — here lowered to
  all_gather / all_to_all over the mesh;
- grouped aggregation: one-stage when child is partitioned on a subset of
  the group keys, else two-stage partial→redistribute→final
  (cdbgroupingpaths.c multi-stage agg), with avg split into sum+count;
- global aggregation: partial per segment → gather → final merge;
- sort/limit and the query result: gathered to a singleton (GATHER motion,
  the QD top slice).

Segment placement (load time, host) and Motion routing (device) both use
jump_consistent_hash over the same column hash — colocation depends on it.

A copy of the JAX package's plan/distribute.py (imports rewritten). The
single-segment tiled executor (exec/tiled.py) uses its aggregate split
(``_split_aggs``, ``_finalize_project``) too: a tiled aggregate is the
two-stage aggregate run over tiles instead of segments.
"""

from __future__ import annotations

import math
from typing import Optional

from cloudberry_tpu_torch.exec.kernels import rung_up
from cloudberry_tpu_torch.plan import expr as ex
from cloudberry_tpu_torch.plan import nodes as N
from cloudberry_tpu_torch.plan.sharding import Sharding
from cloudberry_tpu_torch.types import FLOAT64, INT64


def direct_dispatch_segment(plan: N.PlanNode, session):
    """The cdbtargeteddispatch.c analog: if every partitioned scan is
    filtered by equality literals covering its FULL distribution key set and
    all scans route to the same segment, the statement can run on that one
    segment with no collectives at all. Returns the segment id or None."""
    import numpy as np

    from cloudberry_tpu_torch.utils import hashing

    nseg = session.config.n_segments
    segs: set[int] = set()

    def conjuncts(e: ex.Expr):
        if isinstance(e, ex.BinOp) and e.op == "and":
            yield from conjuncts(e.left)
            yield from conjuncts(e.right)
        else:
            yield e

    def visit(node: N.PlanNode, preds: tuple) -> bool:
        if isinstance(node, N.PFilter):
            return visit(node.child, preds + (node.predicate,))
        if isinstance(node, N.PScan):
            if node.table_name == "$dual":
                return True
            table = session.catalog.table(node.table_name)
            if table.policy.kind == "replicated":
                return True
            if table.policy.kind != "hashed":
                return False
            eq: dict[str, ex.Literal] = {}
            for p in preds:
                for c in conjuncts(p):
                    if isinstance(c, ex.BinOp) and c.op == "=":
                        l, r = c.left, c.right
                        if isinstance(r, ex.ColumnRef) and \
                                isinstance(l, ex.Literal):
                            l, r = r, l
                        if isinstance(l, ex.ColumnRef) and \
                                isinstance(r, ex.Literal):
                            eq[l.name] = r
            try:
                key_names = [node.column_map[k] for k in table.policy.keys]
            except KeyError:
                return False
            if not all(k in eq for k in key_names):
                return False
            cols = []
            for k, phys in zip(key_names, table.policy.keys):
                dt = table.schema.field(phys).type.np_dtype
                cols.append(np.asarray([eq[k].value], dtype=dt))
            h = hashing.hash_columns_np(cols)
            segs.add(int(hashing.jump_consistent_hash_np(h, nseg)[0]))
            return True
        return all(visit(c, ()) for c in node.children())

    if not visit(plan, ()):
        return None
    for e in _all_exprs(plan):
        for sub in ex.walk(e):
            if isinstance(sub, ex.SubqueryScalar):
                return None  # subquery plans may scan other segments
    if len(segs) != 1:
        return None
    return next(iter(segs))


def _all_exprs(plan: N.PlanNode):
    yield from _node_exprs(plan)
    for c in plan.children():
        yield from _all_exprs(c)


def apply_direct_dispatch(plan: N.PlanNode, session, seg: int) -> N.PlanNode:
    """Rewrite scans for single-shard execution (capacities become the
    shard's) and tag the plan; the executor feeds segment ``seg``'s arrays."""
    def rewrite(node: N.PlanNode):
        if isinstance(node, N.PScan) and node.table_name != "$dual":
            table = session.catalog.table(node.table_name)
            if table.policy.kind != "replicated":
                st = session.sharded_table(node.table_name)
                node.capacity = st.capacity
                node.num_rows = int(st.counts[seg])
        for c in node.children():
            rewrite(c)

    rewrite(plan)
    plan._direct_segment = seg
    return plan


def broadcast_struct_rows(thr: int) -> int:
    """Structural ceiling on a replicated build buffer (rows × nseg) for
    memo-chosen broadcasts: the memo may broadcast ABOVE the greedy
    threshold when it is globally cheaper, but a misestimate must never
    allocate an unbounded replicated buffer."""
    return max(thr, 65536) * 16


def distribute_plan(plan: N.PlanNode, session) -> N.PlanNode:
    if session.config.planner.enable_memo:
        from cloudberry_tpu_torch.plan.memo import annotate_distribution

        annotate_distribution(plan, session)
    d = Distributor(session)
    plan, cap = d.walk(plan)
    if plan.sharding.is_partitioned:
        plan, cap = d.gather(plan, cap)
    return plan


class Distributor:
    def __init__(self, session):
        self.session = session
        self.nseg = session.config.n_segments
        self.cfg = session.config

    # -------------------------------------------------------------- walking

    def walk(self, node: N.PlanNode) -> tuple[N.PlanNode, int]:
        self._walk_subqueries(node)
        if isinstance(node, N.PScan):
            return self._scan(node)
        if isinstance(node, N.PFilter):
            child, cap = self.walk(node.child)
            node.child = child
            node.sharding = child.sharding
            return node, cap
        if isinstance(node, N.PProject):
            child, cap = self.walk(node.child)
            node.child = child
            node.sharding = _project_sharding(child.sharding, node.exprs)
            return node, cap
        if isinstance(node, N.PJoin):
            return self._join(node)
        if isinstance(node, N.PAgg):
            return self._agg(node)
        if isinstance(node, N.PSort):
            child, cap = self.walk(node.child)
            if child.sharding.is_partitioned:
                child, cap = self.gather(child, cap)
            node.child = child
            node.sharding = child.sharding
            return node, cap
        if isinstance(node, N.PLimit):
            k = node.limit + node.offset
            if isinstance(node.child, N.PSort) and 0 < k <= (1 << 20):
                self._walk_subqueries(node.child)  # sort keys' subqueries
                # top-N pushdown (the merge-sorted-receive analog,
                # execMotionSortedReceiver): each segment sorts and keeps its
                # own top k, compacts to k rows, THEN gathers — the
                # coordinator merges k·nseg rows instead of whole shards
                srt = node.child
                inner, icap = self.walk(srt.child)
                if inner.sharding.is_partitioned and k < icap:
                    local_sort = N.PSort(inner, list(srt.keys))
                    local_sort.fields = list(inner.fields)
                    local_sort.sharding = inner.sharding
                    local_top = N.PLimit(local_sort, k)
                    local_top.fields = list(inner.fields)
                    local_top.sharding = inner.sharding
                    m, _ = self.gather(local_top, k)
                    m.pre_compact = k
                    srt.child = m
                    srt.sharding = m.sharding
                    node.sharding = m.sharding
                    return node, m.out_capacity
                # fall through: finish as a plain gathered sort+limit
                if inner.sharding.is_partitioned:
                    inner, icap = self.gather(inner, icap)
                srt.child = inner
                srt.sharding = inner.sharding
                node.sharding = inner.sharding
                return node, icap
            child, cap = self.walk(node.child)
            if child.sharding.is_partitioned:
                child, cap = self.gather(child, cap)
            node.child = child
            node.sharding = child.sharding
            return node, cap
        if isinstance(node, N.PWindow):
            child, cap = self.walk(node.child)
            if child.sharding.is_partitioned:
                names = [e.name for e in node.partition_keys
                         if isinstance(e, ex.ColumnRef)]
                ok_coloc = (child.sharding.kind == "hashed"
                            and child.sharding.keys
                            and set(child.sharding.keys) <= set(names))
                if not ok_coloc:
                    if node.partition_keys and                             len(names) == len(node.partition_keys):
                        child, cap = self.redistribute(
                            child, cap, list(node.partition_keys))
                    else:
                        child, cap = self.gather(child, cap)
            node.child = child
            node.sharding = child.sharding
            return node, cap
        if isinstance(node, N.PShare):
            # distribute the shared subplan ONCE; every reference sees the
            # same (possibly motion-wrapped) result — consumers add their
            # own motions above if they need a different distribution
            cached = getattr(node.child, "_dist_out", None)
            if cached is None:
                child, cap = self.walk(node.child)
                cached = (child, cap)
                node.child._dist_out = cached
                child._dist_out = cached
            child, cap = cached
            node.child = child
            node.sharding = child.sharding
            return node, cap
        if isinstance(node, N.PConcat):
            total = 0
            new_inputs = []
            for c in node.inputs:
                cc, cap = self.walk(c)
                if cc.sharding.is_partitioned:
                    cc, cap = self.gather(cc, cap)
                new_inputs.append(cc)
                total += cap
            node.inputs = new_inputs
            node.sharding = Sharding.singleton()
            return node, total
        raise ValueError(f"distribute: unhandled node {type(node).__name__}")

    def _walk_subqueries(self, node: N.PlanNode) -> None:
        """Uncorrelated scalar subqueries ride inside expressions (InitPlan
        analog): distribute each one and make its one-row result available
        on every segment (gather → replicated compute)."""
        for e in _node_exprs(node):
            for sub in ex.walk(e):
                if isinstance(sub, ex.SubqueryScalar) \
                        and not getattr(sub, "_distributed", False):
                    plan, cap = self.walk(sub.plan)
                    if plan.sharding.is_partitioned:
                        plan, cap = self.gather(plan, cap)
                    sub.plan = plan
                    sub._distributed = True

    def _scan(self, node: N.PScan) -> tuple[N.PlanNode, int]:
        if node.table_name == "$dual":
            node.sharding = Sharding.general()
            return node, 1
        table = self.session.catalog.table(node.table_name)
        policy = table.policy
        if policy.kind == "replicated":
            node.sharding = Sharding.replicated()
            return node, node.capacity
        shard_cap = self.session.shard_capacity(node.table_name)
        node.capacity = shard_cap
        node.num_rows = -2  # per-segment count provided at runtime
        if policy.kind == "hashed" and all(k in node.column_map
                                           for k in policy.keys):
            keys = tuple(node.column_map[k] for k in policy.keys)
            node.sharding = Sharding.hashed(*keys)
        elif policy.kind == "hashed":
            # distribution keys pruned out of the scan: rows are still
            # hash-placed, but the planner can no longer NAME the keys
            node.sharding = Sharding.strewn()
        else:
            node.sharding = Sharding.strewn()
        return node, shard_cap

    # --------------------------------------------------------------- motion

    def gather(self, child: N.PlanNode, cap: int) -> tuple[N.PlanNode, int]:
        m = N.PMotion(child, "gather")
        m.fields = list(child.fields)
        m.sharding = Sharding.singleton()
        m.out_capacity = cap * self.nseg
        return m, m.out_capacity

    def broadcast(self, child: N.PlanNode, cap: int) -> tuple[N.PlanNode, int]:
        m = N.PMotion(child, "broadcast")
        m.fields = list(child.fields)
        m.sharding = Sharding.replicated()
        m.out_capacity = cap * self.nseg
        return m, m.out_capacity

    def redistribute(self, child: N.PlanNode, cap: int,
                     keys: list[ex.Expr],
                     est_rows: float | None = None,
                     est_under_exact: bool = False
                     ) -> tuple[N.PlanNode, int]:
        m = N.PMotion(child, "redistribute", hash_keys=list(keys))
        m.fields = list(child.fields)
        key_names = tuple(k.name for k in keys
                          if isinstance(k, ex.ColumnRef))
        m.sharding = (Sharding.hashed(*key_names)
                      if len(key_names) == len(keys) else Sharding.strewn())
        # skew-proof sizing: when the redistributed subtree is a (filtered)
        # base-table scan with column keys, compute the TRUE per-(source,
        # destination) row counts host-side — an exact upper bound that
        # absorbs ANY key skew (the planner-level answer to the reference's
        # skew handling; filters only shrink it further)
        exact = self._exact_bucket_cap(child, keys)
        factor = self.cfg.interconnect.capacity_factor
        if exact is not None:
            # the exact bound is authoritative: it absorbs ANY key skew,
            # and a runtime filter below only removes rows — never grows a
            # bucket past it. Estimates must not undercut it (a skewed hot
            # key would trip the overflow check the exact count prevents).
            # Rounded up to its capacity rung (kernels.rung_up) so equal-
            # shaped motions share compiled executables.
            m.bucket_cap = rung_up(max(exact, 8))
            if est_rows is not None and est_under_exact:
                # a DIGEST runtime filter shrank the input: the exact
                # bound (computed on the UNFILTERED scan) stays the
                # CEILING — it absorbs any skew — but the survivor
                # estimate may seed a LOWER rung: fewer padded wire
                # bytes, and an under-estimate (bloom false positives,
                # skewed survivors) is a detected overflow that promotes
                # back up the ladder (grow_expansion), never past the
                # ceiling it started from and never a wrong result
                est_bucket = rung_up(max(int(math.ceil(
                    min(est_rows, cap) / self.nseg * factor)), 64))
                m.bucket_cap = min(m.bucket_cap, est_bucket)
            m.out_capacity = m.bucket_cap * self.nseg
            self._stamp_hier(m, child, keys)
            return m, m.out_capacity
        # capacity-based flow control (the ic_udpifc.c:3018 analog): each
        # destination bucket holds factor × fair share; overflow is a
        # detected runtime error that promotes the motion one capacity
        # rung and retries (exec/executor.py:grow_expansion) — never a
        # silent drop. The seed rung comes from the planner estimate, so
        # padded bytes track expected volume, and skew climbs a BOUNDED
        # power-of-two ladder instead of forcing worst-case buffers.
        m.bucket_cap = max(int(math.ceil(cap / self.nseg * factor)), 8)
        if est_rows is not None:
            # a runtime filter shrank the input: size buckets as if the
            # worst source segment held min(cap, est) surviving rows —
            # robust to source skew (all survivors on one shard) while
            # still shrinking when the filter is selective; overflow stays
            # a detected error pointing at capacity_factor
            est_bucket = max(int(math.ceil(
                min(est_rows, cap) / self.nseg * factor)), 64)
            m.bucket_cap = min(m.bucket_cap, est_bucket)
        m.bucket_cap = rung_up(m.bucket_cap)
        # feedback-driven seed (plan/feedback.py): when a prior execution
        # OBSERVED this (table, key-set) shuffle under the same validity
        # tokens, the observed per-destination demand replaces the static
        # estimate — a learned rung, not a guess. Both directions pay:
        # seeding BELOW the static rung cuts padded wire bytes
        # (rung_downgrades), seeding ABOVE it skips the grow-and-retry
        # recompile the static seed would have hit (rung_upgrades). The
        # ladder discipline is untouched — the exact path above never gets
        # here, and an overflow against a stale-generalized sketch still
        # promotes and retries. planck re-derives the justified bound
        # from the live sketch (verify.py motion-rung-feedback-forged).
        self._feedback_seed(m, child, keys)
        m.out_capacity = m.bucket_cap * self.nseg
        self._stamp_hier(m, child, keys)
        return m, m.out_capacity

    def _feedback_seed(self, m: N.PMotion, child: N.PlanNode,
                       keys) -> None:
        from cloudberry_tpu_torch.plan import feedback as FB

        store = FB.store_for(self.session)
        if store is None:
            return
        src = FB.resolve_sources(child, keys)
        if src is None:
            return
        sk = store.lookup(self.session, "redist", src)
        if sk is None or sk.demand_max <= 0:
            return
        headroom = self.cfg.feedback.headroom
        seeded = rung_up(max(int(sk.demand_max * headroom), 8))
        if seeded == m.bucket_cap:
            return
        log = getattr(self.session, "stmt_log", None)
        if log is not None:
            log.bump("feedback_seeded")
            log.bump("rung_downgrades" if seeded < m.bucket_cap
                     else "rung_upgrades")
        m._feedback_seed = {"demand": sk.demand_max, "static": m.bucket_cap,
                            "rung": seeded, "src": src}
        m.bucket_cap = seeded

    # ------------------------------------------------- two-level stamping

    def _hier_topo(self):
        """The session's two-level topology (None = flat), derived once
        per Distributor walk. Epoch-aware: the derivation reads the live
        device list + survivor restriction, both of which an epoch flip
        changes — and a replan is exactly when this runs again."""
        if not hasattr(self, "_hier_topo_cache"):
            from cloudberry_tpu_torch.parallel.transport import hier_topology

            self._hier_topo_cache = hier_topology(
                self.cfg, self.nseg,
                getattr(self.session, "_live_device_ids", None))
        return self._hier_topo_cache

    def _stamp_hier(self, m: N.PMotion, child: N.PlanNode, keys) -> None:
        """Stamp the two-level caps on a redistribute when the topology
        gate selects the hierarchical transport: host_bucket_cap sizes
        the aggregated inter-host (DCN) block per (source host ->
        destination host) pair — the exact host-granularity bound when
        the subtree is a base scan, else the host's combined fair share
        — and hier_hosts pins the grouping the caps assume. Flat
        sessions (n_hosts == 1) never reach here: single-host plans are
        byte-identical to pre-two-level plans by construction."""
        topo = self._hier_topo()
        if topo is None:
            return
        if self.cfg.interconnect.hierarchical == "auto" \
                and m.bucket_cap * _wire_row_bytes(m) \
                < self.cfg.interconnect.hier_min_block_bytes:
            return      # blocks too small to amortize the extra launches
        if m.out_capacity >= 1 << 31:
            return      # route words address slots in u32 (transport)
        n_hosts = topo.n_hosts
        S = self.nseg // n_hosts
        exact = self._exact_host_cap(child, keys, n_hosts)
        if exact is not None:
            m.host_bucket_cap = rung_up(max(exact, 8))
        else:
            # a host's S segments' per-destination shares combined; an
            # under-estimate is a detected overflow that promotes the
            # host rung and retries (executor.grow_expansion), never a
            # wrong result — same ladder discipline as bucket_cap
            m.host_bucket_cap = rung_up(max(S * m.bucket_cap, 8))
        m.hier_hosts = n_hosts

    def _exact_host_cap(self, child: N.PlanNode, keys,
                        n_hosts: int) -> Optional[int]:
        """Exact max rows any (source host, destination host) pair
        exchanges — the host-granularity analog of _exact_bucket_cap
        (contiguous uniform grouping: host = segment // S)."""
        import numpy as np

        from cloudberry_tpu_torch.utils import hashing

        node = child
        while isinstance(node, (N.PFilter, N.PRuntimeFilter)):
            node = node.child
        if not isinstance(node, N.PScan) or node.table_name == "$dual":
            return None
        try:
            t = self.session.catalog.table(node.table_name)
        except KeyError:
            return None
        if t.policy.kind == "replicated":
            return None
        rev = {out: phys for phys, out in node.column_map.items()}
        phys = []
        for k in keys:
            p = rev.get(k.name) if isinstance(k, ex.ColumnRef) else None
            if p is None:
                return None
            phys.append(p)
        t.ensure_loaded()
        if t.num_rows == 0:
            return None
        cache = getattr(self.session, "_bucket_cap_cache", None)
        if cache is None:
            cache = self.session._bucket_cap_cache = {}
        key = ("host", node.table_name, getattr(t, "_version", 0),
               tuple(phys), self.nseg, n_hosts)
        hit = cache.get(key)
        if hit is not None:
            return hit
        S = self.nseg // n_hosts
        cols = [np.asarray(t.data[p]) for p in phys]
        dst = hashing.jump_consistent_hash_np(
            hashing.hash_columns_np(cols), self.nseg) // S
        src = t.shard_assignment(self.nseg)
        if src is None:
            return None
        counts = np.bincount(
            (src.astype(np.int64) // S) * n_hosts + dst,
            minlength=n_hosts * n_hosts)
        out = int(counts.max())
        if len(cache) >= 64:
            cache.pop(next(iter(cache)))
        cache[key] = out
        return out

    def _exact_bucket_cap(self, child: N.PlanNode, keys) -> Optional[int]:
        """Exact max rows any (source, destination) bucket can receive,
        from the base table's actual key values — None when the subtree
        isn't a plain (possibly filtered/runtime-filtered) scan."""
        import numpy as np

        from cloudberry_tpu_torch.utils import hashing

        node = child
        while isinstance(node, (N.PFilter, N.PRuntimeFilter)):
            node = node.child
        if not isinstance(node, N.PScan) or node.table_name == "$dual":
            return None
        try:
            t = self.session.catalog.table(node.table_name)
        except KeyError:
            return None
        if t.policy.kind == "replicated":
            return None
        rev = {out: phys for phys, out in node.column_map.items()}
        phys = []
        for k in keys:
            p = rev.get(k.name) if isinstance(k, ex.ColumnRef) else None
            if p is None:
                return None
            phys.append(p)
        t.ensure_loaded()  # distributed scans materialize anyway
        if t.num_rows == 0:
            return None
        cache = getattr(self.session, "_bucket_cap_cache", None)
        if cache is None:
            cache = self.session._bucket_cap_cache = {}
        key = (node.table_name, getattr(t, "_version", 0),
               tuple(phys), self.nseg)
        hit = cache.get(key)
        if hit is not None:
            return hit
        cols = [np.asarray(t.data[p]) for p in phys]
        dst = hashing.jump_consistent_hash_np(
            hashing.hash_columns_np(cols), self.nseg)
        src = t.shard_assignment(self.nseg)
        if src is None:
            return None
        counts = np.bincount(src.astype(np.int64) * self.nseg + dst,
                             minlength=self.nseg * self.nseg)
        out = int(counts.max())
        if len(cache) >= 64:
            cache.pop(next(iter(cache)))
        cache[key] = out
        return out

    def _maybe_runtime_filter(self, node: N.PJoin, build_src: N.PlanNode,
                              probe: N.PlanNode, est_build_rows: float,
                              est_semi_rows: float | None,
                              est_probe_rows: float | None = None
                              ) -> tuple[N.PlanNode, float | None, bool]:
        """Wrap the probe in a pre-motion runtime filter when profitable;
        returns (probe', TOTAL surviving-row estimate for bucket sizing —
        computed pre-walk by the caller so shard-mutated scans can't skew
        it, allow-undercut-of-exact-bound flag). Small builds get the
        EXACT filter (all-gathered keys); bigger builds get the bloom +
        min/max DIGEST when its estimated wire savings beat the digest
        broadcast cost (config.join_filter)."""
        if node.kind not in ("inner", "semi") or est_semi_rows is None:
            return probe, None, False

        def wrap(mode: str, bits: int = 0) -> N.PlanNode:
            rf = N.PRuntimeFilter(probe, build_src,
                                  list(node.build_keys),
                                  list(node.probe_keys),
                                  pack_bits=node.pack_bits, mode=mode,
                                  bloom_bits=bits,
                                  bloom_k=self.cfg.join_filter.bloom_k)
            rf.fields = list(probe.fields)
            rf.sharding = probe.sharding
            return rf

        thresh = self.cfg.planner.runtime_filter_threshold
        if thresh > 0 and est_build_rows <= thresh:
            rf = wrap("exact")
            rf._est_in = est_probe_rows
            rf._est_out = max(est_semi_rows, 1.0)
            return rf, max(est_semi_rows, 1.0), False
        if est_probe_rows is None:
            return probe, None, False
        ok, est, bits = digest_decision(est_build_rows, est_probe_rows,
                                        est_semi_rows, probe.fields,
                                        len(node.build_keys), self.cfg,
                                        self.nseg)
        if not ok:
            return probe, None, False
        rf = wrap("digest", bits)
        rf._est_in = est_probe_rows
        rf._est_out = max(est, 1.0)
        return rf, max(est, 1.0), True

    # ----------------------------------------------------------------- join

    def _join(self, node: N.PJoin) -> tuple[N.PlanNode, int]:
        from cloudberry_tpu_torch.plan.cost import estimate_rows, semi_estimate

        # estimate BEFORE the walk mutates scan capacities to shard sizes
        # (both the build size and the runtime filter's survivor count)
        est_build_rows = estimate_rows(node.build, self.session.catalog)
        est_probe_rows = estimate_rows(node.probe, self.session.catalog)
        est_semi_rows = semi_estimate(node.build, node.probe,
                                      node.build_keys, node.probe_keys,
                                      self.session.catalog) \
            if node.kind in ("inner", "semi") else None
        build, bcap = self.walk(node.build)
        probe, pcap = self.walk(node.probe)
        bsh, psh = build.sharding, probe.sharding

        if node.kind == "full":
            # FULL join emits unmatched rows from BOTH sides exactly once:
            # broadcast/replicated inputs would duplicate them per segment,
            # so require key colocation or gather both sides
            if not (bsh.is_partitioned and psh.is_partitioned
                    and _join_colocated(node, bsh, psh)):
                if bsh.is_partitioned:
                    build, bcap = self.gather(build, bcap)
                if psh.is_partitioned:
                    probe, pcap = self.gather(probe, pcap)
                node.build = build
                node.probe = probe
                node.sharding = Sharding.singleton()
                return node, _join_out_cap(node, bcap, pcap, self.nseg)
            node.build = build
            node.probe = probe
            node.sharding = psh
            return node, _join_out_cap(node, bcap, pcap, self.nseg)

        b_part = bsh.is_partitioned
        p_part = psh.is_partitioned

        if b_part and p_part and not _join_colocated(node, bsh, psh):
            # statistics-estimated build size (cost.py) decides, but the
            # STATIC broadcast buffer is bcap·nseg rows regardless of actual
            # data — cap it structurally so a misestimate can never allocate
            # an unbounded replicated buffer
            thr = self.cfg.planner.broadcast_threshold
            bsub = _hashed_key_positions(bsh, node.build_keys)
            psub = _hashed_key_positions(psh, node.probe_keys)
            # the memo explorer (plan/memo.py) may have stamped the
            # globally cheapest strategy; honor it after re-checking its
            # preconditions (the plan may have drifted since), else fall
            # back to the greedy per-node rules
            choice = getattr(node, "_dist_choice", None)
            if choice == "broadcast" and not (
                    thr > 0
                    and bcap * self.nseg <= broadcast_struct_rows(thr)):
                choice = None
            if choice == "redist_probe" and bsub is None:
                choice = None
            if choice == "redist_build" and psub is None:
                choice = None
            if choice in (None, "colocate"):
                if est_build_rows <= thr \
                        and bcap * self.nseg <= max(thr, 1) * 16:
                    choice = "broadcast"
                elif bsub is not None:
                    choice = "redist_probe"
                elif psub is not None:
                    choice = "redist_build"
                else:
                    choice = "redist_both"
            if choice == "broadcast":
                build, bcap = self.broadcast(build, bcap)
            elif choice == "redist_probe":
                probe, est, under = self._maybe_runtime_filter(
                    node, build, probe, est_build_rows, est_semi_rows,
                    est_probe_rows)
                probe, pcap = self.redistribute(
                    probe, pcap, [node.probe_keys[i] for i in bsub],
                    est_rows=est, est_under_exact=under)
            elif choice == "redist_build":
                build, bcap = self.redistribute(
                    build, bcap, [node.build_keys[i] for i in psub])
            else:  # redist_both
                build_src = build
                build, bcap = self.redistribute(build, bcap,
                                                list(node.build_keys))
                probe, est, under = self._maybe_runtime_filter(
                    node, build_src, probe, est_build_rows,
                    est_semi_rows, est_probe_rows)
                probe, pcap = self.redistribute(probe, pcap,
                                                list(node.probe_keys),
                                                est_rows=est,
                                                est_under_exact=under)
        elif b_part and not p_part:
            if node.kind in ("inner", "semi"):
                # probe replicated/singleton, build partitioned: each segment
                # joins its build shard against the full probe; a probe row
                # is selected only on the segment owning its build partner,
                # so results are partitioned — by the BUILD side's actual
                # distribution, translated onto the equal-valued probe keys.
                node.build = build
                node.probe = probe
                bsub = _hashed_key_positions(bsh, node.build_keys)
                if bsub is not None:
                    names = [node.probe_keys[i].name for i in bsub
                             if isinstance(node.probe_keys[i], ex.ColumnRef)]
                    node.sharding = (Sharding.hashed(*names)
                                     if len(names) == len(bsub)
                                     else Sharding.strewn())
                else:
                    node.sharding = Sharding.strewn()
                return node, _join_out_cap(node, bcap, pcap, self.nseg)
            # left/anti joins select probe rows that match NOWHERE — every
            # segment must see the whole build side to decide that
            build, bcap = self.broadcast(build, bcap)

        node.build = build
        node.probe = probe
        node.sharding = probe.sharding if p_part else (
            Sharding.strewn() if build.sharding.is_partitioned
            else probe.sharding)
        return node, _join_out_cap(node, bcap, pcap, self.nseg)

    # ------------------------------------------------------------------ agg


    def _agg(self, node: N.PAgg) -> tuple[N.PlanNode, int]:
        child, cap = self.walk(node.child)
        node.child = child
        csh = child.sharding

        if not csh.is_partitioned:
            node.sharding = csh
            node.capacity = min(node.capacity, max(cap, 1))
            return node, node.capacity

        if node.group_keys:
            key_src = {e.name for _, e in node.group_keys
                       if isinstance(e, ex.ColumnRef)}
            if csh.kind == "hashed" and set(csh.keys) <= key_src and csh.keys:
                # colocated grouping: one stage, stays partitioned
                node.sharding = _rename_sharding(csh, node.group_keys)
                node.capacity = min(node.capacity, cap)
                return node, node.capacity
            return self._two_stage_group_agg(node, child, cap)
        return self._two_stage_global_agg(node, child, cap)

    def _two_stage_group_agg(self, node: N.PAgg, child: N.PlanNode,
                             cap: int) -> tuple[N.PlanNode, int]:
        partial_aggs, final_aggs, finalize = _split_aggs(node.aggs)
        partial = N.PAgg(child, node.group_keys, partial_aggs,
                         capacity=min(node.capacity, cap), mode="partial")
        partial.fields = [N.PlanField(n, e.dtype, _f_dict(child, e))
                          for n, e in node.group_keys] + \
                         [N.PlanField(n, c.dtype, None)
                          for n, c in partial_aggs]
        partial.sharding = child.sharding

        gst = self.cfg.planner.gather_single_threshold
        if 0 < node.capacity <= gst:
            # GATHER_SINGLE (plannodes.h:1638 analog): partials are small
            # — gather them to one segment for the final merge. Immune to
            # hash-space skew across destinations (a redistribute's
            # per-bucket variance can overflow when many distinct keys
            # land on one segment), and a cheaper collective besides.
            motion, mcap = self.gather(partial, partial.capacity)
            final_sharding = Sharding.singleton()
        else:
            key_refs = [_field_ref(partial, n) for n, _ in node.group_keys]
            motion, mcap = self.redistribute(partial, partial.capacity,
                                             key_refs)
            if motion.hier_hosts:
                spec = host_combine_spec(motion, partial, final_aggs)
                if spec is not None:
                    # host-local combine between the hops: DCN carries
                    # one partial per (host, group). The combined rows
                    # ship from one segment per host, which can see up
                    # to S segments' worth of distinct groups — grow
                    # the pair rung to that ceiling so the combine can
                    # never manufacture an overflow the uncombined
                    # motion would not have had.
                    S = self.nseg // motion.hier_hosts
                    motion.host_combine = True
                    motion.combine_spec = spec
                    motion.bucket_cap = rung_up(S * motion.bucket_cap)
                    motion.out_capacity = motion.bucket_cap * self.nseg
                    mcap = motion.out_capacity
            final_sharding = _rename_sharding(
                Sharding.hashed(*(k.name for k in key_refs
                                  if isinstance(k, ex.ColumnRef))),
                [(n, _field_ref(motion, n)) for n, _ in node.group_keys])

        final_keys = [(n, _field_ref(motion, n)) for n, _ in node.group_keys]
        final = N.PAgg(motion, final_keys, final_aggs,
                       capacity=min(node.capacity, mcap), mode="final")
        final.fields = [N.PlanField(n, e.dtype, _f_dict(motion, e))
                        for n, e in final_keys] + \
                       [N.PlanField(n, c.dtype, None) for n, c in final_aggs]
        final.sharding = final_sharding

        out = _finalize_project(final, node, finalize)
        out.sharding = final.sharding
        return out, final.capacity

    def _two_stage_global_agg(self, node: N.PAgg, child: N.PlanNode,
                              cap: int) -> tuple[N.PlanNode, int]:
        partial_aggs, final_aggs, finalize = _split_aggs(node.aggs)
        partial = N.PAgg(child, [], partial_aggs, capacity=1, mode="partial")
        partial.fields = [N.PlanField(n, c.dtype, None)
                          for n, c in partial_aggs]
        partial.sharding = child.sharding

        motion, mcap = self.gather(partial, 1)

        final = N.PAgg(motion, [], final_aggs, capacity=1, mode="final")
        final.fields = [N.PlanField(n, c.dtype, None) for n, c in final_aggs]
        final.sharding = Sharding.singleton()

        out = _finalize_project(final, node, finalize)
        out.sharding = final.sharding
        return out, 1


def digest_survivors(est_build: float, est_probe: float, est_semi: float,
                     bits: int, k: int) -> float:
    """Probe rows expected to SURVIVE a digest runtime filter: the true
    partners plus bloom false positives at the estimated load factor
    (fpr ≈ (1 - e^{-k·n/m})^k) — the costing currency shared by the
    distributor's eligibility rule and the memo's motion pricing."""
    import math as _m

    m = max(bits, 64)
    kk = max(k, 1)
    fpr = (1.0 - _m.exp(-kk * max(est_build, 1.0) / m)) ** kk
    return min(est_probe,
               est_semi + fpr * max(est_probe - est_semi, 0.0))


def digest_decision(est_build: float, est_probe: float, est_semi: float,
                    probe_fields, n_keys: int, cfg,
                    nseg: int) -> tuple[bool, float, int]:
    """(eligible, survivor estimate, bloom bits) — THE digest eligibility
    rule: fires only above the exact filter's threshold, and only when the
    estimated wire savings beat the digest broadcast cost. One copy shared
    by the distributor's filter insertion (_maybe_runtime_filter) and the
    memo's motion pricing (digest_filter_frac), so the two can't drift."""
    from cloudberry_tpu_torch.exec.kernels import bloom_bits_pow2

    jf = cfg.join_filter
    est_probe = max(est_probe, 1.0)
    if not jf.enabled:
        return False, est_probe, 0
    thresh = cfg.planner.runtime_filter_threshold
    if thresh > 0 and est_build <= thresh:
        return False, est_probe, 0  # exact-filter territory
    bits = bloom_bits_pow2(jf.bloom_bits)
    est = digest_survivors(est_build, est_probe, est_semi, bits,
                           jf.bloom_k)
    row_bytes = max(sum(f.type.np_dtype.itemsize
                        for f in probe_fields), 1)
    saved = (est_probe - est) * row_bytes * (nseg - 1) / max(nseg, 1)
    digest_bytes = (bits // 8 + 32 * n_keys) * nseg
    return saved > digest_bytes, est, bits


def digest_filter_frac(node: N.PJoin, catalog, cfg, nseg: int) -> float:
    """Fraction of probe rows expected on the wire after the pre-motion
    runtime filter a probe redistribute would get, 1.0 when none fires.
    DIGEST mode only — the exact filter (small builds) is deliberately
    unmodeled so existing plan choices stay put; the digest covers the
    big-build shuffles where semijoin reduction decides the motion."""
    from cloudberry_tpu_torch.plan.cost import estimate_rows, semi_estimate

    if not cfg.join_filter.enabled or node.kind not in ("inner", "semi"):
        return 1.0
    est_b = estimate_rows(node.build, catalog)
    est_p = max(estimate_rows(node.probe, catalog), 1.0)
    est_semi = semi_estimate(node.build, node.probe, node.build_keys,
                             node.probe_keys, catalog)
    ok, est, _ = digest_decision(est_b, est_p, est_semi,
                                 node.probe.fields,
                                 len(node.build_keys), cfg, nseg)
    if not ok:
        return 1.0
    # feedback (plan/feedback.py): a prior execution COUNTED this
    # filter's survivors — price the shuffle at the observed fraction
    # instead of the bloom model's. Learned, so stamp provenance for
    # EXPLAIN / the flight recorder.
    fb = getattr(catalog, "_feedback", None)
    if fb is not None:
        obs = fb.jf_frac(node)
        if obs is not None:
            node._jf_frac_src = "feedback"
            return max(obs, 1e-6)
    return max(est / est_p, 1e-6)


def _join_out_cap(node: N.PJoin, bcap: int, pcap: int,
                  nseg: int = 1) -> int:
    """Per-segment output capacity; expansion joins get resized to the
    post-motion per-segment inputs, floored by the NDV-based PAIR estimate
    the binder memoized (bcap+pcap is no bound for many-to-many fanout —
    a detected overflow grows the buffer and retries, executor.py:
    grow_expansion)."""
    est = getattr(node, "_est_pairs", None)
    floor = int(2 * est / max(nseg, 1)) + 8 if est is not None else 0
    if node.residual is not None:
        # semi/anti residual: pairs expand internally, output rides probe
        node.out_capacity = max(bcap + pcap, floor)
        return pcap
    if not node.unique_build:
        node.out_capacity = max(bcap + pcap, floor)
        return node.out_capacity
    return pcap


def _wire_row_bytes(m: N.PMotion) -> int:
    """Bytes one row costs on the motion's packed wire (fallback: raw
    itemsize sum) — the auto-gate's block-size currency."""
    import numpy as np

    from cloudberry_tpu_torch.exec import kernels as K

    dtypes = {f.name: f.type.np_dtype for f in m.fields}
    try:
        return K.wire_layout(dtypes).row_bytes()
    except NotImplementedError:
        return sum(np.dtype(d).itemsize for d in dtypes.values()) + 1


def host_combine_spec(m: N.PMotion, partial: N.PAgg,
                      final_aggs) -> Optional[tuple]:
    """Combine-eligibility for a two-stage agg's merge motion (the
    planner stamp the verifier's motion-host-combine rule checks).

    Eligible only when every merge is ORDER-INSENSITIVE-EXACT — integer
    sums (count partials are int64; DECIMAL rides int64 cents), min,
    max — so host-combined partials merge to bit-identical finals no
    matter how the combine regrouped them. A float sum partial (f64
    rounding depends on add order) or a masked (nullable) key keeps the
    motion combine-free. Returns (group key names, ((column, merge
    func), ...)) or None."""
    import numpy as np

    if m.kind != "redistribute" or not partial.group_keys:
        return None
    by_name = {f.name: f for f in m.fields}
    for f in m.fields:
        if f.masks:
            return None         # NULL semantics need the mask columns
    merges = []
    for name, call in final_aggs:
        f = by_name.get(name)
        if f is None or call.func not in ("sum", "min", "max"):
            return None
        if call.func == "sum" and not (
                np.issubdtype(f.type.np_dtype, np.integer)
                or f.type.np_dtype == np.bool_):
            return None         # float sums are add-order-sensitive
        merges.append((name, call.func))
    keys = tuple(n for n, _ in partial.group_keys)
    if not all(k in by_name for k in keys):
        return None
    return (keys, tuple(merges))


# ---------------------------------------------------------------- agg split


def _split_aggs(aggs):
    """(partial_aggs, final_merge_aggs, finalize_exprs) — how each aggregate
    decomposes across the motion boundary (the reference's combine
    functions / multi-stage Aggref splitting)."""
    partial: list[tuple[str, ex.AggCall]] = []
    final: list[tuple[str, ex.AggCall]] = []
    finalize: dict[str, tuple[str, str]] = {}  # out name -> ('avg', s, c)
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


def _finalize_project(final: N.PAgg, node: N.PAgg, finalize) -> N.PlanNode:
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


# ------------------------------------------------------------------ helpers


# one walk of a node's expressions, shared with the rest of the port
_node_exprs = N.node_exprs


def _field_ref(plan: N.PlanNode, name: str) -> ex.ColumnRef:
    f = plan.field(name)
    c = ex.ColumnRef(f.name, f.type)
    if f.sdict is not None:
        object.__setattr__(c, "_sdict", f.sdict)
    return c


def _f_dict(plan: N.PlanNode, e: ex.Expr):
    if isinstance(e, ex.ColumnRef):
        try:
            return plan.field(e.name).sdict
        except KeyError:
            return None
    return None


def _project_sharding(child_sh: Sharding, exprs) -> Sharding:
    if child_sh.kind != "hashed":
        return child_sh
    renames = {}
    for out_name, e in exprs:
        if isinstance(e, ex.ColumnRef) and e.name not in renames:
            renames[e.name] = out_name
    if all(k in renames for k in child_sh.keys):
        return Sharding.hashed(*(renames[k] for k in child_sh.keys))
    return Sharding.strewn()


def _rename_sharding(csh: Sharding, group_keys) -> Sharding:
    """Child sharding keys (source col names) → agg output key names."""
    if csh.kind != "hashed":
        return csh
    src_to_out = {}
    for out_name, e in group_keys:
        if isinstance(e, ex.ColumnRef) and e.name not in src_to_out:
            src_to_out[e.name] = out_name
    if all(k in src_to_out for k in csh.keys):
        return Sharding.hashed(*(src_to_out[k] for k in csh.keys))
    return Sharding.strewn()


def _hashed_key_positions(sh: Sharding, keys: list[ex.Expr]
                          ) -> Optional[list[int]]:
    """If ``sh`` is hashed exactly on an ordered subset of ``keys`` (by
    column name), return those key positions; else None."""
    if sh.kind != "hashed" or not sh.keys:
        return None
    names = [k.name if isinstance(k, ex.ColumnRef) else None for k in keys]
    pos = []
    for k in sh.keys:
        if k not in names:
            return None
        pos.append(names.index(k))
    return pos


def _join_colocated(node: N.PJoin, bsh: Sharding, psh: Sharding) -> bool:
    """Both sides hash-partitioned on CORRESPONDING join key positions, in
    the same order — equal key tuples then land on the same segment."""
    bpos = _hashed_key_positions(bsh, node.build_keys)
    if bpos is None:
        return False
    ppos = _hashed_key_positions(psh, node.probe_keys)
    if ppos is None:
        return False
    return bpos == ppos
