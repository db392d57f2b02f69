"""Distributed executor: the plan as a gang of segment lowerers on one card.

The reference executes a distributed plan as N OS processes per slice wired
by a socket interconnect (gangs + cdbmotion + ic_udpifc); the JAX package
runs it as ONE ``shard_map`` program over a mesh with one device per
segment, motions lowering to collectives on the ``seg`` axis. One H100 has
one device, so here every segment lives on the same card:

- a partitioned table is a ``(nseg, capacity)`` tensor
  (``Session.device_shards``, filled from the reference's host layout
  ``Session.sharded_table``); segment ``s`` scans its row views ``t[s]``.
  A replicated table stays whole, its ``$nrows`` a length-1 count;
- a GANG holds one ``DistLowerer`` per segment. ``run`` lowers the root on
  segment 0, then 1, and so on, in one thread and a fixed order;
- the first segment that reaches a motion lowers the motion's child on
  EVERY segment (each lowerer's memoized ``lower_shared``), packs each
  segment's wire buffer, exchanges them on the card
  (parallel/transport.py) and caches every segment's received block.
  Later segments read their block from that cache. Every other collective
  is keyed by its plan node the same way: the runtime filter's global
  ranges / digest, the null-aware anti join's ``global_any_of``, and the
  checks and stats (reduced once after the run);
- each segment's operators reach the CUDA kernels through the executor's
  shape gates, one launch per segment.

The received buffers equal the reference's row for row (all_to_all:
destination d receives the blocks of sources 0..nseg-1 in source order,
``bucket_cap`` slots each; all_gather: segment order; unfilled slots
all-zero), so sums after a motion add in the reference's order.

Routing uses jump_consistent_hash over the same column hash as load-time
placement (session.sharded_table), so scan-colocated joins need no motion —
the planner relies on that (plan/distribute.py).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from cloudberry_tpu_torch.exec import executor as X
from cloudberry_tpu_torch.exec import kernels as K
from cloudberry_tpu_torch.exec.expr_compile import compile_expr
from cloudberry_tpu_torch.plan import nodes as N
from cloudberry_tpu_torch.utils import hashing


def prepare_dist_inputs(plan: N.PlanNode, session, names=None) -> list:
    """One input dict per segment for every scanned table: a partitioned
    table as its shard's row views (``{"$cols": ..., "$nrows": 0-d}``), a
    replicated table whole with its one count; plus the cached join
    indexes ('shard'-mode split by segment, the others shared).
    ``names`` overrides the table set."""
    nseg = session.config.n_segments
    per = [dict() for _ in range(nseg)]
    if plan is not None:
        from cloudberry_tpu_torch.exec.joinindex import \
            dist_join_index_inputs

        for s, jix in enumerate(dist_join_index_inputs(plan, session)):
            per[s].update(jix)
    if names is None:
        names = sorted({s.table_name for s in X.scans_of(plan)})
    for name in names:
        ds = session.device_shards(name)
        if ds.replicated:
            ent = {"$cols": ds.columns, "$nrows": ds.counts[0]}
            for s in range(nseg):
                per[s][name] = ent
        else:
            for s in range(nseg):
                per[s][name] = {
                    "$cols": {c: v[s] for c, v in ds.columns.items()},
                    "$nrows": ds.counts[s]}
    return per


def _gang_factory(session, instrument=False):
    """``make(inputs)`` → a Gang over the session's segments, transport
    and lowerer (the setup that every distributed runner shares)."""
    from cloudberry_tpu_torch.parallel.health import slot_count
    from cloudberry_tpu_torch.parallel.transport import make_transport

    nseg = session.config.n_segments
    ic = session.config.interconnect
    # a degraded session's survivor restriction is checked against its
    # slot pool, as the reference's mesh checks it against its devices
    tx = make_transport(ic.backend, nseg,
                        getattr(session, "_live_device_ids", None),
                        slot_count(session))
    packed = ic.packed_wire
    device = session.device
    lowerer_cls = _InstrumentedDistLowerer if instrument else DistLowerer

    def make(inputs):
        return Gang(inputs, nseg, device, tx, packed, lowerer_cls)

    return make


def compile_distributed(plan: N.PlanNode, session, instrument=False):
    """The gang's runner for ``plan`` (the Executable of a distributed
    statement): ``fn(inputs)`` → (result cols, sel, checks, stats) with
    the reference's check and stat keys. Reusable across calls — inputs
    are re-prepared per call from the session's shard cache. A generic
    plan's ``$params`` ride every segment's inputs (replicated 0-d
    tensors). ``instrument=True`` (EXPLAIN ANALYZE's pipeline path)
    records per-node row counts into the stats (``node_rows_sum`` over
    the segments, ``node_rows_one`` segment 0's) through this same entry
    point."""
    make = _gang_factory(session, instrument)

    def run(inputs):
        return make(inputs).run(plan)

    return run


def compile_segments(plan: N.PlanNode, session):
    """The gang's runner for a plan whose top gather was cut (the
    parallel retrieve cursor's endpoints, exec/endpoint.py):
    ``fn(inputs)`` → (every segment's (cols, sel), checks, stats)."""
    make = _gang_factory(session)

    def run(inputs):
        outs, checks, stats = make(inputs).run_each(
            lambda low: low.lower(plan))
        return ([({f.name: c[f.name] for f in plan.fields}, sel)
                 for c, sel in outs], checks, stats)

    return run


class Gang:
    """The segments of one distributed run: one lowerer per segment, the
    node-keyed cache of exchanged blocks and global values, and the
    per-segment parts of the stats."""

    def __init__(self, inputs: list, nseg: int, device, tx, packed: bool,
                 lowerer_cls):
        self.nseg = nseg
        self.device = torch.device(device)
        self.tx = tx
        self.packed = packed
        self.lowerers = [lowerer_cls(inputs[s], self.device, self, s,
                                     params=inputs[s].get("$params"))
                         for s in range(nseg)]
        self._cache: dict = {}
        self.stats: dict = {}
        # psum'd per-segment stat parts: key -> {segment: value}
        self._parts: dict = {}

    def run(self, plan: N.PlanNode):
        """Lower ``plan`` on every segment: (segment 0's result columns,
        its selection, the reduced checks, the stats)."""
        outs, checks, stats = self.run_each(lambda low: low.lower(plan))
        cols, sel = outs[0]
        return ({f.name: cols[f.name] for f in plan.fields}, sel, checks,
                stats)

    def run_each(self, fn):
        """``fn(lowerer)`` on every segment, in segment order: (the
        per-segment results, the checks reduced to one flag each — any
        segment tripped — and the stats). The tiled executors' preludes,
        steps and finalizes run through here."""
        try:
            outs = [fn(low) for low in self.lowerers]
            keys: dict = {}
            for low in self.lowerers:
                for k in low.checks:
                    keys.setdefault(k, None)
            checks = {k: torch.stack([
                torch.as_tensor(low.checks[k]).reshape(-1).any()
                for low in self.lowerers if k in low.checks]).any()
                for k in keys}
            for low in self.lowerers:
                if hasattr(low, "node_counts"):
                    low.flush_counts()
            for k, parts in self._parts.items():
                self.stats[k] = self.tx.psum(
                    [parts[s] for s in sorted(parts)])
            return outs, checks, dict(self.stats)
        finally:
            # the lowerers and the gang refer to each other: break the
            # cycle so a run's device tensors are freed when it returns,
            # not when the garbage collector next runs
            for low in self.lowerers:
                low.gang = None
            self.lowerers = []
            self._cache.clear()

    def add_stat(self, key: str, seg: int, value) -> None:
        """A segment's part of a psum'd stat."""
        self._parts.setdefault(key, {})[seg] = value

    def _once(self, key, build):
        hit = self._cache.get(key)
        if hit is None:
            hit = self._cache[key] = build()
        return hit

    # ------------------------------------------------- node-keyed values

    def global_any(self, node, fn) -> torch.Tensor:
        """psum of every segment's local any() > 0, once per node."""
        return self._once(("any", id(node)), lambda: self.tx.psum(
            [fn(low).to(torch.int32) for low in self.lowerers]) > 0)

    def rf_exact(self, node: N.PRuntimeFilter):
        """The exact runtime filter's global packing ranges and the sorted
        gathered build keys (packed, narrowed to 32 bits when proven)."""
        def build():
            parts = []
            for low in self.lowerers:
                bcols, bsel = low.lower_shared(node.build)
                parts.append(([low.expr(k, bcols) for k in node.build_keys],
                              bsel))
            ranges = []
            for i in range(len(node.build_keys)):
                los, his = [], []
                for bkeys, bsel in parts:
                    u = K.sort_key_u64(bkeys[i])
                    los.append(torch.where(bsel, u, K._full(u, K._I64_MAX))
                               .min())
                    his.append(torch.where(bsel, u, K._full(u, K._I64_MIN))
                               .max())
                lo = self.tx.all_gather([x[None] for x in los]).min()
                hi = self.tx.all_gather([x[None] for x in his]).max()
                # hi - lo + 1 over raw u64 bits (biased difference = raw
                # difference, wrapping like the reference's uint64)
                ranges.append((lo, hi - lo + 1))
            big = K._U64_MAX_B
            kbs = []
            for bkeys, bsel in parts:
                kb = torch.where(bsel, K.pack_with_ranges(bkeys, ranges),
                                 K._full(bsel, K._U64_MAX_B, torch.int64))
                if node.pack_bits == 32:
                    kb = K.downcast32(kb)
                kbs.append(kb)
            if node.pack_bits == 32:
                big = K._U32_MAX_B
            kb_sorted = torch.sort(self.tx.all_gather(kbs)).values
            return ranges, kb_sorted, big
        return self._once(("rf", id(node)), build)

    def rf_digest(self, node: N.PRuntimeFilter):
        """The digest filter's GLOBAL digest: per key the u64 [lo, hi]
        over every segment's selected build rows (biased int64), and the
        OR of the segments' bloom bitmaps. Min/max and OR are exact, so
        this equals the reference's fold of the gathered digests."""
        bits = K.bloom_bits_pow2(node.bloom_bits)
        kk = max(node.bloom_k, 1)

        def build():
            los, his, blooms = [], [], []
            for low in self.lowerers:
                bcols, bsel = low.lower_shared(node.build)
                bus = [K.sort_key_u64(low.expr(k, bcols))
                       for k in node.build_keys]
                los.append(torch.stack([
                    torch.where(bsel, u, K._full(u, K._I64_MAX)).min()
                    for u in bus]))
                his.append(torch.stack([
                    torch.where(bsel, u, K._full(u, K._I64_MIN)).max()
                    for u in bus]))
                blooms.append(K.bloom_build([u ^ K._I64_MIN for u in bus],
                                            bsel, bits, kk))
            bloom = blooms[0]
            for b in blooms[1:]:
                bloom = bloom | b
            return (torch.stack(los).amin(0), torch.stack(his).amax(0),
                    bloom)
        glo, ghi, bloom = self._once(("rfd", id(node)), build)
        return glo, ghi, bloom, bits, kk

    # ------------------------------------------------------------ motions

    def motion(self, node: N.PMotion, seg: int):
        """Segment ``seg``'s received (cols, sel) of ``node``; the first
        call runs the exchange for every segment."""
        return self._once(("motion", id(node)),
                          lambda: self._exchange(node))[seg]

    def _exchange(self, node: N.PMotion) -> list:
        """Lower the motion's child on every segment, then ship."""
        parts = []
        for low in self.lowerers:
            cols, sel = low.lower_shared(node.child)
            if node.pre_compact:
                cols, sel, n = K.compact(cols, sel, node.pre_compact)
                low.checks[
                    f"pre-gather compaction truncated rows (node "
                    f"{id(node)}): local top-N emitted more than its "
                    "limit"] = n > node.pre_compact
            parts.append((cols, sel))
        return self.ship(node, parts)

    def ship(self, node: N.PMotion, parts: list) -> list:
        """Every segment's received (cols, sel) from every segment's sent
        (cols, sel): pack, route, exchange on the card, unpack."""
        cols0 = parts[0][0]
        if node.kind in ("gather", "broadcast"):
            if self.packed and cols0:
                # one buffer for the whole row set: every column plus the
                # validity mask rides ONE (cap, W) word buffer
                layout = K.wire_layout({n: c.dtype for n, c in cols0.items()})
                recv = self.tx.all_gather(
                    [K.pack_wire(c, s, layout) for c, s in parts])
                res = K.unpack_wire(recv, layout)
            else:
                res = ({n: self.tx.all_gather([c[n] for c, _ in parts])
                        for n in cols0},
                       self.tx.all_gather([s for _, s in parts]))
            return [res] * self.nseg
        if node.kind == "redistribute":
            return self._redistribute(node, parts)
        raise X.ExecError(f"motion kind {node.kind}")

    def _redistribute(self, node: N.PMotion, parts: list) -> list:
        nseg, B = self.nseg, node.bucket_cap
        # every segment's routing in one hash call (the same per-row
        # values as one call per segment)
        hs = []
        for cols, sel in parts:
            keys = [X._as_column(compile_expr(k, self.device)(cols),
                                 sel.shape[0]) for k in node.hash_keys]
            hs.append(hashing.hash_columns(keys))
        dests = hashing.jump_consistent_hash(
            torch.cat(hs), nseg).split([h.shape[0] for h in hs])
        slots, demand = [], []
        for low, (cols, sel), dest in zip(self.lowerers, parts, dests):
            order, slot, valid, counts = K.bucket_slots(dest, sel, nseg, B)
            low.checks[
                f"redistribute overflow: a destination bucket exceeded "
                f"capacity {B} (node {id(node)}); raise "
                f"config.interconnect.capacity_factor"] = (counts > B).any()
            slots.append((order, slot, valid))
            demand.append(counts)
        # observed global bucket demand: an overflow promotes DIRECTLY to
        # the capacity rung that fits (one retry, not a probe up the
        # ladder); the per-destination global demand is skew telemetry
        self.stats[f"required bucket (node {id(node)})"] = self.tx.pmax(
            [c.max() for c in demand])
        self.stats[f"seg rows (node {id(node)})"] = self.tx.psum(demand)
        cols0 = parts[0][0]
        n_slots = nseg * B
        if self.packed and cols0:
            # pack once, scatter rows into their destination buckets, ship
            # ONE (nseg, B, W) buffer; unfilled slots stay all-zero, which
            # unpacks as invalid
            layout = K.wire_layout({n: c.dtype for n, c in cols0.items()})
            send = []
            for (cols, sel), (order, slot, _) in zip(parts, slots):
                pbuf = K.pack_wire(cols, sel, layout)
                send.append(K.scatter_slots(pbuf[order], slot, n_slots)
                            .reshape(nseg, B, layout.width))
            return [K.unpack_wire(r.reshape(n_slots, layout.width), layout)
                    for r in self.tx.all_to_all(send)]
        recv_cols = [dict() for _ in range(nseg)]
        for name in cols0:
            recv = self.tx.all_to_all([
                K.scatter_slots(cols[name][order], slot, n_slots)
                .reshape(nseg, B)
                for (cols, _), (order, slot, _) in zip(parts, slots)])
            for d in range(nseg):
                recv_cols[d][name] = recv[d].reshape(n_slots)
        recv_sel = self.tx.all_to_all([
            K.scatter_slots(valid, slot, n_slots).reshape(nseg, B)
            for order, slot, valid in slots])
        return [(recv_cols[d], recv_sel[d].reshape(n_slots))
                for d in range(nseg)]


class DistLowerer(X.Lowerer):
    """One segment's lowering: the executor's operators over the
    segment's inputs, with the scan, motion, runtime-filter and
    ``global_any_of`` hooks answered through the gang."""

    def __init__(self, tables, device, gang: Gang, seg: int, params=None):
        super().__init__(tables, device, params=params)
        self.gang = gang
        self.seg = seg

    def scan(self, node: N.PScan):
        if node.table_name == "$dual":
            return {}, torch.ones((1,), dtype=torch.bool, device=self.device)
        t = self.tables[node.table_name]
        cols = {}
        for phys, out in list(node.column_map.items()) + [
                (f"$nn:{p}", o) for p, o in node.mask_map.items()]:
            arr = t["$cols"][phys]
            if arr.shape[0] < node.capacity:
                # the reference's zero fill: a column shorter than the
                # scan's capacity is replaced by zeros (only an empty
                # replicated table — 0 rows under a capacity of 1 — is
                # shorter; every shard is padded to the shard capacity)
                arr = torch.zeros((node.capacity,), dtype=arr.dtype,
                                  device=self.device)
            cols[out] = arr
        sel = torch.arange(node.capacity, device=self.device) < t["$nrows"]
        return cols, sel

    def motion(self, node: N.PMotion):
        return self.gang.motion(node, self.seg)

    def global_any_of(self, node, fn) -> torch.Tensor:
        return self.gang.global_any(node, fn)

    def runtime_filter(self, node: N.PRuntimeFilter):
        """Semi-join pushdown (nodeRuntimeFilter.c analog) before the
        probe's redistribute. mode='exact': the gathered PACKED build keys
        (packing ranges reduced globally, so every segment packs
        identically) and a sorted membership test of the probe rows.
        mode='digest': a global per-key min/max + bloom digest; bloom
        false positives let extra rows through, the join stays exact."""
        if getattr(node, "mode", "exact") == "digest":
            return self._digest_filter(node)
        pcols, psel = self.lower(node.child)
        ranges, kb_sorted, big = self.gang.rf_exact(node)
        pkeys = [self.expr(k, pcols) for k in node.probe_keys]
        kp = K.pack_with_ranges(pkeys, ranges)
        if node.pack_bits == 32:
            kp = K.downcast32(kp)
        pos = torch.searchsorted(kb_sorted, kp).clamp(
            0, kb_sorted.shape[0] - 1)
        hit = (kb_sorted[pos] == kp) & (kp != big)
        self._filter_stats(node, psel, psel & hit)
        return pcols, psel & hit

    def _digest_filter(self, node: N.PRuntimeFilter):
        pcols, psel = self.lower(node.child)
        glo, ghi, bloom, bits, kk = self.gang.rf_digest(node)
        pus = [K.sort_key_u64(self.expr(k, pcols)) for k in node.probe_keys]
        hit = psel
        for i, u in enumerate(pus):
            hit = hit & (u >= glo[i]) & (u <= ghi[i])
        hit = hit & K.bloom_test(bloom, [u ^ K._I64_MIN for u in pus],
                                 bits, kk)
        self._filter_stats(node, psel, psel & hit)
        return pcols, psel & hit

    def _filter_stats(self, node, pre, post):
        """Global probe rows before/after the filter (psum over segments)
        — pinned on the plan node by record_motion_stats."""
        self.gang.add_stat(f"join_filter pre (node {id(node)})", self.seg,
                           pre.sum(dtype=torch.int32))
        self.gang.add_stat(f"join_filter post (node {id(node)})", self.seg,
                           post.sum(dtype=torch.int32))


class _InstrumentedDistLowerer(DistLowerer):
    """EXPLAIN ANALYZE's per-node row counts over the SAME distributed
    lowering: each node's selected-row count rides the stats — the sum
    over segments for partitioned nodes and segment 0's count for
    replicated ones (post-gather nodes must count once, not nseg
    times)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.node_counts: dict[int, torch.Tensor] = {}

    def lower(self, node):
        cols, sel = super().lower(node)
        self.node_counts[id(node)] = sel.sum(dtype=torch.int64)
        return cols, sel

    def flush_counts(self) -> None:
        for nid, cnt in self.node_counts.items():
            self.gang.add_stat(f"node_rows_sum (node {nid})", self.seg, cnt)
            self.gang.add_stat(f"node_rows_one (node {nid})", self.seg,
                               cnt if self.seg == 0 else torch.zeros_like(cnt))


def stats_to_host(stats: dict) -> dict:
    """Every stat in ONE device→host copy (scalars and the per-destination
    demand vectors), as numpy values."""
    if not stats:
        return {}
    flat = [torch.as_tensor(v).reshape(-1).to(torch.int64)
            for v in stats.values()]
    host = torch.cat(flat).cpu().numpy()
    out, i = {}, 0
    for (k, v), f in zip(stats.items(), flat):
        n = f.shape[0]
        out[k] = host[i] if torch.as_tensor(v).ndim == 0 else host[i:i + n]
        i += n
    return out


def record_motion_stats(plan: N.PlanNode, stats: dict,
                        session=None) -> None:
    """Pin each redistribute's observed global bucket demand onto its
    motion node (``_observed_bucket``): on overflow the retry promotes
    straight to the rung that fits. Runtime-filter row counts pin the
    same way (``_jf_pre``/``_jf_post``), and the per-destination demand
    vector pins as ``_seg_rows`` with its derived max/mean
    ``_skew_ratio``. With a ``session``, skew also feeds the registry
    (histograms + ``skew_events`` past ``config.obs.skew_ratio``).
    ``stats`` are host values (``stats_to_host``)."""
    motions = {id(n): n for n in X.all_nodes(plan)
               if isinstance(n, N.PMotion) and n.kind == "redistribute"}
    filters = {id(n): n for n in X.all_nodes(plan)
               if isinstance(n, N.PRuntimeFilter)}
    for key, v in stats.items():
        m = re.search(r"required bucket \(node (\d+)\)", key)
        if m is not None:
            node = motions.get(int(m.group(1)))
            if node is not None:
                node._observed_bucket = int(np.asarray(v))
            continue
        m = re.search(r"seg rows \(node (\d+)\)", key)
        if m is not None:
            node = motions.get(int(m.group(1)))
            if node is not None:
                node._seg_rows = np.asarray(v).astype(np.int64)
            continue
        m = re.search(r"join_filter (pre|post) \(node (\d+)\)", key)
        if m is not None:
            node = filters.get(int(m.group(2)))
            if node is not None:
                which = "_jf_pre" if m.group(1) == "pre" else "_jf_post"
                setattr(node, which, int(np.asarray(v)))
    _record_skew(motions.values(), session)


def _record_skew(motions, session) -> None:
    """Per-motion skew observability: from each redistribute's
    per-destination demand vector derive the max/mean skew ratio, record
    rows-per-segment and wire-bytes-per-segment histograms, and bump
    ``skew_events`` when a shuffle crosses ``config.obs.skew_ratio``. One
    card is one host, so the reference's per-host skew is never set
    (``_host_skew_ratio`` None)."""
    from cloudberry_tpu_torch.obs.capacity import _wire_row_bytes

    log = getattr(session, "stmt_log", None) if session is not None \
        else None
    threshold = float(session.config.obs.skew_ratio) \
        if session is not None else 0.0
    for node in motions:
        rows = getattr(node, "_seg_rows", None)
        if rows is None:
            continue
        total = int(rows.sum())
        if total <= 0 or rows.shape[0] == 0:
            node._skew_ratio = None
            continue
        ratio = float(rows.max() / (total / rows.shape[0]))
        node._skew_ratio = ratio
        node._host_skew_ratio = None
        if log is None or not log.obs_enabled:
            continue
        reg = log.registry
        reg.observe("motion_skew_ratio", ratio)
        reg.observe("motion_seg_rows_max", int(rows.max()))
        reg.observe("motion_seg_wire_bytes_max",
                    int(rows.max()) * _wire_row_bytes(node))
        if threshold > 0 and ratio >= threshold:
            log.bump("skew_events")


def record_jf_counters(stats: dict, log) -> None:
    """Accumulate runtime-filter row counts on the engine counters
    (jf_rows_in / jf_rows_out). Call AFTER raise_checks: an overflowed
    attempt that grow_expansion retries must not count its probe rows
    twice."""
    if log is None:
        return
    for key, v in stats.items():
        m = re.search(r"join_filter (pre|post)", key)
        if m is not None:
            log.bump("jf_rows_in" if m.group(1) == "pre"
                     else "jf_rows_out", int(np.asarray(v)))


def finish_run(plan: N.PlanNode, session, out, grows=None):
    """Everything after one gang run ``out`` = (cols, sel, checks,
    stats): the stats in one host copy, the motion stats pinned on
    ``plan``, the checks raised, the runtime-filter counters and the
    feedback fold. ``grows`` is the plan the growth loop grows on an
    overflow when that is not ``plan`` (a generic plan's rebind): each
    redistribute's observed demand is copied onto it before the checks
    raise. Returns (segment 0's gathered batch, the host stats)."""
    from cloudberry_tpu_torch.plan.feedback import fold_plan

    cols, sel, checks, stats = out
    stats = stats_to_host(stats)
    record_motion_stats(plan, stats, session=session)
    if grows is not None:
        for a, b in zip(_redistributes(plan), _redistributes(grows)):
            ob = getattr(a, "_observed_bucket", None)
            if ob is not None:
                b._observed_bucket = ob
    X.raise_checks(checks)
    record_jf_counters(stats, getattr(session, "stmt_log", None))
    fold_plan(session, plan)
    return X.make_batch(plan, cols, sel), stats


def _redistributes(plan: N.PlanNode) -> list:
    """Redistribute motions in walk order, deduped by identity (shared
    subtrees re-walk) — the correspondence channel for copying observed
    bucket stats from the built plan onto a signature-equal rebind."""
    seen: set[int] = set()
    out = []
    for n in X.all_nodes(plan):
        if isinstance(n, N.PMotion) and n.kind == "redistribute" \
                and id(n) not in seen:
            seen.add(id(n))
            out.append(n)
    return out


def execute_distributed(plan: N.PlanNode, session, fn=None):
    """Run ``plan`` on the gang (``fn`` from ``compile_distributed``, or
    built here) and ``finish_run`` it: segment 0's (gathered) result."""
    from cloudberry_tpu_torch.obs import trace as OT
    from cloudberry_tpu_torch.utils.faultinject import fault_point

    if fn is None:
        fn = compile_distributed(plan, session)
    inputs = prepare_dist_inputs(plan, session)
    fault_point("dist_execute_start")
    # the result copy is where the host waits for the device, so checks
    # and the copy fall inside the launch span (as on one segment)
    with OT.span("launch", mode="dist"), \
            OT.device_annotation("launch-dist"):
        return finish_run(plan, session, fn(inputs))[0]


def instrument_counts(plan: N.PlanNode, stats: dict) -> dict:
    """Host-side per-node counts from an instrumented run's stats: the
    cross-segment sum for partitioned nodes, segment 0's count for
    replicated ones."""
    sums, ones = {}, {}
    for key, v in stats.items():
        m = re.search(r"node_rows_(sum|one) \(node (\d+)\)", key)
        if m is None:
            continue
        (sums if m.group(1) == "sum" else ones)[int(m.group(2))] = \
            int(np.asarray(v))
    out = {}
    for n in X.all_nodes(plan):
        nid = id(n)
        if nid not in sums:
            continue
        if n.sharding is not None and n.sharding.is_partitioned:
            out[nid] = sums[nid]
        else:
            out[nid] = ones.get(nid, sums[nid])
    return out
