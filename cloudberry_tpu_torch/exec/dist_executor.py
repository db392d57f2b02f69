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

In a cluster of processes (parallel/mesh.py ``init_distributed``) a
process's gang holds lowerers for its own segments only
(``mesh.session_segments``: a contiguous range whose size may differ
between processes), fed from the local rows of each sharded
table, and every collective crosses the process boundary
(parallel/transport.py ``ProcessCollectives``). Every process issues the
same collectives in the same order: the exchanges follow the plan walk,
and everything the host reads after a run (the checks, the psum'd stat
parts, the motion stats) is reduced over the processes first, so every
process grows, retries or raises alike.

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
from cloudberry_tpu_torch.parallel.transport import cluster_sizes_agree
from cloudberry_tpu_torch.plan import nodes as N
from cloudberry_tpu_torch.utils import hashing


def prepare_dist_inputs(plan: N.PlanNode, session, names=None) -> list:
    """One input dict per segment for every scanned table: a partitioned
    table as its shard's row views (``{"$cols": ..., "$nrows": 0-d}``), a
    replicated table whole with its one count; plus the cached join
    indexes ('shard'-mode split by segment, the others shared).
    ``names`` overrides the table set."""
    from cloudberry_tpu_torch.parallel.mesh import session_segments

    segs = session_segments(session)
    per = [dict() for _ in segs]
    if plan is not None:
        from cloudberry_tpu_torch.exec.joinindex import \
            dist_join_index_inputs

        for i, jix in enumerate(dist_join_index_inputs(plan, session)):
            per[i].update(jix)
    if names is None:
        names = sorted({s.table_name for s in X.scans_of(plan)})
    for name in names:
        ds = session.device_shards(name)
        if ds.replicated:
            ent = {"$cols": ds.columns, "$nrows": ds.counts[0]}
            for i in range(len(segs)):
                per[i][name] = ent
        else:
            for i, s in enumerate(segs):
                per[i][name] = {"$cols": ds.shard(s), "$nrows": ds.counts[s]}
    return per


def session_transport(session):
    """The transport of a distributed run of ``session``: the two-level
    exchange when the topology gate selects it (parallel/transport.py
    ``hier_topology``, re-derived from the live layout at every build,
    so a topology flip re-splits the motions), else the flat
    ``interconnect.backend`` with its ``ring_chunks``. A degraded
    session's survivor restriction is checked against its slot pool, as
    the reference's mesh checks it against its devices."""
    from cloudberry_tpu_torch.parallel.health import slot_count
    from cloudberry_tpu_torch.parallel.transport import (hier_topology,
                                                         make_transport)

    nseg = session.config.n_segments
    ic = session.config.interconnect
    live_ids = getattr(session, "_live_device_ids", None)
    n_slots = slot_count(session)
    topo = hier_topology(session.config, nseg, live_ids, n_slots)
    return make_transport(ic.backend, nseg, chunks=ic.ring_chunks,
                          topo=topo, device_ids=live_ids, n_slots=n_slots)


def _gang_factory(session, instrument=False):
    """``make(inputs)`` → a Gang over the session's segments, transport
    and lowerer (the setup that every distributed runner shares; the
    instrumented gang of EXPLAIN ANALYZE runs the same transport)."""
    nseg = session.config.n_segments
    tx = session_transport(session)
    packed = session.config.interconnect.packed_wire
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
    ``fn(inputs)`` → (every segment's (cols, sel), checks, stats). Not
    ported across processes: an endpoint of another process's segment
    cannot be read here."""
    from cloudberry_tpu_torch.parallel.mesh import require_one_process

    require_one_process("a parallel retrieve cursor's endpoints")
    make = _gang_factory(session)

    def run(inputs):
        outs, checks, stats = make(inputs).run_each(
            lambda low: low.lower(plan))
        return ([({f.name: c[f.name] for f in plan.fields}, sel)
                 for c, sel in outs], checks, stats)

    return run


class Gang:
    """The segments of one distributed run: one lowerer per segment of
    this process (``inputs`` holds theirs, in segment order), the
    node-keyed cache of exchanged blocks and global values, and the
    per-segment parts of the stats."""

    def __init__(self, inputs: list, nseg: int, device, tx, packed: bool,
                 lowerer_cls):
        from cloudberry_tpu_torch.parallel.mesh import process_count

        self.nseg = nseg
        # this process's segments: the transport's layout (every segment
        # in one process)
        segs = getattr(tx, "local", range(nseg))
        self.lo, self.nl = segs.start, len(segs)
        self.procs = process_count()
        self.device = torch.device(device)
        self.tx = tx
        self.packed = packed
        self.lowerers = [lowerer_cls(inputs[i], self.device, self, s,
                                     params=inputs[i].get("$params"))
                         for i, s in enumerate(segs)]
        self._cache: dict = {}
        self.stats: dict = {}
        # psum'd per-segment stat parts: key -> {segment: value}
        self._parts: dict = {}

    def run(self, plan: N.PlanNode):
        """Lower ``plan`` on every segment: (the first local segment's
        result columns, its selection, the reduced checks, the stats). A
        plan's top gather replicates its result to every segment."""
        outs, checks, stats = self.run_each(lambda low: low.lower(plan))
        cols, sel = outs[0]
        return ({f.name: cols[f.name] for f in plan.fields}, sel, checks,
                stats)

    def run_each(self, fn):
        """``fn(lowerer)`` on every local segment, in segment order: (the
        per-segment results, the checks reduced to one flag each — any
        segment of any process tripped — and the stats). The tiled
        executors' preludes, steps and finalizes run through here."""
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
            cluster_sizes_agree((len(checks), len(self._parts)),
                                "run checks and stat parts")
            checks = _cluster_checks(checks)
            self.stats.update(_cluster_parts(self._parts))
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
        """psum of every segment's local any() > 0, once per node (the
        node's collective, in plan order on every process)."""
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
                # biased u64 keys: the reference's unsigned payload
                lo = self.tx.all_gather([x[None] for x in los],
                                        unsigned=True).min()
                hi = self.tx.all_gather([x[None] for x in his],
                                        unsigned=True).max()
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
            kb_sorted = torch.sort(self.tx.all_gather(
                kbs, unsigned=True)).values
            return ranges, kb_sorted, big
        return self._once(("rf", id(node)), build)

    def rf_digest(self, node: N.PRuntimeFilter):
        """The digest filter's GLOBAL digest: per key the u64 [lo, hi]
        over every segment's selected build rows (biased int64), and the
        OR of the segments' bloom bitmaps. Min/max and OR are exact, so
        this equals the reference's fold of the gathered digests. Under
        the two-level transport each host folds its segments' digests
        (``_digest_fold``) and the hosts exchange ONE combined digest
        each over the inter-host ring, as in the reference."""
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
            topo = getattr(self.tx, "hier_topo", None)
            if topo is not None and self.nseg // topo.n_hosts > 1:
                return self._hier_digest(topo, torch.stack(los),
                                         torch.stack(his),
                                         torch.stack(blooms))
            if self.procs > 1:
                # every process's segments' digests, folded as one
                nkeys = len(node.build_keys)
                words = _digest_words(torch.stack(los), torch.stack(his),
                                      torch.stack(blooms))
                glob = _digest_fold(self.tx.all_gather(list(words)).reshape(
                    self.nseg, -1), nkeys)
                return _digest_unfold(glob, nkeys)
            bloom = blooms[0]
            for b in blooms[1:]:
                bloom = bloom | b
            return (torch.stack(los).amin(0), torch.stack(his).amax(0),
                    bloom)
        glo, ghi, bloom = self._once(("rfd", id(node)), build)
        return glo, ghi, bloom, bits, kk

    def _hier_digest(self, topo, los, his, blooms):
        """The two-level digest: every segment's digest words gathered
        within its host, folded per host, and the host digests exchanged
        over the inter-host ring; segment 0's view folds to the global
        (lo, hi, bloom)."""
        S = self.nseg // topo.n_hosts
        nkeys = los.shape[1]
        digest = _digest_words(los, his, blooms)        # (local segs, D)
        D = digest.shape[1]
        local = self.tx.intra_all_gather(digest).reshape(self.nl, S, D)
        hosts = self.tx.host_ring_exchange(_digest_fold(local, nkeys))
        return _digest_unfold(_digest_fold(hosts[0], nkeys), nkeys)

    # ------------------------------------------------------------ motions

    def motion(self, node: N.PMotion, seg: int):
        """Segment ``seg``'s received (cols, sel) of ``node``; the first
        call runs the exchange for every segment."""
        return self._once(("motion", id(node)),
                          lambda: self._exchange(node))[seg - self.lo]

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
                    [K.pack_wire(c, s, layout) for c, s in parts],
                    unsigned=True)
                res = K.unpack_wire(recv, layout)
            else:
                res = ({n: self.tx.all_gather([c[n] for c, _ in parts])
                        for n in cols0},
                       self.tx.all_gather([s for _, s in parts]))
            return [res] * self.nl
        if node.kind == "redistribute":
            return self._redistribute(node, parts)
        raise X.ExecError(f"motion kind {node.kind}")

    def _use_hier(self, node: N.PMotion) -> bool:
        """Two-level exchange for this redistribute? Needs the
        hierarchical transport (the topology gate passed at build), the
        planner's host stamps for the live host count, the packed wire,
        and slots addressable by non-negative int32 route words."""
        topo = getattr(self.tx, "hier_topo", None)
        return (self.packed and topo is not None
                and node.host_bucket_cap > 0
                and node.hier_hosts == topo.n_hosts
                and self.nseg % topo.n_hosts == 0
                and self.nseg * node.bucket_cap < 1 << 31)

    def _host_combine(self, node: N.PMotion, parts: list) -> list:
        """Host-local combine of agg partials before the two-level
        exchange: gather each HOST's rows (packed wire), merge partials by
        group key with the stamped order-insensitive-exact merges, and
        keep the combined rows on the host's lane 0 only — the inter-host
        hop then ships one partial per (host, group). The reference
        computes the identical combine on every segment of a host; here
        it runs once per host, on the process that owns the host's lane
        0, and the other lanes ship nothing, which gives every segment
        the same received buffer."""
        key_names, merges = node.combine_spec
        cols0 = parts[0][0]
        layout = K.wire_layout({n: c.dtype for n, c in cols0.items()})
        hb = self.tx.intra_all_gather(torch.stack(
            [K.pack_wire(c, s, layout) for c, s in parts]))
        S = self.nseg // node.hier_hosts
        specs = [K.AggSpec(func, name) for name, func in merges]
        cap = hb.shape[1]
        out = []
        comb = None
        for i in range(self.nl):
            if (self.lo + i) % S == 0:
                hcols, hsel = K.unpack_wire(hb[i], layout)
                keys, aggs, sel, _ = K.group_aggregate(
                    {k: hcols[k] for k in key_names},
                    {name: hcols[name] for name, _ in merges}, specs, hsel,
                    out_capacity=cap)
                comb = {**keys, **aggs}
                # group_aggregate widens counts to int64; the motion's
                # schema is the contract
                comb = {n: v.to(cols0[n].dtype) for n, v in comb.items()}
                out.append((comb, sel))
            else:
                if comb is None:
                    # this process's first lanes belong to a host whose
                    # lane 0 another process owns: they ship nothing
                    comb = {n: torch.zeros((cap,), dtype=c.dtype,
                                           device=self.device)
                            for n, c in cols0.items()}
                out.append((comb, torch.zeros((cap,), dtype=torch.bool,
                                              device=self.device)))
        return out

    def _stamp_exchanges(self, n0: int, **plan) -> None:
        """Stamp the plan's rungs and row width on the exchange records
        the transport appended since ``n0`` (across processes; its
        records hold only the bytes it handed to torch.distributed), so
        the wire models are held to the plan, not to the shipped
        tensor's shape."""
        for rec in getattr(self.tx, "exchanges", ())[n0:]:
            rec.update(plan)

    def _redistribute(self, node: N.PMotion, parts: list) -> list:
        if self._use_hier(node) and node.host_combine \
                and node.combine_spec and parts[0][0]:
            parts = self._host_combine(node, parts)
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
            n0 = len(getattr(self.tx, "exchanges", ()))
            if self._use_hier(node):
                # two-level exchange: intra-host re-bucket by destination
                # host, ONE aggregated inter-host hop at the host rung,
                # intra-host scatter — a bit-identical received buffer
                HB = node.host_bucket_cap
                recv, hostdem = self.tx.hier_all_to_all(send, HB)
                over = (hostdem > HB).any(1)
                for s, low in enumerate(self.lowerers):
                    low.checks[
                        f"host bucket overflow: a host-pair block exceeded "
                        f"capacity {HB} (node {id(node)}); the two-level "
                        "retry promotes the host rung"] = over[s]
                # observed host-pair demand: the host rung's one-retry
                # promotion feed, like bucket_cap's
                self.stats[f"required host bucket (node {id(node)})"] = \
                    self.tx.pmax(list(hostdem.amax(1)))
                self._stamp_exchanges(n0, bucket_cap=B,
                                      row_bytes=layout.width * 4,
                                      host_bucket_cap=HB)
            else:
                recv = self.tx.all_to_all(send)
                self._stamp_exchanges(n0, bucket_cap=B,
                                      row_bytes=layout.width * 4)
            return [K.unpack_wire(r.reshape(n_slots, layout.width), layout)
                    for r in recv]
        recv_cols = [dict() for _ in range(self.nl)]
        for name in cols0:
            n0 = len(getattr(self.tx, "exchanges", ()))
            recv = self.tx.all_to_all([
                K.scatter_slots(cols[name][order], slot, n_slots)
                .reshape(nseg, B)
                for (cols, _), (order, slot, _) in zip(parts, slots)])
            self._stamp_exchanges(n0, bucket_cap=B,
                                  row_bytes=cols0[name].element_size())
            for d in range(self.nl):
                recv_cols[d][name] = recv[d].reshape(n_slots)
        n0 = len(getattr(self.tx, "exchanges", ()))
        recv_sel = self.tx.all_to_all([
            K.scatter_slots(valid, slot, n_slots).reshape(nseg, B)
            for order, slot, valid in slots])
        self._stamp_exchanges(n0, bucket_cap=B, row_bytes=1)
        return [(recv_cols[d], recv_sel[d].reshape(n_slots))
                for d in range(self.nl)]


def _cluster_checks(checks: dict) -> dict:
    """Every check flag OR-ed over the cluster's processes, lined up by
    position (every process records the same checks in the same plan
    order; their keys name the node by its local id)."""
    from cloudberry_tpu_torch.parallel.transport import cluster_reduce

    if not checks:
        return checks
    flags = cluster_reduce(torch.stack(
        [v.reshape(()) for v in checks.values()]).to(torch.uint8), "max")
    return {k: flags[i].bool() for i, k in enumerate(checks)}


def _cluster_parts(parts: dict) -> dict:
    """The psum'd stat parts: each key's local sum over this process's
    segments, then ONE sum over the processes for every key (lined up by
    position, as the checks are)."""
    from cloudberry_tpu_torch.parallel.transport import cluster_reduce

    if not parts:
        return {}
    local = [torch.stack([torch.as_tensor(p[s]) for s in sorted(p)]).sum(0)
             for p in parts.values()]
    flat = cluster_reduce(torch.cat(
        [v.reshape(-1).to(torch.int64) for v in local]), "sum")
    out, i = {}, 0
    for k, v in zip(parts, local):
        n = v.numel()
        out[k] = flat[i:i + n].reshape(v.shape).to(v.dtype)
        i += n
    return out


def _digest_words(los, his, blooms) -> torch.Tensor:
    """(segments, D) runtime-filter digest rows: per key the biased int64
    [lo, hi] pair as int32 words, then the bloom words."""
    nkeys = los.shape[1]
    words = torch.stack([los, his], dim=2).view(torch.int32)
    return torch.cat([words.reshape(los.shape[0], 4 * nkeys), blooms],
                     dim=1)


def _digest_unfold(glob: torch.Tensor, nkeys: int):
    """A folded digest row → (lo, hi, bloom)."""
    lohi = glob[:4 * nkeys].reshape(nkeys, 4).contiguous() \
        .view(torch.int64)
    return lohi[:, 0], lohi[:, 1], glob[4 * nkeys:]


def _digest_fold(rows: torch.Tensor, nkeys: int) -> torch.Tensor:
    """Fold (..., P, D) stacked runtime-filter digests into (..., D): per
    key the [lo, hi] fold (min/max of the biased int64 word pairs) and
    the OR of the bloom words. Order-insensitive and exact, so a
    host-local fold gives the global digest the flat reduction gives."""
    lead = rows.shape[:-2]
    lohi = rows[..., :4 * nkeys].contiguous().view(torch.int64) \
        .reshape(lead + (rows.shape[-2], nkeys, 2))
    folded = torch.stack([lohi[..., 0].amin(-2), lohi[..., 1].amax(-2)],
                         dim=-1).view(torch.int32)
    bloom = rows[..., 0, 4 * nkeys:]
    for p in range(1, rows.shape[-2]):
        bloom = bloom | rows[..., p, 4 * nkeys:]
    return torch.cat([folded.reshape(lead + (4 * nkeys,)), bloom], dim=-1)


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
    ``_skew_ratio``; a two-level motion's observed host-pair demand pins
    as ``_observed_host_bucket`` (the host rung's promotion feed). With a
    ``session``, skew also feeds the registry (histograms +
    ``skew_events`` past ``config.obs.skew_ratio``). ``stats`` are host
    values (``stats_to_host``)."""
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
        m = re.search(r"required host bucket \(node (\d+)\)", key)
        if m is not None:
            node = motions.get(int(m.group(1)))
            if node is not None:
                node._observed_host_bucket = int(np.asarray(v))
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
    ``skew_events`` when a shuffle crosses ``config.obs.skew_ratio``.
    Per-HOST skew sits beside it (``_host_rows``, ``_host_skew_ratio``,
    ``host_skew_events``) on a multi-host layout: a host-skewed shuffle is
    the case the two-level exchange makes worse (one host pair's rung
    pads every host pair)."""
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
        hrows = _host_rows(rows, session)
        if hrows is not None:
            node._host_rows = hrows
            node._host_skew_ratio = float(
                hrows.max() / (total / hrows.shape[0]))
        else:
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
        if node._host_skew_ratio is not None:
            reg.observe("motion_host_skew_ratio", node._host_skew_ratio)
            reg.observe("motion_host_rows_max", int(hrows.max()))
            if threshold > 0 and node._host_skew_ratio >= threshold:
                log.bump("host_skew_events")


def _host_rows(seg_rows: np.ndarray, session) -> np.ndarray | None:
    """Per-destination-HOST row demand from the per-segment vector; None
    on a one-host layout. Uses the host layout the motion layer splits
    over (``CBTPU_FORCE_HOSTS`` included), so the telemetry describes the
    links the bytes would cross."""
    from cloudberry_tpu_torch.parallel.mesh import host_topology

    try:
        topo = host_topology(
            seg_rows.shape[0],
            getattr(session, "_live_device_ids", None)
            if session is not None else None)
    except Exception:
        return None
    if topo.n_hosts < 2:
        return None
    out = np.zeros(topo.n_hosts, dtype=np.int64)
    for h, segs in enumerate(topo.segs_by_host):
        out[h] = sum(int(seg_rows[s]) for s in segs
                     if s < seg_rows.shape[0])
    return out


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
            for attr in ("_observed_bucket", "_observed_host_bucket"):
                ob = getattr(a, attr, None)
                if ob is not None:
                    setattr(b, attr, ob)
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
