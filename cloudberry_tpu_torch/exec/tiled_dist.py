"""Distributed tiled (out-of-core) execution — spill on the segment gang.

The reference spills operator state per segment process (workfile_mgr.c,
nodeHash.c's increase-nbatch discipline) while Motion keeps flowing
between slices. The JAX package moves the spill boundary to plan time
and onto its mesh; the port runs the same plan on the gang of segment
lowerers of exec/dist_executor.py, decision for decision. When an
admission-refused plan is distributed (``n_segments > 1``), the
probe-side stream is tiled PER SEGMENT and each phase is one gang run:

- prelude (once): every spine join's build subtree — including its own
  motions (broadcast of small tables, build-side redistributes) — is
  computed on every segment; the per-segment results stay resident on
  the device;
- step (per tile): each segment feeds tile t of ITS shard; the spine's
  redistribute motions exchange per tile through the one-card transport
  with bucket capacity min(planned, tile) — a tile of T rows can never
  send more than T rows to one destination — and each segment's partial
  aggregation merges into its fixed-capacity accumulator through
  ``executor.merge_group_aggregate`` (the sorted-segment kernel where
  eligible; partials merge associatively, plan/distribute.py
  ``_split_aggs``). The accumulators are (nseg, capacity) tensors;
- finalize (once): the accumulators take the partial aggregation's place
  in the ORIGINAL distributed plan — the merge motion, final aggregation
  and post chain run unchanged as one last gang run.

Top-N keeps per-segment bounded row accumulators (finalize re-runs the
original gather + global sort over them); sort and window modes pool
every segment's rows on the host (the gather is subsumed by collection)
and finish through the single-node merge pass and window chunk pass.

Tile rows, mode, accumulator capacity and the decision to tile or decline
come from the JAX package's planner code and ``estimate_plan_memory``:
the reference admits by the PER-SEGMENT estimate, each segment owning a
device; on one card all nseg working sets coexist (ROADMAP Queue C 32).

Each step's redistributes report their per-destination row counts (the
gang's ``seg rows`` stat); with feedback on, the skew sentinel
(exec/tiled.py ``SkewSentinel``) reads them once per drained tile
(``tile_stat_syncs``) and may ask for a mid-statement replan, resuming
from a forced checkpoint (exec/recovery.py). A device loss at a tile
(the ``tile_device_lost`` seam) rides the session's retry into a resume
from the last checkpoint, at the degraded segment count when the probe
lost a slot (the remaining rows re-shard by the placement hash). The
report's ``topology_epoch`` is the topology epoch the executable was
built under (``sharedcache.topology_token``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from cloudberry_tpu_torch.columnar.batch import ColumnBatch
from cloudberry_tpu_torch.exec import bufferpool as BUF
from cloudberry_tpu_torch.exec import executor as X
from cloudberry_tpu_torch.exec import kernels as K
from cloudberry_tpu_torch.exec import scanpipe as SP
from cloudberry_tpu_torch.exec import tilepipe as TP
from cloudberry_tpu_torch.exec.dist_executor import (DistLowerer, Gang,
                                                     prepare_dist_inputs,
                                                     session_transport)
from cloudberry_tpu_torch.exec.expr_compile import torch_dtype
from cloudberry_tpu_torch.exec.resource import estimate_plan_memory
from cloudberry_tpu_torch.exec.tiled import (_MAX_TILE, _MIN_TILE, _AccLeaf,
                                             AdaptiveTiledMixin,
                                             SkewSentinel, _acc_width,
                                             _bufpool_charge, _expr_dict,
                                             _host_batch, _merge_bytes,
                                             _out_cap, _raise_tile_checks,
                                             _ReplacingLowerer, _TileTimer,
                                             _topn_bound, host_apply_post,
                                             host_post_ok, merge_sorted_runs,
                                             window_chunk_pass)
from cloudberry_tpu_torch.plan import expr as ex
from cloudberry_tpu_torch.plan import nodes as N
from cloudberry_tpu_torch.plan.distribute import (_all_exprs,
                                                  _finalize_project,
                                                  _split_aggs)
from cloudberry_tpu_torch.utils.faultinject import fault_point


@dataclass
class _DistTileShape:
    """Everything the rewrite discovered about the distributed plan."""

    root: N.PlanNode                 # finalize root (whole plan)
    replace_node: N.PlanNode         # node the accumulator stands in for
    partial_plan: N.PlanNode         # per-tile partial plan
    merge_motion: Optional[N.PMotion]  # motion above the partial (case A)
    final_agg: Optional[N.PAgg]      # merge aggregation (case A)
    spine: list[N.PlanNode]          # partial.child .. just above the stream
    stream: N.PScan                  # the tiled per-segment scan
    builds: list[N.PlanNode]         # prelude-computed subtrees
    stream_rows: int = 0             # max per-segment shard rows
    merge_specs: list = field(default_factory=list)
    group_names: list = field(default_factory=list)
    g_cap: int = 0                   # per-segment accumulator capacity
    max_groups: int = 0              # hard ceiling for g_cap growth
    mode: str = "agg"
    sortnode: Optional[N.PSort] = None  # topn/sort: the (synthetic) sort
    post: list = field(default_factory=list)  # topn: chain above spine
    post_above: list = field(default_factory=list)  # sort: above the sort
    winnode: Optional[N.PWindow] = None  # window: BOTTOM of the stack
    n_ckeys: int = 0                     # window: chunk-key count


def plan_tiled_dist(plan: N.PlanNode, session):
    """Re-plan an admission-refused DISTRIBUTED statement for tiled
    execution over the segment gang. None when the plan shape or the
    budget cannot support it."""
    if not session.config.resource.enable_spill:
        return None
    if getattr(plan, "_direct_segment", None) is not None:
        return None
    shape = _analyze_dist(plan, session)
    if shape is None:
        return None

    # whole-run growth marks belong to the untiled attempt; the tiled
    # adaptive loop re-learns spine buffer sizes per tile (builds keep
    # theirs — the prelude still computes whole builds)
    for node in shape.spine:
        if isinstance(node, N.PJoin) and hasattr(node, "_min_out_cap"):
            del node._min_out_cap
    # join-index inputs are a one-shot feature: the tiled phases assemble
    # their own inputs. The strip is speculative: a decline below
    # restores the stash so the one-shot fallback keeps its indexes.
    from cloudberry_tpu_torch.exec.joinindex import (restore_join_index,
                                                     stash_join_index,
                                                     strip_join_index)

    jix_stash = stash_join_index(plan)
    strip_join_index(plan)

    if shape.mode == "agg":
        from cloudberry_tpu_torch.plan.cost import estimate_rows

        try:
            est_groups = estimate_rows(shape.partial_plan, session.catalog)
        except Exception:  # noqa: BLE001 — the reference's fallback
            est_groups = 1024
        shape.g_cap = int(min(shape.max_groups,
                              max(1024, 4 * int(est_groups) + 1)))
        if not shape.group_names:
            shape.g_cap = 1

    budget = session.config.resource.query_mem_bytes
    nseg = session.config.n_segments
    tile_rows = _choose_tile_dist(shape, budget, nseg)
    if tile_rows is None and shape.mode == "topn":
        # LIMIT+OFFSET exceeds any resident accumulator: fall back to the
        # full external sort when the chain above the sort can apply on
        # the host
        s2 = _to_dist_sort(shape)
        if s2 is None:
            restore_join_index(jix_stash)
            return None
        shape = s2
        tile_rows = _choose_tile_dist(shape, budget, nseg)
    if tile_rows is None:
        restore_join_index(jix_stash)
        return None
    cls = {"topn": DistTopNTiledExecutable,
           "sort": DistSortTiledExecutable,
           "window": DistWindowTiledExecutable,
           "agg": DistTiledExecutable}[shape.mode]
    return cls(shape, session, tile_rows, budget)


def _to_dist_sort(shape: _DistTileShape) -> Optional[_DistTileShape]:
    """Re-aim a topn shape at the external-sort executable."""
    post_above = shape.post[:shape.post.index(shape.sortnode)]
    if not host_post_ok(post_above, shape.sortnode.keys):
        return None
    shape.mode = "sort"
    shape.g_cap = 0
    shape.post_above = post_above
    return shape


def _analyze_dist(plan: N.PlanNode, session) -> Optional[_DistTileShape]:
    """Recognize the streamable distributed shape: post chain (projections
    / sorts / limits / gather motions) over a two-stage aggregation
    (final ← motion ← partial) — or a colocated one-stage aggregation —
    over a join/filter/redistribute spine whose probe path ends at a
    partitioned scan."""
    for e in _all_exprs(plan):
        for sub in ex.walk(e):
            if isinstance(sub, ex.SubqueryScalar):
                return None  # subquery plans scan outside the spine budget

    post: list[N.PlanNode] = []
    cur = plan
    while True:
        if isinstance(cur, (N.PProject, N.PSort, N.PLimit, N.PFilter)):
            post.append(cur)
            cur = cur.child
        elif isinstance(cur, N.PMotion) and cur.kind == "gather":
            post.append(cur)
            cur = cur.child
        else:
            break
    if isinstance(cur, N.PWindow):
        return _analyze_dist_window(plan, post, cur, session)
    if not isinstance(cur, N.PAgg):
        return _analyze_dist_topn(plan, post, session)

    if cur.mode == "final":
        final_agg = cur
        motion = final_agg.child
        if not isinstance(motion, N.PMotion) \
                or motion.kind not in ("gather", "redistribute"):
            return None
        partial = motion.child
        if not isinstance(partial, N.PAgg) or partial.mode != "partial":
            return None
        merge_specs = [K.AggSpec(call.func, name)
                       for name, call in final_agg.aggs]
        group_names = [n for n, _ in partial.group_keys]
        spine_res = _walk_spine(partial.child, session)
        if spine_res is None:
            return None
        spine, stream, builds, stream_rows = spine_res
        return _DistTileShape(
            root=plan, replace_node=partial, partial_plan=partial,
            merge_motion=motion, final_agg=final_agg, spine=spine,
            stream=stream, builds=builds, stream_rows=stream_rows,
            merge_specs=merge_specs, group_names=group_names,
            max_groups=partial.capacity)

    if cur.mode != "single":
        return None
    # one-stage colocated aggregation: the partial/merge split of the
    # single-node tiled planner; the accumulator IS the final state per
    # segment (groups are colocated), so finalize is the finalize
    # projection + post chain
    agg = cur
    try:
        partial_aggs, final_aggs, finalize = _split_aggs(agg.aggs)
    except ValueError:
        return None
    spine_res = _walk_spine(agg.child, session)
    if spine_res is None:
        return None
    spine, stream, builds, stream_rows = spine_res

    partial = N.PAgg(agg.child, agg.group_keys, partial_aggs,
                     capacity=agg.capacity, mode="partial")
    partial.fields = [
        N.PlanField(n, e.dtype, _expr_dict(agg.child, e))
        for n, e in agg.group_keys
    ] + [N.PlanField(n, c.dtype, None) for n, c in partial_aggs]

    leaf = _AccLeaf()
    leaf.fields = list(partial.fields)
    leaf.sharding = agg.sharding
    fproj = _finalize_project(leaf, agg, finalize)
    fproj.sharding = agg.sharding
    if post:
        post[-1].child = fproj
        root = post[0]
    else:
        root = fproj
    merge_specs = [K.AggSpec(call.func, name) for name, call in final_aggs]
    return _DistTileShape(
        root=root, replace_node=leaf, partial_plan=partial,
        merge_motion=None, final_agg=None, spine=spine, stream=stream,
        builds=builds, stream_rows=stream_rows, merge_specs=merge_specs,
        group_names=[n for n, _ in agg.group_keys],
        max_groups=agg.capacity)


def _analyze_dist_topn(plan, post, session) -> Optional[_DistTileShape]:
    """ORDER BY + LIMIT with no aggregation: per-segment bounded top-N
    accumulators. Every segment keeps the best LIMIT+OFFSET rows of ITS
    stream — the global top-N is a subset of that union — and finalize
    re-runs the ORIGINAL plan (pre-gather compaction, gather, sorts,
    limits) over the accumulators."""
    # motions in the chain are gathers (the walk guarantees): row-set
    # preserving, so the limit search may cross them
    hit = _topn_bound(post, skip=(N.PMotion,))
    if hit is None:
        return _analyze_dist_sort(plan, post, session)
    sortnode, m = hit
    spine_res = _walk_spine(sortnode.child, session)
    if spine_res is None:
        return None
    spine, stream, builds, stream_rows = spine_res
    shape = _DistTileShape(
        root=plan, replace_node=sortnode.child,
        partial_plan=sortnode.child, merge_motion=None, final_agg=None,
        spine=spine, stream=stream, builds=builds,
        stream_rows=stream_rows, mode="topn", sortnode=sortnode,
        post=post)
    shape.g_cap = m
    shape.max_groups = m
    return shape


def _analyze_dist_sort(plan, post, session) -> Optional[_DistTileShape]:
    """Unbounded ORDER BY: the external-sort stream runs per segment (the
    spine's own motions exchange per tile); the host pools every
    segment's rows — the gather is subsumed by collection — and the merge
    pass plus the chain above the sort apply on the host."""
    sort_i = next((i for i in range(len(post) - 1, -1, -1)
                   if isinstance(post[i], N.PSort)), None)
    if sort_i is None:
        return None
    sortnode = post[sort_i]
    post_above = post[:sort_i]
    if not host_post_ok(post_above, sortnode.keys):
        return None
    below = sortnode.child
    while isinstance(below, N.PMotion) and below.kind == "gather":
        below = below.child
    spine_res = _walk_spine(below, session)
    if spine_res is None:
        return None
    spine, stream, builds, stream_rows = spine_res
    shape = _DistTileShape(
        root=plan, replace_node=below, partial_plan=below,
        merge_motion=None, final_agg=None, spine=spine, stream=stream,
        builds=builds, stream_rows=stream_rows, mode="sort",
        sortnode=sortnode, post=post)
    shape.post_above = post_above
    return shape


def _analyze_dist_window(plan, post, top_window,
                         session) -> Optional[_DistTileShape]:
    """Window stack: phase one is the per-segment external-sort stream
    grouped by the stack's common partition keys; phase two runs
    whole-partition chunks through the ORIGINAL plan (gathers lower as
    the identity over pooled host rows) as one program — chunks are
    independent, so no gang is needed above the stream."""
    for nd in post:
        if isinstance(nd, N.PMotion) and nd.kind == "gather":
            continue
        if isinstance(nd, N.PProject) and all(
                isinstance(e, ex.ColumnRef) for _, e in nd.exprs):
            continue
        return None
    node = top_window
    bottom = node
    common = None
    while isinstance(node, N.PWindow):
        bottom = node
        here = {repr(pk): pk for pk in node.partition_keys}
        common = here if common is None else \
            {k: v for k, v in common.items() if k in here}
        node = node.child
    if not common:
        return None
    below = bottom.child
    while isinstance(below, N.PMotion) and below.kind == "gather":
        below = below.child
    spine_res = _walk_spine(below, session)
    if spine_res is None:
        return None
    spine, stream, builds, stream_rows = spine_res
    ckeys = list(common.values())
    srt = N.PSort(below, [(ck, True) for ck in ckeys])
    srt.fields = list(below.fields)
    shape = _DistTileShape(
        root=plan, replace_node=bottom.child, partial_plan=below,
        merge_motion=None, final_agg=None, spine=spine, stream=stream,
        builds=builds, stream_rows=stream_rows, mode="window",
        sortnode=srt, post=post)
    shape.winnode = bottom
    shape.n_ckeys = len(ckeys)
    return shape


def _walk_spine(top: N.PlanNode, session):
    """Descend the probe path: filters/projections/runtime filters/joins/
    redistribute motions down to a partitioned scan (the stream)."""
    spine: list[N.PlanNode] = []
    builds: list[N.PlanNode] = []
    seen: set[int] = set()
    cur = top
    # graftlint: ignore[seam-loop] bounded plan-tree descent (one step per node; catalog lookups only) — terminates with the tree, never a tile/retry loop
    while True:
        if isinstance(cur, (N.PFilter, N.PProject)):
            spine.append(cur)
            cur = cur.child
        elif isinstance(cur, N.PRuntimeFilter):
            spine.append(cur)
            if id(cur.build) not in seen:
                seen.add(id(cur.build))
                builds.append(cur.build)
            cur = cur.child
        elif isinstance(cur, N.PMotion) and cur.kind == "redistribute":
            cur._orig_bucket_cap = cur.bucket_cap
            spine.append(cur)
            cur = cur.child
        elif isinstance(cur, N.PJoin):
            if cur.kind == "full":
                return None  # unmatched-BUILD emission is once per statement
            spine.append(cur)
            if id(cur.build) not in seen:
                seen.add(id(cur.build))
                builds.append(cur.build)
            cur = cur.probe
        elif isinstance(cur, N.PScan) and cur.table_name != "$dual":
            try:
                t = session.catalog.table(cur.table_name)
            except KeyError:
                return None
            if t.policy.kind == "replicated":
                return None  # stream the partitioned side only
            counts = session.shard_counts(cur.table_name)
            rows = int(counts.max()) if len(counts) else 0
            return spine, cur, builds, max(rows, 1)
        else:
            return None


def _retile_dist(shape: _DistTileShape, tile_rows: int, nseg: int) -> None:
    """Re-derive spine capacities for one tile per segment. Redistribute
    buckets are clamped to the per-tile send bound (a source segment's
    tile holds at most ``cap`` rows, so no destination bucket can exceed
    it); expansion joins keep the NDV pair-estimate floor scaled to the
    tile fraction, and runtime-grown buffers (_min_out_cap) never
    shrink."""
    frac = tile_rows / max(shape.stream_rows, 1)
    shape.stream.capacity = tile_rows
    shape.stream.num_rows = -2
    cap = tile_rows
    for node in reversed(shape.spine):
        if isinstance(node, N.PMotion):  # redistribute (walk guarantees)
            node.bucket_cap = max(min(node._orig_bucket_cap, cap), 8,
                                  getattr(node, "_min_bucket_cap", 0))
            node.out_capacity = node.bucket_cap * nseg
            cap = node.out_capacity
        elif isinstance(node, N.PJoin):
            bcap = _out_cap(node.build)
            est = getattr(node, "_est_pairs", None)
            floor = int(2 * est / nseg * min(frac, 1.0)) + 8 if est else 0
            floor = max(floor, getattr(node, "_min_out_cap", 0))
            if node.residual is not None:
                node.out_capacity = max(bcap + cap, floor)
            elif not node.unique_build:
                node.out_capacity = max(bcap + cap, floor)
                cap = node.out_capacity
    if shape.mode == "agg":
        shape.partial_plan.capacity = min(shape.g_cap, max(cap, 1)) \
            if shape.group_names else 1


def _finalize_bytes(shape: _DistTileShape, nseg: int) -> int:
    """Working set of the finalize per segment: the merge motion's receive
    buffer and final aggregation both hold up to nseg·g_cap accumulator
    rows (one g_cap block from every segment); the colocated one-stage
    case never leaves the segment; top-N gathers every segment's
    accumulator for the global sort."""
    if shape.mode == "topn":
        rows = shape.g_cap * nseg
    else:
        rows = shape.g_cap * (nseg if shape.merge_motion is not None
                              else 1)
    return 3 * rows * _acc_width(shape)


def _choose_tile_dist(shape: _DistTileShape, budget: int,
                      nseg: int) -> Optional[int]:
    if _finalize_bytes(shape, nseg) > budget:
        return None  # no tile size can shrink the finalize
    t = _MAX_TILE
    while t >= _MIN_TILE:
        _retile_dist(shape, t, nseg)
        est = estimate_plan_memory(shape.partial_plan).peak_bytes
        if est + _merge_bytes(shape) <= budget:
            return t
        t >>= 1
    return None


# --------------------------------------------------------------- lowerers


class _DistReplacingLowerer(DistLowerer):
    """DistLowerer with a node-identity substitution table (prelude-computed
    builds; the finalize accumulator)."""

    def __init__(self, tables, device, gang, seg, replace: dict,
                 params=None):
        super().__init__(tables, device, gang, seg, params=params)
        self._replace = replace

    def lower(self, node: N.PlanNode):
        hit = self._replace.get(id(node))
        if hit is not None:
            return hit
        return super().lower(node)


class _DistTileLowerer(_DistReplacingLowerer):
    """Step lowerer: the stream scan reads this segment's tile."""

    def __init__(self, tables, device, gang, seg, replace: dict,
                 stream: N.PScan, tile_n: int, params=None):
        super().__init__(tables, device, gang, seg, replace, params=params)
        self._stream = stream
        self._tile_n = tile_n

    def scan(self, node: N.PScan):
        if node is not self._stream:
            return super().scan(node)
        tile = self.tables["$tile"]
        cols = {}
        for phys, out in node.column_map.items():
            cols[out] = tile[phys]
        for phys, out in node.mask_map.items():
            cols[out] = tile[f"$nn:{phys}"]
        sel = torch.arange(node.capacity, device=self.device) < self._tile_n
        return cols, sel


# --------------------------------------------------------------- execution


def _stat_copy(stats: dict, motions, nseg: int, device):
    """Start the host copy of each stat motion's (required-bucket scalar,
    per-destination row vector) pair off the gang's stats — zeros when a
    motion did not run the bucketed path. The skew sentinel reads the
    copy when the tile drains (``_stat_pairs``)."""
    ts = []
    for m in motions:
        b = stats.get(f"required bucket (node {id(m)})")
        r = stats.get(f"seg rows (node {id(m)})")
        ts.append(torch.zeros((), dtype=torch.int64, device=device)
                  if b is None else torch.as_tensor(b).to(torch.int64))
        ts.append(torch.zeros((nseg,), dtype=torch.int64, device=device)
                  if r is None else torch.as_tensor(r).to(torch.int64))
    return TP._HostCopy(ts)


def _stat_pairs(copy) -> tuple:
    host = copy.wait()
    return tuple((host[i].numpy(), host[i + 1].numpy())
                 for i in range(0, len(host), 2))


class DistTiledExecutable(AdaptiveTiledMixin):
    """A distributed tiled statement: prelude (once) → step (per tile,
    lock-step across segments) → finalize, each a gang run. ``report``
    records the spill decision."""

    _what = "distributed tiled execution"

    def __init__(self, shape: _DistTileShape, session, tile_rows: int,
                 budget: int):
        self.shape = shape
        self.session = session
        self.nseg = session.config.n_segments
        self.tile_rows = tile_rows
        self.budget = budget
        self.device = session.device
        self._platform = session.device.type
        ic = session.config.interconnect
        # the SAME motion semantics as the in-memory distributed path: a
        # plan whose motions carry two-level stamps (host_combine grew
        # the rungs) must not pay the padding while shipping flat
        self._tx = session_transport(session)
        # this process's segments (every segment in one process): its
        # tiles, accumulators and checkpoints index these; every decision
        # that changes the collective sequence is reduced over the
        # processes first (``_agree_retry``, the sentinel, the resume)
        self.segs = getattr(self._tx, "local", range(self.nseg))
        self.lo, self.nl = self.segs.start, len(self.segs)
        # the steps' spine motions AND the finalize merge motion share the
        # packed wire format (kernels.wire_layout)
        self._packed = ic.packed_wire
        self._compiled = None
        # retries mutate shared plan capacities, so runs serialize
        self._run_lock = threading.Lock()
        self._refresh_report()

    def _refresh_report(self) -> None:
        from cloudberry_tpu_torch.sched.sharedcache import topology_token

        shape = self.shape
        _retile_dist(shape, self.tile_rows, self.nseg)
        est = estimate_plan_memory(shape.partial_plan).peak_bytes
        self.report = {
            "tiled": True,
            "distributed": True,
            "n_segments": self.nseg,
            "topology_epoch": topology_token(self.session),
            "stream_table": shape.stream.table_name,
            "tile_rows": self.tile_rows,
            "acc_capacity": shape.g_cap,
            "est_step_bytes": est + _merge_bytes(shape),
            "est_finalize_bytes": _finalize_bytes(shape, self.nseg),
            # scan-pipeline staging plus the dispatch window's extra
            # in-flight (nseg, tile_rows) tiles
            "est_pipeline_bytes": SP.queue_charge_bytes(
                shape.stream, self.tile_rows, self.session.config,
                nseg=self.nseg)
            + TP.window_charge_bytes(
                shape.stream, self.tile_rows, self.session.config,
                self._platform, nseg=self.nseg),
            "est_bufpool_bytes": _bufpool_charge(
                self.session, shape.stream.table_name),
            "budget_bytes": self.budget,
        }

    def _over_budget(self) -> bool:
        return (self.report["est_step_bytes"] > self.budget
                or self.report["est_finalize_bytes"] > self.budget)

    def _groups_ceiling(self) -> int:
        return self.shape.max_groups

    def _agree_retry(self) -> None:
        """A retry's accumulator and tile size, the same on every process
        of a cluster (the largest accumulator, the smallest tile): the
        next attempt's collectives must line up."""
        from cloudberry_tpu_torch.parallel.transport import cluster_reduce

        v = cluster_reduce(torch.tensor(
            [self.shape.g_cap, -self.tile_rows], dtype=torch.int64), "max")
        self.shape.g_cap, self.tile_rows = int(v[0]), -int(v[1])

    # ------------------------------------------------------------ programs

    def _whole_plan(self) -> N.PlanNode:
        return self.shape.partial_plan

    def _resident_names(self) -> list[str]:
        return sorted({s.table_name
                       for s in X.scans_of(self.shape.partial_plan)
                       if s is not self.shape.stream})

    def _gang(self, inputs: list, make) -> Gang:
        return Gang(inputs, self.nseg, self.device, self._tx, self._packed,
                    make)

    def _prelude(self, resident: list) -> list:
        """Every spine build on every segment: per segment, the builds'
        (cols, sel) in ``shape.builds`` order."""
        builds = self.shape.builds
        if not builds:
            return [[] for _ in range(self.nl)]
        outs, checks, _ = self._gang(resident, DistLowerer).run_each(
            lambda low: [low.lower_shared(b) for b in builds])
        X.raise_checks(checks)
        return outs

    def _step_gang(self, resident, prelude, tile, tile_ns) -> Gang:
        """The gang of one step: this process's i-th segment reads row i
        of the (local) tile and its own prelude builds."""
        shape = self.shape
        inputs = []
        for i in range(self.nl):
            t = dict(resident[i])
            t["$tile"] = {k: v[i] for k, v in tile.items()}
            inputs.append(t)
        replaces = [{id(b): prelude[i][j] for j, b in enumerate(shape.builds)}
                    for i in range(self.nl)]
        ns = [int(n) for n in np.asarray(tile_ns)]
        lo = self.lo

        def make(tables, device, gang, seg, params=None):
            return _DistTileLowerer(tables, device, gang, seg,
                                    replaces[seg - lo], shape.stream,
                                    ns[seg - lo], params=params)

        return self._gang(inputs, make)

    def _stat_motions(self):
        """The step's redistribute motions, in deterministic traversal
        order — the skew sentinel watches their per-destination row
        counts, and the end-of-run fold publishes the cumulative
        observations to the feedback store (plan/feedback.py)."""
        return tuple(n for n in X.all_nodes(self.shape.partial_plan)
                     if isinstance(n, N.PMotion)
                     and n.kind == "redistribute")

    def _step(self, resident, prelude, tile, tile_ns, acc):
        """One tile on every segment, merged into the accumulators:
        (new (nseg, g_cap) accumulator, reduced checks, stats)."""
        shape = self.shape
        group_names = list(shape.group_names)
        specs = shape.merge_specs
        g_cap = shape.g_cap
        acc_cols, acc_sel = acc
        dev = self.device

        def seg_fn(low):
            pcols, psel = low.lower(shape.partial_plan)
            s = low.seg - self.lo
            agg_vals = {sp.out_name: torch.cat(
                [acc_cols[sp.out_name][s], pcols[sp.out_name]])
                for sp in specs}
            sel = torch.cat([acc_sel[s], psel])
            if group_names:
                key_cols = {n: torch.cat([acc_cols[n][s], pcols[n]])
                            for n in group_names}
                # the same kernel-or-sort dispatch as the one-shot
                # executor: eligible integer sums are bit-identical
                ok, oa, osel, n_groups = X.merge_group_aggregate(
                    key_cols, agg_vals, specs, sel, g_cap)
                low.checks["tile merge overflow: more groups than "
                           f"capacity {g_cap}; raise the aggregation "
                           "capacity"] = n_groups > g_cap
                return {**ok, **oa}, osel
            out = K.global_aggregate(agg_vals, specs, sel)
            return out, torch.ones((1,), dtype=torch.bool, device=dev)

        gang = self._step_gang(resident, prelude, tile, tile_ns)
        outs, checks, stats = gang.run_each(seg_fn)
        return _stack_acc(outs, acc_cols), checks, stats

    def _refinalize(self) -> None:
        """Size the merge boundary for the accumulator: a segment's acc
        has at most g_cap rows, so a redistribute bucket (all of one
        source's acc to one destination) is bounded by g_cap, and the
        final aggregation sees at most nseg·g_cap rows."""
        shape = self.shape
        if shape.merge_motion is not None:
            if shape.merge_motion.kind == "redistribute":
                shape.merge_motion.bucket_cap = shape.g_cap
            shape.merge_motion.out_capacity = shape.g_cap * self.nseg
        if shape.final_agg is not None:
            shape.final_agg.capacity = max(shape.g_cap * self.nseg, 1)

    def _init_acc(self):
        shape, dev, nseg = self.shape, self.device, self.nl
        g_cap = shape.g_cap
        if shape.group_names:
            cols = {f.name: torch.zeros(
                (nseg, g_cap), dtype=torch_dtype(f.type.np_dtype),
                device=dev) for f in shape.partial_plan.fields}
            return cols, torch.zeros((nseg, g_cap), dtype=torch.bool,
                                     device=dev)
        cols = {}
        for f, spec in zip(shape.partial_plan.fields, shape.merge_specs):
            dt = np.dtype(f.type.np_dtype)
            if spec.func == "min":
                ident = np.finfo(dt).max if np.issubdtype(dt, np.floating) \
                    else np.iinfo(dt).max
            elif spec.func == "max":
                ident = np.finfo(dt).min if np.issubdtype(dt, np.floating) \
                    else np.iinfo(dt).min
            else:
                ident = 0
            cols[f.name] = torch.full((nseg, 1), ident,
                                      dtype=torch_dtype(dt), device=dev)
        # identity row stays unselected: min/max identities must not leak
        return cols, torch.zeros((nseg, 1), dtype=torch.bool, device=dev)

    def _finalize(self, acc) -> ColumnBatch:
        """The original plan above the accumulators, as one gang run;
        segment 0's (gathered) result."""
        shape = self.shape
        acc_cols, acc_sel = acc

        def make(tables, device, gang, seg, params=None):
            i = seg - self.lo
            hit = ({n: c[i] for n, c in acc_cols.items()}, acc_sel[i])
            return _DistReplacingLowerer(tables, device, gang, seg,
                                         {id(shape.replace_node): hit},
                                         params=params)

        cols, sel, checks, _ = self._gang(
            [{} for _ in range(self.nl)], make).run(shape.root)
        X.raise_checks(checks)
        return X.make_batch(shape.root, cols, sel)

    # ----------------------------------------------------------------- run

    def run(self) -> ColumnBatch:
        X.build_kernels(self.session)
        with self._run_lock:
            return self._run_adaptive()

    def _resident(self) -> list:
        return prepare_dist_inputs(None, self.session,
                                   names=self._resident_names())

    def _run_once(self) -> ColumnBatch:
        from cloudberry_tpu_torch.exec import recovery as R
        from cloudberry_tpu_torch.lifecycle import check_cancel

        # mid-statement recovery: the prepare step may grow g_cap for
        # re-sharded partials, so it runs BEFORE the retile/refinalize
        # chain fixes the shapes
        ctx = R.begin(self, dist=True)
        R.agree_resume(ctx)
        if ctx is not None:
            ctx.prepare_dist()
        _retile_dist(self.shape, self.tile_rows, self.nseg)
        self._refinalize()
        resident = self._resident()
        prelude = self._prelude(resident)

        acc = self._init_acc()
        if ctx is not None:
            acc = ctx.restore_acc(acc)
        had = ctx is not None and ctx.resumed
        if not R.agree_resume(ctx) and had:
            acc = self._init_acc()   # another process declined its restore
        feed = (ctx.feed() if ctx is not None else None) \
            or _dist_tile_feed(self.shape.stream, self.session,
                               self.tile_rows, self.segs)
        n_base = ctx.tiles_base if ctx is not None else 0
        n_local = 0
        n_sub = 0
        timer = _TileTimer(self.session)
        tracker = _dist_progress_tracker(self, feed, n_base)
        motions = self._stat_motions()
        sentinel = SkewSentinel(self, motions, ctx)
        pipe = TP.TilePipe(self.session, TP.effective_window(
            self.session.config, self._platform))
        # the prefetch pipeline over the host feed (tiles reach the device
        # through its stage); the tracker and the checkpoint math read the
        # UNWRAPPED feed, and progress counts drained tiles only
        stream = SP.maybe_pipeline(iter(feed), self.session.config,
                                   device=self.device,
                                   min_depth=pipe.window)

        def _verified(d):
            # host effects for one drained-clean tile, in stream order
            nonlocal n_local
            tile_k, staged, srows = d.payload
            n_local = tile_k
            if srows is not None:
                sentinel.observe(_stat_pairs(srows))
            tracker.step(tile_k)
            if ctx is not None:
                ctx.tick(tile_k, staged if staged is not None
                         else (lambda: R.acc_payload(acc)))

        def _settle():
            # drain every dispatched tile so the replan snapshot's acc
            # (the newest) matches the settled tile count
            for d in pipe.drain_all():
                _verified(d)
            return n_sub

        try:
            for tile, tile_ns in stream:
                fault_point("tile_step_dist")
                fault_point("tile_device_lost")
                n_sub += 1
                stage = (ctx is not None and pipe.window > 1
                         and ctx.snapshot_due(n_sub))
                with timer.step(n_base + n_sub - 1):
                    acc, checks, stats = self._step(resident, prelude, tile,
                                                    tile_ns, acc)
                    del tile
                    staged = TP.stage_checkpoint(acc) if stage else None
                    srows = _stat_copy(stats, motions, self.nseg,
                                       self.device) \
                        if sentinel.collect else None
                    drained = pipe.submit(n_base + n_sub - 1, checks,
                                          (n_sub, staged, srows))
                for d in drained:
                    _verified(d)
                # AFTER the cadence tick: an alarm at a tick tile reuses
                # that snapshot instead of saving twice
                sentinel.maybe_replan(n_local,
                                      lambda: R.acc_payload(acc),
                                      settle=_settle)
            for d in pipe.drain_all():
                _verified(d)
            if pipe.window > 1:
                # the tail's observes may alarm after the feed ended
                sentinel.maybe_replan(n_local,
                                      lambda: R.acc_payload(acc))
        finally:
            if pipe.deferred_fail:
                self._deferred_fail = True
            SP.close_feed(stream)
        SP.stamp_report(self.report, stream)
        timer.stamp(self.report)
        pipe.stamp(self.report)
        sentinel.fold_final()
        n_tiles = n_base + n_local
        if n_tiles == 0:  # empty stream: one all-masked tile seeds the acc
            tile = _empty_dist_tile(self.shape.stream, self.tile_rows,
                                    self.nl, self.device)
            acc, checks, _ = self._step(resident, prelude, tile,
                                        np.zeros((self.nl,), np.int64),
                                        acc)
            _raise_tile_checks(checks, 0)
            n_tiles = 1

        # cancel seam before the finalize's merge exchange
        fault_point("tiled_finalize")
        check_cancel()
        out = self._finalize(acc)
        self.report["n_tiles"] = n_tiles
        if ctx is not None:
            ctx.stamp_report(self.report)
        self._publish_report()
        return out


def _stack_acc(outs: list, like: dict):
    """Per-segment (cols, sel) results as one (nseg, capacity)
    accumulator, columns in ``like``'s order."""
    return ({n: torch.stack([o[0][n] for o in outs]) for n in like},
            torch.stack([o[1] for o in outs]))


class DistTopNTiledExecutable(DistTiledExecutable):
    """Distributed tiled statement with per-segment bounded top-N row
    accumulators: each segment's step merges its tile through one LOCAL
    bounding sort — no exchange beyond the spine's own motions — and
    finalize re-runs the original plan (pre-gather compaction, gather,
    global sort, LIMIT) over the accumulators."""

    _what = "distributed top-N tiled execution"

    def _groups_ceiling(self) -> int:
        return self.shape.g_cap  # fixed: LIMIT itself bounds the acc

    def _refresh_report(self) -> None:
        super()._refresh_report()
        self.report["mode"] = "topn"

    def _refinalize(self) -> None:
        # finalize re-runs the original post chain over m-row
        # accumulators: gather receive buffers were sized for the whole
        # stream, shrink them to nseg·m
        shape = self.shape
        for node in shape.post:
            if isinstance(node, N.PMotion):
                node.out_capacity = shape.g_cap * self.nseg

    def _init_acc(self):
        shape, dev, nseg = self.shape, self.device, self.nl
        cols = {f.name: torch.zeros((nseg, shape.g_cap),
                                    dtype=torch_dtype(f.type.np_dtype),
                                    device=dev)
                for f in shape.partial_plan.fields}
        return cols, torch.zeros((nseg, shape.g_cap), dtype=torch.bool,
                                 device=dev)

    def _step(self, resident, prelude, tile, tile_ns, acc):
        shape, dev = self.shape, self.device
        m = shape.g_cap
        mleaf = _AccLeaf()
        mleaf.fields = list(shape.partial_plan.fields)
        msort = N.PSort(mleaf, list(shape.sortnode.keys))
        msort.fields = list(mleaf.fields)
        names = [f.name for f in shape.partial_plan.fields]
        acc_cols, acc_sel = acc

        def seg_fn(low):
            pcols, psel = low.lower(shape.partial_plan)
            s = low.seg - self.lo
            n = psel.shape[0]
            ccols = {nm: torch.cat([acc_cols[nm][s],
                                    X._as_column(pcols[nm], n)])
                     for nm in names}
            csel = torch.cat([acc_sel[s], psel])
            low2 = _ReplacingLowerer({}, {id(mleaf): (ccols, csel)}, dev)
            scols, ssel = low2.lower(msort)
            low.checks.update(low2.checks)
            return {nm: scols[nm][:m] for nm in names}, ssel[:m]

        gang = self._step_gang(resident, prelude, tile, tile_ns)
        outs, checks, stats = gang.run_each(seg_fn)
        return _stack_acc(outs, acc_cols), checks, stats


class DistSortTiledExecutable(DistTiledExecutable):
    """Distributed external sort: each step is one gang run — every
    segment streams a tile of ITS shard through the spine (per-tile
    exchanges included) and emits its surviving rows plus order-normalized
    keys. The host pools all segments' rows (subsuming the plan's gather),
    one stable key sort is the merge pass, and the chain above the sort
    applies on the host."""

    _what = "distributed external-sort tiled execution"

    def _groups_ceiling(self) -> int:
        return 0  # no accumulator exists to grow

    def _refresh_report(self) -> None:
        super()._refresh_report()
        self.report["mode"] = "sort"

    def _sort_step(self, resident, prelude, tile, tile_ns):
        """One tile on every segment: ((nseg, n) columns, selection and
        keys, stacked), the reduced checks."""
        shape, dev = self.shape, self.device
        sort = shape.sortnode
        kchild = sort.child
        names = [f.name for f in shape.partial_plan.fields]

        def seg_fn(low):
            pcols, psel = low.lower(shape.partial_plan)
            n = psel.shape[0]
            keys = []
            for e, asc in sort.keys:
                arr = X._as_column(X._sortable(e, kchild, pcols, dev), n)
                u = K.sort_key_u64(arr)
                keys.append(u if asc else ~u)
            # the columns the spine produced: a filter under a window
            # stack can keep fields that column pruning removed below it
            out = {nm: X._as_column(pcols[nm], n) for nm in names
                   if nm in pcols}
            return out, psel, keys

        gang = self._step_gang(resident, prelude, tile, tile_ns)
        outs, checks, _ = gang.run_each(seg_fn)
        cols = {nm: torch.stack([o[0][nm] for o in outs])
                for nm in outs[0][0]}
        sel = torch.stack([o[1] for o in outs])
        keys = [torch.stack([o[2][i] for o in outs])
                for i in range(len(sort.keys))]
        return (cols, sel, keys), checks

    def _stream_sorted(self):
        """The per-segment tile stream and the host merge: (sorted child
        columns, sorted normalized keys, n_tiles, recovery ctx) as host
        arrays."""
        from cloudberry_tpu_torch.exec import recovery as R
        from cloudberry_tpu_torch.lifecycle import check_cancel

        ctx = R.begin(self, dist=True)
        R.agree_resume(ctx)
        if ctx is not None:
            ctx.prepare_dist()
        shape = self.shape
        resident = self._resident()
        prelude = self._prelude(resident)
        nkeys = len(shape.sortnode.keys)
        runs: dict[str, list] = {}   # keyed by the spine's columns
        key_runs: list[list] = [[] for _ in range(nkeys)]
        if ctx is not None:
            runs, key_runs = ctx.restore_runs(runs, key_runs)
        feed = (ctx.feed() if ctx is not None else None) \
            or _dist_tile_feed(shape.stream, self.session, self.tile_rows,
                               self.segs)
        n_base = ctx.tiles_base if ctx is not None else 0
        n_local = 0
        n_sub = 0
        timer = _TileTimer(self.session)
        tracker = _dist_progress_tracker(self, feed, n_base)
        pipe = TP.TilePipe(self.session, TP.effective_window(
            self.session.config, self._platform))
        stream = SP.maybe_pipeline(iter(feed), self.session.config,
                                   device=self.device,
                                   min_depth=pipe.window)

        def _verified(d):
            # one drained-clean tile's rows join the run store, segment by
            # segment (the host copies started at submit)
            nonlocal n_local
            tile_k, names, rows = d.payload
            n_local = tile_k
            tracker.step(tile_k)
            host = rows.wait()
            sel = host[len(names)].numpy()
            for s in range(self.nl):
                m = sel[s]
                for i, nm in enumerate(names):
                    runs.setdefault(nm, []).append(host[i][s].numpy()[m])
                for i in range(nkeys):
                    key_runs[i].append(
                        host[len(names) + 1 + i][s].numpy()[m])
            if ctx is not None:
                ctx.tick(tile_k,
                         lambda: R.runs_payload(runs, key_runs))

        try:
            for tile, tile_ns in stream:
                fault_point("tile_step_dist")
                fault_point("tile_device_lost")
                n_sub += 1
                with timer.step(n_base + n_sub - 1):
                    (pcols, psel, keys), checks = self._sort_step(
                        resident, prelude, tile, tile_ns)
                    del tile
                    rows = TP._HostCopy(list(pcols.values()) + [psel]
                                        + keys)
                    drained = pipe.submit(n_base + n_sub - 1, checks,
                                          (n_sub, list(pcols), rows))
                for d in drained:
                    _verified(d)
            for d in pipe.drain_all():
                _verified(d)
        finally:
            if pipe.deferred_fail:
                self._deferred_fail = True
            SP.close_feed(stream)
        SP.stamp_report(self.report, stream)
        timer.stamp(self.report)
        pipe.stamp(self.report)
        runs, key_runs = _pool_cluster_runs(runs, key_runs, self.nl)

        fault_point("tiled_finalize")
        check_cancel()
        cols, karr = merge_sorted_runs(runs, key_runs,
                                       shape.partial_plan.fields, nkeys)
        return cols, karr, max(n_base + n_local, 1), ctx

    def _run_once(self) -> ColumnBatch:
        _retile_dist(self.shape, self.tile_rows, self.nseg)
        shape = self.shape
        cols, _karr, n_tiles, ctx = self._stream_sorted()
        cols = host_apply_post(shape.post_above, cols)
        self.report["n_tiles"] = n_tiles
        if ctx is not None:
            ctx.stamp_report(self.report)
        self._publish_report()
        out_node = shape.post_above[0] if shape.post_above \
            else shape.sortnode
        return _host_batch(out_node, cols)


class DistWindowTiledExecutable(DistSortTiledExecutable):
    """Distributed window spill: phase one is the per-segment external-sort
    stream grouped by the stack's common partition keys; phase two packs
    whole partitions into fixed chunks and runs the ORIGINAL plan above
    the stream once per chunk (gather motions lower as the identity over
    the pooled host rows; chunks are independent, so no gang is
    needed)."""

    _what = "distributed windowed tiled execution"

    def _refresh_report(self) -> None:
        super()._refresh_report()
        self.report["mode"] = "window"

    def _chunk_fn(self):
        shape, dev = self.shape, self.device
        cap = self.tile_rows

        def run_chunk(chunk_cols, n_valid):
            sel = torch.arange(cap, device=dev) < n_valid
            low = _ReplacingLowerer(
                {}, {id(shape.replace_node): (chunk_cols, sel)}, dev)
            cols, osel = low.lower(shape.root)
            out = {f.name: cols[f.name] for f in shape.root.fields}
            return out, osel, low.checks

        return run_chunk

    def _run_once(self) -> ColumnBatch:
        _retile_dist(self.shape, self.tile_rows, self.nseg)
        shape = self.shape
        cols, karr, n_tiles, ctx = self._stream_sorted()
        names = [f.name for f in shape.partial_plan.fields
                 if f.name in cols]
        final, n_chunks = window_chunk_pass(
            self._chunk_fn(), shape.root, names, cols, karr,
            shape.n_ckeys, self.tile_rows, self.device)
        self.report["n_tiles"] = n_tiles
        self.report["n_chunks"] = n_chunks
        if ctx is not None:
            ctx.stamp_report(self.report)
        self._publish_report()
        return _host_batch(shape.root, final)


def _pool_cluster_runs(runs: dict, key_runs: list, nl: int):
    """Every process's host runs, in the one-process order (tile by tile,
    segment by segment), on every process of a cluster; the arguments in
    one process. Each process appended ``nl`` runs per drained tile, and
    every process drained the same tiles."""
    from cloudberry_tpu_torch.parallel.mesh import process_count

    if process_count() == 1:
        return runs, key_runs
    import torch.distributed as dist

    every = [None] * process_count()
    dist.all_gather_object(every, (runs, key_runs, nl))

    def interleave(lists):
        # lists[p]: process p's runs, tile-major
        n_tiles = len(lists[0]) // max(every[0][2], 1)
        return [r for t in range(n_tiles)
                for (_, _, n), runs_p in zip(every, lists)
                for r in runs_p[t * n:(t + 1) * n]]

    names = list(every[0][0])
    pooled = {nm: interleave([e[0].get(nm, []) for e in every])
              for nm in names}
    keys = [interleave([e[1][i] for e in every])
            for i in range(len(key_runs))]
    return pooled, keys


# -------------------------------------------------------------- tile feed


def _empty_dist_tile(scan: N.PScan, tile_rows: int, nseg: int,
                     device) -> dict:
    """One all-zero (nseg, tile_rows) tile at the scan's column types (an
    empty stream's single masked step)."""
    t = {}
    for phys, out in scan.column_map.items():
        t[phys] = torch.zeros(
            (nseg, tile_rows),
            dtype=torch_dtype(scan.field(out).type.np_dtype), device=device)
    for phys in scan.mask_map:
        t[f"$nn:{phys}"] = torch.zeros((nseg, tile_rows), dtype=torch.bool,
                                       device=device)
    return t


def _dist_progress_tracker(exe, feed, n_base: int):
    """Live-progress feeder for a distributed tile loop
    (obs/progress.py): one lane per segment — the loop runs lock-step, so
    the longest shard sets the tile count. A resumed feed contributes its
    remaining per-shard counts and the consumed-mask population as the
    base; the fresh feed derives lanes from the shard counts."""
    from cloudberry_tpu_torch.obs.progress import TileTracker, stream_rows

    session = exe.session
    total = stream_rows(exe.shape.stream, session)
    base_rows = 0
    if hasattr(feed, "counts") and hasattr(feed, "base_mask"):
        lanes = np.asarray(feed.counts)
        base_rows = int(np.asarray(feed.base_mask).sum())
    else:
        try:
            lanes = np.asarray(session.shard_counts(
                exe.shape.stream.table_name))
        except KeyError:
            lanes = np.asarray([total])
    return TileTracker(lanes, exe.tile_rows, n_base=n_base,
                       base_rows=base_rows, rows_total=total)


def _dist_tile_feed(scan: N.PScan, session, tile_rows: int, segs: range):
    """Yield (tile dict of (local segments, tile_rows) columns, their
    valid counts) for this process's segments ``segs`` (every segment in
    one process). All segments of the cluster step in lock-step (the
    longest shard of the whole table, which every process holds, sets
    the tile count); a segment whose shard ran dry contributes masked
    rows. A packed feed tile resident in the buffer pool
    (exec/bufferpool.py, keyed by tile offset, the segments and the
    table's content token) is served from its device copy; a hot miss
    is admitted."""
    st = session.sharded_table(scan.table_name)
    nseg, shard_cap = len(st.counts), st.capacity
    lo, hi = segs.start, segs.stop
    bpool = BUF.pool_for(session)
    cols_key = (tuple(sorted(scan.column_map)),
                tuple(sorted(scan.mask_map)), (lo, hi))
    log = getattr(session, "stmt_log", None)
    counts = np.asarray(st.counts)[lo:hi]
    cols: Optional[dict] = None  # built lazily: an all-hit feed never
    max_rows = int(st.counts.max()) if len(st.counts) else 0
    for off in range(0, max(max_rows, 0), tile_rows):
        n = min(tile_rows, max_rows - off)
        tile_ns = np.clip(counts - off, 0, tile_rows)
        key = None
        if bpool is not None:
            try:
                key = BUF.dist_tile_key(session, scan.table_name,
                                        cols_key, nseg, tile_rows, off)
            except KeyError:  # table dropped mid-plan: fall through
                key = None
        if key is not None:
            ent = bpool.lookup(key, log)
            if ent is not None:
                yield dict(ent["tile"]), tile_ns
                continue
        if cols is None:
            cols = {}
            for phys in scan.column_map:
                cols[phys] = np.asarray(st.columns[phys])[lo:hi]
            for phys in scan.mask_map:
                vm = st.columns.get(f"$nn:{phys}")
                cols[f"$nn:{phys}"] = (
                    np.asarray(vm)[lo:hi] if vm is not None
                    else np.ones((hi - lo, shard_cap), dtype=np.bool_))
        tile = {}
        for name, arr in cols.items():
            sl = arr[:, off:off + n]
            if n < tile_rows:
                sl = np.concatenate(
                    [sl, np.zeros((hi - lo, tile_rows - n),
                                  dtype=arr.dtype)], axis=1)
            tile[name] = np.ascontiguousarray(sl)
        if key is not None:
            bpool.offer(key, {"tile": tile}, table=scan.table_name,
                        log=log, device=session.device)
        yield tile, tile_ns
