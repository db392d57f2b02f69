"""Tiled (out-of-core) execution — the workfile-manager / spill analog.

The reference survives bigger-than-memory queries by spilling operator
state to workfiles (src/backend/utils/workfile_manager/workfile_mgr.c, the
batch discipline of nodeHash.c). The JAX package moves the spill boundary
to PLAN TIME, and the port follows it decision for decision: when the
admission estimate (exec/resource.py) refuses a plan, this module
re-plans it as a STREAM OF FIXED-SHAPE TILES —

- the plan's big probe-side scan becomes the tile stream: host RAM (or
  micro-partition files, for cold tables) holds the table; the device only
  ever sees one tile of ``tile_rows`` rows (plus the scan pipeline's and
  the dispatch window's staged tiles). The streamed table is never
  uploaded whole;
- every spine join's build subtree is computed ONCE by a prelude (lowered
  through the port's ``Lowerer``, with its kernel gates) and its
  (bounded, estimated-and-admitted) result tensors stay resident;
- one STEP runs per tile: spine joins/filters/projections, a partial
  aggregation, and a merge into a fixed-capacity accumulator through
  ``executor.merge_group_aggregate`` (the sorted-segment kernel where
  eligible) — partials merge associatively
  (plan/distribute.py:_split_aggs), so any tile order and count gives the
  same answer;
- a finalize applies the post-aggregation chain (HAVING / ORDER BY /
  LIMIT / avg = sum/count) to the accumulator.

Other modes: top-N (ORDER BY + LIMIT: a bounded accumulator of the best
rows), sort (a full ORDER BY: rows and order-normalized keys collected in
host memory, one stable host key sort as the merge pass) and window
(the sort stream grouped by the common partition keys, then whole
partitions windowed in fixed-capacity chunks on the device).

Tile rows, mode, accumulator capacity and the decision to tile or decline
all come from the JAX package's planner code and ``estimate_plan_memory``,
so both engines decide the same on the same plan. Per-tile capacities
keep the checked-overflow discipline: a tile that overflows its join or
group buffers raises, and the adaptive loop grows the buffer (or halves
the tile) and re-runs — never truncation. The admitted step estimate
bounds resident builds + one tile's working set + the accumulator.

Telemetry: every step feeds the ``tile_seconds`` histogram, a
``tile-step`` span on a traced statement and the report's ``tile_time``
summary (``_TileTimer``); drained tiles feed the statement's live
progress (``TileTracker``); store decodes feed ``decode_seconds``.

A distributed plan (``n_segments > 1``) tiles in exec/tiled_dist.py over
the gang of segment lowerers; ``SkewSentinel`` watches its redistributes'
per-tile destination counts and asks the session for a mid-statement
replan when the cumulative skew crosses the alarm.

Device loss: the ``tile_device_lost`` seam fires once per tile, beside
``tile_step``. The session's retry (parallel/health.py ``run_with_retry``)
re-dispatches the statement, and its new executable resumes from the
last K-tile checkpoint (exec/recovery.py) — on fewer segments when the
probe degraded them.
"""

from __future__ import annotations

import threading
import time
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
from cloudberry_tpu_torch.exec.expr_compile import torch_dtype
from cloudberry_tpu_torch.exec.resource import estimate_plan_memory
from cloudberry_tpu_torch.parallel.transport import cluster_all
from cloudberry_tpu_torch.plan import expr as ex
from cloudberry_tpu_torch.plan import nodes as N
from cloudberry_tpu_torch.plan.distribute import (_all_exprs,
                                                  _finalize_project,
                                                  _split_aggs)
from cloudberry_tpu_torch.utils.faultinject import fault_point

_MAX_TILE = 1 << 22
_MIN_TILE = 1 << 12

# The tiled modes that snapshot carried state into the recovery store
# (_TileShape.mode values whose tick() paths checkpoint).
# exec/recovery.py REPLACEABLE must cover every entry: the plan verifier
# (plan/verify.py recovery-mode-unreplaceable) holds the two tables
# together both ways, so a new checkpointing mode cannot ship without a
# re-placement rule.
CHECKPOINT_MODES = ("agg", "topn", "sort", "window")

class _AccLeaf(N.PlanNode):
    """Plan leaf standing for the accumulator in the finalize program."""

    def title(self):
        return "TileAccumulator"


@dataclass
class _TileShape:
    """Everything the rewrite discovered about the plan. "agg" streams into
    a partial-aggregation accumulator; "topn" into a fixed top-N row
    accumulator; "sort" and "window" into host run stores."""

    agg: Optional[N.PAgg]             # the streamed aggregation (agg mode)
    post: list[N.PlanNode]            # chain above agg/sort, root first
    spine: list[N.PlanNode]           # agg.child .. just above the stream
    stream: N.PScan                   # the tiled scan
    builds: list[N.PlanNode]          # spine joins' build subtrees
    stream_rows: int = 0              # whole-stream rows (floor scaling)
    partial_plan: N.PlanNode = None   # type: ignore[assignment]
    merge_specs: list = field(default_factory=list)
    finalize: dict = field(default_factory=dict)
    root: N.PlanNode = None           # type: ignore[assignment]
    g_cap: int = 0                    # accumulator capacity (groups / rows)
    mode: str = "agg"
    sortnode: Optional[N.PSort] = None  # topn/sort: the (synthetic) sort
    winnode: Optional[N.PWindow] = None  # window mode: BOTTOM of the stack
    wintop: Optional[N.PWindow] = None   # window mode: TOP of the stack
    n_ckeys: int = 0                  # window mode: chunk-key count


def plan_tiled(plan: N.PlanNode, session) -> Optional["TiledExecutable"]:
    """Try to re-plan an admission-refused statement for tiled execution.
    Returns None when the plan shape or the budget cannot support it. A
    distributed plan tiles over the segment gang (exec/tiled_dist.py)."""
    if not session.config.resource.enable_spill:
        return None
    if session.config.n_segments > 1:
        from cloudberry_tpu_torch.exec.tiled_dist import plan_tiled_dist

        return plan_tiled_dist(plan, session)
    if getattr(plan, "_direct_segment", None) is not None:
        return None
    from cloudberry_tpu_torch.exec.joinindex import (restore_join_index,
                                                     stash_join_index,
                                                     strip_join_index)
    from cloudberry_tpu_torch.plan.pointlookup import unbind_point_lookups

    # the tile stream and resident loads key inputs by TABLE NAME: a
    # point-sliced scan would miss its $pt input — restore full scans
    unbind_point_lookups(plan)
    shape = _analyze(plan)
    if shape is None:
        return None
    # whole-run growth marks are meaningless at tile scale and would
    # poison the per-tile floor — the adaptive loop re-learns spine buffer
    # sizes itself. Build-side joins keep theirs: the prelude computes
    # whole builds.
    for node in shape.spine:
        if isinstance(node, N.PJoin) and hasattr(node, "_min_out_cap"):
            del node._min_out_cap
    # join-index inputs are a one-shot feature: the tiled programs
    # assemble their own inputs. The strip is speculative: a decline
    # restores the stash so the one-shot fallback keeps its indexes.
    stash = stash_join_index(plan)
    strip_join_index(plan)
    t = _plan_by_mode(shape, session)
    if t is None:
        restore_join_index(stash)
    return t


def _plan_by_mode(shape: "_TileShape", session):
    if shape.mode == "topn":
        t = _plan_topn(shape, session)
        if t is not None:
            return t
        # the LIMIT+OFFSET exceeds any resident accumulator: fall back to
        # the full external sort and apply the limit host-side
        shape.mode = "sort"
        shape.g_cap = 0
    if shape.mode == "sort":
        return _plan_sort(shape, session)
    if shape.mode == "window":
        return _plan_window(shape, session)
    try:
        partial_aggs, final_aggs, finalize = _split_aggs(shape.agg.aggs)
    except ValueError:
        return None  # an aggregate with no partial/merge decomposition
    shape.finalize = finalize
    shape.merge_specs = [K.AggSpec(call.func, name)
                         for name, call in final_aggs]

    # Accumulator capacity: the binder's agg capacity is the worst case
    # (child rows). Size from the NDV-based group estimate with 4×
    # headroom; a merge overflow at runtime grows it and retries.
    from cloudberry_tpu_torch.plan.cost import estimate_rows

    est_groups = estimate_rows(shape.agg, session.catalog)
    shape.g_cap = int(min(shape.agg.capacity,
                          max(1024, 4 * int(est_groups) + 1)))

    # per-tile partial aggregation over the spine
    partial = N.PAgg(shape.agg.child, shape.agg.group_keys, partial_aggs,
                     capacity=shape.agg.capacity, mode="partial")
    partial.fields = [
        N.PlanField(n, e.dtype, _expr_dict(shape.agg.child, e))
        for n, e in shape.agg.group_keys
    ] + [N.PlanField(n, c.dtype, None) for n, c in partial_aggs]
    shape.partial_plan = partial

    budget = session.config.resource.query_mem_bytes
    tile_rows = _choose_tile(shape, budget)
    if tile_rows is None:
        return None

    # finalize plan: (acc leaf) -> finalize project -> original post chain
    leaf = _AccLeaf()
    leaf.fields = list(partial.fields)
    fproj = _finalize_project(leaf, shape.agg, finalize)
    if shape.post:
        shape.post[-1].child = fproj
        shape.root = shape.post[0]
    else:
        shape.root = fproj

    return TiledExecutable(shape, session, tile_rows, budget)


def _plan_topn(shape: _TileShape, session) -> Optional["TopNTiledExecutable"]:
    """Top-N streaming: the accumulator holds the best LIMIT+OFFSET rows of
    the sort's child so far; each tile merges through one bounding sort
    (tuplesort bounded-heap role, nodeSort.c). The post chain above the
    sort (LIMIT, projections) finalizes over the sorted accumulator."""
    sort = shape.sortnode
    shape.partial_plan = sort.child
    budget = session.config.resource.query_mem_bytes
    tile_rows = _choose_tile(shape, budget)
    if tile_rows is None:
        return None  # LIMIT too large for a resident accumulator

    # merge program plan: bounding sort over (acc ∪ tile output)
    mleaf = _AccLeaf()
    mleaf.fields = list(sort.child.fields)
    msort = N.PSort(mleaf, list(sort.keys))
    msort.fields = list(mleaf.fields)
    shape.finalize = {"mleaf": mleaf, "msort": msort}

    # finalize plan: (sorted acc leaf) -> original post chain above sort
    fleaf = _AccLeaf()
    fleaf.fields = list(sort.child.fields)
    shape.post[-1].child = fleaf  # post is non-empty: the LIMIT lives there
    shape.root = shape.post[0]
    return TopNTiledExecutable(shape, session, tile_rows, budget)


def host_post_ok(nodes, sort_keys=None) -> bool:
    """True when a chain above a spilled sort can apply HOST-SIDE after the
    merge pass: column-pruning projections, LIMIT/OFFSET, gather motions
    (no-ops) and sorts on the same keys (already satisfied by the merge
    order)."""
    for nd in nodes:
        if isinstance(nd, N.PLimit):
            continue
        if isinstance(nd, N.PProject) and all(
                isinstance(e, ex.ColumnRef) for _, e in nd.exprs):
            continue
        if isinstance(nd, N.PMotion) and nd.kind == "gather":
            continue
        if sort_keys is not None and isinstance(nd, N.PSort) \
                and repr(nd.keys) == repr(sort_keys):
            continue
        return False
    return True


def host_apply_post(nodes, cols: dict) -> dict:
    """Apply a host_post_ok-validated chain bottom-up over host arrays
    (gathers and merge-order sorts are no-ops here)."""
    for node in reversed(nodes):
        if isinstance(node, N.PLimit):
            total = len(next(iter(cols.values()))) if cols else 0
            lo = min(node.offset, total)
            cols = {nm: a[lo:lo + node.limit] for nm, a in cols.items()}
        elif isinstance(node, N.PProject):
            cols = {out: cols[e.name] for out, e in node.exprs}
    return cols


def merge_sorted_runs(runs: dict, key_runs: list, fields, nkeys: int):
    """The external sort's merge pass: one stable host key sort over the
    pooled runs (np.lexsort: LAST key is primary). Keys are the port's
    biased int64 sort keys (kernels.sort_key_u64), whose signed order is
    the reference's unsigned order. Returns (sorted columns, sorted
    keys)."""
    names = list(runs)
    if not names or not any(len(r) for r in runs[names[0]]):
        cols = {f.name: np.zeros((0,), dtype=f.type.np_dtype)
                for f in fields}
        return cols, [np.zeros((0,), dtype=np.int64)
                      for _ in range(nkeys)]
    karr = [np.concatenate(kr) for kr in key_runs]
    order = np.lexsort(tuple(reversed(karr)))
    cols = {nm: np.concatenate(runs[nm])[order] for nm in names}
    return cols, [k[order] for k in karr]


def _full_sort_shape(chain: list):
    """Unbounded ORDER BY shape: the lowest sort, with only a
    host-applicable chain above it — the external-sort path. Returns the
    sort node, or None when the chain has a different shape."""
    sort_i = next((i for i in range(len(chain) - 1, -1, -1)
                   if isinstance(chain[i], N.PSort)), None)
    if sort_i is None:
        return None
    if any(not isinstance(n, (N.PProject, N.PFilter))
           for n in chain[sort_i + 1:]):
        return None
    if not host_post_ok(chain[:sort_i], chain[sort_i].keys):
        return None
    return chain[sort_i]


def _plan_sort(shape: _TileShape,
               session) -> Optional["SortTiledExecutable"]:
    """Full external sort: stream the spine, keep every surviving row (plus
    order-normalized keys) in host RAM, one stable key sort as the merge
    pass, then apply the post chain host-side."""
    # the topn fallback arrives here WITHOUT _full_sort_shape's chain
    # validation: re-check that everything above the sort is
    # host-applicable
    if not host_post_ok(shape.post, shape.sortnode.keys):
        return None
    shape.partial_plan = shape.sortnode.child
    budget = session.config.resource.query_mem_bytes
    tile_rows = _choose_tile(shape, budget)
    if tile_rows is None:
        return None
    shape.root = shape.post[0] if shape.post else shape.sortnode
    return SortTiledExecutable(shape, session, tile_rows, budget)


def _plan_window(shape: _TileShape,
                 session) -> Optional["WindowTiledExecutable"]:
    """Window spill: phase one is the external-sort stream grouped by the
    partition keys COMMON to every spec in the stack; phase two windows
    whole-partition chunks on the device. A stack with no common partition
    key is one giant partition — it cannot stream."""
    bottom = shape.winnode
    common = {repr(pk): pk for pk in bottom.partition_keys}
    node = shape.wintop
    while isinstance(node, N.PWindow):
        here = {repr(pk) for pk in node.partition_keys}
        common = {k: v for k, v in common.items() if k in here}
        node = node.child
    if not common:
        return None
    ckeys = list(common.values())
    srt = N.PSort(bottom.child, [(ck, True) for ck in ckeys])
    srt.fields = list(bottom.child.fields)
    shape.sortnode = srt
    shape.n_ckeys = len(ckeys)
    shape.partial_plan = bottom.child
    budget = session.config.resource.query_mem_bytes
    tile_rows = _choose_tile(shape, budget)
    if tile_rows is None:
        return None
    shape.root = shape.post[0] if shape.post else shape.wintop
    return WindowTiledExecutable(shape, session, tile_rows, budget)


def _topn_bound(chain: list, skip: tuple = ()):
    """Locate a topn-streamable post chain's bounding sort and LIMIT: the
    LOWEST sort, fed only by projections/filters, with a LIMIT above it
    separated only by projections and ``skip`` nodes (gather motions, on
    the distributed path). Returns (sortnode, limit+offset) or None."""
    sort_i = next((i for i in range(len(chain) - 1, -1, -1)
                   if isinstance(chain[i], N.PSort)), None)
    if sort_i is None:
        return None
    if any(not isinstance(n, (N.PProject, N.PFilter))
           for n in chain[sort_i + 1:]):
        return None
    m = None
    for n in reversed(chain[:sort_i]):
        if isinstance(n, (N.PProject,) + skip):
            continue
        if isinstance(n, N.PLimit):
            m = n.limit + n.offset
        break
    if m is None or m <= 0:
        return None
    return chain[sort_i], m


def _analyze(plan: N.PlanNode) -> Optional[_TileShape]:
    """Recognize a streamable shape: a post chain over one aggregation
    ("agg"), one bounding ORDER BY + LIMIT ("topn"), a full ORDER BY
    ("sort") or a window stack ("window"), over a join/filter spine whose
    probe path ends at a scan."""
    for e in _all_exprs(plan):
        for sub in ex.walk(e):
            if isinstance(sub, ex.SubqueryScalar):
                return None  # subquery plans scan outside the spine budget

    chain: list[N.PlanNode] = []
    cur = plan
    while isinstance(cur, (N.PProject, N.PSort, N.PLimit, N.PFilter)):
        chain.append(cur)
        cur = cur.child

    agg: Optional[N.PAgg] = None
    sortnode: Optional[N.PSort] = None
    winnode: Optional[N.PWindow] = None
    post: list[N.PlanNode] = []
    m = 0
    if isinstance(cur, N.PAgg) and cur.mode == "single":
        agg = cur
        post = chain
        spine_top = agg.child
    elif isinstance(cur, N.PWindow):
        # window mode: a stack of window specs over the spine; above it
        # only column-pruning projections
        if any(not (isinstance(nd, N.PProject) and all(
                isinstance(e, ex.ColumnRef) for _, e in nd.exprs))
               for nd in chain):
            return None
        post = chain
        wintop = cur
        while isinstance(cur, N.PWindow):
            winnode = cur
            cur = cur.child
        spine_top = cur
    else:
        hit = _topn_bound(chain)
        if hit is not None:
            sortnode, m = hit
        else:
            # no bounding LIMIT: full external sort (host-RAM workfile)
            sortnode = _full_sort_shape(chain)
            if sortnode is None:
                return None
            m = 0
        post = chain[:chain.index(sortnode)]
        spine_top = sortnode.child

    spine: list[N.PlanNode] = []
    builds: list[N.PlanNode] = []
    cur = spine_top
    # graftlint: ignore[seam-loop] bounded plan-tree descent (one step per node, no blocking calls) — terminates with the tree, never a tile/retry loop
    while True:
        if isinstance(cur, (N.PFilter, N.PProject)):
            spine.append(cur)
            cur = cur.child
        elif isinstance(cur, N.PRuntimeFilter):
            spine.append(cur)
            cur = cur.child
        elif isinstance(cur, N.PJoin):
            if cur.kind == "full":
                # FULL joins emit unmatched BUILD rows — once per
                # statement, not once per tile
                return None
            spine.append(cur)
            builds.append(cur.build)
            cur = cur.probe
        elif isinstance(cur, N.PScan) and cur.table_name != "$dual":
            rows = cur.num_rows if cur.num_rows >= 0 else cur.capacity
            shape = _TileShape(agg, post, spine, cur, builds,
                               stream_rows=max(rows, 1))
            if winnode is not None:
                shape.mode = "window"
                shape.winnode = winnode
                shape.wintop = wintop
            elif agg is None:
                shape.mode = "topn" if m else "sort"
                shape.sortnode = sortnode
                shape.g_cap = m
            return shape
        else:
            return None


def _retile(shape: _TileShape, tile_rows: int) -> None:
    """Set the stream scan to one tile and re-derive spine capacities (the
    planner's formulas, per tile instead of whole): expansion joins keep
    the NDV pair-estimate floor scaled to the tile fraction, and a
    runtime-grown buffer (_min_out_cap, set by grow_expansion) is never
    shrunk back."""
    frac = tile_rows / max(shape.stream_rows, 1)
    shape.stream.capacity = tile_rows
    cap = tile_rows
    for node in reversed(shape.spine):
        if isinstance(node, N.PJoin):
            bcap = _out_cap(node.build)
            est = getattr(node, "_est_pairs", None)
            floor = int(2 * est * min(frac, 1.0)) + 8 if est else 0
            floor = max(floor, getattr(node, "_min_out_cap", 0))
            if node.residual is not None:
                # pairs expand internally; output rides the probe capacity
                node.out_capacity = max(bcap + cap, floor)
            elif not node.unique_build:
                node.out_capacity = max(bcap + cap, floor)
                cap = node.out_capacity
    if shape.agg is not None:
        shape.partial_plan.capacity = min(shape.g_cap, max(cap, 1))


def _out_cap(node: N.PlanNode) -> int:
    if isinstance(node, (N.PScan, N.PAgg)):
        return node.capacity
    if isinstance(node, N.PJoin):
        if not node.unique_build:
            return node.out_capacity
        return _out_cap(node.probe)
    if isinstance(node, N.PMotion):
        return node.out_capacity or _out_cap(node.child)
    if isinstance(node, N.PConcat):
        return sum(_out_cap(c) for c in node.inputs)
    kids = node.children()
    return max((_out_cap(c) for c in kids), default=1)


def _acc_width(shape: _TileShape) -> int:
    return 1 + sum(f.type.np_dtype.itemsize
                   for f in shape.partial_plan.fields)


def _step_out_cap(shape) -> int:
    """Rows one tile's step can emit into the merge."""
    return shape.partial_plan.capacity if shape.mode == "agg" \
        else _out_cap(shape.partial_plan)


def _merge_bytes(shape: _TileShape) -> int:
    """Accumulator + merge working set: the concat of acc and per-tile rows
    flowing through one sort-based group aggregate (agg mode) or one
    bounding sort (topn mode)."""
    return 3 * (shape.g_cap + _step_out_cap(shape)) * _acc_width(shape)


def _choose_tile(shape: _TileShape, budget: int) -> Optional[int]:
    """Largest power-of-two tile whose estimated step memory fits: the
    spill-file-count decision of workfile_mgr, made at plan time."""
    t = _MAX_TILE
    while t >= _MIN_TILE:
        _retile(shape, t)
        est = estimate_plan_memory(shape.partial_plan).peak_bytes
        if est + _merge_bytes(shape) <= budget:
            return t
        t >>= 1
    return None


# --------------------------------------------------------------- lowerers


class _ReplacingLowerer(X.Lowerer):
    """Lowerer with a node-identity substitution table: nodes whose ids
    appear in ``replace`` lower to the given (cols, sel) instead of being
    walked (prelude-computed builds, the accumulator leaf)."""

    def __init__(self, tables, replace: dict, device):
        super().__init__(tables, device)
        self._replace = replace

    def lower(self, node: N.PlanNode):
        hit = self._replace.get(id(node))
        if hit is not None:
            return hit
        return super().lower(node)


class _TileLowerer(_ReplacingLowerer):
    """Step lowerer: the stream scan reads the tile input; spine builds
    read their prelude-computed tensors."""

    def __init__(self, tables, stream: N.PScan, tile_n: int, replace: dict,
                 device):
        super().__init__(tables, replace, device)
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


class _TileTimer:
    """Per-tile step timing: each step's wall (host clock: the step's
    enqueue, plus the drains the dispatch window makes it wait for) feeds
    the engine ``tile_seconds`` histogram — so tile-time regressions show
    in the session's metrics without an instrumented rerun — and, when
    the statement is traced, a per-tile span; ``stamp()`` summarizes the
    distribution onto the run report for EXPLAIN ANALYZE's tiled trailer.
    Bounded by construction: one fixed-size histogram, and spans ride the
    trace's own cap."""

    def __init__(self, session):
        from cloudberry_tpu_torch.obs.metrics import _Hist

        self._log = getattr(session, "stmt_log", None)
        self._h = _Hist()

    def step(self, idx: int):
        import contextlib

        from cloudberry_tpu_torch.obs import trace as OT

        @contextlib.contextmanager
        def _cm():
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self._h.add(dt)
                if self._log is not None and self._log.obs_enabled:
                    self._log.registry.observe("tile_seconds", dt)
                OT.mark("tile-step", t0, tile=idx)

        return _cm()

    def stamp(self, report: dict) -> None:
        if self._h.n:
            report["tile_time"] = {
                "count": self._h.n,
                "mean": round(self._h.total / self._h.n, 6),
                "p95": self._h.quantile(0.95),
            }


def _progress_tracker(exe, n_base: int, skip: int):
    """Live-progress feeder for a tile loop (obs/progress.py): one lane —
    the remaining row prefix of the deterministic stream. A no-op object
    when the statement carries no Progress (obs off, or no lifecycle
    scope)."""
    from cloudberry_tpu_torch.obs.progress import TileTracker, stream_rows

    total = stream_rows(exe.shape.stream, exe.session)
    return TileTracker(max(total - skip, 0), exe.tile_rows,
                       n_base=n_base, base_rows=min(skip, total),
                       rows_total=total)


class SkewSentinel:
    """Mid-statement adaptive-replan watcher for tiled distributed runs.

    Each distributed step already sums every redistribute's
    per-destination row counts over the segments (the gang's ``seg rows``
    stat); the sentinel accumulates those vectors on the host across
    tiles and, when the CUMULATIVE distribution crosses the skew alarm
    (``config.feedback.replan_skew_ratio``, 0 = inherit
    ``config.obs.skew_ratio``), asks the session to re-plan the rest of
    the statement: it folds the observed counts into the feedback store
    as a partial sketch, force-checkpoints the carried state
    (exec/recovery.py) and raises ``TileReplan``. Correctness never
    depends on it — an adaptation that cannot checkpoint disarms and the
    run finishes on the static plan.

    Guard rails, in check order: feature off / no recovery scope / too
    few tiles seen (``min_tiles``) / statement replan budget spent
    (``max_replans``) / no motion alarmed / ``tile_replan`` fault seam
    armed / checkpoint save failed."""

    def __init__(self, exe, motions, ctx):
        cfg = getattr(exe.session.config, "feedback", None)
        self.exe = exe
        self.session = exe.session
        self.motions = motions
        self.ctx = ctx
        self.min_tiles = cfg.min_tiles if cfg is not None else 2
        self.max_replans = cfg.max_replans if cfg is not None else 0
        self.threshold = float(
            (cfg.replan_skew_ratio or exe.session.config.obs.skew_ratio)
            if cfg is not None else 0.0)
        # collect: accumulate telemetry for the end-of-run fold (the
        # learning half works even with adaptation off); armed: the
        # mid-statement replan trigger itself
        self.collect = bool(cfg is not None and cfg.enabled and motions)
        self.armed = bool(
            self.collect and cfg.adaptive and ctx is not None
            and self.threshold > 0.0)
        self.cum = [np.zeros(exe.nseg, dtype=np.int64) for _ in motions]
        self.demand = [0] * len(motions)

    def observe(self, stats) -> None:
        """Fold one tile's per-motion (required-bucket scalar, summed
        per-destination row vector) pairs, host values in the order of
        ``self.motions``."""
        if not self.collect:
            return
        # one host fetch per tile, counted: when feedback is off (or the
        # plan has no redistribute) the loop never passes stats in, so
        # this stays 0
        log = getattr(self.session, "stmt_log", None)
        if log is not None:
            log.bump("tile_stat_syncs")
        for i, (bucket, rows) in enumerate(stats):
            self.demand[i] = max(self.demand[i], int(np.asarray(bucket)))
            self.cum[i] += np.asarray(rows, dtype=np.int64)

    def _pin(self) -> bool:
        """Stamp the cumulative observations onto the partial plan's
        motions the way record_motion_stats does for the one-shot path;
        True when anything flowed."""
        any_rows = False
        for m, c, d in zip(self.motions, self.cum, self.demand):
            if int(c.sum()) > 0:
                m._seg_rows = c.copy()
                any_rows = True
            if d > 0:
                # per-TILE demand, not cumulative: the rung a re-seeded
                # tiled run needs is the largest single-tile bucket
                m._observed_bucket = max(
                    d, getattr(m, "_observed_bucket", 0) or 0)
        return any_rows

    def fold_final(self) -> None:
        """End-of-run fold: the one-shot distributed path folds in
        ``dist_executor.finish_run``, the tiled stream folds here."""
        if not self.collect:
            return
        from cloudberry_tpu_torch.plan import feedback as FB

        if self._pin():
            FB.fold_plan(self.session, self.exe.shape.partial_plan)

    def _worst(self):
        worst = None
        for m, c in zip(self.motions, self.cum):
            total = int(c.sum())
            if total <= 0:
                continue
            ratio = float(c.max()) * len(c) / total
            if ratio >= self.threshold and (worst is None
                                            or ratio > worst[1]):
                worst = (m, ratio)
        return worst

    def maybe_replan(self, tiles_local: int, payload_fn,
                     settle=None) -> None:
        """Raise TileReplan when the cumulative distribution alarms and the
        adaptation can resume safely; no-op otherwise.

        ``settle`` is the windowed-dispatch hook (exec/tilepipe.py): a
        zero-arg callable that drains every in-flight tile (folding their
        observations) and returns the new drained-tile count. The alarm
        fires on DRAINED telemetry, but the snapshot must capture the
        carried accumulator, which is the newest dispatched step's —
        settling first makes every dispatched tile verified-clean, so
        ``payload_fn`` (the live accumulator) and ``tiles_local`` agree
        again. At window=1 the queue is already empty."""
        import time as _t

        from cloudberry_tpu_torch.exec import recovery as R
        from cloudberry_tpu_torch.lifecycle import current_handle
        from cloudberry_tpu_torch.obs import trace as OT

        if not self.armed or tiles_local < self.min_tiles:
            return
        session = self.session
        # the replan budget rides the STATEMENT handle (Session.sql
        # re-dispatches under the same one), and only handles the session
        # marked adaptation-safe (reads) may restart
        handle = current_handle()
        if handle is None or not getattr(handle, "adaptive_ok", False):
            return
        if getattr(handle, "tile_replans", 0) >= self.max_replans:
            return
        worst = self._worst()
        if worst is None:
            return
        # the alarm reads the cluster's reduced telemetry, so every
        # process of a cluster reaches this point alike; what follows is
        # local (the seam, the snapshot save) and is agreed before a
        # process acts on it
        if not cluster_all(not fault_point("tile_replan")):
            self.armed = False      # seam: suppress the adaptation
            return
        if settle is not None:
            # drain the in-flight window: a check that fires here aborts
            # the replan and rides the normal adaptive-retry path
            tiles_local = settle()
            worst = self._worst()
            if worst is None:       # the tail un-alarmed the ratio
                return
        # publish what was seen BEFORE restarting: pin the cumulative
        # counts on the partial plan's motions and fold a partial sketch —
        # the re-planned statement prices against it
        from cloudberry_tpu_torch.plan import feedback as FB

        self._pin()
        FB.fold_plan(session, self.exe.shape.partial_plan, partial=True)
        # the replanned run must resume from HERE, not re-stream: a failed
        # save disarms the sentinel and the static plan finishes
        if not cluster_all(self.ctx.force_snapshot(tiles_local,
                                                   payload_fn)):
            self.armed = False
            return
        handle.tile_replans = getattr(handle, "tile_replans", 0) + 1
        log = getattr(session, "stmt_log", None)
        if log is not None:
            log.bump("tile_replans")
        OT.mark("tile-replan", _t.perf_counter(),
                tile=tiles_local, ratio=round(worst[1], 3))
        raise R.TileReplan(
            f"[tile {tiles_local}] cumulative redistribute skew "
            f"{worst[1]:.2f}x crossed the adaptive replan alarm "
            f"{self.threshold:.2f}x; carried state checkpointed",
            tiles_done=tiles_local, ratio=worst[1])


class AdaptiveTiledMixin:
    """The adaptive-retry discipline of the tiled executables: classify a
    detected overflow, grow the guilty buffer (accumulator / join pair
    buffer) or shrink the tile, and re-run — the increase-nbatch-and-rescan
    loop of nodeHash.c, never truncation."""

    _what = "tiled execution"

    def refresh_bufpool_charge(self) -> None:
        """Re-stamp the report's ``est_bufpool_bytes``: the report is
        built once per compile, but the pool's residency for the streamed
        table moves between statements — dispatch-time capacity recording
        and report publication both re-read it."""
        self.report["est_bufpool_bytes"] = _bufpool_charge(
            self.session, self.shape.stream.table_name)

    def _publish_report(self) -> None:
        self.refresh_bufpool_charge()
        self.session.last_tiled_report = dict(self.report)

    def _run_adaptive(self) -> ColumnBatch:
        from cloudberry_tpu_torch.lifecycle import check_cancel

        while True:
            # each adaptive round restarts the tile stream — a cancelled
            # statement stops between rounds
            check_cancel()
            try:
                return self._run_once()
            except X.ExecError as e:
                msg = str(e)
                shape = self.shape
                if not msg.startswith("[tile"):
                    # prelude/finalize failure: expansion overflows grow
                    # that join's pair buffer and retry
                    if not X.grow_expansion(shape.partial_plan, msg):
                        raise
                elif ("merge overflow" in msg
                      or "aggregation overflow" in msg):
                    # more groups than estimated: grow the accumulator and
                    # restart the stream — never truncate
                    ceiling = self._groups_ceiling()
                    if shape.g_cap >= ceiling:
                        raise
                    shape.g_cap = min(shape.g_cap * 2, ceiling)
                elif "expansion overflow" in msg:
                    # a tile's join fanout blew its pair buffer: grow that
                    # join when the budget allows, else halve the tile
                    if not (self._try_grow(msg)
                            or self._try_halve_tile()):
                        raise
                elif "redistribute overflow" in msg:
                    # an estimate-sized bucket overflowed inside a tile:
                    # smaller tiles shrink every per-tile send bound
                    if not self._try_halve_tile():
                        raise
                else:
                    raise
                self._agree_retry()
                if getattr(self, "_deferred_fail", False):
                    # the failed check had been outrun by newer in-flight
                    # steps (exec/tilepipe.py): this retry IS the
                    # deferred-failure replay, resuming from the last
                    # drained-clean checkpoint
                    self._deferred_fail = False
                    self.session.stmt_log.bump("tile_window_replays")
                self._compiled = None
                self._refresh_report()
                # a grown accumulator may blow the step budget: smaller
                # tiles buy the room back before giving up
                while self._over_budget() and self._try_halve_tile():
                    self._refresh_report()
                if self._over_budget():
                    raise X.ExecError(
                        f"{self._what} working set (accumulator "
                        f"{shape.g_cap} groups, tile {self.tile_rows} "
                        "rows) exceeds the query memory budget "
                        f"{self.budget >> 20} MiB; raise "
                        "config.resource.query_mem_bytes") from e

    def _over_budget(self) -> bool:
        return self.report["est_step_bytes"] > self.budget

    def _agree_retry(self) -> None:
        """Hook: line a retry's sizes up across processes (the
        distributed executables; nothing in one process)."""

    def _try_grow(self, msg: str) -> bool:
        """Grow the overflowing spine join's pair buffer if the grown step
        still fits the budget; revert (and report False) otherwise."""
        node = X.find_expansion_node(self.shape.partial_plan, msg)
        if node is None:
            return False
        old = getattr(node, "_min_out_cap", 0)
        node._min_out_cap = max(node.out_capacity * 4, 64)
        self._refresh_report()
        if self.report["est_step_bytes"] <= self.budget:
            return True
        node._min_out_cap = old
        self._refresh_report()
        return False

    def _try_halve_tile(self) -> bool:
        if self.tile_rows <= _MIN_TILE:
            return False
        self.tile_rows >>= 1
        return True


class TiledExecutable(AdaptiveTiledMixin):
    """A tiled statement: prelude (once) → step (per tile) → finalize.
    ``report`` records the spill decision."""

    def __init__(self, shape: _TileShape, session, tile_rows: int,
                 budget: int):
        self.shape = shape
        self.session = session
        self.tile_rows = tile_rows
        self.budget = budget
        self.device = session.device
        self._platform = session.device.type
        self._compiled = None
        # retries mutate shared plan capacities, so runs serialize
        self._run_lock = threading.Lock()
        self._refresh_report()

    def _refresh_report(self) -> None:
        shape = self.shape
        _retile(shape, self.tile_rows)
        est = estimate_plan_memory(shape.partial_plan).peak_bytes
        merge_bytes = _merge_bytes(shape)
        self.report = {
            "tiled": True,
            "stream_table": shape.stream.table_name,
            "tile_rows": self.tile_rows,
            "acc_capacity": shape.g_cap,
            "est_step_bytes": est + merge_bytes,
            # scan-pipeline staging plus the dispatch window's extra
            # in-flight tiles
            "est_pipeline_bytes": SP.queue_charge_bytes(
                shape.stream, self.tile_rows, self.session.config)
            + TP.window_charge_bytes(
                shape.stream, self.tile_rows, self.session.config,
                self._platform),
            # buffer-pool residency attributable to the streamed table
            "est_bufpool_bytes": _bufpool_charge(
                self.session, shape.stream.table_name),
            "budget_bytes": self.budget,
        }

    # ------------------------------------------------------------ programs

    def _resident_inputs(self) -> dict:
        """All step inputs except the tile: whole (non-stream) tables and
        pruned store reads — the one-shot inputs minus the stream."""
        scans = [s for s in X.scans_of(self._whole_plan())
                 if s is not self.shape.stream]
        store_scans = [s for s in scans if X.keyed_scan(s)]
        names = sorted({s.table_name for s in scans
                        if not X.keyed_scan(s)})
        return X.assemble_inputs(names, store_scans, self.session)

    def _whole_plan(self) -> N.PlanNode:
        # scans live under the partial plan (spine + builds); the post
        # chain/finalize reference only aggregate outputs
        return self.shape.partial_plan

    def _prelude_fn(self):
        shape, dev = self.shape, self.device

        def prelude_fn(tables):
            low = X.Lowerer(tables, dev)
            outs = [low.lower_shared(b) for b in shape.builds]
            return outs, low.checks

        return prelude_fn

    def _lower_tile(self, resident, prelude, tile, tile_n):
        """The spine over one tile: (partial columns, selection, checks)."""
        shape = self.shape
        tables = dict(resident)
        tables["$tile"] = tile
        replace = {id(b): prelude[i] for i, b in enumerate(shape.builds)}
        low = _TileLowerer(tables, shape.stream, tile_n, replace,
                           self.device)
        pcols, psel = low.lower(shape.partial_plan)
        return pcols, psel, dict(low.checks)

    def _finalize_fn(self):
        shape, dev = self.shape, self.device

        def finalize_fn(acc):
            acc_cols, acc_sel = acc
            low = _ReplacingLowerer(
                {}, {id(_leaf_of(shape.root)): (acc_cols, acc_sel)}, dev)
            cols, sel = low.lower(shape.root)
            out = {f.name: cols[f.name] for f in shape.root.fields}
            return out, sel, low.checks

        return finalize_fn

    def _compile(self):
        if self._compiled is not None:
            return self._compiled
        shape = self.shape
        group_names = [n for n, _ in shape.agg.group_keys]
        specs = shape.merge_specs
        g_cap = shape.g_cap

        def step_fn(resident, prelude, tile, tile_n, acc):
            pcols, psel, checks = self._lower_tile(resident, prelude, tile,
                                                   tile_n)
            acc_cols, acc_sel = acc
            agg_vals = {s.out_name: torch.cat(
                [acc_cols[s.out_name], pcols[s.out_name]]) for s in specs}
            sel = torch.cat([acc_sel, psel])
            if group_names:
                key_cols = {n: torch.cat([acc_cols[n], pcols[n]])
                            for n in group_names}
                # the same kernel-or-sort dispatch the one-shot executor
                # uses: eligible integer sums are bit-identical either way
                ok, oa, osel, n_groups = X.merge_group_aggregate(
                    key_cols, agg_vals, specs, sel, g_cap)
                checks["tile merge overflow: more groups than capacity "
                       f"{g_cap}; raise the aggregation capacity"] = \
                    n_groups > g_cap
                return ({**ok, **oa}, osel), checks
            out = K.global_aggregate(agg_vals, specs, sel)
            return (out, torch.ones((1,), dtype=torch.bool,
                                    device=self.device)), checks

        self._compiled = (self._prelude_fn(), step_fn, self._finalize_fn())
        return self._compiled

    def _init_acc(self):
        shape, dev = self.shape, self.device
        g_cap = shape.g_cap
        group_names = {n for n, _ in shape.agg.group_keys}
        cols = {}
        if group_names:
            for f in shape.partial_plan.fields:
                cols[f.name] = torch.zeros(
                    (g_cap,), dtype=torch_dtype(f.type.np_dtype), device=dev)
            return cols, torch.zeros((g_cap,), dtype=torch.bool, device=dev)
        for f, spec in zip(
                [f for f in shape.partial_plan.fields
                 if f.name not in group_names], shape.merge_specs):
            dt = np.dtype(f.type.np_dtype)
            if spec.func == "min":
                ident = np.finfo(dt).max if np.issubdtype(dt, np.floating) \
                    else np.iinfo(dt).max
            elif spec.func == "max":
                ident = np.finfo(dt).min if np.issubdtype(dt, np.floating) \
                    else np.iinfo(dt).min
            else:
                ident = 0
            cols[f.name] = torch.full((1,), ident, dtype=torch_dtype(dt),
                                      device=dev)
        # identity row stays unselected: min/max identities must not leak
        # into the merge as real values when a tile contributes rows
        return cols, torch.zeros((1,), dtype=torch.bool, device=dev)

    # ----------------------------------------------------------------- run

    def run(self) -> ColumnBatch:
        X.build_kernels(self.session)
        with self._run_lock:
            return self._run_adaptive()

    def _groups_ceiling(self) -> int:
        return self.shape.agg.capacity

    def _run_once(self) -> ColumnBatch:
        from cloudberry_tpu_torch.exec import recovery as R

        prelude_fn, step_fn, finalize_fn = self._compile()
        resident = self._resident_inputs()
        prelude, pchecks = prelude_fn(resident)
        X.raise_checks(pchecks)

        # resume from the last K-tile checkpoint of this statement (the
        # deferred-failure replay) instead of re-streaming the table
        ctx = R.begin(self)
        acc = self._init_acc()
        if ctx is not None:
            acc = ctx.restore_acc(acc)
        skip = ctx.skip_rows if ctx is not None else 0
        n_base = ctx.tiles_base if ctx is not None else 0
        n_local = 0
        n_sub = 0
        timer = _TileTimer(self.session)
        tracker = _progress_tracker(self, n_base, skip)
        pipe = TP.TilePipe(self.session, TP.effective_window(
            self.session.config, self._platform))
        feed = _tile_feed(self.shape.stream, self.session,
                          self.tile_rows, skip_rows=skip,
                          min_depth=pipe.window)

        def _verified(d):
            # host effects for ONE drained-clean tile, in stream order:
            # progress, then the K-tile checkpoint tick (a staged payload
            # when the submit saw the boundary coming; the live
            # accumulator at window=1, where the drain is synchronous and
            # acc IS this tile's state)
            nonlocal n_local
            tile_k, staged = d.payload
            n_local = tile_k
            tracker.step(tile_k)
            if ctx is not None:
                ctx.tick(tile_k, staged if staged is not None
                         else (lambda: R.acc_payload(acc)))

        try:
            for tile, tile_n in feed:
                fault_point("tile_step")
                fault_point("tile_device_lost")
                n_sub += 1
                stage = (ctx is not None and pipe.window > 1
                         and ctx.snapshot_due(n_sub))
                with timer.step(n_base + n_sub - 1):
                    acc, checks = step_fn(resident, prelude, tile, tile_n,
                                          acc)
                    del tile
                    staged = TP.stage_checkpoint(acc) if stage else None
                    drained = pipe.submit(n_base + n_sub - 1, checks,
                                          (n_sub, staged))
                for d in drained:
                    _verified(d)
            for d in pipe.drain_all():
                _verified(d)
        finally:
            # teardown on EVERY exit (cancel, overflow retry): the reader
            # joins and staged tiles release
            if pipe.deferred_fail:
                self._deferred_fail = True
            SP.close_feed(feed)
        SP.stamp_report(self.report, feed)
        n_tiles = n_base + n_local
        timer.stamp(self.report)
        pipe.stamp(self.report)
        if n_tiles == 0:  # empty stream: one all-masked tile seeds the acc
            empty = _empty_tile(self.shape.stream, self.tile_rows,
                                self.device)
            acc, checks = step_fn(resident, prelude, empty, 0, acc)
            _raise_tile_checks(checks, 0)
            n_tiles = 1

        fault_point("tiled_finalize")
        from cloudberry_tpu_torch.lifecycle import check_cancel

        check_cancel()
        cols, sel, fchecks = finalize_fn(acc)
        X.raise_checks(fchecks)
        self.report["n_tiles"] = n_tiles
        if ctx is not None:
            ctx.stamp_report(self.report)
        self._publish_report()
        return X.make_batch(self.shape.root, cols, sel)


class TopNTiledExecutable(TiledExecutable):
    """Tiled statement whose accumulator is the best LIMIT+OFFSET rows seen
    so far (nodeSort.c bounded-heap role): step = spine over one tile,
    then one bounding sort over (accumulator ∪ tile rows), keeping the
    first g_cap positions — selected rows sort first, so the slice is
    exactly the running top-N. Finalize runs the original post chain over
    the sorted accumulator."""

    _what = "top-N tiled execution"

    def _groups_ceiling(self) -> int:
        return self.shape.g_cap  # fixed: LIMIT itself bounds the acc

    def _init_acc(self):
        shape, dev = self.shape, self.device
        cols = {f.name: torch.zeros((shape.g_cap,),
                                    dtype=torch_dtype(f.type.np_dtype),
                                    device=dev)
                for f in shape.partial_plan.fields}
        return cols, torch.zeros((shape.g_cap,), dtype=torch.bool,
                                 device=dev)

    def _refresh_report(self) -> None:
        super()._refresh_report()
        self.report["mode"] = "topn"

    def _compile(self):
        if self._compiled is not None:
            return self._compiled
        shape, dev = self.shape, self.device
        m = shape.g_cap
        mleaf, msort = shape.finalize["mleaf"], shape.finalize["msort"]
        names = [f.name for f in shape.partial_plan.fields]

        def step_fn(resident, prelude, tile, tile_n, acc):
            pcols, psel, checks = self._lower_tile(resident, prelude, tile,
                                                   tile_n)
            acc_cols, acc_sel = acc
            ccols = {n: torch.cat([acc_cols[n],
                                   X._as_column(pcols[n], psel.shape[0])])
                     for n in names}
            csel = torch.cat([acc_sel, psel])
            low2 = _ReplacingLowerer({}, {id(mleaf): (ccols, csel)}, dev)
            scols, ssel = low2.lower(msort)
            checks.update(low2.checks)
            return ({n: scols[n][:m] for n in names}, ssel[:m]), checks

        self._compiled = (self._prelude_fn(), step_fn, self._finalize_fn())
        return self._compiled


class SortTiledExecutable(TiledExecutable):
    """Tiled statement whose result is a FULL ORDER BY with no bounding
    limit — the external-merge-sort analog (tuplesort.c spill mode, with
    host RAM as the tape). Per tile, the step runs the spine and emits the
    rows with one order-normalized key column per sort key (the same
    normalization ``kernels.sort_indices`` uses; descending keys
    bit-complement). The rows and keys copy to pinned host memory behind
    an event at submit; at the tile's drain the host keeps its selected
    rows in the run store. The merge pass is one stable host key sort over
    the runs, then the post chain applies host-side."""

    _what = "external-sort tiled execution"

    def _groups_ceiling(self) -> int:
        return 0  # no accumulator exists to grow

    def _refresh_report(self) -> None:
        shape = self.shape
        _retile(shape, self.tile_rows)
        est = estimate_plan_memory(shape.partial_plan).peak_bytes
        self.report = {
            "tiled": True,
            "mode": "sort",
            "stream_table": shape.stream.table_name,
            "tile_rows": self.tile_rows,
            "acc_capacity": 0,
            "est_step_bytes": est + _merge_bytes(shape),
            "est_pipeline_bytes": SP.queue_charge_bytes(
                shape.stream, self.tile_rows, self.session.config)
            + TP.window_charge_bytes(
                shape.stream, self.tile_rows, self.session.config,
                self._platform),
            "est_bufpool_bytes": _bufpool_charge(
                self.session, shape.stream.table_name),
            "budget_bytes": self.budget,
        }

    def _compile(self):
        if self._compiled is not None:
            return self._compiled
        shape, dev = self.shape, self.device
        sort = shape.sortnode
        names = [f.name for f in sort.child.fields]

        def step_fn(resident, prelude, tile, tile_n):
            pcols, psel, checks = self._lower_tile(resident, prelude, tile,
                                                   tile_n)
            n = psel.shape[0]
            keys = []
            for e, asc in sort.keys:
                arr = X._as_column(X._sortable(e, sort.child, pcols, dev), n)
                u = K.sort_key_u64(arr)
                keys.append(u if asc else ~u)
            # the columns the spine produced: a filter under a window stack
            # can keep fields that column pruning removed below it in its
            # field list (the JAX package's step raises KeyError there)
            out = {nm: X._as_column(pcols[nm], n) for nm in names
                   if nm in pcols}
            return (out, psel, keys), checks

        self._compiled = (self._prelude_fn(), step_fn)
        return self._compiled

    def _stream_sorted(self):
        """Run the tile stream and the merge pass; returns (sorted child
        columns, sorted key columns, n_tiles, recovery ctx) as host
        arrays."""
        from cloudberry_tpu_torch.exec import recovery as R

        prelude_fn, step_fn = self._compile()
        shape = self.shape
        resident = self._resident_inputs()
        prelude, pchecks = prelude_fn(resident)
        X.raise_checks(pchecks)

        ctx = R.begin(self)
        nkeys = len(shape.sortnode.keys)
        runs: dict[str, list] = {}   # keyed by the spine's columns
        key_runs: list[list] = [[] for _ in range(nkeys)]
        if ctx is not None:
            runs, key_runs = ctx.restore_runs(runs, key_runs)
        skip = ctx.skip_rows if ctx is not None else 0
        n_base = ctx.tiles_base if ctx is not None else 0
        n_local = 0
        n_sub = 0
        timer = _TileTimer(self.session)
        tracker = _progress_tracker(self, n_base, skip)
        pipe = TP.TilePipe(self.session, TP.effective_window(
            self.session.config, self._platform))
        feed = _tile_feed(shape.stream, self.session,
                          self.tile_rows, skip_rows=skip,
                          min_depth=pipe.window)

        def _verified(d):
            # one drained-clean tile: the run-store appends happen HERE
            # (the host copies started at submit), so the host collects
            # tile k's rows while later tiles compute; the checkpoint
            # payload is the runs themselves
            nonlocal n_local
            tile_k, names, rows = d.payload
            n_local = tile_k
            tracker.step(tile_k)
            host = rows.wait()
            mask = host[len(names)].numpy()
            for i, nm in enumerate(names):
                runs.setdefault(nm, []).append(host[i].numpy()[mask])
            for i in range(nkeys):
                key_runs[i].append(host[len(names) + 1 + i].numpy()[mask])
            if ctx is not None:
                ctx.tick(tile_k,
                         lambda: R.runs_payload(runs, key_runs))

        try:
            for tile, tile_n in feed:
                fault_point("tile_step")
                fault_point("tile_device_lost")
                n_sub += 1
                with timer.step(n_base + n_sub - 1):
                    (pcols, psel, keys), checks = step_fn(
                        resident, prelude, tile, tile_n)
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
            SP.close_feed(feed)
        SP.stamp_report(self.report, feed)
        timer.stamp(self.report)
        pipe.stamp(self.report)

        fault_point("tiled_finalize")
        from cloudberry_tpu_torch.lifecycle import check_cancel

        check_cancel()
        cols, karr = merge_sorted_runs(runs, key_runs,
                                       shape.sortnode.child.fields, nkeys)
        return cols, karr, max(n_base + n_local, 1), ctx

    def _run_once(self) -> ColumnBatch:
        shape = self.shape
        cols, _karr, n_tiles, ctx = self._stream_sorted()
        cols = host_apply_post(shape.post, cols)
        self.report["n_tiles"] = n_tiles
        if ctx is not None:
            ctx.stamp_report(self.report)
        self._publish_report()
        out_node = shape.post[0] if shape.post else shape.sortnode
        return _host_batch(out_node, cols)


class WindowTiledExecutable(SortTiledExecutable):
    """Tiled window functions — the nodeWindowAgg.c spill analog. Phase one
    reuses the external-sort stream, ordered by the common partition keys,
    so the host holds every surviving spine row grouped by partition.
    Phase two packs WHOLE partitions into fixed-capacity chunks and runs
    the original window (+ projection chain) on the device once per chunk:
    window functions never cross partitions, so chunks are independent and
    every frame kind stays exact. Only a single partition larger than the
    chunk capacity cannot stream; that raises."""

    _what = "windowed tiled execution"

    def _refresh_report(self) -> None:
        super()._refresh_report()
        self.report["mode"] = "window"

    def _chunk_fn(self):
        shape, dev = self.shape, self.device
        win = shape.winnode
        cap = self.tile_rows

        def run_chunk(chunk_cols, n_valid):
            sel = torch.arange(cap, device=dev) < n_valid
            low = _ReplacingLowerer({}, {id(win.child): (chunk_cols, sel)},
                                    dev)
            cols, osel = low.lower(shape.root)
            out = {f.name: cols[f.name] for f in shape.root.fields}
            return out, osel, low.checks

        return run_chunk

    def _run_once(self) -> ColumnBatch:
        shape = self.shape
        cols, karr, n_tiles, ctx = self._stream_sorted()
        names = [f.name for f in shape.winnode.child.fields
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


def window_chunk_pass(run, root, names, cols, karr, npk, cap, device):
    """Phase two of window spill: pack WHOLE partitions (runs of equal
    normalized chunk keys) into fixed-capacity chunks and feed each through
    the window program ``run`` on ``device``. Returns (output columns, chunk
    count)."""
    out_fields = root.fields
    n = len(cols[names[0]]) if names else 0
    if n == 0:
        return ({f.name: np.zeros((0,), dtype=f.type.np_dtype)
                 for f in out_fields}, 0)
    new_part = np.zeros(n, dtype=bool)
    new_part[0] = True
    for k in karr[:npk]:
        new_part[1:] |= k[1:] != k[:-1]
    starts = np.flatnonzero(new_part)
    sizes = np.diff(np.append(starts, n))
    if sizes.max(initial=0) > cap:
        raise X.ExecError(
            f"windowed tiled execution: one partition holds "
            f"{int(sizes.max())} rows, more than the {cap}-row chunk "
            "the memory budget allows; raise "
            "config.resource.query_mem_bytes")
    outs: dict[str, list] = {f.name: [] for f in out_fields}
    n_chunks = 0
    chunk_lo = chunk_hi = 0

    def flush(lo, hi):
        nonlocal n_chunks
        if hi <= lo:
            return
        m = hi - lo
        chunk = {}
        for nm in names:
            a = cols[nm][lo:hi]
            if m < cap:
                a = np.concatenate(
                    [a, np.zeros((cap - m,), dtype=a.dtype)])
            chunk[nm] = torch.from_numpy(
                np.ascontiguousarray(a)).to(device)
        ocols, osel, checks = run(chunk, m)
        _raise_tile_checks(checks, n_chunks)
        n_chunks += 1
        mask = osel.cpu().numpy()
        for nm in outs:
            outs[nm].append(X._as_column(ocols[nm], cap).cpu().numpy()[mask])

    for s, size in zip(starts, sizes):
        if chunk_hi - chunk_lo + size > cap and chunk_hi > chunk_lo:
            flush(chunk_lo, chunk_hi)
            chunk_lo = s
        chunk_hi = s + size
    flush(chunk_lo, chunk_hi)
    final = {nm: np.concatenate(arrs) if arrs else
             np.zeros((0,), dtype=root.field(nm).type.np_dtype)
             for nm, arrs in outs.items()}
    return final, n_chunks


def _host_batch(node: N.PlanNode, cols: dict) -> ColumnBatch:
    """A result batch from host arrays whose rows are all selected."""
    n_out = len(next(iter(cols.values()))) if cols else 0
    return X.make_batch(node, {k: torch.from_numpy(np.asarray(v))
                               for k, v in cols.items()},
                        torch.ones((n_out,), dtype=torch.bool))


def _leaf_of(root: N.PlanNode) -> N.PlanNode:
    cur = root
    while not isinstance(cur, _AccLeaf):
        cur = cur.child  # post chain + finalize project are all unary
    return cur


def _raise_tile_checks(checks: dict, tile_idx: int) -> None:
    """The per-tile cancel seam (the CHECK_FOR_INTERRUPTS analog) and the
    tile's checks: host flags (a drained tile) or device tensors (a window
    chunk, read in one transfer)."""
    from cloudberry_tpu_torch.lifecycle import check_cancel

    check_cancel()
    if not checks:
        return
    vals = list(checks.values())
    if any(torch.is_tensor(v) for v in vals):
        flags = TP._flags(checks).cpu().numpy()
    else:
        flags = [bool(np.asarray(v).any()) for v in vals]
    for msg, bad in zip(checks, flags):
        if bad:
            raise X.ExecError(f"[tile {tile_idx}] {msg}")


def _expr_dict(plan: N.PlanNode, e: ex.Expr):
    if isinstance(e, ex.ColumnRef):
        try:
            return plan.field(e.name).sdict
        except KeyError:
            return None
    return None


# -------------------------------------------------------------- tile feed


def _phys_cols(scan: N.PScan) -> list[str]:
    return sorted(set(scan.column_map) | set(scan.mask_map))


def _empty_tile(scan: N.PScan, tile_rows: int, device) -> dict:
    """One all-zero tile at the scan's column types (an empty stream's
    single masked step)."""
    t = {}
    for phys, out in scan.column_map.items():
        t[phys] = torch.zeros((tile_rows,),
                              dtype=torch_dtype(scan.field(out).type.np_dtype),
                              device=device)
    for phys in scan.mask_map:
        t[f"$nn:{phys}"] = torch.zeros((tile_rows,), dtype=torch.bool,
                                       device=device)
    return t


def _tile_feed(scan: N.PScan, session, tile_rows: int,
               skip_rows: int = 0, min_depth: int = 1):
    """The tile feed: (tile dict of device tensors, n_valid) items, through
    the asynchronous scan pipeline when ``config.scan_pipeline`` enables
    it (exec/scanpipe.py; tile order and content are the synchronous
    feed's, bit-identical on/off). Cold tables stream micro-partition files
    (the device never holds more than the staged tiles); warm tables slice
    their host RAM arrays. ``skip_rows`` drops the already-consumed prefix
    — the checkpoint resume entry point. Callers must close the feed
    (scanpipe.close_feed) on every exit."""
    stats = SP.ScanStats()
    if hasattr(scan, "_store_parts"):
        gen = _store_tiles(scan, session, tile_rows, skip_rows, stats)
    else:
        gen = _ram_tiles(scan, session, tile_rows, skip_rows)
    # min_depth: a prefetch queue shallower than the dispatch window would
    # starve the window it exists to feed
    return SP.maybe_pipeline(gen, session.config, device=session.device,
                             stats=stats, min_depth=min_depth)


def _ram_tiles(scan: N.PScan, session, tile_rows: int,
               skip_rows: int = 0):
    """Warm-table tile producer: slices of the host RAM arrays."""
    t = session.catalog.table(scan.table_name)
    t.ensure_loaded()
    cols = {phys: np.asarray(t.data[phys]) for phys in scan.column_map}
    for phys in scan.mask_map:
        vm = t.validity.get(phys)
        cols[f"$nn:{phys}"] = (np.asarray(vm, dtype=np.bool_)
                               if vm is not None
                               else np.ones(t.num_rows, dtype=np.bool_))
    rows = t.num_rows
    for off in range(min(skip_rows, max(rows, 0)), max(rows, 0),
                     tile_rows):
        n = min(tile_rows, rows - off)
        yield _pad_tile(cols, off, n, tile_rows), n


class _PendBuf:
    """Offset-cursor ring over decoded or pooled partition chunks.
    ``take(n)`` copies ONLY the emitted rows — each row at most once. A
    tile covering a chunk EXACTLY hands the chunk over zero-copy;
    partial-chunk host tiles copy rather than emit a view (a view's base is
    the whole decoded partition column, and the prefetch queue would pin
    partitions, not tiles). Device chunks (the buffer pool's tensors) are
    sliced as views — the pool holds them anyway — and a tile whose pieces
    include a device chunk becomes a ``scanpipe.Mixed`` column, assembled on
    the device by the scan pipeline's stage. ``skip(n)`` advances the
    cursor without touching a byte (the resume prefix)."""

    def __init__(self, stats=None):
        self._names: Optional[list[str]] = None
        self._chunks: dict[str, list] = {}
        self._lens: list[int] = []
        self._off = 0           # consumed rows of the FIRST chunk
        self.rows = 0           # rows pending past the cursor
        self._stats = stats

    def append(self, cols: dict) -> None:
        n = len(next(iter(cols.values()))) if cols else 0
        if self._names is None:
            self._names = list(cols)
            self._chunks = {nm: [] for nm in self._names}
        if n == 0:
            return
        for nm in self._names:
            self._chunks[nm].append(cols[nm])
        self._lens.append(n)
        self.rows += n

    def _plan(self, n: int):
        """Slice plan [(chunk_idx, lo, hi)] covering the next n rows, plus
        the advanced cursor (chunks_to_drop, new_offset)."""
        plan = []
        i, off, need = 0, self._off, n
        while need > 0:
            length = self._lens[i]
            t = min(length - off, need)
            plan.append((i, off, off + t))
            need -= t
            off += t
            if off == length:
                i += 1
                off = 0
        return plan, i, off

    def _advance(self, drop: int, off: int, n: int) -> None:
        for _ in range(drop):
            self._lens.pop(0)
            for nm in self._names:
                self._chunks[nm].pop(0)
        self._off = off
        self.rows -= n

    def skip(self, n: int) -> None:
        _, drop, off = self._plan(n)
        self._advance(drop, off, n)

    def take(self, n: int) -> dict:
        plan, drop, off = self._plan(n)
        whole = (len(plan) == 1 and plan[0][1] == 0
                 and plan[0][2] == self._lens[plan[0][0]])
        out = {}
        for nm in self._names:
            chunks = self._chunks[nm]
            if whole:
                out[nm] = chunks[plan[0][0]]
                continue
            parts = [chunks[i][lo:hi] for i, lo, hi in plan]
            if all(isinstance(p, np.ndarray) for p in parts):
                out[nm] = parts[0].copy() if len(parts) == 1 \
                    else np.concatenate(parts)
            elif len(parts) == 1:
                out[nm] = parts[0]          # a view of a pooled tensor
            else:
                out[nm] = SP.Mixed(parts, 0)
        if self._stats is not None:
            if whole:
                self._stats.view_rows += n
            else:
                self._stats.copy_rows += n
        self._advance(drop, off, n)
        return out


def _bufpool_charge(session, table: str) -> int:
    """The buffer pool's resident bytes for one table — the tiled report's
    ``est_bufpool_bytes``."""
    bpool = BUF.pool_for(session)
    return bpool.table_bytes(table) if bpool is not None else 0


def _pool_chunk(scan: N.PScan, ent: dict) -> dict:
    """One feed chunk from a buffer-pool entry or a fresh decode (the
    canonical ``{"cols", "validity"}`` split), so pooled and decoded chunks
    are interchangeable bit for bit."""
    cols, validity = ent["cols"], ent["validity"]
    n = len(next(iter(cols.values()))) if cols else 0
    chunk = {}
    for phys in scan.column_map:
        chunk[phys] = cols[phys]
    for phys in scan.mask_map:
        vm = validity.get(phys)
        chunk[f"$nn:{phys}"] = (vm if vm is not None
                                else np.ones(n, dtype=np.bool_))
    return chunk


def _store_tiles(scan: N.PScan, session, tile_rows: int,
                 skip_rows: int = 0, stats=None):
    """``_decoded_tiles`` holding the shared decode pool for as long as the
    generator lives (released when it finishes or is closed)."""
    pool = SP.decode_pool(session.config)
    try:
        yield from _decoded_tiles(scan, session, tile_rows, skip_rows,
                                  stats, pool)
    finally:
        SP.release_decode_pool(pool)


def _decoded_tiles(scan: N.PScan, session, tile_rows: int, skip_rows: int,
                   stats, pool):
    """Stream a pruned cold scan part by part, re-chunked to tile_rows: the
    out-of-core path — peak host memory is one partition + the pipeline's
    bounded staging. A resume's ``skip_rows`` drops whole consumed
    partitions WITHOUT reading them. Partitions resident in the device
    buffer pool (exec/bufferpool.py) are served from the device copy — no
    read, no decode, no upload; only misses go to the store (and hot
    misses are admitted for next time)."""
    store = session.catalog.store
    needed = _phys_cols(scan)
    stats = stats if stats is not None else SP.ScanStats()
    bpool = BUF.pool_for(session)
    cols_key = tuple(needed)
    log = session.stmt_log
    obs = log.obs_enabled
    buf = _PendBuf(stats)
    skip_left = max(int(skip_rows), 0)

    parts = list(scan._store_parts)
    start = 0
    for part in parts:
        eff = int(part["num_rows"]) - len(part.get("deleted") or ())
        if skip_left < eff:
            break
        skip_left -= eff
        start += 1
        stats.parts_skipped += 1

    def drain(final: bool):
        nonlocal skip_left
        if skip_left > 0 and buf.rows > 0:
            t = min(skip_left, buf.rows)
            buf.skip(t)  # sub-partition resume remainder: cursor only
            skip_left -= t
        while buf.rows >= tile_rows or (final and buf.rows > 0):
            take = min(tile_rows, buf.rows)
            yield _pad_tile(buf.take(take), 0, take, tile_rows), take

    for part in parts[start:]:
        key = None
        if bpool is not None:
            key = BUF.partition_key(session, scan.table_name, part,
                                    cols_key)
            ent = bpool.lookup(key, log)
            if ent is not None:
                # device hit: the decoded chunk is already on the device
                stats.parts_resident += 1
                buf.append(_pool_chunk(scan, ent))
                yield from drain(final=False)
                continue
        fault_point("scan_decode")
        dts: list = []  # per-column decode seconds (list.append: atomic)
        t0 = time.perf_counter()
        cols, validity = store.read_partitions(
            scan.table_name, [part], needed, pool=pool,
            on_decode=dts.append)
        stats.read_s += time.perf_counter() - t0
        stats.parts_read += 1
        stats.decode_s += sum(dts)
        log.bump("partitions_decoded")
        if obs:
            for dt in dts:
                log.registry.observe("decode_seconds", dt)
        ent = {"cols": {c: np.asarray(v) for c, v in cols.items()},
               "validity": {c: np.asarray(v, dtype=np.bool_)
                            for c, v in validity.items()}}
        chunk = _pool_chunk(scan, ent)
        stats.bytes_decoded += sum(int(a.nbytes) for a in chunk.values())
        if bpool is not None:
            bpool.offer(key, ent, table=scan.table_name, log=log,
                        device=session.device)
        buf.append(chunk)
        yield from drain(final=False)
    yield from drain(final=True)


def _pad_tile(cols: dict, off: int, n: int, tile_rows: int) -> dict:
    """Rows [off, off+n) of each column, zero-padded to ``tile_rows``. A
    device column covering the tile exactly passes through; a device
    column that needs padding, and a Mixed one, stay Mixed (assembled on
    the device)."""
    out = {}
    for name, arr in cols.items():
        if isinstance(arr, SP.Mixed):
            arr.pad += tile_rows - n
            out[name] = arr
            continue
        if not isinstance(arr, np.ndarray):
            if off == 0 and n == tile_rows and len(arr) == tile_rows:
                out[name] = arr
            else:
                out[name] = SP.Mixed([arr[off:off + n]], tile_rows - n)
            continue
        sl = arr[off:off + n]
        if n < tile_rows:
            sl = np.concatenate(
                [sl, np.zeros((tile_rows - n,), dtype=arr.dtype)])
        out[name] = np.ascontiguousarray(sl)
    return out
