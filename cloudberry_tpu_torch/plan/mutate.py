"""Seeded plan-IR corruption classes — the planck verifier's fuzz
corpus (the test_lint seeded-bug-fixture discipline applied to the plan
layer).

Each mutation is one TARGETED way a plan invariant can rot: drop a
motion, lie about a hash key, desync a param slot, undercut a capacity
rung, forge a join-index stamp. ``MUTATIONS`` maps a corruption class
to (sql, mutate_fn, expected rule ids); the tests plan
the statement fresh, applies the corruption, and pins that
plan/verify.py catches it with a node-path finding carrying one of the
expected rules. A mutation returns a human-readable description of what
it broke (and the mutated plan root), or None when the planned shape
does not contain its target pattern — the test treats None as a broken
fixture, not a skip, so the corpus can never silently go stale.

These corruptions are what an incorrect planner CHANGE would produce:
every class was chosen so that, had the verifier not existed, the
mutated plan would run and return silently wrong rows (or blow up
mid-exchange) at 8 segments.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

from cloudberry_tpu_torch.plan import expr as ex
from cloudberry_tpu_torch.plan import nodes as N
from cloudberry_tpu_torch.plan.sharding import Sharding

# ------------------------------------------------------------- helpers


def _nodes(plan: N.PlanNode):
    # ONE child-enumeration source for the whole engine — a new node
    # class extends all_nodes once and every mutation sees it
    from cloudberry_tpu_torch.exec.executor import all_nodes

    seen: set[int] = set()
    for node in all_nodes(plan):
        if id(node) not in seen:
            seen.add(id(node))
            yield node


def _parents(plan: N.PlanNode) -> dict:
    out = {}
    for node in _nodes(plan):
        for c in node.children():
            out.setdefault(id(c), node)
    return out


def _replace_child(parent: N.PlanNode, old: N.PlanNode,
                   new: N.PlanNode) -> None:
    for attr in ("child", "build", "probe"):
        if getattr(parent, attr, None) is old:
            setattr(parent, attr, new)
            return
    if isinstance(parent, N.PConcat):
        parent.inputs = [new if c is old else c for c in parent.inputs]
        return
    raise AssertionError("old is not a child of parent")


def _splice(plan: N.PlanNode, node: N.PlanNode) -> N.PlanNode:
    """Remove a single-child node from the tree; returns the new root."""
    child = node.children()[0]
    parents = _parents(plan)
    p = parents.get(id(node))
    if p is None:
        return child
    _replace_child(p, node, child)
    return plan


def _first(plan: N.PlanNode, pred) -> Optional[N.PlanNode]:
    for node in _nodes(plan):
        if pred(node):
            return node
    return None


def _motions(plan: N.PlanNode, kind: Optional[str] = None):
    return [m for m in _nodes(plan) if isinstance(m, N.PMotion)
            and (kind is None or m.kind == kind)]


# ----------------------------------------------------------- mutations
#
# Each fn(plan, session) -> (new_root, description) | None.


def drop_motion_under_join(plan, session):
    """Splice a broadcast/redistribute feeding a join: equal keys never
    meet again."""
    parents = _parents(plan)
    for m in _motions(plan):
        p = parents.get(id(m))
        if isinstance(p, N.PJoin) and m.kind in ("broadcast",
                                                 "redistribute"):
            return _splice(plan, m), f"spliced {m.kind} under join"
    return None


def drop_gather_at_root(plan, session):
    """Remove the statement's final gather: the coordinator slot would
    see one shard and call it the result."""
    if isinstance(plan, N.PMotion) and plan.kind == "gather":
        return plan.child, "removed root gather"
    return None


def wrong_hash_keys(plan, session):
    """Point a redistribute at a different column than it claims: rows
    route by one key, consumers assume another."""
    for m in _motions(plan, "redistribute"):
        have = {k.name for k in m.hash_keys if isinstance(k, ex.ColumnRef)}
        for f in m.child.fields:
            if f.name not in have and f.type.np_dtype.itemsize in (4, 8):
                m.hash_keys = [ex.ColumnRef(f.name, f.type)]
                return plan, f"redistribute now hashes {f.name!r}"
    return None


def rung_off_ladder(plan, session):
    """Nudge a bucket capacity off the power-of-two rung ladder."""
    for m in _motions(plan, "redistribute"):
        m.bucket_cap += 3
        m.out_capacity = m.bucket_cap * session.config.n_segments
        return plan, f"bucket_cap now {m.bucket_cap}"
    return None


def rung_below_exact(plan, session):
    """Drop a bucket capacity below the exact skew bound with no
    runtime filter to justify it: the hot key is a guaranteed
    overflow."""
    from cloudberry_tpu_torch.exec.kernels import rung_up
    from cloudberry_tpu_torch.plan.verify import Verifier, _rf_below

    v = Verifier(session, plan)
    for m in _motions(plan, "redistribute"):
        if _rf_below(m) is not None:
            continue
        exact = v.exact_bucket_bound(m.child, m.hash_keys)
        if exact is None or rung_up(max(exact, 8)) <= 8:
            continue
        m.bucket_cap = max(rung_up(max(exact, 8)) // 2, 8)
        m.out_capacity = m.bucket_cap * session.config.n_segments
        return plan, f"bucket_cap {m.bucket_cap} < exact rung"
    return None


def feedback_rung_forged(plan, session):
    """Stamp a redistribute as feedback-seeded and drop its rung below
    anything a live sketch justifies: a poisoned/forged learned seed
    must be a guaranteed overflow finding, not a trusted stamp."""
    for m in _motions(plan, "redistribute"):
        m._feedback_seed = {"demand": 1, "static": m.bucket_cap,
                            "rung": 8, "src": ()}
        m.bucket_cap = 8
        m.out_capacity = m.bucket_cap * session.config.n_segments
        return plan, "forged feedback seed, bucket_cap dropped to 8"
    return None


def gather_capacity_shrink(plan, session):
    """Undersize a gather's receive buffer below rows x nseg."""
    for m in _motions(plan, "gather"):
        m.out_capacity -= 1
        return plan, f"gather out_capacity now {m.out_capacity}"
    return None


def sharding_stamp_lie(plan, session):
    """Stamp a redistribute replicated: downstream consumers would skip
    motions they still need."""
    for m in _motions(plan, "redistribute"):
        m.sharding = Sharding.replicated()
        return plan, "redistribute stamped replicated"
    return None


def param_slot_desync(plan, session):
    """Inject a $params slot with no signature neighbor: the rebind
    vector and the plan disagree about what slot 0..n mean."""
    flt = _first(plan, lambda n: isinstance(n, N.PFilter))
    if flt is None:
        return None

    def sub(e):
        if isinstance(e, ex.Literal) and not isinstance(e.value, bool):
            return ex.Param(7, e.dtype, e.value)
        return None

    new_pred = ex.rewrite(flt.predicate, sub)
    if new_pred is flt.predicate:
        return None
    flt.predicate = new_pred
    return plan, "literal replaced by orphan $params slot 7"


def rf_above_motion(plan, session):
    """Hoist a runtime filter ABOVE the shuffle it prices: the wire
    ships every probe row the filter was inserted to drop."""
    parents = _parents(plan)
    for m in _motions(plan, "redistribute"):
        rf = m.child
        if not isinstance(rf, N.PRuntimeFilter):
            continue
        p = parents.get(id(m))
        if p is None:
            continue
        m.child = rf.child
        rf.child = m
        rf.sharding = m.sharding
        rf.fields = list(m.fields)
        _replace_child(p, m, rf)
        return plan, "runtime filter hoisted above its redistribute"
    return None


def rf_build_forged(plan, session):
    """Point a runtime filter at a COPY of the build: the filter keys
    no longer come from rows the join will see."""
    rf = _first(plan, lambda n: isinstance(n, N.PRuntimeFilter))
    if rf is None:
        return None
    rf.build = copy.copy(rf.build)
    return plan, "runtime filter build reference replaced by a clone"


def agg_final_partials_split(plan, session):
    """Re-route the two-stage agg's merge motion onto a NON-group
    column: each segment merges a random subset of every group's
    partials."""
    for node in _nodes(plan):
        if not (isinstance(node, N.PAgg) and node.mode == "final"
                and node.group_keys):
            continue
        m = node.child
        if not (isinstance(m, N.PMotion) and m.kind == "redistribute"):
            continue
        keys = {e.name for _, e in node.group_keys
                if isinstance(e, ex.ColumnRef)}
        for f in m.fields:
            if f.name not in keys and f.type.np_dtype.itemsize in (4, 8):
                m.hash_keys = [ex.ColumnRef(f.name, f.type)]
                m.sharding = Sharding.hashed(f.name)
                return plan, f"merge motion re-keyed to {f.name!r}"
    return None


def agg_merge_illegal(plan, session):
    """Merge a partial count with max: the final 'count' becomes the
    largest per-segment count instead of the sum."""
    for node in _nodes(plan):
        if not (isinstance(node, N.PAgg) and node.mode == "final"):
            continue
        below = node.child
        while isinstance(below, (N.PMotion, N.PShare)):
            below = below.child
        if not (isinstance(below, N.PAgg) and below.mode == "partial"):
            continue
        pf = {n: c.func for n, c in below.aggs}
        for i, (name, call) in enumerate(node.aggs):
            if isinstance(call.arg, ex.ColumnRef) \
                    and pf.get(call.arg.name) == "count":
                node.aggs[i] = (name, ex.AggCall("max", call.arg))
                return plan, f"final {name!r} now merges count with max"
    return None


def agg_single_not_colocated(plan, session):
    """Drop the group key that made a one-stage agg colocated: equal
    groups now live on several segments and aggregate alone."""
    for node in _nodes(plan):
        if not (isinstance(node, N.PAgg) and node.mode == "single"
                and node.sharding is not None
                and node.sharding.is_partitioned):
            continue
        csh = node.child.sharding
        if csh is None or csh.kind != "hashed":
            continue
        doomed = [n for n, e in node.group_keys
                  if isinstance(e, ex.ColumnRef) and e.name in csh.keys]
        if not doomed:
            continue
        node.group_keys = [(n, e) for n, e in node.group_keys
                           if n not in doomed]
        node.fields = [f for f in node.fields if f.name not in doomed]
        return plan, f"dropped colocating group key(s) {doomed}"
    return None


def window_not_colocated(plan, session):
    """Splice the redistribute under a window: partitions span
    segments and every frame is wrong."""
    for node in _nodes(plan):
        if isinstance(node, N.PWindow) \
                and isinstance(node.child, N.PMotion) \
                and node.child.kind == "redistribute":
            m = node.child
            node.child = m.child
            return plan, "spliced redistribute under window"
    return None


def concat_partitioned_input(plan, session):
    """Splice a gather feeding a set-op append: one input contributes
    a single shard."""
    for node in _nodes(plan):
        if not isinstance(node, N.PConcat):
            continue
        for i, c in enumerate(node.inputs):
            if isinstance(c, N.PMotion) and c.kind == "gather":
                node.inputs[i] = c.child
                return plan, f"spliced gather under append input {i}"
    return None


def topn_merge_key_flip(plan, session):
    """Flip the merge sort's direction above a pre-compacting gather:
    each segment keeps its top k ascending, the coordinator merges
    descending."""
    parents = _parents(plan)
    for m in _motions(plan, "gather"):
        if m.pre_compact <= 0:
            continue
        p = parents.get(id(m))
        if isinstance(p, N.PSort) and p.keys:
            e, asc = p.keys[0]
            p.keys[0] = (e, not asc)
            return plan, "merge sort direction flipped"
    return None


def full_join_dist_degrade(plan, session):
    """Flip an inner join with a replicated build to FULL: unmatched
    build rows would be emitted once per segment."""
    for node in _nodes(plan):
        if isinstance(node, N.PJoin) and node.kind == "inner" \
                and node.build.sharding is not None \
                and node.build.sharding.kind == "replicated" \
                and node.probe.sharding is not None \
                and node.probe.sharding.is_partitioned:
            node.kind = "full"
            return plan, "inner join flipped to full"
    return None


def join_key_arity(plan, session):
    """Drop one probe key: the join compares ragged key tuples."""
    j = _first(plan, lambda n: isinstance(n, N.PJoin)
               and len(n.probe_keys) >= 1)
    if j is None:
        return None
    j.probe_keys = j.probe_keys[:-1]
    return plan, "dropped last probe key"


def mask_dangling(plan, session):
    """Declare a validity mask no node provides: NULLs read as
    values."""
    f = plan.fields[0]
    plan.fields[0] = dataclasses.replace(f, null_mask=("$nn:forged",))
    return plan, f"field {f.name!r} now claims mask '$nn:forged'"


def scan_rows_overflow(plan, session):
    """Claim more rows than the scan's static capacity holds."""
    sc = _first(plan, lambda n: isinstance(n, N.PScan)
                and n.table_name != "$dual")
    if sc is None:
        return None
    sc.num_rows = sc.capacity + 5
    return plan, f"scan num_rows {sc.num_rows} > capacity {sc.capacity}"


def motion_wire_dtype(plan, session):
    """Ship a 2-byte column over the packed wire: no lane exists for
    it (the limb convention bitcasts whole u32 words)."""
    import numpy as np

    class _HalfType:
        np_dtype = np.dtype("int16")

        def __str__(self):
            return "int16"

    for m in _motions(plan):
        if m.fields:
            m.fields[0] = dataclasses.replace(m.fields[0],
                                              type=_HalfType())
            return plan, f"motion column {m.fields[0].name!r} now int16"
    return None


def jix_forged(plan, session):
    """Stamp a join-index spec on a join whose build is NOT the
    fragment the cache would describe."""
    from cloudberry_tpu_torch.exec.joinindex import JoinIndexSpec

    for node in _nodes(plan):
        if isinstance(node, N.PJoin):
            node._jix = JoinIndexSpec("$jix:forged:k:64:table",
                                      "forged", ("k",), 64, capacity=8,
                                      mode="table")
            return plan, "forged join-index stamp"
    return None


def hier_wrong_host_grouping(plan, session):
    """Stamp two-level caps for a host count that does not divide the
    mesh: rows would route to a host lane that does not exist."""
    from cloudberry_tpu_torch.exec.kernels import rung_up

    for m in _motions(plan, "redistribute"):
        m.hier_hosts = 3            # 8-segment corpus: 8 % 3 != 0
        m.host_bucket_cap = rung_up(max(m.bucket_cap, 8))
        return plan, "two-level stamps with hier_hosts=3 on 8 segments"
    return None


def hier_inter_buffer_undersize(plan, session):
    """Undersize the aggregated inter-host block below one segment-pair
    bucket: the DCN exchange cannot hold what the intra hop may legally
    deliver — a guaranteed overflow stamped as a valid plan."""
    for m in _motions(plan, "redistribute"):
        if m.bucket_cap <= 8:
            continue
        m.hier_hosts = 2
        m.host_bucket_cap = 8       # a valid rung, below bucket_cap
        return plan, f"host_bucket_cap 8 < bucket_cap {m.bucket_cap}"
    return None


def hier_combine_forged(plan, session):
    """Forge a host-combine stamp on a join redistribute (child is not
    a partial aggregate): the 'combine' would grouped-aggregate
    arbitrary join rows and silently drop data."""
    from cloudberry_tpu_torch.exec.kernels import rung_up

    for m in _motions(plan, "redistribute"):
        if isinstance(m.child, N.PAgg):
            continue
        m.hier_hosts = 2
        m.host_bucket_cap = rung_up(max(m.bucket_cap, 8))
        m.host_combine = True
        keys = tuple(k.name for k in m.hash_keys
                     if isinstance(k, ex.ColumnRef))
        m.combine_spec = (keys, tuple())
        return plan, "host_combine forged on a join redistribute"
    return None


def expansion_no_capacity(plan, session):
    """Zero an expansion join's pair buffer."""
    j = _first(plan, lambda n: isinstance(n, N.PJoin)
               and not n.unique_build)
    if j is None:
        return None
    j.out_capacity = 0
    return plan, "expansion join out_capacity zeroed"


# ------------------------------------------------------------ registry
#
# name -> (sql, mutate fn, expected rule ids). The SQL is planned on
# the standard TPC-H corpus session (SF0.01 seed 7, 8 segments — the
# golden-plan fixtures' world); expected rules are ANY-of: a corruption
# may trip secondary findings too, but at least one finding must carry
# an expected rule AND anchor at a path containing the mutated node
# class.

_Q_JOIN_GROUP = (
    "select l_orderkey, sum(l_extendedprice) as revenue "
    "from customer, orders, lineitem "
    "where c_custkey = o_custkey and l_orderkey = o_orderkey "
    "and c_mktsegment = 'BUILDING' "
    "group by l_orderkey order by revenue desc limit 10")
_Q_TWO_STAGE = (
    "select l_partkey, sum(l_quantity) as q, count(*) as n "
    "from lineitem group by l_partkey")
_Q_REDIST_JOIN = (
    "select count(*) as n from partsupp, lineitem "
    "where ps_partkey = l_partkey and ps_suppkey = l_suppkey")
_Q_WINDOW = (
    "select l_partkey, sum(l_quantity) over "
    "(partition by l_partkey) as w from lineitem")
_Q_UNION = (
    "select l_orderkey as k from lineitem "
    "union all select o_orderkey as k from orders")
_Q_SCAN = "select l_orderkey, l_quantity from lineitem"
# a LEFT join redistributes both sides with NO runtime filter (outer
# joins are ineligible) and a non-unique build — the expansion-buffer
# and bare-redistribute corruption targets
_Q_LEFT_EXPAND = (
    "select count(*) as n from orders left join lineitem "
    "on o_custkey = l_suppkey")

MUTATIONS: dict[str, tuple[str, Callable, frozenset]] = {
    "drop-motion-under-join": (
        _Q_JOIN_GROUP, drop_motion_under_join,
        frozenset({"join-not-colocated"})),
    "drop-gather-at-root": (
        _Q_SCAN, drop_gather_at_root, frozenset({"root-partitioned"})),
    "wrong-hash-keys": (
        _Q_TWO_STAGE, wrong_hash_keys, frozenset({"dist-mismatch"})),
    "rung-off-ladder": (
        _Q_REDIST_JOIN, rung_off_ladder, frozenset({"motion-rung"})),
    "rung-below-exact": (
        _Q_LEFT_EXPAND, rung_below_exact,
        frozenset({"motion-rung-below-exact"})),
    "feedback-rung-forged": (
        _Q_REDIST_JOIN, feedback_rung_forged,
        frozenset({"motion-rung-feedback-forged",
                   "motion-rung-below-exact"})),
    "gather-capacity-shrink": (
        _Q_SCAN, gather_capacity_shrink, frozenset({"motion-capacity"})),
    "sharding-stamp-lie": (
        _Q_TWO_STAGE, sharding_stamp_lie, frozenset({"dist-mismatch"})),
    "param-slot-desync": (
        _Q_JOIN_GROUP, param_slot_desync,
        frozenset({"param-slot-desync"})),
    "rf-above-motion": (
        _Q_REDIST_JOIN, rf_above_motion, frozenset({"rf-placement"})),
    "rf-build-forged": (
        _Q_REDIST_JOIN, rf_build_forged,
        frozenset({"rf-build-unshared"})),
    "agg-final-partials-split": (
        _Q_TWO_STAGE, agg_final_partials_split,
        frozenset({"agg-final-partials-split"})),
    "agg-merge-illegal": (
        _Q_TWO_STAGE, agg_merge_illegal,
        frozenset({"agg-merge-illegal"})),
    "agg-single-not-colocated": (
        _Q_JOIN_GROUP, agg_single_not_colocated,
        frozenset({"agg-single-not-colocated"})),
    "window-not-colocated": (
        _Q_WINDOW, window_not_colocated,
        frozenset({"window-not-colocated"})),
    "concat-partitioned-input": (
        _Q_UNION, concat_partitioned_input,
        frozenset({"concat-partitioned-input"})),
    "topn-merge-key-flip": (
        _Q_JOIN_GROUP, topn_merge_key_flip,
        frozenset({"topn-merge-sort"})),
    "full-join-dist-degrade": (
        _Q_JOIN_GROUP, full_join_dist_degrade,
        frozenset({"join-full-dist"})),
    "join-key-arity": (
        _Q_REDIST_JOIN, join_key_arity, frozenset({"join-key-arity"})),
    "mask-dangling": (
        _Q_SCAN, mask_dangling, frozenset({"mask-dangling"})),
    "scan-rows-overflow": (
        _Q_SCAN, scan_rows_overflow, frozenset({"scan-rows"})),
    "motion-wire-dtype": (
        _Q_SCAN, motion_wire_dtype, frozenset({"motion-wire-dtype"})),
    "jix-forged": (
        _Q_JOIN_GROUP, jix_forged, frozenset({"jix-illegal"})),
    "expansion-no-capacity": (
        _Q_LEFT_EXPAND, expansion_no_capacity,
        frozenset({"join-out-capacity"})),
    "hier-wrong-host-grouping": (
        _Q_REDIST_JOIN, hier_wrong_host_grouping,
        frozenset({"motion-host-grouping"})),
    "hier-inter-buffer-undersize": (
        _Q_REDIST_JOIN, hier_inter_buffer_undersize,
        frozenset({"motion-host-capacity"})),
    "hier-combine-forged": (
        _Q_REDIST_JOIN, hier_combine_forged,
        frozenset({"motion-host-combine"})),
}
