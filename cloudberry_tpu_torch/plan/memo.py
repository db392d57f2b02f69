"""Cascades-lite distribution exploration — the ORCA (gporca) role,
scoped to the decision that dominates MPP cost: where the motions go.

The reference ships two optimizers: the MPP-ified Postgres planner
(greedy locus rules, cdbpath.c:1346 cdbpath_motion_for_join) and ORCA, a
Cascades engine (src/backend/gporca) that explores alternative plans in
a memo and costs them. This module is the memo idea translated to this
planner's world:

- groups        = join-tree subtrees (scans / filters / projections /
                  joins — the grammar Distributor._join decides over);
- physical
  property      = the subtree's output Sharding (the CdbPathLocus
                  analog; ORCA's CDistributionSpec);
- alternatives  = per join: colocate / broadcast-build / redistribute-
                  probe / redistribute-build / redistribute-both —
                  exactly the moves cdbpath_motion_for_join knows, but
                  COSTED AND COMPARED over the whole tree instead of
                  decided greedily per node;
- cost          = bytes over the interconnect (rows moved × row width),
                  the dominant term on the reference's UDP fabric and on
                  TPU ICI alike;
- required
  property      = the parent context: GROUP BY keys above the join tree
                  add the final-redistribute cost each output property
                  implies, so a locally cheap choice that forces an
                  expensive re-shuffle later LOSES — System R's
                  "interesting orders" insight applied to hash
                  distribution (ORCA: derived vs required distribution
                  specs).

The winning alternative is stamped on each join (``_dist_choice``);
``Distributor._join`` honors the stamp — re-checking its preconditions,
falling back to the greedy rules wherever the memo abstained or the
plan drifted — so the memo can only redirect motions the distributor
already knows how to place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from cloudberry_tpu_torch.plan import expr as ex
from cloudberry_tpu_torch.plan import nodes as N
from cloudberry_tpu_torch.plan.distribute import (_hashed_key_positions,
                                            _join_colocated,
                                            _node_exprs,
                                            _project_sharding,
                                            broadcast_struct_rows)
from cloudberry_tpu_torch.plan.sharding import Sharding


@dataclass(frozen=True)
class Alt:
    """One costed alternative for a subtree: total motion bytes below,
    the output sharding it yields, and the per-join choices that
    produce it."""

    cost: float
    sharding: Sharding
    choices: tuple  # ((PJoin, choice-str), ...)


def _width(node: N.PlanNode) -> int:
    return max(sum(f.type.np_dtype.itemsize for f in node.fields), 1)


def _keep_best(alts: dict, alt: Alt) -> None:
    k = str(alt.sharding)
    cur = alts.get(k)
    if cur is None or alt.cost < cur.cost:
        alts[k] = alt


def _redist_sharding(keys) -> Sharding:
    """Mirror Distributor.redistribute's output locus."""
    names = tuple(k.name for k in keys if isinstance(k, ex.ColumnRef))
    return Sharding.hashed(*names) if len(names) == len(keys) \
        else Sharding.strewn()


def explore(node: N.PlanNode, catalog, nseg: int,
            thr: int, gst: int = 0) -> Optional[dict]:
    """Alternative set {sharding-key: Alt} for a join-tree subtree; None
    when the subtree leaves the grammar (set-ops, windows, shares,
    subquery scalars in scope) — the greedy rules then stand alone.
    Single-mode aggregations ARE in the grammar (aggregated derived
    tables, the q65-class multi-block shape); ``gst`` is the
    gather_single_threshold the distributor's two-stage arm applies, so
    explored output shardings match what it actually produces."""
    if isinstance(node, N.PScan):
        return {str(sh): Alt(0.0, sh, ())
                for sh in (_scan_sharding(node, catalog),)}
    if isinstance(node, N.PFilter):
        return explore(node.child, catalog, nseg, thr, gst)
    if isinstance(node, N.PProject):
        sub = explore(node.child, catalog, nseg, thr, gst)
        if sub is None:
            return None
        out: dict = {}
        for a in sub.values():
            _keep_best(out, Alt(a.cost,
                                _project_sharding(a.sharding, node.exprs),
                                a.choices))
        return out
    if isinstance(node, N.PJoin):
        return _explore_join(node, catalog, nseg, thr, gst)
    if isinstance(node, N.PAgg) and node.mode == "single":
        # mirror Distributor._agg's arms — colocated grouping is free
        # and keeps the (renamed) child sharding (_agg_extra prices the
        # move, 0 when colocated); anything else pays the partial rows'
        # move and lands where the distributor will actually put it:
        # singleton under the GATHER_SINGLE threshold, hashed-on-keys
        # above it
        sub = explore(node.child, catalog, nseg, thr, gst)
        if sub is None:
            return None
        from cloudberry_tpu_torch.plan.distribute import _rename_sharding

        out = {}
        for a in sub.values():
            sh = a.sharding
            if not sh.is_partitioned:
                _keep_best(out, Alt(a.cost, sh, a.choices))
                continue
            extra = _agg_extra(node, sh, catalog, nseg)
            if node.group_keys and extra == 0.0:
                _keep_best(out, Alt(
                    a.cost, _rename_sharding(sh, node.group_keys),
                    a.choices))
                continue
            if node.group_keys and not (0 < node.capacity <= gst):
                out_sh = Sharding.hashed(
                    *(n for n, _ in node.group_keys))
            else:
                out_sh = Sharding.singleton()
            _keep_best(out, Alt(a.cost + extra, out_sh, a.choices))
        return out
    return None


def _scan_sharding(node: N.PScan, catalog) -> Sharding:
    """Mirror Distributor._scan's locus assignment."""
    if node.table_name == "$dual":
        return Sharding.general()
    try:
        table = catalog.table(node.table_name)
    except KeyError:
        return Sharding.strewn()
    pol = table.policy
    if pol.kind == "replicated":
        return Sharding.replicated()
    if pol.kind == "hashed" and all(k in node.column_map
                                    for k in pol.keys):
        return Sharding.hashed(*(node.column_map[k] for k in pol.keys))
    return Sharding.strewn()


def _hot_frac(plan: N.PlanNode, keys, catalog) -> float:
    """Estimated fraction of rows holding the HOTTEST redistribute-key
    value, read off the equi-depth histogram: a value spanning k of N
    buckets holds ≈ k/N of the rows (the pg_statistic MCV-list role).
    A compound key is at most as skewed as its least-skewed column."""
    from cloudberry_tpu_torch.plan.cost import _col_source

    frac = 1.0
    seen = False
    for k in keys:
        if not isinstance(k, ex.ColumnRef):
            continue
        src = _col_source(plan, k.name)
        if src is None:
            continue
        try:
            hist = catalog.table(src[0]).stats.hist.get(src[1])
        except KeyError:
            continue
        if not hist or len(hist) < 3:
            continue
        run = best = 1
        for a, b in zip(hist, hist[1:]):
            run = run + 1 if a == b else 1
            best = max(best, run)
        frac = min(frac, (best - 1) / (len(hist) - 1))
        seen = True
    out = frac if seen else 0.0
    # feedback (plan/feedback.py): when a prior execution of this
    # (table, key-set) shuffle ALARMED on observed skew, the measured
    # hottest-destination fraction overrides an optimistic histogram —
    # this is what re-ranks join order / motion choice on the second
    # execution of a mis-estimated hot-key probe. Sub-alarm
    # observations leave the histogram estimate in charge.
    fb = getattr(catalog, "_feedback", None)
    if fb is not None:
        obs = fb.hot_frac(plan, keys)
        if obs is not None and obs > out:
            return obs
    return out


def _redist_cost(est: float, width: int, frac: float, nseg: int) -> float:
    """Bytes cost of a redistribute, skew-aware: when the hottest key
    exceeds its fair 1/nseg share, one destination serializes the motion
    AND the downstream compute — scale by how far it overshoots (the
    cdbpath.c skew-sensitive motion costing role). This is what steers
    the memo toward broadcast for hot-key probes."""
    base = est * width * (nseg - 1) / max(nseg, 1)
    if frac * nseg > 1.0:
        base *= frac * nseg
    return base


def _explore_join(node: N.PJoin, catalog, nseg: int,
                  thr: int, gst: int = 0) -> Optional[dict]:
    from cloudberry_tpu_torch.plan.cost import estimate_rows

    if node.kind == "full":
        return None  # forced shape (coloc or gather-both); greedy path
    balts = explore(node.build, catalog, nseg, thr, gst)
    palts = explore(node.probe, catalog, nseg, thr, gst)
    if balts is None or palts is None:
        return None
    est_b = estimate_rows(node.build, catalog)
    est_p = estimate_rows(node.probe, catalog)
    wb, wp = _width(node.build), _width(node.probe)
    fcache: dict = {}

    def hot(side, keys):
        # skew is a property of the ACTUAL redistribute-key subset: min
        # over more columns can only understate a subset's hot fraction
        ck = (id(side), tuple(k.name if isinstance(k, ex.ColumnRef)
                              else "?" for k in keys))
        if ck not in fcache:
            fcache[ck] = _hot_frac(side, keys, catalog)
        return fcache[ck]
    out: dict = {}
    for ba in balts.values():
        for pa in palts.values():
            base = ba.cost + pa.cost
            ch = ba.choices + pa.choices
            bsh, psh = ba.sharding, pa.sharding
            b_part, p_part = bsh.is_partitioned, psh.is_partitioned
            if not (b_part and p_part):
                # forced arms of Distributor._join: no choice to stamp
                if b_part and not p_part:
                    if node.kind in ("inner", "semi"):
                        bsub = _hashed_key_positions(bsh, node.build_keys)
                        if bsub is not None:
                            names = [node.probe_keys[i].name
                                     for i in bsub
                                     if isinstance(node.probe_keys[i],
                                                   ex.ColumnRef)]
                            sh = (Sharding.hashed(*names)
                                  if len(names) == len(bsub)
                                  else Sharding.strewn())
                        else:
                            sh = Sharding.strewn()
                        _keep_best(out, Alt(base, sh, ch))
                    else:
                        # left/anti: broadcast the partitioned build
                        _keep_best(out, Alt(
                            base + est_b * wb * (nseg - 1), psh, ch))
                else:
                    _keep_best(out, Alt(base, psh, ch))
                continue
            if _join_colocated(node, bsh, psh):
                _keep_best(out, Alt(base, psh,
                                    ch + ((node, "colocate"),)))
                continue
            # thr == 0 is the explicit "never broadcast" switch — the
            # memo honors it like the greedy rule does
            if thr > 0 and est_b * nseg <= broadcast_struct_rows(thr):
                _keep_best(out, Alt(
                    base + est_b * wb * (nseg - 1), psh,
                    ch + ((node, "broadcast"),)))
            bsub = _hashed_key_positions(bsh, node.build_keys)
            psub = _hashed_key_positions(psh, node.probe_keys)
            # semijoin reduction: a probe redistribute ships only the rows
            # a pre-motion DIGEST runtime filter would pass (stamped by
            # annotate_distribution via distribute.digest_filter_frac) —
            # the same currency the distributor uses when it inserts the
            # filter, so a big-build join whose probe shrinks 10x on the
            # wire wins redist_probe over broadcast on its real bytes
            jfrac = getattr(node, "_jf_frac", 1.0)
            if bsub is not None:
                keys = [node.probe_keys[i] for i in bsub]
                _keep_best(out, Alt(
                    base + _redist_cost(est_p * jfrac, wp,
                                        hot(node.probe, keys), nseg),
                    _redist_sharding(keys),
                    ch + ((node, "redist_probe"),)))
            if psub is not None:
                bkeys = [node.build_keys[i] for i in psub]
                _keep_best(out, Alt(
                    base + _redist_cost(est_b, wb,
                                        hot(node.build, bkeys), nseg),
                    psh, ch + ((node, "redist_build"),)))
            _keep_best(out, Alt(
                base + _redist_cost(est_b, wb,
                                    hot(node.build, node.build_keys),
                                    nseg)
                + _redist_cost(est_p * jfrac, wp,
                               hot(node.probe, node.probe_keys), nseg),
                _redist_sharding(node.probe_keys),
                ch + ((node, "redist_both"),)))
    return out or None


# --------------------------------------------------------------------------
# Joint join-order + motion search — the CJoinOrderDPv2 / CMemo marriage
# (reference: src/backend/gporca/libgpopt/src/xforms/CJoinOrderDPv2.cpp,
# libgpopt/src/search/CMemo.cpp). ORCA's core MPP insight: the cheapest
# join ORDER depends on the motion strategy and vice versa — a cheaper
# order under broadcast is not the cheapest order under redistribute — so
# both must be explored in ONE dynamic program. State: per connected
# relation subset, the Pareto set of (output sharding -> cheapest cost,
# build recipe). The binder calls this BEFORE building the join tree
# (plan/binder.py _join_tree); the plain intermediate-rows DP remains the
# fallback when the search abstains or blows its iteration budget.

# cost weights: motion bytes ride the interconnect (slower than local
# HBM traffic), build sides pay for structure construction, every motion
# op pays a fixed launch cost (collective + receiver re-sort — this is
# what keeps the search from trading one broadcast of a small dim for
# two redistributes of small intermediates), and a non-unique build side
# pays the pair-expansion materialization _make_join would set up — the
# relative weights steer order AND motion together, the same currency
# memo exploration uses.
MOTION_WEIGHT = 4.0
BUILD_WEIGHT = 0.5
MOTION_FIXED_BYTES = 1 << 20
# a redistribute costs more PER BYTE than a broadcast: it bucketizes,
# all-to-alls and re-compacts (three passes + a receiver-side resort)
# where broadcast is one all-gather of contiguous rows. Both constants
# grid-searched against dp+greedy on the 8-device mesh at SF0.1
# (geomean 1.26x over q2/3/5/7/8/9/10/18/21; q8 alone 7.5x).
REDIST_WEIGHT = 2.0
JOINT_MAX_RELS = 10
JOINT_ITER_BUDGET = 400_000
JOINT_KEEP_ALTS = 6


def _pair_sel(keys_a, keys_b, atom_a, atom_b, catalog,
              est_a, est_b) -> float:
    """Composite equi-join selectivity for ALL edges between one atom
    pair: 1/max(ndv_left-tuple, ndv_right-tuple) with the tuple NDV the
    product of column NDVs capped by the side's rows — the cost._keys_ndv
    discipline. Treating a composite key as independent edges would
    square its selectivity (q9's (l_partkey, l_suppkey) = partsupp key)
    and make that intermediate look near-free."""
    from cloudberry_tpu_torch.plan.cost import _expr_ndv

    def tup_ndv(keys, atom, est):
        prod = 1.0
        known = False
        for k in keys:
            nd = _expr_ndv(atom, k, catalog)
            if nd is not None:
                known = True
                prod *= nd
        return min(prod, max(est, 1.0)) if known else None

    nd_a = tup_ndv(keys_a, atom_a, est_a)
    nd_b = tup_ndv(keys_b, atom_b, est_b)
    denom = max(nd_a or 1.0, nd_b or 1.0,
                1.0 if (nd_a or nd_b) else max(est_a, est_b, 1.0))
    return 1.0 / max(denom, 1.0)


def _hot_frac_cols(col_atom: dict, keys, catalog) -> float:
    """_hot_frac over pre-resolved column->atom-plan ownership (search
    subsets have no plan node to walk)."""
    frac = 1.0
    seen = False
    for k in keys:
        if not isinstance(k, ex.ColumnRef) or k.name not in col_atom:
            continue
        f = _hot_frac(col_atom[k.name], [k], catalog)
        if f > 0.0:
            frac = min(frac, f)
            seen = True
    return frac if seen else 0.0


def _join_strategies(bsh: Sharding, psh: Sharding, bkeys, pkeys,
                     est_b, est_p, wb, wp, hotb, hotp, nseg, thr):
    """Yield (motion_cost, n_motions, output Sharding, choice|None) for
    one build/probe orientation — the cdbpath_motion_for_join menu,
    shared currency with _explore_join (inner joins only: the DP never
    builds outer joins; those pre-join into atoms)."""
    b_part, p_part = bsh.is_partitioned, psh.is_partitioned
    if not (b_part and p_part):
        if b_part and not p_part:
            bsub = _hashed_key_positions(bsh, bkeys)
            if bsub is not None:
                names = [pkeys[i].name for i in bsub
                         if isinstance(pkeys[i], ex.ColumnRef)]
                sh = (Sharding.hashed(*names) if len(names) == len(bsub)
                      else Sharding.strewn())
            else:
                sh = Sharding.strewn()
            yield (0.0, 0, sh, None)
        else:
            yield (0.0, 0, psh, None)
        return
    bpos = _hashed_key_positions(bsh, bkeys)
    ppos = _hashed_key_positions(psh, pkeys)
    if bpos is not None and bpos == ppos:
        yield (0.0, 0, psh, "colocate")
        return
    if thr > 0 and est_b * nseg <= broadcast_struct_rows(thr):
        yield (est_b * wb * (nseg - 1), 1, psh, "broadcast")
    if bpos is not None:
        keys = [pkeys[i] for i in bpos]
        yield (REDIST_WEIGHT * _redist_cost(est_p, wp, hotp(keys), nseg),
               1, _redist_sharding(keys), "redist_probe")
    if ppos is not None:
        bk = [bkeys[i] for i in ppos]
        yield (REDIST_WEIGHT * _redist_cost(est_b, wb, hotb(bk), nseg),
               1, psh, "redist_build")
    yield (REDIST_WEIGHT * (_redist_cost(est_b, wb, hotb(bkeys), nseg)
           + _redist_cost(est_p, wp, hotp(pkeys), nseg)), 2,
           _redist_sharding(pkeys), "redist_both")


def joint_search(atoms, edges, nseg: int, thr: int, catalog,
                 groupby_names: frozenset, make_join, is_unique=None,
                 gst: int = 0):
    """One DP over join order AND motion strategy.

    atoms: [(plan, width)] per base relation (any bound subtree);
    edges: [(ia, ib, key_a, key_b)] pre-bound equi-join edges;
    groupby_names: bound GROUP BY column names above this region (the
    required-property context — a final sharding matching them saves
    the regroup motion);
    make_join(kind, build, probe, bkeys, pkeys) -> PJoin (the binder's
    node factory, so built trees carry capacities/masks/uniqueness
    exactly like hand-ordered ones);
    is_unique(atom_idx, keys) -> bool: PK-side proof for an atom — a
    build side without it pays the pair-expansion materialization
    (and composite builds always do), which both prices the executor's
    real expansion cost and breaks colocate-orientation ties toward
    the unique build the sorted-build lookup wants.

    Returns the built PJoin tree with ``_dist_choice`` stamps, or None
    (abstain: too many relations, no edges, or budget blown)."""
    n = len(atoms)
    if n < 3 or n > JOINT_MAX_RELS or not edges:
        return None

    from cloudberry_tpu_torch.plan.cost import estimate_rows

    est_atom = [max(estimate_rows(p, catalog), 1.0) for p, _ in atoms]
    width = [w for _, w in atoms]
    col_atom: dict = {}
    for (p, _w) in atoms:
        for f in p.fields:
            col_atom.setdefault(f.name, p)
    # selectivity per atom PAIR (composite keys combine — never multiply
    # a multi-edge key's selectivities independently)
    pair_edges: dict[tuple, list] = {}
    for (ia, ib, ka, kb) in edges:
        lo, hi = (ia, ib) if ia < ib else (ib, ia)
        ka2, kb2 = (ka, kb) if ia < ib else (kb, ka)
        pair_edges.setdefault((lo, hi), []).append((ka2, kb2))
    pair_sel = {}
    for (lo, hi), eks in pair_edges.items():
        pair_sel[(lo, hi)] = _pair_sel(
            [k for k, _ in eks], [k for _, k in eks],
            atoms[lo][0], atoms[hi][0], catalog,
            est_atom[lo], est_atom[hi])

    est_cache: dict[int, float] = {}

    def est_of(mask: int) -> float:
        got = est_cache.get(mask)
        if got is None:
            rows = 1.0
            for i in range(n):
                if mask >> i & 1:
                    rows *= est_atom[i]
            for (lo, hi), sel in pair_sel.items():
                if mask >> lo & 1 and mask >> hi & 1:
                    rows *= sel
            got = est_cache[mask] = max(rows, 1.0)
        return got

    wid_cache: dict[int, int] = {}

    def wid_of(mask: int) -> int:
        got = wid_cache.get(mask)
        if got is None:
            got = wid_cache[mask] = max(
                sum(width[i] for i in range(n) if mask >> i & 1), 1)
        return got

    def hot_fn(keys):
        return _hot_frac_cols(col_atom, keys, catalog)

    # alternatives per atom: the motion-exploration grammar where it
    # applies, a conservative strewn property where it abstains
    best: list[Optional[dict]] = [None] * (1 << n)
    atom_alts: list[dict] = []
    for i, (p, _w) in enumerate(atoms):
        alts = explore(p, catalog, nseg, thr, gst)
        if alts is None:
            alts = {"?": Alt(0.0, Sharding.strewn(), ())}
        atom_alts.append(alts)
        best[1 << i] = {k: (a.cost, a.sharding, ("atom", i, k))
                        for k, a in alts.items()}

    budget = JOINT_ITER_BUDGET
    full = (1 << n) - 1
    by_size: dict[int, list[int]] = {}
    for m in range(1, full + 1):
        by_size.setdefault(bin(m).count("1"), []).append(m)
    for size in range(2, n + 1):
        for m in by_size.get(size, ()):
            out: dict = {}
            s = (m - 1) & m
            while s:
                o = m ^ s
                if s > o and best[s] is not None and best[o] is not None:
                    eidx = [e for e, (ia, ib, _ka, _kb) in enumerate(edges)
                            if (s >> ia & 1 and o >> ib & 1)
                            or (o >> ia & 1 and s >> ib & 1)]
                    if eidx:
                        budget = _joint_pairs(
                            m, s, o, eidx, best, out, edges, est_of,
                            wid_of, hot_fn, nseg, thr, budget,
                            is_unique)
                        if budget <= 0:
                            return None
                s = (s - 1) & m
            if out:
                if len(out) > JOINT_KEEP_ALTS:
                    keep = sorted(out.items(),
                                  key=lambda kv: kv[1][0])[:JOINT_KEEP_ALTS]
                    out = dict(keep)
                best[m] = out
    if best[full] is None:
        return None
    # required property: a final sharding already matching the GROUP BY
    # keys saves the regroup motion above this region. The regroup moves
    # PARTIAL rows — at most (groups × nseg), never more than the join
    # output (the _agg_extra discipline): pricing it as the raw output
    # would overvalue groupby-aligned shardings by orders of magnitude.
    from cloudberry_tpu_torch.plan.cost import _expr_ndv

    groups = 1.0
    for nm in groupby_names:
        p = col_atom.get(nm)
        nd = _expr_ndv(p, ex.ColumnRef(nm, None), catalog) \
            if p is not None else None
        groups *= nd if nd else max(est_of(full) ** 0.5, 1.0)
    rows = min(groups * nseg, est_of(full))
    regroup = rows * wid_of(full) * (nseg - 1) / max(nseg, 1) \
        * MOTION_WEIGHT * REDIST_WEIGHT + MOTION_FIXED_BYTES
    winner = None
    for (cost, sh, desc) in best[full].values():
        extra = 0.0
        if groupby_names:
            if not (sh.kind == "hashed" and sh.keys
                    and set(sh.keys) <= groupby_names):
                extra = regroup
        if winner is None or cost + extra < winner[0]:
            winner = (cost + extra, desc)
    return _joint_build(winner[1], atoms, edges, atom_alts, make_join)


def _joint_pairs(m, s, o, eidx, best, out, edges, est_of, wid_of,
                 hot_fn, nseg, thr, budget, is_unique):
    """Inner loop: cross every sharding alternative pair of the two
    halves with both orientations and the motion menu."""
    est_m = est_of(m)
    compute = est_m * wid_of(m)
    for salt in best[s].values():
        for oalt in best[o].values():
            for bmask, balt, pmask, palt in (
                    (s, salt, o, oalt), (o, oalt, s, salt)):
                budget -= 1
                if budget <= 0:
                    return 0
                bkeys, pkeys = [], []
                for e in eidx:
                    ia, ib, ka, kb = edges[e]
                    if bmask >> ia & 1:
                        bkeys.append(ka)
                        pkeys.append(kb)
                    else:
                        bkeys.append(kb)
                        pkeys.append(ka)
                est_b, est_p = est_of(bmask), est_of(pmask)
                wb, wp = wid_of(bmask), wid_of(pmask)
                base = balt[0] + palt[0] + compute \
                    + BUILD_WEIGHT * est_b * wb
                if not ((bmask & (bmask - 1)) == 0
                        and is_unique is not None
                        and is_unique(bmask.bit_length() - 1, bkeys)):
                    # non-unique (or composite) build side: price the
                    # pair-expansion buffer _make_join will allocate
                    base += compute
                for (mcost, nmot, sh, choice) in _join_strategies(
                        balt[1], palt[1], bkeys, pkeys, est_b, est_p,
                        wb, wp, hot_fn, hot_fn, nseg, thr):
                    cost = base + MOTION_WEIGHT * mcost \
                        + nmot * MOTION_FIXED_BYTES
                    k = str(sh)
                    cur = out.get(k)
                    if cur is None or cost < cur[0]:
                        out[k] = (cost, sh,
                                  ("join", balt[2], palt[2], tuple(eidx),
                                   bmask, choice))
    return budget


def _joint_build(desc, atoms, edges, atom_alts, make_join):
    """Materialize the winning recipe bottom-up through the binder's
    node factory, stamping each join's motion choice."""
    if desc[0] == "atom":
        _kind, i, altkey = desc
        # joins INSIDE an atom (derived tables) carry their own choice
        # stamps through the exploration Alt — and must be final too,
        # or the post-bind exploration re-stamps a locally-cheapest
        # choice whose sharding the parent's motions were not priced for
        for jn, choice in atom_alts[i][altkey].choices:
            jn._dist_choice = choice
            jn._joint = True
        return atoms[i][0]
    _kind, bdesc, pdesc, eidx, bmask, choice = desc
    bplan = _joint_build(bdesc, atoms, edges, atom_alts, make_join)
    pplan = _joint_build(pdesc, atoms, edges, atom_alts, make_join)
    bkeys, pkeys = [], []
    for e in eidx:
        ia, ib, ka, kb = edges[e]
        if bmask >> ia & 1:
            bkeys.append(ka)
            pkeys.append(kb)
        else:
            bkeys.append(kb)
            pkeys.append(ka)
    j = make_join("inner", bplan, pplan, bkeys, pkeys)
    if choice is not None:
        j._dist_choice = choice
    # the joint decision is final: the post-bind motion exploration
    # must not re-stamp joins whose order AND motion were chosen
    # together (annotate_distribution skips _joint regions)
    j._joint = True
    return j


def _agg_extra(agg: N.PAgg, sharding: Sharding, catalog,
               nseg: int) -> float:
    """Cost the GROUP BY above the join tree adds for a given output
    property: zero when the grouping can run one-stage colocated
    (Distributor._agg's test), else the partial rows' redistribute."""
    from cloudberry_tpu_torch.plan.cost import estimate_rows

    if not agg.group_keys:
        return 0.0  # global agg gathers one partial row either way
    key_src = {e.name for _, e in agg.group_keys
               if isinstance(e, ex.ColumnRef)}
    if sharding.kind == "hashed" and sharding.keys \
            and set(sharding.keys) <= key_src:
        return 0.0
    est_groups = estimate_rows(agg, catalog)
    rows = min(est_groups * nseg, estimate_rows(agg.child, catalog))
    return rows * _width(agg) * (nseg - 1) / max(nseg, 1)


def _joins_of(node: N.PlanNode):
    """Every join inside the join-tree grammar region rooted here —
    through single-mode aggs, which the grammar now includes: an outer
    region's stamps on sub-agg joins are final and must not be
    re-explored by the visitor."""
    if isinstance(node, (N.PFilter, N.PProject)):
        yield from _joins_of(node.child)
    elif isinstance(node, N.PAgg) and node.mode == "single":
        yield from _joins_of(node.child)
    elif isinstance(node, N.PJoin):
        yield node
        yield from _joins_of(node.build)
        yield from _joins_of(node.probe)


def _through_chain(node: N.PlanNode) -> N.PlanNode:
    while isinstance(node, (N.PFilter, N.PProject)):
        node = node.child
    return node


def annotate_distribution(plan: N.PlanNode, session) -> None:
    """Explore every join-tree region of the bound plan and stamp the
    globally cheapest motion strategy on each join (``_dist_choice``).
    Runs BEFORE the distribution walk (estimates see bind-time
    capacities, exactly like Distributor._join's own estimate calls)."""
    nseg = session.config.n_segments
    if nseg <= 1:
        return
    catalog = session.catalog
    thr = session.config.planner.broadcast_threshold
    gst = session.config.planner.gather_single_threshold
    annotated: set[int] = set()
    seen: set[int] = set()

    # pre-stamp each join's digest-filter survival fraction so the
    # exploration (which deliberately has no config in scope) prices
    # probe redistributes at their POST-FILTER bytes; the joint search
    # (mask-based, no join nodes yet) stays unmodeled by design
    from cloudberry_tpu_torch.exec.executor import all_nodes
    from cloudberry_tpu_torch.plan.distribute import digest_filter_frac

    fb = getattr(catalog, "_feedback", None)
    for nd in all_nodes(plan):
        if isinstance(nd, N.PJoin) and not hasattr(nd, "_jf_frac"):
            try:
                nd._jf_frac = digest_filter_frac(nd, catalog,
                                                 session.config, nseg)
            except Exception:
                nd._jf_frac = 1.0
        if isinstance(nd, N.PJoin) and fb is not None \
                and not hasattr(nd, "_feedback_skew"):
            # provenance for EXPLAIN/flight recorder: this join's probe
            # shuffle has an ALARMED skew sketch, so the exploration
            # below re-ranks with the observed hot fraction
            try:
                if fb.hot_frac(nd.probe, nd.probe_keys) is not None:
                    nd._feedback_skew = True
            except Exception:
                pass

    def region(root: N.PlanNode, agg: Optional[N.PAgg]) -> None:
        alts = explore(root, catalog, nseg, thr, gst)
        if not alts:
            # abstained (out-of-grammar node somewhere inside): leave
            # every join unmarked — the visitor descends and in-grammar
            # subtrees become fresh regions of their own. The mark makes
            # the abstention VISIBLE in EXPLAIN ("memo: abstained"), so
            # golden plans pin which regions fall back to greedy rules.
            root._memo_abstained = True
            return
        for j in _joins_of(root):
            annotated.add(id(j))
        best = None
        for a in alts.values():
            extra = _agg_extra(agg, a.sharding, catalog, nseg) \
                if agg is not None else 0.0
            if best is None or a.cost + extra < best[0]:
                best = (a.cost + extra, a)
        for jn, choice in best[1].choices:
            jn._dist_choice = choice

    def visit(node: N.PlanNode) -> None:
        if id(node) in seen:  # PShare reuse
            return
        seen.add(id(node))
        if isinstance(node, N.PAgg) and node.mode == "single":
            j = _through_chain(node.child)
            if isinstance(j, N.PJoin) and id(j) not in annotated \
                    and not getattr(j, "_joint", False):
                # explore from the agg's child so the Filter/Project
                # chain folds its renames into each alternative's
                # sharding — _agg_extra must see exactly the locus
                # Distributor._agg will test
                region(node.child, node)
        elif isinstance(node, N.PJoin) and id(node) not in annotated \
                and not getattr(node, "_joint", False):
            region(node, None)
        for c in node.children():
            visit(c)
        # uncorrelated scalar subqueries (InitPlan analog) carry their
        # own plans inside expressions; the distributor walks them, so
        # the memo explores them too
        for e in _node_exprs(node):
            for sub in ex.walk(e):
                if isinstance(sub, ex.SubqueryScalar):
                    visit(sub.plan)

    visit(plan)
