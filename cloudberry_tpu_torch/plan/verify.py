"""The derived distribution of a distributed plan, for EXPLAIN's
``dist:`` annotation.

The JAX package's plan verifier (plan/verify.py there, "planck") walks a
physical plan bottom-up, DERIVES each node's distribution from a
per-node-class rule table that mirrors what plan/distribute.py is
allowed to build, and checks each node's required properties against
it. ``Session.explain`` at ``n_segments > 1`` stamps the derived
distribution on every node (``_vdist``), and the plan text prints it
beside the distributor's stamped locus.

The port carries the derivation only: ``annotate_derived`` with the
rule table's ``dist`` arm, node for node the reference's. The checks,
the session gate (``debug.verify_plans``), the golden-corpus tools and
the fuzzer (plan/mutate.py) are not ported yet (ROADMAP Queue A 6).
"""

from __future__ import annotations

from typing import Optional

from cloudberry_tpu_torch.plan import expr as ex
from cloudberry_tpu_torch.plan import nodes as N
from cloudberry_tpu_torch.plan.distribute import (_hashed_key_positions,
                                                  _node_exprs,
                                                  _project_sharding,
                                                  _rename_sharding)
from cloudberry_tpu_torch.plan.sharding import Sharding


def annotate_derived(plan: N.PlanNode, session) -> None:
    """Stamp every node (scalar-subquery plans included) with its
    DERIVED distribution (``_vdist``). A direct-dispatch plan runs on
    one segment, where distribution is vacuous: nothing is stamped."""
    if session.config.n_segments <= 1 \
            or getattr(plan, "_direct_segment", None) is not None:
        return
    _Derivation(session.catalog).walk(plan)


class _Derivation:
    def __init__(self, catalog):
        self.catalog = catalog
        self._memo: dict[int, Sharding] = {}   # PShare / shared builds

    def walk(self, node: N.PlanNode) -> Sharding:
        got = self._memo.get(id(node))
        if got is not None:
            return got
        kids = [self.walk(c) for c in node.children()]
        # uncorrelated scalar subqueries ride inside expressions — each
        # is its own rooted plan
        for e in _node_exprs(node):
            for sub in ex.walk(e):
                if isinstance(sub, ex.SubqueryScalar):
                    self.walk(sub.plan)
        rule = _RULES.get(type(node).__name__)
        d = rule(self, node, kids) if rule is not None \
            else Sharding.strewn()
        self._memo[id(node)] = d
        node._vdist = d
        return d


def _scan(v: _Derivation, node: N.PScan, kids) -> Sharding:
    """The table's distribution policy: hashed on the (renamed)
    distribution keys when they survive pruning, strewn when they do
    not, replicated for replicated tables, general for $dual."""
    if node.table_name == "$dual":
        return Sharding.general()
    try:
        table = v.catalog.table(node.table_name)
    except KeyError:
        return Sharding.strewn()
    pol = table.policy
    if pol.kind == "replicated":
        return Sharding.replicated()
    if pol.kind == "hashed" and all(k in node.column_map for k in pol.keys):
        return Sharding.hashed(*(node.column_map[k] for k in pol.keys))
    return Sharding.strewn()


def _same(v: _Derivation, node, kids) -> Sharding:
    """Filters, sorts, limits, windows, runtime filters and shares keep
    their child's distribution."""
    return kids[0]


def _project(v: _Derivation, node: N.PProject, kids) -> Sharding:
    """Column renames carry hashed keys; keys projected away degrade to
    strewn."""
    return _project_sharding(kids[0], node.exprs)


def _singleton(v: _Derivation, node, kids) -> Sharding:
    """Set-op appends (gathered inputs) and the tiled finalize
    program's accumulator leaf live in one place."""
    return Sharding.singleton()


def _agg(v: _Derivation, node: N.PAgg, kids) -> Sharding:
    """A one-stage or final agg over a partitioned child renames the
    child's hash keys to its group keys; a partial agg stays where its
    child is."""
    csh = kids[0]
    if node.mode in ("single", "final") and csh.is_partitioned \
            and node.group_keys:
        return _rename_sharding(csh, node.group_keys)
    return csh


def _join(v: _Derivation, node: N.PJoin, kids) -> Sharding:
    """A join runs where its probe lives, except an inner or semi join
    of a partitioned build and an unpartitioned probe: its rows are
    hashed on the probe keys matching the build's hash keys."""
    bsh, psh = kids
    if node.kind == "full" or not bsh.is_partitioned or psh.is_partitioned \
            or node.kind not in ("inner", "semi"):
        return psh
    bsub: Optional[list] = _hashed_key_positions(bsh, node.build_keys)
    if bsub is None:
        return Sharding.strewn()
    names = [node.probe_keys[i].name for i in bsub
             if isinstance(node.probe_keys[i], ex.ColumnRef)]
    return Sharding.hashed(*names) if len(names) == len(bsub) \
        else Sharding.strewn()


def _motion(v: _Derivation, node: N.PMotion, kids) -> Sharding:
    """Gather derives singleton, broadcast replicated, redistribute
    hashed on its key columns (strewn when a key is an expression)."""
    if node.kind == "gather":
        return Sharding.singleton()
    if node.kind == "broadcast":
        return Sharding.replicated()
    names = tuple(k.name for k in node.hash_keys
                  if isinstance(k, ex.ColumnRef))
    if node.kind == "redistribute" and names \
            and len(names) == len(node.hash_keys):
        return Sharding.hashed(*names)
    return Sharding.strewn()


_RULES = {
    "PScan": _scan, "PFilter": _same, "PProject": _project,
    "PShare": _same, "PLimit": _same, "PSort": _same, "PWindow": _same,
    "PConcat": _singleton, "PAgg": _agg, "PJoin": _join,
    "PRuntimeFilter": _same, "PMotion": _motion, "_AccLeaf": _singleton,
}
