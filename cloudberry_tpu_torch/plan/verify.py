"""planck — the distributed-plan IR verifier (derived vs required
properties).

The reference's ORCA optimizer never trusts a plan it did not prove:
every Cascades group tracks *required* vs *derived* plan properties
(CDistributionSpec / COrderSpec) and enforcers are inserted until they
match. Our planner stamps those properties by hand — the distribution
pass writes ``node.sharding``, the memo stamps ``_dist_choice``, the
runtime-filter pass wraps probes, the paramplan rewrites literals into
slots — and until this module nothing ever CHECKED them. A wrong
sharding assumption at 8 segments is not a crash; it is a silently
wrong answer (Theseus' "cost of data movement done wrong").

``verify_plan(plan, session)`` walks any physical plan bottom-up and:

1. **derives** each node's distribution (the CdbPathLocus currency,
   plan/sharding.py) and static row bound from a per-node-class rule
   table (``RULES``), mirroring exactly what plan/distribute.py is
   ALLOWED to produce — scan inherits table policy, motions produce
   hashed/replicated/singleton, joins stay where colocation puts them;
2. checks each node's **required** properties against what its
   children derived: joins need colocation or a motion on an edge,
   two-stage aggs need partial-merge compatibility and colocated
   partials, windows need partition-key colocation, set-ops need
   gathered inputs, the root must not stay partitioned;
3. checks the **lowering contracts** that previously lived only in
   reviewers' heads: packed-wire dtype legality (the int64/DECIMAL
   limb convention ships 4/8-byte words — kernels.WIRE_ITEMSIZES),
   capacity-rung discipline (bucket caps sit ON the rung ladder and
   never undercut the exact skew bound unless a runtime filter
   justifies it), ``$params`` slot consistency between the paramplan
   signature and the plan, join-index (``_jix``) annotation legality,
   runtime-filter placement (the digest must sit probe-side of the
   shuffle it prices), validity-mask closure, and recovery-mode
   re-placeability (every checkpointing tiled mode has a declared
   re-placement rule).

Every finding carries a ``file``-style node path (``Limit/Sort/
Join(inner).probe/Motion(redistribute)``), a rule id, and a message; the
rule ids and paths are the JAX package's, finding for finding.

The verifier checks SOUNDNESS, not optimality: a plan that broadcasts
where a redistribute would be cheaper is legal; a plan whose join
inputs are not colocated and have no motion is not.

Run three ways: ``Session.explain`` at ``n_segments > 1`` stamps the
derived distribution on every node (``annotate_derived``, EXPLAIN's
``dist:`` suffix), the ``config.debug.verify_plans`` session gate (every
plan the planner or memo emits, the greedy re-plan of a refused plan and
every generic-plan build is verified right before it runs), and the
plan-mutation fuzzer (plan/mutate.py's corruption classes, each of which
must be caught).

The two-level (hierarchical) motion stamps and host-combine stamps are
checked whenever any is present, whatever the live host layout
(``_check_two_level``, ``_check_host_combine``: rules
``motion-host-grouping``, ``motion-host-rung``, ``motion-host-capacity``
and ``motion-host-combine``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from cloudberry_tpu_torch.plan import expr as ex
from cloudberry_tpu_torch.plan import nodes as N
from cloudberry_tpu_torch.plan.sharding import Sharding

# ------------------------------------------------------------ findings


@dataclass
class PlanFinding:
    """One verifier diagnostic, anchored at a node path."""

    rule: str
    path: str                 # e.g. "Limit/Sort/Join(inner).probe/Motion"
    message: str

    def render(self) -> str:
        return f"{self.path}: {self.rule}: {self.message}"

    def as_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path,
                "message": self.message}


class PlanVerifyError(RuntimeError):
    """Raised by the ``config.debug.verify_plans`` session gate when a
    plan fails verification; carries the full finding list."""

    def __init__(self, findings: list[PlanFinding], context: str = ""):
        self.findings = findings
        head = f"plan verification failed ({context}): " if context \
            else "plan verification failed: "
        super().__init__(head + "; ".join(f.render() for f in findings))


# ------------------------------------------------- derived properties


@dataclass(frozen=True)
class Props:
    """Derived per-node physical properties — the bottom-up currency.

    ``dist``  — the derived Sharding (None only while deriving a
                local-mode plan, where distribution is vacuous);
    ``rows``  — static per-location row bound (the capacity currency:
                every buffer has a static capacity, so every node has
                one).

    Ordering is deliberately NOT part of the lattice: the one ordering
    contract (motions destroy order; the top-N pushdown must re-sort
    above its pre-compacting gather) is checked STRUCTURALLY against
    the exact key lists (_check_topn_merge) — stronger than any
    derived summary of them.
    """

    dist: Optional[Sharding]
    rows: int


@dataclass
class NodeRule:
    """One row of the rule table: how a node class derives its
    properties and what it requires of its children."""

    name: str
    fn: Callable          # fn(v, node, kids: list[Props], path) -> Props
    doc: str = ""


RULES: dict[str, NodeRule] = {}


def rule(*names: str, doc: str = ""):
    """Register the derive/require rule for the named PlanNode
    class(es). Registration is BY NAME, so the table can be pinned
    against plan/nodes.py both ways (no unverifiable node class, no
    orphan rule)."""

    def deco(fn):
        for nm in names:
            RULES[nm] = NodeRule(nm, fn, doc)
        return fn
    return deco


def _label(node: N.PlanNode) -> str:
    nm = type(node).__name__.removeprefix("P")
    if isinstance(node, N.PMotion):
        return f"Motion({node.kind})"
    if isinstance(node, N.PJoin):
        return f"Join({node.kind})"
    if isinstance(node, N.PAgg):
        return f"Agg({node.mode})"
    if isinstance(node, N.PScan):
        return f"Scan({node.table_name})"
    if isinstance(node, N.PRuntimeFilter):
        return f"RuntimeFilter({node.mode})"
    return nm


def _edge_labels(node: N.PlanNode) -> list[str]:
    """Per-child edge names for node paths (build/probe for joins,
    positional for set-ops, empty for single-child chains)."""
    if isinstance(node, N.PJoin):
        return ["build:", "probe:"]
    if isinstance(node, N.PConcat):
        return [f"[{i}]:" for i in range(len(node.inputs))]
    return ["" for _ in node.children()]


# ------------------------------------------------------------ verifier


class Verifier:
    """One verification walk. ``local`` mode (n_segments == 1 or a
    direct-dispatch plan) skips distribution derivation — sharding is
    vacuous there — but keeps every lowering-contract check."""

    def __init__(self, session, plan: N.PlanNode,
                 declared_slots: Optional[list] = None,
                 declared_nrw: Optional[int] = None):
        self.session = session
        self.catalog = session.catalog
        self.nseg = session.config.n_segments
        self.local = (self.nseg <= 1
                      or getattr(plan, "_direct_segment", None) is not None)
        self.declared_slots = declared_slots
        self.declared_nrw = declared_nrw
        self.findings: list[PlanFinding] = []
        self.nodes_checked = 0
        self.rules_hit: set[str] = set()
        self._memo: dict[int, Props] = {}   # PShare / shared-build reuse
        self._parent: dict[int, tuple] = {}  # id -> (parent, edge label)
        self._build_ids: set[int] = set()   # nodes under some join build
        # $params slots seen during the walk: slot -> {(dtype, path)}
        self._params: dict[int, set] = {}
        # $nrw scan row-count slots seen during the walk: key -> [path]
        self._nrw: dict[str, list] = {}

    # ------------------------------------------------------- reporting

    def fail(self, rule_id: str, path: str, msg: str) -> None:
        self.findings.append(PlanFinding(rule_id, path, msg))

    # --------------------------------------------------------- walking

    def verify(self, plan: N.PlanNode) -> list[PlanFinding]:
        self._index(plan, None, "")
        root = self.walk(plan, _label(plan))
        if not self.local and root.dist is not None \
                and root.dist.is_partitioned:
            self.fail("root-partitioned", _label(plan),
                      f"statement root derives {root.dist} — results "
                      "must be gathered (singleton) or replicated "
                      "before they reach the coordinator slot")
        self._check_params(plan)
        self._check_nrw(_label(plan))
        self._check_recovery_modes(_label(plan))
        return self.findings

    def _index(self, node: N.PlanNode, parent, edge: str) -> None:
        """Parent pointers + the set of nodes under join build edges
        (runtime-filter build sharing checks both)."""
        if id(node) in self._parent:
            return
        self._parent[id(node)] = (parent, edge)
        kids = node.children()
        labels = _edge_labels(node)
        for c, lab in zip(kids, labels):
            self._index(c, node, lab)
            if lab == "build:":
                for sub in _subtree(c):
                    self._build_ids.add(id(sub))
        for e in _node_exprs(node):
            for sub in ex.walk(e):
                if isinstance(sub, ex.SubqueryScalar):
                    self._index(sub.plan, node, "$subquery:")

    def walk(self, node: N.PlanNode, path: str) -> Props:
        got = self._memo.get(id(node))
        if got is not None:
            return got
        self.nodes_checked += 1
        nr = RULES.get(type(node).__name__)
        if nr is None:
            self.fail("planprops-unruled", path,
                      f"no planprops rule for node class "
                      f"{type(node).__name__} — add a @rule row in "
                      "plan/verify.py before this node can be verified")
            props = Props(None if self.local else Sharding.strewn(),
                          rows=1)
            self._memo[id(node)] = props
            return props
        self.rules_hit.add(nr.name)
        kids = []
        labels = _edge_labels(node)
        for c, lab in zip(node.children(), labels):
            kids.append(self.walk(c, f"{path}/{lab}{_label(c)}"))
        # uncorrelated scalar subqueries ride inside expressions — each
        # is its own rooted plan and must not stay partitioned (its one
        # row broadcasts into the enclosing expression); $params slots
        # are collected in the same pass (the slot-discipline check
        # runs once at the end, without a second plan walk)
        for e in _node_exprs(node):
            for sub in ex.walk(e):
                if isinstance(sub, ex.Param):
                    self._params.setdefault(sub.slot, set()).add(
                        (sub.dtype, path))
                if isinstance(sub, ex.SubqueryScalar):
                    sp = self.walk(sub.plan,
                                   f"{path}/$subquery:{_label(sub.plan)}")
                    if not self.local and sp.dist is not None \
                            and sp.dist.is_partitioned:
                        self.fail(
                            "root-partitioned",
                            f"{path}/$subquery:{_label(sub.plan)}",
                            f"scalar-subquery plan derives {sp.dist} — "
                            "its single row must be gathered before it "
                            "broadcasts into the enclosing expression")
        props = nr.fn(self, node, kids, path)
        self._check_masks(node, path)
        if not self.local and node.sharding is not None \
                and props.dist is not None \
                and node.sharding != props.dist:
            self.fail("dist-mismatch", path,
                      f"stamped sharding {node.sharding} != derived "
                      f"{props.dist} — the node lies about where its "
                      "rows live")
        self._memo[id(node)] = props
        return props

    # ----------------------------------------------- generic contracts

    def _check_masks(self, node: N.PlanNode, path: str) -> None:
        """Validity-mask closure: every null_mask name a field carries
        must resolve to a BOOL field of the SAME node (or a mask the
        scan's mask_map provides) — a dangling mask would make the
        lowerer read a missing column or, worse, treat NULLs as
        values."""
        provided = {f.name for f in node.fields}
        if isinstance(node, N.PScan):
            provided |= set(node.mask_map.values())
        for f in node.fields:
            for m in f.masks:
                if m not in provided:
                    self.fail("mask-dangling", path,
                              f"field {f.name!r} declares validity mask "
                              f"{m!r} which is not a field of this node")

    def _check_params(self, plan: N.PlanNode) -> None:
        """$params slot discipline: slots dense, dtype-consistent, and
        — when the paramplan signature is in scope — exactly the
        declared vector. A desynced slot binds a literal into the
        wrong predicate. Slots were collected during the main walk."""
        slots = self._params
        if not slots and not self.declared_slots:
            return
        for slot, uses in sorted(slots.items()):
            dts = {dt for dt, _ in uses}
            anyp = next(p for _, p in uses)
            if slot < 0:
                self.fail("param-slot-desync", anyp,
                          f"negative $params slot {slot}")
            if len(dts) > 1:
                self.fail("param-slot-desync", anyp,
                          f"$params slot {slot} used at conflicting "
                          f"dtypes {sorted(str(d) for d in dts)}")
        if self.declared_slots is not None:
            n = len(self.declared_slots)
            for slot, uses in sorted(slots.items()):
                dt, path = next(iter(uses))
                if slot >= n:
                    self.fail("param-slot-desync", path,
                              f"$params slot {slot} outside the "
                              f"paramplan signature ({n} slots)")
                elif self.declared_slots[slot] != dt:
                    self.fail("param-slot-desync", path,
                              f"$params slot {slot} dtype {dt} != "
                              f"signature dtype "
                              f"{self.declared_slots[slot]}")
            # a declared slot with NO site is the same desync from the
            # other side: the binding vector carries a value the plan
            # never reads, and every later slot is suspect
            missing = [i for i in range(n) if i not in slots]
            if missing:
                self.fail("param-slot-desync", _label(plan),
                          f"paramplan signature declares slot(s) "
                          f"{missing} with no $params site in the plan")
        elif slots:
            # no signature in scope: slots must still be dense — a gap
            # means a binding vector entry with no site (or vice versa)
            want = set(range(max(slots) + 1))
            missing = want - set(slots)
            if missing:
                anyp = next(p for _, p in next(iter(slots.values())))
                self.fail("param-slot-desync", anyp,
                          f"$params slots not dense: missing "
                          f"{sorted(missing)} of 0..{max(slots)}")

    def _check_nrw(self, root_path: str) -> None:
        """$nrw (scan row-count) slot discipline for rewritten generic
        plans: every stamped ``_nrows_key`` is unique to ONE scan, the
        indices are dense, and — when the paramplan binding count is
        in scope — exactly as many as the signature declares. A
        desynced $nrw feeds one scan's runtime row count into
        another's padding mask."""
        if not self._nrw and not self.declared_nrw:
            return
        idxs: set[int] = set()
        for key, paths in sorted(self._nrw.items()):
            if len(paths) > 1:
                self.fail("param-slot-desync", paths[1],
                          f"$nrw slot {key!r} stamped on "
                          f"{len(paths)} scans — each scan needs its "
                          "own row-count input")
            if not key.startswith("$nrw"):
                self.fail("param-slot-desync", paths[0],
                          f"malformed scan row-count key {key!r}")
                continue
            try:
                idxs.add(int(key[4:]))
            except ValueError:
                self.fail("param-slot-desync", paths[0],
                          f"malformed scan row-count key {key!r}")
        if idxs:
            missing = set(range(max(idxs) + 1)) - idxs
            if missing:
                self.fail("param-slot-desync", root_path,
                          f"$nrw slots not dense: missing "
                          f"{sorted(missing)} of 0..{max(idxs)}")
        if self.declared_nrw is not None \
                and len(self._nrw) != self.declared_nrw:
            self.fail("param-slot-desync", root_path,
                      f"plan carries {len(self._nrw)} $nrw scan "
                      f"row-count slots; the paramplan signature "
                      f"binds {self.declared_nrw}")

    def _check_recovery_modes(self, path: str) -> None:
        """Recovery-signature stability: every tiled mode that
        checkpoints (exec/tiled.py CHECKPOINT_MODES) must carry a
        declared re-placement rule (exec/recovery.py REPLACEABLE) —
        a checkpointed mode nobody can re-place on a degraded mesh
        would resume into a wrong answer."""
        from cloudberry_tpu_torch.exec.recovery import REPLACEABLE
        from cloudberry_tpu_torch.exec.tiled import CHECKPOINT_MODES

        for mode in CHECKPOINT_MODES:
            if mode not in REPLACEABLE:
                self.fail("recovery-mode-unreplaceable", path,
                          f"tiled mode {mode!r} checkpoints but has no "
                          "re-placement rule in exec/recovery.py "
                          "REPLACEABLE")
        for mode in REPLACEABLE:
            if mode not in CHECKPOINT_MODES:
                self.fail("recovery-mode-unreplaceable", path,
                          f"recovery declares re-placement for mode "
                          f"{mode!r} which no tiled executor "
                          "checkpoints (stale rule)")

    # ------------------------------------------------- motion helpers

    def exact_bucket_bound(self, child: N.PlanNode,
                           keys) -> Optional[int]:
        """The exact per-(source,destination) bucket bound for a
        redistribute whose subtree is a (filtered) base-table scan —
        the same computation the distributor sized the motion with
        (Distributor._exact_bucket_cap, cached on the session)."""
        from cloudberry_tpu_torch.plan.distribute import Distributor

        try:
            return Distributor(self.session)._exact_bucket_cap(
                child, keys)
        except Exception:
            return None

    def exact_host_bound(self, child: N.PlanNode, keys,
                         n_hosts: int) -> Optional[int]:
        """The exact (source host, destination host) exchange bound for
        a scan-rooted redistribute — the same computation the
        distributor sized host_bucket_cap with (_exact_host_cap)."""
        from cloudberry_tpu_torch.plan.distribute import Distributor

        try:
            return Distributor(self.session)._exact_host_cap(
                child, keys, n_hosts)
        except Exception:
            return None


def _subtree(node: N.PlanNode):
    yield node
    for c in node.children():
        yield from _subtree(c)


def _walk_paths(plan: N.PlanNode):
    """(node, path) for every node including subquery plans — the
    path currency findings anchor to."""
    def rec(node, path, seen):
        if id(node) in seen:
            return
        seen.add(id(node))
        yield node, path
        for c, lab in zip(node.children(), _edge_labels(node)):
            yield from rec(c, f"{path}/{lab}{_label(c)}", seen)
        for e in _node_exprs(node):
            for sub in ex.walk(e):
                if isinstance(sub, ex.SubqueryScalar):
                    yield from rec(sub.plan,
                                   f"{path}/$subquery:{_label(sub.plan)}",
                                   seen)
    yield from rec(plan, _label(plan), set())


# ----------------------------------------------------------- the rules
#
# Each rule mirrors the ONE way plan/distribute.py is allowed to build
# that node class. The imports below are the shared helpers — using the
# distributor's own sharding algebra keeps the two from drifting.

from cloudberry_tpu_torch.plan.distribute import (_hashed_key_positions,  # noqa: E402
                                            _join_colocated,
                                            _node_exprs,
                                            _project_sharding,
                                            _rename_sharding)


@rule("PScan", doc="inherits the table's distribution policy: hashed "
                   "on the (renamed) distribution keys when they "
                   "survive pruning, strewn when they do not, "
                   "replicated for replicated tables, general for "
                   "$dual")
def _r_scan(v: Verifier, node: N.PScan, kids, path) -> Props:
    nk = getattr(node, "_nrows_key", None)
    if nk is not None:
        v._nrw.setdefault(nk, []).append(path)
    if node.capacity < 1:
        v.fail("scan-rows", path,
               f"scan capacity {node.capacity} < 1 (buffers need a "
               "static nonempty shape)")
    if node.num_rows < -2:
        v.fail("scan-rows", path, f"scan num_rows {node.num_rows} is "
               "not a row count / -1 (== capacity) / -2 (runtime "
               "per-segment counts)")
    if node.num_rows > node.capacity:
        v.fail("scan-rows", path,
               f"scan num_rows {node.num_rows} > capacity "
               f"{node.capacity}")
    if node.num_rows == -2 and v.local:
        v.fail("scan-rows", path,
               "num_rows == -2 (runtime per-segment counts) in a "
               "single-segment / direct-dispatch plan — there is no "
               "$nrw input to read")
    if v.local:
        return Props(None, node.capacity)
    if node.table_name == "$dual":
        return Props(Sharding.general(), node.capacity)
    try:
        table = v.catalog.table(node.table_name)
    except KeyError:
        return Props(Sharding.strewn(), node.capacity)
    pol = table.policy
    if pol.kind == "replicated":
        return Props(Sharding.replicated(), node.capacity)
    if pol.kind == "hashed" and all(k in node.column_map
                                    for k in pol.keys):
        return Props(Sharding.hashed(*(node.column_map[k]
                                       for k in pol.keys)),
                     node.capacity)
    return Props(Sharding.strewn(), node.capacity)


@rule("PFilter", doc="preserves the child's distribution; requires a "
                     "BOOL predicate")
def _r_filter(v: Verifier, node: N.PFilter, kids, path) -> Props:
    from cloudberry_tpu_torch.types import BOOL

    pd = getattr(node.predicate, "dtype", None)
    if pd is not None and pd != BOOL:
        v.fail("filter-pred-type", path,
               f"filter predicate has dtype {pd}, not BOOL")
    return Props(kids[0].dist, kids[0].rows)


@rule("PProject", doc="preserves distribution through column renames "
                      "(hashed keys projected away degrade to strewn)")
def _r_project(v: Verifier, node: N.PProject, kids, path) -> Props:
    d = kids[0].dist
    if d is not None:
        d = _project_sharding(d, node.exprs)
    return Props(d, kids[0].rows)


@rule("PShare", doc="the shared subplan computes once; every reference "
                    "sees its distribution")
def _r_share(v: Verifier, node: N.PShare, kids, path) -> Props:
    return kids[0]


@rule("PLimit", doc="preserves distribution; bounds rows at "
                    "limit+offset")
def _r_limit(v: Verifier, node: N.PLimit, kids, path) -> Props:
    if node.limit < 0 or node.offset < 0:
        v.fail("limit-bounds", path,
               f"negative limit/offset ({node.limit}, {node.offset})")
    k = node.limit + node.offset
    rows = min(kids[0].rows, k) if k > 0 else kids[0].rows
    return Props(kids[0].dist, max(rows, 1))


@rule("PSort", doc="preserves distribution; a partitioned sort is "
                   "only legal as the local half of the top-N merge "
                   "pattern (checked structurally at the gather)")
def _r_sort(v: Verifier, node: N.PSort, kids, path) -> Props:
    return Props(kids[0].dist, kids[0].rows)


@rule("PWindow", doc="requires partition-key colocation when the "
                     "child is partitioned (every partition's rows on "
                     "one segment)")
def _r_window(v: Verifier, node: N.PWindow, kids, path) -> Props:
    d = kids[0].dist
    if d is not None and d.is_partitioned:
        names = {e.name for e in node.partition_keys
                 if isinstance(e, ex.ColumnRef)}
        ok = (d.kind == "hashed" and d.keys and set(d.keys) <= names)
        if not ok:
            v.fail("window-not-colocated", path,
                   f"window over {d} child: partition keys "
                   f"{sorted(names) or '(none)'} do not cover the "
                   "child's hash keys — a partition's rows would span "
                   "segments and every frame would be wrong")
    return Props(d, kids[0].rows)


@rule("PConcat", doc="set-op append: every input must be gathered "
                     "(non-partitioned) first; output is singleton")
def _r_concat(v: Verifier, node: N.PConcat, kids, path) -> Props:
    labels = _edge_labels(node)
    for i, kp in enumerate(kids):
        if kp.dist is not None and kp.dist.is_partitioned:
            v.fail("concat-partitioned-input",
                   f"{path}/{labels[i]}{_label(node.inputs[i])}",
                   f"append input {i} derives {kp.dist} — set-op "
                   "inputs are gathered before appending (a "
                   "partitioned input would append one shard only)")
    total = sum(k.rows for k in kids) or 1
    return Props(None if v.local else Sharding.singleton(), total)


@rule("PAgg", doc="single mode requires group-key colocation on a "
                  "partitioned child; final mode requires gathered or "
                  "group-key-hashed partials and partial-merge-"
                  "compatible aggregate pairs")
def _r_agg(v: Verifier, node: N.PAgg, kids, path) -> Props:
    if node.capacity < 1:
        v.fail("agg-capacity", path,
               f"agg capacity {node.capacity} < 1")
    csh = kids[0].dist
    key_src = {e.name for _, e in node.group_keys
               if isinstance(e, ex.ColumnRef)}
    if node.mode == "single":
        if csh is not None and csh.is_partitioned:
            if not (node.group_keys and csh.kind == "hashed"
                    and csh.keys and set(csh.keys) <= key_src):
                v.fail("agg-single-not-colocated", path,
                       f"one-stage agg over {csh} child: group keys "
                       f"{sorted(key_src) or '(none)'} do not cover "
                       "the child's hash keys — equal groups would "
                       "live on several segments and each would "
                       "aggregate alone")
            d = _rename_sharding(csh, node.group_keys) \
                if node.group_keys else csh
        else:
            d = csh
        return Props(d, node.capacity)
    if node.mode == "partial":
        return Props(csh, node.capacity)
    if node.mode != "final":
        v.fail("agg-merge-illegal", path,
               f"unknown agg mode {node.mode!r}")
        return Props(csh, node.capacity)
    # final: all partial rows of one group must be in one place
    if csh is not None and csh.is_partitioned:
        ok = (node.group_keys and csh.kind == "hashed" and csh.keys
              and set(csh.keys) <= key_src)
        if not ok:
            v.fail("agg-final-partials-split", path,
                   f"final agg over {csh} child: partial rows of one "
                   "group are not guaranteed colocated (need a gather "
                   "or a redistribute on the group keys) — merged "
                   "sums would be partial sums")
    _check_merge_pairs(v, node, path)
    if csh is not None and csh.is_partitioned and node.group_keys:
        d = _rename_sharding(csh, node.group_keys)
    else:
        d = csh
    return Props(d, node.capacity)


# the legal (partial, final-merge) aggregate pairs — the _split_aggs
# contract (plan/distribute.py): how each aggregate decomposes across
# the motion boundary. avg never crosses it whole (it splits into
# sum+count and re-divides in a finalize projection).
MERGE_OF = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


def _check_merge_pairs(v: Verifier, node: N.PAgg, path: str) -> None:
    for name, call in node.aggs:
        if call.func not in set(MERGE_OF.values()):
            v.fail("agg-merge-illegal", path,
                   f"final agg {name!r} merges with {call.func!r} — "
                   f"legal merge functions are "
                   f"{sorted(set(MERGE_OF.values()))}")
        if not isinstance(call.arg, ex.ColumnRef):
            v.fail("agg-merge-illegal", path,
                   f"final agg {name!r} must merge a partial COLUMN, "
                   f"got {type(call.arg).__name__}")
    # the partial stage below (through the motion) must emit columns a
    # legal pair can merge: find it and check func pairing by name
    below = node.child
    while isinstance(below, (N.PMotion, N.PShare)):
        below = below.child
    if not (isinstance(below, N.PAgg) and below.mode == "partial"):
        v.fail("agg-final-no-partial", path,
               f"final agg's input chain reaches "
               f"{type(below).__name__} — two-stage aggregation "
               "merges a PARTIAL stage's output")
        return
    partial_funcs = {n: c.func for n, c in below.aggs}
    for name, call in node.aggs:
        if not isinstance(call.arg, ex.ColumnRef):
            continue
        src = partial_funcs.get(call.arg.name)
        if src is None:
            continue  # group-key column or renamed — arity noise
        want = MERGE_OF.get(src)
        if want is not None and call.func != want:
            v.fail("agg-merge-illegal", path,
                   f"final agg {name!r} merges partial "
                   f"{src!r} with {call.func!r}; the declared merge "
                   f"of {src!r} is {want!r}")


@rule("PJoin", doc="requires colocation (or an already-inserted motion "
                   "on an edge): both-partitioned sides must hash on "
                   "corresponding key positions; left/anti builds must "
                   "be visible everywhere; full joins need colocation "
                   "or two gathered sides")
def _r_join(v: Verifier, node: N.PJoin, kids, path) -> Props:
    bprops, pprops = kids
    if len(node.build_keys) != len(node.probe_keys):
        v.fail("join-key-arity", path,
               f"{len(node.build_keys)} build keys vs "
               f"{len(node.probe_keys)} probe keys")
    if not node.unique_build and node.out_capacity < 1:
        v.fail("join-out-capacity", path,
               "expansion join (unique_build=False) with no "
               "out_capacity — the pair buffer would be empty")
    _check_join_index(v, node, path)
    rows = _join_rows(node, bprops.rows, pprops.rows)
    if v.local:
        return Props(None, rows)
    bsh, psh = bprops.dist, pprops.dist
    b_part, p_part = bsh.is_partitioned, psh.is_partitioned
    if node.kind == "full":
        if b_part and p_part:
            if not _join_colocated(node, bsh, psh):
                v.fail("join-not-colocated", path,
                       f"full join over {bsh} build / {psh} probe "
                       "without key colocation — unmatched rows would "
                       "be missed or duplicated")
            return Props(psh, rows)
        if b_part or p_part:
            v.fail("join-full-dist", path,
                   f"full join with {bsh} build / {psh} probe: a "
                   "replicated or singleton side against a "
                   "partitioned one emits unmatched rows once PER "
                   "SEGMENT — both sides must be gathered or "
                   "colocated")
        return Props(psh, rows)
    if b_part and p_part:
        if not _join_colocated(node, bsh, psh):
            v.fail("join-not-colocated", path,
                   f"join over {bsh} build / {psh} probe: sides are "
                   "not hash-colocated on corresponding join keys and "
                   "no motion was inserted — equal keys would never "
                   "meet")
        return Props(psh, rows)
    if b_part and not p_part:
        if node.kind not in ("inner", "semi"):
            v.fail("join-outer-build-partitioned", path,
                   f"{node.kind} join with partitioned build "
                   f"({bsh}) and {psh} probe: deciding that a probe "
                   "row matches NOWHERE needs the whole build side "
                   "on every segment")
            return Props(psh, rows)
        bsub = _hashed_key_positions(bsh, node.build_keys)
        if bsub is not None:
            names = [node.probe_keys[i].name for i in bsub
                     if isinstance(node.probe_keys[i], ex.ColumnRef)]
            d = (Sharding.hashed(*names) if len(names) == len(bsub)
                 else Sharding.strewn())
        else:
            d = Sharding.strewn()
        return Props(d, rows)
    # remaining arms: build is not partitioned (replicated/singleton/
    # general build beside any probe) — the join runs where the probe
    # lives
    return Props(psh, rows)


def _join_rows(node: N.PJoin, brows: int, prows: int) -> int:
    if node.residual is not None:
        return prows
    if not node.unique_build:
        return max(node.out_capacity, 1)
    return prows


def _check_join_index(v: Verifier, node: N.PJoin, path: str) -> None:
    """Join-index (``_jix``) annotation legality: the stamp must be
    exactly what exec/joinindex.py would derive for this join TODAY —
    a stale or hand-forged spec would feed a cached sort order built
    for a different build fragment."""
    spec = getattr(node, "_jix", None)
    if spec is None:
        return
    from cloudberry_tpu_torch.exec.joinindex import _build_spec

    direct = v.local and v.nseg > 1
    try:
        want = _build_spec(node, v.session, v.nseg, direct)
    except Exception:
        want = None
    if want is None or want.key != spec.key:
        v.fail("jix-illegal", path,
               f"join-index annotation {getattr(spec, 'key', spec)!r} "
               "does not match what exec/joinindex.py derives for "
               f"this join ({getattr(want, 'key', None)!r}) — the "
               "cached sorted-build scaffolding would not describe "
               "this build side")


@rule("PRuntimeFilter", doc="passes the probe through unchanged; must "
                            "sit probe-side of (directly under) the "
                            "redistribute it prices, sharing the "
                            "join's build subtree")
def _r_rfilter(v: Verifier, node: N.PRuntimeFilter, kids, path) -> Props:
    if not node.probe_keys or \
            len(node.build_keys) != len(node.probe_keys):
        v.fail("rf-keys", path,
               f"runtime filter with {len(node.build_keys)} build / "
               f"{len(node.probe_keys)} probe keys")
    if node.mode == "digest":
        bits = node.bloom_bits
        if bits < 64 or bits & (bits - 1):
            v.fail("rf-digest-bits", path,
                   f"digest bloom_bits {bits} is not a power of two "
                   ">= 64 (kernels.bloom word math relies on it)")
    elif node.mode != "exact":
        v.fail("rf-keys", path, f"unknown filter mode {node.mode!r}")
    parent, _ = v._parent.get(id(node), (None, ""))
    if not (isinstance(parent, N.PMotion)
            and parent.kind == "redistribute"):
        v.fail("rf-placement", path,
               "runtime filter is not directly under a redistribute "
               "motion — the digest must drop probe rows BEFORE the "
               "shuffle it prices (above it, the wire already paid)")
    if id(node.build) not in v._build_ids:
        v.fail("rf-build-unshared", path,
               "runtime filter's build reference is not a subtree of "
               "any join's build input — the filter would be built "
               "from rows the join never sees")
    return Props(kids[0].dist, kids[0].rows)


@rule("PMotion", doc="gather derives singleton, broadcast replicated, "
                     "redistribute hashed(keys); bucket capacities sit "
                     "on the rung ladder and never silently undercut "
                     "the exact skew bound; wire dtypes must pack")
def _r_motion(v: Verifier, node: N.PMotion, kids, path) -> Props:
    child = kids[0]
    _check_wire_fields(v, node, path)
    if child.dist is not None and not child.dist.is_partitioned:
        v.fail("motion-child-not-partitioned", path,
               f"motion over a {child.dist} child — the distributor "
               "only moves partitioned rows; this motion would "
               "duplicate or misroute them")
    if node.kind == "gather":
        d = Sharding.singleton()
        need = node.pre_compact if node.pre_compact > 0 else child.rows
        if node.out_capacity < need * v.nseg:
            v.fail("motion-capacity", path,
                   f"gather out_capacity {node.out_capacity} < "
                   f"{need} rows x {v.nseg} segments")
        if node.pre_compact > 0:
            _check_topn_merge(v, node, path)
        return Props(None if v.local else d, max(node.out_capacity, 1))
    if node.kind == "broadcast":
        if node.out_capacity < child.rows * v.nseg:
            v.fail("motion-capacity", path,
                   f"broadcast out_capacity {node.out_capacity} < "
                   f"{child.rows} rows x {v.nseg} segments")
        return Props(None if v.local else Sharding.replicated(),
                     max(node.out_capacity, 1))
    if node.kind != "redistribute":
        v.fail("motion-capacity", path,
               f"unknown motion kind {node.kind!r}")
        return Props(Sharding.strewn(), max(node.out_capacity, 1))
    if not node.hash_keys:
        v.fail("motion-hash-keys", path,
               "redistribute with no hash keys — rows have no "
               "destination function")
    from cloudberry_tpu_torch.exec.kernels import rung_up

    if node.bucket_cap < 8 or rung_up(node.bucket_cap) != node.bucket_cap:
        v.fail("motion-rung", path,
               f"redistribute bucket_cap {node.bucket_cap} is not a "
               "capacity rung (power of two >= 8) — off-ladder shapes "
               "defeat the bounded-recompile discipline and the "
               "grow-and-retry path")
    if node.out_capacity != node.bucket_cap * v.nseg:
        v.fail("motion-capacity", path,
               f"redistribute out_capacity {node.out_capacity} != "
               f"bucket_cap {node.bucket_cap} x {v.nseg} segments")
    exact = v.exact_bucket_bound(node.child, node.hash_keys)
    if exact is not None and node.bucket_cap < rung_up(max(exact, 8)):
        # undercutting the exact skew bound is legal ONLY when a
        # runtime filter below shrank the input (overflow then
        # promotes back up the ladder); without one, a hot key is a
        # guaranteed overflow the exact bound existed to prevent
        if _rf_below(node) is None:
            v.fail("motion-rung-below-exact", path,
                   f"redistribute bucket_cap {node.bucket_cap} < exact "
                   f"skew bound rung {rung_up(max(exact, 8))} with no "
                   "runtime filter below to justify the undercut")
    if getattr(node, "_feedback_seed", None) is not None:
        _check_feedback_seed(v, node, path)
    if node.host_bucket_cap or node.hier_hosts or node.host_combine \
            or node.combine_spec is not None:
        _check_two_level(v, node, path)
    names = tuple(k.name for k in node.hash_keys
                  if isinstance(k, ex.ColumnRef))
    d = Sharding.hashed(*names) if names and \
        len(names) == len(node.hash_keys) else Sharding.strewn()
    return Props(None if v.local else d, max(node.out_capacity, 1))


def _check_feedback_seed(v: Verifier, node: N.PMotion, path: str) -> None:
    """Feedback-seeded rungs (plan/feedback.py, distribute._feedback_seed)
    re-derive their justified bound from the LIVE sketch — the stamp's
    own numbers are never trusted. The sketch's sources are re-resolved
    from the motion's actual child and keys, the sketch must still exist
    under current validity tokens, and the rung must cover the observed
    demand (scaled by the session's headroom when it shrinks the seed,
    never when it would inflate the bound away). A stamp with no live
    sketch behind it is forged — exactly what a feedback-poisoning bug
    or a replayed stale plan would look like."""
    from cloudberry_tpu_torch.exec.kernels import rung_up
    from cloudberry_tpu_torch.plan import feedback as FB

    seed = node._feedback_seed
    store = FB.store_for(v.session)
    src = FB.resolve_sources(node.child, node.hash_keys)
    sk = store.lookup(v.session, "redist", src) \
        if store is not None and src is not None else None
    if sk is None or sk.demand_max <= 0:
        v.fail("motion-rung-feedback-forged", path,
               f"feedback-seeded rung {node.bucket_cap} with no live "
               f"sketch for sources {src!r} — the stamp claims demand "
               f"{seed.get('demand')!r} nothing currently observed "
               "justifies")
        return
    headroom = min(float(v.session.config.feedback.headroom), 1.0)
    bound = rung_up(max(int(sk.demand_max * headroom), 8))
    if node.bucket_cap < bound:
        v.fail("motion-rung-feedback-forged", path,
               f"feedback-seeded bucket_cap {node.bucket_cap} < rung "
               f"{bound} justified by the observed demand "
               f"{sk.demand_max} — an undercut rung is a guaranteed "
               "overflow the sketch existed to prevent")


def _check_two_level(v: Verifier, node: N.PMotion, path: str) -> None:
    """The two-level (hierarchical) motion's capacity rules. Checked whenever ANY two-level
    stamp is present, independent of the live topology: the stamps are
    what the hierarchical transport will trust, so a forged or desynced
    stamp must be a finding even on a session that would run it flat."""
    from cloudberry_tpu_torch.exec.kernels import rung_up

    hh = node.hier_hosts
    hb = node.host_bucket_cap
    if hh < 2 or v.nseg % hh != 0:
        v.fail("motion-host-grouping", path,
               f"two-level stamps with hier_hosts={hh} on a {v.nseg}-"
               "segment plan — the hierarchical exchange requires a "
               "uniform host grouping (hosts >= 2 dividing nseg); a "
               "wrong grouping routes rows to the wrong host lane")
        return
    S = v.nseg // hh
    if hb < 8 or rung_up(hb) != hb:
        v.fail("motion-host-rung", path,
               f"host_bucket_cap {hb} is not a capacity rung (power of "
               "two >= 8) — the DCN block ladder shares the bounded-"
               "recompile discipline of bucket_cap")
    if hb < node.bucket_cap:
        v.fail("motion-host-capacity", path,
               f"host_bucket_cap {hb} < bucket_cap {node.bucket_cap}: "
               "a single segment-pair bucket the intra hop may legally "
               "deliver cannot fit the inter-host block — the "
               "aggregated DCN exchange is undersized by construction")
    elif hb > rung_up(S * S * node.bucket_cap):
        v.fail("motion-host-capacity", path,
               f"host_bucket_cap {hb} exceeds the proven host-pair "
               f"ceiling rung {rung_up(S * S * node.bucket_cap)} "
               f"(S^2 x bucket_cap, S={S}) — pure DCN padding no "
               "demand can fill")
    else:
        exact = v.exact_host_bound(node.child, node.hash_keys, hh)
        if exact is not None and hb < rung_up(max(exact, 8)) \
                and _rf_below(node) is None and not node.host_combine:
            v.fail("motion-host-capacity", path,
                   f"host_bucket_cap {hb} < exact host-pair bound rung "
                   f"{rung_up(max(exact, 8))} with nothing below to "
                   "shrink the input — a guaranteed DCN-block overflow")
    if node.host_combine or node.combine_spec is not None:
        _check_host_combine(v, node, path)


def _check_host_combine(v: Verifier, node: N.PMotion,
                        path: str) -> None:
    """Combine-stamp legality: only a two-stage agg's merge motion may
    carry it, and every merge must be order-insensitive-exact — a
    forged stamp would host-combine rows whose merge is not associative
    - commutative-exact and silently change results."""
    import numpy as np

    spec = node.combine_spec
    if not node.host_combine or spec is None:
        v.fail("motion-host-combine", path,
               "host_combine and combine_spec must be stamped together "
               "(one without the other is a forged/half-applied stamp)")
        return
    child = node.child
    if not (isinstance(child, N.PAgg)
            and getattr(child, "mode", "") == "partial"
            and child.group_keys):
        v.fail("motion-host-combine", path,
               "host_combine stamped on a motion whose child is not a "
               "grouped PARTIAL aggregate — there are no partials to "
               "merge; combining arbitrary rows drops data")
        return
    keys, merges = spec
    want = tuple(n for n, _ in child.group_keys)
    if tuple(keys) != want:
        v.fail("motion-host-combine", path,
               f"combine_spec keys {tuple(keys)} != the partial agg's "
               f"group keys {want}")
    hash_names = {k.name for k in node.hash_keys
                  if isinstance(k, ex.ColumnRef)}
    if hash_names != set(keys):
        v.fail("motion-host-combine", path,
               f"combine groups by {sorted(keys)} but the motion "
               f"hashes {sorted(hash_names)} — combined groups would "
               "not be colocated with their merge destination")
    by_name = {f.name: f for f in node.fields}
    for f in node.fields:
        if f.masks:
            v.fail("motion-host-combine", path,
                   f"host-combine over masked (nullable) column "
                   f"{f.name!r} — NULL grouping semantics need the "
                   "mask columns the combine does not model")
            break
    for name, func in merges:
        f = by_name.get(name)
        if f is None:
            v.fail("motion-host-combine", path,
                   f"combine_spec merges column {name!r} the motion "
                   "does not ship")
            continue
        if func not in ("sum", "min", "max"):
            v.fail("motion-host-combine", path,
                   f"merge func {func!r} for {name!r} is not an exact "
                   "combine (count partials merge as sum)")
        elif func == "sum" and not (
                np.issubdtype(f.type.np_dtype, np.integer)
                or np.dtype(f.type.np_dtype) == np.bool_):
            v.fail("motion-host-combine", path,
                   f"sum-merge of {name!r} ({f.type.np_dtype}) is add-"
                   "order-sensitive — host-combined floats would not "
                   "be bit-identical to the flat merge")


def _rf_below(m: N.PMotion) -> Optional[N.PRuntimeFilter]:
    node = m.child
    while isinstance(node, (N.PFilter, N.PRuntimeFilter)):
        if isinstance(node, N.PRuntimeFilter):
            return node
        node = node.child
    return None


def _check_wire_fields(v: Verifier, node: N.PMotion, path: str) -> None:
    """Packed-wire dtype legality: every column a motion ships must be
    bool (a flag bit) or a 4/8-byte word — the int64/DECIMAL limb
    convention bitcasts whole u32 words (kernels.WIRE_ITEMSIZES); any
    other width has no wire lane and would raise mid-execution."""
    import numpy as np

    from cloudberry_tpu_torch.exec.kernels import WIRE_ITEMSIZES

    for f in node.fields:
        dt = np.dtype(f.type.np_dtype)
        if dt == np.bool_:
            continue
        if dt.itemsize not in WIRE_ITEMSIZES:
            v.fail("motion-wire-dtype", path,
                   f"motion ships column {f.name!r} of dtype {dt} "
                   f"({dt.itemsize} bytes); the packed wire carries "
                   f"bool flags and {WIRE_ITEMSIZES}-byte words only")


def _check_topn_merge(v: Verifier, m: N.PMotion, path: str) -> None:
    """The top-N pushdown contract (merge-sorted-receive analog): a
    pre-compacting gather must sit over PLimit(k)/PSort(keys) and
    UNDER a re-sort on the same keys — each segment keeps its own top
    k, the coordinator merges k*nseg rows; drop either half and the
    global top-N is wrong."""
    lim = m.child
    if not (isinstance(lim, N.PLimit)
            and isinstance(lim.child, N.PSort)
            and lim.limit + lim.offset == m.pre_compact):
        v.fail("topn-merge-sort", path,
               f"pre_compact={m.pre_compact} gather is not over "
               "PLimit(k)/PSort — nothing bounds what each segment "
               "keeps")
        return
    inner_keys = lim.child.keys
    parent, _ = v._parent.get(id(m), (None, ""))
    if not isinstance(parent, N.PSort):
        v.fail("topn-merge-sort", path,
               "pre_compact gather has no merge PSort above it — "
               "k*nseg concatenated shard tops are not a global "
               "order")
        return
    if len(parent.keys) != len(inner_keys) or not all(
            (a is c or a == c) and b == d
            for (a, b), (c, d) in zip(parent.keys, inner_keys)):
        v.fail("topn-merge-sort", path,
               "merge sort above the pre_compact gather orders by "
               "different keys than the per-segment local sort — the "
               "merged top-N would be of the wrong order")


@rule("_AccLeaf", doc="the tiled finalize program's accumulator leaf "
                      "(exec/tiled.py): pooled partial state, one "
                      "place, no children")
def _r_accleaf(v: Verifier, node, kids, path) -> Props:
    cap = getattr(node, "capacity", 0) or 1
    return Props(None if v.local else Sharding.singleton(), cap)


# ---------------------------------------------------------- public API


def verify_plan(plan: N.PlanNode, session,
                declared_slots: Optional[list] = None,
                declared_nrw: Optional[int] = None
                ) -> list[PlanFinding]:
    """Verify one physical plan; returns findings (empty == clean)."""
    return Verifier(session, plan, declared_slots,
                    declared_nrw).verify(plan)


def verify_stats(plan: N.PlanNode, session) -> dict:
    """Verification + counters: nodes checked, rule-table rows hit,
    findings."""
    v = Verifier(session, plan)
    findings = v.verify(plan)
    return {"nodes": v.nodes_checked,
            "rules_hit": sorted(v.rules_hit),
            "findings": [f.as_dict() for f in findings]}


def check_plan(plan: N.PlanNode, session, context: str = "",
               declared_slots: Optional[list] = None,
               declared_nrw: Optional[int] = None) -> None:
    """The ``config.debug.verify_plans`` gate body: raise
    PlanVerifyError on any finding."""
    findings = verify_plan(plan, session, declared_slots, declared_nrw)
    if findings:
        raise PlanVerifyError(findings, context)


def annotate_derived(plan: N.PlanNode, session) -> list[PlanFinding]:
    """Stamp every node with its DERIVED distribution (``_vdist``) for
    EXPLAIN's ``dist:`` annotation — plan reviews and golden diffs
    then show sharding explicitly instead of implying it. Returns the
    walk's findings so a gated EXPLAIN pays ONE verification."""
    v = Verifier(session, plan)
    findings = v.verify(plan)
    for node, _ in _walk_paths(plan):
        props = v._memo.get(id(node))
        if props is not None and props.dist is not None:
            node._vdist = props.dist
    return findings
