"""Parameterized generic plans — the plan_cache.c analog.

``Session._stmt_cache`` keys on exact SQL text, so ``WHERE k = 42`` and
``WHERE k = 99`` each pay a full parse→plan→Executable build even though
they need the same walk. This module makes same-shape statements share
one Executable (exec/executor.py ``compile_plan``):

1. ``normalize`` lexes the statement and hoists constant literals into a
   parameter vector, producing a SKELETON string (the cache key) — the
   query-fingerprint normalization of plan_cache.c's generic plans.
2. On first execution of a skeleton, the freshly bound plan's
   filter/project literals are rewritten to ``expr.Param`` slots and the
   Executable is built to read a ``$params`` input; the literal VALUES
   travel as 0-d tensors of the literal's own dtype on the device.
3. On a later execution with different literals, the statement is
   re-bound (host only) and its plan's STRUCTURAL SIGNATURE is compared
   with the cached generic plan's; on a match the new literal values (and
   point-lookup row slices) bind into the existing Executable — no
   ``compile_plan`` call.

The port has no jit: an Executable is the Lowerer walk itself, so a
rebind saves its construction while the signature walk (``analyze``)
costs host time of its own; the exact-text statement cache
(``Session._cached_statement``) is what skips parsing and planning.

Plans that fold literals into plan STRUCTURE — nextval (plan-time sequence
allocation, ``_no_stmt_cache``), literal-dependent partition pruning
(``_store_parts``), a point lookup whose match count changed — are
non-generic by construction: the signature (or the ``_no_stmt_cache``
gate) refuses the rebind and the statement keeps the plan-per-text path.

The signature deliberately captures everything the walk bakes in: node
shapes and capacities, baked literal values outside param sites, DictLookup
table contents (string-predicate lookup tables are literal-derived),
dictionary identity for collation rank tables (guarded by table versions),
and shared-subtree (PShare) topology. A cached plan also matches only the
device it was built for (``sharedcache.device_token``): a CPU session and a
CUDA session over one store root share a cache scope.

Kinds: ``single`` (one program), ``direct`` (a plan the planner routed to
one segment; a rebind feeds that statement's segment) and ``dist`` (the
distributed gang, exec/dist_executor.py: every segment reads the
``$params`` as replicated 0-d tensors). The dispatcher's stacked launch
(``GenericPlan.rung_fn``, ``prepare_one``, ``run_batch``) waits for the
micro-batch dispatcher; those names raise ``NotImplementedError``.
The dispatcher's tokenize-only point-lookup rebind (``FastRebind``) comes
with it too.

The port's generic plans are off by default (config.SchedConfig): a hit
saves only the construction of an Executable, less than the signature
walk costs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from cloudberry_tpu_torch.plan import expr as ex
from cloudberry_tpu_torch.plan import nodes as N
from cloudberry_tpu_torch.sql.lexer import LexError, tokenize
from cloudberry_tpu_torch.types import SqlType


class UnsupportedPlan(Exception):
    """The plan contains a shape the generic-plan walker does not model —
    the statement silently keeps the non-generic path."""


# ------------------------------------------------------------- skeletons


_PARAM_HEADS = ("select", "with", "(")
# literals after these keywords are STRUCTURAL (plan shape / bind-time
# folds), never parameters: LIMIT/OFFSET become static node fields and
# INTERVAL quantities fold into date arithmetic at bind time
_KEEP_AFTER = ("limit", "offset", "interval")


def normalize(sql: str):
    """(skeleton, literal texts) for a parameterizable statement, else
    None. The skeleton is the token stream with number/string literals
    replaced by kind-tagged placeholders — same-shape statements collide
    on it regardless of their literal values."""
    head = sql.lstrip()[:1]
    if not head:
        return None
    first = sql.split(None, 1)[0].lower() if head != "(" else "("
    if first not in _PARAM_HEADS:
        return None
    try:
        toks = tokenize(sql)
    except LexError:
        return None
    parts: list[str] = []
    params: list[str] = []
    prev = ""
    for t in toks:
        if t.kind == "number" and prev not in _KEEP_AFTER:
            params.append(t.text)
            parts.append("?n")
        elif t.kind == "string" and prev not in _KEEP_AFTER:
            params.append(t.text)
            parts.append("?s")
        elif t.kind == "string":
            parts.append(f"'{t.text}'")
        elif t.kind != "eof":
            parts.append(t.text)
        prev = t.text if t.kind == "ident" else ""
    return " ".join(parts), tuple(params)


# ------------------------------------------------------- plan signatures


def _tsig(t: Optional[SqlType]):
    if t is None:
        return None
    return (t.base.value, t.scale)


def _pyval(v) -> Any:
    """Baked literal value as a hashable python scalar."""
    if isinstance(v, str):
        return v
    try:
        return np.asarray(v).item()
    except (TypeError, ValueError):
        return repr(v)


def _param_scalar(e: ex.Literal) -> bool:
    """Literal eligible to travel as a device input: a numeric/bool/date
    scalar (strings stay baked — their plan effect is DictLookup tables,
    whose contents the signature hashes)."""
    if isinstance(e.value, str):
        return False
    try:
        np.asarray(e.value, dtype=e.dtype.np_dtype)
    except (TypeError, ValueError, OverflowError):
        return False
    return np.ndim(e.value) == 0


class _Walker:
    """One canonical walk shared by signature building, parameter-slot
    numbering, binding extraction, and the literal→Param rewrite: every
    consumer MUST see nodes, expression sites, and literals in the same
    order, or rebinding would feed values into the wrong slots."""

    def __init__(self, session, rewrite: bool = False):
        self.rewrite = rewrite
        self.slots: list[SqlType] = []
        self.bindings: dict[str, np.ndarray] = {}
        self.keyed: list[N.PScan] = []
        self._nrw = 0  # scan row-count parameter slots ($nrw<i>)
        self._memo: dict[int, int] = {}
        # table-owned dictionaries are version-pinned (any content change
        # bumps the table version) — only literal-derived dictionaries
        # need content hashing in the signature
        self._table_dicts = {
            id(d)
            for t in session.catalog.tables.values()
            for d in getattr(t, "dicts", {}).values()}

    # ------------------------------------------------------- expressions

    def esig(self, e: Optional[ex.Expr], paramable: bool):
        """(signature, possibly-rewritten expr) for one expression."""
        if e is None:
            return None, None
        if isinstance(e, ex.Literal):
            if paramable and _param_scalar(e):
                slot = len(self.slots)
                self.slots.append(e.dtype)
                key = f"$prm{slot}"
                self.bindings[key] = np.asarray(e.value,
                                                dtype=e.dtype.np_dtype)
                # the Param KEEPS the literal: the baked fallback for a
                # non-generic recompile (growth retry) and the binding
                # source when a rewritten plan is re-analyzed
                new = ex.Param(slot, e.dtype, e.value) if self.rewrite \
                    else e
                return ("P", _tsig(e.dtype)), new
            return ("L", _tsig(e.dtype), _pyval(e.value)), e
        if isinstance(e, ex.Param):
            # re-analysis of an already-rewritten plan (the expansion-growth
            # retry re-enters the generic gate with the same plan object):
            # the Param's kept build-time value IS the binding
            if not paramable or e.value is None:
                raise UnsupportedPlan("Param at a non-parameter site")
            slot = len(self.slots)
            self.slots.append(e.dtype)
            key = f"$prm{slot}"
            self.bindings[key] = np.asarray(e.value,
                                            dtype=e.dtype.np_dtype)
            new = ex.Param(slot, e.dtype, e.value) if self.rewrite else e
            return ("P", _tsig(e.dtype)), new
        if isinstance(e, ex.ColumnRef):
            return ("C", e.name, _tsig(e.dtype)), e
        if isinstance(e, ex.BinOp):
            ls, ln = self.esig(e.left, paramable)
            rs, rn = self.esig(e.right, paramable)
            new = ex.BinOp(e.op, ln, rn, e.dtype) if self.rewrite else e
            return ("B", e.op, _tsig(e.dtype), ls, rs), new
        if isinstance(e, ex.UnaryOp):
            s, n = self.esig(e.operand, paramable)
            new = ex.UnaryOp(e.op, n, e.dtype) if self.rewrite else e
            return ("U", e.op, _tsig(e.dtype), s), new
        if isinstance(e, ex.Cast):
            s, n = self.esig(e.operand, paramable)
            new = ex.Cast(n, e.dtype) if self.rewrite else e
            return ("T", _tsig(e.operand.dtype), _tsig(e.dtype), s), new
        if isinstance(e, ex.Func):
            # scale_down's k literal is consumed at COMPILE time
            # (expr_compile reads e.args[1].value) — args stay baked
            sub_param = paramable and e.name != "scale_down"
            sigs, news = [], []
            for a in e.args:
                s, n = self.esig(a, sub_param)
                sigs.append(s)
                news.append(n)
            new = ex.Func(e.name, tuple(news), e.dtype) if self.rewrite \
                else e
            return ("F", e.name, _tsig(e.dtype), tuple(sigs)), new
        if isinstance(e, ex.CaseWhen):
            sigs, news = [], []
            for c, v in e.whens:
                cs, cn = self.esig(c, paramable)
                vs, vn = self.esig(v, paramable)
                sigs.append((cs, vs))
                news.append((cn, vn))
            os_, on = self.esig(e.otherwise, paramable)
            new = ex.CaseWhen(tuple(news), on, e.dtype) if self.rewrite \
                else e
            return ("W", _tsig(e.dtype), tuple(sigs), os_), new
        if isinstance(e, ex.DictLookup):
            s, n = self.esig(e.column, False)
            tab = np.asarray(e.table)
            tsig = ("DL", s, str(tab.dtype), tab.shape,
                    hash(tab.tobytes()), self._dictsig(
                        getattr(e, "_out_dict", None)))
            if self.rewrite and n is not e.column:
                out = ex.DictLookup(n, e.table, e.dtype)
                d = getattr(e, "_out_dict", None)
                if d is not None:
                    object.__setattr__(out, "_out_dict", d)
                return tsig, out
            return tsig, e
        if isinstance(e, ex.IsValid):
            return ("V", tuple(e.mask_names), e.negate), e
        if isinstance(e, ex.SubqueryScalar):
            # the subplan lowers inside the same program — recurse; its
            # filter/project literals are param sites like any other
            psig = self.nsig(e.plan)
            return ("SQ", e.mode, _tsig(e.dtype), psig), e
        raise UnsupportedPlan(f"expression {type(e).__name__}")

    def _dictsig(self, d):
        if d is None:
            return None
        if id(d) in self._table_dicts:
            return ("tdict", len(d))
        return ("dict", len(d), hash(tuple(d.values)))

    def _fieldsig(self, node: N.PlanNode):
        return tuple(
            (f.name, _tsig(f.type), f.masks, self._dictsig(f.sdict),
             f._is_null_col)
            for f in node.fields)

    # ------------------------------------------------------------- nodes

    def _site(self, node, attr: str, paramable: bool):
        """Signature one expression attribute; rewrite in place when
        building the generic plan."""
        s, n = self.esig(getattr(node, attr), paramable)
        if self.rewrite and n is not None:
            setattr(node, attr, n)
        return s

    def nsig(self, node: N.PlanNode):
        key = id(node)
        if key in self._memo:
            # shared subtree (PShare / runtime-filter build): reference by
            # first-visit index — topology is part of the program
            return ("ref", self._memo[key])
        self._memo[key] = len(self._memo)
        t = type(node).__name__
        if isinstance(node, N.PScan):
            if hasattr(node, "_point_rows"):
                extra = ("pt", len(node._point_rows))
                self.keyed.append(node)
                nrows = node.num_rows  # the slice length IS the shape
            elif hasattr(node, "_store_parts"):
                extra = ("store",
                         tuple(p["file"] for p in node._store_parts))
                self.keyed.append(node)
                nrows = node.num_rows
            else:
                # whole-table/shard scan: the row count is DATA, not
                # shape — bind it as a parameter so one program serves
                # every direct-dispatch segment (per-segment counts
                # differ; the padded capacity does not)
                extra = None
                nrows = "$param"
                key = f"$nrw{self._nrw}"
                self._nrw += 1
                self.bindings[key] = np.asarray(node.num_rows
                                                if node.num_rows >= 0
                                                else node.capacity,
                                                dtype=np.int64)
                if self.rewrite:
                    node._nrows_key = key
            return (t, node.table_name,
                    tuple(sorted(node.column_map.items())),
                    tuple(sorted(node.mask_map.items())),
                    node.capacity, nrows, extra,
                    self._fieldsig(node))
        if isinstance(node, N.PFilter):
            return (t, self._site(node, "predicate", True),
                    self.nsig(node.child))
        if isinstance(node, N.PProject):
            sigs = []
            for i, (name, e) in enumerate(list(node.exprs)):
                s, n = self.esig(e, True)
                if self.rewrite:
                    node.exprs[i] = (name, n)
                sigs.append((name, s))
            return (t, tuple(sigs), self._fieldsig(node),
                    self.nsig(node.child))
        if isinstance(node, N.PJoin):
            bk = tuple(self.esig(k, False)[0] for k in node.build_keys)
            pk = tuple(self.esig(k, False)[0] for k in node.probe_keys)
            # the join-index slot is structural: a program compiled WITH
            # the cached-sorted-build input cannot serve a plan without
            # it (and vice versa) — the spec key carries table/columns/
            # bits/layout so signature-equal plans want the same input
            jix = getattr(node, "_jix", None)
            return (t, node.kind, tuple(node.build_payload),
                    node.match_name, node.probe_match_name,
                    node.unique_build, node.out_capacity, node.null_aware,
                    node.pack_bits, jix.key if jix is not None else None,
                    bk, pk,
                    self._site(node, "residual", False),
                    self._site(node, "build_key_valid", False),
                    self._site(node, "probe_key_valid", False),
                    self.nsig(node.build), self.nsig(node.probe))
        if isinstance(node, N.PAgg):
            keys = tuple((name, self.esig(e, False)[0])
                         for name, e in node.group_keys)
            aggs = tuple(
                (name, c.func, c.distinct,
                 self.esig(c.arg, False)[0],
                 self.esig(c.filter, False)[0])
                for name, c in node.aggs)
            return (t, node.mode, node.capacity, keys, aggs,
                    self._fieldsig(node), self.nsig(node.child))
        if isinstance(node, N.PSort):
            keys = tuple((self.esig(e, False)[0], asc)
                         for e, asc in node.keys)
            return (t, keys, self._fieldsig(node), self.nsig(node.child))
        if isinstance(node, N.PLimit):
            return (t, node.limit, node.offset, self.nsig(node.child))
        if isinstance(node, N.PWindow):
            pk = tuple(self.esig(e, False)[0] for e in node.partition_keys)
            ok = tuple((self.esig(e, False)[0], asc)
                       for e, asc in node.order_keys)
            calls = tuple((name, func, self.esig(arg, False)[0])
                          for name, func, arg in node.calls)
            valids = tuple(self.esig(v, False)[0]
                           for v in (node.valids or ()))
            params = tuple(
                None if p is None else tuple(
                    (k, self.esig(v, False)[0]
                     if isinstance(v, ex.Expr) else v)
                    for k, v in sorted(p.items()))
                for p in (node.params or ()))
            return (t, pk, ok, calls, valids, params, node.frame,
                    self._fieldsig(node), self.nsig(node.child))
        if isinstance(node, N.PShare):
            return (t, self.nsig(node.child))
        if isinstance(node, N.PConcat):
            return (t, tuple(self.nsig(c) for c in node.inputs),
                    self._fieldsig(node))
        if isinstance(node, N.PRuntimeFilter):
            bk = tuple(self.esig(k, False)[0] for k in node.build_keys)
            pk = tuple(self.esig(k, False)[0] for k in node.probe_keys)
            # digest slots (mode + bloom geometry) are structural: the
            # traced collective and bitmap shapes differ per mode
            return (t, node.pack_bits, node.mode, node.bloom_bits,
                    node.bloom_k, bk, pk, self.nsig(node.build),
                    self.nsig(node.child))
        if isinstance(node, N.PMotion):
            hk = tuple(self.esig(k, False)[0] for k in node.hash_keys)
            return (t, node.kind, node.out_capacity, node.bucket_cap,
                    node.pre_compact, hk, self._fieldsig(node),
                    node.host_bucket_cap, node.hier_hosts,
                    node.host_combine, self.nsig(node.child))
        raise UnsupportedPlan(f"node {t}")


def analyze(session, plan: N.PlanNode, rewrite: bool = False):
    """(signature, bindings, keyed scans, slot types) for a bound plan.
    ``rewrite=True`` (generic-plan build only) additionally replaces every
    parameter-site literal with its ``expr.Param`` slot IN PLACE."""
    w = _Walker(session, rewrite=rewrite)
    root = ("root", w.nsig(plan),
            getattr(plan, "_direct_segment", None) is not None,
            w._fieldsig(plan))
    return root, w.bindings, w.keyed, w.slots


# ------------------------------------------------------ the generic plan


def device_bindings(bindings: dict, device) -> dict:
    """A plan's bindings as the Lowerer's ``$params`` input: every literal
    slot a 0-d tensor of its literal's dtype on the device — the very
    tensor a Literal lowers to (exec/expr_compile.py), so torch promotes
    it the same way — and every scan row count a Python int."""
    return {k: int(v) if k.startswith("$nrw")
            else torch.as_tensor(v, device=device)
            for k, v in bindings.items()}


class GenericPlan:
    """One Executable shared by every statement matching a (skeleton,
    signature) pair on one device — rebinding feeds new literals and
    slices. Kind ``single``, ``direct`` (a plan the planner routed to one
    segment) or ``dist`` (the distributed gang's runner)."""

    def __init__(self, session, skeleton: str, plan: N.PlanNode,
                 names, sig, bindings, keyed, slots):
        from cloudberry_tpu_torch.exec import executor as X
        from cloudberry_tpu_torch.exec.joinindex import jix_specs_of
        from cloudberry_tpu_torch.sched import sharedcache

        self.skeleton = skeleton
        self.sig = sig
        self.config = session.config
        if session.config.debug.verify_plans:
            # the verification gate on the GENERIC-PLAN FORM: the
            # rewritten plan (literals now $params slots, scan row counts
            # $nrw inputs) must verify clean AND both slot families must
            # agree with the signature — a desynced slot would bind a
            # literal into the wrong predicate on every later rebind
            from cloudberry_tpu_torch.plan.verify import check_plan

            check_plan(plan, session, "paramplan",
                       declared_slots=list(slots),
                       declared_nrw=sum(1 for k in bindings
                                        if k.startswith("$nrw")))
        # shared-tier guards (sched/sharedcache.py): content-stable table
        # version tokens + the plan epoch — store-scope entries match
        # across sessions, everything else stays private by construction;
        # the device, since the Executable lowers on the device of the
        # session that built it
        self.versions = sharedcache.table_versions(session, names)
        self.ddlv = sharedcache.plan_epoch(session)
        self.device = sharedcache.device_token(session)
        self.plan = plan
        self.param_keys = sorted(bindings, key=lambda k: (k[:4],
                                                          int(k[4:])))
        self.keyed_keys = [s._input_key for s in keyed]
        self.table_names = sorted({s.table_name
                                   for s in X.scans_of(plan)
                                   if not X.keyed_scan(s)})
        # cached sorted-build join indexes this Executable reads next to
        # its tables (exec/joinindex.py) — rebinds re-feed them per table
        # version
        self.jix_keys = [s.key for s in jix_specs_of(plan)]
        seg = getattr(plan, "_direct_segment", None)
        if session.config.n_segments > 1 and seg is None:
            from cloudberry_tpu_torch.exec import dist_executor as DX

            self.kind = "dist"
            self.fn = DX.compile_distributed(plan, session)
            self.exe = None
        else:
            self.kind = "direct" if seg is not None else "single"
            self.exe = X.compile_plan(plan, session)
            self.fn = None

    def matches(self, session, sig, versions, ddlv) -> bool:
        from cloudberry_tpu_torch.sched import sharedcache

        return (self.sig == sig and self.config is session.config
                and self.versions == versions and self.ddlv == ddlv
                and self.device == sharedcache.device_token(session))

    # --------------------------------------------------------- execution

    def bind_inputs(self, session, planB, keyedB, bindings) -> dict:
        """Assemble the Executable's inputs from a freshly bound plan:
        table columns (under the rebind's direct-dispatch segment), keyed
        scan slices REMAPPED to the built plan's input keys, and the
        literal bindings as the ``$params`` entry."""
        from cloudberry_tpu_torch.exec import executor as X

        seg = getattr(planB, "_direct_segment", None)
        tables = X.prepare_tables(self.table_names, session, segment=seg)
        if self.jix_keys:
            from cloudberry_tpu_torch.exec.joinindex import \
                join_index_inputs

            tables.update(join_index_inputs(self.plan, session, seg))
        for key, s in zip(self.keyed_keys, keyedB):
            if hasattr(s, "_point_rows"):
                tables[key] = X.point_scan_slice(
                    s.table_name, s._point_rows, session, seg)
            else:
                tables[key] = X._load_store_scan(s, session)
        if bindings:
            tables["$params"] = device_bindings(bindings, session.device)
        return tables

    def run(self, session, planB, keyedB, bindings):
        """Execute the cached Executable with one rebind's values — never
        calls ``compile_plan``."""
        import time as _t

        from cloudberry_tpu_torch.exec import executor as X
        from cloudberry_tpu_torch.obs import trace as OT

        session.stmt_log.bump("param_binds")
        # the rebind gets a SPAN only — the launch STAGE histogram
        # (recorded by the session around the whole runner) already
        # contains this host work
        t_bind = _t.perf_counter()
        if self.kind == "dist":
            return self._run_dist(session, planB, bindings, t_bind)
        inputs = self.bind_inputs(session, planB, keyedB, bindings)
        OT.mark("param-bind", t_bind)
        return X.run_executable(self.exe, inputs)

    def _run_dist(self, session, planB, bindings, t_bind):
        """The ``dist`` kind's rebind: every segment's inputs carry the
        same ``$params``; motion stats land on the built plan and its
        observed bucket demands are copied onto the rebind's plan (the
        growth loop grows THAT plan)."""
        from cloudberry_tpu_torch.exec import dist_executor as DX
        from cloudberry_tpu_torch.obs import trace as OT

        inputs = DX.prepare_dist_inputs(planB, session)
        if bindings:
            params = device_bindings(bindings, session.device)
            for d in inputs:
                d["$params"] = params
        OT.mark("param-bind", t_bind)
        with OT.span("launch", mode="dist-generic"), \
                OT.device_annotation("launch-dist"):
            return DX.finish_run(self.plan, session, self.fn(inputs),
                                 grows=planB)[0]

    def rung_fn(self, session, rung: int):
        raise NotImplementedError(
            "GenericPlan.rung_fn: the dispatcher's stacked launch is not "
            "yet ported")


# ----------------------------------------------------- session-side cache


_GENERIC_CACHE_MAX = 32
# generic-plan variants kept per statement skeleton (distinct plan shapes:
# capacity rungs, 0-vs-1 point matches) — the JAX package's
# sched.max_variants at its default
_MAX_VARIANTS = 4


def _eligible(session, query, plan) -> bool:
    if not session.config.sched.generic_plans:
        return False
    if getattr(plan, "_no_stmt_cache", False):
        return False
    return True


@dataclass
class Prep:
    """One statement's rebinding package: the shared Executable plus this
    execution's freshly bound plan and its literal values."""
    gp: GenericPlan
    plan: N.PlanNode
    keyed: list
    bindings: dict
    built: bool = False

    def run(self, session):
        return self.gp.run(session, self.plan, self.keyed, self.bindings)


def lookup_or_build(session, query: str, plan) -> Optional[Prep]:
    """The generic-plan gate for one freshly bound plan: normalize, match
    the (skeleton, signature) cache, build on miss. None → the statement
    keeps the non-generic path."""
    from cloudberry_tpu_torch.exec import executor as X

    if not _eligible(session, query, plan):
        return None
    norm = normalize(query)
    if norm is None or not norm[1]:
        return None
    skeleton = norm[0]
    names = sorted({s.table_name for s in X.scans_of(plan)})
    if session._any_external(names):
        return None
    from cloudberry_tpu_torch.sched import sharedcache

    try:
        versions = sharedcache.table_versions(session, names)
    except KeyError:
        return None
    ddlv = sharedcache.plan_epoch(session)
    try:
        sig, bindings, keyed, slots = analyze(session, plan)
    except UnsupportedPlan:
        return None
    lock = session._generic_lock
    cache = session._generic_cache
    with lock:
        bucket = cache.pop(skeleton, None)
        if bucket is not None:
            cache[skeleton] = bucket  # LRU touch
            for gp in bucket:
                if gp.matches(session, sig, versions, ddlv):
                    session.stmt_log.bump("generic_hits")
                    return Prep(gp, plan, keyed, bindings)
    # build: re-walk with rewrite=True so the Executable reads its
    # literals from $params (slot order identical by the walker contract)
    sig2, bindings2, keyed2, slots2 = analyze(session, plan, rewrite=True)
    assert sig2 == sig and list(bindings2) == list(bindings)
    import time as _time

    from cloudberry_tpu_torch.obs import metrics as OM
    from cloudberry_tpu_torch.obs import trace as OT

    t_build = _time.perf_counter()
    with OT.span("compile", skeleton=skeleton[:80]):
        gp = GenericPlan(session, skeleton, plan, names, sig, bindings2,
                         keyed2, slots2)
    OM.observe_stage(session.stmt_log, "compile",
                     _time.perf_counter() - t_build)
    session.stmt_log.bump("generic_builds")
    with lock:
        bucket = cache.setdefault(skeleton, [])
        bucket.append(gp)
        del bucket[:-_MAX_VARIANTS]
        while len(cache) > _GENERIC_CACHE_MAX:
            cache.pop(next(iter(cache)))
    return Prep(gp, plan, keyed2, bindings2, built=True)


def forget(session, gp: GenericPlan) -> None:
    """Drop one variant from its skeleton's bucket. The growth loop
    (session._run_with_growth) grows a failed statement's plan IN PLACE,
    and the Executable walks its plan at every run: a variant built over
    that plan would otherwise run the grown plan under its old
    signature."""
    with session._generic_lock:
        bucket = session._generic_cache.get(gp.skeleton)
        if bucket is not None and gp in bucket:
            bucket.remove(gp)
            if not bucket:
                del session._generic_cache[gp.skeleton]


def __getattr__(name: str):
    if name in ("prepare_one", "run_batch"):
        raise NotImplementedError(
            f"sched.paramplan.{name}: the dispatcher's stacked launch is "
            "not yet ported")
    raise AttributeError(name)
