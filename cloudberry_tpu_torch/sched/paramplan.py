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
``$params`` as replicated 0-d tensors).

The micro-batch dispatcher (sched/dispatcher.py) runs same-skeleton
statements as one STACKED launch (``run_batch``): per-request host
rebinding — tokenize-only for the canonical point lookup (``FastRebind``),
else a host re-plan (``prepare_one``) — then one runner per (skeleton,
signature, rung) (``GenericPlan.rung_fn``). The reference's runner is one
jitted ``jax.vmap`` of the program over the batch padded to a power-of-two
rung. The port's Executable is the Lowerer walk itself and its kernels are
ctypes launches on raw pointers, which ``torch.func.vmap`` cannot trace:
its runner uploads the shared tables and join indexes once (``shared``
mode) and every lane's ``$params`` in ONE host→device copy, runs the k
real lanes (never the padding) through the one Executable lane by lane,
and ORs every lane's runtime checks. Admission, the counters
(``batch_rung_compiles`` once per rung, ``dispatches`` once per batch,
``batched_statements`` += k, ``fast_rebinds``, ``generic_hits``) and the
fallback rule (any lane's ExecError or ResourceError returns None, and the
dispatcher re-routes the batch sequentially) are the reference's.

The port's generic plans are off by default (config.SchedConfig): a hit
saves only the construction of an Executable, less than the signature
walk costs.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from cloudberry_tpu_torch.plan import expr as ex
from cloudberry_tpu_torch.plan import nodes as N
from cloudberry_tpu_torch.sql.lexer import LexError, tokenize
from cloudberry_tpu_torch.types import DType, SqlType


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


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def _text_converter(t: SqlType):
    """Literal token text → physical value, matching the binder's typed
    conversions (the fast-rebind contract is validated at build time:
    converter(build text) must equal the plan's bound literal)."""
    from cloudberry_tpu_torch.plan.planner import _exact_decimal
    from cloudberry_tpu_torch.types import date_to_days

    if t.base in (DType.INT32, DType.INT64):
        return lambda s: int(s)
    if t.base == DType.DECIMAL:
        return lambda s, k=t.scale: _exact_decimal(s, k)
    if t.base == DType.FLOAT64:
        return lambda s: float(s)
    if t.base == DType.DATE:
        return lambda s: date_to_days(s)
    return None


@dataclass
class FastRebind:
    """Tokenize-only rebinding for the canonical point-lookup shape
    (``WHERE k = ?`` on an indexed column): skip parse/bind/plan entirely
    — convert the literal text, sidecar-search the rows, gather the scan
    input, feed the value as the one parameter. The dispatcher's batch
    path leans on this to keep per-request host work small."""

    table: str
    phys: str
    sqltype: SqlType
    expect_rows: int
    input_key: str
    param_key: Optional[str]
    hashed_direct: bool          # multi-seg: route via the dist-key hash
    dist_dtype: Optional[np.dtype]

    def bind(self, session, text: str):
        """(inputs, bindings) for one literal text, or None → caller
        falls back to the full re-plan rebind."""
        from cloudberry_tpu_torch.plan import pointlookup as PL

        conv = _text_converter(self.sqltype)
        try:
            v = conv(text)
        except (ValueError, TypeError, OverflowError):
            return None
        seg = None
        if self.hashed_direct:
            from cloudberry_tpu_torch.utils import hashing

            nseg = session.config.n_segments
            h = hashing.hash_columns_np(
                [np.asarray([v], dtype=self.dist_dtype)])
            seg = int(hashing.jump_consistent_hash_np(h, nseg)[0])
        rows = PL._lookup(session, self.table, self.phys, seg, v)
        if rows is None or len(rows) != self.expect_rows:
            return None
        from cloudberry_tpu_torch.exec import executor as X

        inputs = {self.input_key: X.point_scan_slice(
            self.table, rows, session, seg)}
        bindings = {}
        if self.param_key is not None:
            bindings[self.param_key] = np.asarray(
                v, dtype=self.sqltype.np_dtype)
        return inputs, bindings


def stack_params(lanes: list, keys, device) -> list:
    """Every lane's ``$params`` for the stacked launch: the literal slots
    of all lanes stacked per key and uploaded in ONE host→device copy
    (one byte buffer, 8-byte aligned per key), each lane's slot a 0-d view
    of its row — the dtype a Literal lowers to, as ``device_bindings``
    gives it — and the scan row counts as Python ints."""
    prm = [k for k in keys if k.startswith("$prm")]
    if not prm:
        return [{k: int(b[k]) for k in keys} for b in lanes]
    arrays = [np.ascontiguousarray(np.stack([b[k] for b in lanes]))
              for k in prm]
    offsets, off = [], 0
    for a in arrays:
        offsets.append(off)
        off += -(-a.nbytes // 8) * 8
    buf = np.zeros(off, dtype=np.uint8)
    for a, o in zip(arrays, offsets):
        buf[o:o + a.nbytes] = a.view(np.uint8).reshape(-1)
    dev = torch.from_numpy(buf).to(device)
    stacked = {}
    for k, a, o in zip(prm, arrays, offsets):
        dt = torch.from_numpy(a[:0]).dtype
        stacked[k] = dev[o:o + a.nbytes].view(dt)
    return [{k: (stacked[k][i] if k.startswith("$prm") else int(b[k]))
             for k in keys} for i, b in enumerate(lanes)]


class GenericPlan:
    """One Executable shared by every statement matching a (skeleton,
    signature) pair on one device — rebinding feeds new literals and
    slices. Kind ``single``, ``direct`` (a plan the planner routed to one
    segment) or ``dist`` (the distributed gang's runner)."""

    def __init__(self, session, skeleton: str, plan: N.PlanNode,
                 names, sig, bindings, keyed, slots):
        from cloudberry_tpu_torch.exec import executor as X
        from cloudberry_tpu_torch.exec.joinindex import jix_specs_of
        from cloudberry_tpu_torch.exec.resource import estimate_plan_memory
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
        # the stacked launch admits est_bytes x rung (shared mode)
        self.est_bytes = estimate_plan_memory(plan).peak_bytes
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
        # stacked-launch eligibility for the dispatcher (sched/dispatcher):
        # "sliced"  — every scan is a keyed point slice: every lane binds
        #             its own slices;
        # "shared"  — no keyed scans, one program: the tables ride once,
        #             only $params differ per lane.
        if self.kind in ("single", "direct") and self.keyed_keys \
                and not self.table_names:
            self.stack_mode = "sliced"
        elif self.kind == "single" and not self.keyed_keys \
                and self.param_keys:
            self.stack_mode = "shared"
        else:
            self.stack_mode = None
        self.fast: Optional[FastRebind] = None
        self._rungs: dict[int, Any] = {}
        self._rung_lock = threading.Lock()

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
        tables = self.shared_inputs(session, planB)
        tables.update(self.keyed_inputs(session, planB, keyedB))
        if bindings:
            tables["$params"] = device_bindings(bindings, session.device)
        return tables

    def shared_inputs(self, session, planB=None) -> dict:
        """The RAM tables by name (the session's per-version device
        copies) and the cached join indexes, under ``planB``'s
        direct-dispatch segment."""
        from cloudberry_tpu_torch.exec import executor as X

        seg = getattr(planB, "_direct_segment", None)
        tables = X.prepare_tables(self.table_names, session, segment=seg)
        if self.jix_keys:
            from cloudberry_tpu_torch.exec.joinindex import \
                join_index_inputs

            tables.update(join_index_inputs(self.plan, session, seg))
        return tables

    def keyed_inputs(self, session, planB, keyedB) -> dict:
        """The rebind's keyed scans (point slices, pruned store reads)
        under the built plan's input keys."""
        from cloudberry_tpu_torch.exec import executor as X

        seg = getattr(planB, "_direct_segment", None)
        tables = {}
        for key, s in zip(self.keyed_keys, keyedB):
            if hasattr(s, "_point_rows"):
                tables[key] = X.point_scan_slice(
                    s.table_name, s._point_rows, session, seg)
            else:
                tables[key] = X._load_store_scan(s, session)
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

    # ----------------------------------------------------- stacked launch

    def rung_fn(self, session, rung: int):
        """The stacked runner for a batch of up to ``rung`` lanes — kept
        once per power-of-two rung (``batch_rung_compiles``), as the
        reference compiles one vmapped program per rung. It takes the k
        real lanes' inputs (the reference's padding lanes repeat the last
        one) and runs each through the one Executable; it returns every
        lane's (columns, selection) and the runtime checks ORed across
        lanes."""
        with self._rung_lock:
            fn = self._rungs.get(rung)
        if fn is not None:
            return fn
        session.stmt_log.bump("batch_rung_compiles")
        exe = self.exe

        def run(lanes: list):
            outs, checks = [], {}
            for inputs in lanes:
                cols, sel, lane_checks = exe.fn(inputs)
                outs.append((cols, sel))
                for msg, v in lane_checks.items():
                    flag = torch.as_tensor(v).reshape(-1).any()
                    checks[msg] = flag if msg not in checks \
                        else checks[msg] | flag
            return outs, checks

        with self._rung_lock:
            fn = self._rungs.setdefault(rung, run)
        return fn


# ----------------------------------------------------- session-side cache


_GENERIC_CACHE_MAX = 32


def _try_fast(session, gp: GenericPlan, plan, tok_params, bindings,
              keyed, slots) -> Optional[FastRebind]:
    """Attach the tokenize-only rebind template when the statement is the
    canonical single-parameter point lookup."""
    if len(tok_params) != 1 or len(slots) > 1 or len(keyed) != 1:
        return None
    if gp.kind == "dist" or gp.table_names:
        return None
    s = keyed[0]
    if not hasattr(s, "_point_rows"):
        return None
    out_to_phys = {out: phys for phys, out in s.column_map.items()}
    phys = out_to_phys.get(getattr(s, "_point_col", None))
    if phys is None:
        return None
    t = session.catalog.table(s.table_name)
    sqltype = t.schema.field(phys).type
    conv = _text_converter(sqltype)
    if conv is None:
        return None
    prm_keys = [k for k in gp.param_keys if k.startswith("$prm")]
    if len(prm_keys) != len(gp.param_keys):
        return None  # row-count params imply non-keyed scans — not fast
    param_key = prm_keys[0] if prm_keys else None
    try:
        v = conv(tok_params[0])
    except (ValueError, TypeError, OverflowError):
        return None
    # the converter must reproduce BOTH the bound literal (the $params
    # value) and the sidecar probe value, or fast rebinding would diverge
    # from the binder's typed folds — validate against the build's values
    if param_key is not None:
        bound = bindings[param_key]
        if slots[0] != sqltype or not np.asarray(v, bound.dtype) == bound:
            return None
    hashed_direct = False
    dist_dtype = None
    if session.config.n_segments > 1:
        if getattr(plan, "_direct_segment", None) is None:
            return None
        if t.policy.kind == "hashed":
            if list(t.policy.keys) != [phys]:
                return None
            hashed_direct = True
            dist_dtype = t.schema.field(phys).type.np_dtype
        elif t.policy.kind != "replicated":
            return None
    return FastRebind(s.table_name, phys, sqltype, s.num_rows,
                      gp.keyed_keys[0], param_key, hashed_direct,
                      dist_dtype)


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
    skeleton, tok_params = norm
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
    gp.fast = _try_fast(session, gp, plan, tok_params, bindings2, keyed2,
                        slots2)
    session.stmt_log.bump("generic_builds")
    with lock:
        bucket = cache.setdefault(skeleton, [])
        bucket.append(gp)
        del bucket[:-session.config.sched.max_variants]
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


# -------------------------------------------------------- batch execution


def prepare_one(session, query: str) -> Optional[Prep]:
    """Full host-side preparation of one statement for the dispatcher:
    parse → bind/plan → generic lookup/build. None → not batchable."""
    from cloudberry_tpu_torch.plan.planner import plan_statement
    from cloudberry_tpu_torch.sql.parser import parse_sql

    session._sync_store()
    try:
        stmt = parse_sql(query)
        result = plan_statement(stmt, session, {})
    except Exception:
        return None
    if result.is_ddl:
        return None
    return lookup_or_build(session, query, result.plan)


def run_batch(session, sqls: list[str]):
    """Execute same-skeleton statements as ONE stacked launch: per-request
    host rebinding (tokenize-only when the fast template applies, else a
    host re-plan), every lane's literals uploaded in one copy, the batch's
    power-of-two rung admitted and its runner launched once, results split
    per request.

    Returns a list of ColumnBatch (one per statement) or None when the
    group is not stackable — the dispatcher then falls back to sequential
    dispatch. Builds a runner only once per (skeleton, signature, rung).
    """
    from cloudberry_tpu_torch.exec import executor as X
    from cloudberry_tpu_torch.exec.resource import ResourceError
    from cloudberry_tpu_torch.lifecycle import check_cancel
    from cloudberry_tpu_torch.obs import trace as OT
    from cloudberry_tpu_torch.utils.faultinject import fault_point

    if len(sqls) < 2 or not session.config.sched.generic_plans:
        return None
    prep0 = prepare_one(session, sqls[0])
    if prep0 is None or prep0.gp.stack_mode is None:
        return None
    gp = prep0.gp
    shared = gp.stack_mode == "shared"
    # shared mode: the tables and join indexes ride ONCE for every lane;
    # sliced mode: each lane binds its own point slices
    base = gp.shared_inputs(session) if shared else None
    tabs = [{} if shared else gp.keyed_inputs(session, prep0.plan,
                                              prep0.keyed)]
    binds = [dict(prep0.bindings)]
    for q in sqls[1:]:
        bound = None
        if gp.fast is not None:
            norm = normalize(q)
            if norm is None or norm[0] != gp.skeleton:
                return None
            fb = gp.fast.bind(session, norm[1][0])
            if fb is not None:
                bound = fb
                session.stmt_log.bump("fast_rebinds")
                # a fast rebind IS a generic-plan reuse (the tokenize-
                # only subset): the hit counter must agree with the
                # prepare_one path so per-statement attribution sums to
                # the engine total
                session.stmt_log.bump("generic_hits")
        if bound is None:
            p = prepare_one(session, q)
            if p is None or p.gp is not gp:
                return None  # shape drifted mid-batch — sequential path
            bound = ({} if shared else gp.keyed_inputs(session, p.plan,
                                                       p.keyed),
                     dict(p.bindings))
        tabs.append(bound[0])
        binds.append(bound[1])
    k = len(binds)
    rung = _next_pow2(k)
    lanes = []
    for t, prm in zip(tabs, stack_params(binds, gp.param_keys,
                                         session.device)):
        inputs = dict(base) if shared else t
        if prm:
            inputs["$params"] = prm
        lanes.append(inputs)
    fn = gp.rung_fn(session, rung)
    cost = gp.est_bytes * (rung if shared else 1)
    try:
        with session._gate, session._admitted(cost):
            fault_point("sched_flush")
            # cancel seam at the batched launch: a cancelled/expired
            # member aborts the flush (StatementError is NOT part of the
            # fallback catch below — the dispatcher re-routes survivors)
            check_cancel()
            session.stmt_log.bump("dispatches")
            with OT.span("launch", mode="stacked", lanes=k), \
                    OT.device_annotation("launch-stacked"):
                outs, checks = fn(lanes)
                X.raise_checks(checks)
                batches = [X.make_batch(gp.plan, cols, sel)
                           for cols, sel in outs]
    except (ResourceError, X.ExecError):
        # checks OR across lanes: ONE request's runtime check (subquery
        # cardinality, expansion overflow, ...) must not error its
        # batchmates — fall back to sequential dispatch, where each
        # statement gets its own verdict and the grow-and-retry loop
        return None
    session.stmt_log.bump("batched_statements", k)
    return batches
