"""Executor: plan tree → eager PyTorch operators.

The reference pulls tuples through a process-per-slice Volcano tree
(ExecProcNode, src/backend/executor/execProcnode.c); the JAX package traces
the whole plan into one XLA program. Here the same Lowerer walks the plan
eagerly over fixed-capacity column tensors on one device: scans are table
inputs, operators are exec/kernels.py and the hand-written CUDA kernels of
exec/cuda_kernels.py. Runtime "can't happen" conditions (agg capacity
overflow, duplicate build keys in a PK join) stay device tensors until the
statement ends, and are read on the host ONCE (``raise_checks``) — the
shape-world analog of ereport().

A distributed plan (``n_segments > 1``) runs through
exec/dist_executor.py, whose per-segment lowerer subclasses this one and
overrides the scan, motion, runtime-filter and ``global_any_of`` hooks.
A direct-dispatched plan runs here over one segment's shard.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from cloudberry_tpu_torch.columnar.batch import ColumnBatch
from cloudberry_tpu_torch.exec import cuda_kernels as CK
from cloudberry_tpu_torch.exec import kernels as K
from cloudberry_tpu_torch.exec.expr_compile import compile_expr
from cloudberry_tpu_torch.plan import expr as ex
from cloudberry_tpu_torch.plan import nodes as N
from cloudberry_tpu_torch.types import DType, Field, Schema


class ExecError(RuntimeError):
    pass


class DuplicateBuildKeyError(ExecError):
    """The planner assumed a unique (PK) build side but the data holds
    duplicate build keys — a semantic error (results would be wrong, so
    the statement aborts; never retryable)."""


# The dense cell-domain cap. The JAX package caps it at 4096 on the CPU
# and 64 elsewhere (an unrolled-reduction limit of XLA); the port uses
# 4096 everywhere so the CPU tests and the card take the same path.
DENSE_MAX_CELLS = 4096


@dataclass
class Executable:
    plan: N.PlanNode
    fn: Callable  # (tables) -> (cols dict, sel, checks dict)
    table_names: list[str]
    # scans bound to pruned micro-partition reads (plan/scanprune.py) or
    # point-lookup slices (plan/pointlookup.py); their inputs key by scan
    # identity, not table name
    store_scans: list = None  # type: ignore[assignment]


def execute(plan: N.PlanNode, session) -> ColumnBatch:
    seg = getattr(plan, "_direct_segment", None)
    build_kernels(session)
    if session.config.n_segments > 1 and seg is None:
        from cloudberry_tpu_torch.exec.dist_executor import \
            execute_distributed

        return execute_distributed(plan, session)
    exe = compile_plan(plan, session)
    return run_executable(exe, prepare_inputs(exe, session, segment=seg))


def build_kernels(session) -> float:
    """Build and load the kernel library before a run on a CUDA device,
    if this process has not yet (exec/cuda_kernels.py, one nvcc per
    source): the port's counterpart of a program compile. Records a
    ``compile`` span, counts each nvcc build on the engine's ``compiles``
    counter, and returns the seconds spent (0.0 once the library is
    loaded, and on a CPU device, which runs the plain versions)."""
    if session.device.type != "cuda" or CK.loaded():
        return 0.0
    from cloudberry_tpu_torch.obs import trace as OT

    t0 = time.monotonic()
    before = CK.NVCC_BUILDS
    with OT.span("compile"):
        CK.build()
    if CK.NVCC_BUILDS > before:
        session.stmt_log.bump("compiles", CK.NVCC_BUILDS - before)
    return time.monotonic() - t0


def keyed_scan(s: N.PScan) -> bool:
    """Scans whose input rides under a per-scan key instead of the
    table name: pruned store reads and point-lookup slices."""
    return hasattr(s, "_store_parts") or hasattr(s, "_point_rows")


def compile_plan(plan: N.PlanNode, session,
                 instrument: bool = False) -> Executable:
    """Eager: the 'program' is the Lowerer walk itself (no jit).
    ``instrument=True`` (EXPLAIN ANALYZE's pipeline path,
    exec/instrument.py run_pipeline) builds THE SAME walk through this
    same entry point with per-node row counts (device tensors) as a 4th
    output — no private lowerer, so the same kernels launch."""
    scans = list(scans_of(plan))
    store_scans = [s for s in scans if keyed_scan(s)]
    table_names = sorted({s.table_name for s in scans
                          if not keyed_scan(s)})
    device = session.device

    if instrument:
        from cloudberry_tpu_torch.exec.instrument import InstrumentingMixin

        class _InstrLowerer(InstrumentingMixin, Lowerer):
            def __init__(self, *a, **kw):
                Lowerer.__init__(self, *a, **kw)
                self.__init_instrument__()

        def run_counted(tables):
            low = _InstrLowerer(tables, device,
                                params=tables.get("$params"))
            cols, sel = low.lower(plan)
            out = {f.name: cols[f.name] for f in plan.fields}
            return out, sel, low.checks, low.node_counts

        return Executable(plan, run_counted, table_names, store_scans)

    def run(tables):
        low = Lowerer(tables, device, params=tables.get("$params"))
        cols, sel = low.lower(plan)
        out = {f.name: cols[f.name] for f in plan.fields}
        return out, sel, low.checks

    return Executable(plan, run, table_names, store_scans)


def prepare_tables(table_names: list[str], session,
                   segment: int | None = None) -> dict:
    """RAM tables as device tensors, by name (validity masks under
    ``$nn:<col>``) — from the session's per-version device copies. A cold
    stored table read whole (not through a pruned scan) loads first.
    ``segment``: ONE segment's shard of each partitioned table (direct
    dispatch — the cdbtargeteddispatch analog); replicated tables whole."""
    tables = {}
    for name in table_names:
        t = session.catalog.table(name)
        t.ensure_loaded()
        if segment is None or t.policy.kind == "replicated":
            tables[name] = session.device_table(name)
        else:
            ds = session.device_shards(name)
            tables[name] = {c: v[segment] for c, v in ds.columns.items()}
    return tables


def prepare_inputs(exe: Executable, session,
                   segment: int | None = None) -> dict:
    """All inputs for one executable: RAM tables by name plus pruned
    store reads and point slices keyed by scan identity plus cached join
    indexes (``segment``: a direct-dispatched statement's shard)."""
    return assemble_inputs(exe.table_names, exe.store_scans or (), session,
                           plan=exe.plan, segment=segment)


def assemble_inputs(table_names, store_scans, session, plan=None,
                    segment: int | None = None) -> dict:
    """Inputs for the named RAM tables and the keyed scans; with ``plan``,
    also the cached join indexes its joins are annotated with. The tiled
    executors call it with every scan except the tile stream, which is
    never uploaded whole."""
    tables = prepare_tables(table_names, session, segment=segment)
    for s in store_scans:
        if hasattr(s, "_point_rows"):
            tables[s._input_key] = point_scan_slice(
                s.table_name, s._point_rows, session, segment)
        else:
            tables[s._input_key] = _load_store_scan(s, session)
    if plan is not None:
        # cached sorted-build join indexes ride next to the tables
        # (exec/joinindex.py)
        from cloudberry_tpu_torch.exec.joinindex import join_index_inputs

        tables.update(join_index_inputs(plan, session, segment))
    return tables


def point_scan_slice(table_name: str, rows, session,
                     segment: int | None = None) -> dict:
    """One point-bound scan's input columns: the matched rows of the
    table (or of its direct-dispatched shard). The JAX package slices
    them on the host and uploads them at every statement; the port
    gathers them from the table's device copy (``Session.device_table``,
    ``Session.device_shards``) with one index tensor — the same rows in
    the same order, fewer bytes moved."""
    cols = prepare_tables([table_name], session, segment)[table_name]
    idx = torch.from_numpy(np.asarray(rows, dtype=np.int64)).to(
        session.device)
    return {c: v[idx] for c, v in cols.items()}


_STORE_SCAN_CACHE_MAX = 16


def _nbytes(entry: dict) -> int:
    return sum(v.numel() * v.element_size() for v in entry.values())


def _load_store_scan(scan: N.PScan, session) -> dict:
    """Read a pruned scan's columns from micro-partitions (column
    projection: ONLY column_map + mask_map physical columns are read) as
    tensors on the session's device, cached per (table, version,
    partitions, columns, device) in the session's LRU. A cache miss
    consults the device buffer pool per partition before touching the
    store (exec/bufferpool.py).

    The cache holds device tensors, and a multi-partition entry is a
    ``torch.cat`` copy of chunks the pool may hold too, so its bytes count
    with the pool's against ``bufferpool.max_bytes``: after every miss the
    session's entries plus the pool's resident bytes fit the budget (LRU
    entries go first; an entry that cannot fit is not kept). Another
    session's admissions into a shared pool are seen at this session's
    next miss."""
    from cloudberry_tpu_torch.exec import bufferpool as BUF
    from cloudberry_tpu_torch.sched import sharedcache

    store = session.catalog.store
    key = (scan.table_name, store.effective_version(scan.table_name),
           tuple(p["file"] for p in scan._store_parts),
           tuple(sorted(scan.column_map)), tuple(sorted(scan.mask_map)),
           sharedcache.device_token(session))
    cache = session._store_scan_cache
    log = getattr(session, "stmt_log", None)
    # LRU, not FIFO: pop-and-reinsert moves a hit to the dict's end so a
    # hot table's scan survives a burst of one-off queries; the lock keeps
    # reorder/evict/insert atomic (the store read itself runs unlocked)
    lock = session._store_scan_lock
    with lock:
        hit = cache.pop(key, None)
        if hit is not None:
            cache[key] = hit
    if hit is not None:
        if log is not None:
            log.bump("store_scan_cache_hits")
        return hit
    if log is not None:
        log.bump("store_scan_cache_misses")
    hit = _read_scan_columns(scan, session, log)
    budget = session.config.bufferpool.max_bytes
    pool = BUF.pool_for(session)
    if pool is not None:
        budget -= pool.snapshot()["bytes"]
    nb = _nbytes(hit)
    fits = nb <= budget
    evicted = 0
    with lock:
        held = sum(_nbytes(v) for v in cache.values())
        while cache and (held + (nb if fits else 0) > budget
                         or (fits and len(cache) >= _STORE_SCAN_CACHE_MAX)):
            held -= _nbytes(cache.pop(next(iter(cache))))
            evicted += 1
        if fits:
            cache[key] = hit
    if log is not None:
        if evicted:
            log.bump("store_scan_cache_evictions", evicted)
        if not fits:
            log.bump("store_scan_cache_refusals")
    return hit


def _read_scan_columns(scan: N.PScan, session, log) -> dict:
    """Assemble one pruned scan's input dict on the device. With the
    buffer pool on, partitions are looked up (and admitted) one by one and
    the chunks concatenated in part order with ``torch.cat`` —
    read_partitions concatenates the same chunks in the same order, so
    the assembly is bit-identical to one batched read; resident
    partitions skip the host read, decode and upload entirely."""
    from cloudberry_tpu_torch.exec import bufferpool as BUF

    store = session.catalog.store
    dev = session.device
    needed = sorted(set(scan.column_map) | set(scan.mask_map))
    parts = list(scan._store_parts)
    bpool = BUF.pool_for(session)
    if bpool is None or not parts:
        cols, validity = store.read_partitions(scan.table_name, parts,
                                               needed)
        if log is not None and parts:
            log.bump("partitions_decoded", len(parts))
        hit = {c: BUF.to_device(v, dev) for c, v in cols.items()}
        for c, v in validity.items():
            hit[f"$nn:{c}"] = BUF.to_device(
                np.asarray(v, dtype=np.bool_), dev)
        return hit
    cols_key = tuple(needed)
    col_chunks: dict[str, list] = {}
    val_chunks: dict[str, list] = {}
    for part in parts:
        pk = BUF.partition_key(session, scan.table_name, part, cols_key)
        ent = bpool.lookup(pk, log)
        if ent is None:
            cols, validity = store.read_partitions(
                scan.table_name, [part], needed)
            if log is not None:
                log.bump("partitions_decoded")
            ent = {"cols": {c: BUF.to_device(v, dev)
                            for c, v in cols.items()},
                   "validity": {c: BUF.to_device(
                       np.asarray(v, dtype=np.bool_), dev)
                       for c, v in validity.items()}}
            bpool.offer(pk, ent, table=scan.table_name, log=log,
                        device=dev)
        for c, v in ent["cols"].items():
            col_chunks.setdefault(c, []).append(v)
        for c, v in ent["validity"].items():
            val_chunks.setdefault(c, []).append(v)
    hit = {c: (vs[0] if len(vs) == 1 else torch.cat(vs))
           for c, vs in col_chunks.items()}
    for c, vs in val_chunks.items():
        hit[f"$nn:{c}"] = vs[0] if len(vs) == 1 else torch.cat(vs)
    return hit


def run_executable(exe: Executable, tables: dict) -> ColumnBatch:
    # the run, its checks and the result copy under the statement's
    # ``launch`` span and a torch.profiler range (obs/trace.py); the
    # result copy is where the host waits for the device, so it must fall
    # inside the span. Both are no-ops untraced.
    from cloudberry_tpu_torch.obs import trace as OT

    with OT.span("launch", plan=type(exe.plan).__name__), \
            OT.device_annotation("launch"):
        cols, sel, checks = exe.fn(tables)
        raise_checks(checks)
        return make_batch(exe.plan, cols, sel)


def raise_checks(checks: dict) -> None:
    """Read every runtime check in ONE device→host transfer and raise the
    first that fired."""
    if not checks:
        return
    flags = torch.stack([torch.as_tensor(v).reshape(-1).any()
                         for v in checks.values()]).cpu().numpy()
    for msg, bad in zip(checks, flags):
        if bad:
            if "duplicate keys" in msg:
                raise DuplicateBuildKeyError(msg)
            raise ExecError(msg)


def make_batch(plan: N.PlanNode, cols, sel) -> ColumnBatch:
    """The result as a host ColumnBatch of the SELECTED rows only: they
    are gathered on the device first, so a result at a large capacity
    (an aggregation sized by its input) does not cross to the host
    padded. The reference returns the padded arrays; the selected rows,
    in order, are the same."""
    keep = torch.nonzero(sel).flatten()

    def host(t: torch.Tensor) -> np.ndarray:
        return t[keep].cpu().numpy()

    shown = [f for f in plan.fields if not f.name.startswith("$vm")]
    fields = tuple(Field(f.name, f.type) for f in shown)
    dicts = {f.name: f.sdict for f in shown if f.sdict is not None}
    validity = {}
    for f in shown:
        ms = f.masks
        if ms and all(m in cols for m in ms):
            v = host(cols[ms[0]]).astype(bool)
            for m in ms[1:]:
                v = v & host(cols[m]).astype(bool)
            validity[f.name] = v
    return ColumnBatch(Schema(fields),
                       {f.name: host(cols[f.name]) for f in shown},
                       np.ones(keep.shape[0], dtype=np.bool_), dicts,
                       validity=validity)


def _as_column(v: torch.Tensor, cap: int) -> torch.Tensor:
    """Broadcast a 0-d (constant) value to column shape."""
    return v.expand(cap) if v.ndim == 0 else v


def all_nodes(plan: N.PlanNode):
    """Every node in the plan, including scalar-subquery plans."""
    yield plan
    for e in N.node_exprs(plan):
        for sub in ex.walk(e):
            if isinstance(sub, ex.SubqueryScalar):
                yield from all_nodes(sub.plan)
    for c in plan.children():
        yield from all_nodes(c)


def scans_of(plan: N.PlanNode):
    if isinstance(plan, N.PScan) and plan.table_name != "$dual":
        yield plan
    # scalar subqueries ride inside expressions, not children
    for e in N.node_exprs(plan):
        for sub in ex.walk(e):
            if isinstance(sub, ex.SubqueryScalar):
                yield from scans_of(sub.plan)
    for c in plan.children():
        yield from scans_of(c)


def find_expansion_node(plan: N.PlanNode, message: str):
    """The join a detected expansion-overflow check message points at
    (messages embed the node id), or None."""
    m = re.search(r"\(node (\d+)\)", message)
    if m is None or "expansion overflow" not in message:
        return None
    nid = int(m.group(1))
    for node in all_nodes(plan):
        if id(node) == nid and isinstance(node, N.PJoin):
            return node
    return None


def _dedupe_nodes(nodes) -> list:
    """Unique by identity, preserving order — all_nodes re-walks shared
    (PShare) subtrees once per reference, and a buffer must be grown
    exactly once per retry."""
    seen: set[int] = set()
    out = []
    for nd in nodes:
        if id(nd) not in seen:
            seen.add(id(nd))
            out.append(nd)
    return out


def grow_expansion(plan: N.PlanNode, message: str, factor: int = 4,
                   allow_fallback: bool = False) -> bool:
    """Adaptive recovery from a detected join-expansion overflow (the
    increase-nbatch-and-retry discipline of nodeHash.c): grow the named
    join's pair buffer by ``factor`` and report success. The caller
    re-runs — results are never truncated. A skew-blown redistribute
    bucket recovers the same way, except it promotes to the next CAPACITY
    RUNG that fits the observed demand (``factor`` does not apply there).

    ``allow_fallback``: when the message's node id resolves nowhere in
    ``plan``, grow every candidate buffer instead of giving up (padding at
    worst, progress guaranteed); the statement retry loop sets it — there
    an unresolvable id means the runner was built over another,
    signature-equal plan (a generic plan's rebind, sched/paramplan.py)."""
    from cloudberry_tpu_torch.lifecycle import check_cancel

    # cancel seam: each grow-and-retry round re-runs the whole statement
    check_cancel()
    node = find_expansion_node(plan, message)
    hits = [node] if node is not None else []
    if not hits and allow_fallback and "expansion overflow" in message:
        hits = _dedupe_nodes(
            nd for nd in all_nodes(plan)
            if isinstance(nd, N.PJoin)
            and (not nd.unique_build or nd.residual is not None))
    if hits:
        for nd in hits:
            nd.out_capacity = max(nd.out_capacity * factor, 64)
            # capacity re-derivations (the tiled planner's _retile) must
            # never shrink a runtime-grown buffer back below what
            # overflowed
            nd._min_out_cap = nd.out_capacity
        return True
    if "redistribute overflow" in message:
        m = re.search(r"\(node (\d+)\)", message)
        nid = int(m.group(1)) if m is not None else -1
        # kind filter matters: a stale id from a runner built over
        # another plan could alias ANY current node's address — never
        # promote a gather/broadcast
        motions = _dedupe_nodes(
            nd for nd in all_nodes(plan)
            if isinstance(nd, N.PMotion) and nd.kind == "redistribute")
        hits = [nd for nd in motions if id(nd) == nid]
        if not hits and allow_fallback:
            hits = motions
        for nd in hits:
            # out_capacity tracks bucket_cap × nseg; recover the factor
            # so memory estimates see the grown buffer
            nseg = max(1, (nd.out_capacity or nd.bucket_cap)
                       // max(nd.bucket_cap, 1))
            # the next rung, or straight to the rung fitting the observed
            # global bucket demand (dist_executor.record_motion_stats)
            observed = getattr(nd, "_observed_bucket", 0)
            nd.bucket_cap = K.rung_up(max(nd.bucket_cap * 2, observed, 64))
            nd.out_capacity = nd.bucket_cap * nseg
            nd._min_bucket_cap = nd.bucket_cap
        return bool(hits)
    return False


# ------------------------------------------------------------- plan lowering


class Lowerer:
    """Walks a plan into torch ops on one device. Subclassed by the
    distributed executor (exec/dist_executor.py), which overrides the
    scan (per-segment inputs), motion, runtime-filter and
    ``global_any_of`` hooks."""

    def __init__(self, tables, device, params=None):
        self.tables = tables
        self.device = torch.device(device)
        # a generic plan's bindings (sched/paramplan.py): ``$prm<slot>``
        # literal values as 0-d device tensors and ``$nrw<i>`` scan row
        # counts; None on the plan-per-text path
        self.params = params
        self.checks: dict[str, torch.Tensor] = {}
        self._subcache: dict[int, torch.Tensor] = {}
        # shared-subplan (PShare) results, keyed by child object identity
        self._sharecache: dict[int, tuple] = {}
        # probe joins' duplicate flags (_dup_slot), allocated at first use
        self._dup_flags: torch.Tensor | None = None
        self._dup_used = 0

    def lower(self, node: N.PlanNode) -> tuple[dict, torch.Tensor]:
        if isinstance(node, N.PScan):
            return self.scan(node)
        if isinstance(node, N.PFilter):
            cols, sel = self.lower(node.child)
            mask = self.expr(node.predicate, cols)
            return cols, sel & mask
        if isinstance(node, N.PProject):
            cols, sel = self.lower(node.child)
            out = {}
            for name, e in node.exprs:
                out[name] = _as_column(self.expr(e, cols), sel.shape[0])
            return out, sel
        if isinstance(node, N.PJoin):
            return self.join(node)
        if isinstance(node, N.PAgg):
            return self.agg(node)
        if isinstance(node, N.PSort):
            cols, sel = self.lower(node.child)
            keys, desc = [], []
            for e, asc in node.keys:
                keys.append(_as_column(
                    _sortable(e, node.child, cols, self.device),
                    sel.shape[0]))
                desc.append(not asc)
            perm = K.sort_indices(keys, sel, descending=desc)
            return {n: c[perm] for n, c in cols.items()}, sel[perm]
        if isinstance(node, N.PLimit):
            cols, sel = self.lower(node.child)
            return cols, K.limit_mask(sel, node.limit, node.offset)
        if isinstance(node, N.PMotion):
            return self.motion(node)
        if isinstance(node, N.PWindow):
            return self.window(node)
        if isinstance(node, N.PShare):
            return self.lower_shared(node.child)
        if isinstance(node, N.PRuntimeFilter):
            return self.runtime_filter(node)
        if isinstance(node, N.PConcat):
            outs = [self.lower(c) for c in node.inputs]
            cols = {f.name: torch.cat([o[0][f.name] for o in outs])
                    for f in node.fields}
            sel = torch.cat([o[1] for o in outs])
            return cols, sel
        raise ExecError(f"cannot execute node {type(node).__name__}")

    def scan(self, node: N.PScan):
        if node.table_name == "$dual":
            return {}, torch.ones((1,), dtype=torch.bool, device=self.device)
        data = self.tables[getattr(node, "_input_key", node.table_name)]
        cols = {}
        for phys, out in node.column_map.items():
            arr = data[phys]
            if arr.shape[0] < node.capacity:  # empty table: 0 rows, cap 1
                arr = torch.zeros((node.capacity,), dtype=arr.dtype,
                                  device=self.device)
            cols[out] = arr
        for phys, out in node.mask_map.items():
            arr = data[f"$nn:{phys}"]
            if arr.shape[0] < node.capacity:
                arr = torch.zeros((node.capacity,), dtype=torch.bool,
                                  device=self.device)
            cols[out] = arr
        n = node.num_rows if node.num_rows >= 0 else node.capacity
        key = getattr(node, "_nrows_key", None)
        if key is not None and self.params is not None \
                and key in self.params:
            # generic plan: the row count rides the "$params" input, so one
            # executable serves every table version at an unchanged
            # capacity — the count is data, the CAPACITY is the shape
            n = self.params[key]
        sel = torch.arange(node.capacity, device=self.device) < n
        return cols, sel

    def motion(self, node: N.PMotion):
        """Single program: a loopback motion is the identity.
        ``lower_shared``: a runtime filter may reference the motion's
        child (build side) too."""
        return self.lower_shared(node.child)

    def runtime_filter(self, node: N.PRuntimeFilter):
        """Single program: the filter would only duplicate the join's own
        matching — pass through."""
        return self.lower(node.child)

    def global_any_of(self, node: N.PlanNode, fn) -> torch.Tensor:
        """Any() of ``fn(lowerer)`` across ALL data. ``fn`` computes a
        lowerer's local 0-d bool from ITS lowering (through
        ``lower_shared``); one program answers locally, the distributed
        gang once for every segment, keyed by ``node`` (the reference's
        ``global_any``: null-aware NOT IN needs a cluster-wide answer)."""
        return fn(self)

    def lower_shared(self, node: N.PlanNode):
        """Lower a subtree at most once (PShare / runtime-filter build
        sharing) — the materialize-once contract."""
        key = id(node)
        if key not in self._sharecache:
            self._sharecache[key] = self.lower(node)
        return self._sharecache[key]

    # ----------------------------------------------------------- expressions

    def expr(self, e: ex.Expr, cols) -> torch.Tensor:
        """Evaluate an expression; uncorrelated scalar subqueries (InitPlan
        analog) are lowered once and broadcast; Param leaves (generic
        plans) read their binding from the "$params" input."""
        subs = [n for n in ex.walk(e) if isinstance(n, ex.SubqueryScalar)]
        if self.params is not None \
                and any(isinstance(n, ex.Param) for n in ex.walk(e)):
            cols = {**cols, **self.params}
        if not subs:
            return compile_expr(e, self.device)(cols)
        aug = dict(cols)
        mapping = {}
        for sq in subs:
            key = id(sq)
            if key not in self._subcache:
                scols, ssel = self.lower(sq.plan)
                n = ssel.sum(dtype=torch.int64)
                if sq.mode == "exists":
                    self._subcache[key] = n > 0
                else:
                    arr = scols[sq.plan.fields[0].name]
                    self.checks[
                        f"scalar subquery returned more than one row "
                        f"(node {key})"] = n > 1
                    # 0 selected rows: row 0's arbitrary value is masked
                    # NULL by the binder's presence term
                    idx = torch.argmax(ssel.to(torch.uint8))
                    self._subcache[key] = arr[idx]
            name = f"$sqv{key}"
            mapping[key] = name
            aug[name] = self._subcache[key]
        return compile_expr(_substitute_subqueries(e, mapping),
                            self.device)(aug)

    # ------------------------------------------------------------ operators

    def _join_index(self, node: N.PJoin):
        """Cached sorted-build index for this join (exec/joinindex.py):
        (order, sorted packed keys, packing ranges) fed as an input, or
        None → sort the build side here."""
        spec = getattr(node, "_jix", None)
        if spec is None:
            return None
        jix = self.tables.get(spec.key)
        if jix is None:
            return None
        ranges = [(jix[f"lo{i}"], jix[f"span{i}"])
                  for i in range(len(node.build_keys))]
        return jix["order"], jix["skeys"], ranges

    def _expand_pairs(self, node: N.PJoin, bkeys, bselm, pkeys, pselm,
                      cap: int):
        """join_expand through the cached sorted-build index when one is
        fed (skips the build sort), else the full kernel."""
        jix = self._join_index(node)
        if jix is not None:
            return K.join_expand_sorted(jix[0], jix[1], jix[2], pkeys,
                                        pselm, cap, bits=node.pack_bits)
        return K.join_expand(bkeys, bselm, pkeys, pselm, cap,
                             bits=node.pack_bits)

    def join(self, node: N.PJoin):
        bcols, bsel = self.lower_shared(node.build)
        pcols, psel = self.lower(node.probe)
        bkeys = [self.expr(k, bcols) for k in node.build_keys]
        pkeys = [self.expr(k, pcols) for k in node.probe_keys]

        # SQL NULL-key semantics: a NULL key matches nothing. NULL-key build
        # rows leave the build set; NULL-key probe rows become unmatched
        # (they still flow through left/anti via the ORIGINAL psel).
        bkv = self.expr(node.build_key_valid, bcols) \
            if node.build_key_valid is not None else None
        pkv = self.expr(node.probe_key_valid, pcols) \
            if node.probe_key_valid is not None else None
        bselm = bsel & bkv if bkv is not None else bsel
        pselm = psel & pkv if pkv is not None else psel

        if node.kind in ("semi", "anti") and node.residual is not None:
            return self._join_semi_residual(node, bcols, bselm, bkeys,
                                            pcols, psel, pselm, pkeys)
        if not node.unique_build:
            return self._join_expand(node, bcols, bsel, bselm, bkeys,
                                     pcols, psel, pselm, pkeys)

        fused = self._probe_join_kernel(node, bcols, bselm, bkeys,
                                        pselm, pkeys)
        if fused is not None:
            matched, payload, has_dup = fused
        else:
            jix = self._join_index(node)
            if jix is not None:
                idx, matched, has_dup = K.join_lookup_sorted(
                    jix[0], jix[1], jix[2], pkeys, pselm,
                    bits=node.pack_bits)
            else:
                idx, matched, has_dup = K.join_lookup(
                    bkeys, bselm, pkeys, pselm, bits=node.pack_bits)
            payload = K.gather_payload(
                {n: bcols[n] for n in node.build_payload}, idx, matched)
        if node.kind in ("inner", "left"):
            # semi/anti only test membership; inner/left rely on the
            # planner's uniqueness proof — verify it at runtime. The sorted
            # path checks the build side itself (adjacent-equal on its
            # sorted keys); the kernel's match count > 1 is weaker — it
            # fires only when a selected probe row HITS the duplicated key,
            # i.e. exactly when results would be wrong (the reference's
            # fused-path contract)
            self.checks[
                f"join build side has duplicate keys (node {id(node)}) but "
                "the planner assumed a unique (PK) build side"] = has_dup
        cols = {**pcols, **payload}
        if node.match_name:
            cols[node.match_name] = matched
        if node.kind in ("inner", "semi"):
            sel = matched
        elif node.kind == "left":
            sel = psel
        elif node.kind == "anti":
            sel = psel & ~matched
            if node.null_aware:
                # x NOT IN (...): never TRUE if x is NULL or ANY subquery
                # key is NULL
                if pkv is not None:
                    sel = sel & pkv
                if bkv is not None:
                    # the build-side NULL test must be GLOBAL across
                    # segments (the NULL row may live on another shard)
                    sel = sel & ~self.global_any_of(
                        node, lambda low: _null_build_key(low, node))
        else:
            raise ExecError(f"join kind {node.kind}")
        return cols, sel

    def _probe_join_kernel(self, node: N.PJoin, bcols, bselm, bkeys,
                           pselm, pkeys):
        """The probe-join kernel's gate (the reference's fused-path rules):
        a unique build of at most CK.PROBE_MAX_BUILD rows whose keys pack to
        32 bits, with integer or bool payload; and, the port's own limit,
        at most CK.PROBE_MAX_KEYS key and CK.PROBE_MAX_PAYLOAD payload
        columns. Returns (matched, payload cols, duplicate flag) or None →
        sorted lookup."""
        if node.pack_bits != 32:
            return None
        if int(bselm.shape[0]) > CK.PROBE_MAX_BUILD:
            return None
        if len(bkeys) > CK.PROBE_MAX_KEYS or \
                len(node.build_payload) > CK.PROBE_MAX_PAYLOAD:
            return None
        pay = [bcols[nm] for nm in node.build_payload]
        if any(c.dtype.is_floating_point for c in pay):
            return None  # float payload keeps the sorted path
        dup = self._dup_slot()
        matched, gathered = CK.probe_join(bkeys, bselm, pkeys, pselm, pay,
                                          dup)
        return matched, dict(zip(node.build_payload, gathered)), dup

    def _dup_slot(self) -> torch.Tensor:
        """A zeroed int32[1] slot for one probe join's duplicate flag: the
        statement's joins share one buffer, filled with zeros once."""
        if self._dup_flags is None or \
                self._dup_used == self._dup_flags.shape[0]:
            self._dup_flags = torch.zeros((64,), dtype=torch.int32,
                                          device=self.device)
            self._dup_used = 0
        self._dup_used += 1
        return self._dup_flags[self._dup_used - 1:self._dup_used]

    def _join_semi_residual(self, node: N.PJoin, bcols, bselm, bkeys,
                            pcols, psel, pselm, pkeys):
        """Correlated EXISTS with extra non-equi conditions (Q21 shape):
        expand equi-match pairs, evaluate the residual per pair, then
        OR-reduce back onto probe rows."""
        cap = node.out_capacity
        pi, bi, osel, _matched, total = self._expand_pairs(
            node, bkeys, bselm, pkeys, pselm, cap)
        self.checks[
            f"semi-join expansion overflow: match pairs exceed capacity "
            f"{cap} (node {id(node)})"] = total > cap
        pi, bi = pi.to(torch.int64), bi.to(torch.int64)
        paircols = {name: c[pi] for name, c in pcols.items()}
        for name in node.build_payload:
            paircols[name] = bcols[name][bi]
        rmask = self.expr(node.residual, paircols) & osel
        hit = torch.zeros(psel.shape, dtype=torch.uint8, device=self.device)
        hit = hit.scatter_reduce(0, pi, rmask.to(torch.uint8), "amax")
        hit = hit.to(torch.bool)
        sel = psel & hit if node.kind == "semi" else psel & ~hit
        return dict(pcols), sel

    def _join_expand(self, node: N.PJoin, bcols, bsel, bselm, bkeys,
                     pcols, psel, pselm, pkeys):
        """Many-to-many expansion: one output row per match pair; LEFT joins
        append unmatched (preserved) probe rows after the pairs; FULL joins
        append unmatched rows from BOTH sides."""
        cap = node.out_capacity
        pi, bi, osel, matched, total = self._expand_pairs(
            node, bkeys, bselm, pkeys, pselm, cap)
        pi, bi = pi.to(torch.int64), bi.to(torch.int64)
        need = total
        is_pair = osel
        j = torch.arange(cap, dtype=torch.int64, device=self.device)
        probe_valid = osel  # rows whose probe columns are real
        if node.kind in ("left", "full"):
            um = psel & ~matched
            um_rank = torch.cumsum(um.to(torch.int64), 0) - 1
            n_um = um.sum(dtype=torch.int64)
            pi = _scatter_drop(pi, total + um_rank, um, cap)
            osel = j < (total + n_um)
            is_pair = j < total
            probe_valid = osel
            need = total + n_um
            if node.kind == "full":
                bmatched = torch.zeros(bsel.shape, dtype=torch.uint8,
                                       device=self.device)
                bmatched = bmatched.scatter_reduce(
                    0, bi, is_pair.to(torch.uint8), "amax").to(torch.bool)
                um_b = bsel & ~bmatched
                umb_rank = torch.cumsum(um_b.to(torch.int64), 0) - 1
                n_umb = um_b.sum(dtype=torch.int64)
                bi = _scatter_drop(bi, total + n_um + umb_rank, um_b, cap)
                osel = j < (total + n_um + n_umb)
                # build columns are real for pairs AND the build-only region
                is_pair = (j < total) | (j >= total + n_um)
                probe_valid = j < (total + n_um)
                need = total + n_um + n_umb
        elif node.kind != "inner":
            raise ExecError(f"expansion join does not support {node.kind}")
        self.checks[
            f"join expansion overflow: match pairs exceed capacity {cap} "
            f"(node {id(node)})"] = need > cap

        cols = {}
        for name, c in pcols.items():
            g = c[pi]
            if node.kind == "full":
                g = torch.where(probe_valid, g, torch.zeros_like(g))
            cols[name] = g
        for name in node.build_payload:
            g = bcols[name][bi]
            cols[name] = torch.where(is_pair, g, torch.zeros_like(g))
        if node.match_name:
            cols[node.match_name] = is_pair
        if node.probe_match_name:
            cols[node.probe_match_name] = probe_valid
        return cols, osel

    def window(self, node: N.PWindow):
        """Windows over sorted partitions — scatter-free: boundary flags,
        compacted starts, cumulative-sum differences (nodeWindowAgg analog;
        with ORDER BY the frame is RANGE UNBOUNDED PRECEDING..CURRENT ROW,
        peers included, per the SQL default). The reference's lowering op
        for op; row counts (n_sel, n_segs, n_runs) stay device tensors, so
        the host never waits on the device here. Every gather index is
        clamped into range where the reference relies on JAX's silent
        clamping (PyTorch raises or asserts instead)."""
        cols, sel = self.lower(node.child)
        cap = sel.shape[0]
        dev = self.device
        pk = [_as_column(self.expr(e, cols), cap)
              for e in node.partition_keys]
        # ORDER BY on strings sorts by collation rank, not dictionary code
        # (same rule PSort applies via _sortable)
        ok = [_as_column(_sortable(e, node.child, cols, dev), cap)
              for e, _ in node.order_keys]
        desc = [not asc for _, asc in node.order_keys]
        perm = K.sort_indices(pk + ok, sel,
                              descending=[False] * len(pk) + desc)
        idx = torch.arange(cap, device=dev)
        inv = torch.empty_like(perm).scatter_(0, perm, idx)
        s_sel = sel[perm]
        n_sel = s_sel.sum(dtype=torch.int64)
        last = cap - 1

        def flags(keys):
            f = torch.zeros(cap, dtype=torch.bool, device=dev)
            for k in keys:
                ks = k[perm]
                f = f | (ks != torch.roll(ks, 1))
            f[0] = True
            return f & s_sel

        seg_flag = flags(pk)    # without PARTITION BY: row 0 only
        run_flag = (seg_flag | flags(ok)) if ok else seg_flag

        def bounds(flag):
            """Per row: the 0-based id of its segment (run), its first and
            last sorted position, and the cumulative flag count."""
            starts_c = _compacted_starts(flag)
            cum = torch.cumsum(flag.to(torch.int64), 0)
            id0 = (cum - 1).clamp(0, last)
            n = flag.sum(dtype=torch.int64)
            start = starts_c[id0]
            nxt = starts_c[(id0 + 1).clamp(0, last)]
            end = torch.where(id0 + 1 < n, nxt - 1, n_sel - 1)
            return start, end, cum

        seg_start, seg_end, _ = bounds(seg_flag)
        run_start, run_end, run_cum = bounds(run_flag)

        # explicit frame (node.frame): per-row [flo, fhi] bounds in sorted
        # coordinates. The SQL default keeps the peer-inclusive RANGE
        # semantics (run_end); ROWS frames are purely positional and can
        # be EMPTY at partition edges (fempty)
        fempty = None
        if node.frame is None:
            flo = seg_start
            fhi = run_end if node.order_keys else seg_end
        elif node.frame[0] == "whole":
            flo, fhi = seg_start, seg_end
        elif node.frame[0] == "rangepos":
            # positional RANGE (CURRENT ROW / UNBOUNDED bounds only):
            # peer-group or partition edges, never empty. Without ORDER BY
            # every row is a peer (run_* == seg_*), the SQL rule.
            flo = run_start
            fhi = run_end if node.frame[2] == "peer" else seg_end
        elif node.frame[0] == "rangeoff":
            flo, fhi = self._range_offset_frame(
                node, ok, perm, s_sel, seg_start, seg_end, run_start,
                run_end)
            fempty = flo > fhi
        else:
            _, lo_off, hi_off = node.frame
            flo = seg_start if lo_off is None \
                else torch.maximum(idx + lo_off, seg_start)
            fhi = seg_end if hi_off is None \
                else torch.minimum(idx + hi_off, seg_end)
            fempty = flo > fhi

        def zero_where(mask, o):
            return torch.where(mask, torch.zeros((), dtype=o.dtype,
                                                 device=dev), o)

        out_cols = dict(cols)
        valids = node.valids or [None] * len(node.calls)
        params_list = node.params or [None] * len(node.calls)
        for (name, func, arg), valid, params in zip(node.calls, valids,
                                                    params_list):
            # per-call argument validity in sorted row order: count counts
            # only valid rows, avg divides by the valid count, 'anyvalid'
            # is the null mask for nullable agg outputs
            va = (s_sel & _as_column(self.expr(valid, cols), cap)[perm]) \
                if valid is not None else s_sel
            base = func.split("@", 1)[0]
            if func == "row_number":
                o = idx - seg_start + 1
            elif func == "ntile":
                # SQL ntile: larger buckets first — with s rows and n
                # buckets, the first s%n buckets get s//n+1 rows
                n = params["n"]
                rip = idx - seg_start
                psize = seg_end - seg_start + 1
                base_sz = _floordiv(psize, n)
                rem = torch.remainder(psize, n)
                thresh = rem * (base_sz + 1)
                o = torch.where(
                    rip < thresh,
                    _floordiv(rip, (base_sz + 1).clamp_min(1)),
                    rem + _floordiv(rip - thresh, base_sz.clamp_min(1))) + 1
            elif base in ("lead", "lag", "first_value", "last_value"):
                # positional reads within the sorted partition. The source
                # row index is computed per row; '<func>@mask' re-runs the
                # same gather over the argument's validity (plus the
                # in-partition range test) to produce the output null mask
                if base in ("lead", "lag"):
                    k = params["offset"]
                    src = idx + k if base == "lead" else idx - k
                    inrange = (src >= seg_start) & (src <= seg_end)
                elif base == "first_value":
                    # frame start (the partition head under the default)
                    src = flo
                    inrange = None if fempty is None else ~fempty
                else:
                    # last_value: frame end — under the default frame the
                    # current row's peer group, not the partition tail
                    src = fhi
                    inrange = None if fempty is None else ~fempty
                srcc = src.clamp(0, last)
                dflt = (params or {}).get("default")
                if func.endswith("@mask"):
                    o = va[srcc]
                    if inrange is not None:
                        # out-of-range rows take the (non-NULL) default
                        o = (o | ~inrange) if dflt is not None \
                            else inrange & o
                else:
                    v = _as_column(self.expr(arg, cols), cap)[perm]
                    o = v[srcc]
                    if inrange is not None:
                        fill = self.expr(dflt, cols).to(v.dtype) \
                            if dflt is not None \
                            else torch.zeros((), dtype=v.dtype, device=dev)
                        o = torch.where(inrange, o, fill)
            elif func == "rank":
                o = run_start - seg_start + 1
            elif func == "dense_rank":
                o = run_cum - run_cum[seg_start] + 1
            elif func in ("sum", "count", "avg", "anyvalid"):
                if func in ("count", "anyvalid") or arg is None:
                    v = va.to(torch.int64)
                else:
                    x = _as_column(self.expr(arg, cols), cap)[perm]
                    v = torch.where(va, x, torch.zeros((), dtype=x.dtype,
                                                       device=dev))
                S = _prefix(v)
                hip = (fhi + 1).clamp(0, cap)
                lop = flo.clamp(0, cap)
                o = S[hip] - S[lop]
                if fempty is not None:
                    o = zero_where(fempty, o)
                if func == "avg":
                    C = _prefix(va.to(torch.int64))
                    cnt = C[hip] - C[lop]
                    if fempty is not None:
                        cnt = zero_where(fempty, cnt)
                    o = o.to(torch.float64) / cnt.clamp_min(1)
                    if arg is not None and arg.dtype.base == DType.DECIMAL:
                        o = _div(o, 10.0 ** arg.dtype.scale)
                elif func == "anyvalid":
                    o = o > 0
            elif func in ("min", "max") and node.frame is not None \
                    and node.frame[0] in ("rows", "rangeoff", "rangepos"):
                # ROWS/RANGE-offset-frame extreme: sparse-table range
                # query over [flo, fhi] — the prefix-sum trick does not
                # invert for min/max, and the running scan only covers
                # suffix-anchored frames
                ks = _as_column(_sortable(arg, node.child, cols, dev),
                                cap)[perm]
                cs = _as_column(self.expr(arg, cols), cap)[perm]
                o = _rmq_extreme(ks, cs, va, flo, fhi, cap,
                                 mx=(func == "max"))
                if fempty is not None:
                    o = zero_where(fempty, o)
            elif func in ("min", "max") and node.frame is None \
                    and node.order_keys:
                # running extreme (RANGE UNBOUNDED PRECEDING..CURRENT ROW,
                # peers included via run_end): segmented scan over sorted
                # rows. The combine is the standard segmented-scan operator
                # (reset flag ? right : extreme(left, right)) with the
                # extreme taken lexicographically over (validity desc,
                # sort rank, code) so it stays associative on ties and an
                # invalid (NULL) lane can NEVER beat a valid one — not
                # even when a valid value equals the dtype extreme (an
                # all-NULL prefix is nullified by the 'anyvalid' mask).
                ks = _as_column(_sortable(arg, node.child, cols, dev),
                                cap)[perm]
                cs = _as_column(self.expr(arg, cols), cap)[perm]
                _, _, _, runext = _doubling_scan(
                    _segmented_extreme(func == "max"),
                    (seg_flag, va, ks, cs))
                o = runext[run_end.clamp(0, last)]
            elif func in ("min", "max"):
                # whole-partition extreme: re-sort with the value last; the
                # extreme lands on each partition's boundary row (strings
                # order by collation rank, output keeps the code). Invalid
                # (NULL) lanes sort behind every valid row in their
                # partition, so they reach the boundary only for all-NULL
                # partitions — which the 'anyvalid' mask nullifies.
                v = _as_column(self.expr(arg, cols), cap)
                vkey = _as_column(_sortable(arg, node.child, cols, dev), cap)
                extra = [] if valid is None else \
                    [(~_as_column(self.expr(valid, cols), cap))
                     .to(torch.int32)]
                p2 = K.sort_indices(pk + extra + [vkey], sel,
                                    descending=[False] * (len(pk)
                                                          + len(extra))
                                    + [func == "max"])
                o = v[p2][seg_start]
            else:
                raise ExecError(f"window function {func}")
            o = torch.where(s_sel, o, torch.zeros((), dtype=o.dtype,
                                                  device=dev))
            out_cols[name] = o[inv]  # back to the child's row order
        return out_cols, sel

    def _range_offset_frame(self, node: N.PWindow, ok, perm, s_sel,
                            seg_start, seg_end, run_start, run_end):
        """Value-distance RANGE frame: per-row binary search for the key
        interval [k+lo, k+hi] inside the partition's non-NULL span.
        NULL-key rows frame exactly their peer group (the SQL rule: NULL ±
        offset stays NULL, NULLs are peers of NULLs), while UNBOUNDED sides
        keep the positional partition edge — which includes NULL rows,
        matching nodeWindowAgg.c. Returns (flo, fhi)."""
        cap = s_sel.shape[0]
        _, lo_off, hi_off, knull = node.frame
        asc = node.order_keys[-1][1]
        kv_s = ok[-1][perm]
        if knull:
            keyvalid = (ok[0][perm] == 0) & s_sel
            # NULLs sort last ASC / first DESC (PSort's rule), so valid
            # keys are a prefix (asc) or suffix (desc) of the partition
            C = _prefix(keyvalid.to(torch.int64))
            nv = C[(seg_end + 1).clamp(0, cap)] - C[seg_start.clamp(0, cap)]
            vlo = seg_start if asc else seg_end - nv + 1
            vhi = seg_start + nv - 1 if asc else seg_end
        else:
            keyvalid = s_sel
            vlo, vhi = seg_start, seg_end
        # search in frame direction: DESC negates so "PRECEDING" stays the
        # -offset side of a nondecreasing array
        s = kv_s if asc else -kv_s
        knullrow = s_sel & ~keyvalid

        def target(off):
            # numeric offsets are same-domain distances; a ("months", n)
            # offset is a CALENDAR shift of each row's civil date
            # (timestamp.c interval_pl: month arithmetic with the day of
            # month clamped). DESC negates the search domain, so the month
            # count flips too (s + off ≡ -(v - off) there): PRECEDING under
            # DESC reaches LATER dates.
            if isinstance(off, tuple):
                sh = _shift_months_days(kv_s, off[1] if asc else -off[1])
                return sh if asc else -sh
            return s + off

        if lo_off is None:
            flo = seg_start
        else:
            f = _vsearch(s, target(lo_off), vlo, vhi, cap, lower=True)
            flo = torch.where(knullrow, run_start, f)
        if hi_off is None:
            fhi = seg_end
        else:
            f = _vsearch(s, target(hi_off), vlo, vhi, cap, lower=False) - 1
            fhi = torch.where(knullrow, run_end, f)
        return flo, fhi

    def agg(self, node: N.PAgg):
        cols, sel = self.lower(node.child)
        agg_specs = []
        agg_values: dict[str, Any] = {}
        post_scale: dict[str, float] = {}
        for name, call in node.aggs:
            # NULL semantics are compiled away by the binder: nullable args
            # arrive identity-filled with companion valid-count aggregates
            func = call.func
            if func in ("sum", "min", "max", "avg", "count"):
                agg_values[name] = _as_column(
                    self.expr(call.arg, cols), sel.shape[0]) \
                    if call.arg is not None else None
            else:
                raise ExecError(f"aggregate {func} not implemented yet")
            if func == "avg" and call.arg is not None \
                    and call.arg.dtype.base == DType.DECIMAL:
                post_scale[name] = 10.0 ** call.arg.dtype.scale
            agg_specs.append(K.AggSpec(func, name))

        if not node.group_keys:
            out = K.global_aggregate(agg_values, agg_specs, sel)
            for name, div in post_scale.items():
                out[name] = _div(out[name], div)
            return out, torch.ones((1,), dtype=torch.bool,
                                   device=self.device)

        dense = self._dense_agg(node, cols, sel, agg_specs, agg_values,
                                post_scale)
        if dense is not None:
            return dense

        key_cols = {name: _as_column(self.expr(e, cols), sel.shape[0])
                    for name, e in node.group_keys}
        out_keys, out_aggs, out_sel, n_groups = merge_group_aggregate(
            key_cols, agg_values, agg_specs, sel, node.capacity)
        self.checks[
            f"aggregation overflow: more groups than capacity "
            f"{node.capacity} (node {id(node)})"] = n_groups > node.capacity
        for name, div in post_scale.items():
            out_aggs[name] = _div(out_aggs[name], div)
        return {**out_keys, **out_aggs}, out_sel

    def _dense_agg_kernel(self, gid, n_cells, agg_specs, agg_values, sel):
        """The dense-agg kernel for sum/count/avg over a small cell domain
        (the reference's fused-path gate). Integer-carried values (BIGINT,
        DECIMAL cents) sum exactly in int64; float values in float64.
        Returns None when ineligible (min/max) → scatter formulation."""
        if any(s.func not in ("sum", "count", "avg") for s in agg_specs):
            return None
        layout = []  # (spec, row, is_int, value dtype)
        irows, frows = [], []
        for s in agg_specs:
            if s.func not in ("sum", "avg"):
                continue
            v = agg_values[s.out_name]
            if K._is_int(v):
                layout.append((s, len(irows), True, v.dtype))
                irows.append(v.to(torch.int64))
            else:
                layout.append((s, len(frows), False, v.dtype))
                frows.append(v.to(torch.float64))
        n = sel.shape[0]
        ivals = torch.stack(irows) if irows else \
            torch.zeros((0, n), dtype=torch.int64, device=self.device)
        fvals = torch.stack(frows) if frows else \
            torch.zeros((0, n), dtype=torch.float64, device=self.device)
        counts, isums, fsums = CK.dense_agg(gid.to(torch.int32), ivals,
                                            fvals, sel, n_cells)
        out = {}
        for s, row, is_int, dt in layout:
            ssum = isums[row] if is_int else fsums[row]
            if s.func == "avg":
                out[s.out_name] = ssum.to(torch.float64) \
                    / counts.clamp_min(1)
            else:
                out[s.out_name] = ssum.to(dt)
        for s in agg_specs:
            if s.func == "count":
                out[s.out_name] = counts
        return out, counts > 0

    def _dense_agg(self, node: N.PAgg, cols, sel, agg_specs, agg_values,
                   post_scale):
        """Perfect-hash aggregation when ALL group keys are dictionary-coded
        strings with a small static domain (nodeAgg's hashed strategy with a
        compile-time-perfect hash) — skips the sort entirely."""
        sizes = []
        for name, e in node.group_keys:
            f = node.field(name)
            if f.type.base != DType.STRING or f.sdict is None \
                    or len(f.sdict) == 0:
                return None
            sizes.append(len(f.sdict))
        prod = 1
        for s in sizes:
            prod *= s
        if prod > min(node.capacity, DENSE_MAX_CELLS):
            return None

        strides = []
        acc = 1
        for s in reversed(sizes):
            strides.append(acc)
            acc *= s
        strides.reverse()

        gid = torch.zeros(sel.shape, dtype=torch.int32, device=self.device)
        for (name, e), stride in zip(node.group_keys, strides):
            gid = gid + self.expr(e, cols).to(torch.int32) * stride
        fused = self._dense_agg_kernel(gid, prod, agg_specs, agg_values, sel)
        if fused is not None:
            out_aggs, occupied = fused
        else:
            out_aggs, occupied = K.group_aggregate_dense(
                gid, prod, agg_values, agg_specs, sel)
        for name, div in post_scale.items():
            out_aggs[name] = _div(out_aggs[name], div)

        cell = torch.arange(prod, dtype=torch.int32, device=self.device)
        out_keys = {}
        for (name, _), stride, size in zip(node.group_keys, strides, sizes):
            out_keys[name] = torch.remainder(
                torch.div(cell, stride, rounding_mode="floor"), size)

        cap = node.capacity
        if cap > prod:
            pad = cap - prod
            out_keys = {n: _pad(c, pad) for n, c in out_keys.items()}
            out_aggs = {n: _pad(c, pad) for n, c in out_aggs.items()}
            occupied = _pad(occupied, pad)
        return {**out_keys, **out_aggs}, occupied


def _null_build_key(low: Lowerer, node: N.PJoin) -> torch.Tensor:
    """A null-aware anti join's local part of its global test: does this
    lowerer's build side hold a selected row with a NULL key?"""
    bcols, bsel = low.lower_shared(node.build)
    return (bsel & ~low.expr(node.build_key_valid, bcols)).any()


def merge_group_aggregate(key_cols, agg_values, specs, sel, capacity: int):
    """Grouped-aggregation dispatch: the sorted-segment kernel when
    eligible (sum/avg over integer-carried values + count, at most
    MAX_SEG_ROWS rows — the reference's gate), else the sort path. The two
    produce BIT-IDENTICAL results for eligible aggs."""
    if CK.sorted_segment_eligible(specs, agg_values, int(sel.shape[0])):
        return CK.sorted_segment_aggregate(key_cols, agg_values, specs, sel,
                                           capacity)
    return K.group_aggregate(key_cols, agg_values, specs, sel, capacity)


def _sortable(e: ex.Expr, child: N.PlanNode, cols, device) -> torch.Tensor:
    """ORDER BY key array; string columns sort by host rank, not code."""
    arr = compile_expr(e, device)(cols)
    if e.dtype.base == DType.STRING:
        sdict = None
        if isinstance(e, ex.ColumnRef):
            try:
                sdict = child.field(e.name).sdict
            except KeyError:
                sdict = getattr(e, "_sdict", None)
        else:
            sdict = getattr(e, "_sdict", None) or getattr(e, "_out_dict", None)
        if sdict is not None and len(sdict):
            rank = torch.as_tensor(sdict.rank_table(), device=device)
            safe = arr.clamp(0, rank.shape[0] - 1).to(torch.int64)
            return torch.where(arr >= 0, rank[safe],
                               torch.full((), -1, dtype=rank.dtype,
                                          device=device))
    return arr


def _div(t: torch.Tensor, div: float) -> torch.Tensor:
    """t / div as an IEEE division: PyTorch's CUDA kernel turns division
    by a Python scalar into multiplication by its reciprocal, which can
    differ in the last bit from the reference's (and the CPU's) quotient."""
    return t / torch.full((), div, dtype=torch.float64, device=t.device)


def _floordiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _prefix(vals: torch.Tensor) -> torch.Tensor:
    """[0, cumsum(vals)...] in the values' dtype (the reference's cumsum
    keeps an int32 input int32, wrapping the same way)."""
    csum = torch.cumsum(vals, 0).to(vals.dtype)
    return torch.cat([torch.zeros((1,), dtype=csum.dtype,
                                  device=csum.device), csum])


def _compacted_starts(flag: torch.Tensor) -> torch.Tensor:
    """The flagged positions in order, then the others in order — the
    reference's ``argsort(~flag, stable=True)`` (sorted as int8, since a
    bool sort key is not portable)."""
    return torch.argsort((~flag).to(torch.int8), stable=True)


def _rank_better(mx: bool, v1, r1, c1, v2, r2, c2):
    """True where lane 2 beats lane 1 by (valid desc, sort rank, code) —
    THE extreme comparator: an invalid (NULL) lane never beats a valid
    one, strings compare by collation rank with code as the associativity
    tie-break. Shared by the running-extreme segmented scan and the
    ROWS-frame sparse-table query so the two min/max paths cannot
    diverge."""
    if mx:
        by_rank = (r2 > r1) | ((r2 == r1) & (c2 > c1))
    else:
        by_rank = (r2 < r1) | ((r2 == r1) & (c2 < c1))
    return (v2 & ~v1) | ((v2 == v1) & by_rank)


def _better(mx: bool, a, b):
    """The extreme of two (valid, rank, code) lanes, elementwise."""
    v1, r1, c1 = a
    v2, r2, c2 = b
    take2 = _rank_better(mx, v1, r1, c1, v2, r2, c2)
    return (v1 | v2, torch.where(take2, r2, r1), torch.where(take2, c2, c1))


def _segmented_extreme(mx: bool):
    """The running-extreme combine over (reset flag, valid, rank, code):
    segment reset flag ? right : extreme(left, right)."""
    def comb(a, b):
        f1, w1, r1, c1 = a
        f2, w2, r2, c2 = b
        take2 = f2 | _rank_better(mx, w1, r1, c1, w2, r2, c2)
        return (f1 | f2, torch.where(take2, w2, w1),
                torch.where(take2, r2, r1), torch.where(take2, c2, c1))
    return comb


def _doubling_scan(comb, xs: tuple) -> tuple:
    """Inclusive scan of an associative ``comb`` over a tuple of equally
    long lanes: Hillis–Steele doubling, ceil(log2 n) rounds in which
    element i takes comb(element i-d, element i). For an associative,
    exact combine this equals ``jax.lax.associative_scan``'s result."""
    n = xs[0].shape[0]
    d = 1
    while d < n:
        new = comb(tuple(x[:-d] for x in xs), tuple(x[d:] for x in xs))
        xs = tuple(torch.cat([x[:d], y]) for x, y in zip(xs, new))
        d *= 2
    return xs


def _floor_log2(w: torch.Tensor) -> torch.Tensor:
    """floor(log2 w) of positive int64 values, exactly (a bit search, where
    the reference takes 31 - clz)."""
    k = torch.zeros_like(w)
    for b in (32, 16, 8, 4, 2, 1):
        t = w >> b
        hit = t > 0
        k = torch.where(hit, k + b, k)
        w = torch.where(hit, t, w)
    return k


def _vsearch(s, target, lo, hi, cap: int, lower: bool):
    """Vectorized per-row binary search over the (partition-wise sorted)
    array s restricted to per-row inclusive bounds [lo, hi]: returns the
    insertion point — first index j with s[j] >= target (lower) or
    s[j] > target (upper); hi+1 when every bounded element is smaller.
    O(log cap) lock-step halvings, no data-dependent trip count."""
    l = lo
    h = hi + 1
    for _ in range(max(1, int(cap).bit_length()) + 1):
        active = l < h
        m = _floordiv(l + h, 2)
        mv = s[m.clamp(0, cap - 1)]
        go_right = (mv < target) if lower else (mv <= target)
        l = torch.where(active & go_right, m + 1, l)
        h = torch.where(active & ~go_right, m, h)
    return l


def _rmq_extreme(ks, cs, va, lo, hi, cap: int, mx: bool):
    """Per-row range extreme over [lo, hi] via a sparse table: O(n log n)
    build, two gathers per query. Lanes compare by (valid desc, sort rank,
    code): an invalid (NULL) lane never beats a valid one, and string ranks
    follow collation, not code order. Empty/all-NULL frames return an
    arbitrary code — the caller's masks nullify them. The table holds
    bit_length(cap) levels of (bool, rank, code): at 3M int64 rows, 22
    levels of 17 bytes a row, about 1.1 GB."""
    n_levels = max(1, int(cap).bit_length())
    dev = va.device
    V = torch.empty((n_levels, cap), dtype=torch.bool, device=dev)
    R = torch.empty((n_levels, cap), dtype=ks.dtype, device=dev)
    C = torch.empty((n_levels, cap), dtype=cs.dtype, device=dev)
    V[0], R[0], C[0] = va, ks, cs
    pos = torch.arange(cap, device=dev)
    step = 1
    for lvl in range(1, n_levels):
        j2 = (pos + step).clamp(max=cap - 1)
        prev = (V[lvl - 1], R[lvl - 1], C[lvl - 1])
        V[lvl], R[lvl], C[lvl] = _better(mx, prev,
                                         tuple(t[j2] for t in prev))
        step *= 2
    w = (hi - lo + 1).clamp_min(1)
    k = _floor_log2(w).clamp(max=n_levels - 1)
    p1 = lo.clamp(0, cap - 1)
    p2 = (hi - torch.bitwise_left_shift(torch.ones_like(k), k) + 1) \
        .clamp(0, cap - 1)
    _, _, out = _better(mx, (V[k, p1], R[k, p1], C[k, p1]),
                        (V[k, p2], R[k, p2], C[k, p2]))
    return out


def _days_from_civil(y, m, d):
    """(year, month, day) → days since 1970-01-01; Howard Hinnant's
    branchless days-from-civil (the inverse of
    expr_compile._civil_from_days)."""
    m = m.to(torch.int64)
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = _floordiv(y, 400)
    yoe = y - era * 400
    doy = _floordiv(153 * (m + torch.where(m > 2, -3, 9)) + 2, 5) + d - 1
    doe = yoe * 365 + _floordiv(yoe, 4) - _floordiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _shift_months_days(days, n_months: int):
    """Shift day-numbers by n calendar months, clamping the day of month
    (Mar 31 - 1 month = Feb 28) — PG's date + interval 'n months'
    semantics (src/backend/utils/adt/timestamp.c interval_pl role),
    vectorized for the RANGE frame search. Divisions floor, as jnp's do,
    so days before 1970 shift correctly."""
    from cloudberry_tpu_torch.exec.expr_compile import _civil_from_days

    y, m, d = _civil_from_days(days)
    mm = m.to(torch.int64) - 1 + n_months
    y2 = y.to(torch.int64) + _floordiv(mm, 12)
    m2 = torch.remainder(mm, 12) + 1
    leap = (torch.remainder(y2, 4) == 0) & (
        (torch.remainder(y2, 100) != 0) | (torch.remainder(y2, 400) == 0))
    # days in month m2 without a host-built table: 31 for odd months up
    # to July and even ones from August, else 30; February 28 or 29
    dim = 30 + torch.remainder(m2 + (m2 >= 8).to(torch.int64), 2)
    dim = torch.where(m2 == 2, 28 + leap.to(torch.int64), dim)
    d2 = torch.minimum(d.to(torch.int64), dim)
    return _days_from_civil(y2, m2, d2)


def _pad(a: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([a, torch.zeros(pad, dtype=a.dtype, device=a.device)])


def _scatter_drop(dst: torch.Tensor, slot: torch.Tensor, mask: torch.Tensor,
                  cap: int) -> torch.Tensor:
    """dst[slot[i]] = i where mask[i] and slot[i] < cap (JAX's
    ``.at[slot].set(..., mode='drop')``)."""
    keep = mask & (slot < cap)
    src = torch.arange(mask.shape[0], dtype=dst.dtype, device=dst.device)
    out = dst.clone()
    out[slot[keep]] = src[keep]
    return out


def _substitute_subqueries(e: ex.Expr, mapping: dict[int, str]) -> ex.Expr:
    """Replace SubqueryScalar nodes with ColumnRefs into the augmented
    column dict."""
    return ex.rewrite(
        e, lambda n: ex.ColumnRef(mapping[id(n)], n.dtype)
        if isinstance(n, ex.SubqueryScalar) else None)
