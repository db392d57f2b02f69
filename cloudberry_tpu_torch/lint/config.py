"""graftlint configuration of the port — scope, known-concurrent
classes, lock order.

Everything project-specific the passes need lives here so the analyzer
core stays generic: which files are in scope, which attribute names map
to which concurrent classes (the cross-class acquisition edges the AST
cannot type), which modules are kernel/tile scope, and the DECLARED lock
order the runtime witness asserts. The classes, wiring names and modules
are the port's own (``cloudberry_tpu_torch/``), which keep the JAX
package's names where the port has the same class.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# directories never scanned (relative path components)
EXCLUDE_DIRS = frozenset({
    "__pycache__", ".git", ".pytest_cache", "tests", "build", "dist",
})

# files never scanned (relative path suffixes)
EXCLUDE_FILES = frozenset({
    "conftest.py",
})

# classes whose shared mutable attributes the lock pass audits even when
# the mixed-guard heuristic alone would not select them — the concurrent
# core's known-shared objects (the multi-tenant serving core). CacheScope is the shared-cache tier's per-scope record (the
# SharedCacheTier analog).
CONCURRENT_CLASSES = frozenset({
    "Dispatcher", "TenantScheduler", "CacheScope", "StatementLog",
    "RecoveryStore", "CircuitBreaker", "CancelToken", "Watchdog",
    "AdmissionGate", "VmemTracker", "QueueManager", "_Conn", "_IOLoop",
    "MetricsRegistry", "StatementStats", "Trace", "Progress",
    "TopologyManager", "ScanPipeline", "BufferPool", "FeedbackStore",
    "IngestService", "CompactionService",
})

# attribute-name → class-name hints for cross-class lock edges: when a
# method calls ``self.<attr>.m()`` while holding a lock, the pass needs
# the attribute's class to know which locks ``m`` acquires. Python has
# no static types here; these are the project's stable wiring names.
ATTR_CLASS_HINTS = {
    "tenancy": "TenantScheduler",
    "stmt_log": "StatementLog",
    "_breaker": "CircuitBreaker",
    "_recovery": "RecoveryStore",
    "_gate": "AdmissionGate",
    "_vmem": "VmemTracker",
    "_queues_mgr": "QueueManager",
    "dispatcher": "Dispatcher",
    "_dispatcher": "Dispatcher",
    "watchdog": "Watchdog",
    "_rw": "_RWLock",
    "loop": "_IOLoop",
    "conn": "_Conn",
    "token": "CancelToken",
    "_cache_scope": "CacheScope",
    "scope": "CacheScope",
    "_topology": "TopologyManager",
    "topology": "TopologyManager",
    "topo": "TopologyManager",
    "registry": "MetricsRegistry",
    "statements": "StatementStats",
    "session": "Session",
    "sess": "Session",
    "_sched": "TenantScheduler",
    # two-level motion wiring: the transport and its derived
    # topology are immutable/lock-free by design, but name them so
    # cross-class call edges resolve when a lock-holding caller touches
    # them (and so a future lock added there is discovered, not missed)
    "tx": "HierarchicalCollectives",
    "hier_topo": "HostTopology",
    # HBM buffer pool (exec/bufferpool.py) — the scan-path consumers
    # and the topology-cutover sweep reach it through these names
    "bpool": "BufferPool",
    "bufpool": "BufferPool",
    "_bufpool": "BufferPool",
    # learned-stats store (plan/feedback.py) — planner consumers reach
    # it through these names while cache-tier locks may be held
    "feedback": "FeedbackStore",
    "_feedback_store": "FeedbackStore",
    # write plane: the server and capacity gauges reach the
    # ingest buffers / compactor through these names
    "ingest": "IngestService",
    "_ingest": "IngestService",
    "compactor": "CompactionService",
    "_compactor": "CompactionService",
}

# modules (repo-relative path suffixes) whose jitted / kernel functions
# the trace-purity pass audits: none. The pass checks bodies that run
# under a trace (``jax.jit``, ``shard_map``, ``pl.pallas_call``); the
# port has no traced body — its operators are eager PyTorch and its
# kernels CUDA C++ behind ctypes (exec/cuda_kernels.py) — so the scope
# is empty and the pass stays, with the JAX package's rules, for a
# module that names one.
KERNEL_MODULES: tuple = ()

# functions in kernel scope whose name contains one of these substrings
# implement the int64/DECIMAL limb convention itself — the one place f32
# accumulation of integer limbs is the POINT, not a bug
LIMB_FUNC_MARKERS = ("limb", "decimal")

# modules whose unbounded tile/retry loops must contain a cancel seam
SEAM_LOOP_MODULES = (
    "exec/tiled.py",
    "exec/tiled_dist.py",
    "exec/recovery.py",
    "exec/scanpipe.py",
    "exec/tilepipe.py",
    "storage/ingest.py",
    "storage/compact.py",
)

# calls that count as a cancellation seam inside a loop body;
# drain_one/drain_all route every drained tile through
# _raise_tile_checks, so the windowed dispatcher's drain loops poll
# cancellation once per verified tile
CANCEL_SEAM_CALLS = frozenset({
    "check_cancel", "raise_if_cancelled", "_raise_tile_checks", "check",
    "drain_one", "drain_all",
})

# modules whose wire-response dict literals the taxonomy pass audits
WIRE_MODULES = (
    "serve/server.py",
    "serve/asyncore.py",
    "serve/mcp.py",
)

# where the taxonomy of record lives
TAXONOMY_MODULE = "lifecycle.py"
RETRYABLE_NAMES_CONST = "_RETRYABLE_NAMES"

# where the seam inventory of record lives
FAULTINJECT_MODULE = "utils/faultinject.py"
INVENTORY_CONST = "INVENTORY"

# where the wire metadata verbs live (the obs pass pins describe()'s
# documented Kinds list to its implemented kind == "..." branches)
META_MODULE = "serve/meta.py"

# planprops pass anchors: the plan verifier's rule table of record,
# and the checkpointing/re-placement mode tables it pins together
PLAN_VERIFY_MODULE = "plan/verify.py"
TILED_MODULE = "exec/tiled.py"
RECOVERY_MODULE = "exec/recovery.py"

# ---------------------------------------------------------------- witness

# The DECLARED lock acquisition order (coarse ranks; acquiring a lock of
# rank <= a held lock's rank, other than re-entering the same object, is
# a violation the runtime witness records). Derived from the static
# acquisition graph (`python -m cloudberry_tpu_torch.lint --dot`) —
# update BOTH when the order legitimately changes. Locks not named here
# are unwitnessed.
WITNESS_ORDER: tuple[tuple[str, ...], ...] = (
    # rank 0 — serving front end (outermost)
    ("Server._inflight_cond", "Server._conn_lock", "Server._login_lock",
     "_RWLock._cond", "_Conn.lock", "_IOLoop._tlock"),
    # rank 1 — scheduling tier + session cache sync + topology epochs
    # (TopologyManager._lock is never held across the session sync
    # lock: pin/cutover capture state under it, release, then adopt)
    ("Dispatcher._cond", "Session._sync_lock", "TopologyManager._lock"),
    # rank 2 — tenancy / breaker / cache-tier locks (Dispatcher._cond
    # and Session._sync_lock callers nest into these). The write-plane
    # conditions live here too: both are NEVER held across a flush /
    # SQL / the store lock (batches are taken under the condition,
    # executed outside it), never nested with each other (the
    # on_commit → wake call runs outside both), and only counter bumps
    # (rank-4 MetricsRegistry) happen while held.
    ("TenantScheduler._lock", "CircuitBreaker._lock",
     "CacheScope.generic_lock",
     "CacheScope.joinindex_lock", "RecoveryStore._lock",
     "AdmissionGate._lock", "VmemTracker._cond", "QueueManager._cond",
     "Session._stmt_lock", "IngestService._cond",
     "CompactionService._cond"),
    # rank 3 — accounting taken while cache locks are held (the
    # compile-counter bump inside a generic-plan build holds
    # generic_lock → StatementLog._lock; plan-local rung growth nests
    # under the session rung lock). The port's kernel build and the
    # sorted_seg header pick live here: each takes only the launch
    # counter's leaf lock while held.
    ("StatementLog._lock", "GenericPlan._rung_lock",
     "cuda_kernels._BUILD_LOCK", "cuda_kernels._SEG_LOCK"),
    # rank 4 — innermost leaves (never call out while held). The
    # feedback-store locks live HERE, not with the rank-2 cache-tier
    # locks: planning paths reach sketch lookups while holding
    # CacheScope locks (generic-plan builds plan under generic_lock),
    # so FeedbackStore._lock must nest inside them; _io_lock serializes
    # the _FEEDBACK.json write and is never nested with _lock (the
    # snapshot is taken, released, THEN written).
    ("CancelToken._lock", "faultinject._lock", "sharedcache._tier_lock",
     "MetricsRegistry._lock", "StatementStats._lock", "Trace._lock",
     "Progress._lock", "mesh._topo_lock", "ScanPipeline._cond",
     "scanpipe._pool_lock", "BufferPool._lock",
     "bufferpool._create_lock", "FeedbackStore._lock",
     "FeedbackStore._io_lock", "feedback._create_lock",
     # the port's leaves: the kernel launch counters, the two-level
     # transport's index tables, and the cluster join (held across
     # torch.distributed's rendezvous, which takes no engine lock)
     "cuda_kernels._COUNT_LOCK", "transport._TABLES_LOCK",
     "mesh._dist_lock"),
    # rank 5 — the storage IO shim's counter lock (storage/iofault.py):
    # every durable write can bump storage_io_errors, and writers reach
    # it while holding rank-4 locks (FeedbackStore._io_lock wraps the
    # _FEEDBACK.json atomic replace), so it nests inside EVERYTHING and
    # never calls out
    ("iofault._lock",),
)


def witness_ranks() -> dict[str, int]:
    return {name: rank
            for rank, tier in enumerate(WITNESS_ORDER)
            for name in tier}


@dataclass
class LintConfig:
    """One run's scope + knobs (tests override paths/excludes to point
    the analyzer at fixture trees)."""

    exclude_dirs: frozenset = EXCLUDE_DIRS
    exclude_files: frozenset = EXCLUDE_FILES
    concurrent_classes: frozenset = CONCURRENT_CLASSES
    attr_class_hints: dict = field(
        default_factory=lambda: dict(ATTR_CLASS_HINTS))
    kernel_modules: tuple = KERNEL_MODULES
    limb_func_markers: tuple = LIMB_FUNC_MARKERS
    seam_loop_modules: tuple = SEAM_LOOP_MODULES
    cancel_seam_calls: frozenset = CANCEL_SEAM_CALLS
    wire_modules: tuple = WIRE_MODULES
    taxonomy_module: str = TAXONOMY_MODULE
    faultinject_module: str = FAULTINJECT_MODULE
    meta_module: str = META_MODULE
    plan_verify_module: str = PLAN_VERIFY_MODULE
    tiled_module: str = TILED_MODULE
    recovery_module: str = RECOVERY_MODULE
    # seam names armed only from tests/tools (not declared at an engine
    # call site) that the inventory still documents
    inventory_extra_ok: frozenset = frozenset()

    def in_scope(self, relpath: str) -> bool:
        parts = relpath.replace("\\", "/").split("/")
        if any(p in self.exclude_dirs for p in parts[:-1]):
            return False
        return parts[-1] not in self.exclude_files
