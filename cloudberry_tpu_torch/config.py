"""Typed configuration tree — the GUC system analog.

The reference keeps ~6k lines of GUCs (``src/backend/utils/misc/guc_gp.c``).
Here configuration is a typed, immutable dataclass tree; a session carries
one, and ``with_overrides`` produces a modified copy. This port carries the
fields its slices read: the segment count and the motion transport, the
planner's (motion choices, the memo, direct dispatch, runtime filters),
the runtime join-filter digests, feedback, durable storage, the
device buffer pool, the join-index cache size, memory governance (the
per-query budget, the concurrency slots, the engine-wide red line and the
resource queue), the statement timeout, the observability plane and the
tiled (out-of-core) path's scan pipeline, dispatch window and checkpoint
store, the statement scheduler (generic plans and the micro-batch
dispatcher), the serving front end (``serve``, ``tenancy``, ``ingest``,
``compact``), failure recovery
(``health``: the retry, its breaker and the degrade) and the topology
plane (``topology``), and the plan verification gate
(``debug.verify_plans``). There is no counterpart
of the JAX package's ``exec.use_pallas``: the kernel gates are decided by
the plan's shapes alone, and on a CUDA device the hand-written kernels
always run.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class InterconnectConfig:
    """Motion transport knobs (reference: gp_interconnect_* GUCs,
    contrib/interconnect/ic_modules.c:26-160 vtable selection). On one
    card the segments share the device: a motion is an index transpose
    of the segments' wire buffers (parallel/transport.py)."""

    # Per-destination bucket capacity for hash redistribute, as a multiple of
    # fair share (local_rows / n_segments). The moral equivalent of the UDP
    # interconnect's capacity-based flow control (ic_udpifc.c:3018-3040):
    # rows over capacity are detected and reported, not silently dropped.
    capacity_factor: float = 2.0
    # Motion transport (the ic_modules.c vtable selection). "xla" is the
    # one-card exchange (the JAX package's name for its native
    # collectives, kept so configs carry over); "ring" is not ported.
    backend: str = "xla"
    # Packed wire format (exec/kernels.py wire_layout): every motion
    # bitcasts ALL its columns plus the row-validity mask into one
    # (rows, W) int32 buffer, so gather/broadcast/redistribute each move
    # ONE buffer instead of one per column. False falls back to the
    # per-column exchange (results are bit-identical either way).
    packed_wire: bool = True


@dataclass(frozen=True)
class PlannerConfig:
    """Planner settings: motion choices (the cost-model analog of
    cdbpath.c), the memo, direct dispatch, runtime filters, the
    materialized-view rewrite, autostats and point lookups."""

    # Broadcast the smaller join side instead of redistributing both when its
    # (estimated) row count is below this (reference: cdbpath_motion_for_join
    # cdbpath.c:1346 chooses broadcast vs redistribute by cost).
    broadcast_threshold: int = 100_000
    # Cascades-lite memo exploration (plan/memo.py, the gporca role): cost
    # and compare motion strategies over whole join trees — including the
    # GROUP BY's final redistribute — instead of deciding greedily per
    # join. Off falls back to the cdbpath.c-style rules alone.
    enable_memo: bool = True
    # Prune dispatch to a single segment for point predicates on the
    # distribution key (reference: cdbtargeteddispatch.c).
    enable_direct_dispatch: bool = True
    # Push a semi-join runtime filter below the probe's redistribute when
    # the estimated build side is at most this many rows (0 disables) —
    # the nodeRuntimeFilter.c analog, exact rather than bloom.
    runtime_filter_threshold: int = 1_000_000
    # Final grouped aggregation runs on ONE segment via gather when the
    # group capacity is at most this (the GATHER_SINGLE motion analog,
    # plannodes.h:1638): immune to hash-space skew across destinations,
    # and cheaper than an all_to_all for small partials. 0 disables.
    gather_single_threshold: int = 8192
    # Answer-query-using-matview rewrite (aqumv.c): SELECTs subsumed by a
    # FRESH aggregate materialized view read the view instead.
    enable_aqumv: bool = True
    # Auto-ANALYZE after DML (the gp_autostats_mode analog,
    # autostats.c:283): "none" | "on_no_stats" (first DML on an
    # unanalyzed table) | "on_change" (row count drifted more than
    # autostats_threshold since the last ANALYZE).
    autostats: str = "on_no_stats"
    autostats_threshold: float = 0.2
    # sorted-sidecar point lookups for WHERE col = const on big RAM
    # tables (plan/pointlookup.py — the index/block-directory analog)
    enable_point_lookup: bool = True


@dataclass(frozen=True)
class JoinFilterConfig:
    """Runtime join-filter digests + the join-index cache (the
    semijoin-reduction / runtime-filter-pushdown pair: ORCA's semijoin
    transforms, nodeRuntimeFilter.c's bloom mode).

    The EXACT runtime filter (planner.runtime_filter_threshold) gathers
    every packed build key and is preferred for small builds; the DIGEST
    filter here covers the builds too big for that: a fixed-size bloom
    bitmap plus packed-key min/max, exchanged as ONE small buffer and
    applied to probe rows BEFORE their redistribute. Bloom false positives
    only let extra rows through — results stay bit-identical."""

    # Digest (bloom + min/max) runtime filters on probe-side redistributes
    # whose estimated wire savings exceed the digest broadcast cost.
    enabled: bool = True
    # Bloom bitmap size in bits (rounded to a power of two >= 64).
    bloom_bits: int = 1 << 18
    # Hash probes per key (false-positive rate ~ (1 - e^{-k·n/m})^k).
    bloom_k: int = 3
    # Join-index (sorted-build) cache entries per cache scope: cached
    # (sort order, sorted packed keys, packing ranges) per build table
    # version — repeated statements skip the build-side argsort entirely.
    # 0 disables the cache.
    index_cache: int = 32


@dataclass(frozen=True)
class BufferPoolConfig:
    """Device-resident micro-partition buffer pool (exec/bufferpool.py) —
    the shared-buffer-pool analog with device residency: decoded
    columnar partition chunks stay in the session device's memory across
    statements, so a repeat scan of a hot table starts there instead of
    paying read + decode + transfer again. Keys carry the store version,
    the config epoch and the device, so results are bit-identical pool
    on/off by construction and stale entries can never serve."""

    # Resident budget in device bytes: the pool's chunks (per cache
    # scope — sessions over the same store root share one pool) plus a
    # session's assembled store scans (exec/executor.py). Admission
    # refuses oversize chunks and never evicts a hotter entry for a
    # colder one. 0 keeps no store read on the device across statements.
    max_bytes: int = 256 << 20
    # Admission threshold: a partition is admitted once it has been
    # scanned this many times (observed per-partition frequency); 1
    # admits on first touch.
    admit_min_scans: int = 2


@dataclass(frozen=True)
class StorageConfig:
    """Durable storage (PAX/AOCS analog, storage/table_store.py).

    With ``root`` set, the session's tables live in micro-partition files:
    DDL/DML persist through snapshot manifests, scans read only referenced
    columns from partitions that survive footer-stats pruning, and a fresh
    session on the same root sees every committed table."""

    root: str | None = None
    # Rows per micro-partition file — smaller means finer pruning
    # granularity, more files (the AO blocksize / PAX partition-size knob).
    rows_per_partition: int = 1 << 20
    # TDE cluster key (utils/tde.py): when set, micro-partition files and
    # manifests encrypt at rest (Fernet: AES-CBC + HMAC). Needs the
    # `cryptography` package; None = plaintext storage.
    encryption_key: str | None = None


@dataclass(frozen=True)
class ResourceConfig:
    """Memory governance analog (vmem_tracker.c:94, workfile_mgr.c)."""

    # Per-segment device-memory budget for one query's intermediates (bytes).
    query_mem_bytes: int = 4 << 30
    # Admission: max concurrent statements (resgroup slot pool analog,
    # resgroup.c:135-171).
    max_concurrency: int = 8
    # Tiled out-of-core execution when a plan exceeds the budget (the
    # workfile-manager / spill analog, exec/tiled.py); off = hard refusal.
    enable_spill: bool = True
    # Engine-wide memory red line across CONCURRENT statements (the vmem
    # tracker / red-zone analog, redzone_handler.c): admissions reserve
    # their estimate against it; adaptive growth crossing it terminates
    # the growing statement (runaway_cleaner.c). The reference's default;
    # an 80 GB card could hold more, but the port keeps it.
    total_mem_bytes: int = 16 << 30
    # The resource queue this session's statements run in (resqueue.c);
    # queues are created with CREATE RESOURCE QUEUE.
    queue: str = "default"


@dataclass(frozen=True)
class ObsConfig:
    """Observability plane (cloudberry_tpu_torch/obs/): statement trace
    spans, the session's metrics registry, and the pg_stat_statements-class
    aggregate table. ON by default; every ring and table below is
    explicitly bounded."""

    # Master switch for the OPTIONAL telemetry (trace spans, stage
    # histograms, per-skeleton aggregates, progress, capacity histograms,
    # flight captures). The counter registry itself stays on — engine
    # counters pre-date this subsystem and other features read them.
    enabled: bool = True
    # Keep every Nth statement's span tree (1 = all). Sampling bounds
    # tracing cost under high QPS without losing the aggregate plane.
    trace_sample: int = 1
    # Completed traces retained in the ring (StatementLog.traces).
    trace_ring: int = 64
    # Spans per statement trace; past it spans drop (counted).
    max_spans: int = 512
    # Skeleton rows in the pg_stat_statements analog (LRU dealloc).
    statements_max: int = 256
    # Slow-statement flight recorder (obs/flightrec.py): a statement
    # slower than this many milliseconds — or one that errors — captures
    # a bounded debug bundle (trace spans, plan, skeleton + param
    # fingerprint, counter deltas, config epoch, result digest) into the
    # session's ring (StatementLog.flights). 0 disables capture.
    slow_ms: float = 5000.0
    # Flight bundles retained (ring; oldest drop).
    flight_ring: int = 16
    # Per-motion skew alarm (obs capacity plane): a redistribute whose
    # global rows-per-destination max/mean ratio reaches this bumps
    # ``skew_events`` and stamps the ratio on EXPLAIN ANALYZE's motion
    # annotation. 0 disables the counter (histograms still record).
    skew_ratio: float = 3.0


@dataclass(frozen=True)
class FeedbackConfig:
    """Feedback-driven re-optimization (plan/feedback.py).

    After every distributed statement the motion stats (per-destination
    demand vectors, runtime-filter survivor counts) fold into
    per-(table, key-set) sketches keyed by content-stable tokens — DML
    version bumps and relevant config swaps invalidate by construction.
    The planner consumes them: the memo re-ranks join order / motion
    choice, the distributor seeds capacity rungs at the observed demand
    rung, and the cost model clamps group counts. A tiled distributed
    statement (exec/tiled_dist.py) also watches its redistributes' per-tile
    destination counts: when the cumulative skew crosses the alarm, the
    skew sentinel (exec/tiled.py ``SkewSentinel``) checkpoints the carried
    state and the session re-plans the rest of the statement, which
    resumes from the checkpoint."""

    enabled: bool = True
    # Multiplier over observed per-destination demand when seeding a
    # rung (rung_up gives pow2 headroom on top).
    headroom: float = 1.25
    # Persist sketches alongside ANALYZE stats (store-backed sessions
    # only) so fresh sessions inherit them.
    persist: bool = True
    # Mid-statement adaptive replan for tiled distributed statements
    # (reads only).
    adaptive: bool = True
    # Per-tile cumulative skew ratio (max/mean destination rows) that
    # triggers the mid-statement replan; 0 = inherit obs.skew_ratio.
    replan_skew_ratio: float = 0.0
    # Tiles observed before the skew alarm may fire (one hot tile is
    # noise; a sustained hot destination is a plan problem).
    min_tiles: int = 2
    # Mid-statement replans allowed per statement (the replan loop must
    # terminate even if the replanned statement stays skewed).
    max_replans: int = 1


@dataclass(frozen=True)
class DebugConfig:
    """Engine self-checks. ``verify_plans`` is the plan verification gate
    (plan/verify.py): every plan the planner or memo emits is verified —
    derived vs required distribution properties, capacity-rung
    discipline, param-slot and runtime-filter placement contracts —
    right before it runs, and a finding raises ``PlanVerifyError``
    instead of executing a plan whose sharding assumptions are wrong."""

    verify_plans: bool = False


@dataclass(frozen=True)
class ScanPipelineConfig:
    """Asynchronous tiled-scan pipeline (exec/scanpipe.py): a background
    reader stages the NEXT tiles (read + decode + pad) into a bounded
    prefetch queue while the device computes the current tile. Results are
    bit-identical pipeline on/off (same tiles, same order); the knobs only
    move decode/pad/transfer off the critical path. Queue memory is charged
    into the statement's tiled report (``est_pipeline_bytes``)."""

    enabled: bool = True
    # Tiles staged ahead of the consumer (the bounded queue depth).
    prefetch_tiles: int = 2
    # Reader-pool threads for column-parallel micro-partition decode.
    # <=1 decodes serially in the reader.
    decode_workers: int = 2
    # Device staging of the next tile while the current one runs: on CUDA
    # the tile is copied into pinned host memory and uploaded on a side
    # stream; on a CPU device it is a plain copy.
    device_buffer: bool = True


@dataclass(frozen=True)
class TilePipelineConfig:
    """Windowed in-flight tile dispatch (exec/tilepipe.py): the tiled loops
    keep up to ``inflight_tiles`` steps in flight and read each tile's
    overflow-check scalars through an async copy, up to W tiles late. A
    deferred failure replays from the recovery checkpoint store; results
    are bit-identical window on/off."""

    enabled: bool = True
    # In-flight tile steps. 1 reproduces the synchronous loop exactly.
    # <= 0 means auto: 1 on a CPU device, 4 on CUDA.
    inflight_tiles: int = 0


@dataclass(frozen=True)
class RecoveryConfig:
    """Tile-granular checkpoints of the tiled executors (exec/recovery.py):
    the carried state is snapshotted to a host-side, statement-scoped store
    every ``checkpoint_every`` tiles; the adaptive retry after a deferred
    overflow resumes from the last drained-clean snapshot."""

    enabled: bool = True
    # Tiles between snapshots (K).
    checkpoint_every: int = 4
    # Statements whose checkpoints the store retains at once (LRU).
    max_statements: int = 8
    # Host bytes the store may pin across all statements (0 = unbounded).
    max_bytes: int = 256 << 20


@dataclass(frozen=True)
class SchedConfig:
    """Statement scheduler — generic plans + the micro-batch dispatcher
    (sched/paramplan.py, sched/dispatcher.py; the plan_cache.c /
    gang-dispatch analog). The JAX package's ``max_variants`` and
    ``shared_cache`` are constants here (``paramplan._MAX_VARIANTS``,
    ``sharedcache.scope_for``)."""

    # Parameterized generic plans: hoist constant literals out of repeated
    # statements so same-shape SQL shares ONE Executable with literals fed
    # as device inputs. Off by default, where the JAX package has it on:
    # the port has no jit, so a generic hit saves only the construction of
    # an Executable (a closure) and pays the plan's signature walk, slower
    # than the plan-per-text path on the card. The exact-text statement
    # cache serves repeats either way. Results are the same on or off. The
    # dispatcher stacks a batch only through a generic plan, so with this
    # off ``enabled`` coalesces nothing and every request runs alone.
    generic_plans: bool = False
    # Continuous micro-batch dispatcher in front of the server's session:
    # coalesce same-skeleton statements per tick into one stacked launch.
    # Off by default — the server opts in.
    enabled: bool = False
    # Statements coalesced into one stacked launch per skeleton per tick.
    max_batch: int = 16
    # Bounded request queue (backpressure): submits beyond this block
    # briefly, then fail with SchedQueueFull.
    max_queue: int = 256
    # Coalescing window: after the first request arrives, wait this long
    # for same-skeleton company before flushing.
    tick_s: float = 0.002
    # Default per-request deadline; expired requests fail without
    # executing (SchedDeadline).
    deadline_s: float = 30.0


@dataclass(frozen=True)
class TenantSpec:
    """One declared workload tenant (the named-resource-group analog,
    extended from admission to throughput scheduling)."""

    name: str
    # Deficit-weighted-round-robin share: under saturation a tenant's
    # dispatch throughput is proportional to its weight.
    weight: int = 1
    # Concurrent statements of this tenant in flight (0 = unlimited).
    max_concurrency: int = 0
    # Bounded per-tenant request queue: submits beyond this depth refuse
    # with the retryable TenantQueueFull (backpressure, never silent).
    max_queue: int = 64


@dataclass(frozen=True)
class TenancyConfig:
    """Per-tenant workload governance (sched/tenancy.py): tenants are
    named resource groups picked in deficit-weighted-round-robin order
    inside the dispatcher tick, with starvation-free aging and per-tenant
    admission/backpressure."""

    enabled: bool = False
    # Declared tenants; requests carrying an unknown (or no) tenant name
    # fall into an auto-created group with the defaults below.
    tenants: tuple = ()          # tuple[TenantSpec, ...]
    default_weight: int = 1
    default_max_queue: int = 256
    # DWRR quantum multiplier: each scheduling round a tenant's deficit
    # grows by weight * quantum requests.
    quantum: int = 1
    # Starvation bound: a request waiting longer than this is picked
    # ahead of deficit order (oldest first).
    aging_s: float = 0.5
    # Grace period a blocking submit waits for queue space / a
    # concurrency slot before refusing with TenantQueueFull.
    slot_wait_s: float = 0.25


@dataclass(frozen=True)
class ServeConfig:
    """Serving front end (serve/server.py + serve/asyncore.py).

    The default transport is the EVENT-LOOP core: a handful of I/O
    threads multiplex every connection through selectors with
    non-blocking newline-JSON framing, and parsed requests execute on a
    bounded worker pool (dispatcher-bound reads complete asynchronously,
    so a worker never blocks on a queued batch). ``threaded=True`` keeps
    the thread-per-connection path."""

    # Thread-per-connection transport (socketserver). The event loop is
    # the default: thousands of connections on io_threads.
    threaded: bool = False
    # Accepted-connection cap across the whole server (0 = unlimited):
    # past it, new connections get ONE retryable SERVER_BUSY refusal line
    # and close.
    max_connections: int = 4096
    # listen(2) backlog for the accept socket.
    listen_backlog: int = 512
    # Event-loop I/O threads; connections are sharded across them.
    io_threads: int = 2
    # Worker threads executing parsed requests (0 = auto:
    # max(4, resource.max_concurrency)).
    workers: int = 0
    # Per-connection pipelined-request cap: a client that streams
    # requests without reading responses is paused once this many parsed
    # requests are pending.
    pipeline_depth: int = 64
    # Longest accepted request line in bytes; oversized lines get one
    # fatal error response, then the connection closes.
    max_line_bytes: int = 64 << 20


@dataclass(frozen=True)
class IngestConfig:
    """Streaming ingest plane (storage/ingest.py): per-(table, tenant)
    buffers batching wire appends into group commits. Durability is
    acknowledged only when the covering flush commits through the one SQL
    write path."""

    enabled: bool = True
    # Pending rows that trip an immediate (size-threshold) flush.
    flush_rows: int = 512
    # Oldest-pending-row age (milliseconds) that trips an age flush.
    flush_ms: float = 25.0
    # Per-buffer pending-row cap; past it append refuses with the
    # retryable IngestQueueFull (write backpressure, not data loss).
    max_buffered_rows: int = 8192


@dataclass(frozen=True)
class CompactConfig:
    """Background compaction service (storage/compact.py): the VACUUM
    analog for store-backed tables — merges delta partitions (including
    the rebalancer's destination-tagged ones), applies delete vectors,
    re-sorts toward the table's partition column, and re-packs toward
    rows_per_partition. OFF by default: a plain session/server pays
    nothing; the ingest-heavy deployment opts in."""

    enabled: bool = False
    # Seconds the worker sleeps between scans when nothing is due
    # (commits wake it immediately via IngestService.on_commit).
    interval_s: float = 2.0
    # Sleep between chunks — the background throttle (foreground reads
    # outrank the rewrite).
    throttle_s: float = 0.0
    # Source partitions merged per chunk (one OCC commit per chunk).
    chunk_partitions: int = 8
    # The bounded-delta invariant: a table whose delta-partition count
    # (dirty parts + mergeable small tails) exceeds this is compacted
    # back toward 0 (hysteresis: once triggered, drive to clean).
    max_delta_parts: int = 8
    # A clean partition counts as a mergeable small tail below
    # target_fill * storage.rows_per_partition live rows.
    target_fill: float = 0.5


@dataclass(frozen=True)
class HealthConfig:
    """Failure detection / recovery knobs (the FTS analog, fts.c:118).

    Segments are stateless (placement is recomputed from the tables), so
    recovery is re-execution rather than mirror promotion: a failed
    statement probes the segment slots (parallel/health.py) and
    re-dispatches — on fewer segments when slots are gone (degraded
    replanning: placement re-derives for any segment count)."""

    # Re-dispatches of a statement that failed with a device/runtime error.
    retries: int = 1
    # Probe every segment slot before a retry (the FTS_MSG_PROBE analog).
    probe_on_error: bool = True
    # Shrink the segment count to the live slot count before retrying.
    degrade: bool = True
    # First-retry backoff; attempt n waits backoff_s·2^n plus up to 50%
    # jitter, capped at backoff_max_s. The wait is interruptible:
    # cancellation and the deadline cut it short (lifecycle.py).
    backoff_s: float = 0.2
    backoff_max_s: float = 5.0
    # Per-statement retry budget in seconds: once this much wall clock
    # has gone to failed attempts + backoff, the next recoverable
    # failure is raised instead of retried. 0 = no budget (the
    # statement deadline still bounds everything).
    retry_budget_s: float = 0.0
    # Admission circuit breaker (lifecycle.CircuitBreaker): this many
    # CONSECUTIVE statements needing a device-loss recovery trip the
    # engine to read-only-degraded — writes refuse with the retryable
    # BreakerOpen until a health probe closes it. 0 disables.
    breaker_threshold: int = 3
    # Seconds the breaker stays open before a write may half-open it
    # (one health probe decides).
    breaker_cooldown_s: float = 30.0
    # HealthMonitor probe-history ring size (bounded).
    monitor_history: int = 256


@dataclass(frozen=True)
class TopologyConfig:
    """Online topology changes (parallel/topology.py): epoch-versioned
    placement, staged minimal-movement rebalance, breaker-guarded
    cutover, and failover-as-shrink. Statements pin a TopologyEpoch at
    dispatch; an expand/shrink creates a successor epoch and statements
    keep serving on the old one until cutover."""

    # Consecutive probe observations of the SAME survivor set before the
    # per-statement degrade is promoted to a formal failover-shrink
    # epoch (the FTS mark-down hysteresis; 1 = promote on first loss).
    promote_after: int = 2
    # Consecutive clean probes (slots back) before a failover-shrunk
    # cluster expands back to its pre-failover segment count.
    recover_after: int = 2
    # Automatic expand-back on recovery (the symmetric half of
    # failover-as-shrink). Off leaves the shrunken epoch serving until
    # an operator resizes.
    auto_recover: bool = True
    # Seconds a planned cutover waits for statements pinned to the old
    # epoch to finish before flipping anyway (stragglers stay correct —
    # placement is derived — or resume through the degraded re-shard
    # path). Failover promotion never waits.
    cutover_wait_s: float = 5.0
    # Rows hashed per rebalance chunk (the throttle/fault-seam unit for
    # in-RAM staging; store-backed tables chunk per micro-partition).
    rebalance_chunk_rows: int = 1 << 16
    # Sleep between rebalance chunks — the background-rebalance throttle.
    throttle_s: float = 0.0
    # Fresh plans verified by the plan verification gate (plan/verify.py)
    # right after an epoch adoption, even when config.debug.verify_plans
    # is off. 0 disables.
    verify_replans: int = 4


@dataclass(frozen=True)
class Config:
    # Segments of the distributed plan (the gang size). On one card every
    # segment is a set of row views of the same device's tensors.
    n_segments: int = 1
    # Per-statement wall-clock limit in seconds (the statement_timeout
    # GUC): every statement gets a deadline this far out; cooperative
    # checks at execution seams (and the watchdog, lifecycle.py) convert
    # an overrun into the retryable StatementTimeout. 0 disables.
    statement_timeout_s: float = 0.0
    interconnect: InterconnectConfig = field(
        default_factory=InterconnectConfig)
    planner: PlannerConfig = field(default_factory=PlannerConfig)
    join_filter: JoinFilterConfig = field(default_factory=JoinFilterConfig)
    bufferpool: BufferPoolConfig = field(default_factory=BufferPoolConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    resource: ResourceConfig = field(default_factory=ResourceConfig)
    scan_pipeline: ScanPipelineConfig = field(
        default_factory=ScanPipelineConfig)
    tile_pipeline: TilePipelineConfig = field(
        default_factory=TilePipelineConfig)
    health: HealthConfig = field(default_factory=HealthConfig)
    recovery: RecoveryConfig = field(default_factory=RecoveryConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    topology: TopologyConfig = field(default_factory=TopologyConfig)
    sched: SchedConfig = field(default_factory=SchedConfig)
    feedback: FeedbackConfig = field(default_factory=FeedbackConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    tenancy: TenancyConfig = field(default_factory=TenancyConfig)
    ingest: IngestConfig = field(default_factory=IngestConfig)
    compact: CompactConfig = field(default_factory=CompactConfig)
    debug: DebugConfig = field(default_factory=DebugConfig)

    def with_overrides(self, **kv: Any) -> "Config":
        """Return a copy with dotted-path overrides, e.g.
        ``cfg.with_overrides(**{"planner.autostats": "none"})``."""
        out = self
        for path, value in kv.items():
            parts = path.split(".")
            out = _replace_path(out, parts, value)
        return out


def _replace_path(node: Any, parts: list[str], value: Any) -> Any:
    if len(parts) == 1:
        return dataclasses.replace(node, **{parts[0]: value})
    child = getattr(node, parts[0])
    return dataclasses.replace(node, **{parts[0]: _replace_path(child, parts[1:], value)})


_global_config = Config()


def get_config() -> Config:
    return _global_config


def set_config(cfg: Config) -> None:
    global _global_config
    _global_config = cfg
