"""Session — the QD (query dispatcher) analog.

``sql()`` runs the statement pipeline: a statement-log entry with a
lifecycle handle (deadline from ``statement_timeout_s``, trace, live
progress) → parse → bind/plan → admission → launch on the session's
device → finish (statements table, trace ring) → the flight recorder. A
Session with no device runs on CUDA and raises when no CUDA device is
available; it never moves to the CPU by itself. The tests ask for
``device="cpu"``, which runs the kernels' plain versions.

Admission: every SELECT's plan is held against ``resource.query_mem_bytes``
(exec/resource.py). A plan over the budget is re-planned as a stream of
tiles (exec/tiled.py) and run that way; a plan whose shape cannot stream
raises the reference's ``ResourceError``. An admitted statement then takes
a concurrency slot (``resource.max_concurrency``), a slot of its resource
queue (``resource.queue``; CREATE RESOURCE QUEUE sets ACTIVE_STATEMENTS,
MAX_COST and PRIORITY) and reserves its estimate against the engine-wide
red line (``resource.total_mem_bytes``). ``last_tiled_report`` holds the
last tiled run's report (None after a one-shot statement; like the
reference's, one attribute per session, so concurrent tiled statements of
one session overwrite each other's). A join-expansion overflow (more
match pairs than the planner's estimate) grows the join's pair buffer,
re-checks admission and the red line and runs the statement again
(``growth_events`` counts the growths); a grown plan over the budget is
tiled, one that crosses the red line is terminated (``RunawayError``).
The statement-log id keys the tiled executors' checkpoint store; its
checkpoints are discarded when the statement ends. When a refused plan
cannot be tiled and ``planner.enable_memo`` is on, the statement is
re-planned greedily (memo off: the memo may have put a big relation on a
build side, and tiling streams the probe path only) and that plan is
tiled instead.

Statement cache: a repeated statement text (with the same user params)
reuses its runner — one-shot or tiled — without parsing or planning,
while every referenced table's version, the catalog's DDL version, the
UDF registry's version and the config object are unchanged
(``_cached_statement``). Generic plans (sched/paramplan.py) let a
statement of the same skeleton with other literals reuse the Executable
of an earlier one. Statements over table-function rows (and sequence
calls) bypass both.

Observability (exec/instrument.py, obs/): ``stmt_log`` holds the history
and active registry, the metrics registry (``counters`` is its counter
view: storage-path counts, statement errors, kernel builds), the stage
histograms (``stage_seconds.parse|plan|queue_wait|compile|launch``),
the statements table, the trace ring and the flight ring.
``explain_analyze`` runs a statement through the same pipeline with
per-node row counts. ``metrics_hooks`` receive each instrumented run's
QueryMetrics.

Durable storage: with ``config.storage.root`` set, the session opens the
store (storage/table_store.py), registers every stored table COLD (schema
and statistics from its manifest, no data read), and binds the catalog so
new tables persist. Scans of a cold table read only the partitions that
survive pruning, only the referenced columns (plan/scanprune.py), through
the device buffer pool and a per-session store-scan LRU
(exec/executor.py). Every statement first picks up other sessions'
commits (``_sync_store``). The store runs in autocommit mode.

Distributed execution: with ``config.n_segments > 1`` every SELECT is
planned by the distribution pass (plan/distribute.py, the memo and the
feedback store) and runs as a gang of segment lowerers on the session's
one device (exec/dist_executor.py): partitioned tables are placed by the
reference's hash (``sharded_table``) and uploaded as (nseg, capacity)
tensors (``device_shards``). A point statement on the distribution key
runs on its one segment (direct dispatch). An over-budget distributed
plan is tiled over the gang (exec/tiled_dist.py). A tiled distributed
READ whose redistributes turn skewed mid-stream may raise ``TileReplan``
(the skew sentinel, exec/tiled.py): ``sql`` then evicts the statement's
cache entry, owes the plan verifier one pass, re-plans under the same
statement handle (the memo sees the fresh feedback sketch) and the new
executable resumes from the sentinel's checkpoint — at most
``feedback.max_replans`` times per statement.

Plan verification: with ``debug.verify_plans`` on, every plan the
planner or memo emits is checked by plan/verify.py right before it runs
(the statement path, the greedy re-plan, the generic-plan build and
EXPLAIN); a finding raises ``PlanVerifyError``. The first
``topology.verify_replans`` fresh plans after a topology adoption are
verified with the gate off too.

Failure recovery (the FTS consumption point, fts.c:118): a READ that
fails with a recoverable error (parallel/health.py ``recoverable``: a
device loss, never an out-of-memory error, a kernel build failure or a
semantic error) is re-dispatched by ``run_with_retry`` up to
``health.retries`` times with a backoff that waits on the statement's
cancel token and deadline. Between attempts ``_recover_mesh`` probes the
segment slots and, when slots are gone, ``degrade_mesh`` shrinks the
segment count to the survivors (a 'degrade' topology epoch); a tiled
statement's retry resumes from its last checkpoint, re-sharding the
remaining rows by the placement hash at the smaller segment count
(exec/recovery.py). DML, DDL and COPY are never re-dispatched. The
admission circuit breaker (``lifecycle.CircuitBreaker``) counts the
statements that needed a recovery and, past ``health.breaker_threshold``
in a row, refuses writes with the retryable ``BreakerOpen`` until a
health probe closes it. The recovered statement re-runs the same CUDA
kernels; nothing gives way to a plain version.

Topology (parallel/topology.py): every statement pins the current
topology epoch; an online expand or shrink (``_topology.begin`` /
``rebalance`` / ``cutover``) or a failover promotion makes a successor
epoch, and the next pin adopts it (config swap, placement-derived caches
cleared). A plan whose epoch moved between planning and execution
raises ``TopologyRaceError`` and re-plans at the new epoch.

Transactions (``txn``): BEGIN snapshots the catalog's tables, views and
materialized-view definitions; a store-backed session defers its durable
writes to COMMIT, which publishes them under the store lock with the
reference's optimistic check (first committer wins for rewrites,
concurrent appends merge; a lost race raises ``SerializationError``).
ROLLBACK restores the snapshot and drops the device copies, shard layouts,
store-scan, join-index and buffer-pool entries of every table it restores
or removes. Inside a transaction the session does not pick up other
sessions' commits, and store-backed tables key the shared caches by table
object, not store version. Transaction control is exempt from the
breaker.

The rest of the SQL surface: materialized views (plan/matview.py, their
definitions reloaded from the store at start and at every sync),
parallel retrieve cursors (``parallel_cursors``, ``retrieve``;
exec/endpoint.py) and directory tables (``dir_upload`` / ``dir_read`` /
``dir_remove``; storage/dirtable.py).

Serving (serve/server.py): a ``Server`` over a store-backed session gives
every connection its own Session over the store (the backend analog),
sharing the server session's admission gate, resource queues, red line,
statement log, breaker, topology manager, recovery store, retrieve
endpoints and the dispatcher, tenancy and ingest services.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from cloudberry_tpu_torch.config import Config, get_config


class SerializationError(RuntimeError):
    """COMMIT lost the single-writer OCC race: another session committed a
    conflicting table version after this transaction's BEGIN snapshot."""


@dataclass
class ShardedTable:
    """Host-side sharded layout: per-column (n_segments, capacity) arrays
    padded to the largest shard, plus true per-segment row counts."""
    columns: dict[str, np.ndarray]
    counts: np.ndarray          # (n_segments,) int64
    capacity: int
    replicated: bool
    version: int


@dataclass
class DeviceShards:
    """A sharded table on the session's device: partitioned columns (and
    ``$nn:<col>`` validity masks) as (local segments, capacity) tensors —
    the rows of this process's segments ``lo, lo+1, ...`` (every segment
    in one process) — replicated ones whole; ``counts`` the per-segment
    row counts of EVERY segment (a device tensor for the scans, a host
    copy for planning-side reads). ``host`` is the host layout, which
    every process holds whole."""
    columns: dict[str, torch.Tensor]
    counts: torch.Tensor
    counts_host: np.ndarray
    capacity: int
    replicated: bool
    version: int
    nseg: int
    lo: int = 0
    host: Any = None
    _remote: dict = field(default_factory=dict)

    def shard(self, seg: int) -> dict:
        """Segment ``seg``'s columns: row views of the local block, or,
        for a segment another process owns (a direct-dispatched
        statement runs on every process alike), its host rows uploaded
        once."""
        i = seg - self.lo
        cols = self.columns
        first = next(iter(cols.values()), None)
        if first is None or 0 <= i < first.shape[0]:
            return {c: v[i] for c, v in cols.items()}
        hit = self._remote.get(seg)
        if hit is None:
            from cloudberry_tpu_torch.exec.bufferpool import to_device

            hit = self._remote[seg] = {
                c: to_device(v[seg], first.device)
                for c, v in self.host.columns.items()}
        return hit

    def whole(self, col: str) -> torch.Tensor:
        """Every segment's rows of ``col``, segment-major."""
        v = self.columns[col]
        if self.lo == 0 and v.shape[0] == self.nseg:
            return v.reshape(-1)
        return torch.cat([self.shard(s)[col] for s in range(self.nseg)])


def _host_layout():
    """The host split plans are stamped for: the forced simulated host
    count (parallel/mesh.py), None on the card's one real host."""
    import os

    return os.environ.get("CBTPU_FORCE_HOSTS") or None


class Session:
    def __init__(self, config: Config | None = None, device=None):
        from cloudberry_tpu_torch.catalog.catalog import Catalog

        # the config a statement attempt runs under, per thread (config)
        self._attempt_cfg = threading.local()
        self.config = config or get_config()
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "cloudberry_tpu_torch.Session() runs on CUDA and no "
                    "CUDA device is available; pass device='cpu' to run "
                    "the kernels' plain versions on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available")
        self.catalog = Catalog()
        # durable storage: register stored tables cold (schema/stats only),
        # then bind the catalog so new tables persist (order matters: the
        # registration itself must not write empty snapshots)
        self.store = None
        if self.config.storage.root:
            from cloudberry_tpu_torch.storage.table_store import TableStore

            self.store = TableStore(self.config.storage.root)
            self.store.rows_per_partition = \
                self.config.storage.rows_per_partition
            self.store.quota_bytes = self.config.storage.quota_bytes
            self.store.verify_checksums = \
                self.config.storage.verify_checksums
            if self.config.storage.encryption_key:
                from cloudberry_tpu_torch.utils.tde import make_cipher

                self.store.cipher = make_cipher(
                    self.config.storage.encryption_key)
            for name in self.store.table_names():
                self.store.register_cold(self.catalog, name)
            self.catalog.store = self.store
            self._seen_epoch = self.store.epoch()
            from cloudberry_tpu_torch.plan.matview import load_defs

            load_defs(self)
        # per-query pruned store reads as device tensors, keyed (table,
        # version, parts, cols, device) — an LRU under its own lock
        self._store_scan_cache: dict = {}
        self._store_scan_lock = threading.Lock()
        self._sync_lock = threading.Lock()
        # device copies of RAM tables: name -> (table version, columns)
        self._device_tables: dict[str, tuple[int, dict]] = {}
        # distributed placement (n_segments > 1): the host shard layout
        # per (table, nseg) with its version, a counts-only fast path for
        # the planner, and the layout's device copy
        self._shard_cache: dict[str, ShardedTable] = {}
        self._shard_count_cache: dict = {}
        self._device_shards: dict[str, DeviceShards] = {}
        # join-expansion buffers grown by statement retries
        self.growth_events = 0
        # plans owed a verification after a mid-statement replan, even
        # with debug.verify_plans off (_verify_plan)
        self._verify_next_plans = 0
        # the last tiled run's report (exec/tiled.py), None after one-shot
        self.last_tiled_report = None
        # statement history + active registry + the metrics registry, the
        # ONE home of the session's counters (``counters`` is its view)
        from cloudberry_tpu_torch.exec.instrument import StatementLog

        self.stmt_log = StatementLog()
        self.stmt_log.configure_obs(self.config.obs)
        self.counters = self.stmt_log.counters
        self._session_id = id(self) & 0xFFFF
        # query_info_collect_hook analog: callables receiving QueryMetrics
        self.metrics_hooks: list = []
        # admission: the concurrency slot pool, the resource queues and
        # the engine-wide vmem red line (exec/resource.py)
        from cloudberry_tpu_torch.exec.resource import (AdmissionGate,
                                                        QueueManager,
                                                        VmemTracker)

        self._gate = AdmissionGate(self.config.resource.max_concurrency)
        self._queues = QueueManager()
        self._vmem = VmemTracker(self.config.resource.total_mem_bytes)
        self._stmt_ids = itertools.count(1)   # vmem reservation keys
        # the tiled executors' statement-scoped checkpoint store
        # (exec/recovery.py), keyed by the statement-log id
        from cloudberry_tpu_torch.exec.recovery import RecoveryStore

        self._recovery = RecoveryStore(
            self.config.recovery.max_statements,
            self.config.recovery.max_bytes, log=self.stmt_log)
        # COPY ... LOG ERRORS row rejects, per table (the error-log /
        # gp_read_error_log analog, cdbsreh.c)
        self.copy_errors: dict[str, list] = {}
        # open parallel retrieve cursors (the endpoint registry analog,
        # cdbendpoint.c EndpointTokenHash) — name -> ParallelCursor
        self.parallel_cursors: dict[str, object] = {}
        # the open transaction's BEGIN snapshot (None outside one)
        self._txn_snapshot = None
        # the cache scope (sched/sharedcache.py): sessions over one store
        # root share the join-index cache and the buffer pool
        from cloudberry_tpu_torch.sched import sharedcache

        self._cache_scope = sharedcache.scope_for(self)
        # prepared-statement cache: sql text (+ user params) -> entry
        # (_cache_statement); an LRU under its lock, since hits reorder
        # the dict
        self._stmt_cache: dict = {}
        self._stmt_lock = threading.Lock()
        # feedback-driven re-optimization (plan/feedback.py): learned
        # per-(table, key-set) sketches folded from live motion stats.
        # The store is scope-anchored; the VIEW is stamped on the catalog
        # so cost/memo code that only sees the catalog can consult it.
        from cloudberry_tpu_torch.plan import feedback as FB

        fb_store = FB.store_for(self)
        if fb_store is not None:
            self.catalog._feedback = FB.FeedbackView(fb_store, self)
        # admission circuit breaker (lifecycle.py): K consecutive
        # device-loss recoveries trip writes to read-only-degraded; its
        # half-open probe runs over this session's device and slots
        from cloudberry_tpu_torch.lifecycle import CircuitBreaker
        from cloudberry_tpu_torch.parallel.health import probe

        self._breaker = CircuitBreaker(
            self.config.health.breaker_threshold,
            self.config.health.breaker_cooldown_s,
            probe_fn=lambda: probe(self))
        # versioned topology (parallel/topology.py): every statement pins
        # the current TopologyEpoch; expand/shrink/failover make a
        # successor epoch instead of mutating the layout in place. The
        # survivor restriction of a degraded epoch (None: the first nseg
        # slots) and the last epoch this session adopted
        self._live_device_ids = None
        self._topo_epoch_seen = None
        from cloudberry_tpu_torch.parallel.topology import TopologyManager

        self._topology = TopologyManager(self)

    # the generic-plan cache lives in the session's cache scope
    # (sched/sharedcache.py): shared by the sessions over one store root
    @property
    def config(self) -> Config:
        """The session's config. While a statement attempt runs on this
        thread (``_sql_once``), the config it started under: a topology
        cutover or degrade that another thread adopts meanwhile swaps the
        session's config, and an attempt that read its plan under one
        segment count and its shard layouts under another would index a
        segment that is not there, or drop the rows of one that is. The
        attempt finishes on its own layout (placement is derived); the
        next one starts on the new config."""
        local = self.__dict__.get("_attempt_cfg")
        pinned = getattr(local, "value", None) if local is not None \
            else None
        return self._config if pinned is None else pinned

    @config.setter
    def config(self, cfg: Config) -> None:
        self._config = cfg

    @property
    def _generic_cache(self) -> dict:
        return self._cache_scope.generic

    @property
    def _generic_lock(self):
        return self._cache_scope.generic_lock

    def retrieve(self, cursor: str, segment: int,
                 limit: int | None = None, token: str | None = None):
        """Drain rows from one endpoint of a PARALLEL RETRIEVE CURSOR
        (the retrieve-mode connection analog, cdbendpointretrieve.c)."""
        from cloudberry_tpu_torch.exec.endpoint import retrieve as _r

        return _r(self, cursor, segment, limit, token)

    def dir_upload(self, table: str, rel: str, data: bytes) -> str:
        """Put a file into a DIRECTORY TABLE (the gpdirtableload role)."""
        from cloudberry_tpu_torch.storage import dirtable as DT

        return DT.upload(self, table, rel, data)

    def dir_read(self, table: str, rel: str) -> bytes:
        """Read one file's content from a DIRECTORY TABLE."""
        from cloudberry_tpu_torch.storage import dirtable as DT

        return DT.read(self, table, rel)

    def dir_remove(self, table: str, rel: str) -> None:
        from cloudberry_tpu_torch.storage import dirtable as DT

        DT.remove(self, table, rel)

    def sql(self, query: str, _deadline: float | None = None,
            **params: Any):
        """Run one statement: DDL/DML returns its status string, a SELECT
        its ColumnBatch. ``config.statement_timeout_s`` gives it a
        deadline, checked at execution seams (and by a ``Watchdog``). A
        read that fails with a recoverable error is probed, optionally
        degraded and re-dispatched (module docstring).

        ``_deadline`` (monotonic absolute seconds, lifecycle.py): the
        statement's cancellation deadline; ``statement_timeout_s``
        tightens it. The dispatcher and the server pass their per-request
        deadline here so it governs EXECUTION, not just queueing.
        (Underscored so it never shadows a user bind parameter.)"""
        import time as _t

        from cloudberry_tpu_torch import lifecycle
        from cloudberry_tpu_torch.exec.recovery import TileReplan
        from cloudberry_tpu_torch.parallel.health import (
            never_redispatched, recoverable, run_with_retry)
        from cloudberry_tpu_torch.parallel.topology import \
            TopologyRaceError
        from cloudberry_tpu_torch.sql.classify import read_only

        h = self.config.health
        log = self.stmt_log
        log_id = log.begin(query, self._session_id)
        deadline = _deadline
        timeout = self.config.statement_timeout_s
        if timeout:
            t_dl = _t.monotonic() + timeout
            deadline = t_dl if deadline is None else min(deadline, t_dl)
        handle = lifecycle.StatementHandle(log_id, deadline=deadline)
        # statement trace (obs/trace.py): the span tree rides the handle,
        # so every thread serving this statement records against it
        handle.trace = log.start_trace(log_id, query)
        # live progress (obs/progress.py): the tiled executors' tile loops
        # feed it through the same handle channel
        if log.obs_enabled:
            from cloudberry_tpu_torch.obs.progress import Progress

            handle.progress = Progress()
        log.attach(log_id, handle)
        t_begin = _t.monotonic()
        is_read = read_only(query)
        # device-loss recoveries THIS statement needed — the breaker's
        # consecutive-recovery signal; trial: this write is the half-open
        # probe write and owns the breaker's verdict
        recoveries = [0]
        t_first_fail = [0.0]
        trial = False
        # the classifier's last verdict was epoch-motivated: counted in
        # on_retry (a verdict on the FINAL attempt raises instead)
        epoch_retry = [False]

        def on_retry(e, backoff_s=0.0):
            if epoch_retry[0]:
                epoch_retry[0] = False
                log.bump("topo_epoch_retries")
            recoveries[0] += 1
            if not t_first_fail[0]:
                t_first_fail[0] = _t.monotonic()
            if handle.trace is not None:
                handle.trace.attempt = recoveries[0]
            # the activity row shows the attempt count and the planned
            # backoff, and reads 'recovering' (the watchdog still
            # enforces the DEADLINE: recovery is liveness, not license)
            log.bump("recoveries")
            log.set_state(log_id, "recovering")
            log.annotate(log_id, attempts=recoveries[0],
                         backoff_s=round(backoff_s, 4),
                         last_error=type(e).__name__)
            if h.probe_on_error:
                self._recover_mesh(e)
            # the retry re-plans at the CURRENT epoch: one flip buys one
            # re-dispatch
            handle.topology_epoch = self._topology.current.epoch_id

        def epoch_recoverable(e):
            """Device loss as always — PLUS any non-semantic failure of a
            read whose pinned topology epoch was cut over mid-flight: the
            flip between plan and launch can surface as a shape error,
            and re-dispatching at the new epoch IS the recovery."""
            if isinstance(e, TileReplan):
                return False  # the adaptive-replan loop below owns it
            if recoverable(e) or isinstance(e, TopologyRaceError):
                return True
            if isinstance(e, (lifecycle.StatementError,
                              SerializationError)) \
                    or never_redispatched(e):
                return False
            ep = getattr(handle, "topology_epoch", None)
            if ep is None or ep == self._topology.current.epoch_id:
                return False
            epoch_retry[0] = True
            return True

        compiles_before = log.counter("compiles")
        # per-statement generic-plan hits, the compile counter's delta
        # discipline: the statements table aggregates the generic-hit
        # rate per skeleton from them (obs/statements.py)
        generic_before = log.counter("generic_hits")
        head = query.lstrip()[:10].split(None, 1)
        is_txn_control = bool(head) and head[0].lower() in (
            "begin", "commit", "rollback", "abort", "start", "end")
        topo_epoch = None
        try:
            # topology pin: the statement runs to completion against this
            # epoch; pinning also ADOPTS a newer epoch into this session
            # first (a flip it missed, or another session's committed
            # resize over the same store)
            topo_epoch = self._topology.pin(self)
            handle.topology_epoch = topo_epoch.epoch_id
            with lifecycle.statement_scope(handle):
                if not is_read and not is_txn_control:
                    # read-only-degraded admission: an open breaker
                    # refuses writes (retryable) while reads keep flowing.
                    # Transaction control is exempt: it never reaches the
                    # device, and a session must always be able to
                    # ROLLBACK out of an open transaction
                    trial = self._breaker.check_write()
                # mid-statement adaptive replan (exec/tiled.py
                # SkewSentinel): reads only — a write's tiled subplan
                # must never restart after a host-side mutation. The
                # sentinel checks this flag (and its own per-handle
                # replan budget) before raising TileReplan.
                handle.adaptive_ok = is_read
                adaptations = 0
                while True:
                    try:
                        if h.retries <= 0 or not is_read:
                            # DML/DDL/COPY are NOT re-dispatched: a
                            # failure after the host-side mutation would
                            # re-apply the statement
                            out = self._sql_once(query, **params)
                        else:
                            def attempt():
                                # a retried attempt is live again
                                if recoveries[0]:
                                    log.set_state(log_id, "running")
                                return self._sql_once(query, **params)

                            out = run_with_retry(
                                attempt, retries=h.retries,
                                backoff_s=h.backoff_s, on_retry=on_retry,
                                max_backoff_s=h.backoff_max_s,
                                budget_s=h.retry_budget_s,
                                recoverable_fn=epoch_recoverable)
                        break
                    except TileReplan as e:
                        # NOT a failure: the sentinel already folded the
                        # observed sketch and checkpointed the carried
                        # state. Evict the cached statement so the
                        # re-dispatch re-plans against the fresh sketch,
                        # owe the verifier a pass on the new plan, and
                        # re-run under the SAME handle — the new
                        # executable resumes from the checkpoint
                        adaptations += 1
                        if adaptations > self.config.feedback\
                                .max_replans + 1:
                            raise  # belt over the sentinel's budget
                        with self._stmt_lock:
                            self._stmt_cache.pop(
                                self._stmt_cache_key(query, params), None)
                        self._verify_next_plans = max(
                            self._verify_next_plans, 1)
                        log.bump("adaptive_replans")
                        log.set_state(log_id, "replanning")
                        log.annotate(log_id,
                                     adaptive_skew=round(e.ratio, 2),
                                     replan_at_tile=e.tiles_done)
        except BaseException as e:
            # BaseException too: a Ctrl-C mid-statement must not leave a
            # phantom "running" entry in the active registry
            if trial:
                # the half-open trial write failed (for any reason):
                # re-arm the cooldown, never wedge
                self._breaker.trial_failed()
            elif recoveries[0]:
                # recovery was attempted but the statement still failed:
                # a hard outage counts toward the trip threshold too
                self._breaker.record_recovery()
            if isinstance(e, lifecycle.StatementTimeout):
                log.bump("statement_timeouts")
            elif isinstance(e, lifecycle.StatementCancelled):
                log.bump("statement_cancels")
            else:
                from cloudberry_tpu_torch.exec.executor import \
                    DuplicateBuildKeyError

                if isinstance(e, DuplicateBuildKeyError):
                    log.bump("duplicate_build_key_errors")
            log.finish(log_id, "error", error=f"{type(e).__name__}: {e}")
            # flight recorder (obs/flightrec.py): after finish, so the
            # trace is closed and the bundle ships complete spans
            from cloudberry_tpu_torch.obs import flightrec as OF

            OF.maybe_capture(
                self, query, "error", _t.monotonic() - t_begin, handle,
                params=params, error=e, counters={
                    "compiles": log.counter("compiles") - compiles_before,
                    "generic_hits": log.counter("generic_hits")
                    - generic_before,
                    "recoveries": recoveries[0]})
            raise
        finally:
            # statement-scoped checkpoints die with their statement
            self._recovery.discard(log_id)
            if topo_epoch is not None:
                self._topology.unpin(topo_epoch)
        if trial:
            self._breaker.trial_succeeded()
        if recoveries[0]:
            self._breaker.record_recovery()
            # recovery latency: wall clock from the first device-loss
            # failure to the statement completing
            log.bump("recovery_wall_ms",
                     int((_t.monotonic() - t_first_fail[0]) * 1000))
        else:
            self._breaker.record_success()
        is_batch = hasattr(out, "num_rows")
        compiles_d = log.counter("compiles") - compiles_before
        generic_d = log.counter("generic_hits") - generic_before
        log.finish(log_id, "ok" if is_batch else str(out)[:80],
                   rows=out.num_rows() if is_batch else -1,
                   compiles=compiles_d, generic_hits=generic_d)
        from cloudberry_tpu_torch.obs import flightrec as OF

        OF.maybe_capture(
            self, query, "ok", _t.monotonic() - t_begin, handle,
            params=params, result=out if is_batch else None,
            counters={"compiles": compiles_d, "generic_hits": generic_d,
                      "recoveries": recoveries[0]})
        return out

    def _recover_mesh(self, e: Exception) -> None:
        """Between-retry hook: probe the segment slots; when any are
        gone, re-derive the segments over the SURVIVORS (nothing
        promotes: placement is recomputed). A loss may leave a hole
        mid-list, so the survivor indices matter, not just the count.
        The probe result also feeds the topology manager's persistence
        detector (failover-as-shrink), outside degrade_mesh's lock."""
        from cloudberry_tpu_torch.parallel.health import probe

        # in a cluster the probe gathers every process's live slots, so
        # every process degrades to the same survivors and epoch
        r = probe(self)
        if self.config.health.degrade and r.live:
            self.degrade_mesh(len(r.live), r.live)
        self._topology.note_probe(r)

    def degrade_mesh(self, n_devices: int, live_ids=None) -> bool:
        """Shrink the segment count to ``n_devices`` (over the slots
        ``live_ids`` when given) and invalidate every placement and plan
        cache. Derived placement (the jump hash) makes this a pure
        recompute. Versioned: the degrade MINTS a 'degrade' topology
        epoch FIRST, then adopts it, so a statement pinning in the window
        adopts the smaller layout and a statement that raced the swap
        sees the moved epoch and re-dispatches. In a cluster every process
        calls it with the same arguments (the retry hook's gathered probe
        gives them) and mints the same epoch; ``live_ids`` name slots of
        the cluster's pool, and each process re-derives its own range of
        the surviving segments (parallel/mesh.py ``segment_owners``)."""
        cur = self._topology.current
        n = max(1, min(cur.nseg, n_devices))
        ids = None
        if live_ids is not None:
            live = list(live_ids)
            if len(live) > n:
                # more survivors than segments: the first n suffice, and
                # an unchanged prefix keeps caches valid
                live = live[:n]
            if live != list(range(n)):
                ids = live  # a hole mid-list: skip the dead slots
        from cloudberry_tpu_torch.parallel.mesh import slot_layout

        # across processes the survivors must leave every process a
        # contiguous range of segments (raises before any epoch moves)
        slot_layout(self, n, ids)
        ep = self._topology.note_degrade(n, ids)
        if ep is not None:
            self._topology._adopt(self, ep)
            return True
        # the epoch already reflects this loss: adopt the current epoch
        # so the retry re-plans on the survivors
        cur = self._topology.current
        if cur.nseg == n and (cur.device_ids or None) == \
                (tuple(ids) if ids else None):
            return self._topology._adopt(self, cur)
        return False

    @staticmethod
    def _stmt_cache_key(query: str, params: dict) -> str:
        """Statement-cache key: the SQL text PLUS the user-supplied
        ``sql(query, **params)`` arguments — two calls with the same text
        but different params must never share a cached runner."""
        if not params:
            return query
        return query + "\x00" + repr(sorted(params.items()))

    def _sql_once(self, query: str, **params: Any):
        from cloudberry_tpu_torch.parallel import writer

        # the attempt runs on one config (the ``config`` property)
        local = self._attempt_cfg
        outer = getattr(local, "value", None)
        local.value = self._config
        try:
            # a cluster's processes read one snapshot of the store:
            # process 0's, registered on every process and pinned for
            # the attempt
            agreed = self._cluster_snapshot()
            self._sync_store(agreed)
            # a cluster's processes run this attempt on one layout and
            # one snapshot, or none
            self._topology.agree(self)
            # every process runs the attempt in the same order, so its
            # store commits go through the one writer (parallel/writer.py)
            with writer.lockstep():
                if agreed is None:
                    return self._run_statement(query, params)
                self._agreed = agreed
                try:
                    with self.store.snapshot(agreed[1]):
                        return self._run_statement(query, params)
                finally:
                    self._agreed = None
        finally:
            local.value = outer

    def _run_statement(self, query: str, params: dict):
        import time as _t

        from cloudberry_tpu_torch.exec.resource import (ResourceError,
                                                        check_admission)
        from cloudberry_tpu_torch.obs import capacity as OC
        from cloudberry_tpu_torch.obs import metrics as OM
        from cloudberry_tpu_torch.obs import trace as OT
        from cloudberry_tpu_torch.plan.planner import plan_statement
        from cloudberry_tpu_torch.sql.parser import parse_sql
        from cloudberry_tpu_torch.utils.faultinject import fault_point

        self.last_tiled_report = None  # set again by a tiled run
        ckey = self._stmt_cache_key(query, params)
        cached = self._cached_statement(ckey)
        if cached is not None:
            runner, cost, obs_bytes = cached
            self.stmt_log.bump("stmt_cache_hits")
            self.stmt_log.bump("dispatches")
            # capacity plane: the cached device-byte estimate, one
            # histogram sample, no plan walk on the hot path (a tiled
            # runner admits against the whole budget but observes its
            # step estimate)
            OC.observe_stmt_bytes(self.stmt_log, obs_bytes)
            self._dispatch_seams(fault_point)
            t_wait = _t.perf_counter()
            with self._gate, self._admitted(cost):
                self._obs_wait(t_wait)
                return self._obs_launch(runner)
        t0 = _t.perf_counter()
        with OT.span("parse"):
            stmt = parse_sql(query)
        t1 = _t.perf_counter()
        OM.observe_stage(self.stmt_log, "parse", t1 - t0)
        # the config this statement PLANS under: a topology cutover
        # swapping it before execution makes the plan's capacities stale,
        # and the executors below refuse with the retryable
        # TopologyRaceError instead of running (or caching) a plan of
        # another segment layout (_check_topology_race)
        cfg_plan = self.config
        with OT.span("plan"):
            result = plan_statement(stmt, self, params)
        OM.observe_stage(self.stmt_log, "plan", _t.perf_counter() - t1)
        if result.is_ddl:
            return result.ddl_result
        # the verification gate (config.debug.verify_plans): every plan
        # the planner or memo emitted is verified right before it runs —
        # a finding is a refusal, not a silently wrong answer
        self._verify_plan(result.plan, "session")
        # admission control: memory budget check + queue slot + vmem
        # reservation; an over-budget plan falls back to tiled
        # out-of-core execution (exec/tiled.py) first
        try:
            est = check_admission(result.plan, self)
        except ResourceError:
            from cloudberry_tpu_torch.exec.tiled import plan_tiled

            texe = plan_tiled(result.plan, self)
            if texe is None and self.config.planner.enable_memo:
                # the memo's joint order may have put a big relation on a
                # BUILD side (spill-hostile: tiling streams the probe path
                # only). Re-plan greedy — the fact side stays the stream —
                # and tile that; a shallow session clone carries the
                # greedy config so concurrent planners never observe it
                import copy

                clone = copy.copy(self)
                clone._attempt_cfg = threading.local()
                clone.config = self.config.with_overrides(
                    **{"planner.enable_memo": False})
                result2 = plan_statement(stmt, clone, params)
                self._verify_plan(result2.plan, "greedy-replan")
                texe = plan_tiled(result2.plan, clone)
                if texe is not None:
                    # runs report (last_tiled_report) to the real session
                    texe.session = self
            if texe is None:
                raise
            texe.refresh_bufpool_charge()
            OC.record_tiled(self.stmt_log, texe.report)
            self.stmt_log.bump("dispatches")
            self._dispatch_seams(fault_point)
            t_wait = _t.perf_counter()
            with self._gate, self._admitted(
                    self.config.resource.query_mem_bytes):
                self._obs_wait(t_wait)
                return self._run_cached_tiled(ckey, texe, cfg_plan)
        # capacity plane: itemized device-byte estimate of the fresh plan
        OC.record_statement(self.stmt_log, result.plan, self, est=est)
        self.stmt_log.bump("dispatches")
        self._dispatch_seams(fault_point)
        t_wait = _t.perf_counter()
        with self._gate, self._admitted(est.peak_bytes) as sid:
            self._obs_wait(t_wait)
            return self._run_with_growth(ckey, query, result.plan, sid,
                                         cfg_plan)

    @staticmethod
    def _dispatch_seams(fault_point) -> None:
        """The seams every statement crosses before it launches:
        ``dispatch_start`` (not re-dispatched), ``exec_device_lost`` (a
        device loss: re-dispatched through health.recoverable — no slot
        of one card can die alone, and this seam can) and the
        cancel/deadline poll, after them, so an expired or cancelled
        statement never launches."""
        from cloudberry_tpu_torch.lifecycle import check_cancel

        fault_point("dispatch_start")
        fault_point("exec_device_lost")
        check_cancel()

    def _obs_wait(self, t0: float) -> None:
        """Record the admission/queue wait that just ended (span + stage
        histogram) — called immediately after entering the gate."""
        import time as _t

        from cloudberry_tpu_torch.obs import metrics as OM
        from cloudberry_tpu_torch.obs import trace as OT

        dt = _t.perf_counter() - t0
        OT.mark("queue-wait", t0)
        OM.observe_stage(self.stmt_log, "queue_wait", dt)

    def _obs_launch(self, runner):
        """Run a statement runner, recording the launch stage (histogram;
        the span records inside run_executable and the tile loops)."""
        import time as _t

        from cloudberry_tpu_torch.obs import metrics as OM

        t0 = _t.perf_counter()
        out = runner()
        OM.observe_stage(self.stmt_log, "launch", _t.perf_counter() - t0)
        return out

    def _admitted(self, cost: int):
        """Queue slot (bounded active statements, MAX_COST, priority wake
        order) + engine-wide vmem reservation for one statement; yields
        the id growth re-reservations key on."""
        import contextlib

        q = self.catalog.resource_queues.get(
            self.config.resource.queue.lower()) \
            or self.catalog.resource_queues["default"]

        @contextlib.contextmanager
        def _cm():
            with self._queues.slot(q, cost, q.priority):
                sid = next(self._stmt_ids)
                self._vmem.reserve(sid, cost)
                try:
                    yield sid
                finally:
                    self._vmem.release(sid)

        return _cm()

    def read_error_log(self, table: str):
        """Rejected rows recorded by COPY ... LOG ERRORS for ``table``
        (the gp_read_error_log() analog): DataFrame of
        line/errmsg/rawdata. Needs pandas, imported here only."""
        import pandas as pd

        return pd.DataFrame(self.copy_errors.get(table.lower(), []),
                            columns=["line", "errmsg", "rawdata"])

    def _sync_store(self, agreed=None) -> None:
        """Pick up OTHER sessions' committed changes at statement start
        (outside transactions): any table whose store version moved
        re-registers cold; new tables appear, dropped ones vanish. The
        table's device copy (``device_table``) and its store-scan cache
        entries are dropped with the old version — they could never serve
        again, and they hold device memory. Manifests ARE the catalog of
        record, and the materialized-view definitions reload with them.
        ``agreed``: a cluster's snapshot (``_cluster_snapshot``), whose
        versions every table registers at; the ``sync_store`` seam's
        'skip' holds the session on the snapshot it has."""
        if self.store is None or self._txn_snapshot is not None:
            return
        with self._sync_lock:
            from cloudberry_tpu_torch.utils.faultinject import fault_point

            if fault_point("sync_store"):
                return
            if agreed is None:
                # fast path: one epoch read; the per-table walk only runs
                # when SOMETHING changed since this session last looked
                epoch = self.store.epoch()
                if epoch == getattr(self, "_seen_epoch", None):
                    return
                versions = {n: self.store.current_version(n)
                            for n in self.store.table_names()}
            else:
                # a cluster walks every time: a table this process did not
                # write itself (process 0 wrote it alone) re-registers
                epoch, versions = agreed
            self._seen_epoch = epoch
            names = set(versions)
            stale = set()
            for name in list(self.catalog.tables):
                t = self.catalog.tables[name]
                if t.backing is None:
                    continue
                if name not in names:
                    del self.catalog.tables[name]
                    self.catalog.bump_ddl()
                    stale.add(name)
                    continue
                if versions[name] != getattr(t, "_store_version", None):
                    del self.catalog.tables[name]
                    self.store.register_cold(self.catalog, name,
                                             versions[name])
                    stale.add(name)
            for name in sorted(names - set(self.catalog.tables)):
                self.store.register_cold(self.catalog, name, versions[name])
            self._drop_table_caches(stale)
            # matview definitions are store state too (another session may
            # have created/refreshed one)
            from cloudberry_tpu_torch.plan.matview import load_defs

            self.catalog.matviews = {}
            load_defs(self)

    def _cluster_snapshot(self):
        """A store-backed cluster's snapshot for one statement: (store
        epoch, {table: version}) as process 0 reads them, broadcast to
        every process. None in one process, without a store and inside a
        transaction (which reads BEGIN's agreed snapshot)."""
        from cloudberry_tpu_torch.parallel.mesh import (process_count,
                                                        process_index)

        if self.store is None or self._txn_snapshot is not None \
                or process_count() == 1:
            return None
        import torch.distributed as dist

        snap = [None]
        if process_index() == 0:
            snap[0] = (self.store.epoch(),
                       {n: self.store.current_version(n)
                        for n in self.store.table_names()})
        dist.broadcast_object_list(snap, src=0)
        return snap[0]

    def _snapshot_digest(self) -> int:
        """A checksum of the store versions this session's tables are
        registered at (0 without a store): ``TopologyManager.agree``
        holds a cluster's processes to one."""
        if self.store is None:
            return 0
        import zlib

        return zlib.crc32(repr(sorted(
            (n, getattr(t, "_store_version", None))
            for n, t in self.catalog.tables.items()
            if t.backing is not None)).encode())

    def _drop_table_caches(self, names) -> None:
        """Forget the device copies, shard layouts and store-scan cache
        entries of ``names`` (their versions moved)."""
        if not names:
            return
        for name in names:
            self._device_tables.pop(name, None)
            # shard layouts are keyed by name and version, and a table
            # re-registered cold may restart its version count
            for cache in (self._device_shards, self._shard_cache):
                for key in [k for k in cache if k.rsplit("@", 1)[0] == name]:
                    del cache[key]
            for key in [k for k in self._shard_count_cache if k[0] == name]:
                del self._shard_count_cache[key]
        with self._store_scan_lock:
            for key in [k for k in self._store_scan_cache
                        if k[0] in names]:
                del self._store_scan_cache[key]

    # ----------------------------------------------------- transactions
    # Single-session transactions over the in-memory catalog: BEGIN
    # snapshots every table's (immutable-once-set) data dict plus copies of
    # the mutable string dictionaries and the view registries; ROLLBACK
    # restores and bumps versions so statement caches invalidate. The
    # durable-store analog is TableStore's snapshot manifests (atomic
    # CURRENT commit); this is the session-surface counterpart.

    def txn(self, kind: str) -> str:
        from cloudberry_tpu_torch.columnar.dictionary import StringDictionary
        from cloudberry_tpu_torch.plan.binder import BindError

        snap = self._txn_snapshot
        if kind == "begin":
            if snap is not None:
                raise BindError("already in a transaction")
            import copy

            self._txn_snapshot = {
                "tables": {
                    name: (t, t.data,
                           {c: StringDictionary(d.values)
                            for c, d in t.dicts.items()},
                           t.policy, dict(t.validity), t.cold,
                           copy.deepcopy(t.stats))
                    for name, t in self.catalog.tables.items()},
                "views": dict(self.catalog.views),
                "matviews": dict(self.catalog.matviews),
            }
            if self.store is not None:
                # durable writes defer to COMMIT; ROLLBACK never touches
                # disk. The BEGIN snapshot's versions are the OCC base
                # (a cluster's: the statement's agreed snapshot)
                agreed = getattr(self, "_agreed", None)
                self.store.begin_txn(agreed and agreed[1])
                self._txn_base = dict(self.store.pinned)
            return "BEGIN"
        if snap is None:
            raise BindError(f"{kind.upper()}: no transaction in progress")
        if kind == "commit":
            if self.store is not None:
                self._occ_commit(snap)
            self._txn_snapshot = None
            return "COMMIT"
        # rollback: restore RAM state WITHOUT persisting (the store never
        # saw the transaction's writes); cold tables restore to cold —
        # their placeholder arrays must never overwrite stored data
        self._restore_snapshot(snap)
        return "ROLLBACK"

    def _occ_commit(self, snap) -> None:
        """OCC commit (the 2PC-role analog, cdbtm.c:883): first committer
        wins for REWRITES; append-only writes merge onto the concurrent
        snapshot instead of aborting. The store lock makes
        check-then-publish atomic across processes, and since it is the
        only commit-time lock and conflicts abort rather than wait, no
        waits-for cycle can form (the no-deadlock argument that replaces
        the reference's global deadlock detector, gdd/README.md)."""
        from cloudberry_tpu_torch.parallel import writer

        # in a cluster process 0 alone checks and publishes; the others
        # take its outcome, and roll back with it when it fails
        try:
            merged = writer.run(lambda: self._occ_publish(snap)) or []
        except BaseException:
            if writer.follows():
                self._restore_snapshot(snap)
            raise
        if writer.follows():
            self.store.abort_txn()   # nothing of it was written here
        # a merged table's RAM copy is missing the other session's rows —
        # drop it so the next statement reloads the merged snapshot
        for name in merged:
            self.catalog.tables.pop(name, None)
            self.store.register_cold(self.catalog, name)
            self.catalog.bump_ddl()
        self._forget_tables(merged)
        if getattr(self, "_matviews_dirty", False):
            # definitions deferred during the transaction flush only after
            # the data commit succeeded
            from cloudberry_tpu_torch.plan.matview import _persist_defs

            self._matviews_dirty = False
            _persist_defs(self)

    def _occ_publish(self, snap) -> list:
        """The locked check-then-publish of ``_occ_commit``; returns the
        tables whose appends merged onto another session's commit."""
        from cloudberry_tpu_torch import lifecycle
        from cloudberry_tpu_torch.utils.faultinject import fault_point

        with self.store.lock():
            # chaos seam inside the commit critical section: 'sleep'
            # widens the conflict window, 'error' exercises cleanup
            fault_point("occ_commit_window")
            # a statement cancelled while waiting on (or wedged inside)
            # the commit window aborts cleanly: nothing published, lock
            # released, RAM state restored
            try:
                lifecycle.check_cancel()
            except lifecycle.StatementError:
                self._restore_snapshot(snap)
                raise
            base = getattr(self, "_txn_base", {})
            conflicts = self.store.conflicting_tables(base)
            if conflicts:
                self._restore_snapshot(snap)
                raise SerializationError(
                    "could not serialize access: table(s) "
                    f"{', '.join(conflicts)} were modified by another "
                    "session after this transaction began")
            merged = [n for n in list(self.store._txn_dirty)
                      if self.store.txn_append_only(n)
                      and self.store.current_version(n) != base.get(n, 0)]
            self.store.commit_txn(base)
        return merged

    def _restore_snapshot(self, snap) -> None:
        """Abort the store's transaction and put BEGIN's RAM state back."""
        touched = self._txn_changed(snap)
        if self.store is not None:
            self.store.abort_txn()
        self.catalog.tables = {}
        for name, (t, data, dicts, policy, validity, cold, stats) in \
                snap["tables"].items():
            t.policy = policy
            t._loading = True
            try:
                t.set_data(data, dicts, validity=validity)  # bumps version
            finally:
                t._loading = False
            t.cold = cold
            t.stats = stats  # manifest-derived stats survive (cold tables)
            self.catalog.tables[name] = t
        self.catalog.views = snap["views"]
        self.catalog.matviews = snap.get("matviews", {})
        # rolled-back DML may have advanced view contents/tokens — every
        # view is conservatively stale until refreshed or re-maintained
        from cloudberry_tpu_torch.plan.matview import invalidate_all

        invalidate_all(self)
        self._matviews_dirty = False  # deferred defs die with the rollback
        self.catalog.bump_ddl()
        self._txn_snapshot = None
        self._forget_tables(touched)

    def _txn_changed(self, snap) -> set:
        """The tables the open transaction wrote, dropped or created: a
        table dropped and re-created leaves device entries under its name
        that the restored object must never be served. A table it never
        wrote keeps its entries (those of a store-backed one are shared
        with every session over the store)."""
        cur = self.catalog.tables
        changed = set(cur) ^ set(snap["tables"])
        for name, (t, data, *_rest) in snap["tables"].items():
            now = cur.get(name)
            if now is not t or t.data is not data:
                changed.add(name)
        if self.store is not None:
            changed |= set(self.store._txn_dirty) | set(self.store._txn_drops)
        return changed

    def _forget_tables(self, names) -> None:
        """``_drop_table_caches`` plus the cache scope's join indexes and
        buffer-pool chunks of ``names`` (a ROLLBACK or a merged COMMIT):
        the device entries of a table whose contents moved outside the
        store's versioning."""
        names = set(names)
        if not names:
            return
        self._drop_table_caches(names)
        scope = self._cache_scope
        with scope.joinindex_lock:
            for key in [k for k in scope.joinindex if k[0][0] in names]:
                del scope.joinindex[key]
        pool = getattr(scope, "bufferpool", None)
        if pool is not None:
            pool.drop_tables(names)

    def _check_topology_race(self, cfg_plan) -> None:
        """Refuse to run (or cache) a plan whose topology epoch moved
        under it: its capacities no longer match the placement, and the
        runner — or worse, a CACHED one serving later statements — would
        mix shard shapes of two epochs. The epoch-race retry re-plans at
        the new epoch."""
        if cfg_plan is not None and cfg_plan is not self.config:
            from cloudberry_tpu_torch.parallel.topology import \
                TopologyRaceError

            self.stmt_log.bump("topo_plan_races")
            raise TopologyRaceError(
                "topology epoch changed between plan and execute; "
                "the statement re-plans at the new epoch")

    def _run_cached_tiled(self, ckey: str, texe, cfg_plan=None):
        """Cache a tiled executable's runner under the statement's key
        (unless it reads table-function rows), then run it as the
        statement's launch; afterwards the dispatch window's in-flight
        gauge (obs/capacity.py)."""
        from cloudberry_tpu_torch.exec import executor as X
        from cloudberry_tpu_torch.obs import capacity as OC

        self._check_topology_race(cfg_plan)
        names = sorted({s.table_name
                        for s in X.scans_of(texe._whole_plan())})
        if not self._any_external(names):
            report = texe.report
            self._cache_statement(
                ckey, names, texe.run,
                self.config.resource.query_mem_bytes,
                obs_bytes=max(int(report.get("est_step_bytes", 0)),
                              int(report.get("est_finalize_bytes", 0))),
                cfg=cfg_plan)
        out = self._obs_launch(texe.run)
        OC.record_tile_dispatch(self.stmt_log, texe.report)
        return out

    def _any_external(self, names) -> bool:
        """Whether any named table's rows change outside the versioning
        that keys the caches: an external, foreign or directory table
        (re-read from its source at every referencing statement) or a
        table function's transient table (exec/tablefunc.py). A cached
        runner would replay a stale read."""
        tables = self.catalog.tables
        return any(t is not None and (t.sourced
                                      or getattr(t, "_tablefunc", None))
                   for t in map(tables.get, names))

    # ------------------------------------------------- statement cache
    # The prepared-statement / plan-cache analog: a repeated query string
    # reuses its runner as long as every referenced table's data version
    # is unchanged — shapes are static per version, so reuse is exact,
    # never heuristic.

    def _table_versions(self, names) -> tuple:
        out = []
        for n in names:
            t = self.catalog.table(n)
            out.append((n, getattr(t, "_version", 0),
                        getattr(t, "_stats_version", 0)))
        return tuple(out)

    _STMT_CACHE_MAX = 64

    def _cached_statement(self, ckey: str):
        """(runner, admission cost, obs device-byte estimate) from a
        live cache entry, else None — returned together so the caller
        never re-indexes an entry a concurrent thread may have evicted.
        LRU: a hit moves the entry to the dict's end (under the lock —
        hits MUTATE the dict)."""
        with self._stmt_lock:
            entry = self._stmt_cache.pop(ckey, None)
            if entry is not None:
                self._stmt_cache[ckey] = entry  # LRU touch
        if entry is None:
            return None
        from cloudberry_tpu_torch.exec.udf import registry_version
        from cloudberry_tpu_torch.plan.feedback import feedback_gen

        names, versions, cfg, ddlv, runner, cost, obs_bytes, fbgen, \
            hosts = entry
        # ddlv pairs the catalog DDL version with the UDF registry
        # version: re-registering a function must drop plans that baked
        # its OLD results in at bind time. The config IDENTITY check is
        # the config-epoch guard: any with_overrides swap (n_segments,
        # packed wire, ...) replaces the frozen tree wholesale. fbgen is
        # the feedback-store generation the plan was built against: a
        # MATERIAL sketch fold (plan/feedback.py) bumps it, so learned
        # stats reach statements the cache would otherwise pin to their
        # first plan. hosts is the host layout the plan's two-level stamps
        # were derived for: a statement planned flat is never served under
        # a forced host split, nor the reverse.
        stale = (cfg is not self.config
                 or ddlv != (self.catalog.ddl_version, registry_version())
                 or fbgen != feedback_gen(self)
                 or hosts != _host_layout())
        if not stale:
            try:
                stale = self._table_versions(names) != versions
            except KeyError:
                stale = True
        if stale:
            with self._stmt_lock:  # free the cached runner
                self._stmt_cache.pop(ckey, None)
            return None
        return runner, cost, obs_bytes

    def _execute_and_cache(self, ckey: str, query: str, plan,
                           cfg_plan=None):
        """Build the statement's runner — the generic plan's rebind when
        the skeleton has one (sched/paramplan.py), else a fresh
        Executable: one segment's shard under direct dispatch, the
        distributed gang at ``n_segments > 1``, else the one-program
        path — cache it unless the plan opts out or reads table-function
        rows, and run it as the statement's launch."""
        from cloudberry_tpu_torch.exec import executor as X
        from cloudberry_tpu_torch.sched import paramplan

        self._check_topology_race(cfg_plan)
        names = sorted({s.table_name for s in X.scans_of(plan)})
        seg = getattr(plan, "_direct_segment", None)
        prep = None
        if self.config.sched.generic_plans:
            prep = paramplan.lookup_or_build(self, query, plan)
        if prep is not None:
            runner = lambda: prep.run(self)  # noqa: E731
        elif seg is not None:
            exe = X.compile_plan(plan, self)
            runner = lambda: X.run_executable(  # noqa: E731
                exe, X.prepare_inputs(exe, self, segment=seg))
        elif self.config.n_segments > 1:
            from cloudberry_tpu_torch.exec.dist_executor import (
                compile_distributed, execute_distributed)

            fn = compile_distributed(plan, self)
            runner = lambda: execute_distributed(  # noqa: E731
                plan, self, fn)
        else:
            exe = X.compile_plan(plan, self)
            runner = lambda: X.run_executable(  # noqa: E731
                exe, X.prepare_inputs(exe, self))
        if not getattr(plan, "_no_stmt_cache", False) \
                and not self._any_external(names):
            from cloudberry_tpu_torch.exec.resource import \
                estimate_plan_memory

            self._cache_statement(ckey, names, runner,
                                  estimate_plan_memory(plan).peak_bytes,
                                  cfg=cfg_plan)
        X.build_kernels(self)
        try:
            return self._obs_launch(runner)
        except X.ExecError:
            if prep is not None and prep.built:
                # the variant was built over this plan, which the growth
                # loop is about to grow in place: drop it with the failed
                # runner (a hit's variant holds another statement's plan
                # and stays valid for its signature)
                paramplan.forget(self, prep.gp)
            raise

    def _cache_statement(self, ckey: str, names, runner, cost: int = 0,
                         obs_bytes: int | None = None, cfg=None) -> None:
        """``cost`` is the ADMISSION reservation for cache hits;
        ``obs_bytes`` (defaults to cost) is the device-byte estimate the
        capacity plane observes — tiled runners reserve the whole budget
        but measure their step working set. ``cfg`` pins the entry to the
        config the runner's plan was BUILT under: a topology flip between
        plan and cache leaves an entry the identity guard rejects."""
        from cloudberry_tpu_torch.exec.udf import registry_version
        from cloudberry_tpu_torch.plan.feedback import feedback_gen

        entry = (
            names, self._table_versions(names),
            cfg if cfg is not None else self.config,
            (self.catalog.ddl_version, registry_version()),
            runner, cost,
            cost if obs_bytes is None else int(obs_bytes),
            feedback_gen(self), _host_layout())
        with self._stmt_lock:
            self._stmt_cache.pop(ckey, None)  # re-insert at the tail
            while len(self._stmt_cache) >= self._STMT_CACHE_MAX:
                # LRU eviction (hits reorder, so the head really is the
                # least recently used) keeps the cache bounded under
                # literal-inlining workloads
                self._stmt_cache.pop(next(iter(self._stmt_cache)))
            self._stmt_cache[ckey] = entry

    def _run_with_growth(self, ckey: str, query: str, plan,
                         stmt_id: int = 0, cfg_plan=None):
        """Execute; on a detected join-expansion overflow, grow the pair
        buffer (re-checking admission) and retry — adaptive capacity, never
        truncation (exec/executor.py:grow_expansion). Growth that blows the
        per-query budget falls back to tiled execution; growth that would
        cross the ENGINE-WIDE vmem red line terminates this statement (the
        runaway_cleaner.c decision). Six growths at most (4x each), then a
        last run whose error surfaces."""
        from cloudberry_tpu_torch.exec.executor import (ExecError,
                                                        grow_expansion)
        from cloudberry_tpu_torch.exec.resource import (ResourceError,
                                                        RunawayError,
                                                        check_admission)

        for _ in range(6):
            try:
                return self._execute_and_cache(ckey, query, plan,
                                               cfg_plan)
            except ExecError as e:
                with self._stmt_lock:  # drop the failed runner
                    self._stmt_cache.pop(ckey, None)
                if not grow_expansion(plan, str(e), allow_fallback=True):
                    raise
                self.growth_events += 1
                try:
                    est = check_admission(plan, self)  # budget-ok growth…
                    self._vmem.grow(stmt_id, est.peak_bytes)  # …red-zone ok
                except RunawayError:
                    raise  # red-zone termination, never a spill case
                except ResourceError:
                    from cloudberry_tpu_torch.exec.tiled import plan_tiled

                    texe = plan_tiled(plan, self)  # the grown plan spills
                    if texe is None:
                        raise
                    return self._run_cached_tiled(ckey, texe, cfg_plan)
        return self._execute_and_cache(ckey, query, plan, cfg_plan)

    def _verify_plan(self, plan, context: str) -> None:
        """The config.debug.verify_plans gate (plan/verify.py): verify a
        freshly planned statement and raise PlanVerifyError with
        node-path findings instead of running a broken plan. A plan
        re-made after a mid-statement replan, and the first
        ``topology.verify_replans`` plans after a topology adoption, are
        verified even with the gate off (``_verify_next_plans``)."""
        if plan is None:
            return
        owed = self._verify_next_plans
        if not self.config.debug.verify_plans and owed <= 0:
            return
        if owed > 0:
            # approximate decrement: an extra verification under a race
            # costs wall clock, never correctness
            self._verify_next_plans = owed - 1
        from cloudberry_tpu_torch.plan.verify import check_plan

        check_plan(plan, self, context)

    def explain(self, query: str) -> str:
        """The plan text of a statement, without running it."""
        from cloudberry_tpu_torch.plan.planner import plan_statement
        from cloudberry_tpu_torch.sql.parser import parse_sql

        self._sync_store(self._cluster_snapshot())
        result = plan_statement(parse_sql(query), self, {},
                                explain_only=True)
        if result.is_ddl:
            return str(result.ddl_result)
        if self.config.n_segments > 1 \
                and getattr(result.plan, "_direct_segment", None) is None:
            # stamp the verifier's DERIVED distribution on every node so
            # the plan text shows sharding explicitly (``dist:``): the
            # bracketed locus is what the distributor STAMPED, the dist:
            # suffix what the rule table DERIVES. The annotation walk IS a
            # verification, so the gate rides it
            from cloudberry_tpu_torch.plan.verify import (PlanVerifyError,
                                                          annotate_derived)

            findings = annotate_derived(result.plan, self)
            if findings and self.config.debug.verify_plans:
                raise PlanVerifyError(findings, "explain")
        else:
            self._verify_plan(result.plan, "explain")
        return result.plan.explain()

    def explain_analyze(self, query: str) -> str:
        """Execute with instrumentation; returns the annotated plan (the
        EXPLAIN ANALYZE analog, explain_gp.c): per-node row counts, and
        for a tiled statement its per-tile time distribution and
        checkpoint counters.

        Runs THROUGH the statement pipeline (instrument.run_pipeline):
        lifecycle handle + activity entry, dispatch seams, admission gate
        and the executor's own compile entry point, so the counts come
        from the same kernels the ``sql`` path launches."""
        from cloudberry_tpu_torch.exec.instrument import (
            explain_analyze_text, plan_nodes_in_order, run_pipeline)
        from cloudberry_tpu_torch.plan.planner import plan_statement
        from cloudberry_tpu_torch.sql.parser import parse_sql

        self._sync_store(self._cluster_snapshot())
        stmt = parse_sql(query)
        result = plan_statement(stmt, self, {})
        if result.is_ddl:
            return str(result.ddl_result)
        _, metrics, annotations = run_pipeline(result.plan, self, query)
        counts = {id(n): r for n, (_, _, r) in
                  zip(plan_nodes_in_order(result.plan), metrics.node_rows)
                  if r >= 0}
        return explain_analyze_text(result.plan, counts,
                                    metrics.wall_s, metrics.compile_s,
                                    annotations=annotations,
                                    tiled_report=self.last_tiled_report)

    def device_table(self, name: str) -> dict:
        """A table's columns (and ``$nn:<col>`` validity masks) as tensors
        on the session's device, copied once per table version."""
        t = self.catalog.table(name)
        version = getattr(t, "_version", 0)
        hit = self._device_tables.get(name)
        if hit is not None and hit[0] == version:
            return hit[1]
        from cloudberry_tpu_torch.exec.bufferpool import to_device

        t.ensure_loaded()
        version = getattr(t, "_version", 0)
        cols = {c: to_device(v, self.device) for c, v in t.data.items()}
        for c, vm in t.validity.items():
            cols[f"$nn:{c}"] = torch.from_numpy(
                np.asarray(vm, dtype=np.bool_)).to(self.device)
        self._device_tables[name] = (version, cols)
        return cols

    # ------------------------------------------------------- data placement

    def sharded_table(self, name: str) -> ShardedTable:
        """The table's host shard layout at ``n_segments``: rows placed by
        ``Table.shard_assignment`` (stable within a segment), each column
        an (nseg, capacity) array padded with zeros past the shard's
        count; validity masks ride as ``$nn:<col>`` bool columns. A
        replicated table stays whole. Cached per (table, nseg) and
        version, so DML re-shards."""
        t = self.catalog.table(name)
        t.ensure_loaded()  # distributed placement needs whole arrays
        nseg = self.config.n_segments
        key = f"{name}@{nseg}"
        cached = self._shard_cache.get(key)
        version = getattr(t, "_version", t.stats.row_count)
        if cached is not None and cached.version == version:
            return cached
        phys_cols = dict(t.data)
        for cname, vm in t.validity.items():
            phys_cols[f"$nn:{cname}"] = np.asarray(vm, dtype=np.bool_)
        if t.policy.kind == "replicated":
            st = ShardedTable(phys_cols, self.shard_counts(name),
                              max(t.num_rows, 1), True, version)
        else:
            order, counts, starts = t.shard_layout(nseg)
            cap = max(int(counts.max()) if len(counts) else 0, 1)
            cols = {}
            for cname, arr in phys_cols.items():
                buf = np.zeros((nseg, cap), dtype=arr.dtype)
                sorted_arr = arr[order]
                for s in range(nseg):
                    n = counts[s]
                    buf[s, :n] = sorted_arr[starts[s]:starts[s] + n]
                cols[cname] = buf
            st = ShardedTable(cols, counts, cap, False, version)
        self._shard_cache[key] = st
        return st

    def shard_counts(self, name: str) -> np.ndarray:
        """Per-segment row counts WITHOUT materializing the shard arrays
        (the planner's capacities): ``Table.shard_layout``'s, the one
        derivation ``sharded_table`` places rows by, so the two always
        agree."""
        t = self.catalog.table(name)
        t.ensure_loaded()
        nseg = self.config.n_segments
        version = getattr(t, "_version", t.stats.row_count)
        key = (name, nseg)
        hit = self._shard_count_cache.get(key)
        if hit is not None and hit[0] == version:
            return hit[1]
        st = self._shard_cache.get(f"{name}@{nseg}")
        if st is not None and st.version == version:
            counts = st.counts
        elif t.policy.kind == "replicated":
            counts = np.full(nseg, t.num_rows, dtype=np.int64)
        else:
            counts = t.shard_layout(nseg)[1]
        self._shard_count_cache[key] = (version, counts)
        return counts

    def shard_capacity(self, name: str) -> int:
        return max(int(self.shard_counts(name).max()), 1)

    def device_shards(self, name: str) -> DeviceShards:
        """``sharded_table`` on the session's device, uploaded once per
        (table, nseg, version): a partitioned table's columns as (local
        segments, capacity) tensors whose row views are the shards of
        this process's segments (``parallel/mesh.py session_segments``;
        every segment in one process) — the capacity comes from the whole
        table, which every process holds, so every process's blocks have
        the same size; a replicated table's whole columns (its ``$nrows``
        a length-1 count, as in the reference)."""
        from cloudberry_tpu_torch.exec.bufferpool import to_device
        from cloudberry_tpu_torch.parallel.mesh import session_segments

        st = self.sharded_table(name)
        key = f"{name}@{self.config.n_segments}"
        hit = self._device_shards.get(key)
        if hit is not None and hit.version == st.version:
            return hit
        dev = self.device
        lo = 0
        if st.replicated:
            cols = self.device_table(name)
            counts_host = np.full(1, int(st.counts[0]), dtype=np.int64)
        else:
            segs = session_segments(self)
            lo = segs.start
            if len(segs) == self.config.n_segments:
                cols = {c: to_device(v, dev) for c, v in st.columns.items()}
            else:
                cols = {c: to_device(v[segs.start:segs.stop], dev)
                        for c, v in st.columns.items()}
            counts_host = np.asarray(st.counts, dtype=np.int64)
        ds = DeviceShards(cols, torch.from_numpy(counts_host.copy()).to(dev),
                          counts_host, st.capacity, st.replicated,
                          st.version, self.config.n_segments, lo, st)
        self._device_shards[key] = ds
        return ds

