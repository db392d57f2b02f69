"""Online topology changes — epoch-versioned placement, staged rebalance,
failover-as-shrink (the gpexpand + FTS-promotion pair, made online), on one
card.

The topology is engine-wide VERSIONED STATE, as in the JAX package:

- ``TopologyEpoch``: an immutable (epoch_id, nseg, device_ids, reason)
  record. Every statement PINS the current epoch at dispatch
  (``TopologyManager.pin``) and runs to completion against it; an
  expand/shrink creates a SUCCESSOR epoch instead of mutating the layout
  in place.

- rebalance (``TopologyManager.rebalance``): jump-consistent placement
  moves only about |new−old|/max(new,old) of the rows on a resize
  (cdbhash.c:55's minimal-movement promise), and the rebalancer moves
  EXACTLY that delta while statements keep serving on the old epoch.
  In-RAM tables stage the successor epoch's row assignment
  chunk-by-chunk (the ``topo_rebalance_chunk`` seam fires per chunk;
  ``Table.shard_assignment`` serves the stage after cutover);
  store-backed tables also move the delta rows PHYSICALLY — each
  affected micro-partition's moved rows are rewritten into
  destination-tagged delta partitions and delete-vectored out of their
  source file, one OCC-checked manifest commit per chunk, with progress
  journaled to ``_TOPOLOGY.json`` so an interrupted rebalance resumes.

- cutover (``TopologyManager.cutover``): a breaker-guarded atomic flip.
  In-flight statements finish on their pinned epoch (placement is
  DERIVED) or resume through the degraded re-shard path
  (exec/recovery.py re-places checkpoints at any nseg). The flip swaps
  the session config, clears every placement-derived cache, and moves
  the TOPOLOGY EPOCH TOKEN that the shared-cache keys carry
  (sched/sharedcache.py). The first few plans after a flip are verified
  by the plan verification gate regardless of ``debug.verify_plans``
  (``session._verify_next_plans``).

- failover-as-shrink: when probes see PERSISTENT slot loss
  (``topology.promote_after`` consecutive observations of the same
  survivor set), the per-statement degrade (``Session.degrade_mesh``) is
  PROMOTED to a formal shrink epoch; recovery triggers the symmetric
  expand back (``recover_after`` clean probes). Both ride the
  ``topo_promote`` seam.

One card. The JAX package's segments each own a device, its probe counts
devices and ``begin`` refuses an epoch larger than the visible device
count. The port's segments are row views of one card's tensors: its probe
counts segment SLOTS (parallel/health.py), the slot pool is the healthy
epoch's segment count (``healthy_nseg``), and ``begin`` refuses an epoch
past ``mesh.MAX_SLOTS``.

Cross-process: a store-backed cluster persists its current epoch (and any
in-progress rebalance journal) in ``_TOPOLOGY.json`` under the store root;
another session over the root adopts a newer epoch at its next statement
pin (mtime check).
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from cloudberry_tpu_torch.utils.faultinject import fault_point


class TopologyError(RuntimeError):
    """A topology change could not proceed (pending change in flight,
    breaker open, target larger than the slot pool)."""


class TopologyRaceError(RuntimeError):
    """The topology epoch flipped between a statement's PLAN and its
    EXECUTE: the plan's baked capacities no longer match the session's
    placement, and running it would mix shard shapes from two epochs (or
    worse, cache such a runner). Raised instead; the session's epoch-race retry
    re-plans the statement at the new epoch (session.sql
    epoch_recoverable)."""


@dataclass(frozen=True)
class TopologyEpoch:
    """One immutable cluster-shape generation. ``device_ids`` restricts
    the segments to specific slots (a failover shrink may leave a hole
    mid-list); None means the first ``nseg`` slots."""

    epoch_id: int
    nseg: int
    device_ids: Optional[tuple] = None
    reason: str = "initial"      # initial|expand|shrink|failover|recover
    created: float = field(default_factory=time.time)

    def public(self) -> dict:
        return {"epoch": self.epoch_id, "nseg": self.nseg,
                "device_ids": list(self.device_ids)
                if self.device_ids else None,
                "reason": self.reason, "created": self.created}


@dataclass
class RebalanceState:
    """Progress of one epoch transition's data movement. Mutated only by
    the (single) rebalance driver; readers take point-in-time snapshots
    through TopologyManager.snapshot() — fields are scalars/dicts whose
    torn reads can only be momentarily stale, never wrong."""

    target: TopologyEpoch
    old_nseg: int
    total_rows: int = 0          # rows examined (hashed tables)
    moved_rows: int = 0          # rows whose segment changed
    moved_bytes: int = 0         # bytes physically rewritten / restaged
    chunks: int = 0              # rebalance chunks committed
    tables_done: int = 0
    tables_total: int = 0
    done: bool = False
    # store-layer resume journal: table -> [processed partition files]
    done_files: dict = field(default_factory=dict)

    def fraction(self) -> float:
        if self.done:
            return 1.0
        if not self.tables_total:
            return 0.0
        return min(self.tables_done / self.tables_total, 0.995)

    def minimal_bound(self) -> float:
        """The jump-hash minimal-movement bound: the expected moved-row
        fraction for old→new segments is |new−old|/max(new, old)."""
        hi = max(self.old_nseg, self.target.nseg)
        return abs(self.target.nseg - self.old_nseg) / max(hi, 1)

    def public(self) -> dict:
        return {"target_epoch": self.target.epoch_id,
                "target_nseg": self.target.nseg,
                "old_nseg": self.old_nseg,
                "fraction": round(self.fraction(), 4),
                "moved_rows": int(self.moved_rows),
                "total_rows": int(self.total_rows),
                "moved_bytes": int(self.moved_bytes),
                "chunks": int(self.chunks),
                "minimal_bound": round(self.minimal_bound(), 4),
                "done": self.done}


def topology_token(session) -> int:
    """The session's current topology-epoch id — the cache-key component
    every shared-cache-tier entry carries (sched/sharedcache.py). 0 when
    the session predates the subsystem (tests building bare objects)."""
    mgr = getattr(session, "_topology", None)
    if mgr is None:
        return 0
    return mgr.current.epoch_id


class TopologyManager:
    """Engine-wide versioned topology for one session (the JAX package's
    server shares one manager across its connection backends; the port
    has no server yet)."""

    def __init__(self, session):
        self._session = session          # the owning (serving) session
        self._lock = threading.Lock()
        cfg = session.config
        self.current = TopologyEpoch(1, cfg.n_segments,
                                     reason="initial")
        self.pending: Optional[TopologyEpoch] = None
        self.rebalance_state: Optional[RebalanceState] = None
        self.history: list[dict] = [self.current.public()]
        self.flips = 0
        self.promotions = 0
        # statements currently pinned, per epoch id (the cutover drain
        # barrier reads it)
        self._active: dict[int, int] = {}
        # quiesce gate: a planned cutover CLEARS it so new statements
        # wait at pin (bounded) while the in-flight tail drains — under
        # closed-loop load the old epoch's pin count would otherwise
        # never reach zero. Set = open (the steady state).
        self._flip_gate = threading.Event()
        self._flip_gate.set()
        # persistent-loss / recovery streak detectors (failover-as-shrink)
        self._loss_streak = 0
        self._loss_seen: Optional[tuple] = None
        self._recover_streak = 0
        self._pre_failover: Optional[int] = None
        # one derived Config per (epoch, base-config): per-connection
        # backends built from one base object keep SHARING a config
        # object after adoption, so config-identity cache guards keep
        # working across backends post-cutover
        self._epoch_cfgs: dict[tuple, object] = {}
        # store-file sync state (cross-process adoption)
        self._store_mtime = 0.0
        self._store_epoch_seen = 0
        if session.store is not None:
            self._sync_from_store(session.store, adopt=False)

    # ------------------------------------------------------------ pinning

    def pin(self, session) -> TopologyEpoch:
        """Pin the current epoch for one statement at dispatch. Adopts
        the epoch into ``session`` first when the session is behind (a
        backend that missed a flip, or a cross-process change committed
        through the store journal)."""
        if session.store is not None:
            self._sync_from_store(session.store)
        if not self._flip_gate.is_set():
            # a cutover is quiescing: wait for the flip (bounded — the
            # flip itself is bounded by cutover_wait_s) so this
            # statement pins the NEW epoch instead of extending the old
            # epoch's drain tail forever under closed-loop load
            self._flip_gate.wait(
                session.config.topology.cutover_wait_s + 1.0)
        with self._lock:
            ep = self.current
            self._active[ep.epoch_id] = self._active.get(ep.epoch_id,
                                                         0) + 1
        try:
            self._adopt(session, ep)
        except BaseException:
            self.unpin(ep)
            raise
        return ep

    def unpin(self, epoch: TopologyEpoch) -> None:
        with self._lock:
            n = self._active.get(epoch.epoch_id, 0) - 1
            if n > 0:
                self._active[epoch.epoch_id] = n
            else:
                self._active.pop(epoch.epoch_id, None)

    def active_on(self, epoch_id: int) -> int:
        with self._lock:
            return self._active.get(epoch_id, 0)

    def healthy_nseg(self) -> int:
        """The cluster's healthy segment count — the slot pool of the
        port's probe (parallel/health.py): the count before a degrade or
        failover shrank the current epoch, else the current epoch's."""
        with self._lock:
            if self._pre_failover is not None:
                return self._pre_failover
            return self.current.nseg

    def epoch_config(self, session, epoch: TopologyEpoch):
        """The (memoized) Config a session runs under at ``epoch``:
        derived once per (epoch, base config object) so every backend
        sharing a base shares the derived object too."""
        from cloudberry_tpu_torch.sched import sharedcache

        base = session.config
        if base.n_segments == epoch.nseg:
            return base
        key = (epoch.epoch_id, sharedcache.config_uid(base))
        with self._lock:
            cfg = self._epoch_cfgs.get(key)
            if cfg is None:
                cfg = base.with_overrides(n_segments=epoch.nseg)
                self._epoch_cfgs[key] = cfg
                while len(self._epoch_cfgs) > 32:
                    self._epoch_cfgs.pop(next(iter(self._epoch_cfgs)))
            return cfg

    def _adopt(self, session, epoch: TopologyEpoch) -> bool:
        """Bring ``session`` onto ``epoch``: swap the config, install
        the epoch's device restriction, and drop every placement-derived
        cache. Idempotent; sessions already current return fast without
        taking the sync lock."""
        ids = list(epoch.device_ids) if epoch.device_ids else None
        if (getattr(session, "_topo_epoch_seen", None) or 0) \
                > epoch.epoch_id:
            # staleness guard: a delayed adoption racing a newer mint
            # (cascading 8→7→6 losses on two threads) must never swap
            # an OLDER epoch's config over the newer one
            return False
        if getattr(session, "_topo_epoch_seen", None) == epoch.epoch_id \
                and session.config.n_segments == epoch.nseg \
                and getattr(session, "_live_device_ids", None) == ids:
            return False
        cfg = self.epoch_config(session, epoch)
        with session._sync_lock:
            seen = getattr(session, "_topo_epoch_seen", None) or 0
            if seen > epoch.epoch_id:
                # staleness re-check UNDER the lock: the pre-lock check
                # races a concurrent newer adoption (TOCTOU) — an older
                # epoch's config must never overwrite a newer one
                return False
            if seen == epoch.epoch_id \
                    and session.config.n_segments == epoch.nseg:
                return False
            # placement unchanged (a fresh session's first pin, or an
            # epoch formalizing a degrade the session already applied):
            # stamp the epoch WITHOUT invalidating anything — clearing
            # the SHARED cache tier on every new backend would evict
            # every tenant's cached plans for nothing
            if session.config.n_segments == epoch.nseg \
                    and getattr(session, "_live_device_ids", None) == ids:
                session._topo_epoch_seen = epoch.epoch_id
                return False
            if session.config is not cfg:
                session.config = cfg
            session._live_device_ids = ids
            # every placement-derived cache of the port: the host shard
            # layouts and their counts, their device copies, the
            # store-scan cache, the join indexes and the buffer pool of
            # the cache scope (stale-epoch keys could never serve — the
            # epoch token is in every key — but their device bytes are
            # placement-era garbage), the statement cache and the
            # generic plans. The port has no rung cache. Kept on
            # purpose: a table's own last placement
            # (Table.shard_assignment, keyed by version, data and nseg)
            # and the recovery store's shard layout
            # (exec/recovery.py _shard_layout, keyed by nseg) — both
            # re-derive for another segment count by their keys
            session._shard_cache.clear()
            session._shard_count_cache.clear()
            session._device_shards.clear()
            with session._store_scan_lock:
                session._store_scan_cache.clear()
            scope = session._cache_scope
            with scope.joinindex_lock:
                scope.joinindex.clear()
            if scope.bufferpool is not None:
                scope.bufferpool.clear()
            with session._stmt_lock:
                session._stmt_cache.clear()
            with session._generic_lock:
                session._generic_cache.clear()
            # staged rebalance assignments for OTHER segment counts are
            # dead weight now (4 bytes/row per hashed table) — only the
            # stage matching this epoch stays, as the re-hash-skipping
            # cache it was built to be
            for t in session.catalog.tables.values():
                staged = getattr(t, "_topo_assign", None)
                if staged is not None and staged[1] != epoch.nseg:
                    t._topo_assign = None
            # stamped LAST: the pin fast path reads it without the sync
            # lock, and a stamp published before the cache clears could
            # let a racing pin skip adoption while stale entries remain
            session._topo_epoch_seen = epoch.epoch_id
            # post-cutover replan verification: the next few fresh plans
            # run through the verification gate even when the session's
            # debug gate is off — a topology flip is exactly when a stale
            # sharding assumption would produce a silently wrong answer
            session._verify_next_plans = max(
                getattr(session, "_verify_next_plans", 0),
                session.config.topology.verify_replans)
        return True

    # ----------------------------------------------------- change control

    def begin(self, new_nseg: int, reason: Optional[str] = None,
              device_ids=None) -> RebalanceState:
        """Create the successor epoch (state: rebalancing). Statements
        keep pinning the CURRENT epoch until cutover()."""
        from cloudberry_tpu_torch.parallel.mesh import MAX_SLOTS

        new_nseg = int(new_nseg)
        if new_nseg < 1:
            raise TopologyError(f"invalid segment count {new_nseg}")
        # the reference refuses past its visible device count; one card
        # hosts at most MAX_SLOTS segment slots (parallel/mesh.py)
        if device_ids is None and new_nseg > MAX_SLOTS:
            raise TopologyError(
                f"cannot expand to {new_nseg} segments: one card hosts at "
                f"most {MAX_SLOTS} segment slots")
        with self._lock:
            if self.pending is not None:
                raise TopologyError(
                    f"topology change to {self.pending.nseg} segments "
                    "already in flight — cut it over or abandon() first")
            old = self.current
            if new_nseg == old.nseg and device_ids is None:
                raise TopologyError(
                    f"cluster already at {new_nseg} segments")
            if reason is None:
                reason = "expand" if new_nseg > old.nseg else "shrink"
            ep = TopologyEpoch(
                self._next_epoch_id(), new_nseg,
                tuple(device_ids) if device_ids else None, reason)
            self.pending = ep
            state = RebalanceState(ep, old.nseg)
            self.rebalance_state = state
        self._restore_journal(state)
        return state

    def abandon(self) -> None:
        """Drop an un-cutover pending epoch (operator bail-out). Already
        moved store rows stay where they are — placement is derived, so
        a partially rebalanced table is merely partially pre-aligned."""
        with self._lock:
            self.pending = None
            self.rebalance_state = None
        self._journal(None)

    def _next_epoch_id(self) -> int:
        # store-backed clusters take max(local, journal) so independent
        # processes never mint the same epoch id (call under self._lock)
        nxt = self.current.epoch_id + 1
        if self.pending is not None:
            # a degrade/failover minted while a planned resize is in
            # flight must not reuse the pending epoch's id — duplicate
            # tokens would let a stale-nseg program match post-cutover
            nxt = max(nxt, self.pending.epoch_id + 1)
        store = self._session.store
        if store is not None:
            rec = _read_topology(store)
            if rec and rec.get("current"):
                nxt = max(nxt, int(rec["current"].get("epoch", 0)) + 1)
        return nxt

    # --------------------------------------------------------- rebalance

    def rebalance(self, chunk_rows: Optional[int] = None,
                  throttle_s: Optional[float] = None,
                  progress=None) -> RebalanceState:
        """Move the minimal micro-partition delta for the pending epoch.
        Safe to call again after an interruption — the store journal (and
        idempotent RAM staging) resumes where the last run stopped."""
        state = self.rebalance_state
        if state is None:
            raise TopologyError("no topology change in flight")
        tcfg = self._session.config.topology
        chunk_rows = chunk_rows or tcfg.rebalance_chunk_rows
        throttle_s = tcfg.throttle_s if throttle_s is None else throttle_s
        session = self._session
        session._sync_store()
        tables = [t for t in session.catalog.tables.values()
                  if t.policy.kind == "hashed"]
        state.tables_total = len(tables)
        state.tables_done = 0
        for t in tables:
            if session.store is not None \
                    and getattr(t, "backing", None) is not None:
                self._rebalance_store_table(t.name, state, chunk_rows,
                                            throttle_s)
                # the moved snapshot re-registers cold at the next sync;
                # staged RAM assignments would be stale by construction
            else:
                self._rebalance_ram_table(t, state, chunk_rows,
                                          throttle_s)
            state.tables_done += 1
            self._journal(state)
            if progress is not None:
                progress(state)
        state.done = True
        self._journal(state)
        return state

    def _chunk_seam(self, state: RebalanceState,
                    throttle_s: float) -> None:
        fault_point("topo_rebalance_chunk")
        state.chunks += 1
        self._bump("topo_rebalance_chunks")
        if throttle_s > 0:
            time.sleep(throttle_s)

    def _rebalance_ram_table(self, t, state: RebalanceState,
                             chunk_rows: int, throttle_s: float) -> None:
        """Stage the successor epoch's row assignment for one in-RAM
        table, chunked over rows (the hash is the whole cost). The
        staged assignment rides the Table (catalog.shard_assignment's
        fast path) so cutover's first shard layout skips the re-hash."""
        from cloudberry_tpu_torch.utils import hashing

        t.ensure_loaded()
        n = t.num_rows
        new_nseg, old_nseg = state.target.nseg, state.old_nseg
        version = getattr(t, "_version", 0)
        staged = getattr(t, "_topo_assign", None)
        if staged is not None and staged[0] == version \
                and staged[1] == new_nseg:
            return  # already staged by an interrupted earlier run
        new_assign = np.zeros(n, dtype=np.int32)
        cols = [np.asarray(t.data[k]) for k in t.policy.keys]
        moved = 0
        nbytes_row = sum(a.dtype.itemsize for a in t.data.values()) or 1
        for lo in range(0, max(n, 1), max(chunk_rows, 1)):
            hi = min(lo + chunk_rows, n)
            if hi <= lo:
                break
            h = hashing.hash_columns_np([c[lo:hi] for c in cols])
            a_old = hashing.jump_consistent_hash_np(h, old_nseg)
            a_new = hashing.jump_consistent_hash_np(h, new_nseg)
            new_assign[lo:hi] = a_new
            moved += int((a_old != a_new).sum())
            self._chunk_seam(state, throttle_s)
        t._topo_assign = (version, new_nseg, new_assign)
        state.total_rows += n
        state.moved_rows += moved
        state.moved_bytes += moved * nbytes_row
        self._bump("topo_moved_rows", moved)
        self._bump("topo_moved_bytes", moved * nbytes_row)

    def _rebalance_store_table(self, name: str, state: RebalanceState,
                               chunk_rows: int,
                               throttle_s: float) -> None:
        """Physically move one stored table's delta rows: per source
        micro-partition (the chunk unit), rows whose jump-hash segment
        changes are rewritten into destination-tagged delta partitions
        and delete-vectored out of the source — ONE atomic, OCC-checked
        manifest commit per chunk. Partitions already tagged for the
        target epoch, and files in the resume journal, are skipped."""
        store = self._session.store
        done = set(state.done_files.get(name, ()))
        attempts = 0
        while True:
            man = store.read_manifest(name)
            if man["schema"] is None:
                return
            pol = man.get("policy")
            if not pol or pol.get("kind") != "hashed":
                return
            todo = [p for p in man["partitions"]
                    if p["file"] not in done
                    and p.get("seg_nseg") != state.target.nseg]
            if not todo:
                break
            part = todo[0]
            ok, moved, mbytes, nrows = _move_partition_delta(
                store, name, man, part, tuple(pol["keys"]),
                state.old_nseg, state.target.nseg)
            if not ok:
                # OCC conflict: another session committed between our
                # manifest read and the locked commit — re-read and
                # retry (bounded; the conflicting commit made progress,
                # so livelock needs an adversarial writer)
                attempts += 1
                if attempts > 20:
                    raise TopologyError(
                        f"rebalance of {name!r} kept losing the OCC "
                        "race; aborting chunk loop")
                continue
            attempts = 0
            done.add(part["file"])
            state.done_files[name] = sorted(done)
            state.total_rows += nrows
            state.moved_rows += moved
            state.moved_bytes += mbytes
            self._bump("topo_moved_rows", moved)
            self._bump("topo_moved_bytes", mbytes)
            self._chunk_seam(state, throttle_s)
            self._journal(state)

    # ----------------------------------------------------------- cutover

    def cutover(self, wait_s: Optional[float] = None) -> dict:
        """The atomic flip to the pending epoch. Breaker-guarded: a
        planned resize refuses while the engine is read-only-degraded
        (resizing a flapping cluster compounds the outage) — failover
        promotion bypasses the guard, it IS the outage response. Waits
        up to ``wait_s`` for statements pinned to the old epoch to
        finish; stragglers keep running on their pinned epoch (derived
        placement keeps them correct) or resume through the degraded
        re-shard path if the mesh actually changed under them."""
        with self._lock:
            pending = self.pending
        if pending is None:
            raise TopologyError("no topology change in flight")
        breaker = getattr(self._session, "_breaker", None)
        if breaker is not None and pending.reason not in ("failover",) \
                and getattr(breaker, "state", "closed") == "open":
            raise TopologyError(
                "circuit breaker open (engine read-only-degraded): "
                "refusing planned cutover while the mesh is flapping")
        fault_point("topo_cutover")
        tcfg = self._session.config.topology
        wait_s = tcfg.cutover_wait_s if wait_s is None else wait_s
        t0 = time.monotonic()
        old_id = self.current.epoch_id
        deadline = t0 + max(wait_s, 0.0)
        if wait_s > 0:
            self._flip_gate.clear()  # quiesce: new pins wait on the flip
        try:
            while self.active_on(old_id) > 0 \
                    and time.monotonic() < deadline:
                time.sleep(0.002)
            stragglers = self.active_on(old_id)
            with self._lock:
                if self.pending is not pending:
                    raise TopologyError(
                        "pending epoch changed under cutover")
                if self.current.epoch_id >= pending.epoch_id:
                    # a degrade/failover minted during the drain window
                    # moved the epoch line past the pending id: re-mint
                    # so the flip NEVER moves the epoch id backward —
                    # adoption's staleness guard would (correctly)
                    # refuse a regressed epoch and strand the session
                    pending = TopologyEpoch(
                        self.current.epoch_id + 1, pending.nseg,
                        pending.device_ids, pending.reason,
                        pending.created)
                    if self.rebalance_state is not None:
                        self.rebalance_state.target = pending
                self.current = pending
                self.pending = None
                state = self.rebalance_state
                self.rebalance_state = None
                self.flips += 1
                self.history.append(pending.public())
                del self.history[:-16]
                if pending.reason in ("expand", "shrink", "recover"):
                    # a planned resize (or completed recovery) is the
                    # new HEALTHY baseline: stale failover state must
                    # not later "recover" the cluster to a size the
                    # operator already resized away from
                    self._pre_failover = None
                    self._loss_streak = 0
                    self._loss_seen = None
                    self._recover_streak = 0
        finally:
            self._flip_gate.set()
        self._persist_current()
        self._adopt(self._session, pending)
        ms = (time.monotonic() - t0) * 1000.0
        self._bump("epoch_flips")
        self._bump("topo_cutover_ms", int(ms))
        out = {"epoch": pending.epoch_id, "nseg": pending.nseg,
               "reason": pending.reason, "cutover_ms": round(ms, 2),
               "stragglers": stragglers}
        if state is not None:
            out["rebalance"] = state.public()
        return out

    def online_resize(self, new_nseg: int, chunk_rows=None,
                      throttle_s=None, wait_s=None,
                      progress=None) -> dict:
        """begin → rebalance → cutover in one call. Returns the cutover record with rebalance totals."""
        state = self.begin(new_nseg)
        self.rebalance(chunk_rows=chunk_rows, throttle_s=throttle_s,
                       progress=progress)
        out = self.cutover(wait_s=wait_s)
        out.setdefault("rebalance", state.public())
        return out

    # ------------------------------------------- failover / recovery path

    def note_degrade(self, n: int, live_ids) -> Optional[TopologyEpoch]:
        """A per-statement degrade (session.degrade_mesh) just changed
        the mesh: mint a 'degrade' epoch so the change is VERSIONED.
        Every placement swap must move the epoch token — a statement
        planning while the swap lands builds a mixed-shape plan, and
        the epoch-race retry (session.sql epoch_recoverable) can only
        classify the resulting error if the epoch actually moved.
        Called OUTSIDE degrade_mesh's sync lock."""
        ids = tuple(live_ids) if live_ids else None
        with self._lock:
            cur = self.current
            if cur.nseg == n and cur.device_ids == ids:
                return None
            if self._pre_failover is None:
                # the healthy size the recovery expand returns to —
                # captured at the FIRST degrade, before churn shrinks
                # current.nseg
                self._pre_failover = cur.nseg
            ep = TopologyEpoch(self._next_epoch_id(), n, ids, "degrade")
            self.current = ep
            self.flips += 1
            self.history.append(ep.public())
            del self.history[:-16]
        self._bump("epoch_flips")
        return ep

    def note_probe(self, r) -> Optional[dict]:
        """Consume one health-probe result (the FTS state-machine input,
        parallel/health.py). Persistent loss of the SAME survivor set
        promotes the per-statement degrade to a formal failover-shrink
        epoch; a persistent return to health triggers the symmetric
        online expand back to the pre-failover segment count."""
        live = list(getattr(r, "live", None) or [])
        n_live = len(live) if live else int(getattr(r, "n_devices", 0))
        cur = self.current
        tcfg = self._session.config.topology
        with self._lock:
            healthy = self._pre_failover \
                if self._pre_failover is not None else cur.nseg
        # fewer answering devices than the HEALTHY segment count IS a
        # loss observation, whatever the ok flag says: a clean probe of
        # the 7 survivors reports ok=True — the hole is the signal (and
        # degrade epochs already shrank cur.nseg, so compare against
        # the pre-degrade size)
        if n_live and n_live < healthy:
            key = (n_live, tuple(live))
            with self._lock:
                if self._loss_seen == key:
                    self._loss_streak += 1
                else:
                    self._loss_seen = key
                    self._loss_streak = 1
                self._recover_streak = 0
                streak = self._loss_streak
            already = cur.reason == "failover" and cur.nseg == n_live
            if streak >= max(tcfg.promote_after, 1) \
                    and self.pending is None and not already:
                # not-already-formalized covers the DEEPER second loss:
                # an 8→7 failover followed by another dead device must
                # promote again to 6, not sit behind the first epoch
                return self._promote_shrink(n_live, live)
            return None
        if getattr(r, "ok", False):
            with self._lock:
                self._loss_seen = None
                self._loss_streak = 0
                want = self._pre_failover
                if want is None \
                        or cur.reason not in ("failover", "degrade"):
                    self._recover_streak = 0
                    return None
                if n_live < want:
                    self._recover_streak = 0
                    return None
                self._recover_streak += 1
                streak = self._recover_streak
            breaker = getattr(self._session, "_breaker", None)
            if breaker is not None \
                    and getattr(breaker, "state", "closed") == "open":
                # the engine is read-only-degraded: expanding back into
                # a flap is premature — the streak stays, so the next
                # clean probe after the breaker closes retries
                return None
            if tcfg.auto_recover and streak >= max(tcfg.recover_after, 1) \
                    and self.pending is None:
                return self._promote_recover(min(want, n_live))
        return None

    def _promote_shrink(self, n_live: int, live: list) -> Optional[dict]:
        if fault_point("topo_promote"):
            return None
        with self._lock:
            if self.pending is not None:
                return None
            cur = self.current
            if self._pre_failover is None:
                self._pre_failover = cur.nseg
            ids = tuple(live[:n_live]) \
                if live and list(live[:n_live]) != list(range(n_live)) \
                else None
            self.pending = TopologyEpoch(self._next_epoch_id(), n_live,
                                         ids, "failover")
            self.rebalance_state = RebalanceState(self.pending, cur.nseg)
            self.rebalance_state.done = True  # flip first, realign later
            self._loss_streak = 0
        # the devices are GONE: flip without a drain wait — in-flight
        # statements on the old epoch are exactly the ones mid-recovery,
        # and the degraded re-shard resume (exec/recovery.py) places them on
        # the survivors
        return self._promote_cutover()

    def _promote_recover(self, n: int) -> Optional[dict]:
        if fault_point("topo_promote"):
            return None
        with self._lock:
            if self.pending is not None:
                return None
            cur = self.current
            self.pending = TopologyEpoch(self._next_epoch_id(), n,
                                         None, "recover")
            self.rebalance_state = RebalanceState(self.pending, cur.nseg)
            self.rebalance_state.done = True  # lazy re-derive on adopt
        return self._promote_cutover()

    def _promote_cutover(self) -> Optional[dict]:
        """Flip a promotion epoch, never letting a refusal escape into
        the probe path (a TopologyError would kill a HealthMonitor's
        probe thread, or replace the device-loss error an in-flight
        retry is classifying). Promotions count only on success."""
        try:
            out = self.cutover(wait_s=0.0)
        except TopologyError:
            self.abandon()
            return None
        with self._lock:
            self.promotions += 1
        self._bump("topo_promotions")
        return out

    def probe_and_heal(self) -> Optional[dict]:
        """One explicit probe→state-machine round (what a HealthMonitor
        interval does) over the manager's session."""
        from cloudberry_tpu_torch.parallel.health import probe

        return self.note_probe(probe(self._session))

    # ------------------------------------------------------- persistence

    def _sync_from_store(self, store, adopt: bool = True) -> None:
        """Adopt a newer CURRENT epoch committed by another process
        (an online resize from another session over the store root). Cheap: one
        mtime stat per call, full read only on change."""
        path = os.path.join(store.root, "_TOPOLOGY.json")
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            return
        with self._lock:
            if mtime == self._store_mtime:
                return
            self._store_mtime = mtime
        rec = _read_topology(store)
        cur = (rec or {}).get("current")
        if not cur:
            return
        with self._lock:
            fe = int(cur.get("epoch", 0))
            # the FILE epoch line is tracked separately from the local
            # one: device-local epochs (degrade/failover/recover) are
            # never persisted, so the local counter can outrun the
            # store's without hiding a later planned change
            if fe <= self._store_epoch_seen:
                return
            self._store_epoch_seen = fe
            if fe == self.current.epoch_id \
                    and int(cur["nseg"]) == self.current.nseg:
                return  # this manager's own persisted flip
            ids = cur.get("device_ids")
            self.current = TopologyEpoch(
                max(fe, self.current.epoch_id + 1), int(cur["nseg"]),
                tuple(ids) if ids else None,
                str(cur.get("reason", "expand")),
                float(cur.get("created", time.time())))
            self.flips += 1
            self.history.append(self.current.public())
            del self.history[:-16]
        self._bump("epoch_flips")
        if adopt:
            self._adopt(self._session, self.current)

    def _persist_current(self) -> None:
        store = self._session.store
        if store is None:
            return
        if self.current.reason in ("degrade", "failover", "recover"):
            # device-local epochs never persist: this PROCESS lost (or
            # regained) devices — another process over the same store
            # has its own device pool and must not adopt the shrink
            return
        with store.lock():
            rec = _read_topology(store) or {}
            old = rec.get("current") or {}
            if int(old.get("epoch", 0)) < self.current.epoch_id:
                rec["current"] = self.current.public()
            rec["pending"] = None
            _write_topology(store, rec)
        try:
            mtime = os.path.getmtime(
                os.path.join(store.root, "_TOPOLOGY.json"))
        except OSError:
            return
        with self._lock:
            self._store_mtime = mtime
            self._store_epoch_seen = max(self._store_epoch_seen,
                                         self.current.epoch_id)

    def _journal(self, state: Optional[RebalanceState]) -> None:
        """Persist the in-flight rebalance (resume journal). No-op for
        storeless sessions — RAM staging is idempotent anyway. The
        read-modify-write runs under the store lock: an unlocked update
        racing _persist_current (this process or another) could
        re-publish a stale 'current' epoch line over a committed flip."""
        store = self._session.store
        if store is None:
            return
        with store.lock():
            self._journal_locked(store, state)

    def _journal_locked(self, store, state) -> None:
        rec = _read_topology(store) or {}
        rec.setdefault("current", self.current.public())
        if state is None:
            rec["pending"] = None
        else:
            rec["pending"] = {
                "epoch": state.target.epoch_id,
                "nseg": state.target.nseg,
                "reason": state.target.reason,
                "old_nseg": state.old_nseg,
                "moved_rows": int(state.moved_rows),
                "moved_bytes": int(state.moved_bytes),
                "total_rows": int(state.total_rows),
                "chunks": int(state.chunks),
                "done_files": {k: list(v)
                               for k, v in state.done_files.items()},
                "done": state.done,
            }
        _write_topology(store, rec)

    def _restore_journal(self, state: RebalanceState) -> None:
        store = self._session.store
        if store is None:
            return
        rec = _read_topology(store) or {}
        pend = rec.get("pending")
        if not pend or int(pend.get("nseg", -1)) != state.target.nseg \
                or int(pend.get("old_nseg", -1)) != state.old_nseg:
            self._journal(state)
            return
        # resume: a prior run's movement is already on disk — keep its
        # totals and skip its processed files
        state.moved_rows = int(pend.get("moved_rows", 0))
        state.moved_bytes = int(pend.get("moved_bytes", 0))
        state.total_rows = int(pend.get("total_rows", 0))
        state.chunks = int(pend.get("chunks", 0))
        state.done_files = {k: list(v) for k, v in
                            (pend.get("done_files") or {}).items()}

    # ---------------------------------------------------- observability

    def _bump(self, name: str, k: int = 1) -> None:
        log = getattr(self._session, "stmt_log", None)
        if log is not None:
            log.bump(name, k)

    def snapshot(self) -> dict:
        with self._lock:
            cur = self.current
            pend = self.pending
            state = self.rebalance_state
            out = {
                "epoch": cur.epoch_id,
                "nseg": cur.nseg,
                "reason": cur.reason,
                "device_ids": list(cur.device_ids)
                if cur.device_ids else None,
                "pending": pend.public() if pend is not None else None,
                "rebalance": state.public() if state is not None else None,
                "flips": self.flips,
                "promotions": self.promotions,
                "active_statements": dict(self._active),
                "history": list(self.history[-8:]),
            }
        return out


# ------------------------------------------------------ store data mover


def _move_partition_delta(store, name: str, man: dict, part: dict,
                          keys: tuple, old_nseg: int, new_nseg: int):
    """Move one source partition's delta rows into destination-tagged
    partitions, committed atomically with the source's delete-vector
    extension. Returns (committed, moved_rows, moved_bytes, live_rows);
    committed=False signals an OCC conflict (caller re-reads and
    retries). Rows that keep their segment are NOT touched — the
    jump-hash minimal-movement contract, measured not assumed."""
    from cloudberry_tpu_torch.columnar.dictionary import StringDictionary
    from cloudberry_tpu_torch.storage import micropartition as mp
    from cloudberry_tpu_torch.types import BOOL, Field as TField, Schema
    from cloudberry_tpu_torch.utils import hashing

    tdir = os.path.join(store.root, name)
    path = os.path.join(tdir, part["file"])
    cols = mp.read_columns(path, cipher=store.cipher,
                           verify=getattr(store, "verify_checksums", True))
    n_file = part["num_rows"]
    live = np.ones(n_file, dtype=bool)
    if part["deleted"]:
        live[np.asarray(part["deleted"], dtype=np.int64)] = False
    h = hashing.hash_columns_np([np.asarray(cols[k]) for k in keys])
    a_old = hashing.jump_consistent_hash_np(h, old_nseg)
    a_new = hashing.jump_consistent_hash_np(h, new_nseg)
    moved_mask = live & (a_old != a_new)
    moved_idx = np.flatnonzero(moved_mask)
    n_live = int(live.sum())
    if not len(moved_idx):
        return True, 0, 0, n_live
    # physical schema of the file's columns (data fields from the
    # manifest schema, "$nn:" validity companions as BOOL)
    fields = {f.name: f for f in
              (mp._field_from_json(j) for j in man["schema"])}
    phys_fields = []
    for cname in cols:
        if cname in fields:
            phys_fields.append(fields[cname])
        elif cname.startswith("$nn:"):
            phys_fields.append(TField(cname, BOOL))
    phys_schema = Schema(tuple(phys_fields))
    dicts = {k: StringDictionary(v)
             for k, v in man.get("dicts", {}).items()}
    import uuid as _uuid

    new_entries = []
    moved_bytes = 0
    for dest in np.unique(a_new[moved_idx]):
        idx = moved_idx[a_new[moved_idx] == dest]
        chunk = {k: np.ascontiguousarray(v[idx])
                 for k, v in cols.items()}
        moved_bytes += sum(int(a.nbytes) for a in chunk.values())
        fname = f"part-{_uuid.uuid4().hex}.cbmp"
        footer = mp.write_micropartition(
            os.path.join(tdir, fname), chunk, phys_schema, dicts,
            cipher=store.cipher)
        stats = {c["name"]: [c["min"], c["max"]]
                 for c in footer["columns"] if "min" in c}
        entry = {"file": fname, "num_rows": int(len(idx)),
                 "stats": stats, "deleted": [],
                 "seg": int(dest), "seg_nseg": int(new_nseg)}
        if part.get("pkey") is not None:
            entry["pkey"] = part["pkey"]
        new_entries.append(entry)
    with store.lock():
        if store.current_version(name) != man["version"]:
            # OCC conflict: a concurrent commit owns the snapshot now —
            # drop our delta files, re-read, retry
            for e in new_entries:
                try:
                    os.unlink(os.path.join(tdir, e["file"]))
                except OSError:
                    pass
            return False, 0, 0, n_live
        for p in man["partitions"]:
            if p["file"] == part["file"]:
                dead = set(p["deleted"]) | set(moved_idx.tolist())
                p["deleted"] = sorted(int(i) for i in dead)
                break
        man["partitions"] = man["partitions"] + new_entries
        store._commit(name, man)
    return True, int(len(moved_idx)), int(moved_bytes), n_live


# --------------------------------------------------- store journal io


def _read_topology(store) -> Optional[dict]:
    try:
        with open(os.path.join(store.root, "_TOPOLOGY.json")) as f:
            return json.load(f)
    except (FileNotFoundError, ValueError):
        return None


def _write_topology(store, rec: dict) -> None:
    # its own seam on top of io_atomic_json: the torture matrix kills at
    # the topology record specifically (mid-expand/cutover crash)
    fault_point("io_topology_write")
    store._atomic_json(os.path.join(store.root, "_TOPOLOGY.json"), rec)
