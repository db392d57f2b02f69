"""Process-wide shared cache tier — one invalidation scope per store root.

The JAX package promotes three per-session caches (generic plans,
capacity-rung executables, join indexes) to an engine-wide tier, plus the
HBM buffer pool and the feedback store. This port carries the tier's
scope machinery for generic plans (sched/paramplan.py), the join-index
cache (exec/joinindex.py), the device buffer pool (exec/bufferpool.py)
and the learned-stats store (plan/feedback.py). It has no rung cache:
the reference caches a compiled program per capacity rung, while the
port's distributed runner lowers its plan at every run, so there is
nothing to compile ahead and the statement cache keeps the runner.

- sessions over the same durable store root share ONE scope while
  ``sched.shared_cache`` is on (the default);
- every other session gets a private scope.

The invalidation contract is the signature discipline, not a protocol:

- every shared key embeds content-stable TABLE VERSION tokens
  (``table_key``): a store-backed table outside a transaction is pinned
  by its store version (any commit bumps it); anything else — in-RAM
  tables, mid-transaction state — falls back to a process-unique table
  uid + local version, making those entries private-by-construction even
  inside a shared scope;
- the config OBJECT IDENTITY is the config epoch (``config_uid``);
- the DEVICE is part of every key (``device_token``). The JAX package has
  one default device per process; the port can hold a CPU session and a
  CUDA session over the same store root in one process, and an entry
  holds tensors on the device that built it — a CPU session must never
  be handed CUDA tensors, or the other way round. A generic plan matches
  on it too (``GenericPlan.matches``): its executable lowers on the
  device of the session that built it;
- the UDF registry version stays in every plan epoch (``plan_epoch``):
  process-wide state baked into plans at bind time.

- the TOPOLOGY EPOCH is part of every key (``topology_token``, the
  session's topology manager's epoch id, parallel/topology.py): a plan,
  join index or pooled tile made under an earlier segment layout can
  never serve after a cutover, even when every other component aliases.
"""

from __future__ import annotations

import itertools
import threading
import weakref


class CacheScope:
    """One invalidation domain's caches. ``kind`` is 'store' (shared by
    every session over the same storage root) or 'session' (private)."""

    def __init__(self, kind: str, token):
        self.kind = kind
        self.token = token
        # generic-plan cache: skeleton -> [GenericPlan, ...] (paramplan)
        self.generic: dict = {}
        self.generic_lock = threading.Lock()
        # join indexes (exec/joinindex.py)
        self.joinindex: dict = {}
        self.joinindex_lock = threading.Lock()
        # device-resident scan buffer pool (exec/bufferpool.py), created
        # lazily by bufferpool.pool_for — it owns its own leaf lock and
        # byte budget; anchored here so sessions over one store root
        # share residency
        self.bufferpool = None
        # learned-stats store (plan/feedback.py), created lazily by
        # feedback.store_for — sketches learned by one session serve every
        # session over the same store root
        self.feedback = None

    def clear(self) -> None:
        with self.generic_lock:
            self.generic.clear()
        with self.joinindex_lock:
            self.joinindex.clear()
        pool = self.bufferpool
        if pool is not None:
            pool.clear()

    def snapshot(self) -> dict:
        out = {"kind": self.kind,
               "generic_skeletons": len(self.generic),
               "join_index_entries": len(self.joinindex)}
        pool = self.bufferpool
        if pool is not None:
            out["bufferpool"] = pool.snapshot()
        fb = self.feedback
        if fb is not None:
            out["feedback"] = fb.snapshot()
        return out


_tier_lock = threading.Lock()
_store_scopes: dict[str, CacheScope] = {}
# process-lifetime bound on retained store scopes (LRU): evicting one
# only forfeits cached entries for sessions opened LATER against that
# root — existing sessions keep their scope object, and correctness
# never depends on scope identity (keys are self-describing)
_STORE_SCOPES_MAX = 16
_uid_counter = itertools.count(1)


def scope_for(session) -> CacheScope:
    """The session's cache scope, created on first use. Store-backed
    sessions with ``config.sched.shared_cache`` share the per-root scope;
    everything else is private. Sessions cache the result
    (``session._cache_scope``) — Session.__init__ calls this once."""
    scope = getattr(session, "_cache_scope", None)
    if scope is not None:
        return scope
    if getattr(session, "store", None) is not None \
            and session.config.sched.shared_cache:
        root = str(session.config.storage.root)
        with _tier_lock:
            scope = _store_scopes.pop(root, None)
            if scope is None:
                scope = CacheScope("store", root)
            _store_scopes[root] = scope  # LRU touch
            while len(_store_scopes) > _STORE_SCOPES_MAX:
                _store_scopes.pop(next(iter(_store_scopes)))
    else:
        scope = CacheScope("session", id(session))
    session._cache_scope = scope
    return scope


def drop_store_scope(root: str) -> None:
    """Forget the shared scope of a store root: sessions opened later
    start from empty caches (a cold-read measurement, or a root whose
    directory was removed and re-created). Sessions already holding the
    scope keep it."""
    with _tier_lock:
        scope = _store_scopes.pop(str(root), None)
    if scope is not None:
        scope.clear()


def _uid(obj) -> int:
    """Process-unique, never-reused id for a table object, stamped
    lazily — the private-key component that makes object-bound entries
    collision-free inside a shared scope (plain ``id()`` is reused after
    GC)."""
    u = getattr(obj, "_cache_uid", None)
    if u is None:
        with _tier_lock:
            u = getattr(obj, "_cache_uid", None)
            if u is None:
                u = next(_uid_counter)
                try:
                    obj._cache_uid = u
                except AttributeError:  # __slots__ or frozen: fall back
                    return id(obj)
    return u


def session_uid(session) -> int:
    return _uid(session)


_config_uids: dict[int, tuple] = {}  # id(cfg) -> (uid, weakref)


def config_uid(cfg) -> int:
    """Process-unique token for a Config OBJECT (frozen dataclasses
    reject attribute stamping, and a bare id() could be reused after
    GC): the config-epoch component for shared cache keys."""
    with _tier_lock:
        ent = _config_uids.get(id(cfg))
        if ent is not None and ent[1]() is cfg:
            return ent[0]
        u = next(_uid_counter)
        _config_uids[id(cfg)] = (u, weakref.ref(cfg))
        return u


def table_key(session, name: str):
    """Content-stable identity token for one table, suitable as a shared
    cache-key component. Raises KeyError for unknown tables."""
    t = session.catalog.tables.get(name)
    if t is None:
        raise KeyError(name)
    scope = scope_for(session)
    if scope.kind == "session":
        # private scope: names suffice; versions bump on every
        # set_data/ANALYZE
        return (name, getattr(t, "_version", 0),
                getattr(t, "_stats_version", 0))
    sv = getattr(t, "_store_version", None)
    if sv is not None and getattr(session, "_txn_snapshot", None) is None:
        # store-backed outside a transaction: the store version IS the
        # content (manifests are immutable; any commit — data, stats,
        # recreate — publishes a new version). Inside one the store
        # version stands still while the RAM table changes
        return (name, "sv", sv)
    # in-RAM table / mid-transaction state: bind to this table OBJECT so
    # the entry is private even in a shared scope
    return (name, "uid", _uid(t), getattr(t, "_version", 0),
            getattr(t, "_stats_version", 0))


def table_versions(session, names):
    """Tuple of table_key tokens for a sorted name list (the shared-tier
    form of Session._table_versions in cache guards)."""
    return tuple(table_key(session, n) for n in names)


def device_token(session) -> str:
    """The device an entry's tensors live on — part of every shared key
    (module docstring)."""
    return str(session.device)


def topology_token(session) -> int:
    """The session's current topology-epoch id (parallel/topology.py) —
    carried by EVERY shared key so an entry made under an earlier epoch
    can never serve after a cutover."""
    from cloudberry_tpu_torch.parallel.topology import topology_token as _tt

    return _tt(session)


def plan_epoch(session) -> tuple:
    """The non-table part of a generic plan's validity: the process-wide
    UDF registry version always, plus the topology token; the catalog ddl
    counter only for private scopes (shared scopes rely on the full
    structural signature — ddl counters are per-catalog and would just
    block sharing)."""
    from cloudberry_tpu_torch.exec.udf import registry_version

    scope = scope_for(session)
    if scope.kind == "session":
        return ("local", topology_token(session),
                session.catalog.ddl_version, registry_version())
    return ("store", topology_token(session), registry_version())


def tier_snapshot(session) -> dict:
    """Observability (the flight recorder's cache-tier section): this
    session's scope."""
    scope = scope_for(session)
    out = scope.snapshot()
    out["shared"] = scope.kind == "store"
    return out
