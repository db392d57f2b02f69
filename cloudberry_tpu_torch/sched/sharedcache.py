"""Process-wide shared cache tier — one invalidation scope per store root.

The JAX package promotes three per-session caches (generic plans,
capacity-rung executables, join indexes) to an engine-wide tier, plus the
HBM buffer pool. This port carries the tier's scope machinery for the two
caches it has: the join-index cache (exec/joinindex.py) and the device
buffer pool (exec/bufferpool.py).

- sessions over the same durable store root share ONE scope;
- storeless sessions get a private scope.

The invalidation contract is the signature discipline, not a protocol:

- every shared key embeds content-stable TABLE VERSION tokens
  (``table_key``): a store-backed table is pinned by its store version
  (any commit bumps it); anything else — in-RAM tables — falls back to a
  process-unique table uid + local version, making those entries
  private-by-construction even inside a shared scope;
- the config OBJECT IDENTITY is the config epoch (``config_uid``);
- the DEVICE is part of every key (``device_token``). The JAX package has
  one default device per process; the port can hold a CPU session and a
  CUDA session over the same store root in one process, and an entry
  holds tensors on the device that built it — a CPU session must never
  be handed CUDA tensors, or the other way round.

At one segment there is no topology epoch: ``topology_token`` is a
constant.
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
        # join indexes (exec/joinindex.py)
        self.joinindex: dict = {}
        self.joinindex_lock = threading.Lock()
        # device-resident scan buffer pool (exec/bufferpool.py), created
        # lazily by bufferpool.pool_for — it owns its own leaf lock and
        # byte budget; anchored here so sessions over one store root
        # share residency
        self.bufferpool = None

    def clear(self) -> None:
        with self.joinindex_lock:
            self.joinindex.clear()
        pool = self.bufferpool
        if pool is not None:
            pool.clear()

    def snapshot(self) -> dict:
        out = {"kind": self.kind,
               "join_index_entries": len(self.joinindex)}
        pool = self.bufferpool
        if pool is not None:
            out["bufferpool"] = pool.snapshot()
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
    sessions share the per-root scope; everything else is private. Sessions cache the result
    (``session._cache_scope``) — Session.__init__ calls this once."""
    scope = getattr(session, "_cache_scope", None)
    if scope is not None:
        return scope
    if getattr(session, "store", None) is not None:
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
    if sv is not None:
        # store-backed (the port runs the store in autocommit mode): the
        # store version IS the content (manifests are immutable; any
        # commit — data, stats, recreate — publishes a new version)
        return (name, "sv", sv)
    # in-RAM table: bind to this table OBJECT so the entry is private
    # even in a shared scope
    return (name, "uid", _uid(t), getattr(t, "_version", 0),
            getattr(t, "_stats_version", 0))


def device_token(session) -> str:
    """The device an entry's tensors live on — part of every shared key
    (module docstring)."""
    return str(session.device)


def topology_token(session) -> int:
    """The topology-epoch token of the JAX package's shared keys. One
    segment has one topology: a constant."""
    return 0
