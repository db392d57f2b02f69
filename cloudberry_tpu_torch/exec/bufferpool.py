"""Device-resident buffer pool — hot scans served from device memory.

Without it every store scan reads micro-partitions, decodes them on the
host and copies them to the device at every statement, even a repeat
aggregate over a hot table. The reference engine keeps hot blocks in a
shared buffer pool next to the executor; the JAX package's analog keeps
decoded partitions in HBM across statements, and this port keeps them in
the session device's memory (a CUDA card's HBM; host memory for a CPU
session).

Design (the JAX package's exec/bufferpool.py, with device tensors):

- **Entries are decoded partition chunks**, exactly what
  ``TableStore.read_partitions`` returns for one part (post-delete-filter
  columns, ``cols``/``validity`` split), held as tensors on the device.
  Multi-partition scans concatenate chunks in part order with
  ``torch.cat`` — bit for bit what one ``read_partitions`` of all the
  parts gives, since that concatenates the same chunks in the same order.
- **Keys carry the shared-cache-tier tokens** (sched/sharedcache.py):
  table name, store version, partition file, column set, the config
  epoch uid and the DEVICE. A version bump or a config swap invalidates
  by construction; the device keeps a CPU session and a CUDA session over
  one store root from ever being handed each other's tensors.
- **Admission by observed scan frequency**: every lookup counts a scan
  of that partition; ``offer`` admits only once the count reaches
  ``config.bufferpool.admit_min_scans``.
- **Eviction is LRU-by-bytes under ``config.bufferpool.max_bytes``**
  (device bytes), with REFUSAL-over-evicting-hotter: an oversize chunk is
  refused, and a candidate never evicts a victim that is scanned more
  frequently than itself.
- Lock discipline: ``BufferPool._lock`` is an innermost leaf — nothing is
  called while it is held; counter bumps and the
  ``bufpool_admit``/``bufpool_evict`` fault seams run outside it.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from cloudberry_tpu_torch.utils.faultinject import fault_point

# per-partition scan-frequency sketch bound: far above any realistic
# working set; overflow drops the oldest observation (FIFO), which only
# biases a cold key back toward not-yet-admitted
_FREQ_MAX = 65536


def _value_nbytes(value: dict) -> int:
    """Device bytes one entry pins: the nested cols/validity tensors."""
    total = 0
    for v in value.values():
        if isinstance(v, dict):
            total += _value_nbytes(v)
        elif torch.is_tensor(v):
            total += v.numel() * v.element_size()
        else:
            nb = getattr(v, "nbytes", None)
            if nb is not None:
                total += int(nb)
    return total


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """One host column as a tensor on ``device``. Decoded arrays may be
    read-only views of decompressed bytes (``np.frombuffer``), which
    ``torch.from_numpy`` would share and warn about: such an array is
    copied once, on purpose; a writeable one is shared for the upload."""
    a = np.asarray(arr)
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a, copy=True, order="C")
    return torch.from_numpy(a).to(device)


def _commit(value: dict, device) -> dict:
    """An entry for residency: numpy leaves upload to ``device``, tensor
    leaves (already on the session's device) are held as they are —
    nothing writes to a scan's input tensors."""
    def put(v):
        return to_device(v, device) if isinstance(v, np.ndarray) else v

    return {k: ({c: put(a) for c, a in v.items()}
                if isinstance(v, dict) else put(v))
            for k, v in value.items()}


class BufferPool:
    """Device-side micro-partition cache. One per cache scope
    (sched/sharedcache.py) — sessions over the same store root share it;
    storeless sessions get a private one. All shared state lives under
    ``_lock`` (a leaf: nothing is called while held)."""

    def __init__(self, max_bytes: int, admit_min_scans: int = 2):
        self._lock = threading.Lock()
        # key -> (value dict, nbytes, table name); dict order IS the
        # LRU order (lookup pops and reinserts, eviction takes the head)
        self._entries: dict = {}
        # observed per-partition scan counts (the admission signal)
        self._freq: dict = {}
        self.bytes = 0
        self.max_bytes = int(max_bytes)
        self.admit_min_scans = max(int(admit_min_scans), 1)
        # telemetry mirrors for snapshot() (the session counters are
        # bumped by the callers outside the lock)
        self.hits = 0
        self.misses = 0
        self.admits = 0
        self.evictions = 0
        self.refusals = 0

    # ------------------------------------------------------------- lookup

    def lookup(self, key, log=None) -> Optional[dict]:
        """The resident entry for ``key`` (LRU-touched), or None. Every
        call counts one observed scan of the partition — the admission
        frequency ``offer`` consults."""
        with self._lock:
            self._freq[key] = self._freq.get(key, 0) + 1
            while len(self._freq) > _FREQ_MAX:
                self._freq.pop(next(iter(self._freq)))
            ent = self._entries.pop(key, None)
            if ent is not None:
                self._entries[key] = ent  # LRU touch
                self.hits += 1
            else:
                self.misses += 1
        if log is not None:
            log.bump("bufpool_hits" if ent is not None
                     else "bufpool_misses")
        return ent[0] if ent is not None else None

    # ---------------------------------------------------------- admission

    def offer(self, key, value: dict, table: str = "", log=None,
              device=None) -> bool:
        """Admit one decoded chunk if it is hot enough and fits. Returns
        True when the entry became resident. ``value`` holds tensors (or
        numpy arrays, which upload to ``device`` first); its size counts
        in device bytes. The fault seams and counter bumps run OUTSIDE
        the pool lock (they take leaf locks of their own)."""
        with self._lock:
            cap = self.max_bytes
            admit_min = self.admit_min_scans
            known = key in self._entries
            freq = self._freq.get(key, 0)
        if known or cap <= 0 or freq < admit_min:
            return False
        nb = _value_nbytes(value)
        if nb <= 0:
            return False
        if nb > cap:
            # oversize: refuse rather than flush the whole pool for one
            # chunk (the RecoveryStore ckpt_oversize_refused discipline)
            with self._lock:
                self.refusals += 1
            if log is not None:
                log.bump("bufpool_refusals")
            return False
        if fault_point("bufpool_admit"):
            return False  # 'skip' arm: suppress admission
        with self._lock:
            will_evict = self.bytes + nb > cap and bool(self._entries)
        if will_evict and fault_point("bufpool_evict"):
            return False  # 'skip' arm: refuse rather than evict
        held = _commit(value, device)
        evicted = 0
        refused = False
        admitted = False
        with self._lock:
            cap = self.max_bytes
            if key not in self._entries:
                while self.bytes + nb > cap and self._entries:
                    vk = next(iter(self._entries))
                    if self._freq.get(vk, 0) > freq:
                        # refusal-over-evicting-hotter: never displace
                        # a more-frequently-scanned partition for a
                        # colder candidate — refuse the candidate
                        refused = True
                        break
                    _, vnb, _ = self._entries.pop(vk)
                    self.bytes -= vnb
                    evicted += 1
                if not refused and self.bytes + nb <= cap:
                    self._entries[key] = (held, nb, table)
                    self.bytes += nb
                    self.admits += 1
                    admitted = True
                else:
                    refused = True
                if refused:
                    self.refusals += 1
                if evicted:
                    self.evictions += evicted
        if log is not None:
            if evicted:
                log.bump("bufpool_evictions", evicted)
            if admitted:
                log.bump("bufpool_admits")
            if refused:
                log.bump("bufpool_refusals")
        return admitted

    # ------------------------------------------------------- invalidation

    def sweep(self, pred) -> int:
        """Drop every entry whose KEY satisfies ``pred`` (a pure
        function over the key tuple — called under the lock, so it must
        not acquire anything). Returns the count dropped."""
        with self._lock:
            dead = [k for k in self._entries if pred(k)]
            for k in dead:
                _, nb, _ = self._entries.pop(k)
                self.bytes -= nb
        return len(dead)

    def drop_tables(self, names) -> int:
        """Drop every entry offered for one of the tables ``names``;
        returns the count dropped."""
        with self._lock:
            dead = [k for k, (_, _, t) in self._entries.items()
                    if t in names]
            for k in dead:
                _, nb, _ = self._entries.pop(k)
                self.bytes -= nb
        return len(dead)

    def clear(self) -> int:
        """Drop everything (scope invalidation — stale keys could never
        serve anyway, but the resident device bytes are freed eagerly).
        The frequency sketch clears too."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._freq.clear()
            self.bytes = 0
        return n

    # ------------------------------------------------------ observability

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self.bytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "admits": self.admits,
                "evictions": self.evictions,
                "refusals": self.refusals,
                "tracked_keys": len(self._freq),
            }

    def table_bytes(self, table: str) -> int:
        """Resident bytes attributable to one table."""
        with self._lock:
            return sum(nb for _, nb, t in self._entries.values()
                       if t == table)

    def grow(self, max_bytes: int) -> None:
        """Grow-only budget update: a second session in the scope with a
        larger configured pool raises the cap; a smaller one never
        shrinks it under a peer."""
        with self._lock:
            if int(max_bytes) > self.max_bytes:
                self.max_bytes = int(max_bytes)


# -------------------------------------------------------------- wiring

_create_lock = threading.Lock()


def pool_for(session) -> Optional[BufferPool]:
    """The session's buffer pool, anchored on its cache scope
    (sched/sharedcache.py — per store root when shared, per session
    otherwise), lazily created. None when ``bufferpool.enabled`` is
    False or ``bufferpool.max_bytes`` is 0: every consumer then takes its
    pre-pool path unchanged."""
    bp = getattr(getattr(session, "config", None), "bufferpool", None)
    if bp is None or not bp.enabled or bp.max_bytes <= 0:
        return None
    from cloudberry_tpu_torch.sched import sharedcache

    scope = sharedcache.scope_for(session)
    pool = getattr(scope, "bufferpool", None)
    if pool is None:
        with _create_lock:
            pool = getattr(scope, "bufferpool", None)
            if pool is None:
                pool = BufferPool(bp.max_bytes, bp.admit_min_scans)
                scope.bufferpool = pool
    else:
        pool.grow(bp.max_bytes)
    return pool


def partition_key(session, table: str, part: dict, columns: tuple):
    """Key for one decoded partition chunk. The store version pins
    content (manifests are immutable — a commit publishes a new version,
    including delete-vector changes); the config and device tokens are
    the shared-tier epoch discipline."""
    from cloudberry_tpu_torch.sched import sharedcache

    return ("part", table,
            session.catalog.store.effective_version(table),
            part["file"], columns,
            sharedcache.topology_token(session),
            sharedcache.config_uid(session.config),
            sharedcache.device_token(session))


def dist_tile_key(session, table: str, columns: tuple, nseg: int,
                  tile_rows: int, off: int):
    """Key for one packed (nseg, tile_rows) distributed feed tile
    (exec/tiled_dist.py). ``table_key`` pins the content (store version,
    or object uid + version for RAM tables); nseg and the tile geometry
    pin the packing; the config and device tokens are the shared-tier
    epoch discipline."""
    from cloudberry_tpu_torch.sched import sharedcache

    return ("dtile", sharedcache.table_key(session, table), columns,
            int(nseg), int(tile_rows), int(off),
            sharedcache.topology_token(session),
            sharedcache.config_uid(session.config),
            sharedcache.device_token(session))
