"""TableStore — persistent tables over immutable micro-partitions with
snapshot manifests.

The transactional design follows SURVEY.md §7.1's stance: instead of
re-building per-node WAL + 2PC (cdbtm.c), the coordinator owns ONE logical
commit log per store: every write produces new immutable partition files plus
a new manifest version; readers pin a manifest version and see a consistent
snapshot (the distributed-snapshot analog, cdbdistributedsnapshot.c — here
trivially consistent because data files never mutate). Deletes are
delete-vectors recorded in the manifest (the AO visimap analog,
appendonly_visimap.c). Commit = atomic rename of the CURRENT pointer; crash
before rename leaves the previous snapshot intact (crash recovery = nothing
to do).

Layout:
    root/<table>/part-<uuid>.cbmp           immutable column data
    root/<table>/_manifests/v<k>.json       snapshot manifests
    root/<table>/_manifests/CURRENT         text: latest committed version
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import tempfile
import threading
import uuid
from dataclasses import dataclass
from typing import Optional

import numpy as np

from cloudberry_tpu_torch.columnar.dictionary import StringDictionary
from cloudberry_tpu_torch.parallel.writer import one_writer
from cloudberry_tpu_torch.storage import iofault
from cloudberry_tpu_torch.storage import micropartition as mp
from cloudberry_tpu_torch.types import DType, Schema


@dataclass
class PartitionEntry:
    file: str
    num_rows: int
    # stats: {col: [min, max]}
    stats: dict
    # sorted row ids deleted from this partition (visimap analog)
    deleted: list[int]


class QuotaError(RuntimeError):
    """Store disk usage reached TableStore.quota_bytes (diskquota analog)."""


class TableStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        # session-transaction write deferral: inside BEGIN..COMMIT, data
        # changes collect in _txn_dirty (and drops in _txn_drops) and hit
        # disk only at COMMIT; ROLLBACK discards them — the store never
        # sees uncommitted state (single-coordinator commit discipline)
        self.autocommit = True
        self._txn_dirty: dict[str, object] = {}
        self._txn_drops: list[str] = []
        self.rows_per_partition = 1 << 20
        # TDE (utils/tde.py): set via storage.encryption_key; encrypts
        # micro-partition files and manifests at rest
        self.cipher = None
        # content-checksum verification at decode (pg_checksums analog):
        # column blobs carry a crc in the footer; a mismatch raises
        # StorageCorruptionError instead of decoding garbage. Config:
        # storage.verify_checksums (default on — crc32 is cheap next to
        # decompression).
        self.verify_checksums = True
        # disk quota (diskquota extension analog): enforced at write time
        # against real on-disk usage; 0 = unlimited. Config:
        # storage.quota_bytes. Like the reference's, enforcement is a hard
        # stop once usage REACHES the quota — the write that crosses it
        # succeeds, the next one is refused.
        self.quota_bytes = 0
        # snapshot pinning: while a session transaction is open, every read
        # through read_manifest resolves to the version current at BEGIN —
        # repeatable reads even while OTHER sessions commit (the
        # distributed-snapshot discipline, cdbdistributedsnapshot.c)
        self.pinned: dict[str, int] = {}
        # intra-process writer exclusion (see lock()): the O_EXCL file
        # only arbitrates between PROCESSES; threads sharing this store
        # object (the ingest flusher, the compaction worker, statement
        # threads) serialize here first
        self._tlock = threading.Lock()
        self._lock_owner: Optional[int] = None
        # a cluster statement's agreed snapshot (Session._cluster_snapshot):
        # this thread's reads resolve to these versions while it runs
        self._stmt = threading.local()

    @contextlib.contextmanager
    def snapshot(self, versions: dict):
        """Resolve this thread's manifest reads to ``versions`` (table ->
        version) — one cluster statement's agreed snapshot. Writes build
        on CURRENT regardless (``_head``)."""
        prev = getattr(self._stmt, "pins", None)
        self._stmt.pins = versions
        try:
            yield
        finally:
            self._stmt.pins = prev

    # ------------------------------------------------- session transactions

    def begin_txn(self, versions: Optional[dict] = None) -> None:
        """Defer writes to COMMIT and pin every table's version:
        ``versions`` (a cluster's agreed snapshot), else CURRENT's."""
        self.autocommit = False
        self._txn_dirty = {}
        self._txn_stats: dict[str, object] = {}
        self._txn_drops = []
        # append tracking for the OCC merge: a transaction whose writes to
        # a table were ALL appends can merge onto a concurrently-committed
        # snapshot instead of aborting (concurrent INSERTs both succeed —
        # the concurrent-DML capability of the reference's GDD,
        # src/backend/utils/gdd/README.md)
        self._txn_appends: dict[str, int] = {}
        self._txn_rewrites: set[str] = set()
        self.pinned = dict(versions) if versions is not None else {
            name: self.current_version(name) for name in self.table_names()}

    def note_txn_write(self, name: str, appended: Optional[int]) -> None:
        """Record whether a deferred in-transaction write was an append
        (last ``appended`` rows new, rest untouched) or a rewrite."""
        if appended is None:
            self._txn_rewrites.add(name)
            self._txn_appends.pop(name, None)
        elif name not in self._txn_rewrites:
            self._txn_appends[name] = \
                self._txn_appends.get(name, 0) + appended

    def txn_append_only(self, name: str) -> bool:
        return (name in getattr(self, "_txn_appends", {})
                and name not in getattr(self, "_txn_rewrites", set())
                and name not in self._txn_drops)

    @one_writer
    def commit_txn(self, base: Optional[dict] = None) -> None:
        self.pinned = {}  # commit writes against CURRENT, not the snapshot
        base = base or {}
        for name in self._txn_drops:
            self.drop_table(name)
        for name, t in self._txn_dirty.items():
            moved = self.current_version(name) != base.get(name, 0)
            if moved and self.txn_append_only(name):
                # another session committed first but this transaction
                # only APPENDED: merge the new tail onto their snapshot
                # (serial order: theirs, then this one)
                self._merge_append(t, self._txn_appends[name])
                # this session's RAM copy is missing the other session's
                # rows — force a cold re-register at the next sync
                t._store_version = None
            else:
                t._store_version = self.save_table(t,
                                                   self.rows_per_partition)
        # stats-only changes (ANALYZE with no DML): one manifest write,
        # not a full data re-snapshot
        for name, t in getattr(self, "_txn_stats", {}).items():
            if name not in self._txn_dirty and t.stats.ndv:
                t._store_version = self.save_stats(
                    name, t.stats.ndv, t.stats.hist,
                    t.stats.analyzed_rows)
        self.abort_txn()

    def abort_txn(self) -> None:
        self.autocommit = True
        self._txn_dirty = {}
        self._txn_stats = {}
        self._txn_drops = []
        self._txn_appends = {}
        self._txn_rewrites = set()
        self.pinned = {}

    def effective_version(self, name: str) -> int:
        v = self.pinned.get(name)
        return v if v is not None else self.current_version(name)

    def conflicting_tables(self, base: dict[str, int]) -> list[str]:
        """Tables this transaction wrote whose store version moved past the
        BEGIN snapshot AND whose writes cannot merge — the OCC check.
        Append-only writes merge onto the concurrent snapshot (commit_txn);
        rewrites (UPDATE/DELETE) and drops conflict: first committer wins,
        the later COMMIT must fail rather than overwrite. Stats-only
        changes (ANALYZE) never conflict — advisory, last write wins."""
        written = set(self._txn_dirty) | set(self._txn_drops)
        return sorted(n for n in written
                      if self.current_version(n) != base.get(n, 0)
                      and not self.txn_append_only(n))

    def _merge_append(self, t, k: int) -> int:
        """Append transaction ``t``'s last ``k`` rows onto the CURRENT
        snapshot (which another session committed after this transaction
        began). String codes re-encode against the stored dictionary (the
        two sessions may have extended the base dictionary differently),
        and stored uniqueness flags are re-verified against the merged
        data — a column stays unique only if the tail neither overlaps the
        stored values nor repeats internally."""
        name = t.name
        tail = {c: np.asarray(v)[-k:] for c, v in t.data.items()}
        validity = {c: np.asarray(v)[-k:] for c, v in t.validity.items()
                    if len(v)}
        man = self._head(name)
        stored_dicts = {c: StringDictionary(v)
                        for c, v in man.get("dicts", {}).items()}
        dicts = {}
        for c, d in t.dicts.items():
            sd = stored_dicts.get(c)
            if sd is None or sd.values == d.values:
                dicts[c] = d
                continue
            vals = d.decode(tail[c])
            tail[c] = sd.encode(np.asarray(vals, dtype=object))
            dicts[c] = sd
        unique = dict(man.get("unique", {}))
        for c, was in list(unique.items()):
            if not was or c not in tail:
                continue
            tc = tail[c]
            if len(np.unique(tc)) != len(tc):
                unique[c] = False
                continue
            stored, _ = self.read_partitions(name, man["partitions"], [c])
            unique[c] = not bool(np.isin(tc, stored[c]).any())
        v = self.append(name, tail, t.schema, dicts, replace=False,
                        validity=validity, unique=unique,
                        rows_per_partition=self.rows_per_partition)
        return v

    # ----------------------------------------------------------- manifests

    def _mdir(self, table: str) -> str:
        return os.path.join(self.root, table, "_manifests")

    def current_version(self, table: str) -> int:
        try:
            with open(os.path.join(self._mdir(table), "CURRENT")) as f:
                return int(f.read().strip())
        except FileNotFoundError:
            return 0

    def read_manifest(self, table: str,
                      version: Optional[int] = None) -> dict:
        if version is None:
            version = self.pinned.get(table)
        if version is None:
            version = (getattr(self._stmt, "pins", None) or {}).get(table)
        v = self.current_version(table) if version is None else version
        if v == 0:
            return {"version": 0, "schema": None, "partitions": [],
                    "dicts": {}}
        mpath = os.path.join(self._mdir(table), f"v{v}.json")
        with open(mpath, "rb") as f:
            raw = f.read()
        if raw[:8] == b"CBMPENC1":
            if self.cipher is None:
                from cloudberry_tpu_torch.utils.tde import TdeError

                raise TdeError(f"{mpath}: encrypted manifest but no "
                               "storage.encryption_key configured")
            raw = self.cipher.decrypt(raw[8:])
        return json.loads(raw)

    def _head(self, table: str) -> dict:
        """The manifest a write builds on: the open transaction's pinned
        version, else CURRENT (never a cluster statement's snapshot)."""
        v = self.pinned.get(table)
        return self.read_manifest(
            table, self.current_version(table) if v is None else v)

    def _commit(self, table: str, manifest: dict) -> int:
        """Atomically publish a new snapshot (single-coordinator commit).
        The store lock closes the version-read → publish window against
        other processes."""
        with self.lock():
            return self._commit_locked(table, manifest)

    def _commit_locked(self, table: str, manifest: dict) -> int:
        from cloudberry_tpu_torch.utils.faultinject import fault_point

        mdir = self._mdir(table)
        os.makedirs(mdir, exist_ok=True)
        v = self.current_version(table) + 1
        manifest["version"] = v
        path = os.path.join(mdir, f"v{v}.json")
        raw = json.dumps(manifest).encode()
        if self.cipher is not None:
            raw = b"CBMPENC1" + self.cipher.encrypt(raw)
        # the manifest body write — a crash here leaves a torn/orphan
        # v{N}.json that CURRENT never points at (fsck collects it)
        fault_point("io_manifest_write")
        iofault.durable_write(path, raw)
        # atomic CURRENT swap — the commit point; the fault point simulates
        # a crash in the window after the manifest is written but before the
        # commit becomes visible (chaos tests verify the old snapshot wins)
        if fault_point("storage_commit_before_current"):
            return v
        fd, tmp = tempfile.mkstemp(dir=mdir)
        with os.fdopen(fd, "w") as f:
            f.write(str(v))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(mdir, "CURRENT"))
        iofault.fsync_dir(mdir)  # the rename must survive power loss too
        # the committed-but-unacknowledged window: a crash here loses the
        # ack, not the data — restart-verify must FIND these rows durable
        fault_point("storage_commit_after_current")
        self._bump_epoch()
        return v

    # store-wide change token: one cheap read tells a session whether ANY
    # table changed since it last looked (catalog-sync fast path). A unique
    # token, not a counter — concurrent bumps can never collapse into one
    # value and hide a commit (no read-modify-write race).

    def epoch(self) -> str:
        try:
            with open(os.path.join(self.root, "_EPOCH")) as f:
                return f.read().strip()
        except FileNotFoundError:
            return ""

    def _bump_epoch(self) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.root)
        with os.fdopen(fd, "w") as f:
            f.write(uuid.uuid4().hex)
        os.replace(tmp, os.path.join(self.root, "_EPOCH"))

    # ---------------------------------------------- inter-process write lock

    def lock(self, timeout_s: float = 30.0):
        """Store-wide mutual exclusion: _tlock serializes the THREADS
        sharing this store object (ingest flusher, compaction worker,
        statement threads), an flock(2) on the persistent _LOCK file
        serializes PROCESSES. Held around version-check-then-commit so
        two committers can never both pass the OCC check and overwrite
        each other. Re-entrant within one thread — a boolean "am I
        inside?" flag is NOT enough here: it is readable by sibling
        threads, and a sibling that treated the holder's flag as its own
        re-entrancy would walk straight into the critical section and
        tear the v{N}.json both would then write.

        flock, not a pid-stamped O_EXCL file: the kernel drops the lock
        the instant the holder dies (crash-only — a SIGKILLed writer
        needs no stale-lock breaking), and breaking by unlink had an
        unfixable TOCTOU — between "pid in _LOCK is dead" and the
        unlink, a racer can break the same stale file and acquire a
        fresh one, which the unlink then destroys, letting two processes
        into the commit critical section. The _LOCK file itself is
        permanent (unlink-on-release re-opens the same race: a lock
        taken on a just-unlinked inode excludes nobody); its content is
        the holder's pid, for diagnostics only."""
        import contextlib
        import time as _time

        @contextlib.contextmanager
        def _locked():
            me = threading.get_ident()
            if self._lock_owner == me:
                yield
                return
            from cloudberry_tpu_torch.utils.faultinject import fault_point

            fault_point("store_lock_acquire")
            if not self._tlock.acquire(timeout=timeout_s):
                raise RuntimeError(
                    f"store lock timeout after {timeout_s}s — another "
                    "thread of this process is holding the store lock")
            try:
                path = os.path.join(self.root, "_LOCK")
                fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
                try:
                    deadline = _time.monotonic() + timeout_s
                    while True:
                        try:
                            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                            break
                        except OSError:
                            if _time.monotonic() > deadline:
                                raise RuntimeError(
                                    f"store lock timeout after {timeout_s}s "
                                    f"— another process holds {path}")
                            _time.sleep(0.01)
                    try:
                        os.ftruncate(fd, 0)
                        os.write(fd, str(os.getpid()).encode())
                    except OSError:
                        pass  # diagnostics only — the flock IS the lock
                    self._lock_owner = me
                    try:
                        yield
                    finally:
                        self._lock_owner = None
                        try:
                            os.ftruncate(fd, 0)
                        except OSError:
                            pass
                finally:
                    os.close(fd)  # releases the flock
            finally:
                self._tlock.release()

        return _locked()

    # -------------------------------------------------------------- writes

    @one_writer
    def append(self, table: str, data: dict[str, np.ndarray], schema: Schema,
               dicts: dict[str, StringDictionary] | None = None,
               rows_per_partition: int = 1 << 20,
               replace: bool = False, policy=None,
               validity: dict[str, np.ndarray] | None = None,
               unique: dict[str, bool] | None = None,
               partition_spec: tuple | None = None) -> int:
        """Append rows as new micro-partitions (``replace=True``: the new
        snapshot contains ONLY these rows — still one atomic commit, so a
        crash mid-write never publishes an empty intermediate).
        ``validity`` masks persist as extra "$nn:<col>" bool columns.
        Returns the new snapshot version."""
        tdir = os.path.join(self.root, table)
        os.makedirs(tdir, exist_ok=True)
        man = self._head(table)
        n = len(next(iter(data.values()))) if data else 0
        live = sum(p["num_rows"] - len(p["deleted"])
                   for p in man["partitions"])
        if not (replace and n < live):
            # a rewrite that only removes rows (SQL DELETE, TRUNCATE) is
            # a way out past the quota, as the refusal's words promise
            self._check_quota(table)
        if replace:
            man["partitions"] = []
        phys_schema = schema
        phys_data = data
        if validity:
            from cloudberry_tpu_torch.types import BOOL, Field as TField

            phys_data = dict(data)
            extra = []
            for c, v in validity.items():
                phys_data[f"$nn:{c}"] = np.asarray(v, dtype=np.bool_)
                extra.append(TField(f"$nn:{c}", BOOL))
            phys_schema = Schema(tuple(schema.fields) + tuple(extra))
        spec = partition_spec if partition_spec is not None \
            else (tuple(man["partition_spec"])
                  if man.get("partition_spec") else None)
        new_parts = []
        for pkey, idx in _partition_rows(spec, phys_data, n):
            group = phys_data if idx is None \
                else {k: v[idx] for k, v in phys_data.items()}
            gn = n if idx is None else len(idx)
            for lo in range(0, max(gn, 1), rows_per_partition):
                hi = min(lo + rows_per_partition, gn)
                if hi <= lo:
                    break
                chunk = {k: v[lo:hi] for k, v in group.items()}
                fname = f"part-{uuid.uuid4().hex}.cbmp"
                footer = mp.write_micropartition(
                    os.path.join(tdir, fname), chunk, phys_schema, dicts,
                    cipher=self.cipher)
                stats = {c["name"]: [c["min"], c["max"]]
                         for c in footer["columns"] if "min" in c}
                entry = {"file": fname, "num_rows": hi - lo,
                         "stats": stats, "deleted": []}
                if pkey is not None:
                    entry["pkey"] = pkey
                new_parts.append(entry)
        # dictionaries are table-level, append-only state: a new dict must
        # EXTEND the stored one (codes in already-written partitions keep
        # decoding correctly); anything else is a caller error, not silent
        # corruption.
        man["schema"] = [mp._field_json(f) for f in schema.fields]
        man["not_null"] = [f.name for f in schema.fields if not f.nullable]
        if replace:
            man["nullable"] = sorted(validity or [])
        elif validity:
            man["nullable"] = sorted(set(man.get("nullable", []))
                                     | set(validity))
        if unique is not None:
            man["unique"] = unique
        if policy is not None:
            man["policy"] = {"kind": policy.kind, "keys": list(policy.keys)}
        if spec is not None:
            man["partition_spec"] = list(spec)
        old_dicts = man.get("dicts", {}) if not replace else {}
        new_dicts = {k: list(d.values) for k, d in (dicts or {}).items()}
        for k, old in old_dicts.items():
            new = new_dicts.get(k)
            if new is None:
                new_dicts[k] = old
            elif new[:len(old)] != old:
                raise ValueError(
                    f"dictionary for column {k!r} is not an append-only "
                    f"extension of the stored dictionary")
        man["dicts"] = new_dicts
        man["partitions"] = man["partitions"] + new_parts
        return self._commit(table, man)

    _QUOTA_TTL_S = 5.0

    def disk_usage(self, fresh: bool = False) -> int:
        """Bytes on disk under the store root (partition files, manifests,
        sequences — everything the store owns). Cached for a few seconds:
        quota enforcement is approximate by design (the reference's
        diskquota worker likewise refreshes usage on an interval rather
        than walking per write)."""
        import time as _time

        now = _time.monotonic()
        cached = getattr(self, "_usage_cache", None)
        if not fresh and cached is not None \
                and now - cached[0] < self._QUOTA_TTL_S:
            return cached[1]
        total = 0
        for dirpath, _, files in os.walk(self.root):
            for f in files:
                try:
                    total += os.path.getsize(os.path.join(dirpath, f))
                except FileNotFoundError:
                    pass  # raced a concurrent unlink — benign
                except OSError as e:
                    iofault.note_io_error(os.path.join(dirpath, f), e)
        self._usage_cache = (now, total)
        return total

    def _invalidate_usage(self) -> None:
        self._usage_cache = None

    def _check_quota(self, table: str) -> None:
        if self.quota_bytes <= 0:
            return
        used = self.disk_usage()
        if used >= self.quota_bytes:
            # re-walk before refusing: the cache may predate a reclaim
            used = self.disk_usage(fresh=True)
            if used < self.quota_bytes:
                return
            raise QuotaError(
                f"disk quota exceeded: store uses {used} of "
                f"{self.quota_bytes} quota bytes; writes to {table!r} "
                "refused (DELETE / DROP TABLE to reclaim)")

    @one_writer
    def delete_rows(self, table: str, pred) -> int:
        """Mark rows deleted (visimap-style) where pred(columns)->bool mask;
        pred receives decoded per-partition columns. Returns new version.

        OCC like every other manifest writer: the per-partition masks are
        computed outside the lock (file IO), and the commit only lands if
        the manifest version is still the one that was read — a concurrent
        append/compaction commit forces a re-read and re-apply, so neither
        side's partitions are silently dropped (last-writer-wins on the
        whole manifest was a lost-update bug under the write plane)."""
        for _ in range(50):
            man = self._head(table)
            tdir = os.path.join(self.root, table)
            for part in man["partitions"]:
                cols = mp.read_columns(os.path.join(tdir, part["file"]),
                                       cipher=self.cipher,
                                       verify=self.verify_checksums)
                mask = np.asarray(pred(cols))
                if mask.any():
                    dead = set(part["deleted"]) \
                        | set(np.nonzero(mask)[0].tolist())
                    part["deleted"] = sorted(dead)
            with self.lock():
                if self.current_version(table) == man["version"]:
                    return self._commit(table, man)
        raise RuntimeError(
            f"delete_rows({table!r}) kept losing the manifest OCC race")

    # --------------------------------------------------------------- reads

    def select_partitions(self, table: str, ranges: dict | None = None,
                          eqs: dict | None = None,
                          version: Optional[int] = None
                          ) -> tuple[list[dict], dict]:
        """Pick the partitions a predicate can touch, without reading any
        column data. ``ranges``: {col: (lo, hi)}; ``eqs``: {col: value}.
        Manifest min/max prunes first (no file IO); equality predicates then
        check footer bloom filters (footer-only IO). Returns (surviving
        partition entries, report) — the report counts candidates and
        skips per mechanism (for EXPLAIN and the file-skip tests)."""
        man = self.read_manifest(table, version)
        tdir = os.path.join(self.root, table)
        report = {"candidates": len(man["partitions"]),
                  "skipped_minmax": 0, "skipped_bloom": 0}
        ranges = dict(ranges or {})
        for c, v in (eqs or {}).items():
            lo, hi = ranges.get(c, (None, None))
            lo = v if lo is None else max(lo, v)
            hi = v if hi is None else min(hi, v)
            ranges[c] = (lo, hi)
        out = []
        for part in man["partitions"]:
            if ranges and not all(_part_may_match(part, c, lo, hi)
                                  for c, (lo, hi) in ranges.items()):
                report["skipped_minmax"] += 1
                continue
            if eqs and not self.bloom_may_match(
                    table, part, {c: [v] for c, v in eqs.items()}):
                report["skipped_bloom"] += 1
                continue
            out.append(part)
        return out, report

    def bloom_may_match(self, table: str, part: dict,
                        col_values: dict) -> bool:
        """One footer read answering: could this partition hold ANY of the
        given values in EVERY listed column? (False = provably not — the
        shared membership primitive for eq pruning and the partition
        selector.)"""
        footer = mp.read_footer(
            os.path.join(self.root, table, part["file"]),
            cipher=self.cipher)
        encs = {c["name"]: c for c in footer["columns"]}
        for col, vals in col_values.items():
            enc = encs.get(col)
            if enc is None:
                continue
            if not any(mp.bloom_may_contain(enc, v) for v in vals):
                return False
        return True

    def read_partitions(self, table: str, parts: list[dict],
                        columns: list[str] | None = None,
                        version: Optional[int] = None,
                        pool=None, on_decode=None) -> tuple[dict, dict]:
        """Read (selected columns of) the given partitions; "$nn:" validity
        columns split out. Returns (columns dict, validity dict).
        ``pool``/``on_decode`` ride through to the column decode
        (micropartition.read_columns) — the scan pipeline's
        column-parallel decode and its ``decode_seconds`` feed."""
        from cloudberry_tpu_torch.utils.faultinject import fault_point

        fault_point("store_read_partition")
        man = self.read_manifest(table, version)
        schema = Schema(tuple(mp._field_from_json(j) for j in man["schema"]))
        nullable = set(man.get("nullable", []))
        tdir = os.path.join(self.root, table)
        names = list(columns) if columns is not None else list(schema.names)
        want = names + [f"$nn:{c}" for c in names if c in nullable]
        chunks: list[dict[str, np.ndarray]] = []
        for part in parts:
            cols = mp.read_columns(os.path.join(tdir, part["file"]),
                                   want, cipher=self.cipher,
                                   pool=pool, on_decode=on_decode,
                                   verify=self.verify_checksums)
            if part["deleted"]:
                keep = np.ones(part["num_rows"], dtype=bool)
                keep[np.asarray(part["deleted"], dtype=np.int64)] = False
                cols = {k: v[keep] for k, v in cols.items()}
                cols["$n"] = int(keep.sum())
            else:
                cols["$n"] = part["num_rows"]
            chunks.append(cols)
        out, validity = {}, {}
        for name in want:
            arrs = []
            for c in chunks:
                a = c.get(name)
                if a is None:
                    # older partition without the validity column: all valid
                    a = np.ones(c["$n"], dtype=np.bool_)
                arrs.append(a)
            base = name[4:] if name.startswith("$nn:") else None
            f_dt = (np.bool_ if base is not None
                    else schema.field(name).type.np_dtype)
            col = (np.concatenate(arrs) if arrs
                   else np.zeros(0, dtype=f_dt))
            if base is not None:
                validity[base] = col
            else:
                out[name] = col
        return out, validity

    def scan(self, table: str, columns: list[str] | None = None,
             version: Optional[int] = None,
             prune: dict | None = None) -> tuple[dict, Schema, dict]:
        """Snapshot read. ``prune``: {col: (lo, hi)} ranges — partitions
        provably outside are skipped via footer stats.

        Returns (columns dict, schema, dicts); validity columns under
        their "$nn:<col>" names when present."""
        man = self.read_manifest(table, version)
        if man["schema"] is None:
            raise KeyError(f"table {table!r} has no data in store")
        schema = Schema(tuple(mp._field_from_json(j) for j in man["schema"]))
        parts, _ = self.select_partitions(table, prune, version=version)
        cols, validity = self.read_partitions(table, parts, columns,
                                              version=version)
        for c, v in validity.items():
            cols[f"$nn:{c}"] = v
        dicts = {k: StringDictionary(v) for k, v in man["dicts"].items()}
        return cols, schema, dicts

    # ------------------------------------------------------------ sequences
    # Durable, store-wide sequences (the gp_fastsequence / QD-owned nextval
    # analog): one JSON file guarded by the store lock; allocation is
    # write-through (nextval never rolls back — PostgreSQL semantics) and
    # every session on the root draws from the same number line.

    def _atomic_json(self, path: str, obj) -> None:
        """Durable atomic JSON replace (shared by sequences/matview defs,
        the topology record, and the compaction journal — same
        discipline as the manifest CURRENT swap)."""
        from cloudberry_tpu_torch.utils.faultinject import fault_point

        fault_point("io_atomic_json")
        iofault.atomic_json(path, obj, dirpath=self.root)

    def _seq_path(self) -> str:
        return os.path.join(self.root, "_SEQUENCES.json")

    def _read_sequences(self) -> dict:
        try:
            with open(self._seq_path()) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}

    def _write_sequences(self, seqs: dict) -> None:
        self._atomic_json(self._seq_path(), seqs)

    @one_writer
    def create_sequence(self, name: str, start: int = 1, increment: int = 1,
                        if_not_exists: bool = False) -> None:
        if increment == 0:
            raise ValueError("INCREMENT must not be zero")
        with self.lock():
            seqs = self._read_sequences()
            if name in seqs:
                if if_not_exists:
                    return
                raise ValueError(f"sequence {name!r} already exists")
            seqs[name] = {"next": int(start), "inc": int(increment)}
            self._write_sequences(seqs)

    @one_writer
    def drop_sequence(self, name: str, if_exists: bool = False) -> None:
        with self.lock():
            seqs = self._read_sequences()
            if name not in seqs:
                if if_exists:
                    return
                raise KeyError(f"unknown sequence {name!r}")
            del seqs[name]
            self._write_sequences(seqs)

    @one_writer
    def sequence_alloc(self, name: str) -> int:
        """Reserve and return the next value."""
        with self.lock():
            seqs = self._read_sequences()
            s = seqs.get(name)
            if s is None:
                raise KeyError(f"unknown sequence {name!r}")
            base = s["next"]
            s["next"] = base + s["inc"]
            self._write_sequences(seqs)
            return base

    @one_writer
    def sequence_setval(self, name: str, value: int) -> None:
        with self.lock():
            seqs = self._read_sequences()
            s = seqs.get(name)
            if s is None:
                raise KeyError(f"unknown sequence {name!r}")
            s["next"] = int(value) + s["inc"]
            self._write_sequences(seqs)

    def sequence_names(self) -> list[str]:
        return sorted(self._read_sequences())

    # --------------------------------------------------- matview definitions

    @one_writer
    def save_matviews(self, defs: dict) -> None:
        """Persist materialized-view definitions (full DDL text) — the
        gp_matview_aux catalog analog."""
        with self.lock():
            self._atomic_json(os.path.join(self.root, "_MATVIEWS.json"),
                              defs)

    def load_matviews(self) -> dict:
        try:
            with open(os.path.join(self.root, "_MATVIEWS.json")) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}

    # ------------------------------------------------------ session bridge

    @one_writer
    def save_table(self, t, rows_per_partition: int = 1 << 20) -> int:
        """Persist a catalog Table's current data as a fresh snapshot
        (one atomic commit). Records per-column uniqueness so cold
        registration can plan PK joins without loading data."""
        unique = {c: bool(t.is_unique(c)) for c in t.schema.names
                  if t.data.get(c) is not None
                  and t.data[c].dtype.kind in "iu"}
        v = self.append(t.name, t.data, t.schema, t.dicts, replace=True,
                        policy=t.policy, validity=t.validity,
                        unique=unique,
                        partition_spec=t.partition_spec,
                        rows_per_partition=rows_per_partition)
        if t.stats.ndv:
            # ANALYZE output survives the snapshot (deferred-commit path)
            v = self.save_stats(t.name, t.stats.ndv, t.stats.hist,
                                t.stats.analyzed_rows)
        return v

    @one_writer
    def drop_table(self, name: str) -> None:
        import shutil

        tdir = os.path.join(self.root, name)
        if os.path.isdir(tdir):
            shutil.rmtree(tdir)
            self._invalidate_usage()  # reclaim visible to the next quota check
            self._bump_epoch()

    def table_names(self) -> list[str]:
        out = []
        for name in sorted(os.listdir(self.root)):
            if os.path.isfile(os.path.join(self._mdir(name), "CURRENT")):
                out.append(name)
        return out

    @one_writer
    def save_stats(self, name: str, ndv: dict[str, int],
                   hist: dict | None = None,
                   analyzed_rows: int | None = None) -> int:
        """Persist ANALYZE output as a new manifest version (stats change
        is a catalog change — same atomic commit discipline). ``hist``:
        equi-depth histogram bounds per column (pg_statistic
        histogram_bounds role); ``analyzed_rows``: row count at ANALYZE
        time (the autostats change baseline)."""
        man = self._head(name)
        man["ndv"] = {k: int(v) for k, v in ndv.items()}
        if hist is not None:
            man["hist"] = {k: [float(x) for x in v]
                           for k, v in hist.items()}
        if analyzed_rows is not None:
            man["analyzed_rows"] = int(analyzed_rows)
        return self._commit(name, man)

    def register_cold(self, catalog, name: str,
                      version: Optional[int] = None):
        """Register a stored table WITHOUT loading data: schema, policy,
        dictionaries, nullability, row count, per-column min/max and
        uniqueness all come from the manifest (``version``'s, else the
        pinned or current one), so the planner can bind and
        prune scans against the cold table (the reference analog: catalog
        entries + pg_statistic exist without touching segment files)."""
        from cloudberry_tpu_torch.catalog.catalog import DistributionPolicy
        from cloudberry_tpu_torch.types import Field as TField

        man = self.read_manifest(name, version)
        if man["schema"] is None:
            return None
        nullable = set(man.get("nullable", []))
        not_null = set(man.get("not_null", []))
        fields = tuple(
            TField(j["name"],
                   mp._field_from_json(j).type,
                   nullable=j["name"] not in not_null)
            for j in man["schema"])
        pol = man.get("policy")
        policy = (DistributionPolicy(pol["kind"], tuple(pol["keys"]))
                  if pol else DistributionPolicy.random())
        from cloudberry_tpu_torch.catalog.catalog import Table

        t = Table(name, Schema(fields), policy)
        if man.get("partition_spec"):
            t.partition_spec = tuple(man["partition_spec"])
        t.data = {f.name: np.zeros(0, dtype=f.type.np_dtype)
                  for f in fields}
        catalog.adopt(t)  # no create_table: must not write a new snapshot
        t.backing = self
        t.cold = True
        t._store_version = man["version"]
        t.dicts = {k: StringDictionary(v) for k, v in man["dicts"].items()}
        # placeholder keys: the binder only needs to know WHICH columns are
        # nullable to emit scan mask fields; arrays load with the data
        t.validity = {c: np.zeros(0, dtype=np.bool_) for c in nullable}
        rows = 0
        mm: dict[str, tuple] = {}
        for p in man["partitions"]:
            rows += p["num_rows"] - len(p["deleted"])
            for c, (lo, hi) in p.get("stats", {}).items():
                if c.startswith("$nn:"):
                    continue
                old = mm.get(c)
                mm[c] = ((lo, hi) if old is None
                         else (min(old[0], lo), max(old[1], hi)))
        t.stats.row_count = rows
        t.stats.min_max = {c: (float(lo), float(hi))
                           for c, (lo, hi) in mm.items()}
        # uniqueness survives deletion (a subset of unique stays unique)
        t.stats.unique = {c: bool(u)
                          for c, u in man.get("unique", {}).items()}
        t.stats.ndv = {c: int(v) for c, v in man.get("ndv", {}).items()}
        t.stats.hist = {c: list(v) for c, v in man.get("hist", {}).items()}
        t.stats.analyzed_rows = int(man.get("analyzed_rows", -1))
        return t

    def load_table(self, catalog, name: str,
                   version: Optional[int] = None):
        """Materialize a stored table into a catalog (replaces data)."""
        from cloudberry_tpu_torch.catalog.catalog import DistributionPolicy

        data, schema, dicts = self.scan(name, version=version)
        validity = {k[4:]: v for k, v in data.items()
                    if k.startswith("$nn:")}
        data = {k: v for k, v in data.items() if not k.startswith("$nn:")}
        pol = self.read_manifest(name, version).get("policy")
        policy = (DistributionPolicy(pol["kind"], tuple(pol["keys"]))
                  if pol else DistributionPolicy.random())
        if name in catalog.tables:
            t = catalog.table(name)
            t.policy = policy
        else:
            t = catalog.create_table(name, schema, policy)
        t.dicts = dicts
        t.set_data(data, dicts, validity=validity)
        return t


def _partition_rows(spec, phys_data: dict, n: int):
    """Yield (pkey, row_indices) groups per the PARTITION BY spec — each
    group becomes partition-pure files whose manifest min/max stats are
    exact partition bounds (the reference keeps a partition catalog +
    PartitionSelector; here the stats ARE the partition metadata). Rows
    outside the declared RANGE land in a DEFAULT-partition analog."""
    if spec is None or n == 0:
        yield None, None
        return
    kind, col = spec[0], spec[1]
    vals = phys_data.get(col)
    if vals is None:  # partition column pruned out of this write — no route
        yield None, None
        return
    v = np.asarray(vals)
    if kind == "range":
        start, end, every = int(spec[2]), int(spec[3]), int(spec[4])
        # floor_divide BEFORE any int cast: truncation toward zero would
        # misroute negative fractional values into the wrong bucket
        if v.dtype.kind == "f":
            ids = np.floor_divide(v - start, every).astype(np.int64)
        else:
            ids = np.floor_divide(v.astype(np.int64) - start, every)
        nbuckets = -(-(end - start) // every)
        ids = np.where((v < start) | (v >= end), np.int64(-1), ids)
        for b in range(-1, nbuckets):
            idx = np.nonzero(ids == b)[0]
            if len(idx):
                yield ("default" if b < 0
                       else f"r{start + b * every}"), idx
    else:  # list
        for val in np.unique(v):
            idx = np.nonzero(v == val)[0]
            yield f"l{val}", idx


def _part_may_match(part: dict, col: str, lo, hi) -> bool:
    st = part.get("stats", {}).get(col)
    if st is None:
        return True
    if lo is not None and st[1] < lo:
        return False
    if hi is not None and st[0] > hi:
        return False
    return True
