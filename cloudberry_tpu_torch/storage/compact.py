"""Background compaction service — the VACUUM analog.

The streaming ingest plane (storage/ingest.py) and the online
rebalancer (parallel/topology.py) both grow a store's manifests
sideways: small appends become small partitions, DELETEs become delete
vectors, and a rebalance leaves destination-tagged (``"seg"`` /
``"seg_nseg"``) delta partitions that nothing folds back in. This
service is the fold: a lifecycle-scoped, breaker-guarded worker with
the rebalancer's exact shape — throttled chunks, ONE OCC-checked atomic
manifest commit per chunk, journal-resumable, conflict re-reads and
retries while concurrent appends keep serving — that

- merges delta partitions (grouped by (pkey, seg, seg_nseg): routing
  tags and partition-pruning keys are load-bearing, so merges never
  cross them),
- applies delete vectors (a rewritten partition carries none; a fully
  deleted partition simply disappears),
- re-sorts merged rows toward the table's scan order (the range/list
  partition column when one is declared), and
- re-packs toward ``storage.rows_per_partition``,

maintaining the bounded-delta invariant: a table's delta-partition
count (``delta_parts``: dirty partitions + mergeable small tails) is
driven back toward 0 whenever it exceeds ``config.compact.
max_delta_parts`` (hysteresis — once triggered, a table compacts to
clean, so the invariant holds with slack rather than oscillating at
the threshold).

Correctness story: compaction only REARRANGES committed live rows — a
compacted store answers every query bit-identically to its un-compacted
self (pinned across TPC-H in tests/test_compaction.py). Concurrency is
pure OCC: the chunk reads a manifest snapshot, writes replacement files
to fresh names, then commits under the store lock only if the version
it read is still current; a concurrent INSERT/DELETE/append wins the
race and the chunk re-reads and retries (bounded). Replaced partition
files are NOT unlinked — older manifest versions stay readable, the
same snapshot semantics the rebalancer keeps. Only never-committed
orphans (an OCC loss, or a crash between file write and commit) are
deleted — the latter by the ``_COMPACTION.json`` journal on restart.

Lock discipline: ``CompactionService._cond`` guards worker lifecycle
state only; it is NEVER held across manifest reads, file writes, or the
store lock.

The service is host work only (numpy and the store's files): it never
touches a device, so its thread runs beside the CUDA worker threads of
a server without a stream or a context of its own. The device caches
follow a committed compaction the way they follow DML: the commit is a
new store version with new partition file names, so the buffer pool's,
join-index's and store-scan cache's version-keyed entries stop
matching, and a session's ``_sync_store`` drops the table's device copy
and shard layouts at its next statement. The store format is the JAX
package's, and so are the journal and the file names.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid

import numpy as np

from cloudberry_tpu_torch import lifecycle
from cloudberry_tpu_torch.storage import iofault
from cloudberry_tpu_torch.utils.faultinject import fault_point

_JOURNAL = "_COMPACTION.json"


class CompactionError(lifecycle.StatementError):
    """The chunk loop kept losing the OCC race (adversarial writer) —
    transient by nature, retry once the write burst passes."""

    retryable = True


# --------------------------------------------------------- delta census


def _live(part: dict) -> int:
    return part["num_rows"] - len(part["deleted"])


def _group_key(part: dict):
    return (part.get("pkey"), part.get("seg"), part.get("seg_nseg"))


def delta_parts(man: dict, rows_per_partition: int,
                target_fill: float) -> int:
    """The bounded invariant's census for one table: partitions with
    delete vectors (each needs a rewrite) plus, per (pkey, seg,
    seg_nseg) group, every mergeable small tail beyond the one natural
    tail a healthy append pattern always has."""
    fill_rows = max(1, int(rows_per_partition * target_fill))
    dirty = 0
    smalls: dict = {}
    for p in man.get("partitions", ()):
        if p["deleted"]:
            dirty += 1
        elif _live(p) < fill_rows:
            k = _group_key(p)
            smalls[k] = smalls.get(k, 0) + 1
    return dirty + sum(max(0, n - 1) for n in smalls.values())


def _select_chunk(man: dict, fill_rows: int, cap: int):
    """Pick one group's worth of work: dirty partitions first, then
    small clean tails, capped at ``cap`` sources. A lone small clean
    tail is NOT work (merging it with itself forever is the classic
    compaction livelock); a lone dirty partition is (the rewrite drops
    its delete vector). Groups are visited in manifest order —
    deterministic, and old debt ages out first."""
    groups: dict = {}
    order = []
    for p in man.get("partitions", ()):
        k = _group_key(p)
        if k not in groups:
            groups[k] = []
            order.append(k)
        groups[k].append(p)
    for k in order:
        dirty = [p for p in groups[k] if p["deleted"]]
        small = [p for p in groups[k]
                 if not p["deleted"] and _live(p) < fill_rows]
        if not dirty and len(small) < 2:
            continue
        return k, (dirty + small)[:max(1, cap)]
    return None, []


# ------------------------------------------------------------- the merge


def _read_live(store, name: str, part: dict) -> dict:
    """One source partition's live rows, every physical column."""
    from cloudberry_tpu_torch.storage import micropartition as mp

    path = os.path.join(store.root, name, part["file"])
    cols = mp.read_columns(path, cipher=store.cipher,
                           verify=getattr(store, "verify_checksums", True))
    if part["deleted"]:
        keep = np.ones(part["num_rows"], dtype=bool)
        keep[np.asarray(part["deleted"], dtype=np.int64)] = False
        cols = {k: v[keep] for k, v in cols.items()}
    return cols


def _merge_columns(chunks: list[dict]) -> dict:
    """Concatenate per-file column dicts over the UNION of their
    physical columns. Files written before a column turned nullable
    lack its "$nn:" companion — those rows are all-valid by definition
    (ones), exactly the default the read path synthesizes. A missing
    DATA column would be schema drift this engine doesn't produce;
    refuse loudly rather than invent values."""
    names = []
    for c in chunks:
        for k in c:
            if k not in names:
                names.append(k)
    out = {}
    for k in names:
        pieces = []
        for c in chunks:
            v = c.get(k)
            if v is None:
                if not k.startswith("$nn:"):
                    raise CompactionError(
                        f"column {k!r} missing from a source partition "
                        "(schema drift) — refusing to merge")
                n = len(next(iter(c.values()))) if c else 0
                v = np.ones(n, dtype=np.bool_)
            pieces.append(np.asarray(v))
        out[k] = np.concatenate(pieces) if len(pieces) > 1 else pieces[0]
    return out


def _sort_for_scan(man: dict, cols: dict) -> dict:
    """Stable re-sort toward the table's declared scan order: the
    range/list partition column when present (partition pruning's
    min/max stats tighten the most there). No declared order is fine —
    merged rows keep source order (stable concatenation)."""
    spec = man.get("partition_spec")
    if not spec or len(spec) < 2:
        return cols
    key = spec[1]
    v = cols.get(key)
    if v is None or len(v) < 2:
        return cols
    order = np.argsort(np.asarray(v), kind="stable")
    return {k: np.ascontiguousarray(a[order]) for k, a in cols.items()}


class CompactionService:
    """The background fold. One instance per Server (or bare Session in
    tests); the ingest plane's ``on_commit`` pokes :meth:`wake` so debt
    from a write burst folds promptly, and the interval scan catches
    debt from DELETEs / rebalances that never touched ingest."""

    def __init__(self, session, exec_scope=None):
        cfg = session.config.compact
        self.session = session
        self.interval_s = max(0.05, float(cfg.interval_s))
        self.throttle_s = float(cfg.throttle_s)
        self.chunk_partitions = max(1, int(cfg.chunk_partitions))
        self.max_delta_parts = max(0, int(cfg.max_delta_parts))
        self.target_fill = float(cfg.target_fill)
        self._exec_scope = exec_scope  # parity with IngestService; the
        # chunk commit is pure OCC + store lock, so it does NOT take the
        # server write scope — holding it would stall foreground writes,
        # defeating the background contract
        self._cond = threading.Condition()
        self._stop = False
        self._thread = None
        self._wake = False
        self._last_delta_max = 0
        self.restore()

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        with self._cond:
            if self._thread is None and not self._stop:
                t = threading.Thread(target=self._worker,
                                     name="cbtpu_torch-compactor",
                                     daemon=True)
                self._thread = t
                t.start()

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            t, self._thread = self._thread, None
            self._cond.notify_all()
        if t is not None:
            t.join(timeout=10)

    def wake(self, table: str | None = None) -> None:
        """Called (outside any lock) after a committed ingest flush."""
        with self._cond:
            self._wake = True
            self._cond.notify_all()

    def _worker(self) -> None:
        log = getattr(self.session, "stmt_log", None)
        while True:
            with self._cond:
                if not (self._wake or self._stop):
                    self._cond.wait(timeout=self.interval_s)
                if self._stop:
                    return
                self._wake = False
            lifecycle.check_cancel()
            # breaker-guarded like planned cutover: a read-only-degraded
            # engine must not spend devices/IO on reorganization
            breaker = getattr(self.session, "_breaker", None)
            if breaker is not None \
                    and getattr(breaker, "state", "closed") == "open":
                continue
            try:
                self.run_once()
            except lifecycle.StatementCancelled:
                continue  # an operator cancelled one pass, not the service
            except Exception:  # noqa: BLE001 — the worker must survive
                if log is not None:
                    log.bump("compact_errors")

    # ----------------------------------------------------------- the scan

    def run_once(self, table: str | None = None,
                 force: bool = False) -> dict:
        """One full pass: every table over the invariant threshold
        (``force`` compacts regardless) is driven to a clean manifest.
        Returns the pass's counters; safe to call directly in tests."""
        store = getattr(self.session, "store", None)
        out = {"tables": 0, "chunks": 0, "rows": 0, "parts_merged": 0,
               "delta_parts_max": 0}
        if store is None:
            return out
        rpp = getattr(store, "rows_per_partition", 1 << 20)
        names = [table] if table is not None else sorted(
            store.table_names())
        worst = 0
        for name in names:
            man = store.read_manifest(name)
            if man["schema"] is None:
                continue
            dp = delta_parts(man, rpp, self.target_fill)
            if not force and dp <= self.max_delta_parts:
                worst = max(worst, dp)
                continue
            res = self._compact_table(name)
            out["tables"] += 1
            out["chunks"] += res["chunks"]
            out["rows"] += res["rows"]
            out["parts_merged"] += res["parts_merged"]
            worst = max(worst, delta_parts(
                store.read_manifest(name), rpp, self.target_fill))
        out["delta_parts_max"] = worst
        with self._cond:
            self._last_delta_max = worst
        return out

    def _compact_table(self, name: str) -> dict:
        """One table to clean, as ONE statement: the pass appears in the
        StatementLog / flight recorder / metrics exactly like foreground
        SQL, and ``stmt_log.cancel(sid)`` aborts it cooperatively at the
        next chunk seam (the pg_cancel_backend story holds for
        background work too)."""
        from cloudberry_tpu_torch.obs import flightrec

        log = getattr(self.session, "stmt_log", None)
        sql = f"COMPACT {name}"
        sid = log.begin(sql) if log is not None else 0
        handle = lifecycle.StatementHandle(sid)
        if log is not None:
            log.attach(sid, handle)
        t0 = time.monotonic()
        try:
            with lifecycle.statement_scope(handle):
                totals = self._run_chunks(name, handle)
        except BaseException as e:
            if log is not None:
                log.finish(sid, "error",
                           error=f"{type(e).__name__}: {e}")
                flightrec.maybe_capture(
                    self.session, sql, "error", time.monotonic() - t0,
                    handle, error=e)
            raise
        if log is not None:
            log.finish(sid, "ok", rows=totals["rows"])
            flightrec.maybe_capture(
                self.session, sql, "ok", time.monotonic() - t0, handle,
                counters={f"compact_{k}": v for k, v in totals.items()})
        return totals

    def _run_chunks(self, name: str, handle) -> dict:
        store = self.session.store
        log = getattr(self.session, "stmt_log", None)
        rpp = getattr(store, "rows_per_partition", 1 << 20)
        fill_rows = max(1, int(rpp * self.target_fill))
        totals = {"chunks": 0, "rows": 0, "parts_merged": 0}
        attempts = 0
        while True:
            handle.check()
            man = store.read_manifest(name)
            if man["schema"] is None:
                return totals
            key, parts = _select_chunk(man, fill_rows,
                                       self.chunk_partitions)
            if not parts:
                return totals
            # the chunk seam: 'hang' wedges here cooperatively (the
            # cancel-mid-chunk chaos case polls handle.check via the
            # statement scope); 'error'/'skip' perturb the loop
            fault_point("compact_chunk")
            ok, rows = self._merge_chunk(store, name, man, key, parts)
            if not ok:
                if log is not None:
                    log.bump("compact_conflicts")
                attempts += 1
                if attempts > 20:
                    raise CompactionError(
                        f"compaction of {name!r} kept losing the OCC "
                        "race; aborting (will retry next pass)")
                continue
            attempts = 0
            totals["chunks"] += 1
            totals["rows"] += rows
            totals["parts_merged"] += len(parts)
            if log is not None:
                log.bump("compact_chunks")
                log.bump("compact_rows", rows)
                log.bump("compact_parts_merged", len(parts))
            self._journal_progress(store, chunks=1, rows=rows,
                                   parts_merged=len(parts))
            if self.throttle_s > 0:
                time.sleep(self.throttle_s)

    # ----------------------------------------------------------- one chunk

    def _merge_chunk(self, store, name: str, man: dict, key,
                     parts: list[dict]) -> tuple[bool, int]:
        """Merge one group's sources into re-sorted, re-packed
        replacements; ONE atomic OCC-checked manifest commit. Returns
        (committed, live_rows); committed=False is the conflict signal
        (caller re-reads and retries). The journal's pending record
        brackets the file writes so a crash anywhere in between leaves
        only orphans a restart can identify and delete."""
        from cloudberry_tpu_torch.columnar.dictionary import StringDictionary
        from cloudberry_tpu_torch.storage import micropartition as mp
        from cloudberry_tpu_torch.types import BOOL, Field as TField, Schema

        pkey, seg, seg_nseg = key
        tdir = os.path.join(store.root, name)
        cols = _sort_for_scan(man, _merge_columns(
            [_read_live(store, name, p) for p in parts]))
        n_live = len(next(iter(cols.values()))) if cols else 0
        rpp = getattr(store, "rows_per_partition", 1 << 20)
        # physical schema: manifest data fields + "$nn:" bools (the
        # rebalancer's exact recipe, topology._move_partition_delta)
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
        plan = [(f"part-{uuid.uuid4().hex}.cbmp", lo,
                 min(lo + rpp, n_live))
                for lo in range(0, n_live, max(rpp, 1))]
        self._journal_pending(store, name, [f for f, _, _ in plan])
        new_entries = []
        try:
            for fname, lo, hi in plan:
                chunk = {k: np.ascontiguousarray(v[lo:hi])
                         for k, v in cols.items()}
                footer = mp.write_micropartition(
                    os.path.join(tdir, fname), chunk, phys_schema,
                    dicts, cipher=store.cipher)
                stats = {c["name"]: [c["min"], c["max"]]
                         for c in footer["columns"] if "min" in c}
                entry = {"file": fname, "num_rows": hi - lo,
                         "stats": stats, "deleted": []}
                if pkey is not None:
                    entry["pkey"] = pkey
                if seg is not None:
                    entry["seg"] = seg
                if seg_nseg is not None:
                    entry["seg_nseg"] = seg_nseg
                new_entries.append(entry)
            gone = {p["file"] for p in parts}
            with store.lock():
                # the crash-restart seam: an 'error' here dies AFTER the
                # replacement files exist but BEFORE the commit — the
                # journal's pending record is what makes that survivable
                fault_point("compact_commit")
                if store.current_version(name) != man["version"]:
                    for e in new_entries:
                        try:
                            os.unlink(os.path.join(tdir, e["file"]))
                        except FileNotFoundError:
                            pass  # already gone — nothing was lost
                        except OSError as exc:
                            # an undeletable orphan is an IO fault worth
                            # counting; fsck's GC sweep retries it later
                            iofault.note_io_error(e["file"], exc)
                    self._journal_pending(store, None, None)
                    return False, 0
                man["partitions"] = [p for p in man["partitions"]
                                     if p["file"] not in gone]
                man["partitions"] = man["partitions"] + new_entries
                store._commit(name, man)
        except BaseException:
            # pending stays set: the restart journal owns the cleanup
            raise
        self._journal_pending(store, None, None)
        return True, n_live

    # ------------------------------------------------------------- journal

    def _journal_path(self, store) -> str:
        return os.path.join(store.root, _JOURNAL)

    def _read_journal(self, store) -> dict:
        try:
            with open(self._journal_path(store)) as f:
                rec = json.load(f)
        except (FileNotFoundError, ValueError):
            rec = {}
        rec.setdefault("counters", {"chunks": 0, "rows": 0,
                                    "parts_merged": 0})
        rec.setdefault("pending", None)
        return rec

    def _journal_pending(self, store, table, files) -> None:
        rec = self._read_journal(store)
        rec["pending"] = ({"table": table, "files": list(files)}
                          if table is not None else None)
        # the journal's own durability seam: a crash here must leave
        # either the old or the new pending record, never torn JSON
        fault_point("io_journal_write")
        store._atomic_json(self._journal_path(store), rec)

    def _journal_progress(self, store, **deltas) -> None:
        rec = self._read_journal(store)
        for k, v in deltas.items():
            rec["counters"][k] = rec["counters"].get(k, 0) + v
        store._atomic_json(self._journal_path(store), rec)

    def restore(self) -> None:
        """Crash recovery, run at construction: a pending record names
        replacement files whose commit may or may not have happened —
        files absent from the table's CURRENT manifest are orphans from
        a pre-commit crash and are deleted; files present committed
        (the crash was after) and stay. Either way the store is clean
        and the next pass re-derives its work from the manifest —
        resumability without replaying anything."""
        store = getattr(self.session, "store", None)
        if store is None:
            return
        rec = self._read_journal(store)
        pend = rec.get("pending")
        if not pend:
            return
        name = pend["table"]
        try:
            man = store.read_manifest(name)
            committed = {p["file"] for p in man.get("partitions", ())}
        except Exception:  # noqa: BLE001 — table may be gone entirely
            committed = set()
        for f in pend.get("files", ()):
            if f not in committed:
                try:
                    os.unlink(os.path.join(store.root, name, f))
                except FileNotFoundError:
                    pass  # already gone — nothing to clean
                except OSError as exc:
                    iofault.note_io_error(f, exc)
        self._journal_pending(store, None, None)
        log = getattr(self.session, "stmt_log", None)
        if log is not None:
            log.bump("compact_journal_restores")

    # ------------------------------------------------------------ telemetry

    def delta_parts_gauge(self) -> int:
        """Last pass's worst per-table delta count (the capacity-plane
        gauge feed; a fresh manifest census per gauge refresh would be
        IO on the telemetry path)."""
        with self._cond:
            return self._last_delta_max

    def snapshot(self) -> dict:
        """``meta "compaction"``: config, live per-table census, counter
        story, and the journal's durable progress in one read."""
        store = getattr(self.session, "store", None)
        with self._cond:
            running = self._thread is not None and not self._stop
        out = {"enabled": True, "running": running,
               "interval_s": self.interval_s,
               "throttle_s": self.throttle_s,
               "chunk_partitions": self.chunk_partitions,
               "max_delta_parts": self.max_delta_parts,
               "target_fill": self.target_fill,
               "tables": []}
        if store is not None:
            rpp = getattr(store, "rows_per_partition", 1 << 20)
            for name in sorted(store.table_names()):
                man = store.read_manifest(name)
                if man["schema"] is None:
                    continue
                out["tables"].append(
                    {"table": name,
                     "partitions": len(man["partitions"]),
                     "delta_parts": delta_parts(man, rpp,
                                                self.target_fill)})
            out["journal"] = self._read_journal(store)["counters"]
        log = getattr(self.session, "stmt_log", None)
        if log is not None:
            for c in ("compact_chunks", "compact_rows",
                      "compact_parts_merged", "compact_conflicts",
                      "compact_errors", "compact_journal_restores"):
                out[c.replace("compact_", "")] = log.counter(c)
        return out
