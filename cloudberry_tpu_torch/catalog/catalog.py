"""Catalog — tables, schemas, distribution policies.

The MPP catalog analog: the reference records how every table is spread over
segments in ``gp_distribution_policy`` (hash keys / randomly / replicated)
and the cluster layout in ``gp_segment_configuration`` (SURVEY.md §2.1
"Catalog extensions"). Here a ``DistributionPolicy`` hangs off each table and
drives the planner's locus assignment; placement uses the same
jump-consistent-hash discipline as cdbhash.c:55 so elastic resize moves
minimal data.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal, Optional

import numpy as np

import itertools
import threading

from cloudberry_tpu_torch.columnar.dictionary import StringDictionary
from cloudberry_tpu_torch.types import Schema
from cloudberry_tpu_torch.utils import hashing


@dataclass(frozen=True)
class DistributionPolicy:
    kind: Literal["hashed", "random", "replicated"]
    keys: tuple[str, ...] = ()

    @staticmethod
    def hashed(*keys: str) -> "DistributionPolicy":
        return DistributionPolicy("hashed", tuple(keys))

    @staticmethod
    def replicated() -> "DistributionPolicy":
        return DistributionPolicy("replicated")

    @staticmethod
    def random() -> "DistributionPolicy":
        return DistributionPolicy("random")


@dataclass
class TableStats:
    row_count: int = 0
    # per-column (min, max) over numeric/date columns — scan pruning + costing
    min_max: dict[str, tuple[float, float]] = field(default_factory=dict)
    # lazily-computed per-column uniqueness (PK detection for join planning)
    unique: dict[str, bool] = field(default_factory=dict)
    # number of distinct values per column (the pg_statistic n_distinct
    # analog) — computed lazily or by ANALYZE; drives join/group costing
    ndv: dict[str, int] = field(default_factory=dict)
    # equi-depth histogram bounds per numeric column (the pg_statistic
    # histogram_bounds analog): N+1 ascending values splitting the valid
    # rows into N equal-count buckets — range selectivity interpolates
    # within the containing bucket instead of assuming a uniform [min,max]
    hist: dict[str, list] = field(default_factory=dict)
    # row count at the last ANALYZE (-1 = never) — the autostats trigger
    # compares against it (gp_autostats_mode, autostats.c:283)
    analyzed_rows: int = -1


@dataclass
class Table:
    name: str
    schema: Schema
    policy: DistributionPolicy
    data: dict[str, np.ndarray] = field(default_factory=dict)   # host columns
    dicts: dict[str, StringDictionary] = field(default_factory=dict)
    stats: TableStats = field(default_factory=TableStats)
    # per-column validity (True = value present); absent column = no NULLs.
    # Invariant: data values are canonicalized to 0 at invalid lanes, so
    # hashing/placement/grouping see a stable representative.
    validity: dict[str, np.ndarray] = field(default_factory=dict)

    # durable storage binding (storage/table_store.py). cold=True means the
    # data lives ONLY in micro-partition files: scans read pruned partitions
    # per query; ensure_loaded() materializes for paths that need RAM arrays
    backing: object = None
    cold: bool = False
    # PARTITION BY spec (gp_partition_template analog): stored writes route
    # rows into partition-pure micro-partition files so manifest min/max
    # stats become exact partition bounds — elimination needs no separate
    # partition catalog. ('range', col, start, end, every) | ('list', col)
    partition_spec: tuple | None = None

    @property
    def num_rows(self) -> int:
        return self.stats.row_count

    def ensure_loaded(self) -> None:
        """Materialize a cold stored table into RAM (DML paths and
        distributed placement need whole arrays)."""
        if not self.cold or self.backing is None:
            return
        cols, _, dicts = self.backing.scan(self.name)
        validity = {k[4:]: v for k, v in cols.items()
                    if k.startswith("$nn:")}
        data = {k: v for k, v in cols.items() if not k.startswith("$nn:")}
        self._loading = True
        try:
            self.set_data(data, dicts, validity=validity)
        finally:
            self._loading = False
        self.cold = False

    def set_data(self, data: dict[str, np.ndarray],
                 dicts: dict[str, StringDictionary] | None = None,
                 validity: dict[str, np.ndarray] | None = None,
                 appended: int | None = None) -> None:
        # a refused persist (disk quota, full disk) must not leave RAM
        # ahead of the store — capture enough to restore on failure
        import copy as _copy

        _prev = (self.data, self.dicts, self.validity,
                 _copy.deepcopy(self.stats), getattr(self, "_version", 0),
                 self.cold)
        try:
            self._set_data_inner(data, dicts, validity, appended)
        except Exception:
            (self.data, self.dicts, self.validity, self.stats,
             self._version, self.cold) = _prev
            raise

    def _set_data_inner(self, data: dict[str, np.ndarray],
                        dicts: dict[str, StringDictionary] | None = None,
                        validity: dict[str, np.ndarray] | None = None,
                        appended: int | None = None) -> None:
        self.data = data
        self.dicts = dicts or {}
        n = len(next(iter(data.values()))) if data else 0
        self.stats.row_count = n
        self.stats.unique = {}
        self.stats.ndv = {}
        self.validity = {}
        no_change = appended == 0  # zero-row append: skip persistence
        if no_change:
            appended = None
        for c, v in (validity or {}).items():
            v = np.asarray(v, dtype=np.bool_)
            if c in data and not v.all():
                self.validity[c] = v
                # canonical zero at NULL lanes (placement/grouping stability)
                data[c] = np.where(v, data[c],
                                   np.zeros((), dtype=data[c].dtype))
        # globally-unique version: a DROP+CREATE+INSERT sequence must never
        # reproduce an old version (statement caches key on it)
        self._version = next(_VERSION_COUNTER)
        for f in self.schema.fields:
            arr = data.get(f.name)
            if arr is not None and arr.dtype.kind in "if" and n:
                vm = self.validity.get(f.name)
                vals = arr[vm] if vm is not None else arr
                if len(vals):
                    self.stats.min_max[f.name] = (float(vals.min()),
                                                  float(vals.max()))
        # durable tables: every data change is a new atomic snapshot; an
        # append-only change persists just the new tail partitions (the
        # port runs the store in autocommit mode: no transactions yet)
        if self.backing is not None and not getattr(self, "_loading", False) \
                and not no_change:
            if appended is not None and appended < n:
                k = appended
                # refresh persisted uniqueness incrementally: a previously
                # unique column stays unique iff the appended tail has no
                # internal dups and no overlap with the head (O(N) isin,
                # not a full O(N log N) re-sort per statement)
                prev = self.backing.read_manifest(self.name) \
                    .get("unique", {})
                unique = dict(prev)
                for c, flag in prev.items():
                    arr = data.get(c)
                    if arr is None or not flag:
                        continue
                    tail, head = arr[n - k:], arr[:n - k]
                    unique[c] = bool(
                        len(np.unique(tail)) == len(tail)
                        and not np.isin(tail, head).any())
                self._store_version = self.backing.append(
                    self.name, {c: v[-k:] for c, v in data.items()},
                    self.schema, self.dicts,
                    validity={c: v[-k:] for c, v in self.validity.items()},
                    unique=unique,
                    policy=self.policy,
                    rows_per_partition=self.backing.rows_per_partition)
            else:
                self._store_version = self.backing.save_table(
                    self, getattr(self.backing, "rows_per_partition",
                                  1 << 20))
            self.cold = False

    def ndv(self, col: str) -> Optional[int]:
        """Distinct-value count for costing (exact; computed lazily and
        cached — the auto-ANALYZE stance, autostats.c:283). Cold tables
        only report manifest-persisted values (ANALYZE writes them)."""
        cached = self.stats.ndv.get(col)
        if cached is not None:
            return cached
        if self.cold:
            return None
        arr = self.data.get(col)
        if arr is None or arr.dtype.kind not in "iufb" \
            or self.stats.row_count == 0:
            return None
        n = int(len(np.unique(arr)))
        self.stats.ndv[col] = n
        return n

    HIST_BUCKETS = 64

    def analyze(self) -> dict[str, int]:
        """Collect NDV and equi-depth histograms for every numeric column
        (the distributed-ANALYZE analog, analyze.c:31 — strings count
        distinct dictionary codes; histogram role: pg_statistic
        histogram_bounds) and persist into the manifest if durable."""
        self.ensure_loaded()
        for f in self.schema.fields:
            arr = self.data.get(f.name)
            if arr is None or arr.dtype.kind not in "iufb" \
                    or not self.stats.row_count:
                continue
            self.stats.ndv[f.name] = int(len(np.unique(arr)))
            if arr.dtype.kind in "iuf":
                # valid rows only: canonical-zero NULL fills would put a
                # false spike at 0
                vm = self.validity.get(f.name)
                vals = arr[vm] if vm is not None and len(vm) == len(arr) \
                    else arr
                if len(vals):
                    qs = np.linspace(0.0, 1.0, self.HIST_BUCKETS + 1)
                    self.stats.hist[f.name] = [
                        float(v) for v in np.quantile(vals, qs)]
        self.stats.analyzed_rows = int(self.stats.row_count)
        # fresh stats change plan choices (selectivity, memo motion
        # costing): bump the STATS version so cached compiled statements
        # re-plan — deliberately not _version, which OCC snapshots watch
        # (an ANALYZE must never abort a concurrent writer)
        self._stats_version = next(_VERSION_COUNTER)
        if self.backing is not None:
            self._store_version = \
                self.backing.save_stats(self.name, self.stats.ndv,
                                        self.stats.hist,
                                        self.stats.analyzed_rows)
        return dict(self.stats.ndv)

    def is_unique(self, col: str) -> bool:
        """Whether a column's values are distinct (PK detection; the planner
        uses this the way nodeHash.c trusts unique-ified hash sides). Lazy +
        cached; recomputed when data changes (set_data clears the cache)."""
        if self.cold:
            # data not in RAM: only manifest-recorded uniqueness counts
            return bool(self.stats.unique.get(col, False))
        cached = self.stats.unique.get(col)
        if cached is None:
            arr = self.data.get(col)
            if arr is None or arr.dtype.kind not in "iuf" \
                    or col in self.validity:
                cached = False  # nullable columns never count as PKs
            else:
                cached = bool(len(np.unique(arr)) == len(arr))
            self.stats.unique[col] = cached
        return cached

    def is_unique_cols(self, cols: tuple[str, ...]) -> bool:
        """Exact multi-column uniqueness (composite PK detection, e.g.
        partsupp's (ps_partkey, ps_suppkey)) — lexsort + adjacent compare."""
        if self.cold:
            # conservative without RAM data (single-column manifests only)
            return any(bool(self.stats.unique.get(c, False)) for c in cols)
        key = "|".join(sorted(cols))
        cached = self.stats.unique.get(key)
        if cached is None:
            arrs = [self.data.get(c) for c in cols]
            if any(a is None or a.dtype.kind not in "iuf" for a in arrs) \
                    or any(c in self.validity for c in cols):
                cached = False
            elif self.stats.row_count == 0:
                cached = True
            else:
                order = np.lexsort(tuple(arrs))
                eq = np.ones(len(order) - 1, dtype=bool)
                for a in arrs:
                    s_ = a[order]
                    eq &= s_[1:] == s_[:-1]
                cached = not bool(eq.any())
            self.stats.unique[key] = cached
        return cached

    def to_pandas(self):
        """Decode the (already physically-encoded) table data to pandas;
        NULL lanes render as None."""
        import pandas as pd

        from cloudberry_tpu_torch.columnar.batch import decode_column

        out = {}
        for f in self.schema.fields:
            col = decode_column(np.asarray(self.data[f.name]), f, self.dicts)
            vm = self.validity.get(f.name)
            if vm is not None:
                col = np.asarray(col, dtype=object)
                col[~vm] = None
            out[f.name] = col
        return pd.DataFrame(out)

    def shard_assignment(self, n_segments: int) -> Optional[np.ndarray]:
        """Segment id per row (None for replicated tables).

        Hash-distributed: jump_consistent_hash over the distribution keys —
        minimal movement on resize (gpexpand analog). Random ('Strewn' locus):
        round-robin.
        """
        if self.policy.kind == "replicated":
            return None
        n = self.stats.row_count
        if self.policy.kind == "random":
            return (np.arange(n) % n_segments).astype(np.int32)
        cols = [self.data[k] for k in self.policy.keys]
        h = hashing.hash_columns_np([np.asarray(c) for c in cols])
        return hashing.jump_consistent_hash_np(h, n_segments)


_VERSION_COUNTER = itertools.count(1)


class Catalog:
    def __init__(self):
        self.tables: dict[str, Table] = {}
        # durable store (storage/table_store.py) when the session is
        # storage-backed; new tables bind to it at CREATE
        self.store = None
        # name -> unbound query AST (views re-bind per statement, so they
        # track base-table changes like the reference's rewriter)
        self.views: dict[str, object] = {}
        # bumped on any DDL that can change name resolution (view create/
        # drop, table create/drop) — statement caches key on it
        self.ddl_version: int = 0
        # sequences (gp_fastsequence / '?'-message analog): storeless
        # sessions keep state here; store-backed sessions delegate every
        # allocation to the store's locked _SEQUENCES.json so all sessions
        # draw from one coordinator-owned number line. nextval never rolls
        # back (PostgreSQL semantics) — deliberately outside txn snapshots.
        self.sequences: dict[str, dict] = {}
        # materialized views (not yet ported): always empty here, so the
        # planner's maintenance hooks have nothing to do
        self.matviews: dict[str, object] = {}
        self._seq_currval: dict[str, int] = {}  # session-local currval
        # storeless allocation is read-modify-write on shared session
        # state — server handler threads share one Session, so it needs
        # its own lock (the store path is covered by the store file lock)
        self._seq_lock = threading.Lock()

    def bump_ddl(self) -> None:
        self.ddl_version += 1

    # ------------------------------------------------------------ sequences

    def create_sequence(self, name: str, start: int = 1, increment: int = 1,
                        if_not_exists: bool = False) -> None:
        name = name.lower()
        if increment == 0:
            raise ValueError("INCREMENT must not be zero")
        if self.store is not None:
            self.store.create_sequence(name, start, increment, if_not_exists)
            return
        with self._seq_lock:
            if name in self.sequences:
                if if_not_exists:
                    return
                raise ValueError(f"sequence {name!r} already exists")
            self.sequences[name] = {"next": int(start),
                                    "inc": int(increment)}

    def drop_sequence(self, name: str, if_exists: bool = False) -> None:
        name = name.lower()
        if self.store is not None:
            self.store.drop_sequence(name, if_exists)
            self._seq_currval.pop(name, None)
            return
        with self._seq_lock:
            if name not in self.sequences:
                if if_exists:
                    return
                raise KeyError(f"unknown sequence {name!r}")
            del self.sequences[name]
        self._seq_currval.pop(name, None)

    def seq_nextval(self, name: str) -> int:
        """Allocate the next value — the segments-fetch-from-the-QD
        protocol (postgres.c '?' message, cdb_sequence_nextval_qe): the
        coordinator owns the number line; here that is the locked store
        file (durable) or this catalog under its own lock."""
        name = name.lower()
        if self.store is not None:
            base = self.store.sequence_alloc(name)
        else:
            with self._seq_lock:
                s = self.sequences.get(name)
                if s is None:
                    raise KeyError(f"unknown sequence {name!r}")
                base = s["next"]
                s["next"] = base + s["inc"]
        self._seq_currval[name] = base
        return base

    def seq_currval(self, name: str) -> int:
        name = name.lower()
        v = self._seq_currval.get(name)
        if v is None:
            raise ValueError(
                f"currval of sequence {name!r} is not yet defined in "
                "this session")
        return v

    def seq_setval(self, name: str, value: int) -> int:
        name = name.lower()
        if self.store is not None:
            self.store.sequence_setval(name, value)
        else:
            with self._seq_lock:
                s = self.sequences.get(name)
                if s is None:
                    raise KeyError(f"unknown sequence {name!r}")
                s["next"] = int(value) + s["inc"]
        self._seq_currval[name] = int(value)
        return int(value)

    def adopt(self, t: "Table") -> "Table":
        """Register an externally-constructed table (store registration)
        without the CREATE-time persistence side effects."""
        t._version = next(_VERSION_COUNTER)
        self.tables[t.name] = t
        self.bump_ddl()
        return t

    def create_table(self, name: str, schema: Schema,
                     policy: DistributionPolicy | None = None,
                     if_not_exists: bool = False,
                     partition_spec: tuple | None = None,
                     durable: bool = True, bump: bool = True) -> Table:
        name = name.lower()
        if name in self.tables:
            if if_not_exists:
                return self.tables[name]
            raise ValueError(f"table {name!r} already exists")
        t = Table(name, schema, policy or DistributionPolicy.random())
        if partition_spec is not None:
            if partition_spec[1] not in schema.names:
                raise ValueError(
                    f"partition column {partition_spec[1]!r} is not a "
                    "column of the table")
            t.partition_spec = partition_spec
        # empty columns from the start so scans of unpopulated tables work
        t.data = {f.name: np.zeros(0, dtype=f.type.np_dtype)
                  for f in schema.fields}
        t._version = next(_VERSION_COUNTER)
        if self.store is not None and durable:
            t.backing = self.store
            # durable schema from CREATE on
            t._store_version = self.store.save_table(t)
        self.tables[name] = t
        if bump:
            # bump=False: transient tables (table functions) are invisible
            # to SQL names, so creating one must not evict every cached
            # compiled statement via the ddl version
            self.bump_ddl()
        return t

    def drop_table(self, name: str, if_exists: bool = False) -> None:
        name = name.lower()
        if name not in self.tables and if_exists:
            return
        t = self.tables[name]
        if t.backing is not None:
            t.backing.drop_table(name)
        del self.tables[name]
        self.bump_ddl()

    def table(self, name: str) -> Table:
        t = self.tables.get(name.lower())
        if t is None:
            raise KeyError(f"unknown table {name!r}")
        return t
