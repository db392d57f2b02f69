"""Session — the QD (query dispatcher) analog, single segment.

``sql()`` runs the pipeline: parse → bind/plan → execute on the session's
device. A Session with no device runs on CUDA and raises when no CUDA
device is available; it never moves to the CPU by itself. The tests ask
for ``device="cpu"``, which runs the kernels' plain versions.

A join-expansion overflow (more match pairs than the planner's estimate)
grows the join's pair buffer and runs the statement again
(``growth_events`` counts the growths). The reference also re-checks
admission and may fall back to tiled execution there; the port has
neither yet, so it only grows and retries.

Durable storage: with ``config.storage.root`` set, the session opens the
store (storage/table_store.py), registers every stored table COLD (schema
and statistics from its manifest, no data read), and binds the catalog so
new tables persist. Scans of a cold table read only the partitions that
survive pruning, only the referenced columns (plan/scanprune.py), through
the device buffer pool and a per-session store-scan LRU
(exec/executor.py). Every statement first picks up other sessions'
commits (``_sync_store``). The store runs in autocommit mode.

``counters`` holds the session's storage-path counts: partitions decoded,
store-scan cache and buffer-pool traffic, join-index builds and hits.

Not ported yet: more than one segment, generic plans, transactions (BEGIN
raises ``NotImplementedError``), materialized views, tiled (out-of-core)
execution, admission control, serving and the metrics plane.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np
import torch

from cloudberry_tpu_torch.config import Config, get_config


class Counters:
    """Named event counts (the storage path's subset of the JAX
    package's StatementLog counters), safe across threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)


class Session:
    def __init__(self, config: Config | None = None, device=None):
        from cloudberry_tpu_torch.catalog.catalog import Catalog

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
            if self.config.storage.encryption_key:
                from cloudberry_tpu_torch.utils.tde import make_cipher

                self.store.cipher = make_cipher(
                    self.config.storage.encryption_key)
            for name in self.store.table_names():
                self.store.register_cold(self.catalog, name)
            self.catalog.store = self.store
            self._seen_epoch = self.store.epoch()
        # per-query pruned store reads as device tensors, keyed (table,
        # version, parts, cols, device) — an LRU under its own lock
        self._store_scan_cache: dict = {}
        self._store_scan_lock = threading.Lock()
        self._sync_lock = threading.Lock()
        # device copies of RAM tables: name -> (table version, columns)
        self._device_tables: dict[str, tuple[int, dict]] = {}
        # join-expansion buffers grown by statement retries
        self.growth_events = 0
        self.counters = Counters()
        # COPY ... LOG ERRORS row rejects, per table (the error-log /
        # gp_read_error_log analog, cdbsreh.c)
        self.copy_errors: dict[str, list] = {}
        # the cache scope (sched/sharedcache.py): sessions over one store
        # root share the join-index cache and the buffer pool
        from cloudberry_tpu_torch.sched import sharedcache

        self._cache_scope = sharedcache.scope_for(self)

    def sql(self, query: str, **params: Any):
        """Run one statement: DDL/DML returns its status string, a SELECT
        its ColumnBatch."""
        from cloudberry_tpu_torch.plan.planner import plan_statement
        from cloudberry_tpu_torch.sql.parser import parse_sql

        self._sync_store()
        result = plan_statement(parse_sql(query), self, params)
        if result.is_ddl:
            return result.ddl_result
        return self._run_with_growth(result.plan)

    def read_error_log(self, table: str):
        """Rejected rows recorded by COPY ... LOG ERRORS for ``table``
        (the gp_read_error_log() analog): DataFrame of
        line/errmsg/rawdata. Needs pandas, imported here only."""
        import pandas as pd

        return pd.DataFrame(self.copy_errors.get(table.lower(), []),
                            columns=["line", "errmsg", "rawdata"])

    def _sync_store(self) -> None:
        """Pick up OTHER sessions' committed changes at statement start:
        any table whose store version moved re-registers cold; new tables
        appear, dropped ones vanish. The table's device copy
        (``device_table``) and its store-scan cache entries are dropped
        with the old version — they could never serve again, and they
        hold device memory. Manifests ARE the catalog of record."""
        if self.store is None:
            return
        with self._sync_lock:
            from cloudberry_tpu_torch.utils.faultinject import fault_point

            fault_point("sync_store")
            # fast path: one epoch read; the per-table walk only runs when
            # SOMETHING changed since this session last looked
            epoch = self.store.epoch()
            if epoch == getattr(self, "_seen_epoch", None):
                return
            self._seen_epoch = epoch
            names = set(self.store.table_names())
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
                v = self.store.current_version(name)
                if v != getattr(t, "_store_version", None):
                    del self.catalog.tables[name]
                    self.store.register_cold(self.catalog, name)
                    stale.add(name)
            for name in sorted(names - set(self.catalog.tables)):
                self.store.register_cold(self.catalog, name)
            self._drop_table_caches(stale)

    def _drop_table_caches(self, names) -> None:
        """Forget the device copies and store-scan cache entries of
        ``names`` (their versions moved)."""
        if not names:
            return
        for name in names:
            self._device_tables.pop(name, None)
        with self._store_scan_lock:
            for key in [k for k in self._store_scan_cache
                        if k[0] in names]:
                del self._store_scan_cache[key]

    def _run_with_growth(self, plan):
        """Execute; on a detected join-expansion overflow, grow the pair
        buffer and retry — adaptive capacity, never truncation
        (exec/executor.py:grow_expansion). Six growths at most (4x each),
        then a last run whose error surfaces."""
        from cloudberry_tpu_torch.exec.executor import (ExecError, execute,
                                                        grow_expansion)

        for _ in range(6):
            try:
                return execute(plan, self)
            except ExecError as e:
                if not grow_expansion(plan, str(e), allow_fallback=True):
                    raise
                self.growth_events += 1
        return execute(plan, self)

    def explain(self, query: str) -> str:
        """The plan text of a statement, without running it (one
        segment: no distribution annotation)."""
        from cloudberry_tpu_torch.plan.planner import plan_statement
        from cloudberry_tpu_torch.sql.parser import parse_sql

        self._sync_store()
        result = plan_statement(parse_sql(query), self, {},
                                explain_only=True)
        if result.is_ddl:
            return str(result.ddl_result)
        return result.plan.explain()

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
