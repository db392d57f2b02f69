"""Typed configuration tree — the GUC system analog.

The reference keeps ~6k lines of GUCs (``src/backend/utils/misc/guc_gp.c``).
Here configuration is a typed, immutable dataclass tree; a session carries
one, and ``with_overrides`` produces a modified copy. This port carries the
fields its single-segment slice reads: the planner's, durable storage, the
device buffer pool and the join-index cache size. There is no counterpart
of the JAX package's ``exec.use_pallas``: the kernel gates are decided by
the plan's shapes alone, and on a CUDA device the hand-written kernels
always run.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class PlannerConfig:
    """Planner settings the single-segment slice reads."""

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
    """The join-index cache (exec/joinindex.py). The JAX package's
    runtime join-filter digests are a multi-segment feature and are not
    carried."""

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
class Config:
    planner: PlannerConfig = field(default_factory=PlannerConfig)
    join_filter: JoinFilterConfig = field(default_factory=JoinFilterConfig)
    bufferpool: BufferPoolConfig = field(default_factory=BufferPoolConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)

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
