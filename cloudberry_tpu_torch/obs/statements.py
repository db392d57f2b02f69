"""Per-skeleton statement aggregates — the pg_stat_statements analog.

The reference normalizes queries to a fingerprint and aggregates calls /
time / rows per fingerprint in shared memory; here the fingerprint is the
generic-plan SKELETON (sched/paramplan.normalize — the same key the plan
cache uses, so "one row" means "one compiled shape"), and the aggregates
ride the finished statement-history entries the StatementLog already
produces: every ``finish()`` feeds ``observe()``.

Per row: calls, errors, rows, total/mean wall (plus a bounded log2
histogram for p95), compiles, generic hits (zero-compile executions of a
parameterized skeleton), recoveries, and wire bytes (stamped by the
serving layer per response). The table is bounded: past ``max_rows``
skeletons the least-recently-updated row is evicted — like the
reference's pg_stat_statements.max dealloc.
"""

from __future__ import annotations

import threading

from cloudberry_tpu_torch.obs.metrics import _Hist


# text → skeleton memo (repeated texts skip the tokenize; bounded by a
# wholesale clear — GIL-atomic dict ops, a racing clear only costs a
# re-tokenize)
_skel_cache: dict = {}
_SKEL_CACHE_MAX = 2048


def skeleton_of(sql: str) -> str:
    """The aggregation key: the generic-plan skeleton when the statement
    normalizes, else the (truncated) text itself."""
    hit = _skel_cache.get(sql)
    if hit is not None:
        return hit
    try:
        from cloudberry_tpu_torch.sched.paramplan import normalize

        norm = normalize(sql)
    except Exception:  # pragma: no cover - lexer drift
        norm = None
    out = norm[0][:500] if norm is not None else sql.strip()[:500]
    if len(_skel_cache) >= _SKEL_CACHE_MAX:
        _skel_cache.clear()
    _skel_cache[sql] = out
    return out


class _Row:
    __slots__ = ("calls", "errors", "rows", "wall", "compiles",
                 "generic_hits", "recoveries", "wire_bytes", "hist")

    def __init__(self):
        self.calls = 0
        self.errors = 0
        self.rows = 0
        self.wall = 0.0
        self.compiles = 0
        self.generic_hits = 0
        self.recoveries = 0
        self.wire_bytes = 0
        self.hist = _Hist()


class StatementStats:
    """Bounded per-skeleton aggregate table (leaf lock — nothing is
    called while it is held)."""

    def __init__(self, max_rows: int = 256):
        self.max_rows = max_rows
        self._lock = threading.Lock()
        self._rows: dict[str, _Row] = {}
        self.evicted = 0

    def _row(self, key: str) -> _Row:
        """LRU row fetch/insert (callers hold the lock): a touch moves
        the row to the dict tail, inserts past the bound evict the
        head — the least recently UPDATED skeleton."""
        row = self._rows.pop(key, None)
        if row is None:
            row = _Row()
            while len(self._rows) >= self.max_rows:
                self._rows.pop(next(iter(self._rows)))
                self.evicted += 1
        self._rows[key] = row
        return row

    def observe(self, entry: dict) -> None:
        """Fold one finished statement-history entry (StatementLog
        finish()) into its skeleton's aggregates."""
        sql = entry.get("sql") or ""
        if not sql:
            return
        row_count = entry.get("rows", -1)
        wall = float(entry.get("wall_s", 0.0))
        key = skeleton_of(sql)  # tokenizes — stays outside the lock
        with self._lock:
            row = self._row(key)
            row.calls += 1
            if entry.get("status") == "error":
                row.errors += 1
            if isinstance(row_count, int) and row_count > 0:
                row.rows += row_count
            row.wall += wall
            row.hist.add(wall)
            row.compiles += int(entry.get("compiles", 0) or 0)
            row.generic_hits += int(entry.get("generic_hits", 0) or 0)
            row.recoveries += int(entry.get("attempts", 0) or 0)

    def add_wire(self, sql: str, nbytes: int) -> None:
        """Wire bytes for one response, attributed to the statement's
        skeleton (stamped by the serving layer after rendering)."""
        key = skeleton_of(sql)
        with self._lock:
            self._row(key).wire_bytes += int(nbytes)

    def snapshot(self, limit: int = 50) -> list[dict]:
        """Rows by total wall time, heaviest first (the
        pg_stat_statements ordering people actually use)."""
        with self._lock:
            items = [(k, r) for k, r in self._rows.items()]
            out = []
            for key, r in items:
                calls = max(r.calls, 1)
                out.append({
                    "query": key,
                    "calls": r.calls,
                    "errors": r.errors,
                    "rows": r.rows,
                    "total_wall_s": round(r.wall, 6),
                    "mean_wall_s": round(r.wall / calls, 6),
                    "p95_wall_s": r.hist.quantile(0.95),
                    "compiles": r.compiles,
                    "generic_hits": r.generic_hits,
                    "generic_hit_rate": round(r.generic_hits / calls, 4),
                    "recoveries": r.recoveries,
                    "wire_bytes": r.wire_bytes,
                })
        out.sort(key=lambda d: -d["total_wall_s"])
        return out[:limit]

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)
