"""Live statement progress — how far along a running statement is.

The reference answers "is it stuck or just slow" with
pg_stat_progress_* views; here a statement's progress is a monotone
fraction riding its lifecycle handle (the same cross-thread channel the
trace uses, lifecycle.py): the tiled executors' step loops — the ONLY
place a statement's work is countable — feed tiles-done / tiles-total
and consumed-row fractions after every tile, and the activity view plus
a dedicated ``meta "progress"`` verb read them live.

The monotonicity contract (pinned by tests): the reported fraction
NEVER decreases, even though a device-loss resume restarts the tile
loop (possibly from tile 0 when no checkpoint survived), an adaptive
retry halves the tile size (changing the total), and a degraded-mesh
re-shard re-plans the remaining stream at a smaller segment count.
``Progress`` clamps to the high-water mark, caps the streaming phase
below 1.0 (the finalize pass is still ahead), and only ``complete()``
— called when the statement FINISHES successfully — reports exactly
1.0. A failed statement therefore can never read as done.
"""

from __future__ import annotations

import threading

import numpy as np


# mid-stream fractions cap here: the finalize pass (merge collectives,
# post chain) is still ahead of a fully streamed statement, and a failed
# statement must never have reported completion
_STREAM_CAP = 0.995


class Progress:
    """One statement's monotone progress gauge (leaf lock — nothing is
    called while it is held)."""

    __slots__ = ("_lock", "tiles_done", "tiles_total", "rows_done",
                 "rows_total", "_frac", "done")

    def __init__(self):
        self._lock = threading.Lock()
        self.tiles_done = 0
        self.tiles_total = 0
        self.rows_done = 0
        self.rows_total = 0
        self._frac = 0.0
        self.done = False

    def update(self, tiles_done: int, tiles_total: int,
               rows_done: int | None = None,
               rows_total: int | None = None) -> None:
        """Record the CURRENT attempt's position. The raw tile/row
        numbers reflect this attempt (they may restart after a fresh
        re-run); the fraction is the high-water mark across attempts."""
        with self._lock:
            if self.done:
                return
            self.tiles_done = int(tiles_done)
            self.tiles_total = int(tiles_total)
            if rows_done is not None:
                self.rows_done = int(rows_done)
            if rows_total is not None:
                self.rows_total = int(rows_total)
            if tiles_total > 0:
                frac = min(tiles_done / tiles_total, _STREAM_CAP)
                if frac > self._frac:
                    self._frac = frac

    def complete(self) -> None:
        """The statement finished successfully: the fraction is exactly
        1.0 from here on (and frozen — a late tile-loop update from a
        racing thread cannot drag it back)."""
        with self._lock:
            self.done = True
            self._frac = 1.0

    @property
    def fraction(self) -> float:
        with self._lock:
            return self._frac

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "fraction": round(self._frac, 4),
                "tiles_done": self.tiles_done,
                "tiles_total": self.tiles_total,
                "rows_done": self.rows_done,
                "rows_total": self.rows_total,
            }


def current_progress():
    """The executing statement's Progress from the thread's lifecycle
    scope — None outside a statement or when the telemetry plane is
    off (the handle only carries one when obs is enabled)."""
    from cloudberry_tpu_torch.lifecycle import current_handle

    h = current_handle()
    return getattr(h, "progress", None) if h is not None else None


class TileTracker:
    """Per-tile-loop feeder: precomputes the attempt's totals once so
    the per-tile cost is one clamp + one lock (or nothing when the
    statement is untracked).

    ``lane_rows``: remaining rows per stream lane this attempt (one
    lane single-node, one per segment distributed — the loop runs
    lock-step, so the LONGEST lane sets the tile count).
    ``base_rows``: rows already consumed by checkpointed prior attempts
    (the resume prefix / consumed-mask population).
    ``n_base``: tiles those prior attempts completed.
    """

    __slots__ = ("_prog", "_tile_rows", "_n_base", "_base_rows",
                 "_lanes", "_rows_total", "total_est")

    def __init__(self, lane_rows, tile_rows: int,
                 n_base: int = 0, base_rows: int = 0,
                 rows_total: int | None = None):
        self._prog = current_progress()
        lanes = np.atleast_1d(np.asarray(lane_rows, dtype=np.int64))
        self._lanes = lanes
        self._tile_rows = max(int(tile_rows), 1)
        self._n_base = int(n_base)
        self._base_rows = int(base_rows)
        longest = int(lanes.max()) if lanes.size else 0
        self.total_est = self._n_base + max(
            -(-longest // self._tile_rows), 1)
        self._rows_total = int(rows_total) if rows_total is not None \
            else self._base_rows + int(lanes.sum())

    def step(self, tiles_local: int) -> None:
        """Feed the statement's progress after tile ``tiles_local``
        (1-based count of tiles this attempt completed)."""
        if self._prog is None:
            return
        consumed = int(np.minimum(
            self._lanes, tiles_local * self._tile_rows).sum())
        self._prog.update(self._n_base + tiles_local,
                          max(self.total_est,
                              self._n_base + tiles_local),
                          rows_done=self._base_rows + consumed,
                          rows_total=self._rows_total)


def stream_rows(scan, session) -> int:
    """Total source rows a tile stream will feed: pruned
    micro-partition scans count their surviving parts, warm tables
    their catalog row count. Telemetry-grade (progress denominators),
    not an execution contract."""
    parts = getattr(scan, "_store_parts", None)
    if parts is not None:
        return sum(int(p.get("num_rows", 0)) - len(p.get("deleted", ()))
                   for p in parts)
    t = session.catalog.tables.get(scan.table_name)
    return int(t.num_rows) if t is not None else 0
