"""Streaming ingest plane — the append-optimized write path.

The reference's AO (append-optimized) tables absorb small writes into
segment files without rewriting the table; here the analog is an
``IngestBuffer`` per (table, tenant) that batches wire-level appends into
micro-partition-sized commits. The contract:

- **Durability only at commit.** ``append()`` buffers the rows and blocks
  until the flush that covers them commits (group commit: whoever's rows
  trip the size threshold — or the age flusher — flushes EVERYONE's
  pending rows in one batch). A successful return means the rows are in
  the store's committed manifest; an error means the batch did not
  commit (retry-safe for the caller, like any failed INSERT).
- **Bit-identical to INSERTs by construction.** A flush renders one
  multi-row ``INSERT INTO t [(cols)] VALUES (...), (...)`` per
  column-signature run and executes it through ``session.sql`` inside
  the server's write scope — so OCC, matview maintenance, autostats,
  exact DECIMAL text encoding, the StatementLog/flight recorder, and
  store-version bumps (which invalidate the buffer pool / shared cache /
  feedback sketches) all ride the one existing write path instead of a
  parallel one.
- **Backpressure is retryable.** Past ``config.ingest.max_buffered_rows``
  pending rows per buffer, ``append`` refuses with ``IngestQueueFull``
  (in the retryable taxonomy — clients back off and retry, the same
  shape as SchedQueueFull).
- **Lifecycle.** Appends honor per-request deadlines (StatementTimeout)
  and cooperative cancel; ``stop()`` drains — every buffered row is
  flushed before the service goes down (the wire layer refuses new
  appends while draining).

Lock discipline: ``IngestService._cond`` guards the buffer map and all
buffer state; it is NEVER
held across a flush — the leader takes the batch under the condition,
releases it, executes the INSERT(s), then re-acquires to publish the
outcome and wake waiters.
"""

from __future__ import annotations

import contextlib
import re
import threading
import time

from cloudberry_tpu_torch import lifecycle
from cloudberry_tpu_torch.utils.faultinject import fault_point

_IDENT = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _lit(v) -> str:
    """One wire value → the SQL literal text a user would have typed.
    The flush is bit-identical to hand-written INSERTs exactly because
    this rendering is the identity on literal text: ints print as ints,
    floats as their shortest round-trip repr (DECIMAL columns parse the
    text exactly, fixed-point), strings single-quoted with '' escaping
    (dates/times ride as strings and encode at bind time)."""
    if v is None:
        return "NULL"
    if v is True:
        return "TRUE"
    if v is False:
        return "FALSE"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    raise ValueError(
        f"unsupported append value type {type(v).__name__!r} "
        "(use null/bool/int/float/str)")


def render_insert(table: str, columns, rows) -> str:
    """The flush statement for one column-signature run of rows."""
    cols = f" ({', '.join(columns)})" if columns else ""
    vals = ", ".join(
        "(" + ", ".join(_lit(v) for v in row) + ")" for row in rows)
    return f"INSERT INTO {table}{cols} VALUES {vals}"


def _row_bytes(row) -> int:
    """Cheap host-bytes estimate for the buffer gauge: 8 per scalar plus
    string payload (the gauge is capacity-plane telemetry, not an
    allocator)."""
    n = 0
    for v in row:
        n += 8 + (len(v) if isinstance(v, str) else 0)
    return n


class _Batch:
    """One flush's worth of rows taken out of a buffer: the ordered
    column-signature runs plus the (lo, hi] enqueue span they cover."""

    __slots__ = ("runs", "lo", "hi", "first_ts")

    def __init__(self, runs, lo, hi, first_ts):
        self.runs = runs
        self.lo = lo
        self.hi = hi
        self.first_ts = first_ts


class _Buffer:
    """Per-(table, tenant) pending rows. All state is guarded by the
    owning IngestService's condition."""

    __slots__ = ("runs", "pending", "bytes", "first_ts", "enqueued",
                 "done", "flushing", "fails")

    def __init__(self):
        self.runs = []          # [(columns-tuple-or-None, [rows])]
        self.pending = 0        # rows currently buffered
        self.bytes = 0          # estimated host bytes buffered
        self.first_ts = None    # monotonic ts of the oldest pending row
        self.enqueued = 0       # rows ever accepted (monotonic)
        self.done = 0           # rows resolved (committed or failed)
        self.flushing = False   # a leader holds this buffer's batch
        self.fails = []         # [(lo, hi, exc)] — failed flush spans

    def add(self, columns, rows, now: float) -> int:
        """Append one wire batch; returns the caller's ack position."""
        if self.runs and self.runs[-1][0] == columns:
            self.runs[-1][1].extend(rows)
        else:
            self.runs.append((columns, list(rows)))
        self.pending += len(rows)
        self.bytes += sum(_row_bytes(r) for r in rows)
        if self.first_ts is None:
            self.first_ts = now
        self.enqueued += len(rows)
        return self.enqueued

    def take(self) -> _Batch:
        """Hand the whole pending set to a flush leader."""
        batch = _Batch(self.runs, self.done + self._in_flight(),
                       self.enqueued, self.first_ts)
        self.runs = []
        self.pending = 0
        self.bytes = 0
        self.first_ts = None
        return batch

    def _in_flight(self) -> int:
        # rows between done and the pending set (a batch being flushed)
        return self.enqueued - self.done - self.pending

    def error_for(self, pos: int):
        for lo, hi, exc in self.fails:
            if lo < pos <= hi:
                return exc
        return None


class IngestService:
    """The streaming append plane: buffers per (table, tenant), size/age
    flush thresholds, group commit through the session's one write path.
    One instance serves a whole Server (wired with the server's
    ``exec_scope`` so flushes take the same write lock SQL does); tests
    drive it directly on a bare Session."""

    def __init__(self, session, exec_scope=None):
        cfg = session.config.ingest
        self.session = session
        self.flush_rows = max(1, int(cfg.flush_rows))
        self.flush_ms = float(cfg.flush_ms)
        self.max_buffered_rows = max(1, int(cfg.max_buffered_rows))
        self._exec_scope = exec_scope
        self._cond = threading.Condition()
        self._buffers: dict[tuple, _Buffer] = {}
        self._stop = False
        self._thread = None
        # wired by the server: called (outside locks) with the table
        # name after each committed flush — the compaction wake-up
        self.on_commit = None

    # ------------------------------------------------------------ lifecycle

    def _ensure_flusher(self) -> None:
        """Spawn the age flusher lazily: a server that never sees an
        append never pays a thread."""
        if self._thread is not None:
            return
        with self._cond:
            if self._thread is None and not self._stop:
                t = threading.Thread(target=self._age_flusher,
                                     name="cbtpu_torch-ingest-flusher",
                                     daemon=True)
                self._thread = t
                t.start()

    def stop(self) -> None:
        """Drain flush-on-stop: refuse new appends, flush every buffered
        row, and only then return — a stopping server never drops
        acknowledged-pending work on the floor."""
        with self._cond:
            self._stop = True
            t, self._thread = self._thread, None
            self._cond.notify_all()
        if t is not None:
            t.join(timeout=10)
        self.drain()

    def drain(self) -> None:
        """Flush until no buffer has pending rows and no flush is in
        flight (other leaders' flushes are waited out)."""
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            work = []
            with self._cond:
                for key, buf in self._buffers.items():
                    if buf.pending and not buf.flushing:
                        work.append((key, buf, buf.take()))
                        buf.flushing = True
                busy = bool(work) or any(
                    b.flushing for b in self._buffers.values())
            if not busy:
                return
            for key, buf, batch in work:
                self._run_flush(key, buf, batch)
            if not work:
                time.sleep(0.005)

    # --------------------------------------------------------------- append

    def append(self, table: str, rows, columns=None,
               tenant: str | None = None,
               deadline_s: float | None = None) -> int:
        """Buffer ``rows`` for ``table`` and block until the covering
        flush commits. Returns the number of rows made durable."""
        self._validate(table, rows, columns)
        self._ensure_flusher()
        log = getattr(self.session, "stmt_log", None)
        cols = tuple(columns) if columns else None
        key = (table, tenant)
        now = time.monotonic()
        deadline = now + deadline_s if deadline_s else None
        lead_batch = None
        with self._cond:
            if self._stop:
                raise lifecycle.ServerDraining("ingest is draining")
            buf = self._buffers.get(key)
            if buf is None:
                buf = self._buffers[key] = _Buffer()
            if buf.pending + len(rows) > self.max_buffered_rows:
                if log is not None:
                    log.bump("ingest_queue_full", tenant=tenant)
                raise lifecycle.IngestQueueFull(
                    f"ingest buffer for {table!r} is full "
                    f"({buf.pending} rows pending); retry")
            pos = buf.add(cols, rows, now)
            self._cond.notify_all()
            while True:
                err = buf.error_for(pos)
                if err is not None:
                    raise err
                if buf.done >= pos:
                    break
                now = time.monotonic()
                if deadline is not None and now >= deadline:
                    raise lifecycle.StatementTimeout(
                        f"append to {table!r} timed out awaiting commit "
                        "(rows remain buffered; durability unknown)")
                lifecycle.check_cancel()
                if buf.pending and not buf.flushing \
                        and self._due(buf, now):
                    lead_batch = buf.take()
                    buf.flushing = True
                    break
                self._cond.wait(timeout=self._wait_s(buf, now, deadline))
        if lead_batch is not None:
            self._run_flush(key, buf, lead_batch)
            with self._cond:
                err = buf.error_for(pos)
            if err is not None:
                raise err
        if log is not None:
            log.bump("ingest_appends", tenant=tenant)
        return len(rows)

    def _validate(self, table, rows, columns) -> None:
        if not _IDENT.match(table or ""):
            raise ValueError(f"bad table name {table!r}")
        if columns is not None:
            for c in columns:
                if not _IDENT.match(c or ""):
                    raise ValueError(f"bad column name {c!r}")
        if not rows:
            raise ValueError("append needs at least one row")
        width = len(columns) if columns else len(rows[0])
        for row in rows:
            if not isinstance(row, (list, tuple)) or len(row) != width:
                raise ValueError(
                    "append rows must be equal-width lists")

    def _due(self, buf: _Buffer, now: float) -> bool:
        if buf.pending >= self.flush_rows:
            return True
        return buf.first_ts is not None \
            and (now - buf.first_ts) * 1000.0 >= self.flush_ms

    def _wait_s(self, buf: _Buffer, now: float, deadline) -> float:
        wake = now + max(self.flush_ms / 1000.0, 0.001)
        if buf.first_ts is not None:
            wake = min(wake, buf.first_ts + self.flush_ms / 1000.0)
        if deadline is not None:
            wake = min(wake, deadline)
        return max(0.001, min(wake - now, 0.05))

    # ---------------------------------------------------------------- flush

    def _age_flusher(self) -> None:
        """Background thread: commits buffers whose oldest row has aged
        past flush_ms even when no appender is waiting to lead (e.g.
        every appender already timed out, or leads a different buffer)."""
        while True:
            lifecycle.check_cancel()
            work = []
            with self._cond:
                self._cond.wait(
                    timeout=max(0.005, self.flush_ms / 2000.0))
                if self._stop:
                    return
                now = time.monotonic()
                for key, buf in self._buffers.items():
                    if buf.pending and not buf.flushing \
                            and self._due(buf, now):
                        work.append((key, buf, buf.take()))
                        buf.flushing = True
            for key, buf, batch in work:
                self._run_flush(key, buf, batch)

    def _run_flush(self, key, buf: _Buffer, batch: _Batch) -> None:
        """Execute one batch OUTSIDE the condition, then publish the
        outcome. A failed flush resolves its span with the error — the
        rows are NOT durable and every covered appender sees the
        exception (never a silent drop, never a false ack)."""
        table, tenant = key
        log = getattr(self.session, "stmt_log", None)
        err = None
        try:
            # the device-loss-mid-flush chaos seam: an armed fault here
            # fails the WHOLE batch before any statement commits
            fault_point("ingest_flush")
            scope = self._exec_scope(write=True) \
                if self._exec_scope is not None \
                else contextlib.nullcontext()
            with scope:
                for cols, rows in batch.runs:
                    self.session.sql(render_insert(table, cols, rows))
        except BaseException as e:  # noqa: BLE001 — delivered to waiters
            err = e
        with self._cond:
            buf.flushing = False
            buf.done = max(buf.done, batch.hi)
            if err is not None:
                buf.fails.append((batch.lo, batch.hi, err))
                del buf.fails[:-16]
            self._cond.notify_all()
        if log is not None:
            if err is None:
                log.bump("ingest_flushes")
                log.bump("ingest_rows", batch.hi - batch.lo,
                         tenant=tenant)
                log.registry.observe(
                    "ingest_flush_seconds",
                    time.monotonic() - (batch.first_ts
                                        or time.monotonic()))
            else:
                log.bump("ingest_flush_errors")
        if err is None and self.on_commit is not None:
            try:
                self.on_commit(table)
            except Exception:  # noqa: BLE001 — observer must not break
                if log is not None:
                    log.bump("ingest_commit_hook_errors")

    # ------------------------------------------------------------ telemetry

    def buffered_bytes(self) -> int:
        """The ``mem_ingest_buffer_bytes`` gauge feed
        (obs/capacity.refresh_gauges)."""
        with self._cond:
            return sum(b.bytes for b in self._buffers.values())

    def snapshot(self) -> dict:
        """``meta "ingest"``: buffer occupancy + the counter/latency
        story in one read."""
        with self._cond:
            bufs = [{"table": k[0], "tenant": k[1],
                     "pending_rows": b.pending,
                     "pending_bytes": b.bytes,
                     "flushing": b.flushing}
                    for k, b in sorted(self._buffers.items(),
                                       key=lambda kv: (kv[0][0],
                                                       kv[0][1] or ""))]
            draining = self._stop
        out = {"enabled": True, "draining": draining,
               "flush_rows": self.flush_rows, "flush_ms": self.flush_ms,
               "max_buffered_rows": self.max_buffered_rows,
               "buffered_rows": sum(b["pending_rows"] for b in bufs),
               "buffered_bytes": sum(b["pending_bytes"] for b in bufs),
               "buffers": bufs}
        log = getattr(self.session, "stmt_log", None)
        if log is not None:
            for c in ("ingest_appends", "ingest_rows", "ingest_flushes",
                      "ingest_flush_errors", "ingest_queue_full"):
                out[c.replace("ingest_", "")] = log.counter(c)
            h = log.registry.hist("ingest_flush_seconds") or {}
            out["flush_ms_p95"] = round(h.get("p95", 0.0) * 1000.0, 3)
        return out
