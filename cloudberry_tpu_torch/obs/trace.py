"""Statement trace spans — where one statement's time went.

The reference answers "where did the time go" with per-node
Instrumentation shipped QE→QD (cdbexplain_sendExecStats) plus gpperfmon;
here a statement's host-side journey is a SPAN TREE riding the existing
thread-local statement scope (lifecycle.py): the handle a scope installs
carries the statement's ``Trace``, so any seam on any thread — the
session's parse/plan, a dispatcher worker's flush, the tiled step loop,
a recovery backoff — records spans against the statement it is serving
without threading a context object through every signature. Crossing
threads is exactly the lifecycle-handle mechanism: whoever enters a
``statement_scope`` with the handle inherits its trace.

Span taxonomy (docs/DESIGN.md "Observability"): statement (root), parse,
plan, param-bind, compile, queue-wait, tenant-slot-wait, launch,
tile-step, recovery-backoff, render. Spans are Chrome-trace "X"
(complete) events — ts/dur in µs, tid = recording thread — so the
export loads directly into Perfetto / chrome://tracing, where per-tid
time-nesting reproduces the call tree. Device launches additionally wrap
in ``torch.profiler.record_function`` ranges named ``cbtpu:<span>`` while
a profiler records, so a ``torch.profiler`` trace of the card lines up
with the host span names (the JAX package uses ``jax.profiler``
annotations there).

Bounds: each trace keeps at most ``max_spans`` spans (drops counted on
the trace), and completed traces land in a bounded ring on the shared
StatementLog (``meta "trace"`` reads it newest-first).
"""

from __future__ import annotations

import contextlib
import threading
import time


_current_handle = None  # resolved once; avoids a per-span import lookup


def current_trace():
    """The executing statement's Trace, from the thread's lifecycle
    scope — None outside a statement or when tracing is off/sampled
    out."""
    global _current_handle
    ch = _current_handle
    if ch is None:
        from cloudberry_tpu_torch.lifecycle import current_handle

        ch = _current_handle = current_handle
    h = ch()
    return getattr(h, "trace", None) if h is not None else None


class Trace:
    """One statement's bounded span collection. Append-only under a leaf
    lock (multiple threads may serve one statement: dispatcher worker,
    handler thread, watchdog)."""

    def __init__(self, statement_id: int, sql: str,
                 max_spans: int = 512, tenant: str | None = None):
        self.statement_id = statement_id
        self.sql = sql[:200]
        self.tenant = tenant
        self.max_spans = max_spans
        self._lock = threading.Lock()
        self._spans: list[dict] = []
        self.dropped = 0
        self.attempt = 0
        self.t0 = time.perf_counter()
        self.wall_s = 0.0
        self.status = "running"

    def add(self, name: str, t_start: float, dur_s: float,
            args: dict | None = None) -> None:
        """Record one completed interval (perf_counter seconds)."""
        ev = {
            "name": name,
            "ph": "X",
            "ts": round(t_start * 1e6, 1),
            "dur": round(dur_s * 1e6, 1),
            "pid": 1,
            "tid": threading.get_ident() & 0xFFFFFF,
            "cat": "statement",
        }
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped += 1
                return
            self._spans.append(ev)

    def mark(self, name: str, t_start: float,
             args: dict | None = None) -> None:
        """Span from ``t_start`` to now (the measure-around-enter
        shape used for queue/admission waits)."""
        self.add(name, t_start, time.perf_counter() - t_start, args)

    def finish(self, status: str) -> None:
        """Close the root span; the statement's whole wall clock."""
        self.status = status
        self.wall_s = time.perf_counter() - self.t0
        self.add("statement", self.t0, self.wall_s,
                 {"sql": self.sql, "status": status,
                  "statement_id": self.statement_id,
                  "tenant": self.tenant, "attempt": self.attempt})

    def export(self) -> dict:
        """JSON-safe export: the ring entry / wire payload."""
        with self._lock:
            spans = list(self._spans)
        return {
            "statement_id": self.statement_id,
            "sql": self.sql,
            "tenant": self.tenant,
            "status": self.status,
            "wall_s": round(self.wall_s, 6),
            "attempt": self.attempt,
            "spans_dropped": self.dropped,
            "events": spans,
        }


class span:
    """Record a span around the body when the thread is inside a traced
    statement; a no-op (one thread-local read) otherwise. A plain class
    rather than a generator context manager — this sits on the
    per-statement hot path."""

    __slots__ = ("name", "args", "tr", "t0")

    def __init__(self, name: str, **args):
        self.name = name
        self.args = args

    def __enter__(self):
        self.tr = current_trace()
        self.t0 = time.perf_counter() if self.tr is not None else 0.0
        return self.tr

    def __exit__(self, *exc) -> bool:
        if self.tr is not None:
            self.tr.add(self.name, self.t0,
                        time.perf_counter() - self.t0, self.args or None)
        return False


def mark(name: str, t_start: float, **args) -> None:
    """Span from ``t_start`` (perf_counter) to now on the current
    trace, if any — for waits whose scope is awkward to wrap."""
    tr = current_trace()
    if tr is not None:
        tr.mark(name, t_start, args or None)


def device_annotation(name: str):
    """``torch.profiler.record_function`` range around a device launch,
    so a ``torch.profiler`` trace of the card lines up with the host span
    names; a null context when the thread is untraced, or when no
    profiler is recording (the range would record nothing, and the
    profiler machinery stays untouched)."""
    if current_trace() is None:
        return contextlib.nullcontext()
    import torch

    if not torch._C._autograd._profiler_enabled():
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(f"cbtpu:{name}")


def chrome_trace(exports: list[dict]) -> dict:
    """Assemble ring exports into ONE Chrome-trace JSON document
    (Perfetto-loadable): {"traceEvents": [...]} with every statement's
    events concatenated (ts values share the perf_counter timebase, so
    concurrent statements interleave truthfully)."""
    events = []
    for ex in exports:
        events.extend(ex.get("events", ()))
    return {"traceEvents": events, "displayTimeUnit": "ms"}
