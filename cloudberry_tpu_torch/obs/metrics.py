"""Engine-wide metrics registry — the gpperfmon / pg_stat_* counter plane.

The reference ships statement and system counters through a dedicated
collector (query_info_collect_hook → metrics_collector, plus the
pg_stat_* views); here the analog is ONE in-process registry per engine
(it hangs off the shared StatementLog, so a server's backends all write
the same instance) holding three metric kinds:

- counters  — monotonically increasing ints (``bump``), optionally with
  a tenant label: the labeled series rides NEXT TO the unlabeled total,
  so ``counter(name)`` stays O(1) and per-tenant attribution is opt-in;
- gauges    — last-write-wins scalars (queue depth, ring occupancy);
- histograms — bounded log2-bucket distributions for latencies/bytes
  (``observe``): bucket i counts values in [2^(i-1), 2^i) microunits,
  so p50/p95/p99 come from ~40 ints per series with no sample storage.

Everything is explicitly bounded: past ``max_series`` distinct names the
registry drops new series and counts the drops on itself
(``obs_series_dropped``) — observability must never become the leak.

Snapshots read as a dict (``snapshot()``) and as a Prometheus-style
text exposition (``exposition()``). The port's copy adds ``counter`` and
``snapshot`` to ``CounterView`` (its readers' names); the serving layer's
``meta "metrics"`` verb reads both.
"""

from __future__ import annotations

import threading


# histogram bucket i holds values v with 2^(i-1) <= v/unit < 2^i; the
# unit is 1e-6 (microseconds / micro-units) so sub-millisecond latencies
# still resolve. 48 buckets cover up to ~2^47 µs — beyond any real value.
_HIST_BUCKETS = 48
_HIST_UNIT = 1e-6


def _bucket_of(value: float) -> int:
    v = int(value / _HIST_UNIT)
    if v <= 0:
        return 0
    return min(v.bit_length(), _HIST_BUCKETS - 1)


def bucket_upper(i: int) -> float:
    """Upper bound of bucket ``i`` in base units (seconds/bytes)."""
    return (1 << i) * _HIST_UNIT


class _Hist:
    __slots__ = ("counts", "n", "total")

    def __init__(self):
        self.counts = [0] * _HIST_BUCKETS
        self.n = 0
        self.total = 0.0

    def add(self, value: float) -> None:
        self.counts[_bucket_of(value)] += 1
        self.n += 1
        self.total += value

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile: the upper bound of the bucket the
        q-th sample lands in (conservative — never under-reports)."""
        if self.n == 0:
            return 0.0
        target = max(1, -int(-q * self.n // 1))  # ceil: p99 of 4 is #4
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return bucket_upper(i)
        return bucket_upper(_HIST_BUCKETS - 1)

    def snapshot(self) -> dict:
        # sparse bucket dict: most of the 48 buckets are empty
        return {
            "count": self.n,
            "sum": round(self.total, 6),
            "mean": round(self.total / self.n, 6) if self.n else 0.0,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "buckets": {i: c for i, c in enumerate(self.counts) if c},
        }


class MetricsRegistry:
    """Thread-safe, bounded metric store. The lock is a leaf: nothing is
    called while it is held (graftlint witness rank 4)."""

    def __init__(self, max_series: int = 4096):
        self.max_series = max_series
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        # (name, tenant) -> int: per-tenant attribution next to the total
        self._labeled: dict[tuple, int] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, _Hist] = {}
        self._dropped = 0

    # ------------------------------------------------------------ writes

    def _admit(self, table, key) -> bool:
        """Series-cardinality bound (callers hold the lock)."""
        if key in table or len(table) < self.max_series:
            return True
        self._dropped += 1
        return False

    def bump(self, name: str, n: int = 1, tenant: str | None = None) -> None:
        with self._lock:
            if self._admit(self._counters, name):
                self._counters[name] = self._counters.get(name, 0) + n
            if tenant is not None:
                key = (name, tenant)
                if self._admit(self._labeled, key):
                    self._labeled[key] = self._labeled.get(key, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            if self._admit(self._gauges, name):
                self._gauges[name] = float(value)

    def gauge_max(self, name: str, value: float) -> None:
        """High-water-mark gauge: keeps the max ever written (the
        peak-statement-memory gauge the capacity plane maintains).
        Atomic under the registry lock — concurrent writers cannot
        lose a peak to a read-modify-write race."""
        with self._lock:
            if self._admit(self._gauges, name):
                v = float(value)
                cur = self._gauges.get(name)
                if cur is None or v > cur:
                    self._gauges[name] = v

    def observe(self, name: str, value: float,
                tenant: str | None = None) -> None:
        """One histogram sample (seconds or bytes). The tenant label
        folds into the series name — per-tenant histograms are a
        cardinality product, so they ride the same series bound."""
        if tenant is not None:
            name = f"{name}{{tenant={tenant}}}"
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                if not self._admit(self._hists, name):
                    return
                h = self._hists[name] = _Hist()
            h.add(value)

    # ------------------------------------------------------------- reads

    def counter(self, name: str) -> int:
        with self._lock:
            return int(self._counters.get(name, 0))

    def counter_snapshot(self) -> dict:
        with self._lock:
            return {k: int(v) for k, v in sorted(self._counters.items())}

    def hist(self, name: str) -> dict | None:
        with self._lock:
            h = self._hists.get(name)
            return h.snapshot() if h is not None else None

    def series_count(self) -> int:
        with self._lock:
            return (len(self._counters) + len(self._labeled)
                    + len(self._gauges) + len(self._hists))

    def snapshot(self) -> dict:
        """JSON-safe full snapshot (the ``meta "metrics"`` payload)."""
        with self._lock:
            labeled = {f"{n}{{tenant={t}}}": v
                       for (n, t), v in sorted(self._labeled.items())}
            return {
                "counters": {k: int(v)
                             for k, v in sorted(self._counters.items())},
                "labeled_counters": labeled,
                "gauges": {k: v for k, v in sorted(self._gauges.items())},
                "histograms": {k: h.snapshot()
                               for k, h in sorted(self._hists.items())},
                "series": (len(self._counters) + len(self._labeled)
                           + len(self._gauges) + len(self._hists)),
                "series_dropped": self._dropped,
            }

    def exposition(self) -> str:
        """Prometheus-style text exposition. Histogram buckets emit
        cumulative ``le`` bounds in base units, the way a scraper
        expects; names are sanitized to the metric charset."""

        def _san(name: str) -> str:
            return "".join(c if (c.isalnum() or c == "_") else "_"
                           for c in name)

        snap = self.snapshot()
        lines = []
        for name, v in snap["counters"].items():
            lines.append(f"# TYPE cbtpu_{_san(name)} counter")
            lines.append(f"cbtpu_{_san(name)} {v}")
        # tenant-labeled series under a DISTINCT name (<name>_by_tenant):
        # the unlabeled series above is already the all-up total, and a
        # Prometheus sum() over one name must never double-count a
        # metric that mixes a total with its partitioning labels
        seen_by_tenant = set()
        for (series, v) in snap["labeled_counters"].items():
            name, _, label = series.partition("{")
            tenant = label.rstrip("}").partition("=")[2]
            m = f"cbtpu_{_san(name)}_by_tenant"
            if m not in seen_by_tenant:
                seen_by_tenant.add(m)
                lines.append(f"# TYPE {m} counter")
            lines.append(f'{m}{{tenant="{tenant}"}} {v}')
        for name, v in snap["gauges"].items():
            lines.append(f"# TYPE cbtpu_{_san(name)} gauge")
            lines.append(f"cbtpu_{_san(name)} {v}")
        for name, h in snap["histograms"].items():
            base, _, label = name.partition("{")
            tenant = label.rstrip("}").partition("=")[2] if label else ""
            sel = f'{{tenant="{tenant}",le="%s"}}' if tenant \
                else '{le="%s"}'
            m = f"cbtpu_{_san(base)}"
            lines.append(f"# TYPE {m} histogram")
            cum = 0
            for i, c in sorted(h["buckets"].items()):
                cum += c
                lines.append(f"{m}_bucket" + sel % bucket_upper(int(i))
                             + f" {cum}")
            lines.append(f"{m}_bucket" + sel % "+Inf" + f" {h['count']}")
            suffix = f'{{tenant="{tenant}"}}' if tenant else ""
            lines.append(f"{m}_sum{suffix} {h['sum']}")
            lines.append(f"{m}_count{suffix} {h['count']}")
        return "\n".join(lines) + "\n"


class CounterView:
    """Read-only mapping view over the registry's unlabeled counters —
    ``StatementLog.counters``, which a port Session exposes as
    ``session.counters``. Mutations go through ``StatementLog.bump``;
    the view lets readers (``counter``, ``snapshot``, mapping access)
    read the registry, the single home of the engine's counters."""

    __slots__ = ("_reg",)

    def __init__(self, registry: MetricsRegistry):
        self._reg = registry

    def get(self, name: str, default: int = 0) -> int:
        if default == 0:
            return self._reg.counter(name)
        return self._reg.counter_snapshot().get(name, default)

    def __getitem__(self, name: str) -> int:
        return self._reg.counter(name)

    def __contains__(self, name: str) -> bool:
        return name in self._reg.counter_snapshot()

    def __iter__(self):
        return iter(self._reg.counter_snapshot())

    def __len__(self) -> int:
        return len(self._reg.counter_snapshot())

    def items(self):
        return self._reg.counter_snapshot().items()

    def keys(self):
        return self._reg.counter_snapshot().keys()

    def values(self):
        return self._reg.counter_snapshot().values()

    def counter(self, name: str) -> int:
        return self._reg.counter(name)

    def snapshot(self) -> dict:
        """Every counter's value (the registry's ``counter_snapshot``)."""
        return self._reg.counter_snapshot()


def observe_stage(log, stage: str, dt: float,
                  tenant: str | None = None) -> None:
    """One per-stage latency sample (``stage_seconds.<stage>``) on the
    engine registry — the serve_bench time-share columns read these.
    ``log`` is a StatementLog (or None); a disabled obs config
    (log.obs_enabled False) makes this a no-op."""
    if log is None or not getattr(log, "obs_enabled", False):
        return
    log.registry.observe(f"stage_seconds.{stage}", dt, tenant=tenant)
