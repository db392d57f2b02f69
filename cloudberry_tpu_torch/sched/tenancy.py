"""Per-tenant fair scheduling — resource groups with CPU-share teeth.

The admission layer (exec/resource.py) bounds HOW MANY statements run;
it says nothing about WHOSE. Under warehouse concurrency that means one
chatty tenant starves the rest — exactly the "partial — no CPU-share
isolation" gap of the resource-group analog. This module adds the
scheduling half, the way "Accelerating Presto with GPUs" feeds many
cheap coordinator connections into a small accelerator-side execution
pool with priority-aware batching:

- tenants are declared named groups (weight, max concurrency, queue
  depth — config.tenancy / exec/resource.TenantGroup); requests carry a
  tenant name, unknown names fall into an auto-created default-shaped
  group;
- each dispatcher tick picks requests in DEFICIT-WEIGHTED-ROUND-ROBIN
  order: every round a non-empty tenant's deficit grows by
  weight x quantum, and it dequeues while the deficit lasts — under
  saturation, dispatch throughput is proportional to weight;
- STARVATION-FREE AGING: a request waiting past ``aging_s`` is picked
  ahead of deficit order (oldest first), so a weight-1 tenant's p99
  stays bounded no matter how heavy its neighbors — priority aging, not
  priority inversion (per-tenant max_concurrency still holds: an
  operator's explicit cap is never overridden);
- per-tenant admission/backpressure: a full tenant queue refuses with
  the RETRYABLE TenantQueueFull instead of queueing unboundedly — the
  same flow-control discipline as the dispatcher's global queue, scoped
  per tenant.

The scheduler is deliberately free of execution knowledge: it schedules
opaque items (the dispatcher's _Request objects) and exposes
``enqueue`` / ``pick`` / ``finish`` plus a ``slot`` context manager for
the server's direct (non-dispatcher) paths.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any, Optional

from cloudberry_tpu_torch.exec.resource import TenantGroup, TenantQueueFull

DEFAULT_TENANT = "default"


class TenantScheduler:
    """DWRR + aging over per-tenant bounded queues.

    Items are opaque; the scheduler tracks (item, enqueue_t) pairs and
    per-group accounting. Every mutable field of a TenantGroup is
    guarded by ``self._lock``.
    """

    def __init__(self, config):
        """``config`` is a config.TenancyConfig."""
        self.quantum = max(1, int(config.quantum))
        self.aging_s = float(config.aging_s)
        self.slot_wait_s = float(config.slot_wait_s)
        self._default_weight = max(1, int(config.default_weight))
        self._default_max_queue = max(1, int(config.default_max_queue))
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._groups: dict[str, TenantGroup] = {}
        self._queues: dict[str, deque] = {}
        self._order: list[str] = []       # round-robin rotation order
        self._rr = 0                      # rotation cursor
        for spec in getattr(config, "tenants", ()) or ():
            self._add_group(TenantGroup(
                name=str(spec.name).lower(),
                weight=max(1, int(spec.weight)),
                max_concurrency=max(0, int(spec.max_concurrency)),
                max_queue=max(1, int(spec.max_queue))))

    # ------------------------------------------------------------- groups

    def _add_group(self, g: TenantGroup) -> TenantGroup:
        self._groups[g.name] = g
        self._queues[g.name] = deque()
        self._order.append(g.name)
        return g

    def group(self, tenant: Optional[str]) -> TenantGroup:
        """The tenant's group, auto-created with the default shape for
        undeclared names (callers under the lock use _group_locked)."""
        with self._lock:
            return self._group_locked(tenant)

    def _group_locked(self, tenant: Optional[str]) -> TenantGroup:
        name = (tenant or DEFAULT_TENANT).lower()
        g = self._groups.get(name)
        if g is None:
            g = self._add_group(TenantGroup(
                name=name, weight=self._default_weight,
                max_queue=self._default_max_queue))
        return g

    # ------------------------------------------------------------ enqueue

    def enqueue(self, tenant: Optional[str], item: Any,
                wait_s: Optional[float] = None) -> TenantGroup:
        """Admit one request to its tenant's bounded queue. Waits up to
        ``wait_s`` (default: config slot_wait_s; 0 = refuse immediately)
        for space, then raises the retryable TenantQueueFull."""
        wait = self.slot_wait_s if wait_s is None else wait_s
        end = time.monotonic() + wait
        with self._lock:
            g = self._group_locked(tenant)
            q = self._queues[g.name]
            while len(q) >= g.max_queue:
                left = end - time.monotonic()
                if left <= 0:
                    g.rejected += 1
                    raise TenantQueueFull(
                        f"tenant {g.name!r}: request queue full "
                        f"({g.max_queue} waiting); retry, or raise the "
                        "tenant's max_queue")
                self._cond.wait(timeout=left)
            q.append((item, time.monotonic()))
            g.queued = len(q)
            g.max_depth = max(g.max_depth, len(q) + g.waiting)
            self._cond.notify_all()
            return g

    # --------------------------------------------------------------- pick

    def _pickable(self, g: TenantGroup) -> bool:
        return bool(self._queues[g.name]) and (
            g.max_concurrency <= 0 or g.running < g.max_concurrency)

    def _take(self, g: TenantGroup, now: float, aged: bool) -> Any:
        item, t0 = self._queues[g.name].popleft()
        g.queued = len(self._queues[g.name])
        g.running += 1
        g.picks += 1
        g.last_pick_t = now
        try:
            # the dispatcher's _Request.finish reads this to release the
            # concurrency slot; opaque items without the field just skip
            item._tenant_group = g
        except AttributeError:
            pass
        if aged:
            g.aged += 1
        w = (now - t0) * 1000.0
        g.wait_sum_ms += w
        g.wait_max_ms = max(g.wait_max_ms, w)
        self._cond.notify_all()  # space freed: wake blocked enqueuers
        return item

    def pick(self, max_n: int, now: Optional[float] = None) -> list:
        """Up to ``max_n`` requests in scheduling order: over-age heads
        first (oldest first — the starvation bound), then DWRR rounds.
        Deficits persist across calls; a tenant whose queue empties
        forfeits its leftover deficit (classic DWRR, so an idle tenant
        cannot hoard credit and burst past its share later)."""
        now = time.monotonic() if now is None else now
        out: list = []
        with self._lock:
            # aging pass — the STARVATION bound, not a FIFO override: a
            # tenant qualifies only when its head is over-age AND the
            # scheduler has not picked from it within aging_s (a tenant
            # being served every round is loaded, not starved — under
            # deep saturation every head is over-age, and oldest-first
            # alone would collapse the weights into global FIFO). Taking
            # one request updates last_pick_t, so each starving tenant
            # gets at most one aged pick per call; the rest is DWRR.
            while len(out) < max_n:
                oldest = None
                for name in self._order:
                    g = self._groups[name]
                    if not self._pickable(g):
                        continue
                    t0 = self._queues[name][0][1]
                    if now - t0 > self.aging_s \
                            and now - g.last_pick_t > self.aging_s \
                            and (oldest is None or t0 < oldest[1]):
                        oldest = (g, t0)
                if oldest is None:
                    break
                out.append(self._take(oldest[0], now, aged=True))
            # DWRR rounds over the rotation order
            while len(out) < max_n:
                progressed = False
                n = len(self._order)
                for i in range(n):
                    name = self._order[(self._rr + i) % n]
                    g = self._groups[name]
                    if not self._queues[name]:
                        g.deficit = 0.0  # empty queue forfeits credit
                        continue
                    if not self._pickable(g):
                        # concurrency-blocked: no credit accrual — a
                        # tenant parked at its cap must not bank deficit
                        # and burst past its weight share once freed
                        continue
                    # cap the bank at one pick budget: credit models
                    # "servable but the batch filled", never a hoard
                    g.deficit = min(g.deficit + g.weight * self.quantum,
                                    float(max(max_n,
                                              g.weight * self.quantum)))
                    while g.deficit >= 1.0 and self._pickable(g) \
                            and len(out) < max_n:
                        g.deficit -= 1.0
                        out.append(self._take(g, now, aged=False))
                        progressed = True
                    if len(out) >= max_n:
                        break
                self._rr = (self._rr + 1) % max(1, n)
                if not progressed:
                    break
        return out

    def finish(self, g: TenantGroup) -> None:
        """One picked/admitted request completed (ok or error)."""
        with self._lock:
            g.running -= 1
            g.served += 1
            self._cond.notify_all()

    # ------------------------------------------------ direct-path gating

    def slot(self, tenant: Optional[str],
             wait_s: Optional[float] = None):
        """Concurrency gate for statements that bypass the dispatcher
        (writes, non-parameterizable reads): waits briefly for a
        max_concurrency slot, then refuses with TenantQueueFull. The
        queue-depth bound covers waiters too — a tenant cannot park
        unbounded worker threads here."""
        wait = self.slot_wait_s if wait_s is None else wait_s

        @contextlib.contextmanager
        def _slot():
            end = time.monotonic() + wait
            with self._lock:
                g = self._group_locked(tenant)
                g.waiting += 1
                g.max_depth = max(g.max_depth, g.queued + g.waiting)
                try:
                    if g.waiting + g.queued > g.max_queue:
                        g.rejected += 1
                        raise TenantQueueFull(
                            f"tenant {g.name!r}: {g.max_queue} requests "
                            "already waiting; retry shortly")
                    while g.max_concurrency > 0 \
                            and g.running >= g.max_concurrency:
                        left = end - time.monotonic()
                        if left <= 0:
                            g.rejected += 1
                            raise TenantQueueFull(
                                f"tenant {g.name!r}: no concurrency slot "
                                f"({g.running} of {g.max_concurrency} "
                                "running); retry shortly")
                        self._cond.wait(timeout=left)
                finally:
                    g.waiting -= 1
                g.running += 1
                g.picks += 1
            try:
                yield
            finally:
                self.finish(g)

        return _slot()

    # ------------------------------------------------------ observability

    def depth(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def pending(self) -> list:
        """Drain every queue (dispatcher stop: fail pending visibly)."""
        out = []
        with self._lock:
            for name, q in self._queues.items():
                g = self._groups[name]
                while q:
                    out.append(q.popleft()[0])
                g.queued = 0
            self._cond.notify_all()
        return out

    def snapshot(self) -> dict:
        with self._lock:
            out = {}
            for name in self._order:
                g = self._groups[name]
                served = max(g.picks, 1)
                out[name] = {
                    "weight": g.weight,
                    "max_concurrency": g.max_concurrency,
                    "max_queue": g.max_queue,
                    "queued": g.queued,
                    "waiting": g.waiting,
                    "running": g.running,
                    "picks": g.picks,
                    "served": g.served,
                    "rejected": g.rejected,
                    "aged": g.aged,
                    "max_depth": g.max_depth,
                    "wait_avg_ms": round(g.wait_sum_ms / served, 3),
                    "wait_max_ms": round(g.wait_max_ms, 3),
                }
            return out

    def fairness_index(self) -> float:
        """Jain's fairness index over weight-normalized picks: 1.0 =
        every tenant got throughput exactly proportional to its weight
        (only tenants that were ever picked participate)."""
        with self._lock:
            xs = [g.picks / g.weight for g in self._groups.values()
                  if g.picks > 0]
        if not xs:
            return 1.0
        return (sum(xs) ** 2) / (len(xs) * sum(x * x for x in xs))
