"""The port's per-tenant scheduler (sched/tenancy.py) against the JAX
package's on the same schedules: deficit-weighted round robin, aging,
concurrency slots, the retryable TenantQueueFull and Jain's fairness
index, each driven with a fixed ``now`` (never the clock), then the
tenancy-aware dispatcher and the wire's tenant refusal and ``meta
"tenants"``. Mirrors tests/test_tenancy.py but for its bench smoke and
its clock-sampled saturation tests."""

import threading
import time

import numpy as np
import pytest

from torch_parity import twin, twin_servers

TIMEOUT = 60
# wait times ride the real clock at enqueue: everything else is the
# schedule's own, and must agree
_CLOCKED = ("wait_avg_ms", "wait_max_ms")


class _Item:
    """An opaque schedulable item (the dispatcher's _Request stand-in)."""

    def __init__(self, tag):
        self.tag = tag


def _sched(e, tenants, **kv):
    cfgm = e.mod("config")
    cfg = cfgm.TenancyConfig(enabled=True, tenants=tuple(
        cfgm.TenantSpec(*t[:2], **t[2]) for t in tenants), **kv)
    return e.mod("sched.tenancy").TenantScheduler(cfg)


def _snap(s):
    return {n: {k: v for k, v in g.items() if k not in _CLOCKED}
            for n, g in s.snapshot().items()}


def test_dwrr_pick_order_is_the_weight_ratio():
    """Both queues saturated, no aging: the pick ORDER (not a rate) is
    the same in both engines and serves 3:1 while both are non-empty;
    nothing is lost; the fairness index over the picks agrees."""
    def run(e):
        s = _sched(e, [("gold", 3, {"max_queue": 1000}),
                       ("silver", 1, {"max_queue": 1000})], aging_s=3600.0)
        now = time.monotonic()
        for name in ("gold", "silver"):
            for i in range(120):
                s.enqueue(name, _Item(name))
        picked = []
        while True:
            batch = s.pick(8, now=now)
            if not batch:
                break
            picked.extend(it.tag for it in batch)
            for it in batch:
                s.finish(s.group(it.tag))
        e.keep(picked)
        e.keep(_snap(s))
        e.keep(round(s.fairness_index(), 12))
    got = twin(run)
    head = got[0][:160]
    assert head.count("gold") == 3 * head.count("silver")
    assert len(got[0]) == 240


def test_aging_slots_and_default_groups():
    """An over-age head is picked first however heavy the neighbor; a
    tenant's concurrency cap holds even against aging; undeclared names
    get a default-shaped group; ``None`` is the default tenant."""
    def run(e):
        s = _sched(e, [("heavy", 100, {"max_queue": 1000}),
                       ("starved", 1, {"max_queue": 1000}),
                       ("t", 1, {"max_concurrency": 1, "max_queue": 10})],
                   aging_s=0.5)
        t0 = time.monotonic()
        s.enqueue("starved", _Item("old"))
        for _ in range(50):
            s.enqueue("heavy", _Item("heavy"))
        e.keep([it.tag for it in s.pick(4, now=t0 + 10.0)])
        a, b = _Item("a"), _Item("b")
        s.enqueue("t", a)
        s.enqueue("t", b)
        e.keep([it.tag for it in s.pick(60, now=t0 + 20.0)])
        e.keep([it.tag for it in s.pick(8, now=t0 + 20.0)])
        s.finish(s.group("t"))
        e.keep([it.tag for it in s.pick(8, now=t0 + 20.0)])
        s.enqueue("walkin", _Item("w"))
        s.enqueue(None, _Item("d"))
        e.keep(_snap(s))
    got = twin(run)
    assert got[0][0] == "old"
    assert got[2] == [] and got[3] == ["b"]
    assert got[4]["starved"]["aged"] == 1
    assert got[4]["walkin"]["weight"] == 1 and "default" in got[4]


def test_tenant_queue_full_and_slots():
    """A full tenant queue refuses with TenantQueueFull (retryable by
    name in both taxonomies); the direct-path slot gates concurrency and
    refuses past the wait."""
    def run(e):
        lc = e.mod("lifecycle")
        s = _sched(e, [("t", 1, {"max_queue": 2})])
        s.enqueue("t", _Item(1))
        s.enqueue("t", _Item(2))
        e.error(s.enqueue, "t", _Item(3), wait_s=0.0)
        e.keep([lc.is_retryable(n) for n in (
            "TenantQueueFull", "ServerBusy", "IngestQueueFull",
            "ServerDraining", "SchedQueueFull", "SchedDeadline")])
        e.keep([lc.is_retryable(c("x")) for c in (
            lc.ServerBusy, lc.IngestQueueFull, lc.ServerDraining,
            e.mod("exec.resource").TenantQueueFull)])
        g = _sched(e, [("g", 1, {"max_concurrency": 1, "max_queue": 1})],
                   slot_wait_s=0.05)
        entered, release = threading.Event(), threading.Event()

        def holder():
            with g.slot("g"):
                entered.set()
                release.wait(timeout=TIMEOUT)

        th = threading.Thread(target=holder)
        th.start()
        assert entered.wait(timeout=TIMEOUT)
        e.error(lambda: g.slot("g", wait_s=0.05).__enter__())
        release.set()
        th.join(timeout=TIMEOUT)
        with g.slot("g"):
            pass
        e.keep(_snap(s)["t"]["rejected"])
        e.keep(_snap(g)["g"])
    got = twin(run)
    assert got[0][0] == "TenantQueueFull"
    assert got[1] == [True] * 6 and got[2] == [True] * 4
    assert got[4] == 1 and got[5]["served"] == 2


def _point_session(e, **over):
    s = e.session(**{"sched.generic_plans": True, **over})
    s.sql("create table pts (k bigint, v bigint) distributed by (k)")
    s.catalog.table("pts").set_data({
        "k": np.arange(40_000, dtype=np.int64),
        "v": np.arange(40_000, dtype=np.int64) * 3}, {})
    return s


def test_tenancy_dispatcher_answers_every_tenant():
    """Two tenants at 3:1 queued before the worker starts: every request
    is answered right, and each tenant's picks and serves equal the JAX
    package's totals."""
    def run(e):
        cfgm = e.mod("config")
        sched = e.mod("sched")
        s = _point_session(e, **{"sched.tick_s": 0.001,
                                 "sched.max_batch": 8})
        ts = sched.TenantScheduler(cfgm.TenancyConfig(
            enabled=True, aging_s=3600.0, tenants=(
                cfgm.TenantSpec("gold", weight=3, max_queue=1000),
                cfgm.TenantSpec("silver", weight=1, max_queue=1000))))
        d = sched.Dispatcher(s, tenancy=ts)
        res, ev = {}, threading.Event()

        def cb(k):
            def f(r):
                res[k] = r.result.decoded_columns()["v"].tolist() \
                    if r.error is None else repr(r.error)
                if len(res) == 80:
                    ev.set()
            return f

        for i in range(40):
            d.submit_nowait(f"select k, v from pts where k = {i}",
                            tenant="gold", on_done=cb(i))
            d.submit_nowait(f"select k, v from pts where k = {1000 + i}",
                            tenant="silver", on_done=cb(1000 + i))
        d.start()
        try:
            assert ev.wait(TIMEOUT)
        finally:
            d.drain(TIMEOUT)
            d.stop()
        e.keep(sorted(res.items()))
        snap = _snap(ts)
        e.keep({n: (g["picks"], g["served"], g["queued"], g["running"])
                for n, g in snap.items()})
    got = twin(run)
    assert got[0] == sorted((k, [k * 3]) for k in
                            [*range(40), *range(1000, 1040)])
    assert got[1] == {"gold": (40, 40, 0, 0), "silver": (40, 40, 0, 0)}


def test_wire_tenant_backpressure_retry_and_meta():
    """A saturated tenant's wire read fails with the retryable
    TenantQueueFull; a ``retry_reads`` client gets through once the slot
    frees; ``meta "tenants"`` answers the same groups in both engines."""
    def run(e):
        cfgm = e.mod("config")
        s = _point_session(e, **{
            "tenancy.enabled": True, "tenancy.slot_wait_s": 0.02,
            "tenancy.tenants": (
                cfgm.TenantSpec("small", weight=1, max_concurrency=1,
                                max_queue=1),
                cfgm.TenantSpec("gold", weight=3))})
        srv = e.server(session=s)
        q = "select count(*) as n from pts group by k order by n limit 1"
        with srv.tenancy.slot("small"):
            c = e.client(srv, tenant="small", timeout=TIMEOUT)
            e.wire(c.sql, q)
        r = e.client(srv, tenant="small", retry_reads=True,
                     max_retries=5, backoff_s=0.02, timeout=TIMEOUT)
        e.wire(r.sql, q)
        g = e.client(srv, tenant="gold", timeout=TIMEOUT)
        e.wire(g.sql, "select k, v from pts where k = 42")
        t = g.meta("tenants")
        e.keep((t["enabled"], round(t["fairness_index"], 12),
                {n: {k: v for k, v in grp.items() if k not in _CLOCKED}
                 for n, grp in t["groups"].items()}))
    got = twin_servers(run)
    assert got[0][:3] == ("ServerError", "TenantQueueFull", True)
    assert got[1]["rowcount"] == 1
    assert got[3][0] is True and got[3][2]["gold"]["weight"] == 3


@pytest.mark.parametrize("n", [0, 1])
def test_fairness_index_on_a_fixed_schedule(n):
    """Jain's index over weight-normalized picks: 1.0 with nothing
    picked or exact proportions, below 1 when one tenant is starved —
    the same number in both engines."""
    def run(e):
        s = _sched(e, [("a", 2, {"max_queue": 100}),
                       ("b", 1, {"max_queue": 100})], aging_s=3600.0)
        e.keep(s.fairness_index())
        now = time.monotonic()
        for _ in range(30):
            s.enqueue("a", _Item("a"))
        if n:
            for _ in range(30):
                s.enqueue("b", _Item("b"))
        while s.pick(4, now=now):
            pass
        e.keep(round(s.fairness_index(), 12))
    got = twin(run)
    assert got[0] == 1.0 and 0.0 < got[1] <= 1.0
