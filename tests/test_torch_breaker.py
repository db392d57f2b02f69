"""The admission circuit breaker (lifecycle.CircuitBreaker) through the
port against the JAX package, on the CPU: the counterparts of
tests/test_lifecycle.py's breaker cases.

Each session case drives both engines through the same statements and
injected device losses and holds the breaker's snapshot, the refusals and
the counters equal: K consecutive statements that needed a recovery trip
the breaker open; writes then refuse with the retryable ``BreakerOpen``
while reads serve; after the cooldown a write half-opens it and one
health probe decides. The reference's transaction-control exemption has
no port counterpart to drive yet: the port's planner refuses BEGIN
(ROADMAP Queue A 8).
"""

import numpy as np
import pytest

from cloudberry_tpu_torch import lifecycle
from torch_parity import (arm_both, assert_same, chaos_teardown, dist_pair,
                          reset_both, same_counters)


@pytest.fixture(autouse=True)
def _clean_faults():
    reset_both()
    yield
    chaos_teardown()


def _pair(**ov):
    def load(s):
        s.sql("create table t (k bigint, v bigint) distributed by (k)")
        s.catalog.table("t").set_data(
            {"k": np.arange(64, dtype=np.int64),
             "v": (np.arange(64, dtype=np.int64) * 7) % 13})
    return dist_pair(load, nseg=1, **{"health.backoff_s": 0.01, **ov})


def _snap(js, ts) -> dict:
    """Both breakers' snapshots, equal; returns the port's."""
    got, want = ts._breaker.snapshot(), js._breaker.snapshot()
    assert got == want, (got, want)
    return got


def _each(js, ts, fn):
    """Run ``fn(session, lifecycle module)`` for the JAX session, then the
    port's."""
    from cloudberry_tpu import lifecycle as JL

    fn(js, JL)
    fn(ts, lifecycle)


def _recovered_select(js, ts):
    arm_both("exec_device_lost", start_hit=1, end_hit=1)
    assert_same(ts.sql("select sum(v) as sv from t"),
                js.sql("select sum(v) as sv from t"))
    reset_both()


def test_breaker_trip_halfopen_close():
    js, ts = _pair(**{"health.breaker_threshold": 2,
                      "health.breaker_cooldown_s": 60.0})
    # two CONSECUTIVE statements needing a device-loss recovery trip it
    for _ in range(2):
        _recovered_select(js, ts)
    snap = _snap(js, ts)
    assert snap["state"] == "open" and snap["trips"] == 1

    def refused(s, L):
        # read-only-degraded: writes refuse retryably, reads still serve
        with pytest.raises(L.BreakerOpen):
            s.sql("create table w1 (x bigint)")
        got = s.sql("select count(*) as c from t")
        assert int(np.asarray(got.columns["c"])[0]) == 64
        assert L.is_retryable(L.BreakerOpen("x"))

    _each(js, ts, refused)

    def half_open(s, L):
        # half-open with a FAILING probe: stays open, cooldown re-arms
        s._breaker._probe_fn = \
            lambda: type("R", (), {"ok": False, "error": "dead"})()
        s._breaker.cooldown_s = 0.0
        with pytest.raises(L.BreakerOpen):
            s.sql("create table w1 (x bigint)")
        assert s._breaker.snapshot()["state"] == "open"
        # half-open with a HEALTHY probe (the engine's own): the trial
        # write closes it
        s._breaker._probe_fn = None
        assert str(s.sql("create table w1 (x bigint)")) \
            .startswith("CREATE TABLE")

    _each(js, ts, half_open)
    snap = _snap(js, ts)
    assert snap["state"] == "closed" and snap["consecutive_recoveries"] == 0
    same_counters(ts, js, ("recoveries",))


def test_breaker_success_resets_consecutive():
    js, ts = _pair(**{"health.breaker_threshold": 2})
    _recovered_select(js, ts)   # one recovery
    assert_same(ts.sql("select sum(v) as sv from t"),
                js.sql("select sum(v) as sv from t"))  # clean: resets
    _recovered_select(js, ts)   # one again — NOT consecutive
    snap = _snap(js, ts)
    assert snap["state"] == "closed" and snap["trips"] == 0


def test_breaker_trips_on_hard_outage():
    """Recovery ATTEMPTS count even when the statement ultimately fails
    (retries exhausted)."""
    from cloudberry_tpu.utils import faultinject as JFI
    from cloudberry_tpu_torch.utils import faultinject as TFI

    js, ts = _pair(**{"health.breaker_threshold": 2})
    for _ in range(2):
        arm_both("exec_device_lost")  # EVERY attempt
        with pytest.raises(JFI.InjectedFault):
            js.sql("select sum(v) as sv from t")
        with pytest.raises(TFI.InjectedFault):
            ts.sql("select sum(v) as sv from t")
        reset_both()
    assert _snap(js, ts)["state"] == "open"


def test_breaker_trial_failure_reopens_no_wedge():
    """A half-open trial write failing for a SEMANTIC reason re-arms the
    cooldown — the breaker never wedges in half-open."""
    js, ts = _pair(**{"health.breaker_threshold": 1,
                      "health.breaker_cooldown_s": 0.0})
    _recovered_select(js, ts)  # one recovery: trips at K=1
    assert _snap(js, ts)["state"] == "open"

    def trial(s, L):
        with pytest.raises(ValueError):
            s.sql("create table t (k bigint)")  # trial: duplicate table
        assert s._breaker.snapshot()["state"] == "open"
        assert str(s.sql("create table w2 (x bigint)")) \
            .startswith("CREATE TABLE")

    _each(js, ts, trial)
    assert _snap(js, ts)["state"] == "closed"


def _ok_probe():
    return type("R", (), {"ok": True})()


def test_breaker_reads_never_close_half_open():
    """Only the trial WRITE's verdict moves a half-open breaker."""
    from cloudberry_tpu import lifecycle as JL

    for L in (JL, lifecycle):
        b = L.CircuitBreaker(threshold=1, cooldown_s=0.0,
                             probe_fn=_ok_probe)
        b.record_recovery()
        assert b.snapshot()["state"] == "open"
        assert b.check_write() is True  # this write is the trial
        b.record_success()              # a read completing mid-trial
        assert b.snapshot()["state"] == "half-open"
        with pytest.raises(L.BreakerOpen):
            b.check_write()             # a second write: still degraded
        b.trial_succeeded()
        assert b.snapshot()["state"] == "closed"


def test_breaker_raising_probe_reopens():
    """A probe that RAISES counts as a failed probe: back open with a
    fresh cooldown, never wedged in half-open."""
    from cloudberry_tpu import lifecycle as JL

    def bad_probe():
        raise RuntimeError("probe transport died")

    for L in (JL, lifecycle):
        b = L.CircuitBreaker(threshold=1, cooldown_s=0.0,
                             probe_fn=bad_probe)
        b.record_recovery()
        with pytest.raises(L.BreakerOpen) as ei:
            b.check_write()
        assert "probe raised" in str(ei.value)
        assert b.snapshot()["state"] == "open"
        b._probe_fn = _ok_probe
        assert b.check_write() is True  # the slot recovered


def test_the_session_breaker_probes_its_own_slots():
    """The port's half-open probe runs over the session's device and its
    8 segment slots: a probe that lost a slot is still a clean probe (the
    survivors answer), as the reference's probe of 7 live devices is."""
    js, ts = dist_pair(lambda s: None, nseg=8,
                       **{"health.breaker_threshold": 1,
                          "health.breaker_cooldown_s": 0.0})
    for s in (js, ts):
        s._breaker.record_recovery()
    arm_both("probe_degraded", "skip")
    assert js._breaker.check_write() is ts._breaker.check_write() is True
    _snap(js, ts)
