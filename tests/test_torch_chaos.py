"""Device-loss recovery through the port against the JAX package, on the
CPU: the counterparts of tests/test_chaos.py's retry, degrade and
classifier cases, plus the one-card slot design.

Each case arms the same fault seams in both engines, runs the same SQL
over the same seeded tables, and holds the results, the segment counts
and the counters equal. The port's probe reports one SLOT per segment of
the cluster's healthy epoch (parallel/health.py), so ``probe_degraded``
takes an 8-segment session to 7 segments, as the reference's 8 devices
less one do, and never to 1.
"""

import numpy as np
import pytest
import torch

from cloudberry_tpu_torch import lifecycle
from cloudberry_tpu_torch.exec.cuda_kernels import KernelBuildError
from cloudberry_tpu_torch.parallel import health, mesh
from cloudberry_tpu_torch.parallel.topology import TopologyError
from cloudberry_tpu_torch.utils import faultinject as TFI
from torch_parity import (MONITORS, arm_both, assert_same, chaos_teardown,
                          dist_pair, fired_both, reset_both, same_counters)


@pytest.fixture(autouse=True)
def _clean_faults():
    reset_both()
    yield
    chaos_teardown()


def _pair(nseg=1, n=64, **ov):
    def load(s):
        s.sql("create table t (k bigint, v bigint) distributed by (k)")
        s.catalog.table("t").set_data(
            {"k": np.arange(n, dtype=np.int64),
             "v": (np.arange(n, dtype=np.int64) * 7) % 13})
    return dist_pair(load, nseg=nseg, **{"health.backoff_s": 0.01, **ov})


def _both(js, ts, sql):
    got, want = ts.sql(sql), js.sql(sql)
    assert_same(got, want)
    return got


def _raises_both(js, ts, sql, exc_j, exc_t):
    with pytest.raises(exc_j):
        js.sql(sql)
    with pytest.raises(exc_t):
        ts.sql(sql)


# ---------------------------------------------------- device-loss recovery


def test_device_loss_retries_and_succeeds():
    js, ts = _pair()
    arm_both("exec_device_lost", start_hit=1, end_hit=1)
    got = _both(js, ts, "select sum(v) as sv from t")
    assert int(np.asarray(got.columns["sv"])[0]) == \
        int(((np.arange(64) * 7) % 13).sum())
    assert fired_both("exec_device_lost") == (2, 1)
    assert same_counters(ts, js, ("recoveries",))["recoveries"] == 1


def test_device_loss_exhausts_retries():
    from cloudberry_tpu.utils import faultinject as JFI

    js, ts = _pair()
    arm_both("exec_device_lost")  # every hit
    _raises_both(js, ts, "select sum(v) from t", JFI.InjectedFault,
                 TFI.InjectedFault)
    assert fired_both("exec_device_lost") == (2, 2)
    same_counters(ts, js, ("recoveries",))


def test_non_recoverable_fault_not_retried():
    """dispatch_start is not a device-loss seam: no retry, one hit."""
    from cloudberry_tpu.utils import faultinject as JFI

    js, ts = _pair()
    arm_both("dispatch_start")
    _raises_both(js, ts, "select sum(v) from t", JFI.InjectedFault,
                 TFI.InjectedFault)
    assert fired_both("dispatch_start") == (1, 1)


def test_degraded_mesh_replanning():
    """A device loss and a probe that lost one slot: both engines shrink
    8 -> 7 segments (not 8 -> 1) and the statement completes on 7."""
    js, ts = _pair(nseg=8, n=128)
    q = "select k, v from t where v > 6 order by k"
    before = _both(js, ts, q)
    arm_both("exec_device_lost", start_hit=1, end_hit=1)
    arm_both("probe_degraded", "skip")  # the probe sees 7 slots
    assert_same(_both(js, ts, q), before)
    assert ts.config.n_segments == js.config.n_segments == 7
    assert ts._topology.snapshot()["reason"] == \
        js._topology.snapshot()["reason"] == "degrade"
    # later statements keep running on the degraded layout
    reset_both()
    got = _both(js, ts, "select count(*) as c from t")
    assert int(np.asarray(got.columns["c"])[0]) == 128
    same_counters(ts, js, ("recoveries", "epoch_flips"))


def test_degraded_mesh_skips_mid_list_hole():
    """Slot 3 lost: recovery places over the survivors [0, 1, 2, 4, 5, 6,
    7], not over the first seven slots."""
    js, ts = _pair(nseg=8, n=256)
    q = "select v, count(*) as c from t group by v order by v"
    before = _both(js, ts, q)
    live = [0, 1, 2, 4, 5, 6, 7]
    assert js.degrade_mesh(7, live_ids=live)
    assert ts.degrade_mesh(7, live_ids=live)
    assert ts.config.n_segments == 7
    assert ts._live_device_ids == js._live_device_ids == live
    assert_same(_both(js, ts, q), before)


def test_probe_reports_live_indices():
    from cloudberry_tpu.parallel import health as JH

    js, ts = _pair(nseg=8)
    want, got = JH.probe(), health.probe(ts)
    assert got.ok and want.ok
    assert (got.n_devices, got.live) == (want.n_devices, want.live) \
        == (8, list(range(8)))
    arm_both("probe_degraded", "skip")
    want2, got2 = JH.probe(), health.probe(ts)
    assert (got2.n_devices, got2.live) == (want2.n_devices, want2.live) \
        == (7, list(range(7)))


def test_read_only_classifier():
    from cloudberry_tpu.session import _read_only
    from cloudberry_tpu_torch.sql.classify import read_only

    for q in ("select 1", "  (select 1) union (select 2)",
              "WITH q AS (select 1) select * from q",
              "insert into t values (1)", "create table t (x int)",
              "select nextval('s')"):
        assert read_only(q) == _read_only(q), q


def test_degrade_disabled_still_retries():
    js, ts = _pair(nseg=4, **{"health.degrade": False})
    arm_both("exec_device_lost", start_hit=1, end_hit=1)
    arm_both("probe_degraded", "skip")
    got = _both(js, ts, "select count(*) as c from t")
    assert int(np.asarray(got.columns["c"])[0]) == 64
    assert ts.config.n_segments == js.config.n_segments == 4


def test_dml_never_retried(monkeypatch):
    """A recoverable failure during DML must NOT re-dispatch (the mutation
    may already be applied); during a SELECT it retries."""

    class FakeXla(RuntimeError):
        pass

    FakeXla.__name__ = "XlaRuntimeError"
    js, ts = _pair()
    calls = {"jax": [], "port": []}
    for s, key in ((js, "jax"), (ts, "port")):
        orig = type(s)._sql_once

        def flaky(self, query, _orig=orig, _calls=calls[key], **kw):
            _calls.append(query)
            if len(_calls) == 1:
                # the reference classifies its runtime errors by class
                # name, the port by the device_lost text
                raise FakeXla("device_lost mid-statement")
            return _orig(self, query, **kw)

        monkeypatch.setattr(type(s), "_sql_once", flaky)
    _raises_both(js, ts, "insert into t values (999, 1)", FakeXla, FakeXla)
    assert len(calls["jax"]) == len(calls["port"]) == 1
    for c in calls.values():
        c.clear()
    got = _both(js, ts, "select count(*) as c from t")
    assert len(calls["jax"]) == len(calls["port"]) == 2
    assert int(np.asarray(got.columns["c"])[0]) == 64


def test_retries_zero_disables_recovery():
    from cloudberry_tpu.utils import faultinject as JFI

    js, ts = _pair(**{"health.retries": 0})
    arm_both("exec_device_lost", start_hit=1, end_hit=1)
    _raises_both(js, ts, "select count(*) from t", JFI.InjectedFault,
                 TFI.InjectedFault)
    same_counters(ts, js, ("recoveries",))


def test_tile_step_fault_fails_clean_then_recovers():
    """A fault mid-tile-stream surfaces cleanly, releases the admission
    slot, and the same statement succeeds after disarm."""
    from cloudberry_tpu.utils import faultinject as JFI

    def load(s):
        rng = np.random.default_rng(5)
        s.sql("create table dim (k bigint, g bigint) distributed by (k)")
        s.sql("create table fact (k bigint, v bigint) distributed by (k)")
        s.catalog.table("dim").set_data(
            {"k": np.arange(500), "g": np.arange(500) % 9})
        s.catalog.table("fact").set_data(
            {"k": rng.integers(0, 500, 200_000),
             "v": rng.integers(0, 100, 200_000)})

    js, ts = dist_pair(load, nseg=1, budget=4 << 20,
                       **{"health.retries": 0})
    q = ("select g, sum(v) as sv from fact join dim on fact.k = dim.k "
         "group by g order by g")
    arm_both("tile_step", start_hit=2)
    _raises_both(js, ts, q, JFI.InjectedFault, TFI.InjectedFault)
    reset_both()
    got = _both(js, ts, q)
    assert ts.last_tiled_report["n_tiles"] == \
        js.last_tiled_report["n_tiles"] > 1
    assert got.num_rows() == 9


# ------------------------------------------------------ what re-dispatches


@pytest.mark.parametrize("make", [
    lambda: TFI.InjectedFault("fault injected at 'exec_device_lost'"),
    lambda: RuntimeError("segment slot device_lost"),
])
def test_device_loss_is_recoverable(make):
    assert health.recoverable(make())


@pytest.mark.parametrize("make", [
    # an out-of-memory error, a kernel build failure and a semantic error
    # never re-dispatch, whatever their text says
    lambda: torch.OutOfMemoryError("device_lost: oom"),
    lambda: KernelBuildError("nvcc failed (device_lost)"),
    lambda: lifecycle.StatementCancelled("device_lost while cancelled"),
    lambda: lifecycle.StorageCorruptionError("device_lost checksum"),
    # a CUDA runtime error: a launch fault a re-run repeats, or a sticky
    # context error that no re-dispatch in the process recovers
    lambda: torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered"),
    lambda: RuntimeError("CUDA kernel sorted_seg failed to launch"),
])
def test_what_never_redispatches(make):
    e = make()
    assert not health.recoverable(e)
    calls = []

    def fn():
        calls.append(1)
        raise e

    with pytest.raises(type(e)):
        health.run_with_retry(fn, retries=3, backoff_s=0.0)
    assert calls == [1]


@pytest.mark.parametrize("kind", ["shape", "kernel_build"])
def test_an_epoch_flip_mid_statement_redispatches_only_what_may_succeed(
        kind, monkeypatch):
    """A read whose pinned topology epoch was cut over while it ran is
    re-dispatched at the new epoch on a non-semantic failure (a shape
    error, as in the reference, counted in ``topo_epoch_retries``), but
    never on a kernel build failure."""
    js, ts = _pair(nseg=2)
    sessions = (js, ts) if kind == "shape" else (ts,)
    calls = {id(s): 0 for s in sessions}
    for s in sessions:
        orig = type(s)._sql_once

        def flaky(self, query, _orig=orig, **kw):
            calls[id(self)] += 1
            if calls[id(self)] == 1:
                self._topology.online_resize(3)
                if kind == "shape":
                    raise RuntimeError("shapes (2, 64) and (3, 64) differ")
                raise KernelBuildError("nvcc failed")
            return _orig(self, query, **kw)

        monkeypatch.setattr(type(s), "_sql_once", flaky)
    if kind == "shape":
        got = _both(js, ts, "select count(*) as c from t")
        assert int(np.asarray(got.columns["c"])[0]) == 64
        assert calls[id(ts)] == calls[id(js)] == 2
        assert same_counters(ts, js, ("topo_epoch_retries",)) == \
            {"topo_epoch_retries": 1}
    else:
        with pytest.raises(KernelBuildError):
            ts.sql("select count(*) as c from t")
        assert calls[id(ts)] == 1
    assert ts.config.n_segments == 3


def test_retry_backoff_is_a_traced_span_and_waits_on_the_token():
    """The backoff is a ``recovery-backoff`` span on the statement's trace,
    and a cancel during it cuts it short with StatementCancelled."""
    import threading
    import time

    js, ts = _pair(**{"health.backoff_s": 0.01})
    arm_both("exec_device_lost", start_hit=1, end_hit=1)
    ts.sql("select sum(v) as sv from t")
    spans = [e["name"] for tr in ts.stmt_log.traces() for e in tr["events"]]
    assert "recovery-backoff" in spans
    reset_both()
    js2, ts2 = _pair(**{"health.backoff_s": 30.0,
                        "health.backoff_max_s": 30.0})
    TFI.inject_fault("exec_device_lost", "error")

    def cancel_when_recovering():
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            for sid, h in ts2.stmt_log.active_handles():
                if any(r.get("state") == "recovering"
                       for r in ts2.stmt_log.activity()):
                    h.token.cancel()
                    return
            time.sleep(0.01)

    th = threading.Thread(target=cancel_when_recovering)
    th.start()
    t0 = time.monotonic()
    with pytest.raises(lifecycle.StatementCancelled):
        ts2.sql("select sum(v) from t")
    th.join()
    assert time.monotonic() - t0 < 10.0  # not 30 s of backoff


# ------------------------------------------------------ one-card slot pool


def test_slot_pool_degrades_8_to_7_and_meshes_a_hole():
    """The one-card slot design: a probe that lost a slot takes 8 segments
    to 7 (not 8 -> 1); a hole mid-list places over the survivors, each
    id checked against the slot pool (the healthy 8), so a stale id
    raises; the slots come back on the next clean probe; and an expand
    past ``mesh.MAX_SLOTS`` is refused."""
    js, ts = _pair(nseg=8)
    assert health.slot_count(ts) == 8
    arm_both("probe_degraded", "skip")
    r = health.probe(ts)
    assert r.live == list(range(7))
    reset_both()
    assert ts.degrade_mesh(7, live_ids=[0, 1, 2, 4, 5, 6, 7])
    assert (ts.config.n_segments, health.slot_count(ts)) == (7, 8)
    assert ts._topology.current.device_ids == (0, 1, 2, 4, 5, 6, 7)
    assert health.probe(ts).live == list(range(8))
    with pytest.raises(mesh.DeviceRestrictionError) as ei:
        mesh.host_topology(7, [0, 1, 2, 4, 5, 6, 8], health.slot_count(ts))
    assert ei.value.kind == "stale"
    with pytest.raises(mesh.DeviceRestrictionError) as ei:
        mesh.host_topology(7, [0, 1, 1, 4, 5, 6, 7], 8)
    assert ei.value.kind == "invalid"
    got = ts.sql("select count(*) as c from t")
    assert int(np.asarray(got.columns["c"])[0]) == 64
    assert 12 <= mesh.MAX_SLOTS < 4096
    ts2 = _pair(nseg=2)[1]
    state = ts2._topology.begin(12)
    assert state.target.nseg == 12
    ts2._topology.abandon()
    with pytest.raises(TopologyError):
        ts2._topology.begin(mesh.MAX_SLOTS + 1)


def test_health_monitor_thread_is_named_and_joined():
    import threading

    js, ts = _pair(nseg=8)
    mon = health.HealthMonitor(interval_s=0.01, topology=ts._topology)
    MONITORS.append(mon)
    mon.start()
    names = [t.name for t in threading.enumerate()]
    assert "cbtpu_torch-fts-probe" in names
    mon.stop()
    MONITORS.remove(mon)
    assert "cbtpu_torch-fts-probe" not in \
        [t.name for t in threading.enumerate()]
    assert mon.history.maxlen == 256
