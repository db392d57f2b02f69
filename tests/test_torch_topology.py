"""The engine half of the topology plane (parallel/topology.py) through
the port against the JAX package, on the CPU: the counterparts of
tests/test_topology.py's epoch, rebalance, store, failover, cache-token,
mid-statement cutover and verify-gate cases.

Each case drives both engines through the same resizes, probes and
statements over the same seeded tables and holds the results, the epoch
records, the rebalance totals (moved rows within 1.25x of the jump hash's
minimal bound) and the counters equal. Store-backed cases give each engine
a root of its own. The serving half: ``mgmt expand --online`` through the
port's CLI lands where the offline expand and the JAX package's online
expand land, and port wire clients keep sending through an online expand
and a failover shrink with no request dropped, every answer equal to a
static port session's.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from cloudberry_tpu_torch.parallel.topology import TopologyError
from torch_parity import (MONITORS, arm_both, assert_same, carry_tables,
                          chaos_teardown, count_calls, dist_pair,
                          reset_both, same_counters)

_Q = "select sum(v) as sv, count(*) as c from t"
_BACKOFF = {"health.backoff_s": 0.01, "health.backoff_max_s": 0.05}


@pytest.fixture(autouse=True)
def _clean_faults():
    reset_both()
    yield
    chaos_teardown()


def _load(n):
    def load(s):
        s.sql("create table t (k bigint, v bigint) distributed by (k)")
        s.catalog.table("t").set_data(
            {"k": np.arange(n, dtype=np.int64),
             "v": (np.arange(n, dtype=np.int64) * 3) % 97}, {})
    return load


def _pair(nseg=4, n=20000, **ov):
    return dist_pair(_load(n), nseg=nseg, **{**_BACKOFF, **ov})


def _both(js, ts, sql):
    got, want = ts.sql(sql), js.sql(sql)
    assert_same(got, want)
    return got


def _same_out(got: dict, want: dict) -> dict:
    """Two cutover records equal but for the flip's wall clock."""
    g = {k: v for k, v in got.items() if k != "cutover_ms"}
    w = {k: v for k, v in want.items() if k != "cutover_ms"}
    assert g == w, (g, w)
    return got


def _same_snap(js, ts) -> dict:
    """Both managers' snapshots equal but for the epochs' creation
    times."""
    def strip(snap):
        out = dict(snap)
        out["history"] = [{k: v for k, v in h.items() if k != "created"}
                          for h in snap["history"]]
        if out["pending"]:
            out["pending"] = {k: v for k, v in out["pending"].items()
                              if k != "created"}
        return out

    got, want = strip(ts._topology.snapshot()), strip(
        js._topology.snapshot())
    assert got == want, (got, want)
    return got


def _resize(js, ts, n):
    return _same_out(ts._topology.online_resize(n),
                     js._topology.online_resize(n))


# ------------------------------------------------------ epochs + resize


def test_online_expand_minimal_movement_and_identical_results():
    js, ts = _pair(4)
    before = _both(js, ts, _Q)
    assert ts._topology.current.epoch_id == 1
    out = _resize(js, ts, 6)
    assert out["epoch"] == 2 and ts.config.n_segments == 6
    reb = out["rebalance"]
    frac = reb["moved_rows"] / reb["total_rows"]
    assert reb["minimal_bound"] == pytest.approx(1 / 3, abs=1e-4)
    assert 0.5 * reb["minimal_bound"] <= frac <= 1.25 * reb["minimal_bound"]
    assert_same(_both(js, ts, _Q), before)
    c = same_counters(ts, js, ("epoch_flips", "topo_moved_rows",
                               "topo_moved_bytes",
                               "topo_rebalance_chunks"))
    assert c["epoch_flips"] == 1 and c["topo_moved_rows"] == \
        reb["moved_rows"]


def test_online_shrink_back_identical():
    js, ts = _pair(6)
    before = _both(js, ts, _Q)
    out = _resize(js, ts, 4)
    assert out["reason"] == "shrink"
    reb = out["rebalance"]
    assert reb["minimal_bound"] == pytest.approx(2 / 6, abs=1e-4)
    assert reb["moved_rows"] / reb["total_rows"] <= \
        1.25 * reb["minimal_bound"]
    assert_same(_both(js, ts, _Q), before)


def test_staged_assignment_matches_fresh_hash():
    """The rebalancer's staged successor assignment equals the jump hash
    the placement layer derives (and the JAX package's stage); after the
    cutover it IS what placement serves."""
    js, ts = _pair(4)
    states = [s._topology.begin(6) for s in (js, ts)]
    for s in (js, ts):
        s._topology.rebalance()
    jt, tt = js.catalog.table("t"), ts.catalog.table("t")
    staged = tt._topo_assign
    assert staged[1] == 6 and np.array_equal(staged[2], jt._topo_assign[2])
    tt._placement_cache = None   # a fresh hash, not the stage
    saved, tt._topo_assign = tt._topo_assign, None
    assert np.array_equal(staged[2], tt.shard_assignment(6))
    tt._topo_assign, tt._placement_cache = saved, None
    assert all(st.done for st in states)
    for s in (js, ts):
        s._topology.cutover()
    assert tt.shard_assignment(6) is staged[2]


def test_begin_refuses_second_change_and_oversize():
    from cloudberry_tpu.parallel.topology import TopologyError as JTE

    js, ts = _pair(2, n=64)
    for s, err in ((js, JTE), (ts, TopologyError)):
        s._topology.begin(4)
        with pytest.raises(err):
            s._topology.begin(3)
        s._topology.abandon()
        with pytest.raises(err):
            s._topology.begin(4096)  # past the device / slot pool
        with pytest.raises(err):
            s._topology.cutover()  # nothing in flight after abandon


def test_planned_cutover_refuses_while_breaker_open():
    from cloudberry_tpu.parallel.topology import TopologyError as JTE

    js, ts = _pair(2, n=64)
    for s, err in ((js, JTE), (ts, TopologyError)):
        s._topology.begin(4)
        s._topology.rebalance()
        s._breaker.state = "open"
        s._breaker._opened_at = time.monotonic()
        with pytest.raises(err):
            s._topology.cutover()
        s._breaker.state = "closed"
        assert s._topology.cutover()["nseg"] == 4


def test_statement_pins_epoch_on_handle():
    js, ts = _pair(2, n=64)
    _both(js, ts, _Q)
    assert ts.stmt_log.recent(1)[0]["sql"].startswith("select")
    assert ts._topology.active_on(1) == js._topology.active_on(1) == 0
    _resize(js, ts, 3)
    _both(js, ts, _Q)
    assert ts._topology.active_on(2) == js._topology.active_on(2) == 0


# ------------------------------------------------------- store movement


def _store_one(engine, root, nseg, n, parts, **ov):
    import cloudberry_tpu as cb
    import cloudberry_tpu_torch as ct

    over = {"n_segments": nseg, "storage.root": str(root),
            "storage.rows_per_partition": parts, **_BACKOFF, **ov}
    if engine == "jax":
        s = cb.Session(cb.get_config().with_overrides(
            **{"sched.generic_plans": False, **over}))
    else:
        s = ct.Session(ct.Config().with_overrides(**over), device="cpu")
    if n:
        s.sql("create table t (k bigint, v bigint) distributed by (k)")
        t = s.catalog.table("t")
        t.set_data({"k": np.arange(n, dtype=np.int64),
                    "v": (np.arange(n, dtype=np.int64) * 3) % 97}, {})
        t._store_version = s.store.save_table(t, rows_per_partition=parts)
        s._sync_store()
    return s


def _store_pair(tmp_path, nseg=4, n=5000, parts=1000, **ov):
    return (_store_one("jax", tmp_path / "jax", nseg, n, parts, **ov),
            _store_one("port", tmp_path / "port", nseg, n, parts, **ov))


def test_store_rebalance_moves_minimal_delta(tmp_path):
    js, ts = _store_pair(tmp_path)
    before = _both(js, ts, _Q)
    rows = "select k, v from t order by k"
    rows_before = _both(js, ts, rows)
    out = _resize(js, ts, 6)
    reb = out["rebalance"]
    frac = reb["moved_rows"] / reb["total_rows"]
    assert 0.5 * reb["minimal_bound"] <= frac <= 1.25 * reb["minimal_bound"]
    man = ts.store.read_manifest("t")
    delta = [p for p in man["partitions"] if p.get("seg_nseg") == 6]
    assert delta, "physical movement must produce delta partitions"
    assert sum(p["num_rows"] for p in delta) == reb["moved_rows"]
    jdelta = [p for p in js.store.read_manifest("t")["partitions"]
              if p.get("seg_nseg") == 6]
    assert sorted((p["seg"], p["num_rows"]) for p in delta) == \
        sorted((p["seg"], p["num_rows"]) for p in jdelta)
    assert all(0 <= p["seg"] < 6 for p in delta)
    assert_same(_both(js, ts, _Q), before)
    assert_same(_both(js, ts, rows), rows_before)
    # a FRESH session over the store adopts the committed epoch
    js2 = _store_one("jax", tmp_path / "jax", 6, 0, 1000)
    ts2 = _store_one("port", tmp_path / "port", 6, 0, 1000)
    assert ts2._topology.current.epoch_id == \
        js2._topology.current.epoch_id == out["epoch"]
    assert_same(_both(js2, ts2, rows), rows_before)


def test_store_rebalance_resumes_from_journal(tmp_path):
    from cloudberry_tpu.utils import faultinject as JFI
    from cloudberry_tpu_torch.utils import faultinject as TFI

    js, ts = _store_pair(tmp_path)
    rows = "select k, v from t order by k"
    expected = _both(js, ts, rows)
    for s, FI in ((js, JFI), (ts, TFI)):
        s._topology.begin(6)
        FI.inject_fault("topo_rebalance_chunk", "error", start_hit=3,
                        end_hit=3)
        with pytest.raises(FI.InjectedFault):
            s._topology.rebalance()
    reset_both()
    journals = [json.load(open(os.path.join(str(tmp_path / e),
                                            "_TOPOLOGY.json")))["pending"]
                for e in ("jax", "port")]
    for j in journals:
        j["done_files"] = sum(len(v) for v in j["done_files"].values())
    assert journals[1] == journals[0]
    assert journals[1]["done_files"] >= 1
    # a FRESH manager (crash-restart analog) resumes from the journal
    outs = []
    for e in ("jax", "port"):
        s2 = _store_one(e, tmp_path / e, 4, 0, 1000)
        state = s2._topology.begin(6)
        assert state.moved_rows == journals[1]["moved_rows"]
        assert sum(len(v) for v in state.done_files.values()) == \
            journals[1]["done_files"]
        s2._topology.rebalance()
        outs.append((s2, s2._topology.cutover()))
    (js2, jout), (ts2, tout) = outs
    reb = _same_out(tout, jout)["rebalance"]
    assert reb["moved_rows"] / max(reb["total_rows"], 1) <= \
        1.25 * reb["minimal_bound"]
    assert_same(_both(js2, ts2, rows), expected)


def test_store_rebalance_occ_survives_concurrent_append(tmp_path):
    """A concurrent commit mid-rebalance loses nothing: the chunk's OCC
    check re-reads, and rows appended during the move keep serving."""
    js, ts = _store_pair(tmp_path)
    for e, s in (("jax", js), ("port", ts)):
        def writer(e=e):
            s2 = _store_one(e, tmp_path / e, 4, 0, 1000)
            t = s2.catalog.table("t")
            t.ensure_loaded()
            s2.store.append(
                "t", {"k": np.arange(90000, 90007, dtype=np.int64),
                      "v": np.full(7, 7, dtype=np.int64)},
                t.schema, rows_per_partition=1000)

        w = threading.Thread(target=writer)
        s._topology.begin(6)
        w.start()
        s._topology.rebalance(throttle_s=0.002)
        w.join()
        s._topology.cutover()
    got = _both(js, ts, "select count(*) as c, sum(v) as sv from t")
    base = int(((np.arange(5000) * 3) % 97).sum())
    assert int(np.asarray(got.columns["c"])[0]) == 5007
    assert int(np.asarray(got.columns["sv"])[0]) == base + 49


# --------------------------------------------- failover / recovery path


def _probe_result(n):
    from cloudberry_tpu.parallel.health import ProbeResult as JP
    from cloudberry_tpu_torch.parallel.health import ProbeResult as TP

    return (JP(True, n, 0.0, live=list(range(n))),
            TP(True, n, 0.0, live=list(range(n))))


def _note_both(js, ts, n):
    jr, tr = _probe_result(n)
    js._topology.note_probe(jr)
    ts._topology.note_probe(tr)


def _heal_both(js, ts):
    """One explicit probe → state-machine round in each engine: the
    reference probes its 8 devices, the port its session's slots."""
    js._topology.probe_and_heal()
    ts._topology.probe_and_heal()


def test_failover_promotion_then_recovery_expand():
    js, ts = _pair(8, n=8000, **{"health.retries": 3,
                                 "topology.promote_after": 2,
                                 "topology.recover_after": 2})
    before = _both(js, ts, _Q)
    # persistent loss: every probe reports one slot gone, and two
    # transient losses -> probe -> degrade -> the SAME survivor set seen
    # twice promotes to a formal failover-shrink epoch (8 -> 7)
    arm_both("probe_degraded", "skip", end_hit=1 << 30)
    arm_both("exec_device_lost", start_hit=1, end_hit=2)
    assert_same(_both(js, ts, _Q), before)
    snap = _same_snap(js, ts)
    assert snap["reason"] == "failover" and snap["nseg"] == 7
    assert snap["promotions"] == 1 and ts.config.n_segments == 7
    # the slots come back: consecutive clean probes expand back
    reset_both()
    for _ in range(2):
        _heal_both(js, ts)
    snap = _same_snap(js, ts)
    assert snap["reason"] == "recover" and snap["nseg"] == 8
    assert ts.config.n_segments == 8
    assert_same(_both(js, ts, _Q), before)
    same_counters(ts, js, ("recoveries", "epoch_flips", "topo_promotions"))


def test_promote_seam_suppresses_promotion():
    js, ts = _pair(8, n=2000, **{"health.retries": 3,
                                 "topology.promote_after": 1})
    arm_both("probe_degraded", "skip", end_hit=1 << 30)
    arm_both("topo_promote", "skip", end_hit=1 << 30)
    arm_both("exec_device_lost", start_hit=1, end_hit=1)
    _both(js, ts, _Q)
    snap = _same_snap(js, ts)
    assert snap["promotions"] == 0 and snap["reason"] == "degrade"
    assert ts.config.n_segments == 7


def test_second_deeper_loss_promotes_again():
    js, ts = _pair(8, n=256, **{"topology.promote_after": 1,
                                "topology.recover_after": 2})
    _note_both(js, ts, 7)
    snap = _same_snap(js, ts)
    assert snap["reason"] == "failover" and snap["nseg"] == 7
    _note_both(js, ts, 6)
    snap = _same_snap(js, ts)
    assert snap["nseg"] == 6 and snap["promotions"] == 2
    _note_both(js, ts, 6)  # the SAME survivor set: no re-promotion
    assert _same_snap(js, ts)["promotions"] == 2
    for _ in range(2):
        _note_both(js, ts, 8)
    snap = _same_snap(js, ts)
    assert snap["reason"] == "recover" and snap["nseg"] == 8


def test_planned_resize_resets_failover_baseline():
    js, ts = _pair(8, n=256, **{"topology.promote_after": 1,
                                "topology.recover_after": 1})
    _note_both(js, ts, 7)
    assert _same_snap(js, ts)["reason"] == "failover"
    _resize(js, ts, 4)
    _note_both(js, ts, 7)
    snap = _same_snap(js, ts)
    assert snap["reason"] == "shrink" and snap["nseg"] == 4
    assert ts.config.n_segments == 4


def test_recovery_deferred_while_breaker_open():
    js, ts = _pair(8, n=256, **{"topology.promote_after": 1,
                                "topology.recover_after": 1})
    _note_both(js, ts, 7)
    assert _same_snap(js, ts)["reason"] == "failover"
    for s in (js, ts):
        s._breaker.state = "open"
        s._breaker._opened_at = time.monotonic()
    jr, tr = _probe_result(8)
    assert js._topology.note_probe(jr) is None
    assert ts._topology.note_probe(tr) is None
    assert _same_snap(js, ts)["nseg"] == 7  # deferred, not dead
    for s in (js, ts):
        s._breaker.state = "closed"
    _note_both(js, ts, 8)
    snap = _same_snap(js, ts)
    assert snap["reason"] == "recover" and snap["nseg"] == 8


def test_health_monitor_feeds_topology():
    from cloudberry_tpu.parallel import health as JH
    from cloudberry_tpu_torch.parallel import health as TH

    js, ts = _pair(8, n=500, **{"topology.promote_after": 2})
    mons = [JH.HealthMonitor(interval_s=3600, topology=js._topology),
            TH.HealthMonitor(interval_s=3600, topology=ts._topology)]
    MONITORS.extend(mons)
    arm_both("probe_degraded", "skip", end_hit=1 << 30)
    for m in mons:
        m.probe_now()
        m.probe_now()
    snap = _same_snap(js, ts)
    assert snap["reason"] == "failover" and snap["nseg"] == 7


# --------------------------------------- shared-cache epoch token


def test_epoch_token_rides_every_shared_cache_key():
    from cloudberry_tpu.sched import sharedcache as JSC
    from cloudberry_tpu_torch.sched import sharedcache as TSC

    js, ts = _pair(4, n=512)
    tok1, pe1 = TSC.topology_token(ts), TSC.plan_epoch(ts)
    assert tok1 == JSC.topology_token(js) == 1
    _resize(js, ts, 6)
    tok2 = TSC.topology_token(ts)
    assert tok2 == JSC.topology_token(js) == tok1 + 1
    assert tok1 in pe1 and tok2 in TSC.plan_epoch(ts)


def test_stale_nseg_plan_never_serves_after_cutover(tmp_path, monkeypatch):
    """Collapse config_uid so that after a 4 -> 6 -> 4 round trip the
    epoch-1 and epoch-3 key prefixes differ only in the topology token;
    the round trip re-lowers the statement (the port has no jit: its
    "compile" is ``compile_distributed``) and the answer is unchanged."""
    from cloudberry_tpu.sched import sharedcache as JSC
    from cloudberry_tpu_torch.exec import dist_executor as DX
    from cloudberry_tpu_torch.sched import sharedcache as TSC

    js, ts = _store_pair(tmp_path, nseg=4, n=2000)
    for SC in (JSC, TSC):
        monkeypatch.setattr(SC, "config_uid", lambda cfg: 0)
    q = "select k % 8 as g, sum(v) as sv from t group by g order by g"
    first = _both(js, ts, q)
    pe1 = TSC.plan_epoch(ts)
    assert pe1[0] == "store"
    _resize(js, ts, 6)
    _resize(js, ts, 4)  # the same nseg as epoch 1 again
    pe3 = TSC.plan_epoch(ts)
    assert pe1 != pe3 and (pe1[0],) + pe1[2:] == (pe3[0],) + pe3[2:]
    assert pe3[1] == pe1[1] + 2 == JSC.plan_epoch(js)[1]
    calls = count_calls(monkeypatch, DX, {"c": "compile_distributed"})
    c1 = js.stmt_log.counter("compiles")
    assert_same(_both(js, ts, q), first)
    assert calls["c"] >= 1 and js.stmt_log.counter("compiles") > c1


def test_a_statement_straddling_a_cutover_answers_on_its_own_layout():
    """A cached 4-segment statement held at its dispatch seam while
    another thread cuts the session over to 8 segments (no drain wait)
    finishes on the layout it started under: every row counted, and no
    re-dispatch. Its runner used to read the shard layouts of the new
    config, 8 segments for a 4-segment gang, and dropped the rows of
    segments 4-7 (a wrong answer with no error, ROADMAP C 59)."""
    from cloudberry_tpu_torch import Config, Session
    from cloudberry_tpu_torch.utils import faultinject as FI

    s = Session(Config(n_segments=4).with_overrides(**_BACKOFF),
                device="cpu")
    _load(20000)(s)
    want = s.sql(_Q).decoded_columns()
    out = []
    FI.inject_fault("dispatch_start", "hang", sleep_s=30)
    th = threading.Thread(target=lambda: out.append(
        s.sql(_Q).decoded_columns()))
    th.start()
    deadline = time.monotonic() + 30
    while FI.list_faults()["armed"]["dispatch_start"]["fired"] < 1:
        assert time.monotonic() < deadline, "the statement never dispatched"
        time.sleep(0.005)
    rec = s._topology.online_resize(8, wait_s=0)
    assert rec["stragglers"] == 1 and s.config.n_segments == 8
    FI.reset_fault()
    th.join(timeout=30)
    assert not th.is_alive() and len(out) == 1
    assert {k: v.tolist() for k, v in out[0].items()} \
        == {k: v.tolist() for k, v in want.items()}
    assert s.stmt_log.counter("recoveries") == 0
    assert s.sql(_Q).decoded_columns()["c"].tolist() == [20000]


def test_join_index_key_carries_epoch_token(tmp_path):
    from cloudberry_tpu_torch.sched import sharedcache as TSC

    js, ts = _store_pair(tmp_path, nseg=2, n=512)
    for s in (js, ts):
        s.sql("create table d (k bigint, w bigint) distributed by (k)")
        s.catalog.table("d").set_data(
            {"k": np.arange(64, dtype=np.int64),
             "w": np.arange(64, dtype=np.int64)}, {})
    q = "select sum(t.v) as sv from t join d on t.k = d.k"
    r1 = _both(js, ts, q)
    before = list(ts._cache_scope.joinindex)
    _resize(js, ts, 3)
    assert_same(_both(js, ts, q), r1)
    tok = TSC.topology_token(ts)
    new = [k for k in ts._cache_scope.joinindex if k not in before]
    # the port keys end (topology epoch, device)
    for k in new:
        assert k[-2] == tok
    for k in before:
        assert k[-2] != tok
    assert not (set(before) & set(ts._cache_scope.joinindex))


def test_topology_gauges_match_jax():
    """The gauges the reference's ``meta topology`` verb reads: the
    serving epoch, its segment count, the rebalance fraction and the
    bytes moved."""
    from cloudberry_tpu.obs import capacity as JC
    from cloudberry_tpu_torch.obs import capacity as TC

    js, ts = _pair(2, n=256)
    _resize(js, ts, 3)
    keys = ("topo_epoch", "topo_nseg", "topo_rebalance_fraction",
            "topo_moved_bytes")
    got, want = TC.refresh_gauges(ts), JC.refresh_gauges(js)
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["topo_epoch"] == 2 and got["topo_nseg"] == 3
    assert got["topo_moved_bytes"] > 0
    snap = ts.stmt_log.registry.snapshot()
    assert snap["gauges"]["topo_epoch"] == 2
    assert snap["counters"]["epoch_flips"] == 1


# -------------------------------------------------- mid-statement flip


def test_checkpointed_statement_resumes_across_expand_cutover():
    """A tiled distributed statement killed mid-stream resumes AFTER an
    online expand cutover landed between attempts: the degraded re-shard
    path re-places its checkpoint at the LARGER segment count (6 -> 8),
    equal to the uninterrupted run in both engines."""
    from cloudberry_tpu.utils import faultinject as JFI
    from cloudberry_tpu_torch.utils import faultinject as TFI

    def load(s):
        # distributed by k, grouped by g: a TWO-STAGE agg whose partials
        # re-place across a changed nseg
        s.sql("create table big (k bigint, g bigint, v bigint) "
              "distributed by (k)")
        n = 400_000
        rng = np.random.default_rng(7)
        s.catalog.table("big").set_data(
            {"k": np.arange(n, dtype=np.int64) % 997,
             "g": rng.integers(0, 9, n).astype(np.int64),
             "v": rng.integers(0, 1000, n).astype(np.int64)}, {})

    js, ts = dist_pair(load, nseg=6, budget=512 << 10, **{
        "recovery.checkpoint_every": 2, "health.retries": 2,
        "health.backoff_s": 0.5, "health.backoff_max_s": 0.5})
    q = "select g, sum(v) as sv from big group by g order by g"
    expected = _both(js, ts, q)
    assert ts.last_tiled_report["n_tiles"] == \
        js.last_tiled_report["n_tiles"] >= 5
    results = []
    for s, FI in ((js, JFI), (ts, TFI)):
        FI.inject_fault("tile_device_lost", "error", start_hit=4,
                        end_hit=4)
        done = {}
        th = threading.Thread(target=lambda s=s: done.setdefault(
            "b", s.sql(q)))
        th.start()
        deadline = time.monotonic() + 30
        rows = []
        while time.monotonic() < deadline and not rows:
            rows = [r for r in s.stmt_log.activity()
                    if r.get("state") == "recovering"]
            time.sleep(0.005)
        assert rows, "statement never entered recovery"
        s._topology.begin(8)
        s._topology.rebalance()
        s._topology.cutover(wait_s=0.0)  # flip under the statement
        th.join(timeout=120)
        results.append(done["b"])
        assert s.config.n_segments == 8
    assert_same(results[1], results[0])
    assert_same(results[1], expected)
    c = same_counters(ts, js, ("tile_resumes", "topo_resharded_resumes",
                               "tiles_replayed", "recoveries"))
    assert c["tile_resumes"] >= 1 and c["topo_resharded_resumes"] >= 1


# ------------------------------------- the verify gate after a cutover


def test_post_cutover_replans_pass_the_verify_gate():
    """After an online expand, fresh plans run through the verification
    gate (ON here) clean, equal to the pre-expand results."""
    js, ts = _pair(4, n=4000, **{"debug.verify_plans": True})
    for s in (js, ts):
        s.sql("create table d (k bigint, w bigint) distributed by (k)")
        s.catalog.table("d").set_data(
            {"k": np.arange(256, dtype=np.int64),
             "w": np.arange(256, dtype=np.int64)}, {})
    qs = [_Q,
          "select k % 7 as g, sum(v) as sv from t group by g order by g",
          "select sum(t.v) as sv from t join d on t.k = d.k",
          "select k, v from t order by v desc, k limit 5"]
    before = [_both(js, ts, q) for q in qs]
    _resize(js, ts, 8)
    for q, b in zip(qs, before):
        assert_same(_both(js, ts, q), b)
    assert ts._verify_next_plans == js._verify_next_plans >= 0


def test_adoption_verify_window_fires_without_debug_gate(monkeypatch):
    """topology.verify_replans: the first fresh plans after an epoch
    adoption are verified even with debug.verify_plans off."""
    from cloudberry_tpu.plan import verify as JV
    from cloudberry_tpu_torch.plan import verify as TV

    calls = {"jax": [], "port": []}
    for V, key in ((JV, "jax"), (TV, "port")):
        real = V.check_plan

        def spy(plan, session, context="", _real=real, _c=calls[key],
                **kw):
            _c.append(context)
            return _real(plan, session, context, **kw)

        monkeypatch.setattr(V, "check_plan", spy)
    js, ts = _pair(2, n=256)
    _both(js, ts, _Q)
    assert calls == {"jax": [], "port": []}  # gate off: no verification
    _resize(js, ts, 3)
    _both(js, ts, "select sum(v) as x from t where k < 100")
    assert calls["port"] == calls["jax"] and calls["port"]


# ------------------------------------------------------------ mgmt CLI


def _init_store(tmp_path, name, engine, nseg=4, n=3000):
    """A cluster store (``mgmt init``) holding ``t`` in 500-row
    partitions, written by ``engine``."""
    import importlib

    cli = importlib.import_module(
        "cloudberry_tpu_torch.mgmt.cli" if engine == "port"
        else "cloudberry_tpu.mgmt.cli")
    root = os.path.join(str(tmp_path), name)
    assert cli.main(["--store", root, "init", "--segments",
                     str(nseg)]) == 0
    _store_one(engine, root, nseg, n, 500)
    return root


def test_mgmt_expand_online_matches_offline_and_jax(tmp_path, capsys):
    """``expand --online`` through the port's CLI reports the moved rows
    against the delta/N bound exactly as the JAX package's CLI does, and
    lands on the same placement and relation as the port's offline
    expand and the JAX package's online expand."""
    import re

    import cloudberry_tpu as cb
    import cloudberry_tpu_torch as ct
    from cloudberry_tpu.mgmt import cli as JC
    from cloudberry_tpu_torch.mgmt import cli as TC

    roots = {k: _init_store(tmp_path, k, "jax" if k == "jax" else "port")
             for k in ("jax", "on", "off")}
    capsys.readouterr()
    assert JC.main(["--store", roots["jax"], "expand", "--segments", "6",
                    "--online"]) == 0
    jout = capsys.readouterr().out
    assert TC.main(["--device", "cpu", "--store", roots["on"], "expand",
                    "--segments", "6", "--online"]) == 0
    tout = capsys.readouterr().out
    strip = re.compile(r"cutover [0-9.]+ ms")
    assert strip.sub("", tout) == strip.sub("", jout)
    assert "ONLINE" in tout and "minimal-movement bound" in tout
    assert TC.main(["--device", "cpu", "--store", roots["off"], "expand",
                    "--segments", "6"]) == 0
    capsys.readouterr()
    for r in roots.values():
        assert json.load(open(os.path.join(r, "cluster.json")))[
            "n_segments"] == 6
    q = "select k, v from t order by k"
    sess = {k: ct.Session(ct.Config(n_segments=6).with_overrides(
        **{"storage.root": roots[k]}), device="cpu") for k in ("on", "off")}
    js = cb.Session(cb.get_config().with_overrides(**{
        "n_segments": 6, "storage.root": roots["jax"],
        "sched.generic_plans": False}))
    want = js.sql(q)
    for k in ("on", "off"):
        assert_same(sess[k].sql(q), want)

    def placement(s):
        t = s.catalog.table("t")
        t.ensure_loaded()
        return t.shard_assignment(6)[np.argsort(
            np.asarray(t.data["k"]), kind="stable")]

    assert np.array_equal(placement(sess["on"]), placement(sess["off"]))
    assert np.array_equal(placement(sess["on"]), placement(js))
    assert sess["on"]._topology.current.epoch_id \
        == js._topology.current.epoch_id >= 2
    assert sess["off"]._topology.current.epoch_id == 1


# ------------------------------------------- cutover under wire load


def _sql_for(i):
    if i % 3 == 0:
        return ("select sum(v) as sv, count(*) as c from t "
                f"where k < {1000 + (i % 7) * 100}")
    if i % 3 == 1:
        return f"select k, v from pts where k = {(i * 37) % 2000}"
    return ("select k % 5 as g, sum(v) as sv from t "
            f"where v < {90 - (i % 4)} group by g order by g")


def _port_session(nseg, **ov):
    import cloudberry_tpu_torch as ct

    s = ct.Session(ct.Config(n_segments=nseg).with_overrides(**ov),
                   device="cpu")
    _load(4000)(s)
    s.sql("create table pts (k bigint, v bigint) distributed by (k)")
    s.catalog.table("pts").set_data(
        {"k": np.arange(2000, dtype=np.int64),
         "v": (np.arange(2000, dtype=np.int64) * 11) % 1009}, {})
    return s


def test_cutover_under_wire_load_expand_and_failover_shrink():
    """Port wire clients keep sending through ``online_resize(8)`` and a
    failover shrink to 7 (a persistent slot loss the probes keep
    reporting, two transient device losses) with no request dropped;
    every recorded answer equals a static 4-segment port session's
    (JAX ``tests/test_topology.py::
    test_cutover_under_load_expand_and_failover_shrink``). Each step
    waits for fresh answers under a deadline, never for a fixed time."""
    from cloudberry_tpu_torch.serve import Client, Server, ServerError
    from cloudberry_tpu_torch.serve.server import _json_safe
    from cloudberry_tpu_torch.utils import faultinject as FI

    # the reference's test settings (one statement at a time; the
    # clients still send concurrently)
    s = _port_session(4, **{"health.retries": 4, **_BACKOFF,
                            "topology.promote_after": 2,
                            "resource.max_concurrency": 1,
                            "debug.verify_plans": True})
    results: dict = {}
    answered = [0]
    lock = threading.Lock()
    errors: list = []
    stop = threading.Event()

    def client(srv, wid):
        try:
            with Client(srv.host, srv.port, timeout=120) as c:
                i = wid * 1009
                while not stop.is_set():
                    q = _sql_for(i)
                    i += 1
                    try:
                        out = c.sql(q)
                    except ServerError as e:
                        if getattr(e, "retryable", False):
                            continue
                        raise
                    with lock:
                        results.setdefault(q, []).append(out.get("rows"))
                        answered[0] += 1
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(f"{type(e).__name__}: {e}")

    def answers_after(n, what):
        deadline = time.monotonic() + 120
        with lock:
            target = answered[0] + n
        while time.monotonic() < deadline and not errors:
            with lock:
                if answered[0] >= target:
                    return
            time.sleep(0.01)
        raise AssertionError(f"no {n} answers {what}: {errors[:3]}")

    with Server(session=s) as srv:
        threads = [threading.Thread(target=client, args=(srv, i))
                   for i in range(4)]
        for t in threads:
            t.start()
        try:
            answers_after(12, "before the expand")
            assert s._topology.online_resize(8)["nseg"] == 8
            answers_after(12, "after the expand")
            FI.inject_fault("probe_degraded", "skip", end_hit=1 << 30)
            FI.inject_fault("exec_device_lost", "error", start_hit=1,
                            end_hit=2)
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and \
                    s._topology.snapshot()["reason"] != "failover":
                time.sleep(0.02)
            FI.reset_fault()
            snap = s._topology.snapshot()
            assert snap["reason"] == "failover" and snap["nseg"] == 7
            answers_after(12, "after the failover shrink")
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=120)
    assert not errors, f"dropped/errored requests: {errors[:3]}"
    assert s.stmt_log.counter("epoch_flips") >= 2
    assert s.stmt_log.counter("topo_promotions") >= 1
    static = _port_session(4)

    def wire_rows(result):
        arrays = list(result.decoded_columns().values())
        n = len(arrays[0]) if arrays else 0
        return [[_json_safe(a[i]) for a in arrays] for i in range(n)]

    for q, answers in sorted(results.items()):
        want = wire_rows(static.sql(q))
        assert all(rows == want for rows in answers), \
            f"divergent result for {q!r}"


def test_point_lookup_after_a_resize_unlike_jax():
    """A point lookup's sorted sidecar is derived from one segment's
    shard, whose rows depend on the segment count; an online resize keeps
    the table's version. The reference keys the sidecar by version alone,
    so after 4 → 8 its direct-dispatched lookups index the new shard with
    the old shard's rows and miss; the port keys it by the segment count
    too and answers as a static 8-segment session does (ROADMAP Queue
    C 49; shards above the sidecar's 32,768-row floor). The reference
    runs at its defaults here, generic plans on: with them off its
    lookups re-plan on the host and happen to miss the stale entry."""
    import cloudberry_tpu as cb
    import cloudberry_tpu_torch as ct

    n = 300_000

    def load(s):
        s.sql("create table pts (k bigint, v bigint) distributed by (k)")
        s.catalog.table("pts").set_data(
            {"k": np.arange(n, dtype=np.int64),
             "v": (np.arange(n, dtype=np.int64) * 11) % 1009}, {})

    qs = [f"select k, v from pts where k = {k}"
          for k in (5, 123, 39_999, 20_001, 777, 299_999)]
    js = cb.Session(cb.get_config().with_overrides(n_segments=4))
    load(js)
    ts = ct.Session(ct.Config(n_segments=4), device="cpu")
    carry_tables(js, ts)
    before = [_both(js, ts, q) for q in qs]
    _resize(js, ts, 8)
    static = ct.Session(ct.Config(n_segments=8), device="cpu")
    load(static)
    missed = 0
    for q, b in zip(qs, before):
        got = ts.sql(q)
        assert_same(got, b)
        assert_same(got, static.sql(q))
        missed += not np.asarray(js.sql(q).sel).any()
    assert missed > 0, "the reference's stale sidecar no longer misses"
