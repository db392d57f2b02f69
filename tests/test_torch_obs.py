"""The observability plane of the port against the JAX package, on the
CPU: the metrics registry, the statement log (history, errors, activity),
the statements table, trace spans, EXPLAIN ANALYZE's pipeline counts, the
capacity histograms, live progress and the flight recorder.

These are the single-segment cases of the JAX package's
``tests/test_obs.py``, ``tests/test_activity.py`` and
``tests/test_capacity_forensics.py``. Where a case drives a session it runs
in both engines (``engine`` parameter) on the same seeded data and must
give the same outcome; the registry and statements-table cases hold the
port's copies to the reference's classes on the same inputs. Left for
later slices, with the modules they need: the distributed and motion
cases (skew events, motion annotations, the 8→7 degraded progress), the
generic-plan hit counts, the dispatcher's batched spans and flight
captures, the server's meta verbs and render stage, the flight replay
tool, the serve bench's columns, the recovery store's device-loss resume
and the lint passes.
"""

import json
import threading
import time

import numpy as np
import pytest

import cloudberry_tpu as cb
import cloudberry_tpu_torch as ct
from cloudberry_tpu.obs.metrics import MetricsRegistry as JRegistry
from cloudberry_tpu.obs.statements import StatementStats as JStats
from cloudberry_tpu.utils import faultinject as JFI
from cloudberry_tpu_torch.obs.metrics import MetricsRegistry as TRegistry
from cloudberry_tpu_torch.obs.statements import StatementStats as TStats
from cloudberry_tpu_torch.utils import faultinject as TFI
from torch_parity import budget_pair, carry_tables

ENGINES = ("jax", "port")
engines = pytest.mark.parametrize("engine", ENGINES)


def session(engine, **ov):
    if engine == "jax":
        return cb.Session(cb.config.Config(n_segments=1).with_overrides(
            **{"sched.generic_plans": False, **ov}))
    return ct.Session(ct.Config().with_overrides(**ov), device="cpu")


def faults(engine):
    return JFI if engine == "jax" else TFI


@pytest.fixture(autouse=True)
def _clean_faults():
    JFI.reset_fault()
    TFI.reset_fault()
    yield
    JFI.reset_fault()
    TFI.reset_fault()


# ------------------------------------------------------------- registry


def _fill(r):
    r.bump("a")
    r.bump("a", 4)
    r.bump("b", 2, tenant="gold")
    r.gauge("depth", 7)
    r.gauge_max("peak", 3)
    r.gauge_max("peak", 2)
    for v in (0.001, 0.002, 0.004, 0.1):
        r.observe("lat", v)


def test_registry_counters_gauges_hists():
    r, j = TRegistry(), JRegistry()
    _fill(r)
    _fill(j)
    assert r.counter("a") == 5 and r.counter("b") == 2
    snap = r.snapshot()
    assert snap == j.snapshot()
    assert snap["labeled_counters"] == {"b{tenant=gold}": 2}
    assert snap["gauges"] == {"depth": 7.0, "peak": 3.0}
    h = snap["histograms"]["lat"]
    assert h["count"] == 4 and h["sum"] == pytest.approx(0.107)
    assert h["p50"] >= 0.002 and h["p99"] >= 0.1
    text = r.exposition()
    assert text == j.exposition()
    assert 'cbtpu_b_by_tenant{tenant="gold"} 2' in text
    assert "cbtpu_lat_bucket" in text and "cbtpu_lat_count 4" in text


def test_registry_series_bound():
    r = TRegistry(max_series=4)
    for i in range(10):
        r.bump(f"c{i}")
    snap = r.snapshot()
    assert len(snap["counters"]) == 4
    assert snap["series_dropped"] == 6


def test_counter_view_is_registry_backed():
    s = ct.Session(device="cpu")
    log = s.stmt_log
    log.bump("xyz", 3)
    assert s.counters is log.counters      # one home for counters
    assert log.counters["xyz"] == 3
    assert log.counters.get("xyz") == 3
    assert log.counters.counter("xyz") == 3
    assert log.counter_snapshot()["xyz"] == 3
    assert s.counters.snapshot() == log.counter_snapshot()
    assert "xyz" in log.counters
    assert dict(log.counters.items())["xyz"] == 3


@engines
def test_metrics_hook_exception_safe(engine):
    s = session(engine)
    s.sql("create table hk (k bigint)")
    s.sql("insert into hk values (1), (2)")

    def bad_hook(m):
        raise RuntimeError("observer bug")

    got = []
    s.metrics_hooks.append(bad_hook)
    s.metrics_hooks.append(got.append)
    text = s.explain_analyze("select count(*) as n from hk")
    assert "rows=" in text
    assert len(got) == 1  # later hooks still fire
    assert got[0].rows_out == 1
    assert s.stmt_log.counter("metrics_hook_errors") == 1


@pytest.fixture(scope="module")
def d1():
    js = session("jax")
    js.sql("create table d1 (k bigint, v bigint) distributed by (k)")
    js.sql("insert into d1 values "
           + ",".join(f"({i},{i % 7})" for i in range(64)))
    ts = ct.Session(device="cpu")
    carry_tables(js, ts)
    return js, ts


def _node_rows(metrics):
    return [r for _, _, r in metrics.node_rows]


def test_pipeline_counts_match_legacy(d1):
    """Row counts from the pipeline path equal the legacy private
    lowerer's, and the JAX package's."""
    from cloudberry_tpu.exec import instrument as JI
    from cloudberry_tpu.plan.planner import plan_statement as jplan
    from cloudberry_tpu.sql.parser import parse_sql as jparse
    from cloudberry_tpu_torch.exec import instrument as TI
    from cloudberry_tpu_torch.plan.planner import plan_statement
    from cloudberry_tpu_torch.sql.parser import parse_sql

    js, s = d1
    q = "select v, count(*) as n from d1 where k < 32 group by v"
    p1 = plan_statement(parse_sql(q), s, {}).plan
    _, legacy = TI.run_instrumented(p1, s, q)
    p2 = plan_statement(parse_sql(q), s, {}).plan
    batch, pipe, _ann = TI.run_pipeline(p2, s, q)
    assert _node_rows(legacy) == _node_rows(pipe)
    assert all(r >= 0 for r in _node_rows(pipe))
    assert batch.num_rows() == pipe.rows_out == 7
    _, jpipe, _ = JI.run_pipeline(jplan(jparse(q), js, {}).plan, js, q)
    assert _node_rows(pipe) == _node_rows(jpipe)
    assert [t for t, _, _ in pipe.node_rows] == \
        [t for t, _, _ in jpipe.node_rows]
    # pipeline semantics: the run is a real statement — logged, counted
    recent = s.stmt_log.recent(5)
    assert recent[0]["sql"] == q and recent[0]["status"] == "ok"
    assert recent[0]["compiles"] == 0   # the CPU builds no kernel
    assert s.stmt_log.registry.hist("stage_seconds.launch")["count"] >= 1


def _load_big(s):
    s.sql("create table big (k bigint, v double)")
    n = 200_000
    s.catalog.table("big").set_data({
        "k": np.arange(n, dtype=np.int64) % 97,
        "v": np.arange(n, dtype=np.float64)}, {})


def test_tiled_histogram_progress_and_bytes(monkeypatch):
    """An over-budget statement: ``tile_seconds`` counts one sample per
    tile in both engines, the progress fraction climbs monotonically and
    ends at exactly 1.0, and the tiled working set lands on the capacity
    histogram."""
    from cloudberry_tpu.obs import progress as JP
    from cloudberry_tpu_torch.obs import progress as TP

    fracs = {"jax": [], "port": []}
    for key, mod in (("jax", JP), ("port", TP)):
        orig = mod.Progress.update

        def spy(self, *a, _orig=orig, _key=key, **k):
            _orig(self, *a, **k)
            fracs[_key].append(self.fraction)

        monkeypatch.setattr(mod.Progress, "update", spy)
    js, ts = budget_pair(_load_big, 1 << 20)
    q = "select k, sum(v) as sv from big group by k order by k"
    assert ts.sql(q).to_pandas().equals(js.sql(q).to_pandas())
    for s, key in ((js, "jax"), (ts, "port")):
        n = s.last_tiled_report["n_tiles"]
        assert n >= 4
        assert s.stmt_log.registry.hist("tile_seconds")["count"] == n
        f = fracs[key]
        assert len(f) == n and all(a <= b for a, b in zip(f, f[1:]))
        assert 0.9 < f[-1] < 1.0
        assert s.stmt_log.recent(1)[0]["progress"] == 1.0
        assert s.stmt_log.registry.hist("stmt_device_bytes")["count"] == 1
    assert fracs["port"] == fracs["jax"]


@engines
def test_progress_error_stays_below_one(engine):
    extra = {"health.retries": 0} if engine == "jax" else {}
    s = session(engine, **{"resource.query_mem_bytes": 1 << 20, **extra})
    n = 200_000
    s.sql("create table pe (k bigint, v bigint)")
    s.catalog.table("pe").set_data({
        "k": np.arange(n, dtype=np.int64) % 97,
        "v": np.arange(n, dtype=np.int64)}, {})
    faults(engine).inject_fault("tile_step", "error", start_hit=3)
    with pytest.raises(Exception, match="tile_step"):
        s.sql("select k, sum(v) as sv from pe group by k")
    entry = s.stmt_log.recent(1)[0]
    assert entry["status"] == "error"
    assert 0.0 < entry["progress"] < 1.0


# -------------------------------------------------- statements analog


@engines
def test_statement_stats_aggregates(engine):
    s = session(engine)
    s.sql("create table st (k bigint, v bigint) distributed by (k)")
    s.catalog.table("st").set_data({
        "k": np.arange(500, dtype=np.int64),
        "v": np.arange(500, dtype=np.int64) * 2}, {})
    for i in range(6):
        s.sql(f"select v from st where k = {i}")
    with pytest.raises(Exception):
        s.sql("select nope from st where k = 9")
    rows = s.stmt_log.statements.snapshot()
    row = next(r for r in rows if r["query"] ==
               "select v from st where k = ?n")
    assert row["calls"] == 6 and row["rows"] == 6 and row["errors"] == 0
    assert row["total_wall_s"] > 0 and row["p95_wall_s"] > 0
    bad = next(r for r in rows if "nope" in r["query"])
    assert bad["calls"] == 1 and bad["errors"] == 1


def test_statement_stats_bounded_lru():
    kept = {}
    for cls in (TStats, JStats):
        st = cls(max_rows=4)
        for i in range(10):
            st.observe({"sql": f"select {i} api_unique_{i}",
                        "wall_s": 0.001 * (i + 1), "status": "ok",
                        "rows": 1})
        assert len(st) == 4 and st.evicted == 6
        kept[cls] = [r["query"] for r in st.snapshot()]
    assert kept[TStats] == kept[JStats]
    assert kept[TStats][0] == "select ?n api_unique_9"


@engines
def test_counters_consistency_with_history(engine):
    s = session(engine)
    s.sql("create table cc (k bigint, v bigint) distributed by (k)")
    s.catalog.table("cc").set_data({
        "k": np.arange(100, dtype=np.int64),
        "v": np.arange(100, dtype=np.int64)}, {})
    for i in range(5):
        s.sql(f"select v from cc where k = {i}")
    s.sql("select count(*) as n from cc")
    recent = s.stmt_log.recent(100)
    assert sum(e.get("compiles", 0) for e in recent) \
        == s.stmt_log.counter("compiles")
    assert s.stmt_log.registry.hist("statement_seconds")["count"] \
        == len(recent) == 7
    assert s.stmt_log.counter("dispatches") == 6


# ------------------------------------------------------------- tracing


def _span_intervals_nest(events, eps=2.0):
    """Within each tid, spans must properly nest (contain or be
    disjoint) — the invariant Perfetto's track rendering assumes."""
    by_tid = {}
    for e in events:
        by_tid.setdefault(e["tid"], []).append(
            (e["ts"], e["ts"] + e["dur"]))
    for ivals in by_tid.values():
        ivals.sort(key=lambda p: (p[0], -p[1]))
        stack = []
        for lo, hi in ivals:
            while stack and lo >= stack[-1] - eps:
                stack.pop()
            if stack and hi > stack[-1] + eps:
                return False
            stack.append(hi)
    return True


@pytest.fixture(scope="module")
def tpch_pair():
    from tools.tpchgen import load_tpch

    js = session("jax")
    load_tpch(js, sf=0.01, seed=7)
    ts = ct.Session(device="cpu")
    carry_tables(js, ts)
    return {"jax": js, "port": ts}


@engines
def test_trace_q5_coverage_and_nesting(tpch_pair, engine):
    """A traced TPC-H Q5 exports Chrome-trace JSON whose root span covers
    >=95% of the externally measured wall, with child spans for every
    pipeline stage, all properly nested."""
    from cloudberry_tpu_torch import tpch
    from cloudberry_tpu_torch.obs.trace import chrome_trace

    s = tpch_pair[engine]
    t0 = time.perf_counter()
    s.sql(tpch.QUERIES["q5"])
    wall = time.perf_counter() - t0
    tr = s.stmt_log.traces(1)[0]
    assert tr["status"] == "ok"
    root = next(e for e in tr["events"] if e["name"] == "statement")
    assert root["dur"] / 1e6 >= 0.95 * wall, (root["dur"], wall)
    names = {e["name"] for e in tr["events"]}
    assert {"parse", "plan", "queue-wait", "launch"} <= names, names
    assert _span_intervals_nest(tr["events"]), tr["events"]
    doc = chrome_trace([tr])
    json.dumps(doc)
    assert all(e["ph"] == "X" for e in doc["traceEvents"])


@engines
def test_trace_ring_and_span_bounds(engine):
    s = session(engine, **{"obs.trace_ring": 3, "obs.max_spans": 16})
    s.sql("create table tb (k bigint)")
    for i in range(6):
        s.sql(f"insert into tb values ({i})")
    assert len(s.stmt_log.traces(100)) == 3
    for tr in s.stmt_log.traces(100):
        assert len(tr["events"]) <= 16


@engines
def test_trace_sampling_and_disable(engine):
    s = session(engine, **{"obs.trace_sample": 3})
    s.sql("create table ts1 (k bigint)")
    for i in range(8):
        s.sql(f"insert into ts1 values ({i})")
    assert len(s.stmt_log.traces(100)) == 3   # statements 1, 4 and 7 of 9

    off = session(engine, **{"obs.enabled": False})
    off.sql("create table ts2 (k bigint)")
    off.sql("insert into ts2 values (1)")
    assert off.sql("select count(*) as n from ts2").num_rows() == 1
    assert off.stmt_log.traces(100) == []
    assert len(off.stmt_log.statements) == 0


def test_device_annotation_is_a_profiler_range():
    """While a profiler records, a traced statement's launch runs inside
    a ``torch.profiler.record_function`` range named after the span;
    untraced, or with no profiler recording, there is no range."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from cloudberry_tpu_torch.obs import trace as OT

    assert isinstance(OT.device_annotation("launch"),
                      contextlib.nullcontext)   # untraced: nothing
    s = ct.Session(device="cpu")
    s.sql("create table pr (k bigint)")
    s.sql("insert into pr values (1)")
    q = "select count(*) as n from pr"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.sql(q)
    names = [e.name for e in prof.events()]
    assert names.count("cbtpu:launch") == 1, names
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        off = ct.Session(ct.Config().with_overrides(
            **{"obs.enabled": False}), device="cpu")
        off.sql("create table pr (k bigint)")
        off.sql("insert into pr values (1)")
        off.sql(q)
    assert "cbtpu:launch" not in [e.name for e in prof.events()]


# ------------------------------------------------ history and activity


@engines
def test_statement_log_records_history(engine):
    s = session(engine)
    s.sql("create table a (x bigint)")
    s.sql("insert into a values (1),(2)")
    assert s.sql("select * from a").num_rows() == 2
    rec = s.stmt_log.recent()
    assert [r["sql"] for r in rec[:3]] == [
        "select * from a", "insert into a values (1),(2)",
        "create table a (x bigint)"]
    assert rec[0]["status"] == "ok" and rec[0]["rows"] == 2
    assert rec[1]["status"].startswith("INSERT")
    assert all(r["wall_s"] >= 0 for r in rec)


@engines
def test_statement_log_records_errors(engine):
    s = session(engine)
    with pytest.raises(Exception):
        s.sql("select * from nope")
    rec = s.stmt_log.recent()
    assert rec[0]["status"] == "error" and "nope" in rec[0]["error"]


@engines
def test_activity_shows_running_statement(engine):
    s = session(engine)
    s.sql("create table b (x bigint)")
    s.catalog.table("b").set_data({"x": np.arange(64, dtype=np.int64)})
    faults(engine).inject_fault("dispatch_start", "sleep", sleep_s=1.0)
    seen = []

    def run():
        s.sql("select sum(x) from b")

    t = threading.Thread(target=run)
    t.start()
    deadline = time.time() + 10
    while time.time() < deadline:
        act = s.stmt_log.activity()
        if act:
            seen = act
            break
        time.sleep(0.02)
    t.join(10)
    assert not t.is_alive()
    assert seen and seen[0]["sql"] == "select sum(x) from b"
    assert seen[0]["state"] == "running" and seen[0]["elapsed_s"] >= 0
    assert s.stmt_log.activity() == []


def test_ring_buffer_bounded():
    from cloudberry_tpu_torch.exec.instrument import StatementLog

    log = StatementLog(capacity=8)
    for i in range(50):
        sid = log.begin(f"q{i}")
        log.finish(sid, "ok")
    rec = log.recent(100)
    assert len(rec) == 8 and rec[0]["sql"] == "q49"


# ------------------------------------------------- capacity accounting


@engines
def test_stmt_device_bytes_recorded_fresh(engine):
    s = session(engine)
    s.sql("create table cap_t (k bigint, v double)")
    s.catalog.table("cap_t").set_data({
        "k": np.arange(10_000, dtype=np.int64) % 64,
        "v": np.arange(10_000, dtype=np.float64)}, {})
    q = "select k, sum(v) as sv from cap_t group by k"
    s.sql(q)
    h = s.stmt_log.registry.hist("stmt_device_bytes")
    assert h is not None and h["count"] == 1
    gauges = s.stmt_log.registry.snapshot()["gauges"]
    assert gauges["stmt_device_bytes_peak"] == h["sum"] > 0
    assert s.stmt_log.registry.hist("stmt_live_bytes")["count"] == 1
    if engine == "port":
        from cloudberry_tpu_torch.exec.resource import estimate_plan_memory
        from cloudberry_tpu_torch.plan.planner import plan_statement
        from cloudberry_tpu_torch.sql.parser import parse_sql

        est = estimate_plan_memory(plan_statement(parse_sql(q), s,
                                                  {}).plan)
        assert h["sum"] == est.peak_bytes   # no motion at one segment


def test_memory_gauges_refresh(tmp_path):
    from cloudberry_tpu_torch import tpch
    from cloudberry_tpu_torch.obs.capacity import nbytes_of, refresh_gauges

    cfg = ct.Config().with_overrides(**{
        "storage.root": str(tmp_path), "bufferpool.admit_min_scans": 1})
    tpch.load_tables(ct.Session(cfg, device="cpu"), tpch.SCHEMAS,
                     tpch.DIST_KEYS, tpch.generate(0.01, 3),
                     ["nation", "region"])
    s = ct.Session(cfg, device="cpu")     # every table cold
    s.sql("select n_name from nation join region on n_regionkey = "
          "r_regionkey where r_name = 'ASIA'")
    vals = refresh_gauges(s)
    gauges = s.stmt_log.registry.snapshot()["gauges"]
    for k, v in vals.items():
        assert gauges[k] == float(v)
    assert vals["mem_trace_ring_entries"] >= 1
    assert vals["mem_statement_rows"] >= 1
    assert vals["mem_bufpool_bytes"] > 0
    assert vals["mem_store_scan_entries"] >= 0
    import torch

    assert nbytes_of({"a": [torch.zeros(4, dtype=torch.int64),
                            np.zeros(3, dtype=np.int32)]}) == 32 + 12


# ------------------------------------------------------ flight recorder


def _slow_session(engine, tmp_path):
    s = session(engine, **{"storage.root": str(tmp_path / engine),
                           "obs.slow_ms": 0.01})
    s.sql("create table ft (k bigint, v bigint) distributed by (k)")
    s.sql("insert into ft values " +
          ",".join(f"({i},{i * 3})" for i in range(500)))
    return s


def test_flight_bundle_contents_and_ring(tmp_path):
    q = "select k, sum(v) as sv from ft where k < 400 group by k order by k"
    bundles = {}
    for engine in ENGINES:
        s = _slow_session(engine, tmp_path)
        s.sql(q)
        assert s.stmt_log.counter("flight_captures") >= 1
        b = s.stmt_log.flights(1)[0]
        assert b["reason"] == "slow" and b["status"] == "ok"
        assert b["replayable"] is True
        for key in ("sql", "wall_s", "config_epoch", "n_segments",
                    "storage_root", "skeleton", "param_fingerprint",
                    "counters", "plan", "device_bytes", "rungs",
                    "cache_tier", "trace", "progress", "result"):
            assert key in b, f"bundle missing {key}"
        assert b["result"]["rows"] == 400
        json.dumps(b)
        for i in range(40):
            s.sql(f"select k from ft where k = {i}")
        assert len(s.stmt_log.flights(100)) <= s.config.obs.flight_ring
        bundles[engine] = b
    j, t = bundles["jax"], bundles["port"]
    # the same answer digest, skeleton, fingerprint and plan text
    assert t["result"] == j["result"]
    for key in ("skeleton", "param_fingerprint", "param_count", "plan",
                "n_segments", "rungs"):
        assert t[key] == j[key], key
    assert t["progress"]["fraction"] == 1.0


def test_flight_error_capture(tmp_path):
    for engine in ENGINES:
        s = _slow_session(engine, tmp_path)
        with pytest.raises(Exception):
            s.sql("select nope from ft")
        b = s.stmt_log.flights(1)[0]
        assert b["reason"] == "error" and b["status"] == "error"
        assert "error" in b and "result" not in b
        # error-storm protection: a second error inside the spacing
        # window is skipped and counted, never built
        n = s.stmt_log.counter("flight_captures")
        s.stmt_log._flight_last_error = time.monotonic()
        with pytest.raises(Exception):
            s.sql("select nope2 from ft")
        assert s.stmt_log.counter("flight_captures") == n
        assert s.stmt_log.counter("flight_capture_ratelimited") >= 1
        # lifecycle verdicts capture light bundles — no re-plan
        s.stmt_log._flight_last_error = 0.0
        s.config = s.config.with_overrides(statement_timeout_s=1e-9)
        with pytest.raises(Exception, match="timed out"):
            s.sql("select count(*) as c from ft")
        b = s.stmt_log.flights(1)[0]
        assert b["reason"] == "error" and "StatementTimeout" in b["error"]
        assert b.get("plan_skipped") and "plan" not in b


@engines
def test_obs_off_disables_the_plane(engine):
    s = session(engine, **{"obs.enabled": False, "obs.slow_ms": 0.01})
    s.sql("create table off_t (k bigint, v bigint)")
    s.catalog.table("off_t").set_data({
        "k": np.arange(5000, dtype=np.int64) % 16,
        "v": np.arange(5000, dtype=np.int64)}, {})
    s.sql("select k, sum(v) as sv from off_t group by k")
    reg = s.stmt_log.registry
    assert reg.hist("stmt_device_bytes") is None
    assert reg.hist("stage_seconds.launch") is None
    assert s.stmt_log.counter("flight_captures") == 0
    assert "progress" not in s.stmt_log.recent(1)[0]
