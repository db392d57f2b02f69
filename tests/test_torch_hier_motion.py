"""The port's two-level (hierarchical) motion and ring transport against
the JAX package and the flat run, on the CPU.

``CBTPU_FORCE_HOSTS`` splits the 8 segments into simulated hosts in both
engines (set through ``monkeypatch`` before a statement plans). The
distributor's host stamps (``hier_hosts``, ``host_bucket_cap``,
``host_combine``, ``combine_spec``) must equal the JAX package's motion
for motion, a one-host session's plans stay unstamped, and every result
equals the JAX package's and the flat run's exactly: the two-level
exchange delivers the flat exchange's buffers bit for bit, and the host
combine merges only integer sums, min and max. The host rung's overflow
and growth, the host-skew telemetry, the two-level staging bytes, the
tiled path, EXPLAIN ANALYZE and the degraded layout follow the JAX
package's too."""

import numpy as np
import pytest

import cloudberry_tpu as cb
from cloudberry_tpu.exec import executor as JX
from cloudberry_tpu.plan.planner import plan_statement as j_plan
from cloudberry_tpu.sql.parser import parse_sql as j_parse
from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch.exec import dist_executor as TDX
from cloudberry_tpu_torch.exec import executor as TX
from cloudberry_tpu_torch.parallel import transport as TT
from cloudberry_tpu_torch.plan.planner import plan_statement as t_plan
from cloudberry_tpu_torch.sql.parser import parse_sql as t_parse
from torch_parity import (assert_same, carry_tables, count_calls,
                          strip_timings)

NSEG = 8

QUERIES = [
    # redistribute join (both sides move) + two-stage agg + gathered sort
    "SELECT g, sum(v) AS sv, count(*) AS c FROM fact "
    "JOIN dim ON fact.grp = dim.d GROUP BY g ORDER BY g",
    # broadcast join (small build)
    "SELECT count(*) AS n FROM fact JOIN dim ON fact.grp = dim.d "
    "WHERE g < 3",
    # top-N pushdown through the gather motion
    "SELECT k, v FROM fact ORDER BY v DESC, k LIMIT 7",
    # two-stage agg on a non-distribution key: the host-combined merge
    "SELECT v % 13 AS b, sum(v) AS sv, count(*) AS c, min(k) AS mn, "
    "max(k) AS mx FROM fact GROUP BY b ORDER BY b",
]


@pytest.fixture()
def hosts4(monkeypatch):
    monkeypatch.setenv("CBTPU_FORCE_HOSTS", "4")
    return monkeypatch


def _load(s):
    rng = np.random.default_rng(11)
    s.sql("CREATE TABLE dim (d BIGINT, g BIGINT) DISTRIBUTED BY (d)")
    s.sql("CREATE TABLE fact (k BIGINT, grp BIGINT, v BIGINT) "
          "DISTRIBUTED BY (k)")
    s.catalog.table("dim").set_data(
        {"d": np.arange(100), "g": np.arange(100) % 6})
    s.catalog.table("fact").set_data(
        {"k": rng.integers(0, 4000, 20_000),
         "grp": rng.integers(0, 100, 20_000),
         "v": rng.integers(0, 1000, 20_000)})


def _pair(load=_load, nseg=NSEG, **over):
    """A JAX session (generic plans off) and a port session on the CPU
    over the same tables and dotted overrides."""
    js = cb.Session(cb.config.Config(n_segments=nseg).with_overrides(
        **{"sched.generic_plans": False, **over}))
    load(js)
    ts = TorchSession(TorchConfig(n_segments=nseg).with_overrides(**over),
                      device="cpu")
    carry_tables(js, ts)
    return js, ts


def _identical(got, want):
    """Exact equality of two results, floats by their bits."""
    assert_same(got, want, allow_empty=True)
    gsel, wsel = np.asarray(got.sel), np.asarray(want.sel)
    for f in want.schema.fields:
        g = np.asarray(got.columns[f.name])[gsel]
        w = np.asarray(want.columns[f.name])[wsel]
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                      err_msg=f.name)


def _stamps(plan, all_nodes):
    return [(m.kind, m.bucket_cap, m.out_capacity, m.host_bucket_cap,
             m.hier_hosts, m.host_combine, m.combine_spec)
            for m in all_nodes(plan) if type(m).__name__ == "PMotion"]


def _plans(js, ts, q):
    return (j_plan(j_parse(q), js, {}).plan,
            t_plan(t_parse(q), ts, {}).plan)


def _spy_transports(monkeypatch):
    """Record every transport each engine builds: {engine: [tx, ...]}."""
    import cloudberry_tpu.parallel.transport as JT

    made = {"jax": [], "port": []}
    for key, mod in (("jax", JT), ("port", TT)):
        def make(*a, _real=mod.make_transport, _key=key, **kw):
            tx = _real(*a, **kw)
            made[_key].append(tx)
            return tx
        monkeypatch.setattr(mod, "make_transport", make)
    return made


# ------------------------------------------------ plans and statements


@pytest.mark.parametrize("hier", ["on", "off"])
def test_queries_equal_jax_and_flat(hosts4, hier):
    """At a forced 4-host split every query's motions carry the JAX
    package's stamps (the verify gate on), and every result equals the
    JAX package's and the port's flat run exactly. With the two-level
    transport on, the port's transport makes as many permutations as the
    JAX package's."""
    made = _spy_transports(hosts4)
    js, ts = _pair(**{"interconnect.hierarchical": hier,
                      "debug.verify_plans": True})
    hosts4.delenv("CBTPU_FORCE_HOSTS")
    flat = TorchSession(ts.config, device="cpu")
    carry_tables(js, flat)
    flat_res = [flat.sql(q) for q in QUERIES]
    hosts4.setenv("CBTPU_FORCE_HOSTS", "4")
    n_stamped = 0
    for q, want_flat in zip(QUERIES, flat_res):
        jp, tp = _plans(js, ts, q)
        assert _stamps(tp, TX.all_nodes) == _stamps(jp, JX.all_nodes), q
        n_stamped += sum(s[4] == 4 for s in _stamps(tp, TX.all_nodes))
        del made["jax"][:], made["port"][:]
        got = ts.sql(q)
        _identical(got, js.sql(q))
        _identical(got, want_flat)
        hier_tx = [t for t in made["port"] if t.name == "hier"]
        assert len(hier_tx) == (1 if hier == "on" else 0)
        if hier_tx:
            jl = [t.launches for t in made["jax"] if t.name == "hier"]
            assert [hier_tx[0].launches] == jl, q
    assert (n_stamped > 0) == (hier == "on")


def test_tpch_q3_stamps_and_result(hosts4):
    """TPC-H Q3 at SF 0.05 under the default "auto" gate, its joins forced
    onto redistributes (broadcast threshold 0): the stamps of every
    motion equal the JAX package's, the blocks that clear the 64 KiB
    floor are stamped, and the result equals the JAX package's and the
    flat run."""
    from cloudberry_tpu_torch import tpch
    from tools.tpchgen import load_tpch

    js, ts = _pair(lambda s: load_tpch(s, sf=0.05, seed=7),
                   **{"planner.broadcast_threshold": 0})
    q = tpch.QUERIES["q3"]
    jp, tp = _plans(js, ts, q)
    got = _stamps(tp, TX.all_nodes)
    assert got == _stamps(jp, JX.all_nodes)
    assert any(s[4] == 4 for s in got)
    got = ts.sql(q)
    _identical(got, js.sql(q))
    hosts4.delenv("CBTPU_FORCE_HOSTS")
    flat = TorchSession(ts.config, device="cpu")
    carry_tables(js, flat)
    _identical(got, flat.sql(q))


def test_one_host_plans_unstamped(monkeypatch):
    """Without a forced split the one card is one host: the gate never
    fires even with hierarchical "on" (the JAX package's plans agree),
    and at one segment a forced split stamps nothing either."""
    monkeypatch.delenv("CBTPU_FORCE_HOSTS", raising=False)
    js, ts = _pair(**{"interconnect.hierarchical": "on"})
    for q in QUERIES:
        jp, tp = _plans(js, ts, q)
        got = _stamps(tp, TX.all_nodes)
        assert got == _stamps(jp, JX.all_nodes)
        assert all(s[3] == s[4] == 0 and not s[5] for s in got)
    monkeypatch.setenv("CBTPU_FORCE_HOSTS", "4")
    one = TorchSession(TorchConfig(n_segments=1).with_overrides(
        **{"interconnect.hierarchical": "on"}), device="cpu")
    carry_tables(js, one)
    plan = t_plan(t_parse(QUERIES[3]), one, {}).plan
    assert all(s[3] == 0 and not s[5]
               for s in _stamps(plan, TX.all_nodes))


def test_ring_session_equals_jax(monkeypatch):
    """interconnect.backend="ring" runs in the port, equal to the JAX
    ring session, whole-block and chunked (ring_chunks 4), and to the
    one-card exchange; the ring never selects the two-level transport."""
    monkeypatch.setenv("CBTPU_FORCE_HOSTS", "4")
    made = _spy_transports(monkeypatch)
    over = {"interconnect.backend": "ring",
            "planner.broadcast_threshold": 0}
    js, ts = _pair(**over)
    others = [TorchSession(ts.config.with_overrides(**o), device="cpu")
              for o in ({"interconnect.ring_chunks": 4},
                        {"interconnect.backend": "xla",
                         "interconnect.hierarchical": "off"})]
    for o in others:
        carry_tables(js, o)
    for q in (QUERIES[0], QUERIES[3]):
        got = ts.sql(q)
        _identical(got, js.sql(q))
        for o in others:
            _identical(o.sql(q), got)
    rings = [t for t in made["port"] if t.name == "ring"]
    assert sorted({t.chunks for t in rings}) == [1, 4]
    assert not [t for t in made["port"] if t.name == "hier"]


def test_stmt_cache_keyed_by_host_layout(monkeypatch):
    """A statement planned flat is never served under a forced split,
    nor the reverse: the cached entry carries the host layout."""
    monkeypatch.delenv("CBTPU_FORCE_HOSTS", raising=False)
    js, ts = _pair(**{"interconnect.hierarchical": "on"})
    q = QUERIES[3]
    flat = ts.sql(q)
    plans = []
    real = TDX.execute_distributed

    def spy(plan, session, fn=None):
        plans.append(_stamps(plan, TX.all_nodes))
        return real(plan, session, fn)
    monkeypatch.setattr(TDX, "execute_distributed", spy)
    hits = ts.counters.counter("stmt_cache_hits")
    monkeypatch.setenv("CBTPU_FORCE_HOSTS", "4")
    _identical(ts.sql(q), flat)
    monkeypatch.delenv("CBTPU_FORCE_HOSTS")
    _identical(ts.sql(q), flat)
    monkeypatch.setenv("CBTPU_FORCE_HOSTS", "4")
    _identical(ts.sql(q), flat)
    assert ts.counters.counter("stmt_cache_hits") == hits
    # a repeat under the entry's own layout is a hit: no new plan
    _identical(ts.sql(q), flat)
    assert ts.counters.counter("stmt_cache_hits") == hits + 1
    assert [any(s[4] == 4 for s in p) for p in plans] == \
        [True, False, True, True]


# ------------------------------------------------------ rungs and skew


def _grown_pair(monkeypatch, engine_mods):
    """Sessions whose plain (uncombined) two-level motions are stamped at
    an 8-row host block — a certain host-rung overflow."""
    for mod in engine_mods:
        real = mod.Distributor._stamp_hier

        def low(self, m, child, keys, _real=real):
            _real(self, m, child, keys)
            if m.host_bucket_cap > 0:
                m.host_bucket_cap = 8
        monkeypatch.setattr(mod.Distributor, "_stamp_hier", low)


def test_host_rung_overflow_promotes_and_retries(hosts4):
    """An undersized host rung is a detected overflow naming the node:
    the statement loop grows as many times as the JAX package's, each
    growth promotes the host rung to the same rung over the same observed
    host demand, and the retried result equals the JAX package's and the
    flat run."""
    import re

    import cloudberry_tpu.exec.executor as JXM
    import cloudberry_tpu.plan.distribute as JD
    import cloudberry_tpu_torch.exec.executor as TXM
    import cloudberry_tpu_torch.plan.distribute as TD

    q = QUERIES[0]
    over = {"interconnect.hierarchical": "on",
            "planner.broadcast_threshold": 0}
    _grown_pair(hosts4, (JD, TD))
    js, ts = _pair(**over)
    grown = {}
    for key, mod, all_nodes in (("jax", JXM, JX.all_nodes),
                                ("port", TXM, TX.all_nodes)):
        def spy(plan, message, *a, _real=mod.grow_expansion, _key=key,
                _all=all_nodes, **kw):
            ok = _real(plan, message, *a, **kw)
            grown.setdefault(_key, []).append((
                ok, re.sub(r"\(node \d+\)", "(node N)", message),
                [(m.bucket_cap, m.host_bucket_cap,
                  getattr(m, "_observed_host_bucket", 0))
                 for m in _all(plan) if type(m).__name__ == "PMotion"
                 and m.host_bucket_cap > 0]))
            return ok
        hosts4.setattr(mod, "grow_expansion", spy)
    got = ts.sql(q)
    _identical(got, js.sql(q))
    assert grown["port"] == grown["jax"]
    assert "host bucket overflow" in grown["port"][0][1]
    assert all(ok for ok, _, _ in grown["port"])
    hosts4.delenv("CBTPU_FORCE_HOSTS")
    flat = TorchSession(ts.config, device="cpu")
    carry_tables(js, flat)
    _identical(got, flat.sql(q))


def test_host_rung_overflow_names_the_node(hosts4):
    """Through the gang's own entry points: the check text names the
    motion, the observed host demand pins on it, and one growth makes the
    re-run equal the flat run."""
    js, ts = _pair(**{"interconnect.hierarchical": "on",
                      "planner.broadcast_threshold": 0})
    q = QUERIES[0]
    plan = t_plan(t_parse(q), ts, {}).plan
    plain = [m for m in TX.all_nodes(plan) if type(m).__name__ == "PMotion"
             and m.host_bucket_cap > 0 and not m.host_combine]
    m = max(plain, key=lambda n: n.bucket_cap)
    m.host_bucket_cap = 8
    with pytest.raises(TX.ExecError) as ei:
        TDX.execute_distributed(plan, ts)
    msg = str(ei.value)
    assert "host bucket overflow" in msg and f"(node {id(m)})" in msg
    assert m._observed_host_bucket > 8
    assert TX.grow_expansion(plan, msg)
    assert m.host_bucket_cap >= m._observed_host_bucket
    got = TDX.execute_distributed(plan, ts)
    hosts4.delenv("CBTPU_FORCE_HOSTS")
    flat = TorchSession(ts.config, device="cpu")
    carry_tables(js, flat)
    _identical(got, flat.sql(q))


def test_segment_rung_promotion_lifts_host_rung():
    """Promoting bucket_cap on a two-level motion keeps host_bucket_cap >=
    bucket_cap and folds in the host demand already observed, as the JAX
    package's grow_expansion does."""
    out = []
    for pkg in ("cloudberry_tpu", "cloudberry_tpu_torch"):
        import importlib

        ex = importlib.import_module(f"{pkg}.plan.expr")
        PN = importlib.import_module(f"{pkg}.plan.nodes")
        X = importlib.import_module(f"{pkg}.exec.executor")
        INT64 = importlib.import_module(f"{pkg}.types").INT64
        m = PN.PMotion(PN.PScan("t", {"k": "k"}, 64), "redistribute",
                       hash_keys=[ex.ColumnRef("k", INT64)])
        m.bucket_cap, m.out_capacity = 64, 64 * NSEG
        m.host_bucket_cap, m.hier_hosts = 256, 4
        m._observed_bucket, m._observed_host_bucket = 5000, 9000
        assert X.grow_expansion(m, f"redistribute overflow (node {id(m)})")
        m2 = PN.PMotion(PN.PScan("t", {"k": "k"}, 64), "redistribute",
                        hash_keys=[ex.ColumnRef("k", INT64)])
        m2.bucket_cap, m2.host_bucket_cap, m2.hier_hosts = 64, 128, 2
        m2._observed_host_bucket = 300
        assert X.grow_expansion(m2, f"host bucket overflow (node {id(m2)})")
        assert not X.grow_expansion(m2, "host bucket overflow (node 1)")
        out.append((m.bucket_cap, m.out_capacity, m.host_bucket_cap,
                    m2.bucket_cap, m2.host_bucket_cap))
    assert out[0] == out[1]
    assert out[1][0] == 8192 and out[1][2] >= max(8192, 9000)


def test_host_skew_telemetry(hosts4):
    """A host-skewed shuffle (every row to one destination host) records
    the same per-host rows, skew ratio and host_skew_events as the JAX
    package, beside the per-segment ones."""
    def load(s):
        s.sql("CREATE TABLE dim (d BIGINT, g BIGINT) DISTRIBUTED BY (d)")
        s.sql("CREATE TABLE fact (k BIGINT, grp BIGINT) "
              "DISTRIBUTED BY (k)")
        s.catalog.table("dim").set_data(
            {"d": np.arange(100), "g": np.arange(100) % 6})
        s.catalog.table("fact").set_data(
            {"k": np.arange(4000), "grp": np.full(4000, 7)})

    js, ts = _pair(load, **{"interconnect.hierarchical": "on",
                            "planner.broadcast_threshold": 0})
    q = "SELECT count(*) AS n FROM fact JOIN dim ON fact.grp = dim.d"
    seen = {}
    for name, mod in (("jax", __import__(
            "cloudberry_tpu.exec.dist_executor", fromlist=["x"])),
            ("port", TDX)):
        real = mod.record_motion_stats

        def spy(plan, stats, session=None, _real=real, _name=name,
                _all=(JX.all_nodes if name == "jax" else TX.all_nodes)):
            _real(plan, stats, session=session)
            seen[_name] = sorted(
                (tuple(m._host_rows), m._host_skew_ratio)
                for m in _all(plan) if type(m).__name__ == "PMotion"
                and getattr(m, "_host_skew_ratio", None) is not None)
        hosts4.setattr(mod, "record_motion_stats", spy)
    assert_same(ts.sql(q), js.sql(q))
    assert seen["port"] == seen["jax"] and seen["port"]
    got = ts.counters.counter("host_skew_events")
    assert got == js.stmt_log.counter("host_skew_events") > 0
    reg = ts.stmt_log.registry
    for h in ("motion_host_skew_ratio", "motion_host_rows_max"):
        assert reg.hist(h) and reg.hist(h) == \
            js.stmt_log.registry.hist(h), h


# --------------------------------------------------------- other paths


def test_staging_bytes_equal_jax(hosts4):
    """two_level_staging_bytes and the plan's wire bytes equal the JAX
    package's on a stamped plan; clearing the stamps drops the staging."""
    from cloudberry_tpu.obs import capacity as JC
    from cloudberry_tpu_torch.obs import capacity as TC

    js, ts = _pair(**{"interconnect.hierarchical": "on",
                      "planner.broadcast_threshold": 0})
    jp, tp = _plans(js, ts, QUERIES[0])
    jm = [m for m in JX.all_nodes(jp) if type(m).__name__ == "PMotion"]
    tm = [m for m in TX.all_nodes(tp) if type(m).__name__ == "PMotion"]
    got = [TC.two_level_staging_bytes(m) for m in tm]
    assert got == [JC.two_level_staging_bytes(m) for m in jm]
    assert sum(b > 0 for b in got) >= 2
    wire = TC.plan_device_bytes(tp)["wire_bytes"]
    assert wire == JC.plan_device_bytes(jp)["wire_bytes"]
    for m in tm:
        m.host_bucket_cap = m.hier_hosts = 0
    assert TC.plan_device_bytes(tp)["wire_bytes"] < wire


def test_tiled_dist_under_forced_hosts(hosts4):
    """An admission-rejected statement on a forced 4-host session tiles
    over the gang through the two-level transport (host-combined merge
    included) and equals the JAX package's unbudgeted flat run."""
    made = _spy_transports(hosts4)

    def load(s):
        rng = np.random.default_rng(5)
        n = 60_000
        s.sql("CREATE TABLE dim (d BIGINT, g BIGINT) DISTRIBUTED BY (g)")
        s.sql("CREATE TABLE fact (k BIGINT, d BIGINT, v BIGINT) "
              "DISTRIBUTED BY (k)")
        s.catalog.table("dim").set_data(
            {"d": np.arange(500), "g": np.arange(500) % 9})
        s.catalog.table("fact").set_data(
            {"k": np.arange(n) % 997, "d": rng.integers(0, 500, n),
             "v": rng.integers(0, 100, n)})

    q = ("SELECT g, sum(v) AS sv, count(*) AS c FROM fact "
         "JOIN dim ON fact.d = dim.d GROUP BY g ORDER BY g")
    hosts4.delenv("CBTPU_FORCE_HOSTS")
    js, ts = _pair(load, **{"planner.broadcast_threshold": 0,
                            "interconnect.hierarchical": "on",
                            "resource.query_mem_bytes": 1 << 20})
    want = js.sql(q)
    hosts4.setenv("CBTPU_FORCE_HOSTS", "4")
    del made["port"][:]
    got = ts.sql(q)
    rep = ts.last_tiled_report
    assert rep["tiled"] and rep["distributed"] and rep["n_tiles"] > 1
    hier = [t for t in made["port"] if t.name == "hier"]
    assert hier and sum(t.launches for t in hier) > 0
    _identical(got, want)


def test_explain_analyze_two_level(hosts4):
    """EXPLAIN ANALYZE of a two-level session: the instrumented gang runs
    the two-level transport too, and the annotated text equals the JAX
    package's, timings stripped."""
    made = _spy_transports(hosts4)
    js, ts = _pair(**{"interconnect.hierarchical": "on"})
    q = QUERIES[3]
    want = js.explain_analyze(q)
    del made["port"][:]
    got = ts.explain_analyze(q)
    assert strip_timings(got) == strip_timings(want)
    assert [t.name for t in made["port"]] == ["hier"]
    assert made["port"][0].launches > 0


def test_degraded_layout_stays_flat(hosts4):
    """8 -> 7 segments under CBTPU_FORCE_HOSTS=4: the forced count does
    not divide 7, so the session runs flat (no raise), unstamped, and
    equal to the JAX package's degraded run."""
    js, ts = _pair(**{"interconnect.hierarchical": "on"})
    ids = [0, 1, 2, 4, 5, 6, 7]
    assert ts.degrade_mesh(7, live_ids=ids)
    assert js.degrade_mesh(7, live_ids=ids)
    assert TT.hier_topology(ts.config, 7, ids, 8) is None
    for q in (QUERIES[0], QUERIES[3]):
        plan = t_plan(t_parse(q), ts, {}).plan
        assert all(s[3] == 0 for s in _stamps(plan, TX.all_nodes))
        _identical(ts.sql(q), js.sql(q))


_DIGEST = {"planner.broadcast_threshold": 0,
           "planner.runtime_filter_threshold": 0,
           "join_filter.bloom_bits": 4096}


@pytest.mark.parametrize("mode", ["exact", "digest"])
def test_runtime_filters_two_level(hosts4, mode):
    """The exact filter's gathered keys ride the tree gather and the
    digest folds per host before the inter-host ring: the same probe rows
    pass as in the JAX package's two-level run and the result equals
    the flat run."""
    def load(s):
        s.sql("create table fact (k bigint, grp bigint, v bigint) "
              "distributed by (k)")
        s.sql("create table dim (d bigint, p bigint) distributed by (d)")
        s.catalog.table("fact").set_data(
            {"k": np.arange(3000), "grp": np.arange(3000) % 3000,
             "v": np.arange(3000) % 7})
        s.catalog.table("dim").set_data(
            {"d": np.arange(300), "p": np.arange(300) * 2})

    over = dict(_DIGEST if mode == "digest"
                else {"planner.broadcast_threshold": 0})
    over["interconnect.hierarchical"] = "on"
    made = _spy_transports(hosts4)
    js, ts = _pair(load, **over)
    q = ("select grp, count(*) as n from fact, dim where grp = d "
         "group by grp order by grp")
    text = ts.explain(q)
    assert ("RuntimeFilter digest(" in text) == (mode == "digest")
    got = ts.sql(q)
    _identical(got, js.sql(q))
    for c in ("jf_rows_in", "jf_rows_out"):
        assert ts.counters.counter(c) == js.stmt_log.counter(c), c
    jl = [t.launches for t in made["jax"] if t.name == "hier"]
    assert [t.launches for t in made["port"] if t.name == "hier"] == jl
    hosts4.delenv("CBTPU_FORCE_HOSTS")
    flat = TorchSession(ts.config, device="cpu")
    carry_tables(js, flat)
    _identical(got, flat.sql(q))
