"""Generic plans and the statement cache of the port (sched/paramplan.py,
``Session._stmt_cache``) against the JAX package, on the CPU.

TPC-H at SF 0.01, seed 7, generated by the JAX package's loader and carried
into the port's sessions (``torch_parity.carry_tables``). The JAX session
runs as its own tests run it: Pallas kernels on, in interpret mode, and
generic plans on (its default).

- ``normalize``, the plan signatures and the binding vectors of
  ``analyze`` equal the JAX package's on the 22 TPC-H texts, wherever both
  walkers model the plan;
- TPC-H q1, q3, q5, q6 and q14 and a perturbed-literal rebind of each are
  bit-identical between the port with generic plans on and the port with
  them off, and equal to the JAX package (int, DECIMAL, count, date and
  string columns exactly; float columns within the suite's stated
  tolerance, since the port's q1 ``avg_price`` already differs from the
  JAX package's by one ulp with generic plans off, the XLA quotient); a
  rebind builds no Executable (no ``compile_plan`` call), and an exact
  repeat is a statement-cache hit;
- the single-segment tests of the JAX package's ``test_paramplan.py`` in
  their port form (the port has no jit, so ``compile_plan`` calls are
  counted where the JAX tests count compiles);
- the device is part of a generic plan's match;
- a tiled statement is served twice from the statement cache, equal to the
  JAX package's tiled result.
"""

import threading

import numpy as np
import pytest

import cloudberry_tpu as cb
from cloudberry_tpu.plan.planner import plan_statement as j_plan_statement
from cloudberry_tpu.sched import paramplan as jpp
from cloudberry_tpu.sql.parser import parse_sql as j_parse_sql
from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch.exec import executor as X
from cloudberry_tpu_torch.plan.planner import plan_statement
from cloudberry_tpu_torch.sched import paramplan
from cloudberry_tpu_torch.sched import sharedcache
from cloudberry_tpu_torch.sql.parser import parse_sql
from tools.tpch_queries import QUERIES
from tools.tpchgen import load_tpch
from torch_parity import (budget_pair, carry_tables, count_calls,
                          same_tiled_report, assert_same)

# literal perturbations that keep each query valid — the REBIND path: the
# same skeleton, another parameter vector (JAX tests/test_generic_parity.py,
# plus q5's date and region)
PERTURB = {
    "q1": [("'1998-12-01'", "'1998-11-15'")],
    "q3": [("'1995-03-15'", "'1995-03-01'")],
    "q5": [("'1994-01-01'", "'1995-01-01'"), ("'ASIA'", "'EUROPE'")],
    "q6": [("24", "30")],
    "q14": [("'1995-09-01'", "'1995-06-01'")],
}
# generic plans are off by default in the port (config.SchedConfig); the
# JAX package has them on
ON = {"sched.generic_plans": True}
OFF = {"sched.generic_plans": False}


@pytest.fixture(scope="module")
def tpch_sessions():
    """(JAX session, port with generic plans on, port with them off)."""
    js = cb.Session(cb.get_config().with_overrides(
        n_segments=1, **{"exec.use_pallas": True}))
    load_tpch(js, sf=0.01, seed=7)
    on = TorchSession(TorchConfig().with_overrides(**ON), device="cpu")
    off = TorchSession(device="cpu")
    carry_tables(js, on)
    carry_tables(js, off)
    return js, on, off


def assert_bit_identical(got, want, what: str) -> None:
    """Same columns, dtypes, NULLs and selected rows; every value equal
    bit for bit, floats included."""
    assert [f.name for f in got.schema.fields] == \
        [f.name for f in want.schema.fields], what
    gsel, wsel = np.asarray(got.sel), np.asarray(want.sel)
    assert int(gsel.sum()) == int(wsel.sum()), what
    for f in want.schema.fields:
        g = np.asarray(got.columns[f.name])[gsel]
        w = np.asarray(want.columns[f.name])[wsel]
        assert g.dtype == w.dtype, (what, f.name, g.dtype, w.dtype)
        gv, wv = got.validity.get(f.name), want.validity.get(f.name)
        if gv is not None or wv is not None:
            gv = np.ones(len(g), bool) if gv is None \
                else np.asarray(gv, bool)[gsel]
            wv = np.ones(len(w), bool) if wv is None \
                else np.asarray(wv, bool)[wsel]
            np.testing.assert_array_equal(gv, wv, err_msg=what)
            g, w = g[wv], w[wv]
        if w.dtype.kind == "f":
            g, w = g.view(np.uint64), w.view(np.uint64)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}.{f.name}")
        gd, wd = got.dicts.get(f.name), want.dicts.get(f.name)
        if wd is not None:
            assert list(gd.values) == list(wd.values), (what, f.name)


# ------------------------------------------- skeletons and signatures


@pytest.mark.parametrize("qname", sorted(QUERIES, key=lambda q: int(q[1:])))
def test_signatures_and_bindings_match_jax(tpch_sessions, qname):
    js, on, _ = tpch_sessions
    sql = QUERIES[qname]
    assert paramplan.normalize(sql) == jpp.normalize(sql)
    jplan = j_plan_statement(j_parse_sql(sql), js, {}).plan
    tplan = plan_statement(parse_sql(sql), on, {}).plan
    try:
        jsig, jb, jkeyed, jslots = jpp.analyze(js, jplan)
    except jpp.UnsupportedPlan:
        jsig = None
    try:
        tsig, tb, tkeyed, tslots = paramplan.analyze(on, tplan)
    except paramplan.UnsupportedPlan:
        tsig = None
    assert (jsig is None) == (tsig is None), qname
    if jsig is None:
        return
    assert tsig == jsig, qname
    assert list(tb) == list(jb), qname
    for k in jb:
        assert tb[k].dtype == jb[k].dtype and tb[k] == jb[k], (qname, k)
    assert [(t.base.value, t.scale) for t in tslots] == \
        [(t.base.value, t.scale) for t in jslots]
    assert len(tkeyed) == len(jkeyed)


# --------------------------------- rebinds: bit-identical, no Executable


@pytest.mark.parametrize("qname", sorted(PERTURB, key=lambda q: int(q[1:])))
def test_rebinds_bit_identical_with_no_compile(tpch_sessions, qname,
                                               monkeypatch):
    js, on, off = tpch_sessions
    sql = QUERIES[qname]
    calls = count_calls(monkeypatch, X, {"compile_plan": "compile_plan"})
    first = on.sql(sql)
    assert_bit_identical(first, off.sql(sql), qname)
    assert_same(first, js.sql(sql))
    # an exact repeat: a statement-cache hit, no parse, plan or build
    c0, h0 = calls["compile_plan"], on.counters.counter("stmt_cache_hits")
    assert_bit_identical(on.sql(sql), first, f"{qname} repeat")
    assert calls["compile_plan"] == c0
    assert on.counters.counter("stmt_cache_hits") == h0 + 1
    for old, new in PERTURB[qname]:
        assert old in sql
        text = sql.replace(old, new)
        c0 = calls["compile_plan"]
        hits = on.counters.counter("generic_hits")
        builds = on.counters.counter("generic_builds")
        got = on.sql(text)
        assert calls["compile_plan"] == c0, f"{qname}: a rebind compiled"
        assert on.counters.counter("generic_hits") == hits + 1
        assert on.counters.counter("generic_builds") == builds
        what = f"{qname} {old}->{new}"
        assert_bit_identical(got, off.sql(text), what)
        assert_same(got, js.sql(text))


def test_string_literal_rebind_follows_the_reference(tpch_sessions):
    """A changed string literal compared with a dictionary column binds
    as its code: both engines rebind it (a generic hit), never a new
    variant."""
    js, on, _ = tpch_sessions
    sql = QUERIES["q5"].replace("'1994-01-01'", "'1993-01-01'")
    on.sql(sql)
    js.sql(sql)
    text = sql.replace("'ASIA'", "'AMERICA'")
    for s, counter in ((on, on.counters.counter),
                       (js, js.stmt_log.counter)):
        h, b = counter("generic_hits"), counter("generic_builds")
        s.sql(text)
        assert (counter("generic_hits"), counter("generic_builds")) == \
            (h + 1, b)


# --------------------- the JAX package's test_paramplan.py, port form


def _pts_session(rows=100_000, generic=True, config=None):
    cfg = (config or TorchConfig()).with_overrides(
        **{"sched.generic_plans": generic})
    s = TorchSession(cfg, device="cpu")
    s.sql("create table pts (k bigint, v bigint, w double) "
          "distributed by (k)")
    s.catalog.table("pts").set_data({
        "k": np.arange(rows, dtype=np.int64),
        "v": (np.arange(rows, dtype=np.int64) * 7) % 1000,
        "w": np.arange(rows, dtype=np.float64) * 0.5}, {})
    return s


def test_point_lookup_rebinds_without_building(monkeypatch):
    s = _pts_session()
    off = _pts_session(generic=False)
    q = "select k, v, w from pts where k = {}"
    s.sql(q.format(4242))  # builds the generic plan
    calls = count_calls(monkeypatch, X, {"compile_plan": "compile_plan"})
    for key in (7, 999, 31337, 77777):
        got = s.sql(q.format(key))
        assert_bit_identical(got, off.sql(q.format(key)), str(key))
        assert got.to_pandas().k.tolist() == [key]
    # off builds one Executable per text; the generic session none
    assert calls["compile_plan"] == 4
    assert [e["generic_hits"] for e in s.stmt_log.recent(4)] == [1] * 4


def test_decimal_and_date_literals_rebind(monkeypatch):
    rng = np.random.default_rng(5)
    m = 40_000
    data = {"qty": rng.integers(1, 5000, m).astype(np.int64),
            "price": rng.integers(100, 10000, m).astype(np.int64),
            "disc": rng.integers(0, 11, m).astype(np.int64),
            "sd": rng.integers(8000, 12000, m).astype(np.int32)}
    js = cb.Session(cb.get_config().with_overrides(n_segments=1))
    s = TorchSession(TorchConfig().with_overrides(**ON), device="cpu")
    off = TorchSession(TorchConfig().with_overrides(**OFF), device="cpu")
    for sess in (js, s, off):
        sess.sql("create table li (qty decimal(2), price decimal(2), "
                 "disc decimal(2), sd date)")
        sess.catalog.table("li").set_data(dict(data), {})
    q = ("select sum(price * disc) as rev, count(*) as n from li where "
         "sd >= date '{d}' and disc between 0.0{lo} and 0.0{hi} "
         "and qty < {q}.0")
    s.sql(q.format(d="1994-01-01", lo=5, hi=7, q=24))
    calls = count_calls(monkeypatch, X, {"compile_plan": "compile_plan"})
    for d, lo, hi, qty in (("1993-04-14", 3, 5, 20), ("1995-01-01", 1, 9, 48),
                           ("1990-02-02", 6, 8, 10)):
        text = q.format(d=d, lo=lo, hi=hi, q=qty)
        got = s.sql(text)
        assert_bit_identical(got, off.sql(text), text)
        assert_same(got, js.sql(text))
    assert calls["compile_plan"] == 3   # the off session's
    assert s.counters.counter("generic_hits") == 3


def test_nextval_stays_non_generic():
    s = TorchSession(TorchConfig().with_overrides(**ON), device="cpu")
    s.sql("create sequence sq")
    a = s.sql("select nextval('sq') as n").to_pandas().n[0]
    b = s.sql("select nextval('sq') as n").to_pandas().n[0]
    assert (a, b) == (1, 2)  # a cached/generic replay would repeat 1
    assert not s._generic_cache and not s._stmt_cache


def test_point_match_count_change_is_a_new_variant():
    s = _pts_session()
    t = s.catalog.table("pts")
    data = {c: np.concatenate([np.asarray(v), np.asarray(v[55:56])])
            for c, v in t.data.items()}
    t.set_data(data, {})
    q = "select k, v from pts where k = {}"
    assert s.sql(q.format(7)).num_rows() == 1
    assert s.sql(q.format(55)).num_rows() == 2  # its own variant
    assert s.sql(q.format(8)).num_rows() == 1
    (bucket,) = s._generic_cache.values()
    assert len(bucket) == 2


def _growth_sessions():
    """(JAX session, port session with generic plans on, statement
    template, expected count) over a skewed join whose first run
    overflows its pair buffer (JAX ``test_growth_retry_over_generic_plan_
    recovers``'s data)."""
    import pandas as pd

    rng = np.random.default_rng(13)
    n = 40_000
    pk = np.where(rng.random(n) < 0.3, 0,
                  rng.integers(1, 30_000, n)).astype(np.int64)
    bk = np.concatenate([np.zeros(12, dtype=np.int64),
                         np.arange(1, 2000, dtype=np.int64)])
    js = cb.Session(cb.get_config().with_overrides(n_segments=1))
    s = TorchSession(TorchConfig().with_overrides(**ON), device="cpu")
    for sess in (js, s):
        sess.sql("create table probe (k bigint, x bigint) "
                 "distributed by (k)")
        sess.sql("create table build (k bigint, y bigint) "
                 "distributed by (k)")
        sess.catalog.table("probe").set_data(
            {"k": pk, "x": np.ones(n, dtype=np.int64)}, {})
        sess.catalog.table("build").set_data(
            {"k": bk, "y": np.arange(len(bk), dtype=np.int64)}, {})
    q = ("select count(*) as n from probe, build "
         "where probe.k = build.k and probe.x < {}")
    want = pd.DataFrame({"k": pk}).merge(
        pd.DataFrame({"k": bk}), on="k").shape[0]
    return js, s, q, want


def test_growth_retry_over_generic_plan_recovers():
    """Expansion overflow on a generic-built (rewritten) plan: the retry
    drops the failed runner and its variant, grows and re-enters the
    cache; the kept Param values serve the rebuilt variant. An exact
    repeat is a cache hit that grows no more; a rebind with another
    literal starts again from the ungrown plan and grows again, as many
    times as the JAX package, whose cached pre-growth program overflows
    again."""
    js, s, q, want = _growth_sessions()
    for sess in (js, s):
        assert sess.sql(q.format(2)).to_pandas().n[0] == want
        assert sess.growth_events > 0
    assert s.growth_events == js.growth_events
    grown = s.growth_events
    assert s.sql(q.format(2)).to_pandas().n[0] == want  # cached, grown
    assert s.growth_events == grown
    for sess in (js, s):   # the same skeleton, another literal
        assert sess.sql(q.format(3)).to_pandas().n[0] == want
    assert s.growth_events == js.growth_events == 2 * grown


def test_no_cached_variant_outlives_its_signature_after_growth():
    """The growth loop grows a statement's plan in place, and an
    Executable walks its plan at every run. A variant built over that
    plan must not stay cached under its pre-growth signature: a later
    rebind with that signature would be admitted at its own estimate and
    run the grown pair buffers. After every statement, each cached
    variant's plan still has the signature it is matched by."""
    _js, s, q, want = _growth_sessions()

    def variants():
        return [gp for bucket in s._generic_cache.values()
                for gp in bucket]

    for lit in (2, 3, 2, 4):
        assert s.sql(q.format(lit)).to_pandas().n[0] == want
        assert variants()
        for gp in variants():
            assert paramplan.analyze(s, gp.plan)[0] == gp.sig, lit
    # one variant, the grown one: every ungrown build overflowed and went
    assert [len(b) for b in s._generic_cache.values()] == [1]
    assert s.counters.counter("generic_hits") == 2   # 3 and 4, grown
    assert s.counters.counter("stmt_cache_hits") == 1   # the second 2


def test_version_bump_invalidates_generic_and_cached():
    s = _pts_session(rows=40_000)
    q = "select sum(v) as sv from pts where k < {}"
    r1 = s.sql(q.format(1000)).to_pandas().sv[0]
    s.sql("insert into pts values (1000000, 123, 0.5)")
    r2 = s.sql(q.format(1000)).to_pandas().sv[0]
    assert r1 == r2 == int(((np.arange(1000) * 7) % 1000).sum())
    s.sql("insert into pts values (500, 500, 0.5)")  # inside the range
    assert s.sql(q.format(1000)).to_pandas().sv[0] == r1 + 500


def test_stmt_cache_keys_on_user_params():
    s = _pts_session(rows=1024)
    q = "select count(*) as n from pts"
    s.sql(q, tenant=1)
    s.sql(q, tenant=2)
    assert len([k for k in s._stmt_cache if k.startswith(q)]) == 2
    assert s._stmt_cache_key(q, {"a": 1}) != s._stmt_cache_key(q, {"a": 2})
    assert s._stmt_cache_key(q, {}) == q


def test_stmt_cache_config_epoch_invalidates():
    s = _pts_session(rows=1024)
    q = "select count(*) as n from pts"
    s.sql(q)
    assert s._cached_statement(q) is not None
    s.config = s.config.with_overrides(**{"obs.slow_ms": 1.0})
    assert s._cached_statement(q) is None  # stale under the new epoch


def _run_threads(threads) -> None:
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads)


def _column(batch, name) -> list:
    """A result column's selected values (no pandas in worker threads)."""
    return np.asarray(batch.columns[name])[np.asarray(batch.sel)].tolist()


def test_stmt_cache_lru_thread_stress():
    """Concurrent sql() across threads while the 64-entry LRU evicts."""
    s = _pts_session(rows=2048)
    errors = []

    def worker(wid):
        try:
            for i in range(40):
                key = (wid * 40 + i) % 90
                n = _column(s.sql("select count(*) as n from pts "
                                  f"where k >= {key}"), "n")
                assert n == [2048 - key], (key, n)
                hot = s.sql("select count(*) as n from pts")
                assert _column(hot, "n") == [2048]
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(6)]
    _run_threads(threads)
    assert not errors
    assert len(s._stmt_cache) <= s._STMT_CACHE_MAX


def test_generic_rebind_thread_stress(monkeypatch):
    s = _pts_session()
    s.sql("select k, v, w from pts where k = 1")  # build once
    calls = count_calls(monkeypatch, X, {"compile_plan": "compile_plan"})
    errors = []

    def worker(wid):
        try:
            for i in range(25):
                key = wid * 1000 + i
                got = s.sql(f"select k, v, w from pts where k = {key}")
                assert _column(got, "k") == [key]
                assert _column(got, "v") == [(key * 7) % 1000]
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(4)]
    _run_threads(threads)
    assert not errors
    assert calls["compile_plan"] == 0


# ------------------------------------------------- the device in the key


def test_the_device_is_part_of_the_generic_match(tmp_path, monkeypatch):
    """Two sessions over one store root share a cache scope. A plan built
    by one must not serve a session on another device: the match compares
    ``sharedcache.device_token`` (a CUDA statement could otherwise run a
    CPU-built Executable)."""
    cfg = TorchConfig().with_overrides(
        **{"storage.root": str(tmp_path), **ON})
    a = TorchSession(cfg, device="cpu")
    a.sql("create table t (k bigint, v bigint)")
    a.sql("insert into t values (1, 10), (2, 20), (3, 30)")
    b = TorchSession(cfg, device="cpu")
    assert a._cache_scope is b._cache_scope
    real = sharedcache.device_token
    monkeypatch.setattr(sharedcache, "device_token",
                        lambda s: "cuda:0" if s is b else real(s))
    q = "select sum(v) as s from t where k > {}"
    assert a.sql(q.format(1)).to_pandas().s[0] == 50
    builds = b.counters.counter("generic_builds")
    assert b.sql(q.format(2)).to_pandas().s[0] == 30
    assert b.counters.counter("generic_builds") == builds + 1
    (bucket,) = a._generic_cache.values()
    assert sorted(gp.device for gp in bucket) == ["cpu", "cuda:0"]
    # a's next rebind still matches its own plan
    hits = a.counters.counter("generic_hits")
    assert a.sql(q.format(0)).to_pandas().s[0] == 60
    assert a.counters.counter("generic_hits") == hits + 1


def test_store_sessions_share_one_scope_ram_sessions_their_own(tmp_path):
    """The JAX package's ``sched.shared_cache`` at its default, the port's
    one behaviour: sessions over one store root share its scope (and its
    generic plans), a session without a store keeps a private one."""
    cfg = TorchConfig().with_overrides(
        **{"storage.root": str(tmp_path), **ON})
    w = TorchSession(cfg, device="cpu")
    w.sql("create table t (k bigint, v bigint)")
    w.sql("insert into t values (1, 10), (2, 20)")
    # two backends opened on the written store (cold registers, as
    # JAX test_shared_cache.py's tenants) and one without a store
    a = TorchSession(cfg, device="cpu")
    b = TorchSession(cfg, device="cpu")
    c = TorchSession(TorchConfig().with_overrides(**ON), device="cpu")
    assert a._cache_scope is b._cache_scope is w._cache_scope
    assert a._cache_scope.kind == "store"
    assert c._cache_scope is not a._cache_scope
    assert c._cache_scope.kind == "session"
    q = "select sum(v) as s from t where k > {}"
    assert a.sql(q.format(0)).to_pandas().s[0] == 30
    hits = b.counters.counter("generic_hits")
    assert b.sql(q.format(1)).to_pandas().s[0] == 20
    assert b.counters.counter("generic_hits") == hits + 1


# ---------------------------------------- tiled runners from the cache


def test_tiled_statement_served_twice_from_the_cache(monkeypatch):
    js, ts = budget_pair(lambda s: load_tpch(s, sf=0.02, seed=7), 4 << 20)
    from cloudberry_tpu_torch.exec import tiled as TT

    calls = count_calls(monkeypatch, TT, {"plan_tiled": "plan_tiled"})
    want = js.sql(QUERIES["q1"])
    first = ts.sql(QUERIES["q1"])
    assert_same(first, want)
    same_tiled_report(ts, js)
    hits = ts.counters.counter("stmt_cache_hits")
    second = ts.sql(QUERIES["q1"])
    assert ts.counters.counter("stmt_cache_hits") == hits + 1
    assert calls["plan_tiled"] == 1   # the second run planned nothing
    assert_bit_identical(second, first, "tiled q1 from the cache")
    rep = same_tiled_report(ts, js)
    assert rep["n_tiles"] > 1
