"""The port's join-index cache (exec/joinindex.py), on the CPU.

The cached index is the port's ``kernels.build_sort`` run once on the
table's device copy, and must equal the in-program sort (order, sorted
keys and packing ranges). Each key kind — duplicate keys, int64
wraparound of the packing arithmetic, float, bool, DATE and DECIMAL keys,
32- and 64-bit packs — gives the same result with the cache on and off
and in the JAX package. Through sessions: a repeat statement hits the
cache, a write invalidates it. Builds of at most 2048 rows keep the
probe-join kernel, so the tables here are larger. Results are held
exactly (``torch_parity.assert_same``).
"""

import numpy as np
import pytest
import torch

import cloudberry_tpu as cb
from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch.exec import executor as X
from cloudberry_tpu_torch.exec import joinindex as JI
from cloudberry_tpu_torch.exec import kernels as K
from cloudberry_tpu_torch.plan import nodes as N
from torch_parity import assert_same, carry_tables

N_DIM = 3000
Q = ("select grp, count(*) as n, sum(p) as sp from fact, dim "
     "where grp = d group by grp order by grp")


def _key_kinds():
    """(name, build key columns as (SQL type, values)) — 3000 build rows
    each, NOT NULL, so the build side is a bare scan the index takes."""
    rng = np.random.default_rng(3)
    n = N_DIM
    big = np.int64(1) << np.int64(62)
    yield "int64 with duplicates", [("bigint", rng.integers(0, 1000, n))]
    yield "int64 full range (wrapping spans)", [("bigint", np.concatenate([
        np.array([-(1 << 63), (1 << 63) - 1, 0, -1], dtype=np.int64),
        rng.integers(-big, big, n - 4)]))]
    yield "int32 and int64 pair", [
        ("integer", rng.integers(0, 300, n).astype(np.int32)),
        ("bigint", rng.integers(0, 50, n))]
    yield "float64 (signed zeros, infinities)", [("double", np.concatenate([
        np.array([0.0, -0.0, np.inf, -np.inf, 1e308, -1e-308]),
        rng.standard_normal(n - 6)]))]
    yield "bool and int32", [("boolean", rng.random(n) < 0.5),
                             ("integer", rng.integers(-500, 500, n)
                              .astype(np.int32))]
    yield "date and decimal", [
        ("date", rng.integers(8000, 9000, n).astype(np.int32)),
        ("decimal(12,2)", rng.integers(0, 5, n) * 100)]


KINDS = list(_key_kinds())
MATCHES = ("every probe key in the build", "half in the build",
           "no probe key in the build")


def _probe_keys(cols, match, rng, n):
    """Probe key columns of ``n`` rows: drawn from the build's rows, from
    fresh values, or half of each."""
    drawn = [c[rng.integers(0, len(c), n)] for c in cols]
    fresh = []
    for c in cols:
        if c.dtype == np.bool_:
            fresh.append(rng.random(n) < 0.5)
        elif c.dtype.kind == "f":
            fresh.append(rng.standard_normal(n) + 1e6)
        else:
            fresh.append((c.max() // 2 + 1 + rng.integers(0, 1000, n))
                         .astype(c.dtype))
    if match == MATCHES[0]:
        return drawn
    if match == MATCHES[2]:
        if cols[0].dtype == np.bool_:  # the pair's int half misses
            return [drawn[0], fresh[1] + np.int32(1000)]
        return fresh
    half = rng.random(n) < 0.5
    return [np.where(half, d, f) for d, f in zip(drawn, fresh)]


@pytest.fixture(scope="module")
def key_kind_sessions():
    """A JAX session holding dim_i (the build) and fact_i_j (the probe,
    6000 rows) for every key kind i and match kind j, and two port
    sessions over the same arrays: the join-index cache on and off."""
    js = cb.Session(cb.config.Config(n_segments=1).with_overrides(
        **{"sched.generic_plans": False}))
    rng = np.random.default_rng(11)
    for i, (_, cols) in enumerate(KINDS):
        keys = ", ".join(f"k{c} {t} not null" for c, (t, _) in
                         enumerate(cols))
        js.sql(f"create table dim_{i} ({keys}, p bigint not null)")
        data = {f"k{c}": v for c, (_, v) in enumerate(cols)}
        data["p"] = np.arange(N_DIM, dtype=np.int64) * 3
        js.catalog.table(f"dim_{i}").set_data(data)
        for j, match in enumerate(MATCHES):
            js.sql(f"create table fact_{i}_{j} ({keys}, v bigint not null)")
            probe = _probe_keys([v for _, v in cols], match, rng, 6000)
            data = {f"k{c}": v for c, v in enumerate(probe)}
            data["v"] = rng.integers(0, 100, 6000)
            js.catalog.table(f"fact_{i}_{j}").set_data(data)
    on = TorchSession(TorchConfig(), device="cpu")
    off = TorchSession(TorchConfig().with_overrides(
        **{"join_filter.index_cache": 0}), device="cpu")
    carry_tables(js, on)
    carry_tables(js, off)
    return js, on, off


@pytest.mark.parametrize("match", range(len(MATCHES)),
                         ids=lambda j: MATCHES[j])
@pytest.mark.parametrize("kind", range(len(KINDS)),
                         ids=lambda i: KINDS[i][0])
def test_key_kinds_match_cache_off_and_jax(kind, match, key_kind_sessions):
    """Each key kind through the cached index: duplicate keys (stable tie
    order), int64 wraparound of the packing spans, 32- and 64-bit packs,
    float, bool, DATE and DECIMAL keys; the result equals the in-program
    sort's (cache off) and the JAX package's exactly."""
    js, on, off = key_kind_sessions
    conds = " and ".join(f"f.k{c} = d.k{c}"
                         for c in range(len(KINDS[kind][1])))
    q = (f"select count(*) as n, sum(f.v) as sv, sum(d.p) as sp "
         f"from fact_{kind}_{match} f, dim_{kind} d where {conds}")
    specs = [j._jix for j in _joins(on, q)[1] if hasattr(j, "_jix")]
    assert len(specs) == 1  # the build is one of the two bare scans
    before = on.counters.snapshot()
    got = on.sql(q)
    after = on.counters.snapshot()
    assert sum(after.get(k, 0) - before.get(k, 0)
               for k in ("join_index_builds", "join_index_hits")) == 1
    assert_same(got, off.sql(q))
    assert_same(got, js.sql(q))


def _fill(s):
    s.sql("create table fact (k bigint, grp bigint, v bigint, f double)")
    s.sql("create table dim (d bigint, p bigint, fd double)")
    rows = ",".join(f"({i}, {(i * 7) % (N_DIM + 50)}, {i % 7}, {i % 13}.5)"
                    for i in range(6000))
    s.sql(f"insert into fact values {rows}")
    rows = ",".join(f"({i}, {i * 3}, {i % 13}.5)" for i in range(N_DIM))
    s.sql(f"insert into dim values {rows}")
    s.sql("create table fk (x double, w bigint)")
    s.sql("insert into fk values " +
          ",".join(f"({i}.5, {i})" for i in range(13)))


def _port(**ov):
    s = TorchSession(TorchConfig().with_overrides(**ov), device="cpu")
    _fill(s)
    return s


def _joins(s, sql):
    from cloudberry_tpu_torch.plan.binder import Binder
    from cloudberry_tpu_torch.plan.planner import _optimize
    from cloudberry_tpu_torch.sql.parser import parse_sql

    plan = _optimize(Binder(s.catalog).bind_query(parse_sql(sql)), s)
    return plan, [n for n in X.all_nodes(plan) if isinstance(n, N.PJoin)]


@pytest.fixture(scope="module")
def jax_session():
    js = cb.Session(cb.config.Config(n_segments=1).with_overrides(
        **{"sched.generic_plans": False}))
    _fill(js)
    return js


def test_cached_index_equals_in_program_sort():
    s = _port()
    plan, joins = _joins(s, Q)
    spec = joins[0]._jix
    assert spec.table == "dim" and spec.phys == ("d",)
    inputs = X.prepare_inputs(X.compile_plan(plan, s), s)
    jix = inputs[spec.key]
    dim = s.device_table("dim")
    n = int(dim["d"].shape[0])
    order, skeys, ranges = K.build_sort(
        [dim["d"]], torch.ones(n, dtype=torch.bool), spec.bits)
    assert torch.equal(jix["order"], order)
    assert torch.equal(jix["skeys"], skeys)
    assert int(jix["lo0"]) == int(ranges[0][0])
    assert int(jix["span0"]) == int(ranges[0][1])


def test_repeat_hits_and_results_match_cache_off(jax_session):
    on = _port()
    off = _port(**{"join_filter.index_cache": 0})
    assert not any(hasattr(j, "_jix") for j in _joins(off, Q)[1])
    a = on.sql(Q)
    assert on.counters.counter("join_index_builds") == 1
    b = on.sql(Q)
    assert on.counters.counter("join_index_hits") == 1
    assert on.counters.counter("join_index_builds") == 1
    want = jax_session.sql(Q)
    for got in (a, b, off.sql(Q)):
        assert_same(got, want)


def test_skips_the_build_sort(monkeypatch):
    s = _port()
    s.sql(Q)
    calls = {"n": 0}
    real = K.build_sort

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(K, "build_sort", counted)
    s.sql(Q)
    assert calls["n"] == 0


def test_write_invalidates(jax_session):
    s = _port()
    s.sql(Q)
    s.sql(f"insert into dim values ({N_DIM}, 9999, 0.5)")
    out = s.sql(Q)
    assert s.counters.counter("join_index_builds") == 2
    got = out.decoded_columns()
    i = got["grp"].tolist().index(N_DIM)
    assert got["sp"][i] == 9999 * got["n"][i]


@pytest.mark.parametrize("sql", [
    # many-to-many: the expansion join rides the index
    "select f1.grp, count(*) as n from fact f1, fact f2 "
    "where f1.grp = f2.grp group by f1.grp order by f1.grp",
    # float keys (a 64-bit pack: the probe-join kernel does not take it)
    "select fk.x, count(*) as n, sum(dim.p) as sp from dim, fk "
    "where dim.fd = fk.x group by fk.x order by fk.x",
], ids=["duplicate keys (expansion)", "float keys"])
def test_other_joins_match_cache_off_and_jax(sql, jax_session):
    on, off = _port(), _port(**{"join_filter.index_cache": 0})
    assert any(hasattr(j, "_jix") for j in _joins(on, sql)[1])
    got = on.sql(sql)
    assert on.counters.counter("join_index_builds") >= 1
    assert_same(got, off.sql(sql))
    assert_same(got, jax_session.sql(sql))


def test_null_masked_build_keys_keep_the_in_program_sort():
    """A nullable build key masks NULL rows out of the build at run time
    (build_key_valid), which a cached order cannot know: no index."""
    js = cb.Session(cb.config.Config(n_segments=1))
    js.sql("create table a (k bigint, v bigint)")
    js.sql("create table b (k bigint, w bigint)")
    js.sql("insert into a values " + ",".join(
        f"({i % 2500}, {i})" for i in range(5000)))
    js.sql("insert into b values " + ",".join(
        f"({'null' if i % 10 == 0 else i}, {i})" for i in range(3000)))
    ts = TorchSession(device="cpu")
    carry_tables(js, ts)
    q = ("select count(*) as n, sum(w) as sw from a, b where a.k = b.k")
    assert not any(hasattr(j, "_jix") for j in _joins(ts, q)[1])
    assert_same(ts.sql(q), js.sql(q))


def test_duplicate_build_key_error_through_cached_index(monkeypatch):
    """A unique-build join whose data holds a duplicate key (the planner's
    uniqueness inference pinned stale) raises the typed error when the
    duplicate check runs on the cached sorted keys."""
    s = _port()
    s.sql(Q)
    t = s.catalog.table("dim")
    data = {c: np.asarray(v).copy() for c, v in t.data.items()}
    data["d"][1] = data["d"][0]
    t.set_data(data, t.dicts)
    monkeypatch.setattr(type(t), "is_unique", lambda self, col: True)
    monkeypatch.setattr(type(t), "is_unique_cols", lambda self, cols: True)
    q = "select grp, p from fact, dim where grp = d order by grp, p limit 5"
    assert _joins(s, q)[1][0]._jix.table == "dim"
    with pytest.raises(X.DuplicateBuildKeyError):
        s.sql(q)
    assert s.counters.counter("join_index_builds") == 2
