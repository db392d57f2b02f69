"""Window functions through the port against the JAX package, on the CPU.

Unit parity: the window helpers of ``cloudberry_tpu_torch/exec/executor.py``
against the reference's (``cloudberry_tpu/exec/executor.py``) on the same
numpy-seeded inputs, and the port's doubling scan against
``jax.lax.associative_scan`` with the reference's combine.

SQL parity: every window shape of ``tests/test_window_longtail.py`` (lead/
lag, ntile, first/last_value, ROWS frames, RANGE offsets with months and
float or decimal keys, the random frame oracles) plus the frame kinds and
function families it leaves out, through ``cb.Session`` and the port's
``Session(device="cpu")`` over the same tables carried with
``catalog/carry.py``. Results are held equal by ``torch_parity.assert_same``
(ints, DECIMALs, dates and strings exactly, floats within its stated
tolerance). Partitions are ordered by a key unique within them wherever a
function reads positions, so the answer is fixed by SQL, not by tie order.
"""

import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloudberry_tpu as cb
from cloudberry_tpu.exec import executor as JX
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch.exec import executor as TX
from torch_parity import assert_same, carry_tables

W = "from w order by g, o"
RW = "from rw order by g, k, v"


def _tables(s) -> None:
    """The long-tail suite's tables, plus dates before 1970 for negative
    day numbers and string ORDER BY keys."""
    s.sql("create table w (g text, o int, v int, s text) distributed by (o)")
    s.sql("insert into w values ('a', 1, 10, 'x'), ('a', 2, null, 'y'), "
          "('a', 3, 30, null), ('b', 1, 100, 'p'), ('b', 2, 200, 'q'), "
          "('c', 1, null, 'z')")
    s.sql("create table rw (g text, k int, v int) distributed by (v)")
    s.sql("insert into rw values ('a', 1, 1), ('a', 2, 2), ('a', 2, 3), "
          "('a', 5, 4), ('b', 10, 5), ('b', 11, 6), ('c', 3, 9), "
          "('c', null, 7), ('c', null, 8)")
    s.sql("create table rf (k double, v int) distributed by (v)")
    s.sql("insert into rf values (0.5, 1), (1.0, 2), (1.4, 3), (3.0, 4)")
    s.sql("create table rd (k decimal(8,2), v int) distributed by (v)")
    s.sql("insert into rd values (1.00, 1), (1.25, 2), (1.50, 3), "
          "(3.00, 4)")
    s.sql("create table rdt (dt date, v int) distributed by (v)")
    s.sql("insert into rdt values (date '2024-01-01', 1), "
          "(date '2024-01-03', 2), (date '2024-01-04', 3), "
          "(date '2024-02-01', 4)")
    s.sql("create table rmy (dt date, v int) distributed by (v)")
    s.sql("insert into rmy values (date '2000-02-29', 1), "
          "(date '2000-03-31', 2), (date '2001-02-28', 4), "
          "(date '2001-03-01', 8), (date '2002-02-28', 16), "
          "(date '1968-02-29', 32), (date '1968-03-31', 64), "
          "(date '1969-12-31', 128), (date '1970-01-31', 256)")
    rng = np.random.default_rng(31)
    base = datetime.date(1999, 6, 15)
    rows = [(int(rng.integers(0, 3)),
             base + datetime.timedelta(days=int(rng.integers(0, 900))),
             int(rng.integers(1, 40))) for _ in range(300)]
    s.sql("create table rmo (g bigint, dt date, v int) distributed by (g)")
    s.sql("insert into rmo values " + ", ".join(
        f"({g}, date '{d}', {v})" for g, d, v in rows))
    for name, seed, key in (("rr", 23, "k"), ("r", 21, "o")):
        rng = np.random.default_rng(seed)
        n = 2000
        keys = rng.integers(0, 300, n) if key == "k" else np.arange(n)
        s.sql(f"create table {name} (g bigint, {key} bigint, v bigint, "
              f"f double) distributed by (v)")
        s.catalog.table(name).set_data(
            {"g": rng.integers(0, 7, n).astype(np.int64),
             key: keys.astype(np.int64),
             "v": rng.integers(-50, 50, n).astype(np.int64),
             "f": rng.normal(0, 1e3, n)})


@pytest.fixture(scope="module")
def sessions():
    js = cb.Session(cb.get_config().with_overrides(
        **{"sched.generic_plans": False}))
    _tables(js)
    ts = TorchSession(device="cpu")
    carry_tables(js, ts)
    return js, ts


def _over(func, spec, frm=W):
    return f"select {func} over ({spec}) as x {frm}"


P = "partition by g order by o"
PK = "partition by g order by k"

SQL = {
    # lead / lag (test_window_longtail.py:52-124)
    "lead": _over("lead(o)", P),
    "lag": _over("lag(o)", P),
    "lead_offset": _over("lead(o, 2)", P),
    "lead_offset_default": _over("lead(o, 2, -1)", P),
    "lag_default": _over("lag(o, 1, 0)", P),
    "lag_nullable": _over("lag(v)", P),
    "lag_nullable_default": _over("lag(v, 1, -5)", P),
    "lead_strings": _over("lead(s)", P),
    "lag_zero_offset": _over("lag(o, 0)", P),
    "lead_string_default": _over("lead(s, 1, 'none')", P),
    "lag_string_default": _over("lag(s, 2, '<pad>')", P),
    "lead_null_default": _over("lead(o, 1, null)", P),
    # ntile (:136-147)
    "ntile": _over("ntile(4)", "order by g, o"),
    "ntile_more_buckets": _over("ntile(10)", P),
    # first_value / last_value (:159-195)
    "first_value": _over("first_value(o)", P),
    "first_value_nullable": _over("first_value(v)", P),
    "last_value_default_frame": _over("last_value(o)", P),
    "last_value_no_order": "select g, o, last_value(o) over "
                           "(partition by g) as x " + W,
    "last_value_nullable": _over("last_value(v)", P),
    "first_value_strings": _over("first_value(s)", P),
    # windows over aggregates, mixed calls (:198-224)
    "over_aggregate": "select g, sum(o) as t, sum(sum(o)) over () as grand, "
                      "rank() over (order by sum(o) desc) as rk "
                      "from w group by g order by g",
    "rank_over_sum": "select rank() over (order by sum(o)) as rk from w",
    "mixed": "select g, o, lead(o) over (partition by g order by o) as nxt, "
             "sum(o) over (partition by g order by o) as run, "
             "ntile(2) over (partition by g order by o) as nt " + W,
    # explicit ROWS / RANGE frames (:230-292)
    "rows_sum": _over("sum(o)", P + " rows between 1 preceding and "
                      "current row"),
    "rows_avg": _over("avg(o)", P + " rows between 1 preceding and "
                      "1 following"),
    "rows_max": _over("max(o)", P + " rows between 1 preceding and "
                      "current row"),
    "rows_min": _over("min(o)", P + " rows between current row and "
                      "1 following"),
    "rows_max_nullable": _over("max(v)", P + " rows between 1 preceding "
                               "and 1 following"),
    "rows_empty_sum": _over("sum(o)", P + " rows between 2 preceding and "
                            "1 preceding"),
    "rows_empty_count": _over("count(o)", P + " rows between 2 preceding "
                              "and 1 preceding"),
    "rows_last_value_whole": _over("last_value(o)", P + " rows between "
                                   "unbounded preceding and unbounded "
                                   "following"),
    "rows_first_value_following": _over("first_value(o)", P + " rows "
                                        "between 1 following and "
                                        "2 following"),
    "range_whole_max": _over("max(o)", P + " range between unbounded "
                             "preceding and unbounded following"),
    "range_default_spelling": _over("sum(o)", P + " range between "
                                    "unbounded preceding and current row"),
    # RANGE offsets (:354-483)
    "range_offset_sum": _over("sum(v)", PK + " range between 1 preceding "
                              "and 1 following", RW),
    "range_offset_desc": _over("sum(v)", PK + " desc range between "
                               "1 preceding and current row", RW),
    "range_offset_empty_sum": _over("sum(v)", PK + " range between "
                                    "3 preceding and 2 preceding", RW),
    "range_offset_empty_count": _over("count(v)", PK + " range between "
                                      "3 preceding and 2 preceding", RW),
    "range_offset_max": _over("max(v)", PK + " range between 1 preceding "
                              "and 1 following", RW),
    "range_offset_min": _over("min(v)", PK + " range between 1 preceding "
                              "and current row", RW),
    "range_offset_first_value": _over("first_value(v)", PK + " range "
                                      "between 1 following and "
                                      "2 following", RW),
    "range_offset_last_value": _over("last_value(v)", PK + " range between "
                                     "current row and unbounded following",
                                     RW),
    "range_offset_float_key": _over("sum(v)", "order by k range between "
                                    "0.5 preceding and 0.5 following",
                                    "from rf order by k"),
    "range_offset_decimal_key": _over("sum(v)", "order by k range between "
                                      "0.25 preceding and 0.25 following",
                                      "from rd order by k"),
    "range_offset_decimal_inexact": _over("count(v)", "order by k range "
                                          "between 0.07 preceding and "
                                          "0.07 following",
                                          "from rd order by k"),
    "range_positional_multi_key": _over("sum(v)", "order by g, k range "
                                        "between current row and "
                                        "unbounded following", RW),
    "range_positional_peers": _over("sum(v)", "order by g range between "
                                    "current row and current row", RW),
    "range_offset_mixed_unbounded": _over("sum(v)", PK + " range between "
                                          "unbounded preceding and "
                                          "1 preceding", RW),
    "range_interval_day": _over("sum(v)", "order by dt range between "
                                "interval '2' day preceding and current "
                                "row", "from rdt order by dt"),
    "range_interval_month": _over("sum(v)", "order by dt range between "
                                  "interval '1' month preceding and "
                                  "current row", "from rmy order by dt"),
    "range_interval_year": _over("sum(v)", "order by dt range between "
                                 "interval '1' year preceding and "
                                 "current row", "from rmy order by dt"),
    "range_interval_month_desc": _over("sum(v)", "order by dt desc range "
                                       "between interval '1' month "
                                       "preceding and current row",
                                       "from rmy order by dt"),
    "range_month_random": "select g, dt, sum(v) over (partition by g "
                          "order by dt range between interval '2' month "
                          "preceding and current row) as s from rmo",
    # the random frame oracles (:523-593)
    "range_frame_random": "select g, k, sum(v) over (partition by g order "
                          "by k range between 5 preceding and 3 following) "
                          "as ms, count(v) over (partition by g order by k "
                          "range between 5 preceding and 3 following) as "
                          "mc from rr order by g, k, v",
    "rows_frame_random": "select g, o, sum(v) over (partition by g order "
                         "by o rows between 3 preceding and current row) "
                         "as ms, min(v) over (partition by g order by o "
                         "rows between 3 preceding and current row) as mn, "
                         "max(v) over (partition by g order by o rows "
                         "between 2 preceding and 1 following) as mx "
                         "from r order by g, o",
    # shapes the long-tail suite leaves out: dense_rank and rank, running
    # and whole-partition extremes (strings by collation rank, NULLs),
    # float sums and averages over ROWS and RANGE frames, a RANGE offset
    # extreme over a date key, and inputs with no row or one row selected
    "ranks": "select g, o, rank() over (order by g) as r, "
             "dense_rank() over (order by g) as dr, "
             "row_number() over (order by s desc, o) as rn " + W,
    "running_extremes": "select g, o, min(v) over (" + P + ") as mn, "
                        "max(s) over (" + P + ") as mxs, "
                        "min(s) over (order by o, g) as mns " + W,
    "whole_partition_extremes": "select g, o, min(v) over (partition by g) "
                                "as mn, max(s) over (partition by g) as mx, "
                                "count(*) over (partition by g) as c " + W,
    "float_rows_sum": "select g, o, sum(f) over (partition by g order by o "
                      "rows between 5 preceding and 2 following) as fs, "
                      "avg(f) over (partition by g order by o) as fa "
                      "from r order by g, o",
    "float_range_extremes": "select g, k, max(f) over (partition by g "
                            "order by k range between 2 preceding and "
                            "current row) as fm, sum(f) over (partition by "
                            "g order by k range between 4 preceding and "
                            "4 following) as fs from rr order by g, k, v",
    "range_month_extreme": "select dt, min(v) over (order by dt range "
                           "between interval '1' month preceding and "
                           "interval '1' month following) as x, "
                           "ntile(3) over (order by dt) as nt "
                           "from rmo order by dt, g, v",
    "all_filtered": "select o, row_number() over (order by o) as rn, "
                    "sum(v) over (" + P + " rows between 1 preceding and "
                    "current row) as s, max(v) over (" + P + ") as m "
                    "from w where o > 99 order by o",
    "one_row": "select o, lead(o, 1, -1) over (" + P + ") as ld, "
               "max(v) over (" + P + " rows between 1 preceding and "
               "1 following) as m, avg(v) over (partition by g) as a, "
               "min(o) over (" + P + ") as r from w where g = 'c'",
}


@pytest.mark.parametrize("name", list(SQL))
def test_window_sql_matches_jax(sessions, name):
    js, ts = sessions
    want = js.sql(SQL[name])
    got = ts.sql(SQL[name])
    assert_same(got, want, allow_empty=(name == "all_filtered"))


@pytest.mark.parametrize("name", ["rows_frame_random", "range_month_random",
                                  "running_extremes", "mixed",
                                  "lag_nullable_default", "all_filtered"])
def test_window_lowering_never_reads_the_device(sessions, name,
                                                 monkeypatch):
    """Lowerer.window leaves row counts (selected rows, segments, runs) on
    the device: while it runs, no tensor is read on the host (no .item(),
    no nonzero, no bool()/int() of a tensor, no copy to the host)."""
    _, ts = sessions
    active = [False]
    real_window = TX.Lowerer.window

    def guarded(self, node):
        active[0] = True
        try:
            return real_window(self, node)
        finally:
            active[0] = False

    def forbid(cls, attr):
        real = getattr(cls, attr)

        def f(*a, **kw):
            assert not active[0], f"window lowering called {attr}"
            return real(*a, **kw)
        monkeypatch.setattr(cls, attr, f)

    for attr in ("item", "tolist", "cpu", "numpy", "nonzero", "__bool__",
                 "__int__", "__index__", "__float__"):
        forbid(torch.Tensor, attr)
    forbid(torch, "nonzero")
    monkeypatch.setattr(TX.Lowerer, "window", guarded)
    ts.sql(SQL[name])


ERRORS = [
    "select lead(s, 1, 42) over (order by o) from w",
    "select lead(o, o) over (order by o) from w",
    "select ntile(0) over (order by o) from w",
    "select sum(o) over (order by o rows between 1 following and "
    "1 preceding) from w",
    "select sum(o) over (order by g, o range between 1 preceding and "
    "current row) from w",
    "select sum(o) over (order by g range between 1 preceding and "
    "current row) from w",
    "select sum(v) over (order by v range between interval '1' month "
    "preceding and current row) from rmy",
]


@pytest.mark.parametrize("sql", ERRORS, ids=range(len(ERRORS)))
def test_window_bind_errors_match_jax(sessions, sql):
    js, ts = sessions
    with pytest.raises(Exception) as jerr:
        js.sql(sql)
    with pytest.raises(Exception) as terr:
        ts.sql(sql)
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert str(terr.value) == str(jerr.value)


# ------------------------------------------------------------ unit parity


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _partitioned(rng, n, n_parts, lo=0, hi=50):
    """Values sorted within random partitions, per-row partition bounds."""
    part = np.sort(rng.integers(0, n_parts, n))
    vals = np.concatenate([np.sort(rng.integers(lo, hi, (part == p).sum()))
                           for p in range(n_parts)])
    starts = np.searchsorted(part, part, side="left")
    ends = np.searchsorted(part, part, side="right") - 1
    return vals.astype(np.int64), starts, ends


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("n", [1, 7, 300])
def test_vsearch_matches_jax(lower, n):
    rng = np.random.default_rng(n)
    s, lo, hi = _partitioned(rng, n, 4)
    target = s + rng.integers(-6, 6, n)
    # some empty bounds (lo > hi) as the NULL-key span can give
    hi = np.where(rng.random(n) < 0.1, lo - 1, hi)
    want = JX._vsearch(jnp.asarray(s), jnp.asarray(target), jnp.asarray(lo),
                       jnp.asarray(hi), n, lower)
    got = TX._vsearch(_t(s), _t(target), _t(lo), _t(hi), n, lower)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _lanes(rng, n, strings):
    """(valid, rank, code) lanes: NULL runs, ties, and for strings a
    collation rank that is a permutation of the code order."""
    va = rng.random(n) < 0.7
    va[n // 3: n // 3 + 5] = False       # an all-NULL stretch
    cs = rng.integers(-5, 6, n).astype(np.int64)
    ks = rng.permutation(11)[cs + 5].astype(np.int32) if strings else cs
    return va, ks, cs


@pytest.mark.parametrize("strings", [False, True], ids=["ints", "strings"])
@pytest.mark.parametrize("mx", [False, True], ids=["min", "max"])
def test_rmq_extreme_matches_jax(mx, strings):
    n = 257
    rng = np.random.default_rng(7 + mx + 2 * strings)
    va, ks, cs = _lanes(rng, n, strings)
    lo = rng.integers(-3, n, n)
    hi = lo + rng.integers(-2, 40, n)    # empty frames where hi < lo
    hi = np.minimum(hi, n + 2)
    want = JX._rmq_extreme(jnp.asarray(ks), jnp.asarray(cs), jnp.asarray(va),
                           jnp.asarray(lo), jnp.asarray(hi), n, mx)
    got = TX._rmq_extreme(_t(ks), _t(cs), _t(va), _t(lo), _t(hi), n, mx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mx", [False, True], ids=["min", "max"])
def test_rank_better_matches_jax(mx):
    rng = np.random.default_rng(3)
    n = 500
    lanes = [rng.random(n) < 0.5, rng.integers(0, 4, n), rng.integers(0, 4, n),
             rng.random(n) < 0.5, rng.integers(0, 4, n), rng.integers(0, 4, n)]
    want = JX._rank_better(mx, *[jnp.asarray(x) for x in lanes])
    got = TX._rank_better(mx, *[_t(x) for x in lanes])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_months", [-25, -13, -1, 0, 1, 2, 12, 14])
def test_shift_months_days_matches_jax(n_months):
    rng = np.random.default_rng(abs(n_months) + 5)
    days = np.concatenate([rng.integers(-40_000, 40_000, 500),
                           # month ends, leap days, before and after 1970
                           [-672, -641, -1, 0, 30, 59, 11_016, 11_047,
                            -25_508, 10_956]]).astype(np.int32)
    want = JX._shift_months_days(jnp.asarray(days), n_months)
    got = TX._shift_months_days(_t(days), n_months)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_days_from_civil_matches_jax():
    rng = np.random.default_rng(9)
    y = rng.integers(1800, 2200, 400)
    m = rng.integers(1, 13, 400)
    d = rng.integers(1, 29, 400)
    want = JX._days_from_civil(jnp.asarray(y), jnp.asarray(m),
                               jnp.asarray(d))
    got = TX._days_from_civil(_t(y), _t(m), _t(d))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("strings", [False, True], ids=["ints", "strings"])
@pytest.mark.parametrize("mx", [False, True], ids=["min", "max"])
@pytest.mark.parametrize("n", [1, 2, 5, 64, 1000])
def test_doubling_scan_matches_associative_scan(n, mx, strings):
    """The running extreme's segmented scan: the port's Hillis–Steele
    doubling scan against jax.lax.associative_scan with the reference's
    combine (executor.py window(), the running min/max branch)."""
    rng = np.random.default_rng(n + 10 * mx)
    flag = rng.random(n) < 0.1
    flag[0] = True
    va, ks, cs = _lanes(rng, n, strings)

    def comb(a, b):
        f1, w1, r1, c1 = a
        f2, w2, r2, c2 = b
        take2 = f2 | JX._rank_better(mx, w1, r1, c1, w2, r2, c2)
        return (f1 | f2, jnp.where(take2, w2, w1),
                jnp.where(take2, r2, r1), jnp.where(take2, c2, c1))

    want = jax.lax.associative_scan(
        comb, tuple(jnp.asarray(x) for x in (flag, va, ks, cs)))
    got = TX._doubling_scan(TX._segmented_extreme(mx),
                            tuple(_t(x) for x in (flag, va, ks, cs)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("p", [0.0, 0.05, 1.0])
def test_compacted_starts_match_argsort(p):
    rng = np.random.default_rng(int(p * 100))
    flag = rng.random(300) < p
    want = jnp.argsort(~jnp.asarray(flag), stable=True)
    got = TX._compacted_starts(_t(flag))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_floor_log2_is_exact():
    w = np.unique(np.concatenate([
        [1, 2, 3], [(1 << b) + d for b in range(2, 40) for d in (-1, 0, 1)],
        np.random.default_rng(1).integers(1, 1 << 31, 200)])).astype(np.int64)
    want = np.asarray(31 - jax.lax.clz(jnp.asarray(w.clip(max=(1 << 31) - 1),
                                                   dtype=jnp.int32)))
    got = TX._floor_log2(_t(w)).numpy()
    np.testing.assert_array_equal(got[w < (1 << 31)], want[w < (1 << 31)])
    np.testing.assert_array_equal(got, np.floor(np.log2(w)).astype(np.int64))
