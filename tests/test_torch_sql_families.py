"""GROUPING SETS, DISTINCT aggregates and set operations through the port
against the JAX package, on the CPU at 1 and 8 segments.

Nothing of the planner is the port's own here: these families lower
through the copied host layers (the binder's per-set UNION ALL of
aggregations, its per-argument inner-distinct subplans zipped by 1:1
joins, the bag counters of INTERSECT / EXCEPT ALL) into the port's
Lowerer. The statements are the JAX package's own
(``tests/test_grouping_sets.py``, ``tests/test_dqa.py``,
``tests/test_setop_all.py``), NULL keys, DECIMAL sums and averages
included, plus a 3,000-row table of TPC-H lineitem's key shapes (two
dictionary flags, a supplier key) on which ROLLUP and CUBE take the
dense kernel and a statement with two DISTINCT aggregates joins their
results through the probe-join kernel. Both engines hold the same tables,
made from the same seeded numpy arrays; every result is held equal
(``torch_parity.assert_same``), and each statement's calls of the port's
kernel wrappers (their plain versions on the CPU) are held to the counts
below, so a plan that stops reaching a kernel fails here before the card
would show it.
"""

import numpy as np
import pytest

import cloudberry_tpu as cb
from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch.exec import cuda_kernels as CK
from torch_parity import assert_same, count_calls

SALES = """insert into sales values
    ('east','a',1,10.50),('east','b',2,20.25),('east','a',3,15.00),
    ('west','a',4,30.75),('west','b',5,40.00),('west','b',6,25.10),
    (null,'a',7,12.50),('west',null,8,null)"""
DQA = """insert into t values
    (1, 1, 10, 'x'), (1, 1, 20, 'x'), (1, 2, 10, 'y'), (1, null, 20, null),
    (2, 3, 30, 'z'), (2, 3, 30, 'z'), (2, null, null, null),
    (null, 4, 40, 'x'), (null, 4, null, 'w')"""
BAGS = {"tl": [(1, 1), (1, 1), (1, 2), (2, 5), (3, 7), (3, 7), (3, 7),
               (4, 0)],
        "tr": [(1, 1), (1, 2), (3, 7), (3, 7), (9, 9)]}

# statement -> (SQL, the port's kernel calls at 1 segment, at 8 segments),
# the calls as (dense_agg, probe_join, sorted_seg)
GROUPING = {
    "rollup": ("select region, product, sum(amount) as total, "
               "avg(amount) as av from sales group by rollup "
               "(region, product) order by region, product",
               (0, 0, 2), (0, 0, 32)),
    "cube": ("select region, product, count(*) as c from sales "
             "group by cube (region, product) order by region, product",
             (0, 0, 3), (0, 0, 48)),
    "grouping_sets": ("select region, product, sum(qty) as q from sales "
                      "group by grouping sets ((region), (product), ()) "
                      "order by region, product", (0, 0, 2), (0, 0, 32)),
    "grouping_sets_max": ("select region, product, max(amount) as m "
                          "from sales group by grouping sets ((region), "
                          "(product)) order by region, product",
                          (0, 0, 0), (0, 0, 0)),
    "li_rollup": ("select f, s, sum(q) as sq, sum(p) as sp, avg(p) as ap, "
                  "count(*) as c from li group by rollup (f, s) "
                  "order by f, s", (2, 0, 0), (32, 0, 0)),
    "li_cube": ("select f, s, count(*) as c from li group by cube (f, s) "
                "order by f, s", (3, 0, 0), (48, 0, 0)),
}
DISTINCT = {
    "two_distinct": ("select k, count(distinct a) as ca, "
                     "count(distinct b) as cb_ from t group by k "
                     "order by k", (0, 0, 4), (0, 0, 48)),
    "sum_avg_distinct": ("select k, sum(distinct a) as sd, "
                         "avg(distinct a) as ad from t group by k "
                         "order by k", (0, 0, 2), (0, 0, 24)),
    "random_mixed": ("select k, count(distinct a) as ca, count(distinct b) "
                     "as cb_, sum(a) as sa, count(*) as n, "
                     "sum(distinct b) as sdb from r group by k order by k",
                     (0, 0, 5), (0, 16, 40)),
    "li_two_distinct": ("select f, count(distinct sup) as cs, "
                        "count(distinct q) as cq from li group by f "
                        "order by f", (2, 1, 2), (24, 8, 24)),
    "li_high_card": ("select sup, count(distinct q) as cq from li "
                     "group by sup order by sup", (0, 0, 2), (0, 0, 16)),
}
SETOPS = {
    "intersect_all": ("select k, v from tl intersect all "
                      "select k, v from tr order by k, v",
                      (0, 0, 0), (0, 0, 0)),
    "except_all": ("select k, v from tl except all select k, v from tr "
                   "order by k, v", (0, 0, 0), (0, 0, 0)),
    "null_intersect_all": ("select k, v from nl intersect all "
                           "select k, v from nr order by k, v",
                           (0, 0, 0), (0, 0, 0)),
    "null_except_all": ("select k, v from nl except all "
                        "select k, v from nr order by k, v",
                        (0, 0, 0), (0, 0, 0)),
    "string_intersect_all": ("select k, name from sl intersect all "
                             "select k, name from sr order by k, name",
                             (0, 0, 0), (0, 0, 0)),
    "union_all": ("select k, v from tl union all select k, v from tr "
                  "order by k, v", (0, 0, 0), (0, 0, 0)),
    "union": ("select k, v from tl union select k, v from tr "
              "order by k, v", (0, 0, 1), (0, 0, 8)),
}


def _load(s) -> None:
    """The families' tables, the same in both engines: the JAX tests'
    literal rows, and two seeded 3,000-row tables."""
    s.sql("create table sales (region text, product text, qty bigint, "
          "amount decimal(12,2)) distributed by (qty)")
    s.sql(SALES)
    s.sql("create table t (k bigint, a bigint, b bigint, c text) "
          "distributed by (a)")
    s.sql(DQA)
    rng = np.random.default_rng(7)
    n = 3000
    k, a, b = (rng.integers(0, 40, n), rng.integers(0, 150, n),
               rng.integers(0, 500, n))
    a_null, b_null = rng.random(n) < 0.1, rng.random(n) < 0.1
    s.sql("create table r (k bigint, a bigint, b bigint) distributed by (k)")
    s.catalog.table("r").set_data({"k": k, "a": a, "b": b}, {},
                                  validity={"a": ~a_null, "b": ~b_null})
    rng = np.random.default_rng(3)
    s.sql("create table li (f text, s text, q bigint, p decimal(12,2), "
          "sup bigint) distributed by (sup)")
    s.sql("insert into li values " + ",".join(
        f"('{'ANR'[int(rng.integers(0, 3))]}', "
        f"'{'FO'[int(rng.integers(0, 2))]}', {int(rng.integers(1, 50))}, "
        f"{int(rng.integers(100, 10_000)) / 100:.2f}, "
        f"{int(rng.integers(0, 100))})" for _ in range(n)))
    for name, rows in BAGS.items():
        s.sql(f"create table {name} (k bigint, v bigint)")
        s.sql(f"insert into {name} values " +
              ", ".join(f"({x}, {y})" for x, y in rows))
    s.sql("create table nl (k bigint, v bigint)")
    s.sql("insert into nl values (1, null), (1, null), (1, 1)")
    s.sql("create table nr (k bigint, v bigint)")
    s.sql("insert into nr values (1, null), (2, null)")
    s.sql("create table sl (k bigint, name text)")
    s.sql("insert into sl values (1,'aa'),(1,'aa'),(2,'bb'),(3,'cc')")
    s.sql("create table sr (k bigint, name text)")
    s.sql("insert into sr values (1,'aa'),(3,'cc'),(3,'cc')")


@pytest.fixture(scope="module", params=[1, 8], ids=["seg1", "seg8"])
def engines(request):
    """(JAX session, port session) at 1 or 8 segments, both loaded."""
    nseg = request.param
    js = cb.Session(cb.config.Config(n_segments=nseg).with_overrides(
        **{"sched.generic_plans": False}))
    ts = TorchSession(TorchConfig(n_segments=nseg), device="cpu")
    for s in (js, ts):
        _load(s)
    return nseg, js, ts


def _held(engines, family, monkeypatch) -> None:
    """Each statement of ``family`` in both engines: equal results, and
    the port's kernel wrapper calls as the family's table says."""
    nseg, js, ts = engines
    for name, (sql, one, eight) in family.items():
        calls = count_calls(monkeypatch, CK, {k: k for k in CK.LAUNCHES})
        got = ts.sql(sql)
        monkeypatch.undo()
        try:
            assert_same(got, js.sql(sql), allow_empty=True)
        except AssertionError as e:
            raise AssertionError(f"{name} at {nseg} segments: {e}") from e
        assert int(np.asarray(got.sel).sum()) > 0, name
        assert tuple(calls[k] for k in ("dense_agg", "probe_join",
                                        "sorted_seg")) == \
            (one if nseg == 1 else eight), (name, dict(calls))


# one test per family, each at 1 and 8 segments (the ``engines`` fixture)
def test_grouping_sets_equal_jax(engines, monkeypatch):
    _held(engines, GROUPING, monkeypatch)


def test_distinct_aggregates_equal_jax(engines, monkeypatch):
    _held(engines, DISTINCT, monkeypatch)


def test_set_operations_equal_jax(engines, monkeypatch):
    _held(engines, SETOPS, monkeypatch)
