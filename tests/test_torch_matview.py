"""Materialized views through the port against the JAX package, on the
CPU: CREATE / REFRESH / DROP MATERIALIZED VIEW, the AQUMV rewrite and
incremental maintenance after INSERT, UPDATE and DELETE — the cases of
``tests/test_matview.py``, each run in both engines (``torch_parity.twin``)
with every result held equal: integers, DECIMAL (int64 cents) and counts
exactly, floats to rtol 1e-9, status texts and errors exactly."""

import numpy as np
import pytest

from torch_parity import twin

MV = ("create incremental materialized view mv_sales as "
      "select region, sum(amt) as s_amt, count(*) as cnt, "
      "min(qty) as mn_q, max(qty) as mx_q from sales group by region")
MV_DELTA = ("create incremental materialized view mv_delta as "
            "select region, sum(amt) as s_amt, sum(qty) as s_q, "
            "count(*) as cnt from sales group by region")
ORACLE = ("select region, sum(amt) as s_amt, sum(qty) as s_q, "
          "count(*) as cnt from sales group by region order by region")


def sales(e):
    """The reference test's fixture: 300 seeded rows of ``sales``."""
    s = e.session()
    s.sql("create table sales (region text not null, day bigint not null, "
          "amt decimal(12,2) not null, qty bigint not null)")
    rng = np.random.default_rng(3)
    rows = [f"('r{int(rng.integers(0, 4))}', {int(rng.integers(0, 30))}, "
            f"{int(rng.integers(1, 500))}.25, {int(rng.integers(1, 9))})"
            for _ in range(300)]
    s.sql("insert into sales values " + ", ".join(rows))
    return s


def aqumv(e, s, q):
    """Whether the rewrite fires for ``q`` (kept)."""
    return e.keep("AQUMV" in s.explain(q))


def without_aqumv(s, q):
    cfg = s.config
    s.config = cfg.with_overrides(**{"planner.enable_aqumv": False})
    try:
        return s.sql(q + " limit 999")   # another text: no cached runner
    finally:
        s.config = cfg


def spy_refresh(e, monkeypatch):
    """Count the view re-materializations of this engine."""
    MV_ = e.mod("plan.matview")
    calls = []
    orig = MV_.refresh_matview
    monkeypatch.setattr(MV_, "refresh_matview",
                        lambda s, n: calls.append(n) or orig(s, n))
    return calls


def test_matview_basics():
    def run(e):
        s = sales(e)
        e.keep(s.sql(MV))
        e.keep(s.sql("select region, s_amt, cnt, mn_q, mx_q from mv_sales "
                     "order by region"))
    got = twin(run)
    assert got[0] == "CREATE INCREMENTAL MATERIALIZED VIEW mv_sales"


def test_aqumv_rewrite_used():
    q = ("select region, sum(amt) as s from sales group by region "
         "order by region")

    def run(e):
        s = sales(e)
        s.sql(MV)
        aqumv(e, s, q)
        e.keep(s.sql(q))
        e.keep(without_aqumv(s, q))
    got = twin(run)
    assert got[0] is True
    np.testing.assert_array_equal(got[1].columns["s"], got[2].columns["s"])


def test_aqumv_global_agg_and_filter():
    q = "select sum(amt) as s, count(*) as c from sales where region = 'r1'"

    def run(e):
        s = sales(e)
        s.sql(MV)
        aqumv(e, s, q)
        e.keep(s.sql(q))
        e.keep(s.sql("select sum(amt) as s, count(*) as c from sales "
                     "where region = 'r1' and 1 = 1"))
    got = twin(run)
    assert got[0] is True
    for c in ("s", "c"):
        np.testing.assert_array_equal(got[1].columns[c], got[2].columns[c])


def test_aqumv_not_used_when_not_derivable():
    def run(e):
        s = sales(e)
        s.sql(MV)
        aqumv(e, s, "select region, avg(amt) as a from sales "
                    "group by region")
        aqumv(e, s, "select sum(amt) as s from sales where qty > 3")
    assert twin(run) == [False, False]


def test_ivm_insert_maintains():
    def run(e):
        s = sales(e)
        s.sql(MV)
        e.keep(s.sql("insert into sales values ('r1', 99, 1000.50, 100), "
                     "('r9', 1, 7.00, 2)"))
        e.keep(s.sql("select region, s_amt, cnt, mn_q, mx_q from mv_sales "
                     "order by region"))
        e.keep(without_aqumv(
            s, "select region, sum(amt) as s_amt, count(*) as cnt, "
               "min(qty) as mn_q, max(qty) as mx_q from sales "
               "group by region order by region"))
    got = twin(run)
    assert "r9" in got[1].decoded_columns()["region"].tolist()
    for c in ("region", "s_amt", "cnt", "mn_q", "mx_q"):
        np.testing.assert_array_equal(got[1].columns[c], got[2].columns[c])


def test_ivm_stays_fresh_for_aqumv():
    q = ("select region, count(*) as c from sales group by region "
         "order by region")

    def run(e):
        s = sales(e)
        s.sql(MV)
        s.sql("insert into sales values ('r0', 5, 1.00, 1)")
        aqumv(e, s, q)
        e.keep(s.sql(q))
        e.keep(without_aqumv(s, q))
    got = twin(run)
    assert got[0] is True
    np.testing.assert_array_equal(got[1].columns["c"], got[2].columns["c"])


def test_plain_matview_goes_stale_and_refreshes():
    q = "select region, sum(qty) as q from sales group by region"

    def run(e):
        s = sales(e)
        e.keep(s.sql("create materialized view mv2 as "
                     "select region, sum(qty) as q from sales "
                     "group by region"))
        aqumv(e, s, q)
        s.sql("insert into sales values ('r0', 5, 1.00, 1)")
        aqumv(e, s, q)       # stale now: the rewrite must not fire
        e.keep(s.sql("refresh materialized view mv2"))
        aqumv(e, s, q)
        e.keep(s.sql("select region, q from mv2 order by region"))
    got = twin(run)
    assert got[1:4] == [True, False, "REFRESH MATERIALIZED VIEW mv2"]
    assert got[4] is True


def test_update_delete_force_refresh():
    def run(e):
        s = sales(e)
        s.sql(MV)
        e.keep(s.sql("delete from sales where region = 'r2'"))
        e.keep(s.sql("select region, s_amt, cnt, mn_q, mx_q from mv_sales "
                     "order by region"))
    got = twin(run)
    assert "r2" not in got[1].decoded_columns()["region"].tolist()


def test_incremental_requires_not_null():
    def run(e):
        s = e.session()
        s.sql("create table nn (k bigint, v bigint)")  # nullable
        e.error(s.sql, "create incremental materialized view bad as "
                       "select k, sum(v) as s from nn group by k")
        e.keep(s.sql("create materialized view ok as "
                     "select k, sum(v) as s from nn group by k"))
    got = twin(run)
    assert got[0][0] == "BindError" and "NOT NULL" in got[0][1]


def test_matview_persists_across_sessions(tmp_path):
    def run(e):
        root = {"storage.root": e.root()}
        a = e.session(**root)
        a.sql("create table t (k bigint not null, v bigint not null)")
        a.sql("insert into t values (1, 10), (1, 20), (2, 5)")
        a.sql("create incremental materialized view m as "
              "select k, sum(v) as s from t group by k")
        b = e.session(**root)
        e.keep(b.sql("select k, s from m order by k"))
        # fresh across sessions: the rewrite fires in session b too
        aqumv(e, b, "select k, sum(v) as s from t group by k")
    got = twin(run, tmp_path)
    assert got[0].columns["s"].tolist() == [30, 5] and got[1] is True


def test_rollback_invalidates():
    q = "select region, sum(amt) as s from sales group by region"

    def run(e):
        s = sales(e)
        s.sql(MV)
        s.sql("begin")
        s.sql("insert into sales values ('r0', 5, 1.00, 1)")
        e.keep(s.sql("rollback"))
        aqumv(e, s, q)   # conservative: no AQUMV until refreshed
        s.sql("refresh materialized view mv_sales")
        aqumv(e, s, q)
        e.keep(s.sql("select region, s_amt, cnt from mv_sales "
                     "order by region"))
    assert twin(run)[:3] == ["ROLLBACK", False, True]


def test_aqumv_having_and_order_by_agg():
    q = ("select region, sum(amt) as s from sales group by region "
         "having sum(amt) > 6 order by sum(amt) desc")

    def run(e):
        s = sales(e)
        s.sql(MV)
        aqumv(e, s, q)
        e.keep(s.sql(q))
        e.keep(without_aqumv(s, q))
    got = twin(run)
    assert got[0] is True
    np.testing.assert_array_equal(got[1].columns["s"], got[2].columns["s"])


def test_explain_statement_shows_aqumv():
    def run(e):
        s = sales(e)
        s.sql(MV)
        e.keep(s.sql("explain select region, sum(amt) as s from sales "
                     "group by region"))
    assert "AQUMV" in twin(run)[0]


def test_incremental_unknown_table_is_bind_error():
    def run(e):
        s = e.session()
        e.error(s.sql, "create incremental materialized view m as "
                       "select k, sum(v) as s from nosuch group by k")
    assert twin(run)[0][0] == "BindError"


def test_drop_base_table_refused_with_dependents():
    def run(e):
        s = sales(e)
        s.sql(MV)
        e.error(s.sql, "drop table sales")
        e.keep(s.sql("drop materialized view mv_sales"))
        e.keep(s.sql("drop table sales"))
    got = twin(run)
    assert got[0][0] == "BindError" and "depend" in got[0][1]


def test_dml_into_matview_rejected():
    def run(e):
        s = sales(e)
        s.sql(MV)
        e.error(s.sql, "insert into mv_sales values ('zz', 1.00, 1, 1, 1)")
        e.error(s.sql, "delete from mv_sales where cnt > 0")
        e.error(s.sql, "update mv_sales set cnt = 0")
    for kind, msg in twin(run):
        assert kind == "BindError" and "materialized view" in msg


def test_rolled_back_create_leaves_no_durable_def(tmp_path):
    def run(e):
        root = {"storage.root": e.root()}
        a = e.session(**root)
        a.sql("create table t (k bigint not null, v bigint not null)")
        a.sql("insert into t values (1, 10)")
        a.sql("begin")
        a.sql("create materialized view m as select k, sum(v) as s from t "
              "group by k")
        a.sql("rollback")
        b = e.session(**root)
        e.keep("m" in b.catalog.matviews)
        e.keep(b.sql("select k, sum(v) as s from t group by k"))
    got = twin(run, tmp_path)
    assert got[0] is False and got[1].columns["s"].tolist() == [10]


def test_drop_matview():
    q = "select region, sum(amt) as s from sales group by region"

    def run(e):
        s = sales(e)
        s.sql(MV)
        e.keep(s.sql("drop materialized view mv_sales"))
        aqumv(e, s, q)
        e.error(s.sql, "select * from mv_sales")
    got = twin(run)
    assert got[:2] == ["DROP MATERIALIZED VIEW mv_sales", False]


def test_ivm_update_delete_delta_no_refresh(monkeypatch):
    """UPDATE and DELETE maintain sum/count views through the captured
    (subtract, add) delta, never a re-materialization."""
    def run(e):
        s = sales(e)
        s.sql(MV_DELTA)
        calls = spy_refresh(e, monkeypatch)
        for q in ("update sales set amt = amt + 10.50, qty = qty + 1 "
                  "where region = 'r1'",
                  "delete from sales where qty > 7",
                  "update sales set qty = qty * 2 where day < 5"):
            e.keep(s.sql(q))
        e.keep(s.sql("select region, s_amt, s_q, cnt from mv_delta "
                     "order by region"))
        e.keep(without_aqumv(s, ORACLE))
        e.keep(list(calls))
        aqumv(e, s, "select region, sum(amt) as s from sales "
                    "group by region")
    got = twin(run)
    for c in ("s_amt", "s_q", "cnt"):
        np.testing.assert_array_equal(got[3].columns[c], got[4].columns[c])
    assert got[5] == [] and got[6] is True


def test_ivm_delete_empties_group(monkeypatch):
    def run(e):
        s = sales(e)
        s.sql(MV_DELTA)
        calls = spy_refresh(e, monkeypatch)
        e.keep(s.sql("delete from sales where region = 'r2'"))
        e.keep(s.sql("select region, s_amt, s_q, cnt from mv_delta "
                     "order by region"))
        e.keep(list(calls))
    got = twin(run)
    assert "r2" not in got[1].decoded_columns()["region"].tolist()
    assert got[2] == []


def test_ivm_minmax_still_refreshes(monkeypatch):
    """min/max are not invertible under deletion: those views
    re-materialize."""
    def run(e):
        s = sales(e)
        s.sql(MV)
        calls = spy_refresh(e, monkeypatch)
        e.keep(s.sql("delete from sales where qty = 8"))
        e.keep(list(calls))
        e.keep(s.sql("select region, mn_q, mx_q from mv_sales "
                     "order by region"))
        e.keep(without_aqumv(s, "select region, min(qty) as mn_q, "
                                "max(qty) as mx_q from sales "
                                "group by region order by region"))
    got = twin(run)
    assert got[1] == ["mv_sales"]
    for c in ("mn_q", "mx_q"):
        np.testing.assert_array_equal(got[2].columns[c], got[3].columns[c])


def test_ivm_update_string_key(monkeypatch):
    """An UPDATE that moves rows between groups subtracts from the old
    group and adds to the new one."""
    def run(e):
        s = sales(e)
        s.sql(MV_DELTA)
        calls = spy_refresh(e, monkeypatch)
        e.keep(s.sql("update sales set region = 'r9' where region = 'r0' "
                     "and day < 10"))
        e.keep(s.sql("select region, s_amt, s_q, cnt from mv_delta "
                     "order by region"))
        e.keep(without_aqumv(s, ORACLE))
        e.keep(list(calls))
    got = twin(run)
    assert got[1].decoded_columns()["region"].tolist() == \
        got[2].decoded_columns()["region"].tolist()
    for c in ("s_amt", "s_q", "cnt"):
        np.testing.assert_array_equal(got[1].columns[c], got[2].columns[c])
    assert got[3] == []


@pytest.mark.parametrize("stmt", [
    "insert into sales select region, day + 100, amt, qty from sales "
    "where qty > 6",
    "update sales set amt = amt * 2 where day >= 20",
    "delete from sales where amt > 300",
])
def test_ivm_merge_equals_fresh_refresh(stmt):
    """The merged view equals a fresh REFRESH of it, bit for bit (the
    card's phase holds the same at SF1)."""
    def run(e):
        s = sales(e)
        s.sql(MV_DELTA)
        e.keep(s.sql(stmt))
        merged = e.keep(s.sql("select region, s_amt, s_q, cnt from "
                              "mv_delta order by region"))
        s.sql("refresh materialized view mv_delta")
        fresh = e.keep(s.sql("select region, s_amt, s_q, cnt from "
                             "mv_delta order by region"))
        for c in ("s_amt", "s_q", "cnt"):
            np.testing.assert_array_equal(merged.columns[c],
                                          fresh.columns[c])
    twin(run)
