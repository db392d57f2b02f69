"""DML on RAM tables (no store) through the port against the JAX
package, on the CPU: UPDATE, DELETE, INSERT … SELECT, CREATE TABLE AS
and COPY FROM/TO run the same statements in both engines; status texts
must be equal, and every table afterwards equal (``assert_same``: ints,
DECIMALs, dates, strings and NULL masks exactly, floats to rtol 1e-9).
"""

import pytest

import cloudberry_tpu as cb
from cloudberry_tpu_torch import Config as TorchConfig
from torch_parity import Pair

ROWS = [
    "(1, 'alpha', 10.25, date '1995-01-01', 1.5, null)",
    "(2, 'beta', null, date '1995-06-30', 2.5, 7)",
    "(3, 'gamma', 30.00, date '1996-02-29', null, 8)",
    "(4, 'alpha', 40.75, null, 4.5, 9)",
    "(5, null, 50.50, date '1997-12-31', 5.5, null)",
    "(6, 'delta', -6.10, date '1998-03-01', 6.5, 11)",
]
ALL = "select k, s, m, d, f, n from t order by k"


@pytest.fixture
def p():
    pair = Pair(cb.config.Config(n_segments=1).with_overrides(
        **{"sched.generic_plans": False}), TorchConfig())
    pair.sql("create table t (k bigint not null, s text, m decimal(12,2), "
             "d date, f double, n int)")
    pair.sql("insert into t values " + ", ".join(ROWS))
    return pair


@pytest.mark.parametrize("stmt", [
    "update t set m = m * 2 where d < date '1996-01-01'",
    "update t set s = 'epsilon' where k in (2, 5)",    # new dictionary code
    "update t set s = 'big' where n > 8",
    "update t set d = date '2000-01-01', n = n + 1 where f > 2.0",
    "update t set m = null where s = 'alpha'",
    "update t set f = f / 3",
    "delete from t where n > 8",          # NULL n: the row stays (3VL)
    "delete from t where s = 'alpha' or m < 0",
    "delete from t where d >= date '1996-01-01'",
    "delete from t",
])
def test_update_delete_match(p, stmt):
    p.sql(stmt)
    p.sql(ALL)


def test_three_valued_delete_keeps_null_predicate_rows(p):
    got, _ = p.sql("delete from t where n > 8")
    assert got == "DELETE 2"
    out, _ = p.sql(ALL)
    assert out.decoded_columns()["k"].tolist() == [1, 2, 3, 5]


def test_insert_select_and_ctas_match(p):
    p.sql("create table u (k bigint not null, s text, m decimal(12,2), "
          "d date, f double, n int)")
    p.sql("insert into u select k + 10, s, m, d, f, n from t where k > 2")
    p.sql("insert into u select k, s, m * 3, d, f, n from t "
          "where s is null")
    p.sql("select k, s, m, d, f, n from u order by k")
    p.sql("create table v as select s, sum(m) as sm, count(*) as c, "
          "max(d) as md from t group by s")
    p.sql("select s, sm, c, md from v order by s")
    # DECIMAL scale conversion on the way in (raw cents, no float trip)
    p.sql("create table w (k bigint, m decimal(12,4))")
    p.sql("insert into w select k, m from t")
    p.sql("select k, m from w order by k")


def test_copy_roundtrip_matches(p, tmp_path):
    paths = {"jax": tmp_path / "j.txt", "port": tmp_path / "t.txt"}
    for name, s in (("jax", p.js), ("port", p.ts)):
        assert s.sql(f"copy t to '{paths[name]}'") == "COPY 6"
    assert paths["jax"].read_text() == paths["port"].read_text()
    p.sql("create table back (k bigint not null, s text, "
          "m decimal(12,2), d date, f double, n int)")
    want = p.js.sql(f"copy back from '{paths['jax']}'")
    assert p.ts.sql(f"copy back from '{paths['port']}'") == want
    p.sql("select k, s, m, d, f, n from back order by k")


def test_copy_native_fast_path_matches(p, tmp_path):
    """A NULL-free file takes the native integer/decimal parsers."""
    path = tmp_path / "in.txt"
    path.write_text("".join(f"{i}|{i * 1.25:.2f}|x{i % 3}\n"
                            for i in range(1, 200)))
    p.sql("create table c (k bigint, m decimal(10,2), s text)")
    got, _ = p.sql(f"copy c from '{path}'")
    assert got == "COPY 199"
    p.sql("select k, m, s from c order by k")


def test_insert_null_into_not_null_raises_in_both(p):
    for s in (p.js, p.ts):
        with pytest.raises(Exception, match="NOT NULL"):
            s.sql("insert into t select null, s, m, d, f, n from t")
