"""TPC-H through the port against the JAX package, end to end on the CPU.

The JAX Session runs with its Pallas kernels on (``exec.use_pallas``, in
interpret mode on the CPU) and without generic plans; the port's
``Session(device="cpu")`` scans the SAME encoded arrays, installed through
``catalog.carry.load_encoded`` from the JAX catalog. Results must be equal:
exact for int, DECIMAL, count, date and string columns, rtol 1e-9 for
float64 columns (``torch_parity.assert_same``). Each query must also reach
the same kernels in both engines (the port's wrappers run their plain
versions on the CPU). All 22 queries run: q4 and q21 group by COUNT only,
where the reference's Pallas dense path raises (ROADMAP Queue C 5), so they
are held against its default path; q18 selects no row at SF0.01 in either
engine. The same texts run once more from store-backed sessions of both
engines (every table cold, scans reading pruned micro-partitions), where
the port must also reach the same kernels as its RAM run.
"""

import numpy as np
import pytest

import cloudberry_tpu as cb
from cloudberry_tpu.exec import pallas_kernels as PK
from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch import tpch
from cloudberry_tpu_torch.exec import cuda_kernels as CK
from cloudberry_tpu_torch.exec import executor as X
from tools.tpch_queries import QUERIES
from tools.tpchgen import load_tpch
from torch_parity import PALLAS_OF, assert_same, carry_tables, count_calls

COUNT_ONLY_DENSE = ("q4", "q21")


@pytest.fixture(scope="module")
def sessions():
    cfg = cb.get_config().with_overrides(
        **{"exec.use_pallas": True, "sched.generic_plans": False})
    js = cb.Session(cfg)
    load_tpch(js, sf=0.01, seed=7)
    ts = TorchSession(device="cpu")
    carry_tables(js, ts)
    return js, ts


def test_port_holds_all_22_texts():
    assert tpch.QUERIES == QUERIES and len(QUERIES) == 22


@pytest.fixture(scope="module")
def store_sessions(sessions, tmp_path_factory):
    """The same TPC-H data written to a store by each engine (each on a
    root of its own, 16,384 rows per micro-partition: lineitem has four),
    then opened by fresh sessions, so that every table is cold and every
    scan reads pruned partitions."""
    js, ts = sessions
    root = tmp_path_factory.mktemp("tpch_store")
    rpp = {"storage.rows_per_partition": 16384}
    jcfg = js.config.with_overrides(
        **{"storage.root": str(root / "jax"), **rpp})
    tcfg = TorchConfig().with_overrides(
        **{"storage.root": str(root / "port"), **rpp})
    load_tpch(cb.Session(jcfg), sf=0.01, seed=7)
    carry_tables(js, TorchSession(tcfg, device="cpu"))
    jcold, tcold = cb.Session(jcfg), TorchSession(tcfg, device="cpu")
    assert all(t.cold for t in tcold.catalog.tables.values())
    return jcold, tcold


TPCH_HELD = [q for q in sorted(QUERIES, key=lambda q: int(q[1:]))
             if q not in COUNT_ONLY_DENSE]


def _held_equal(js, ts, qname, monkeypatch) -> dict:
    """Run one query in both engines: equal results, and the same kernels
    reached (the port's wrappers run their plain versions on the CPU).
    Returns the port's kernel call counts."""
    jcalls = count_calls(monkeypatch, PK, PALLAS_OF)
    tcalls = count_calls(monkeypatch, CK, {k: k for k in PALLAS_OF})
    want = js.sql(QUERIES[qname])
    got = ts.sql(QUERIES[qname])
    assert tcalls == jcalls, (tcalls, jcalls)
    if qname in ("q1", "q3", "q5"):
        assert any(tcalls.values()), "the query reached no kernel"
    assert_same(got, want, allow_empty=(qname == "q18"))
    return dict(tcalls)


@pytest.mark.parametrize("qname", TPCH_HELD)
def test_tpch_matches_jax(sessions, qname, monkeypatch):
    _held_equal(*sessions, qname, monkeypatch)


@pytest.mark.parametrize("qname", TPCH_HELD)
def test_tpch_from_the_store_matches_jax(sessions, store_sessions, qname,
                                         monkeypatch):
    """The same query from store-backed sessions of both engines: equal
    results, and the port reaches the same kernels as its RAM run. The
    number of calls may differ: a cold table reports only the statistics
    its manifest holds (single-column uniqueness, no lazily computed NDV),
    so the join order of a
    store-backed plan can differ from the RAM plan's — in both engines
    alike (q5 makes four probe-join calls from the store, two in RAM)."""
    from_store = _held_equal(*store_sessions, qname, monkeypatch)
    ram = count_calls(monkeypatch, CK, {k: k for k in PALLAS_OF})
    sessions[1].sql(QUERIES[qname])
    assert {k for k, n in from_store.items() if n} == \
        {k for k, n in ram.items() if n}, (from_store, ram)


def test_count_only_dense_q21(sessions, monkeypatch):
    """q21 (like q4 below) groups with COUNT only: the reference's Pallas
    dense path raises, the port's kernel takes it; held against the
    reference's default path."""
    js, ts = sessions
    tcalls = count_calls(monkeypatch, CK, {k: k for k in PALLAS_OF})
    with pytest.raises(ValueError):
        js.sql(QUERIES["q21"])
    want = cb.Session(js.config.with_overrides(
        **{"exec.use_pallas": False}))
    want.catalog = js.catalog
    got = ts.sql(QUERIES["q21"])
    assert tcalls["dense_agg"] == 1
    assert_same(got, want.sql(QUERIES["q21"]))


def test_explain_matches_jax(sessions):
    """Session.explain at one segment gives the reference's plan text."""
    js, ts = sessions
    assert ts.explain(QUERIES["q3"]) == js.explain(QUERIES["q3"])


def test_count_only_dense_group_by(sessions, monkeypatch):
    """q4 groups with COUNT(*) only: the dense kernel with no value rows.
    The reference's Pallas dense path cannot take that shape (its kernel
    slices an empty sums block), so q4 is held against the reference's
    default (XLA) path."""
    js, ts = sessions
    tcalls = count_calls(monkeypatch, CK, {k: k for k in PALLAS_OF})
    want = cb.Session(js.config.with_overrides(
        **{"exec.use_pallas": False}))
    want.catalog = js.catalog
    got = ts.sql(QUERIES["q4"])
    assert tcalls["dense_agg"] == 1
    assert_same(got, want.sql(QUERIES["q4"]))


# GROUP BY shapes around the dense path: dictionary keys, a string CASE,
# keys made nullable by an outer join (NULL groups), COALESCE over them,
# a derived dictionary (SUBSTRING), a COUNT-only aggregate
DENSE_SQL = {
    "q1": QUERIES["q1"],
    "q4": QUERIES["q4"],
    "q5": QUERIES["q5"],
    "string_case": "select case when l_quantity > 25 then 'big' else "
                   "'small' end as sz, count(*) as c, sum(l_quantity) as q "
                   "from lineitem group by sz",
    "null_key": "select n_name, count(*) as c from customer left join "
                "nation on c_nationkey = n_nationkey + 20 group by n_name",
    "coalesce_null_key": "select coalesce(n_name, 'none') as nm, count(*) "
                         "as c from customer left join nation on "
                         "c_nationkey = n_nationkey + 20 "
                         "group by coalesce(n_name, 'none')",
    "substring_key": "select substring(c_phone from 1 for 2) as cc, "
                     "count(*) as c, sum(c_acctbal) as b from customer "
                     "group by substring(c_phone from 1 for 2)",
}


@pytest.mark.parametrize("name", sorted(DENSE_SQL))
def test_dense_cells_stay_in_domain(sessions, name, monkeypatch):
    """The port's dense kernel drops a selected row whose cell id lies
    outside [0, cells); the reference's default path clamps it into an edge
    cell. No SQL hands the kernel such a row: dictionary codes index their
    dictionary, and a NULL key (outer join) rides a separate validity key,
    which is not a string, so that GROUP BY takes the sort path. Every
    dense call here sees only in-domain cells, and each result equals the
    reference's default (non-Pallas) session."""
    js, ts = sessions
    calls = []
    real = CK.dense_agg

    def spy(gid, ivals, fvals, sel, n_cells):
        g = gid[sel]
        calls.append(bool(((g >= 0) & (g < n_cells)).all()))
        return real(gid, ivals, fvals, sel, n_cells)

    monkeypatch.setattr(CK, "dense_agg", spy)
    want = cb.Session(js.config.with_overrides(**{"exec.use_pallas": False}))
    want.catalog = js.catalog
    got = ts.sql(DENSE_SQL[name])
    assert all(calls)
    assert bool(calls) == (name != "null_key"), calls
    assert_same(got, want.sql(DENSE_SQL[name]))


@pytest.mark.parametrize("qname", ["q5", "q7", "q8", "q10"])
def test_probe_join_one_call_per_eligible_join(sessions, qname,
                                               monkeypatch):
    """Every join that passes the probe-join gate is ONE call of the fused
    operator (CK.probe_join, one kernel launch on the card) from the raw
    key columns; a join the gate refuses makes none. Both engines fuse the
    same joins, and the results are equal."""
    js, ts = sessions
    per_join = []
    real_gate = X.Lowerer._probe_join_kernel
    real_call = CK.probe_join
    calls = [0]

    def gate(self, node, bcols, bselm, bkeys, pselm, pkeys):
        before = calls[0]
        out = real_gate(self, node, bcols, bselm, bkeys, pselm, pkeys)
        per_join.append((out is not None, calls[0] - before))
        return out

    def call(*a):
        calls[0] += 1
        return real_call(*a)

    monkeypatch.setattr(X.Lowerer, "_probe_join_kernel", gate)
    monkeypatch.setattr(CK, "probe_join", call)
    jcalls = count_calls(monkeypatch, PK, {"probe_join": "probe_join_pallas"})
    js._stmt_cache.clear()  # trace the statement again, as in a fresh run
    want = js.sql(QUERIES[qname])
    got = ts.sql(QUERIES[qname])
    fused = [n for ok, n in per_join if ok]
    assert fused and all(n == 1 for n in fused), per_join
    assert all(n == 0 for ok, n in per_join if not ok), per_join
    assert calls[0] == len(fused) == jcalls["probe_join"]
    assert_same(got, want)


def test_duplicate_build_key_raises_on_both_engines(monkeypatch):
    """A SQL join whose dimension table holds a duplicate key, planned as
    a unique (PK) build: both engines take their fused probe join, and
    both raise DuplicateBuildKeyError after the statement — the port from
    the flag slot the kernel sets."""
    from cloudberry_tpu.exec.executor import DuplicateBuildKeyError as JDup
    from cloudberry_tpu_torch.exec.executor import DuplicateBuildKeyError

    js = cb.Session(cb.get_config().with_overrides(
        **{"exec.use_pallas": True, "sched.generic_plans": False}))
    ts = TorchSession(device="cpu")
    fact = ",".join(f"({i}, {i % 50})" for i in range(400))
    dim = ",".join(f"({d}, {d * 3})" for d in [*range(50), 7])
    for s in (js, ts):
        s.sql("create table fact (k bigint, grp bigint) distributed by (k)")
        s.sql("create table dim (d bigint, p bigint) distributed by (d)")
        s.sql(f"insert into fact values {fact}")
        s.sql(f"insert into dim values {dim}")
        # the stale-inference scenario: the planner takes dim.d as unique
        monkeypatch.setattr(type(s.catalog.table("dim")), "is_unique_cols",
                            lambda self, cols: True)
    jcalls = count_calls(monkeypatch, PK, {"probe_join": "probe_join_pallas"})
    tcalls = count_calls(monkeypatch, CK, {"probe_join": "probe_join"})
    q = "select k, p from fact, dim where grp = d"
    with pytest.raises(JDup):
        js.sql(q)
    with pytest.raises(DuplicateBuildKeyError):
        ts.sql(q)
    assert jcalls["probe_join"] == tcalls["probe_join"] == 1
    # a probe that never hits the duplicated key is not an error
    ok = "select k, p from fact, dim where grp = d and grp <> 7"
    assert_same(ts.sql(ok), js.sql(ok))


def test_wide_join_key_keeps_the_sorted_lookup(monkeypatch):
    """The port's own gate (ROADMAP Queue C): a join on more key columns
    than the kernel takes (CK.PROBE_MAX_KEYS) keeps the sorted lookup,
    where the reference fuses it; the results are equal."""
    js = cb.Session(cb.get_config().with_overrides(
        **{"exec.use_pallas": True, "sched.generic_plans": False}))
    ts = TorchSession(device="cpu")
    cols = ["a", "b", "c", "d", "e"]
    dim = ",".join("(" + ", ".join(str((i >> s) & 1) for s in range(5))
                   + f", {i})" for i in range(32))
    fact = ",".join("(" + ", ".join(str((i * 7 >> s) & 1)
                                    for s in range(5)) + f", {i})"
                    for i in range(200))
    for s in (js, ts):
        s.sql("create table dim5 (" + ", ".join(f"{c} int" for c in cols)
              + ", v bigint) distributed by (v)")
        s.sql("create table fact5 (" + ", ".join(f"f{c} int" for c in cols)
              + ", k bigint) distributed by (k)")
        s.sql(f"insert into dim5 values {dim}")
        s.sql(f"insert into fact5 values {fact}")
    jcalls = count_calls(monkeypatch, PK, {"probe_join": "probe_join_pallas"})
    tcalls = count_calls(monkeypatch, CK, {"probe_join": "probe_join"})
    q = ("select k, v from fact5, dim5 where "
         + " and ".join(f"f{c} = {c}" for c in cols))
    want = js.sql(q)
    got = ts.sql(q)
    assert len(cols) > CK.PROBE_MAX_KEYS
    assert jcalls["probe_join"] == 1 and tcalls["probe_join"] == 0
    assert_same(got, want)
