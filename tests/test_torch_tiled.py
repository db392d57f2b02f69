"""Tiled (out-of-core) execution of the port against the JAX package.

The single-segment cases of the JAX package's ``test_spill.py`` and
``test_spill_sort_window.py``: a statement whose plan-time estimate
exceeds ``resource.query_mem_bytes`` runs as a stream of tiles in both
engines, under the same budget, on the same encoded tables. The port's
result must equal its own one-shot run and the JAX session's (exactly;
floats per ``torch_parity.assert_same``; window-mode rows sorted by every
column, as the reference's test compares them), and its report must take
the JAX session's decisions: mode, tile rows, tile count, accumulator
capacity and step estimate. The tiled programs must reach the kernels the
one-shot run reaches, and the streamed table must never be copied to the
device whole.
"""

import numpy as np
import pytest

from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch.exec import cuda_kernels as CK
from cloudberry_tpu_torch.exec.resource import ResourceError
from torch_parity import (assert_same, assert_same_rows, budget_pair,
                          carry_tables, count_calls, same_tiled_report)

JOIN_GROUP_Q = ("SELECT g, sum(v) AS sv, count(*) AS c "
                "FROM fact JOIN dim ON fact.k = dim.k "
                "GROUP BY g ORDER BY g")
TOPN_Q = ("SELECT fact.k AS k, v, g FROM fact JOIN dim ON fact.k = dim.k "
          "WHERE v < 90 ORDER BY v, fact.k, g LIMIT 25")


def _load(n_fact=200_000, n_dim=500, seed=3):
    def load(session):
        rng = np.random.default_rng(seed)
        session.sql("CREATE TABLE dim (k BIGINT, g BIGINT) "
                    "DISTRIBUTED BY (k)")
        session.sql("CREATE TABLE fact (k BIGINT, v BIGINT) "
                    "DISTRIBUTED BY (k)")
        session.catalog.table("dim").set_data(
            {"k": np.arange(n_dim), "g": np.arange(n_dim) % 9})
        session.catalog.table("fact").set_data(
            {"k": rng.integers(0, n_dim, n_fact),
             "v": rng.integers(0, 100, n_fact)})
    return load


def _one_shot(js) -> TorchSession:
    """A port session at the default budget over the JAX session's
    tables."""
    ts = TorchSession(device="cpu")
    carry_tables(js, ts)
    return ts


def _watch_uploads(ts) -> list:
    """Record the names of the tables the session copies to its device
    whole."""
    seen = []
    real = ts.device_table

    def recording(name):
        seen.append(name)
        return real(name)

    ts.device_table = recording
    return seen


@pytest.fixture(scope="module")
def join_group():
    js, ts = budget_pair(_load(), 4 << 20)
    return js, ts, _one_shot(js)


def test_tiled_join_group_matches_one_shot_and_jax(join_group):
    js, ts, one = join_group
    uploads = _watch_uploads(ts)
    got = ts.sql(JOIN_GROUP_Q)
    want = js.sql(JOIN_GROUP_Q)
    assert_same(got, want)
    assert_same(got, one.sql(JOIN_GROUP_Q))
    assert one.last_tiled_report is None
    rep = same_tiled_report(ts, js)
    assert rep["n_tiles"] > 1 and rep["stream_table"] == "fact"
    # the admitted per-step estimate respects the budget
    assert rep["est_step_bytes"] <= rep["budget_bytes"] == 4 << 20
    # the build (dim) is resident; the stream (fact) never uploads whole
    assert "dim" in uploads and "fact" not in uploads


def test_tiled_repeated_run(join_group):
    js, ts, _ = join_group
    want = js.sql(JOIN_GROUP_Q)
    first = ts.sql(JOIN_GROUP_Q)
    second = ts.sql(JOIN_GROUP_Q)
    assert_same(first, want)
    assert_same(second, want)
    assert ts.last_tiled_report["n_tiles"] > 1


def test_tiled_global_agg():
    q = ("SELECT sum(v) AS sv, min(v) AS mn, max(v) AS mx, "
         "count(*) AS c, avg(v) AS av FROM fact")
    js, ts = budget_pair(_load(), 1 << 20)
    got = ts.sql(q)
    assert_same(got, js.sql(q))
    assert_same(got, _one_shot(js).sql(q))
    assert same_tiled_report(ts, js)["n_tiles"] > 1


def test_merge_overflow_grows_accumulator():
    """An under-estimated group count grows the accumulator and retries
    (the increase-nbatch discipline) instead of truncating groups."""
    q = ("SELECT k % 7000 AS kk, count(*) AS c, sum(v) AS sv "
         "FROM fact GROUP BY k % 7000 ORDER BY kk LIMIT 50")
    js, ts = budget_pair(_load(n_dim=10_000), 4 << 20)
    got = ts.sql(q)
    assert_same(got, js.sql(q))
    assert_same(got, _one_shot(js).sql(q))
    assert same_tiled_report(ts, js)["acc_capacity"] >= 7000


def test_tiled_spine_expansion_join():
    """A many-to-many join ON the tiled spine: per-tile pair buffers are
    floored by the tile-scaled estimate, and the adaptive loop absorbs
    what the floor missed."""
    def load(s):
        rng = np.random.default_rng(5)
        s.sql("CREATE TABLE dup (k BIGINT, g BIGINT) DISTRIBUTED BY (k)")
        s.sql("CREATE TABLE fact (k BIGINT, v BIGINT) DISTRIBUTED BY (k)")
        keys = np.repeat(np.arange(100), 20)
        s.catalog.table("dup").set_data({"k": keys, "g": keys % 7})
        s.catalog.table("fact").set_data(
            {"k": rng.integers(0, 100, 150_000),
             "v": rng.integers(0, 50, 150_000)})

    q = ("SELECT g, count(*) AS c, sum(v) AS sv "
         "FROM fact JOIN dup ON fact.k = dup.k GROUP BY g ORDER BY g")
    js, ts = budget_pair(load, 8 << 20)
    got = ts.sql(q)
    assert_same(got, js.sql(q))
    assert_same(got, _one_shot(js).sql(q))
    rep = same_tiled_report(ts, js)
    assert rep["n_tiles"] > 1
    assert rep["est_step_bytes"] <= rep["budget_bytes"]


def test_tiled_streams_cold_storage(tmp_path):
    """Cold tables stream tile by tile from micro-partition files: the
    stream never loads into session RAM or onto the device whole."""
    import cloudberry_tpu as cb

    rpp = {"storage.rows_per_partition": 25_000}
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jcfg = cb.get_config().with_overrides(
        n_segments=1, **{"sched.generic_plans": False,
                         "storage.root": jroot, **rpp})
    js0 = cb.Session(jcfg)
    _load(n_fact=150_000)(js0)
    carry_tables(js0, TorchSession(TorchConfig().with_overrides(
        **{"storage.root": troot, **rpp}), device="cpu"))
    budget = {"resource.query_mem_bytes": 3 << 20}
    js = cb.Session(jcfg.with_overrides(**budget))
    ts = TorchSession(TorchConfig().with_overrides(
        **{"storage.root": troot, **budget}), device="cpu")
    assert ts.catalog.table("fact").cold
    uploads = _watch_uploads(ts)
    got = ts.sql(JOIN_GROUP_Q)
    assert_same(got, js.sql(JOIN_GROUP_Q))
    assert_same(got, js0.sql(JOIN_GROUP_Q))
    rep = same_tiled_report(ts, js)
    assert rep["n_tiles"] > 1
    assert rep["pipeline"]["parts_read"] == 6
    assert ts.catalog.table("fact").cold and "fact" not in uploads


@pytest.mark.parametrize("q,m", [
    (TOPN_Q, 25),
    ("SELECT v, fact.k AS k FROM fact JOIN dim ON fact.k = dim.k "
     "ORDER BY v DESC, fact.k DESC LIMIT 10 OFFSET 7", 17),
    ("SELECT v FROM fact JOIN dim ON fact.k = dim.k "
     "WHERE v < 0 ORDER BY v LIMIT 5", 5),
], ids=["basic", "offset_desc", "empty"])
def test_tiled_topn(join_group, q, m):
    """ORDER BY + LIMIT over a join spine with no aggregation: a bounded
    top-N accumulator (nodeSort.c bounded-heap role)."""
    js, ts, one = join_group
    got = ts.sql(q)
    assert_same(got, js.sql(q), allow_empty=True)
    assert_same(got, one.sql(q), allow_empty=True)
    rep = same_tiled_report(ts, js)
    assert rep["mode"] == "topn" and rep["acc_capacity"] == m
    assert rep["n_tiles"] > 1
    assert rep["est_step_bytes"] <= rep["budget_bytes"]


@pytest.fixture(scope="module")
def tpch_small():
    from tools.tpchgen import load_tpch

    js, ts = budget_pair(lambda s: load_tpch(s, sf=0.02, seed=7))
    return js, ts, _one_shot(js)


# budgets (MiB) that tile each text at SF 0.02 into several tiles
TPCH_TILED = {"q1": 4, "q3": 16, "q5": 8, "q9": 10}


@pytest.mark.parametrize("qn", sorted(TPCH_TILED))
def test_tpch_tiled_reaches_the_one_shot_kernels(tpch_small, qn,
                                                 monkeypatch):
    """TPC-H texts under a small budget: equal to the one-shot run and to
    the JAX session under the same budget, with the JAX session's tiling
    decisions, and every kernel the one-shot run calls is called in the
    tiled programs (prelude, steps or finalize)."""
    from tools.tpch_queries import QUERIES

    js, ts, one = tpch_small
    budget = TPCH_TILED[qn] << 20
    q = QUERIES[qn]
    calls = count_calls(monkeypatch, CK, {k: k for k in CK.LAUNCHES})
    want = one.sql(q)
    one_shot = {k for k, v in calls.items() if v}
    for k in calls:
        calls[k] = 0
    js.config = js.config.with_overrides(
        **{"resource.query_mem_bytes": budget})
    ts.config = ts.config.with_overrides(
        **{"resource.query_mem_bytes": budget})
    got = ts.sql(q)
    assert_same(got, want)
    assert_same(got, js.sql(q))
    rep = same_tiled_report(ts, js)
    assert rep["n_tiles"] > 1 and rep["est_step_bytes"] <= budget
    assert one_shot and one_shot <= {k for k, v in calls.items() if v}


# ------------------------------------------------ sort and window spill

SORT_Q = ("SELECT g, v, w FROM fact JOIN dim ON fact.k = dim.k "
          "WHERE v < 50 ORDER BY g, v DESC, w")
WIN_Q = ("SELECT g, v, rank() over (partition by g order by v desc) AS r,"
         " sum(v) over (partition by g) AS sv, "
         "avg(w) over (partition by g order by v, w "
         "rows between 2 preceding and current row) AS aw "
         "FROM fact JOIN dim ON fact.k = dim.k")


def _load_w(session, n_fact=200_000, n_dim=500):
    rng = np.random.default_rng(3)
    session.sql("CREATE TABLE dim (k BIGINT, g BIGINT) DISTRIBUTED BY (k)")
    session.sql("CREATE TABLE fact (k BIGINT, v BIGINT, w DOUBLE) "
                "DISTRIBUTED BY (k)")
    session.catalog.table("dim").set_data(
        {"k": np.arange(n_dim), "g": np.arange(n_dim) % 300})
    session.catalog.table("fact").set_data(
        {"k": rng.integers(0, n_dim, n_fact),
         "v": rng.integers(0, 100, n_fact),
         "w": rng.standard_normal(n_fact)})


@pytest.fixture(scope="module")
def sort_pair():
    js, ts = budget_pair(_load_w, 4 << 20)
    return js, ts, _one_shot(js)


def test_external_sort_matches(sort_pair):
    js, ts, one = sort_pair
    got = ts.sql(SORT_Q)
    assert_same(got, js.sql(SORT_Q))
    assert_same(got, one.sql(SORT_Q))
    rep = same_tiled_report(ts, js)
    assert rep["mode"] == "sort" and rep["n_tiles"] > 1
    assert rep["est_step_bytes"] <= rep["budget_bytes"]


def test_window_spill_matches(sort_pair):
    js, ts, one = sort_pair
    got = ts.sql(WIN_Q)
    assert_same_rows(got, js.sql(WIN_Q), float_cols=("aw",))
    assert_same_rows(got, one.sql(WIN_Q), float_cols=("aw",))
    rep = same_tiled_report(ts, js)
    assert rep["mode"] == "window"
    assert rep["n_tiles"] > 1 and rep["n_chunks"] > 1
    assert rep["n_chunks"] == js.last_tiled_report["n_chunks"]


def test_window_spill_over_a_filtered_join(sort_pair):
    """A window stack over a filtered join (the card's WIN_DS shape): the
    filter's field list still names a column that pruning removed below
    it. The JAX package's tiled step raises KeyError there (ROADMAP Queue
    C 18); the port streams the columns the spine produced, with the JAX
    package's tiling decisions, and equals its own one-shot run and the
    JAX package's one-shot run at a budget that admits the statement."""
    import cloudberry_tpu as cb
    from cloudberry_tpu.exec.tiled import plan_tiled
    from cloudberry_tpu.plan.planner import plan_statement
    from cloudberry_tpu.sql.parser import parse_sql

    js, ts, one = sort_pair
    q = ("SELECT g, v, rank() over (partition by g order by v desc) AS r, "
         "sum(v) over (partition by g) AS sv "
         "FROM fact JOIN dim ON fact.k = dim.k WHERE v < 90")
    with pytest.raises(KeyError, match="fact.w"):
        js.sql(q)
    got = ts.sql(q)
    assert_same_rows(got, one.sql(q))
    js_big = cb.Session(cb.get_config().with_overrides(
        n_segments=1, **{"sched.generic_plans": False}))
    _load_w(js_big)
    assert_same_rows(got, js_big.sql(q))
    assert js_big.last_tiled_report is None
    rep = ts.last_tiled_report
    assert rep["mode"] == "window" and rep["n_tiles"] > 1
    jrep = plan_tiled(plan_statement(parse_sql(q), js, {}).plan, js).report
    for k in ("mode", "tile_rows", "acc_capacity", "est_step_bytes"):
        assert rep[k] == jrep[k], k


def test_huge_offset_limit_falls_back_to_sort(sort_pair):
    """A LIMIT whose OFFSET exceeds any resident accumulator cannot run
    top-N; the external sort applies it host-side."""
    js, ts, one = sort_pair
    q = SORT_Q + " LIMIT 1000 OFFSET 60000"
    got = ts.sql(q)
    assert_same(got, js.sql(q))
    assert_same(got, one.sql(q))
    assert got.num_rows() == 1000
    assert same_tiled_report(ts, js)["mode"] == "sort"


def test_single_partition_too_big_is_a_clear_error():
    def load(s):
        s.sql("CREATE TABLE one (k BIGINT, v BIGINT) DISTRIBUTED BY (k)")
        s.catalog.table("one").set_data(
            {"k": np.zeros(300_000, dtype=np.int64),
             "v": np.arange(300_000)})

    js, ts = budget_pair(load, 3 << 20)
    q = "SELECT k, sum(v) over (partition by k) AS sv FROM one"
    with pytest.raises(Exception, match="partition"):
        js.sql(q)
    with pytest.raises(Exception, match="partition"):
        ts.sql(q)


def test_spill_disabled_refuses():
    js, ts = budget_pair(_load(), 4 << 20,
                         **{"resource.enable_spill": False})
    from cloudberry_tpu.exec.resource import ResourceError as JaxRE

    with pytest.raises(JaxRE, match="memory estimate"):
        js.sql(JOIN_GROUP_Q)
    with pytest.raises(ResourceError, match="memory estimate"):
        ts.sql(JOIN_GROUP_Q)
