"""Distributed planning through the port against the JAX package, on the
CPU: the distribution pass, the memo's joint join-order search, direct
dispatch, the shard layout and admission. The JAX package compiles
almost nothing here, so the texts are cheap.

- ``explain`` text at 8 and 4 segments, memo on and off, equal to the JAX
  package's on the 22 TPC-H texts (SF 0.01) and TPC-DS q17/q25/q29
  (tpcds-lite scale 0.5); the text carries each node's stamped locus and
  the verifier's derived ``dist:`` annotation;
- ``sharded_table`` arrays and counts equal to the reference's;
- direct dispatch picks the reference's segment;
- the admission estimate of a distributed plan equals the reference's;
- a sketch learned from one statement overflows another's aggregate in
  both engines (a reference fault the port keeps).

The feedback loop's parity runs in ``test_torch_dist_feedback.py``.
"""

import numpy as np
import pytest

import cloudberry_tpu as cb
from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch import tpch
from tools.tpcds_queries import DS_QUERIES
from tools.tpcdsgen import load_tpcds
from tools.tpchgen import load_tpch
from torch_parity import assert_same, carry_tables

DS_TEXTS = ("q17", "q25", "q29")
LAYOUTS = [(8, True), (8, False), (4, True), (4, False)]


def _pair(load, nseg, memo, **over):
    over = {"n_segments": nseg, "planner.enable_memo": memo, **over}
    js = cb.Session(cb.get_config().with_overrides(**over))
    load(js)
    ts = TorchSession(TorchConfig().with_overrides(**over), device="cpu")
    carry_tables(js, ts)
    return js, ts


@pytest.fixture(scope="module")
def tpch_layouts():
    return {(n, m): _pair(lambda s: load_tpch(s, sf=0.01, seed=7), n, m)
            for n, m in LAYOUTS}


@pytest.fixture(scope="module")
def ds_layouts():
    return {(n, m): _pair(lambda s: load_tpcds(s, scale=0.5, seed=11), n, m)
            for n, m in LAYOUTS}


@pytest.mark.parametrize("layout", LAYOUTS,
                         ids=[f"{n}seg-memo-{m}" for n, m in LAYOUTS])
@pytest.mark.parametrize("qname", sorted(tpch.QUERIES,
                                         key=lambda q: int(q[1:])))
def test_tpch_explain_matches_jax(tpch_layouts, qname, layout):
    js, ts = tpch_layouts[layout]
    want = js.explain(tpch.QUERIES[qname])
    assert ts.explain(tpch.QUERIES[qname]) == want
    assert "Motion" in want or "GroupAgg" in want


@pytest.mark.parametrize("layout", LAYOUTS,
                         ids=[f"{n}seg-memo-{m}" for n, m in LAYOUTS])
@pytest.mark.parametrize("qname", DS_TEXTS)
def test_tpcds_explain_matches_jax(ds_layouts, qname, layout):
    js, ts = ds_layouts[layout]
    want = js.explain(DS_QUERIES[qname])
    assert ts.explain(DS_QUERIES[qname]) == want
    assert "Motion" in want


def test_sharded_table_equals_the_reference(tpch_layouts):
    """The host shard layout (and so the device upload) is the
    reference's: the same rows in the same (nseg, capacity) slots, the
    same counts, replicated tables whole."""
    js, ts = tpch_layouts[(8, True)]
    for name in ("lineitem", "orders", "customer", "nation", "region"):
        want, got = js.sharded_table(name), ts.sharded_table(name)
        assert (got.capacity, got.replicated) == \
            (want.capacity, want.replicated)
        np.testing.assert_array_equal(got.counts, want.counts)
        assert sorted(got.columns) == sorted(want.columns)
        for c in want.columns:
            np.testing.assert_array_equal(got.columns[c], want.columns[c])
        ds = ts.device_shards(name)
        assert ds.capacity == want.capacity
        for c in want.columns:
            np.testing.assert_array_equal(ds.columns[c].numpy(),
                                          want.columns[c])
        assert ts.shard_capacity(name) == js.shard_capacity(name)


@pytest.mark.parametrize("key", [1, 7, 32, 4711, 59_999])
def test_direct_dispatch_picks_the_same_segment(tpch_layouts, key):
    from cloudberry_tpu.plan.binder import Binder as JBinder
    from cloudberry_tpu.plan.planner import _optimize as jopt
    from cloudberry_tpu.sql.parser import parse_sql as jparse
    from cloudberry_tpu_torch.plan.binder import Binder as TBinder
    from cloudberry_tpu_torch.plan.planner import _optimize as topt
    from cloudberry_tpu_torch.sql.parser import parse_sql as tparse

    js, ts = tpch_layouts[(8, True)]
    sql = ("select o_orderkey, o_totalprice from orders "
           f"where o_orderkey = {key}")
    jp = jopt(JBinder(js.catalog, js.config).bind_query(jparse(sql)), js)
    tp = topt(TBinder(ts.catalog, ts.config).bind_query(tparse(sql)), ts)
    assert getattr(tp, "_direct_segment", None) == \
        getattr(jp, "_direct_segment", None)
    assert tp._direct_segment is not None
    assert_same(ts.sql(sql), js.sql(sql), allow_empty=True)


@pytest.mark.parametrize("qname", sorted(tpch.QUERIES,
                                         key=lambda q: int(q[1:])))
def test_admission_estimate_at_8_segments_matches_jax(tpch_layouts, qname):
    """The per-segment memory estimate of a distributed plan (scan
    capacities are shard capacities, motion capacities receive buffers)
    equals the reference's, so both engines admit, and refuse, the same
    statements. On one card every segment's working set coexists: the
    card's chip phase reads the peak against this estimate times nseg."""
    from cloudberry_tpu.exec.resource import \
        estimate_plan_memory as jestimate
    from cloudberry_tpu.plan.planner import plan_statement as jplan
    from cloudberry_tpu.sql.parser import parse_sql as jparse
    from cloudberry_tpu_torch.exec.resource import \
        estimate_plan_memory as testimate
    from cloudberry_tpu_torch.plan.planner import plan_statement as tplan
    from cloudberry_tpu_torch.sql.parser import parse_sql as tparse

    js, ts = tpch_layouts[(8, True)]
    sql = tpch.QUERIES[qname]
    want = jestimate(jplan(jparse(sql), js, {}, explain_only=True).plan)
    got = testimate(tplan(tparse(sql), ts, {}, explain_only=True).plan)
    assert got.peak_bytes == want.peak_bytes


def test_a_sketch_from_another_statement_overflows_an_aggregate():
    """A reference fault the port reproduces (ROADMAP Queue C 37):
    feedback sketches are keyed by (table, key set) alone, so a filtered
    shuffle on ``t.s`` (a few rows) seeds the next statement's shuffle on
    the same key set at the smallest rung. The final aggregate's capacity
    follows that rung (64 rows at 8 segments); the redistribute then
    overflows and is promoted, but the aggregate is not regrown, and its
    "aggregation overflow" is an error no growth retries — in the JAX
    package as in the port (TPC-H Q15 after Q8 at SF 0.05 is the same
    case). The statement alone runs."""
    from cloudberry_tpu_torch.exec.executor import ExecError

    def fill(s):
        rng = np.random.default_rng(0)
        n = 40_000
        s.sql("create table t (k bigint, s bigint, v bigint) "
              "distributed by (k)")
        s.catalog.table("t").set_data(
            {"k": np.arange(n), "s": rng.permutation(n) // 2,
             "v": np.arange(n) % 1000}, {})

    js, ts = _pair(fill, 8, True)
    filtered = "select s, count(*) as c from t where v < 1 group by s"
    whole = "select s, count(*) as c from t group by s"
    fresh = TorchSession(ts.config, device="cpu")
    carry_tables(js, fresh)
    assert fresh.sql(whole).num_rows() == 20_000
    assert ts.explain(whole) == js.explain(whole)
    assert_same(ts.sql(filtered), js.sql(filtered))
    assert ts.explain(whole) == js.explain(whole)
    assert "feedback: rung 8" in ts.explain(whole)
    with pytest.raises(Exception, match="aggregation overflow") as jerr:
        js.sql(whole)
    assert type(jerr.value).__name__ == "ExecError"
    with pytest.raises(ExecError, match="aggregation overflow"):
        ts.sql(whole)
