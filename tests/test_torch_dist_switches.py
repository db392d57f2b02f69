"""The motion switches of the port at 8 segments, on the CPU: the packed
wire (one word buffer per motion) against the per-column exchange, bit
for bit on TPC-H SF 0.01; and the exact and digest runtime filters,
against the JAX package's (the same probe rows in and out) and against
the filter off (bit for bit).
"""

import numpy as np
import pytest

import cloudberry_tpu as cb
from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch import tpch
from tools.tpchgen import load_tpch
from torch_parity import assert_same, carry_tables

NSEG = 8


@pytest.fixture(scope="module")
def sessions():
    over = {"n_segments": NSEG}
    js = cb.Session(cb.get_config().with_overrides(
        **{"sched.generic_plans": False, **over}))
    load_tpch(js, sf=0.01, seed=7)
    ts = TorchSession(TorchConfig().with_overrides(**over), device="cpu")
    carry_tables(js, ts)
    return js, ts


def _bit_identical(got, want):
    assert_same(got, want, allow_empty=True)
    gsel, wsel = np.asarray(got.sel), np.asarray(want.sel)
    for f in want.schema.fields:
        g = np.asarray(got.columns[f.name])[gsel]
        w = np.asarray(want.columns[f.name])[wsel]
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                      err_msg=f.name)


@pytest.mark.parametrize("qname", ["q9", "q10", "q13"])
def test_packed_and_per_column_wire_are_bit_identical(sessions, qname):
    """The packed wire (one buffer per motion) and the per-column exchange
    give bit-identical results, floats included."""
    js, ts = sessions
    per_col = TorchSession(ts.config.with_overrides(
        **{"interconnect.packed_wire": False}), device="cpu")
    carry_tables(js, per_col)
    sql = tpch.QUERIES[qname]
    _bit_identical(per_col.sql(sql), ts.sql(sql))


_DIGEST = {
    "planner.broadcast_threshold": 0,
    "planner.runtime_filter_threshold": 0,
    "join_filter.bloom_bits": 4096,
}
_EXACT = {"planner.broadcast_threshold": 0}
FILTER_Q = ("select grp, count(*) as n from fact, dim where grp = d "
            "group by grp order by grp")


def _filter_pair(over):
    over = {"n_segments": NSEG, **over}
    js = cb.Session(cb.get_config().with_overrides(**over))
    ts = TorchSession(TorchConfig().with_overrides(**over), device="cpu")
    for s in (js, ts):
        s.sql("create table fact (k bigint, grp bigint, v bigint) "
              "distributed by (k)")
        s.sql("create table dim (d bigint, p bigint) distributed by (d)")
        s.sql("insert into fact values " + ",".join(
            f"({i}, {i % 3000}, {i % 7})" for i in range(3000)))
        s.sql("insert into dim values " + ",".join(
            f"({i}, {i * 2})" for i in range(300)))
    return js, ts


@pytest.mark.parametrize("mode", ["exact", "digest"])
def test_runtime_filter_matches_jax_and_the_filter_off(mode):
    """The exact filter (gathered packed build keys) and the digest
    (global min/max + bloom) drop the same probe rows as the JAX package's
    (equal ``jf_rows_in``/``jf_rows_out``) and leave the result equal to
    the filter off, bit for bit."""
    from cloudberry_tpu_torch.exec import executor as X
    from cloudberry_tpu_torch.plan import nodes as N

    over = _DIGEST if mode == "digest" else _EXACT
    js, ts = _filter_pair(over)
    plan_text = ts.explain(FILTER_Q)
    assert plan_text == js.explain(FILTER_Q)
    assert "RuntimeFilter" in plan_text
    assert ("RuntimeFilter digest(" in plan_text) == (mode == "digest")
    want = js.sql(FILTER_Q)
    got = ts.sql(FILTER_Q)
    assert_same(got, want)
    for c in ("jf_rows_in", "jf_rows_out"):
        assert ts.counters.counter(c) == js.stmt_log.counter(c), c
    assert 0 < ts.counters.counter("jf_rows_out") \
        < ts.counters.counter("jf_rows_in")
    off = TorchSession(ts.config.with_overrides(
        **{"join_filter.enabled": False,
           "planner.runtime_filter_threshold": 0}), device="cpu")
    carry_tables(js, off)
    from cloudberry_tpu_torch.plan.binder import Binder
    from cloudberry_tpu_torch.plan.planner import _optimize
    from cloudberry_tpu_torch.sql.parser import parse_sql

    plan = _optimize(Binder(off.catalog, off.config).bind_query(
        parse_sql(FILTER_Q)), off)
    assert not [n for n in X.all_nodes(plan)
                if isinstance(n, N.PRuntimeFilter)]
    _bit_identical(off.sql(FILTER_Q), got)
