"""Distributed results through the port against the JAX package, on the
CPU: TPC-H at SF 0.01 over 8 segments (the JAX package on its 8 virtual
CPU devices, the port's gang of 8 segment lowerers on one CPU device),
and a null-aware NOT IN whose NULL lives on another segment. Tolerance is
``torch_parity.assert_same``'s: ints, DECIMALs, counts and strings bit for
bit, float64 within rtol 1e-9 (partial sums reorder across segments in
the JAX package too).

Each segment launches its own kernels: every kernel the port reaches is
called a multiple of 8 times (one launch per segment; batching segments
into one launch is later work, ROADMAP Queue C).
"""

import numpy as np
import pytest

import cloudberry_tpu as cb
from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch import tpch
from cloudberry_tpu_torch.exec import cuda_kernels as CK
from tools.tpchgen import load_tpch
from torch_parity import PALLAS_OF, assert_same, carry_tables, count_calls

QNAMES = ("q1", "q3", "q5", "q9", "q10", "q13", "q16", "q18")
NSEG = 8


def _pair(**over):
    over = {"n_segments": NSEG, **over}
    js = cb.Session(cb.get_config().with_overrides(
        **{"sched.generic_plans": False, **over}))
    load_tpch(js, sf=0.01, seed=7)
    ts = TorchSession(TorchConfig().with_overrides(**over), device="cpu")
    carry_tables(js, ts)
    return js, ts


@pytest.fixture(scope="module")
def sessions():
    return _pair()


@pytest.mark.parametrize("qname", QNAMES)
def test_tpch_at_8_segments_matches_jax(sessions, qname, monkeypatch):
    """q13 is a left join, q16 a null-aware NOT IN (its build-side NULL
    test is global across segments), q18 selects no row at SF 0.01."""
    js, ts = sessions
    sql = tpch.QUERIES[qname]
    calls = count_calls(monkeypatch, CK, {k: k for k in PALLAS_OF})
    got = ts.sql(sql)
    assert_same(got, js.sql(sql), allow_empty=qname == "q18")
    assert any(calls.values()), "the query reached no kernel"
    assert all(n % NSEG == 0 for n in calls.values()), calls


def test_null_aware_not_in_sees_a_null_on_another_segment():
    """x NOT IN (subquery) is never true once ANY subquery key is NULL —
    also when the NULL row lives on another segment than the probe row."""
    over = {"n_segments": NSEG}
    js = cb.Session(cb.get_config().with_overrides(**over))
    ts = TorchSession(TorchConfig().with_overrides(**over), device="cpu")
    for s in (js, ts):
        s.sql("create table p (a bigint, b bigint) distributed by (a)")
        s.sql("create table q (c bigint, d bigint) distributed by (c)")
        s.sql("insert into p values " +
              ",".join(f"({i}, {i % 11})" for i in range(200)))
        s.sql("insert into q values " +
              ",".join(f"({i}, {i % 5})" for i in range(40)))
    sql = "select count(*) as n from p where b not in (select d from q)"
    want = js.sql(sql)
    assert_same(ts.sql(sql), want)
    assert int(np.asarray(want.columns["n"])[0]) > 0
    for s in (js, ts):
        s.sql("insert into q values (4711, null)")
    want = js.sql(sql)
    assert_same(ts.sql(sql), want)
    assert int(np.asarray(want.columns["n"])[0]) == 0
