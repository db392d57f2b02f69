"""Join-expansion growth in the port: a many-to-many join whose true pair
count exceeds the planner's NDV estimate trips the overflow check, the
join's pair buffer grows and the statement runs again — never a truncated
result. Held against numpy and the JAX session on the same data."""

import numpy as np
import pytest

import cloudberry_tpu as cb
from cloudberry_tpu.config import Config
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch.exec import executor as TX
from cloudberry_tpu_torch.exec.executor import ExecError
from cloudberry_tpu_torch.plan import nodes as N
from torch_parity import carry_tables

Q = ("select count(*) as n, sum(x + y) as s from probe, build "
     "where probe.k = build.k")


@pytest.fixture(scope="module")
def skew():
    """40,000 probe rows, 30 % of them on key 0, which the build side
    holds 12 times (tests/test_paramplan.py's skew join)."""
    rng = np.random.default_rng(13)
    n = 40_000
    pk = np.where(rng.random(n) < 0.3, 0,
                  rng.integers(1, 30_000, n)).astype(np.int64)
    bk = np.concatenate([np.zeros(12, dtype=np.int64),
                         np.arange(1, 2000, dtype=np.int64)])
    js = cb.Session(Config())
    js.sql("create table probe (k bigint, x bigint) distributed by (k)")
    js.sql("create table build (k bigint, y bigint) distributed by (k)")
    js.catalog.table("probe").set_data(
        {"k": pk, "x": np.arange(n, dtype=np.int64)}, {})
    js.catalog.table("build").set_data(
        {"k": bk, "y": np.arange(len(bk), dtype=np.int64) * 3}, {})
    return js, pk, bk


def _numpy_answer(pk, bk):
    x = np.arange(len(pk), dtype=np.int64)
    y = np.arange(len(bk), dtype=np.int64) * 3
    order = np.argsort(bk, kind="stable")
    lo = np.searchsorted(bk[order], pk, side="left")
    hi = np.searchsorted(bk[order], pk, side="right")
    pairs = hi - lo
    s = int((x * pairs).sum())
    cy = np.concatenate([[0], np.cumsum(y[order])])
    s += int((cy[hi] - cy[lo]).sum())
    return int(pairs.sum()), s


def test_skew_join_grows_and_matches_numpy_and_jax(skew):
    js, pk, bk = skew
    ts = TorchSession(device="cpu")
    carry_tables(js, ts)
    got = ts.sql(Q)
    assert ts.growth_events > 0   # the overflow actually tripped
    n, s = _numpy_answer(pk, bk)
    assert got.columns["n"][got.sel].tolist() == [n]
    assert got.columns["s"][got.sel].tolist() == [s]
    want = js.sql(Q)
    assert js.growth_events > 0
    assert want.columns["n"][want.sel].tolist() == [n]
    assert want.columns["s"][want.sel].tolist() == [s]
    # the grown plan is kept, as in the JAX package: a second statement
    # is a statement-cache hit and grows no more
    events, jevents = ts.growth_events, js.growth_events
    hits = ts.counters.counter("stmt_cache_hits")
    got = ts.sql(Q)
    assert got.columns["n"][got.sel].tolist() == [n]
    assert ts.growth_events == events
    assert ts.counters.counter("stmt_cache_hits") == hits + 1
    want = js.sql(Q)
    assert want.columns["n"][want.sel].tolist() == [n]
    assert js.growth_events == jevents


def test_overflow_surfaces_after_the_last_growth(skew, monkeypatch):
    """Growth that cannot catch up (here: growth disabled by a factor of
    1 on a buffer already at the floor) ends in the overflow error after
    six retries, never in a truncated result."""
    js, _, _ = skew
    ts = TorchSession(device="cpu")
    carry_tables(js, ts)
    real = TX.grow_expansion

    def stuck(plan, message, factor=4, allow_fallback=False):
        node = TX.find_expansion_node(plan, message)
        node.out_capacity = 64
        return real(plan, message, factor=1, allow_fallback=allow_fallback)

    monkeypatch.setattr(TX, "grow_expansion", stuck)
    with pytest.raises(ExecError, match="expansion overflow"):
        ts.sql(Q)
    assert ts.growth_events == 6


def _join_plan():
    scan = N.PScan("t", {"k": "k"}, capacity=10)
    join = N.PJoin("inner", scan, scan, [], [], unique_build=False,
                   out_capacity=100)
    return N.PLimit(join, 5), join


def test_grow_expansion_grows_the_named_join():
    plan, join = _join_plan()
    msg = (f"join expansion overflow: match pairs exceed capacity 100 "
           f"(node {id(join)})")
    assert TX.find_expansion_node(plan, msg) is join
    assert TX.grow_expansion(plan, msg)
    assert join.out_capacity == 400
    small = N.PJoin("inner", join.build, join.probe, [], [],
                    unique_build=False, out_capacity=3)
    assert TX.grow_expansion(
        small, f"semi-join expansion overflow (node {id(small)})")
    assert small.out_capacity == 64   # the floor of a grown buffer
    assert TX._dedupe_nodes([join, plan, join]) == [join, plan]


@pytest.mark.parametrize("msg", [
    "aggregation overflow: more groups than capacity 10 (node {nid})",
    "redistribute overflow: bucket exceeds capacity (node {nid})",
    "host bucket overflow (node {nid})",
    "join expansion overflow: match pairs exceed capacity 100 (node 12)",
    "join build side has duplicate keys (node {nid})",
])
def test_grow_expansion_refuses_a_message_naming_no_join(msg):
    """A message that names no join of the plan (another check, a motion
    of a multi-segment plan, an unknown node id) grows nothing; with the
    retry loop's fallback, an expansion message with an unknown id grows
    every expansion join instead."""
    plan, join = _join_plan()
    text = msg.format(nid=id(join))
    assert not TX.grow_expansion(plan, text)
    assert join.out_capacity == 100
    assert TX.grow_expansion(plan, text, allow_fallback=True) == \
        ("expansion overflow" in text)
