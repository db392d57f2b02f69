"""The feedback loop through the port against the JAX package, on the
CPU, over 8 segments (TPC-H SF 0.01): after one run of a statement the
feedback store's sketches (per shuffled (table, key set): the observed
bucket demand, rows per destination, skew, runtime-filter survivor
fractions) equal the JAX package's, the store generation moved the same
way, and the statement's second plan, seeded from the sketches, equals
the JAX package's second plan.
"""

import dataclasses

import pytest

import cloudberry_tpu as cb
from cloudberry_tpu.plan import feedback as JFB
from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch import tpch
from cloudberry_tpu_torch.plan import feedback as TFB
from tools.tpchgen import load_tpch
from torch_parity import assert_same, carry_tables


def _sketches(store) -> dict:
    """A store's sketches without their validity tokens (table tokens are
    per-process object ids)."""
    return {k: dataclasses.asdict(v[1]) for k, v in store._sketches.items()}


@pytest.mark.parametrize("qname", ["q8", "q9", "q13", "q17"])
def test_feedback_sketches_and_the_second_plan_match_jax(qname):
    """One run folds the motion stats into the feedback store: the
    sketches equal the JAX package's, and the statement's second plan
    (seeded from them) equals its second plan."""
    over = {"n_segments": 8, "sched.generic_plans": False}
    js = cb.Session(cb.get_config().with_overrides(**over))
    load_tpch(js, sf=0.01, seed=7)
    ts = TorchSession(TorchConfig().with_overrides(**over), device="cpu")
    carry_tables(js, ts)
    sql = tpch.QUERIES[qname]
    first = js.explain(sql)
    assert ts.explain(sql) == first
    assert_same(ts.sql(sql), js.sql(sql), allow_empty=True)
    want = _sketches(JFB.store_for(js))
    assert want, "the run folded no sketch"
    assert _sketches(TFB.store_for(ts)) == want
    assert TFB.feedback_gen(ts) == JFB.feedback_gen(js)
    assert ts.explain(sql) == js.explain(sql)


def test_reset_forgets_the_sketches():
    """``FeedbackStore.reset`` empties the store and moves its
    generation on: the next plan is the plan of an empty store again,
    and the statement cache does not serve the seeded runner."""
    over = {"n_segments": 8, "sched.generic_plans": False}
    js = cb.Session(cb.get_config().with_overrides(**over))
    load_tpch(js, sf=0.01, seed=7)
    ts = TorchSession(TorchConfig().with_overrides(**over), device="cpu")
    carry_tables(js, ts)
    sql = tpch.QUERIES["q9"]
    first = ts.explain(sql)
    want = js.sql(sql)
    assert_same(ts.sql(sql), want)
    store = TFB.store_for(ts)
    gen = store.gen
    assert _sketches(store) and ts.explain(sql) != first
    store.reset()
    assert store.snapshot()["sketches"] == 0 and store.gen == gen + 1
    assert ts.explain(sql) == first
    assert_same(ts.sql(sql), want)
    assert _sketches(store)
