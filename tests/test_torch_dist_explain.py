"""EXPLAIN ANALYZE at 8 segments through the port against the JAX
package, on the CPU (TPC-H SF 0.01): node counts (partitioned nodes
summed over the segments, replicated ones once) and the motion
annotations print the JAX package's text, timings stripped.
"""

import re

import pytest

import cloudberry_tpu as cb
from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch import tpch
from tools.tpchgen import load_tpch
from torch_parity import carry_tables, held_explain_analyze, strip_timings

NSEG = 8


@pytest.fixture(scope="module")
def tpch8():
    over = {"n_segments": NSEG, "sched.generic_plans": False}
    js = cb.Session(cb.get_config().with_overrides(**over))
    load_tpch(js, sf=0.01, seed=7)
    ts = TorchSession(TorchConfig().with_overrides(**over), device="cpu")
    carry_tables(js, ts)
    return js, ts


@pytest.mark.parametrize("qname", ["q3", "q5", "q9"])
def test_explain_analyze_at_8_segments_matches_jax(tpch8, qname,
                                                   monkeypatch):
    """Node counts (partitioned nodes summed over the segments,
    replicated ones once) and the motion annotations print the JAX
    package's text, timings stripped; the instrumented run launches the
    kernels the statement does. Feedback folds after every run change
    the next plan (rung seeds), so the JAX statement runs once first: both
    engines then EXPLAIN ANALYZE their second plan."""
    js, ts = tpch8
    js.sql(tpch.QUERIES[qname])
    text = held_explain_analyze(js, ts, tpch.QUERIES[qname], monkeypatch)
    assert "Motion" in text


def test_motion_stats_feed_skew_telemetry(tpch8):
    """Each redistribute pins its per-destination demand and skew ratio
    (EXPLAIN ANALYZE's motion annotation reads them)."""
    js, ts = tpch8
    text = ts.explain_analyze(tpch.QUERIES["q13"])
    assert strip_timings(text) == strip_timings(
        js.explain_analyze(tpch.QUERIES["q13"]))
    assert re.search(r"skew=\d+\.\d\d", text)
