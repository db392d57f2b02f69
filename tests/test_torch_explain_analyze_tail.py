"""EXPLAIN ANALYZE through the port's statement pipeline against the JAX
package, on the CPU: the last share of the TPC-H (SF 0.01) and TPC-DS
(tpcds-lite scale 0.5) texts that ``torch_parity.EA_TEXTS`` gives this
file (``test_torch_explain_analyze.py`` holds the pipeline's contracts).
Each text equals the JAX package's default path's with the timings
stripped, and the port's EXPLAIN ANALYZE reaches the same kernels as its
``sql`` of the statement, the same number of times, with a root ``rows=``
equal to the result's rows (``torch_parity.held_explain_analyze``).
"""

import pytest

from cloudberry_tpu_torch import tpcds
from cloudberry_tpu_torch import tpch
from tools.tpcdsgen import load_tpcds
from tools.tpchgen import load_tpch
from torch_parity import (EA_TEXTS, EA_WINDOWED, explain_analyze_session,
                          held_explain_analyze)

TPCH_TEXTS, DS_TEXTS = EA_TEXTS["test_torch_explain_analyze_tail"]


@pytest.fixture(scope="module")
def tpch_sessions():
    return explain_analyze_session(lambda s: load_tpch(s, sf=0.01, seed=7))


@pytest.fixture(scope="module")
def ds_sessions():
    return explain_analyze_session(
        lambda s: load_tpcds(s, scale=0.5, seed=11))


@pytest.mark.parametrize("qname", TPCH_TEXTS)
def test_tpch_explain_analyze_matches_jax(tpch_sessions, qname,
                                          monkeypatch):
    js, ts = tpch_sessions
    text = held_explain_analyze(js, ts, tpch.QUERIES[qname], monkeypatch)
    assert "rows=" in text


@pytest.mark.parametrize("qname", DS_TEXTS)
def test_tpcds_explain_analyze_matches_jax(ds_sessions, qname,
                                           monkeypatch):
    js, ts = ds_sessions
    text = held_explain_analyze(js, ts, tpcds.QUERIES[qname], monkeypatch)
    assert ("Window" in text) == (qname in EA_WINDOWED)
