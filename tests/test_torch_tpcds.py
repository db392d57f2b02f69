"""TPC-DS through the port against the JAX package, end to end on the CPU.

tpcds-lite at scale 0.5, seed 11, generated by the JAX package's
tools/tpcdsgen.py into a ``cb.Session`` (Pallas kernels on, in interpret
mode; no generic plans) and carried into the port's ``Session(device="cpu")``
with ``catalog/carry.py``. Each of the 30 queries must give equal results
(``torch_parity.assert_same``) and reach the same kernels in both engines
(the port's wrappers run their plain versions on the CPU).
"""

import numpy as np
import pytest

import cloudberry_tpu as cb
from cloudberry_tpu.exec import pallas_kernels as PK
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch import tpcds
from cloudberry_tpu_torch.exec import cuda_kernels as CK
from tools.tpcds_queries import DS_QUERIES
from tools.tpcdsgen import generate, load_tpcds
from torch_parity import PALLAS_OF, assert_same, carry_tables, count_calls

# a GROUP BY with COUNT only over dictionary keys: the reference's Pallas
# dense path raises there (ROADMAP Queue C 5), so the query is held
# against the reference's default path
COUNT_ONLY_DENSE = {"q6"}
WINDOWED = {"q12", "q20", "q36", "q86", "q98"}


@pytest.fixture(scope="module")
def sessions():
    js = cb.Session(cb.get_config().with_overrides(
        **{"exec.use_pallas": True, "sched.generic_plans": False}))
    load_tpcds(js, scale=0.5, seed=11)
    ts = TorchSession(device="cpu")
    carry_tables(js, ts)
    return js, ts


def test_copies_match_the_tools():
    """The port's tpcds.py is a copy: the same 30 texts and, for a seed,
    the same generated arrays as tools/."""
    assert tpcds.QUERIES == DS_QUERIES and len(tpcds.QUERIES) == 30
    want, got = generate(0.5, 11), tpcds.generate(0.5, 11)
    assert list(got) == list(want)
    for t in want:
        assert list(got[t]) == list(want[t])
        for c in want[t]:
            np.testing.assert_array_equal(got[t][c], want[t][c])


@pytest.mark.parametrize("qname", sorted(tpcds.QUERIES,
                                         key=lambda q: int(q[1:])))
def test_tpcds_matches_jax(sessions, qname, monkeypatch):
    js, ts = sessions
    sql = tpcds.QUERIES[qname]
    jcalls = count_calls(monkeypatch, PK, PALLAS_OF)
    tcalls = count_calls(monkeypatch, CK, {k: k for k in PALLAS_OF})
    got = ts.sql(sql)
    assert any(tcalls.values()), "the query reached no kernel"
    if qname in COUNT_ONLY_DENSE:
        with pytest.raises(ValueError):
            js.sql(sql)
        assert tcalls["dense_agg"] > 0
        ref = cb.Session(js.config.with_overrides(
            **{"exec.use_pallas": False}))
        ref.catalog = js.catalog
        want = ref.sql(sql)
    else:
        want = js.sql(sql)
        assert tcalls == jcalls, (tcalls, jcalls)
    plan = ts.explain(sql)
    assert ("Window [" in plan) == (qname in WINDOWED)
    assert_same(got, want)


def test_explain_matches_jax(sessions):
    """Session.explain at one segment: the port's plan text is the
    reference's, window node included."""
    js, ts = sessions
    text = ts.explain(tpcds.QUERIES["q98"])
    assert text == js.explain(tpcds.QUERIES["q98"])
    assert "Window [sum]" in text
