"""The committed golden plan corpus (``tests/golden/*.plan``) through the
port: for every TPC-H and TPC-DS text behind a golden file, the port's
``Session.explain`` at that file's segment count (1 or 8) equals the
file, byte for byte, and the plan verifies clean (the sessions run with
``debug.verify_plans`` on, so a finding raises ``PlanVerifyError``).

The data comes from the port's own generators at the corpus's sizes
(``tools/golden_plans.py``: TPC-H SF 0.01 seed 7, tpcds-lite scale 0.5
seed 11). The golden files and the tool are read, never written.
"""

import os

import pytest

from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch import tpcds, tpch

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")
SF, SEED = 0.01, 7
DS_SCALE, DS_SEED = 0.5, 11
FILES = sorted(f for f in os.listdir(GOLDEN_DIR) if f.endswith(".plan"))
_SESSIONS: dict = {}


def _parse(fname: str):
    """(suite, query name, segments) of a golden file name."""
    stem = fname[:-len(".plan")]
    suite = "tpcds" if stem.startswith("ds_") else "tpch"
    stem = stem.removeprefix("ds_")
    qname, seg = stem.rsplit("_seg", 1)
    return suite, qname, int(seg)


def _session(suite: str, nseg: int) -> TorchSession:
    key = (suite, nseg)
    if key not in _SESSIONS:
        s = TorchSession(TorchConfig().with_overrides(
            n_segments=nseg, **{"debug.verify_plans": True}), device="cpu")
        if suite == "tpch":
            tpch.load_tpch(s, sf=SF, seed=SEED)
        else:
            tpcds.load_tpcds(s, scale=DS_SCALE, seed=DS_SEED)
        _SESSIONS[key] = s
    return _SESSIONS[key]


def test_the_corpus_is_the_reference_corpus():
    """One file per TPC-H and TPC-DS text at 1 and 8 segments, as the JAX
    package's golden tool names them."""
    from tools.golden_plans import snapshot_name
    from tools.tpcds_queries import DS_QUERIES
    from tools.tpch_queries import QUERIES

    want = {snapshot_name(q, n) for q in QUERIES for n in (1, 8)}
    want |= {snapshot_name(q, n, "tpcds") for q in DS_QUERIES
             for n in (1, 8)}
    assert set(FILES) == want and len(FILES) == 104
    assert all(tpch.QUERIES[q] == QUERIES[q] for q in QUERIES)
    assert all(tpcds.QUERIES[q] == DS_QUERIES[q] for q in DS_QUERIES)


@pytest.mark.parametrize("fname", FILES)
def test_port_explain_equals_the_golden_plan(fname):
    suite, qname, nseg = _parse(fname)
    queries = tpch.QUERIES if suite == "tpch" else tpcds.QUERIES
    with open(os.path.join(GOLDEN_DIR, fname)) as fh:
        expected = fh.read()
    got = _session(suite, nseg).explain(queries[qname]).rstrip() + "\n"
    assert got == expected, (
        f"{fname}:\n--- golden ---\n{expected}\n--- port ---\n{got}")
