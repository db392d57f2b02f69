"""EXPLAIN ANALYZE through the port's statement pipeline against the JAX
package, on the CPU.

Text parity: the port's ``Session.explain_analyze`` text equals the JAX
package's once the timings are stripped (the ``Execution time:`` line and
every ``<number> ms`` of a tiled trailer): the same plan nodes, in the same
order, with the same per-node row counts. Held against the JAX package's
default path (its Pallas dense path raises on q4 and q21: ROADMAP Queue C
5; the kernels do not change a count): the 22 TPC-H texts at SF 0.01 and
seven TPC-DS texts at tpcds-lite scale 0.5 (the window queries q12, q36
and q98 among them), spread over this file,
``test_torch_explain_analyze_mid.py`` and
``test_torch_explain_analyze_tail.py`` (``torch_parity.EA_TEXTS``), and
one tiled statement with its trailer lines.

With generic plans on in both engines, EXPLAIN ANALYZE runs the generic
form of Q1 and Q3 (literals as ``$params`` slots) with equal bindings and
equal text.

Pipeline contracts of the port: EXPLAIN ANALYZE reaches the same kernels as
``sql`` of the same statement, the same number of times (the wrappers'
calls counted on the CPU); its per-node counts cross to the host in ONE
copy (the only host read it adds to the ``sql`` path's); and the window
lowering stays free of host reads under instrumentation too.
"""

import numpy as np
import pytest
import torch

from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch import tpcds
from cloudberry_tpu_torch import tpch
from cloudberry_tpu_torch.exec import executor as TX
from tools.tpcdsgen import load_tpcds
from tools.tpchgen import load_tpch
from torch_parity import (EA_TEXTS, EA_WINDOWED, budget_pair,
                          explain_analyze_session, held_explain_analyze,
                          strip_timings)

HEAD, DS_HEAD = EA_TEXTS["test_torch_explain_analyze"]


@pytest.fixture(scope="module")
def tpch_sessions():
    return explain_analyze_session(lambda s: load_tpch(s, sf=0.01, seed=7))


@pytest.fixture(scope="module")
def ds_sessions():
    return explain_analyze_session(
        lambda s: load_tpcds(s, scale=0.5, seed=11))


def test_texts_cover_every_tpch_query_once():
    tpch_texts = [q for h, _ in EA_TEXTS.values() for q in h]
    ds_texts = [q for _, d in EA_TEXTS.values() for q in d]
    assert sorted(tpch_texts) == sorted(tpch.QUERIES)
    assert len(set(ds_texts)) == len(ds_texts) >= 6
    assert set(EA_WINDOWED) <= set(ds_texts)


@pytest.mark.parametrize("qname", HEAD)
def test_tpch_explain_analyze_matches_jax(tpch_sessions, qname,
                                          monkeypatch):
    js, ts = tpch_sessions
    text = held_explain_analyze(js, ts, tpch.QUERIES[qname], monkeypatch)
    assert "rows=" in text


@pytest.mark.parametrize("qname", DS_HEAD)
def test_tpcds_explain_analyze_matches_jax(ds_sessions, qname,
                                           monkeypatch):
    js, ts = ds_sessions
    text = held_explain_analyze(js, ts, tpcds.QUERIES[qname], monkeypatch)
    assert ("Window" in text) == (qname in EA_WINDOWED)


@pytest.fixture(scope="module")
def generic_sessions():
    """The JAX package with generic plans on (its default; Pallas off, as
    in ``explain_analyze_session``) and a port session with generic plans
    on (the port's default is off) over the same TPC-H tables."""
    import cloudberry_tpu as cb

    from torch_parity import carry_tables

    js = cb.Session(cb.get_config().with_overrides(
        **{"exec.use_pallas": False}))
    load_tpch(js, sf=0.01, seed=7)
    ts = TorchSession(TorchConfig().with_overrides(
        **{"sched.generic_plans": True}), device="cpu")
    carry_tables(js, ts)
    return js, ts


@pytest.mark.parametrize("qname", ["q1", "q3"])
def test_generic_form_matches_jax(generic_sessions, qname, monkeypatch):
    """EXPLAIN ANALYZE runs a statement's generic-plan form (literals as
    ``$params`` slots, scan row counts as ``$nrw`` slots) with its
    bindings fed as the ``$params`` input, in both engines: the bindings
    are equal, and the text (timings stripped) equals the JAX package's,
    with the ``sql`` path's kernels and root rows."""
    from cloudberry_tpu.exec import instrument as JI
    from cloudberry_tpu_torch.exec import instrument as TI

    js, ts = generic_sessions
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        for key, mod in (("port", TI), ("jax", JI)):
            def spy(session, plan, real=mod._generic_form, key=key):
                seen[key] = real(session, plan)
                return seen[key]
            mp.setattr(mod, "_generic_form", spy)
        held_explain_analyze(js, ts, tpch.QUERIES[qname], monkeypatch)
    assert seen["port"] and list(seen["port"]) == list(seen["jax"])
    for k, v in seen["jax"].items():
        assert seen["port"][k].dtype == v.dtype and seen["port"][k] == v


def _load_big(s):
    s.sql("create table big (k bigint, v double)")
    n = 200_000
    s.catalog.table("big").set_data({
        "k": np.arange(n, dtype=np.int64) % 97,
        "v": np.arange(n, dtype=np.float64)}, {})


def test_tiled_trailer_matches_jax():
    """An over-budget statement takes the tiled path in both engines; its
    trailer (tile count, tile rows, stream, per-tile time line, scan
    pipeline line) matches with the timings stripped, and the per-tile
    times also land on the ``tile_seconds`` histogram."""
    js, ts = budget_pair(_load_big, 1 << 20)
    sql = "select k, sum(v) as sv from big group by k"
    got = ts.explain_analyze(sql)
    want = js.explain_analyze(sql)
    assert "Tiled execution" in got and "tile step: mean" in got, got
    assert strip_timings(got) == strip_timings(want)
    h = ts.stmt_log.registry.hist("tile_seconds")
    assert h is not None
    assert h["count"] == ts.last_tiled_report["tile_time"]["count"] >= 1


def test_node_counts_cross_in_one_copy(tpch_sessions, monkeypatch):
    """Per-node counts stay device tensors while the plan runs and cross
    to the host in one stacked copy: EXPLAIN ANALYZE makes exactly one
    ``Tensor.cpu`` call more than ``sql`` of the same statement, and no
    ``item``/``tolist`` call more."""
    _, ts = tpch_sessions
    sql = tpch.QUERIES["q5"]
    counts = {}
    mode = ["sql"]

    def counting(attr):
        real = getattr(torch.Tensor, attr)

        def f(*a, **kw):
            key = (mode[0], attr)
            counts[key] = counts.get(key, 0) + 1
            return real(*a, **kw)
        monkeypatch.setattr(torch.Tensor, attr, f)

    for attr in ("cpu", "item", "tolist"):
        counting(attr)
    ts.sql(sql)
    mode[0] = "ea"
    ts.explain_analyze(sql)
    for attr, extra in (("cpu", 1), ("item", 0), ("tolist", 0)):
        assert counts.get(("ea", attr), 0) == \
            counts.get(("sql", attr), 0) + extra, (attr, counts)


def test_window_lowering_reads_nothing_under_instrumentation(monkeypatch):
    """The window lowering's no-host-read guard (test_torch_window.py)
    holds inside the instrumented Lowerer too."""
    ts = TorchSession(device="cpu")
    ts.sql("create table w (g text, o int, v int)")
    ts.sql("insert into w values ('a', 1, 10), ('a', 2, null), "
           "('a', 3, 30), ('b', 1, 100), ('b', 2, 200), ('c', 1, null)")
    active = [False]
    real_window = TX.Lowerer.window

    def guarded(self, node):
        active[0] = True
        try:
            return real_window(self, node)
        finally:
            active[0] = False

    def forbid(cls, attr):
        real = getattr(cls, attr)

        def f(*a, **kw):
            assert not active[0], f"window lowering called {attr}"
            return real(*a, **kw)
        monkeypatch.setattr(cls, attr, f)

    for attr in ("item", "tolist", "cpu", "numpy", "nonzero", "__bool__",
                 "__int__", "__index__", "__float__"):
        forbid(torch.Tensor, attr)
    forbid(torch, "nonzero")
    monkeypatch.setattr(TX.Lowerer, "window", guarded)
    text = ts.explain_analyze(
        "select g, o, sum(v) over (partition by g order by o rows between "
        "1 preceding and current row) as s, rank() over (partition by g "
        "order by o) as r, lag(v, 1, -1) over (partition by g order by o) "
        "as l from w where o < 3")
    assert "Window" in text and "rows=" in text
