"""Distributed tiled execution (exec/tiled_dist.py) through the port
against the JAX package, on the CPU at 8 segments: counterparts of the
JAX package's ``test_spill_dist.py`` (join-group, global agg, colocated
one-stage agg, merge overflow growing the accumulator, spill disabled,
top-N, top-N with offset, TPC-H Q5/Q9, the statement cache), the dist8
window and sort shapes of ``test_tilepipe.py`` / ``test_scan_pipeline.py``,
and the greedy re-plan of a refused plan.

For each case the port's tiling decisions (mode, tile rows, accumulator
capacity, tile count, the estimates and the report's key set) equal the
JAX package's, and the result equals the JAX package's tiled result and
the port's own one-shot 8-segment run. Tolerance is
``torch_parity.assert_same``'s: ints, DECIMALs and counts bit for bit,
float64 within rtol 1e-9 plus 1e-12 times the column's magnitude sum.
Kernel calls follow the gates: every segment launches its own, so each
kernel's count is a multiple of 8, and every tile of an eligible agg
merges through ``sorted_seg`` on every segment.
"""

import threading

import numpy as np
import pytest

from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch import tpch
from cloudberry_tpu_torch.exec import cuda_kernels as CK
from cloudberry_tpu_torch.exec.resource import ResourceError
from torch_parity import (PALLAS_OF, assert_same, assert_same_rows,
                          count_calls, dist_pair, same_dist_tiled_report)

NSEG = 8
# dim is distributed on a DIFFERENT key than the join key, so the probe
# side (fact) redistributes — the motion then runs inside every tile
JOIN_GROUP_Q = ("SELECT g, sum(v) AS sv, count(*) AS c "
                "FROM fact JOIN dim ON fact.d = dim.d "
                "GROUP BY g ORDER BY g")
NO_BCAST = {"planner.broadcast_threshold": 0}


def _load(n_fact=400_000, n_dim=500, seed=3):
    def load(session):
        rng = np.random.default_rng(seed)
        session.sql("CREATE TABLE dim (d BIGINT, g BIGINT) "
                    "DISTRIBUTED BY (g)")
        session.sql("CREATE TABLE fact (k BIGINT, d BIGINT, v BIGINT) "
                    "DISTRIBUTED BY (k)")
        session.catalog.table("dim").set_data(
            {"d": np.arange(n_dim), "g": np.arange(n_dim) % 9})
        session.catalog.table("fact").set_data(
            {"k": np.arange(n_fact) % 997,
             "d": rng.integers(0, n_dim, n_fact),
             "v": rng.integers(0, 100, n_fact)})
    return load


def _one_shot(js, **over) -> TorchSession:
    """A port session at 8 segments and the default budget over the JAX
    session's tables: the in-memory reference run."""
    from torch_parity import carry_tables

    ts = TorchSession(TorchConfig().with_overrides(
        n_segments=NSEG, **over), device="cpu")
    carry_tables(js, ts)
    return ts


def _tiled_case(sql, budget, load, monkeypatch, mode=None, min_tiles=2,
                **over):
    """Run ``sql`` tiled in both engines and one-shot in the port; hold
    the results and decisions equal. Returns (port report, kernel
    calls)."""
    js, ts = dist_pair(load, budget=budget, **over)
    calls = count_calls(monkeypatch, CK, {k: k for k in PALLAS_OF})
    got = ts.sql(sql)
    counted = dict(calls)
    want = js.sql(sql)
    assert_same(got, want)
    rep = same_dist_tiled_report(ts, js)
    assert rep["n_tiles"] >= min_tiles and rep["est_step_bytes"] <= budget
    if mode is not None:
        assert rep.get("mode") == mode
    assert_same(got, _one_shot(js, **over).sql(sql))
    assert all(n % NSEG == 0 for n in counted.values()), counted
    return rep, counted


def test_dist_tiled_join_group_matches_jax_and_one_shot(monkeypatch):
    rep, calls = _tiled_case(JOIN_GROUP_Q, 2 << 20, _load(), monkeypatch,
                             **NO_BCAST)
    assert rep["n_segments"] == NSEG and rep["stream_table"] == "fact"
    # every tile's partial merges through the sorted-segment kernel on
    # every segment (integer sums and counts: the kernel's gate)
    assert calls["sorted_seg"] >= NSEG * rep["n_tiles"], calls


def test_dist_tiled_statement_cache_reuses_runner(monkeypatch):
    """The first run's end-of-stream feedback fold is material, so the
    second run re-plans (a new feedback generation); the third is a
    statement-cache hit that skips planning and ``plan_tiled_dist`` — in
    both engines alike."""
    from cloudberry_tpu_torch.exec import tiled_dist as TD

    js, ts = dist_pair(_load(), budget=2 << 20, **NO_BCAST)
    planned = count_calls(monkeypatch, TD, {"plan": "plan_tiled_dist"})
    for _ in range(3):
        assert_same(ts.sql(JOIN_GROUP_Q), js.sql(JOIN_GROUP_Q))
        same_dist_tiled_report(ts, js)
    assert planned["plan"] == 2
    for name in ("stmt_cache_hits", "feedback_gen_bumps", "feedback_folds"):
        assert ts.stmt_log.counter(name) == js.stmt_log.counter(name), name
    assert ts.stmt_log.counter("stmt_cache_hits") == 1


def test_dist_tiled_global_agg(monkeypatch):
    q = ("SELECT sum(v) AS sv, min(v) AS mn, max(v) AS mx, "
         "count(*) AS c, avg(v) AS av FROM fact")
    rep, _ = _tiled_case(q, 256 << 10, _load(), monkeypatch, **NO_BCAST)
    assert rep["acc_capacity"] == 1


def test_dist_tiled_colocated_one_stage_agg(monkeypatch):
    """Grouping on the distribution key: a one-stage colocated
    aggregation whose accumulator IS the final per-segment state."""
    q = "SELECT k, sum(v) AS sv FROM fact GROUP BY k ORDER BY k LIMIT 20"
    _tiled_case(q, 1 << 20, _load(), monkeypatch, **NO_BCAST)


def test_dist_merge_overflow_grows_accumulator(monkeypatch):
    """An under-estimated group count grows the per-segment accumulator
    and restarts the stream (one tile per segment here, in both engines:
    the budget leaves room for the finalize's nseg x grown-accumulator
    rows)."""
    q = ("SELECT d % 7000 AS dd, count(*) AS c, sum(v) AS sv "
         "FROM fact GROUP BY d % 7000 ORDER BY dd LIMIT 50")
    rep, _ = _tiled_case(q, 10 << 20, _load(n_fact=800_000, n_dim=10_000),
                         monkeypatch, min_tiles=1, **NO_BCAST)
    assert rep["acc_capacity"] >= 7000


def test_dist_spill_disabled_refuses():
    from cloudberry_tpu.exec.resource import ResourceError as JResourceError

    js, ts = dist_pair(_load(), budget=4 << 20,
                       **{"resource.enable_spill": False, **NO_BCAST})
    for s, err in ((js, JResourceError), (ts, ResourceError)):
        with pytest.raises(err, match="memory estimate"):
            s.sql(JOIN_GROUP_Q)


TOPN_Q = ("SELECT fact.k AS k, fact.d AS d, v, g FROM fact JOIN dim "
          "ON fact.d = dim.d WHERE v < 90 "
          "ORDER BY v, fact.k, fact.d, g LIMIT 25")


def test_dist_tiled_topn(monkeypatch):
    rep, _ = _tiled_case(TOPN_Q, 12 << 20, _load(), monkeypatch,
                         mode="topn", **NO_BCAST)
    assert rep["acc_capacity"] == 25


def test_dist_tiled_topn_offset(monkeypatch):
    q = ("SELECT v, fact.k AS k FROM fact JOIN dim ON fact.d = dim.d "
         "ORDER BY v DESC, fact.k DESC, fact.d DESC LIMIT 10 OFFSET 5")
    rep, _ = _tiled_case(q, 6 << 20, _load(), monkeypatch, mode="topn",
                         **NO_BCAST)
    assert rep["acc_capacity"] == 15


@pytest.mark.parametrize("qn,budget", [("q5", 1 << 20), ("q9", 3 << 20)])
def test_tpch_q5_q9_tiled_at_8_segments(qn, budget, monkeypatch):
    """Admission-refused Q5/Q9 complete over 8 segments under a small
    per-segment budget, equal to the JAX package's tiled run and the
    port's one-shot run, through the gates' kernels."""
    from tools.tpchgen import load_tpch

    rep, calls = _tiled_case(
        tpch.QUERIES[qn], budget, lambda s: load_tpch(s, sf=0.02, seed=7),
        monkeypatch)
    assert any(calls.values()), calls


# the dist8 shapes of the JAX package's test_tilepipe.py /
# test_scan_pipeline.py: the window path needs finer groups over more
# rows, at the budget whose chunk capacity holds a partition
AGG_Q = ("SELECT g, sum(v) AS sv, count(*) AS c "
         "FROM fact JOIN dim ON fact.k = dim.k GROUP BY g ORDER BY g")
P_TOPN_Q = ("SELECT fact.k AS k, v, g FROM fact JOIN dim ON fact.k = "
            "dim.k WHERE v < 90 ORDER BY v, fact.k, g LIMIT 25")
SORT_Q = ("SELECT g, v FROM fact JOIN dim ON fact.k = dim.k "
          "WHERE v < 50 ORDER BY g, v DESC, fact.k")
WIN_Q = ("SELECT g, v, rank() over (partition by g order by v desc) AS r,"
         " sum(v) over (partition by g) AS sv "
         "FROM fact JOIN dim ON fact.k = dim.k")


def _load_pipe(n_fact, n_groups, n_dim=500):
    def load(s):
        rng = np.random.default_rng(3)
        s.sql("CREATE TABLE dim (k BIGINT, g BIGINT) DISTRIBUTED BY (k)")
        s.sql("CREATE TABLE fact (k BIGINT, v BIGINT) DISTRIBUTED BY (k)")
        s.catalog.table("dim").set_data(
            {"k": np.arange(n_dim), "g": np.arange(n_dim) % n_groups})
        s.catalog.table("fact").set_data(
            {"k": rng.integers(0, n_dim, n_fact),
             "v": rng.integers(0, 100, n_fact)})
    return load


@pytest.mark.parametrize("q,mode,budget,n_fact,n_groups", [
    (AGG_Q, None, 1 << 20, 120_000, 9),
    (P_TOPN_Q, "topn", 1 << 20, 120_000, 9),
    (SORT_Q, "sort", 1 << 20, 120_000, 9),
    (WIN_Q, "window", 4 << 20, 240_000, 300)],
    ids=["agg", "topn", "sort", "window"])
def test_dist8_modes_match_jax(q, mode, budget, n_fact, n_groups):
    """Each mode at 8 segments, windows 1 and 4: equal decisions, equal
    to the JAX package's tiled result and to the port's one-shot run (a
    window's rows compare in sorted order, as the JAX package's own
    test does)."""
    got = {}
    for w in (1, 4):
        js, ts = dist_pair(_load_pipe(n_fact, n_groups), budget=budget,
                           **{"tile_pipeline.inflight_tiles": w})
        got[w] = ts.sql(q)
        want = js.sql(q)
        rep = same_dist_tiled_report(ts, js)
        assert rep.get("mode") == mode and rep["n_tiles"] > 1
        assert rep["tile_window"] == w
        if mode == "window":
            assert_same_rows(got[w], want, float_cols=())
            assert_same_rows(got[w], _one_shot(js).sql(q))
        else:
            assert_same(got[w], want)
            assert_same(got[w], _one_shot(js).sql(q))
    if mode == "window":
        assert_same_rows(got[1], got[4])
    else:
        assert_same(got[1], got[4])


def test_greedy_replan_decision_matches_jax():
    """A refused plan that the memo's join order cannot tile is re-planned
    greedily (memo off) and tiled, in both engines alike: both refuse, or
    both tile the same stream with the same decisions. Q9's memo plan at
    8 segments, at budgets that refuse its one-shot run."""
    from cloudberry_tpu.exec.resource import ResourceError as JResourceError
    from tools.tpchgen import load_tpch

    for budget in (3 << 20, 1 << 20):
        js, ts = dist_pair(lambda s: load_tpch(s, sf=0.02, seed=7),
                           budget=budget,
                           **{"planner.enable_memo": True})
        outcome = []
        for s, err in ((js, JResourceError), (ts, ResourceError)):
            try:
                outcome.append(("ok", s.sql(tpch.QUERIES["q9"])))
            except err:
                outcome.append(("refused", None))
        assert outcome[0][0] == outcome[1][0]
        if outcome[0][0] == "ok":
            assert_same(outcome[1][1], outcome[0][1])
            same_dist_tiled_report(ts, js)


def test_greedy_replan_runs_when_the_memo_plan_declines(monkeypatch):
    """When plan_tiled declines the memo's plan, the session plans the
    statement again with the memo off and tiles that, in both engines;
    the greedy plan's result equals the one-shot run."""
    import cloudberry_tpu.exec.tiled as JT
    from cloudberry_tpu_torch.exec import tiled as TT

    js, ts = dist_pair(_load(), budget=2 << 20,
                       **{"planner.enable_memo": True, **NO_BCAST})
    for mod, s in ((JT, js), (TT, ts)):
        real = mod.plan_tiled
        seen = []

        def first_declines(plan, session, real=real, seen=seen):
            seen.append(session.config.planner.enable_memo)
            return None if len(seen) == 1 else real(plan, session)

        monkeypatch.setattr(mod, "plan_tiled", first_declines)
        s.sql(JOIN_GROUP_Q)
        assert seen == [True, False], seen
    assert_same(ts.sql(JOIN_GROUP_Q), js.sql(JOIN_GROUP_Q))
    same_dist_tiled_report(ts, js)


def test_port_threads_never_carry_the_reference_prefix(tmp_path):
    """The port's scan reader, decode pool and watchdog threads are named
    ``cbtpu_torch-``: a thread the port starts never carries the JAX
    package's ``cbtpu-`` prefix, whose tests assert no such thread is
    alive."""
    from cloudberry_tpu_torch import lifecycle
    from cloudberry_tpu_torch.exec import scanpipe as SP

    before = {t.ident for t in threading.enumerate()}
    cfg = TorchConfig().with_overrides(**{
        "storage.root": str(tmp_path / "port"),
        "storage.rows_per_partition": 20_000,
        "scan_pipeline.decode_workers": 2})
    ts = TorchSession(cfg, device="cpu")
    _load_pipe(120_000, 9)(ts)
    cold = TorchSession(cfg.with_overrides(
        **{"resource.query_mem_bytes": 1 << 20}), device="cpu")
    cold.sql(AGG_Q)
    assert cold.last_tiled_report["pipeline"]["parts_read"] > 1
    dog = lifecycle.Watchdog(cold.stmt_log, interval_s=0.01).start()
    try:
        started = [t for t in threading.enumerate()
                   if t.ident not in before]
        assert started, "the port started no thread"
        assert all(t.name.startswith("cbtpu_torch-") for t in started), \
            [t.name for t in started]
        assert not any(t.name.startswith("cbtpu-") for t in started)
    finally:
        dog.stop()
    # a grown pool retires the one it replaced once nobody holds it
    pool = SP.decode_pool(cfg)
    SP.release_decode_pool(pool)
    bigger = SP.decode_pool(cfg.with_overrides(
        **{"scan_pipeline.decode_workers": SP._pool_workers + 1}))
    SP.release_decode_pool(bigger)
    assert pool is not bigger and pool._shutdown
