"""The mid-statement adaptive replan through the port against the JAX
package, on the CPU at 8 segments: counterparts of the JAX package's
``test_feedback.py`` acceptance tests of the replan, and the skew
sentinel's decisions on fixed per-tile count vectors.

A tiled distributed read whose cumulative redistribute skew crosses the
alarm folds a partial feedback sketch, checkpoints its accumulators,
raises ``TileReplan``; the session re-plans (the replanned plan is
verified, ``debug.verify_plans`` on) and the new executable resumes from
the checkpoint. The counters — ``tile_replans``, ``adaptive_replans``,
``tile_checkpoints``, ``tile_resumes``, ``feedback_folds``,
``tile_stat_syncs`` — equal the JAX package's on the same statement, and
the result equals the JAX package's and the port's one-shot run.
"""

import types

import numpy as np
import pytest

from cloudberry_tpu.utils import faultinject as JFI
from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch.utils import faultinject as FI
from torch_parity import (assert_same, carry_tables, dist_pair,
                          same_dist_tiled_report)

JOIN_GROUP_Q = ("SELECT g, sum(v) AS sv, count(*) AS c "
                "FROM fact JOIN dim ON fact.d = dim.d "
                "GROUP BY g ORDER BY g")
COUNTERS = ("tile_replans", "adaptive_replans", "tile_checkpoints",
            "tile_resumes", "feedback_folds", "tile_stat_syncs",
            "tiles_replayed")


@pytest.fixture(autouse=True)
def _clean_faults():
    for m in (FI, JFI):
        m.reset_fault()
    yield
    for m in (FI, JFI):
        m.reset_fault()


def _load_hot(session, n_fact=400_000, n_dim=500, seed=3, hot_key=7,
              hot_frac=0.85):
    """fact JOIN dim on d, dim distributed on g != d so the probe side
    redistributes; 85 % of the fact rows carry one join key."""
    rng = np.random.default_rng(seed)
    session.sql("CREATE TABLE dim (d BIGINT, g BIGINT) DISTRIBUTED BY (g)")
    session.sql("CREATE TABLE fact (k BIGINT, d BIGINT, v BIGINT) "
                "DISTRIBUTED BY (k)")
    session.catalog.table("dim").set_data(
        {"d": np.arange(n_dim), "g": np.arange(n_dim) % 9})
    d = rng.integers(0, n_dim, n_fact)
    d[rng.random(n_fact) < hot_frac] = hot_key
    session.catalog.table("fact").set_data(
        {"k": np.arange(n_fact) % 997, "d": d,
         "v": rng.integers(0, 100, n_fact)})


def _one_shot(js):
    ts = TorchSession(TorchConfig().with_overrides(
        n_segments=8, **{"planner.broadcast_threshold": 0}), device="cpu")
    carry_tables(js, ts)
    return ts.sql(JOIN_GROUP_Q)


def test_midstatement_adaptive_replan_matches_jax():
    js, ts = dist_pair(_load_hot, budget=2 << 20, **{
        "planner.broadcast_threshold": 0, "debug.verify_plans": True})
    got = ts.sql(JOIN_GROUP_Q)
    assert_same(got, js.sql(JOIN_GROUP_Q))
    assert_same(got, _one_shot(js))
    for name in COUNTERS:
        assert ts.stmt_log.counter(name) == js.stmt_log.counter(name), name
    c = ts.stmt_log.counter
    assert c("tile_replans") == c("adaptive_replans") == 1
    assert c("tile_checkpoints") >= 1 and c("tile_resumes") >= 1
    assert c("feedback_folds") >= 2        # the partial and the final
    rep = same_dist_tiled_report(ts, js)
    assert rep["n_tiles"] > 1 and rep["resumed_from_tile"] > 0
    # the statement's history carries the replan's annotation
    entry = ts.stmt_log.recent()[0]
    assert entry.get("replan_at_tile") == rep["resumed_from_tile"]
    assert entry.get("adaptive_skew", 0) > 3.0


def test_fault_skip_suppresses_adaptation():
    """A skipped ``tile_replan`` fault point disarms the sentinel for the
    statement: the static plan finishes, the result unchanged."""
    js, ts = dist_pair(_load_hot, budget=2 << 20,
                       **{"planner.broadcast_threshold": 0})
    FI.inject_fault("tile_replan", action="skip")
    JFI.inject_fault("tile_replan", action="skip")
    got = ts.sql(JOIN_GROUP_Q)
    assert_same(got, js.sql(JOIN_GROUP_Q))
    assert_same(got, _one_shot(js))
    for name in COUNTERS:
        assert ts.stmt_log.counter(name) == js.stmt_log.counter(name), name
    assert ts.stmt_log.counter("tile_replans") == 0
    assert ts.stmt_log.counter("adaptive_replans") == 0


# --------------------------------------------------- the sentinel alone


class _Ctx:
    """A recovery context whose snapshot always saves (or never)."""

    def __init__(self, ok=True):
        self.ok = ok
        self.saved = []

    def force_snapshot(self, tiles_local, payload_fn):
        self.saved.append(tiles_local)
        return self.ok


def _sentinel_run(pkg, vectors, **cfg):
    """Feed per-tile (bucket, rows) vectors to one engine's SkewSentinel
    under an adaptation-safe statement handle; returns what it decided
    and its state."""
    if pkg == "jax":
        import cloudberry_tpu as cb
        from cloudberry_tpu import lifecycle
        from cloudberry_tpu.exec import recovery as R
        from cloudberry_tpu.exec.tiled import SkewSentinel
        from cloudberry_tpu.plan import nodes as NN

        s = cb.Session(cb.get_config().with_overrides(
            n_segments=8, **cfg))
    else:
        from cloudberry_tpu_torch import lifecycle
        from cloudberry_tpu_torch.exec import recovery as R
        from cloudberry_tpu_torch.exec.tiled import SkewSentinel
        from cloudberry_tpu_torch.plan import nodes as NN

        s = TorchSession(TorchConfig().with_overrides(
            n_segments=8, **cfg), device="cpu")
    nmot = len(vectors[0])
    motions = [types.SimpleNamespace() for _ in range(nmot)]
    plan = NN.PFilter.__new__(NN.PFilter)   # the fold walks no node
    plan.children = lambda: []
    exe = types.SimpleNamespace(session=s, nseg=8,
                                shape=types.SimpleNamespace(
                                    partial_plan=plan))
    ctx = _Ctx()
    sent = SkewSentinel(exe, motions, ctx)
    handle = lifecycle.StatementHandle(1)
    handle.adaptive_ok = True
    out = {"raised": None}
    with lifecycle.statement_scope(handle):
        for t, per_motion in enumerate(vectors, start=1):
            sent.observe([(np.asarray(b), np.asarray(r, dtype=np.int64))
                          for b, r in per_motion])
            try:
                sent.maybe_replan(t, lambda: {"acc": 1})
            except R.TileReplan as e:
                out["raised"] = (e.tiles_done, round(e.ratio, 9))
                break
    out.update(armed=sent.armed, threshold=sent.threshold,
               cum=[c.tolist() for c in sent.cum], demand=sent.demand,
               saved=ctx.saved,
               replans=s.stmt_log.counter("tile_replans"),
               syncs=s.stmt_log.counter("tile_stat_syncs"),
               seg_rows=[getattr(m, "_seg_rows", np.zeros(0)).tolist()
                         for m in motions],
               observed=[getattr(m, "_observed_bucket", None)
                         for m in motions])
    return out


EVEN = [8, [10] * 8]
HOT = [40, [40, 2, 2, 2, 2, 2, 2, 2]]
MILD = [9, [9, 7, 7, 7, 7, 7, 7, 7]]


@pytest.mark.parametrize("vectors,cfg", [
    # a sustained hot destination alarms at min_tiles
    ([[HOT], [HOT], [HOT]], {}),
    # one hot tile among even ones is noise
    ([[HOT], [EVEN], [EVEN], [EVEN]], {}),
    # even traffic never alarms
    ([[EVEN]] * 4, {}),
    # the worst of two motions wins; a lower alarm catches mild skew
    ([[EVEN, MILD], [EVEN, MILD], [EVEN, HOT]],
     {"feedback.replan_skew_ratio": 1.2}),
    # min_tiles 3 waits a tile longer
    ([[HOT]] * 4, {"feedback.min_tiles": 3}),
    # adaptation off: telemetry is still collected, nothing raises
    ([[HOT]] * 3, {"feedback.adaptive": False}),
    # feedback off: nothing is collected at all
    ([[HOT]] * 3, {"feedback.enabled": False}),
    # no replan budget
    ([[HOT]] * 3, {"feedback.max_replans": 0}),
], ids=["hot", "one-hot-tile", "even", "two-motions", "min-tiles-3",
        "adaptive-off", "feedback-off", "no-budget"])
def test_skew_sentinel_decides_as_jax(vectors, cfg):
    want = _sentinel_run("jax", vectors, **cfg)
    got = _sentinel_run("port", vectors, **cfg)
    assert got == want
