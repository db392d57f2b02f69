"""Recovery's distributed half (exec/recovery.py) through the port against
the JAX package, on the CPU at 8 segments.

A late accumulator overflow replays from a drained-clean checkpoint
(``recovery.checkpoint_every=2``) instead of re-streaming the table: the
resumed run reads the remaining rows through ``_ResumedDistFeed`` (the
consumed-row mask over the placement hash's shard layout), and its
checkpoint counters and result equal the JAX package's and the
synchronous run's. The restore math — ``fresh_consumed_mask``,
``_pad_acc``, ``_round_robin_acc``, ``_pooled_rows`` and ``_host_topn`` —
equals the JAX package's functions on seeded inputs, at the snapshot's
segment count and at another one.

The device-loss half (tests/test_recovery.py's counterparts): a kill at
tile 0, mid and last (the ``tile_device_lost`` seam) of a tiled
statement at 1 and 8 segments rides the session's retry into a resume
from the last checkpoint (``recovery.checkpoint_every=2``: at most K = 2
tiles replayed once a checkpoint exists); with ``probe_degraded`` armed
the statement resumes on 7 segments, the remaining rows re-sharded by the
placement hash, in agg, top-N and sort mode; a colocated one-stage
aggregate declines the changed-nseg resume and completes with a fresh
run. Results, reports and recovery counters equal the JAX package's and
the uninterrupted run's.
"""

import numpy as np
import pytest

from cloudberry_tpu.exec import recovery as JR
from cloudberry_tpu_torch.exec import recovery as R
from cloudberry_tpu_torch.plan import expr as ex
from cloudberry_tpu_torch.types import INT64, FLOAT64
from torch_parity import (arm_both, assert_same, chaos_teardown, dist_pair,
                          reset_both, same_counters, same_dist_tiled_report,
                          same_tiled_report)

NSEG = 8


def _late_overflow(session):
    """The first 3.2M rows hold 2,000 keys, the last 1.2M rows 30,000:
    every segment's accumulator overflows in its fourth tile, behind two
    checkpoints."""
    rng = np.random.default_rng(4)
    session.sql("CREATE TABLE fact (k BIGINT, v BIGINT) DISTRIBUTED BY (k)")
    k = np.concatenate([rng.integers(0, 2_000, 3_200_000),
                        rng.integers(0, 30_000, 1_200_000)])
    session.catalog.table("fact").set_data(
        {"k": k, "v": rng.integers(0, 100, len(k))})


LATE_Q = ("SELECT k % 20000 AS kk, count(*) AS c, sum(v) AS sv "
          "FROM fact GROUP BY k % 20000 ORDER BY kk LIMIT 50")


def test_late_overflow_resumes_from_a_checkpoint_at_8_segments():
    """Windows 1 and 4: the overflow's retry resumes from tile 2
    (``resumed_from_tile`` > 0), with the JAX package's checkpoint,
    resume and replay counts, and both windows' results equal the JAX
    package's and each other's. Feedback is off, so neither engine
    learns a group count between the two windows' sessions."""
    res = {}
    for w in (1, 4):
        js, ts = dist_pair(_late_overflow, budget=4 << 20, **{
            "tile_pipeline.inflight_tiles": w,
            "recovery.checkpoint_every": 2, "feedback.enabled": False})
        res[w] = ts.sql(LATE_Q)
        assert_same(res[w], js.sql(LATE_Q))
        rep = same_dist_tiled_report(ts, js)
        assert rep["resumed_from_tile"] > 0
        for k in ("tile_checkpoints", "tile_resumes", "tiles_replayed",
                  "tile_deferred_overflows", "tile_window_replays"):
            assert ts.stmt_log.counter(k) == js.stmt_log.counter(k), k
        assert ts.stmt_log.counter("tile_resumes") == 1
    assert_same(res[4], res[1])


# ------------------------------------------------------------ restore math


@pytest.fixture(scope="module")
def tables():
    """The same 5,000-row partitioned table in both engines."""
    def load(s):
        rng = np.random.default_rng(11)
        s.sql("CREATE TABLE t (k BIGINT, v BIGINT) DISTRIBUTED BY (k)")
        s.catalog.table("t").set_data(
            {"k": rng.integers(0, 100_000, 5_000),
             "v": rng.integers(0, 1_000, 5_000)})
    js, ts = dist_pair(load)
    return js.catalog.table("t"), ts.catalog.table("t")


@pytest.mark.parametrize("nseg,tile_rows,tiles",
                         [(8, 64, 0), (8, 64, 3), (8, 500, 1),
                          (4, 128, 2), (3, 1000, 9)])
def test_fresh_consumed_mask_equals_jax(tables, nseg, tile_rows, tiles):
    jt, tt = tables
    want = JR.fresh_consumed_mask(jt, nseg, tile_rows, tiles)
    got = R.fresh_consumed_mask(tt, nseg, tile_rows, tiles)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # the cached layout gives the same mask
    lay = R._shard_layout(tt, nseg)
    assert np.array_equal(
        R.fresh_consumed_mask(tt, nseg, tile_rows, tiles, layout=lay), want)


@pytest.mark.parametrize("nseg,after", [(8, 8), (8, 5)])
def test_resumed_feed_equals_jax(tables, nseg, after):
    """The remaining-row feed after 2 tiles at 8 segments, re-sharded at
    ``after`` segments: the same tiles, counts and consumed masks."""
    from cloudberry_tpu.plan import nodes as JN
    from cloudberry_tpu_torch.plan import nodes as TN

    jt, tt = tables
    consumed = R.fresh_consumed_mask(tt, nseg, 64, 2)

    class _S:  # the two attributes the feed reads
        def __init__(self, t):
            self.catalog = type("C", (), {"table": lambda _, n: t})()

    scans = []
    for NN in (JN, TN):
        sc = NN.PScan(table_name="t", column_map={"k": "k", "v": "v"},
                      capacity=64)
        scans.append(sc)
    jf = JR._ResumedDistFeed(scans[0], _S(jt), 64, consumed, after)
    tf = R._ResumedDistFeed(scans[1], _S(tt), 64, consumed, after)
    jtiles, ttiles = list(jf), list(tf)
    assert len(jtiles) == len(ttiles) > 0
    for (ja, jn), (ta, tn) in zip(jtiles, ttiles):
        assert np.array_equal(jn, tn)
        assert sorted(ja) == sorted(ta)
        for c in ja:
            assert np.array_equal(ja[c], ta[c]), c
    for k in (0, 1, len(ttiles)):
        assert np.array_equal(jf.consumed_after(k), tf.consumed_after(k))


def _acc_payload(rng, nseg, cap):
    sel = rng.random((nseg, cap)) < 0.6
    return {"cols": {"g": rng.integers(-50, 50, (nseg, cap)),
                     "s": rng.integers(0, 10**9, (nseg, cap)),
                     "f": rng.standard_normal((nseg, cap))},
            "sel": sel}


@pytest.mark.parametrize("nseg,cap,grow", [(8, 16, 16), (8, 16, 40),
                                           (1, 7, 9)])
def test_pad_acc_equals_jax(nseg, cap, grow):
    p = _acc_payload(np.random.default_rng(nseg * 100 + grow), nseg, cap)
    (jc, js), (tc, ts) = JR._pad_acc(p, grow), R._pad_acc(p, grow)
    assert np.array_equal(js, ts) and js.shape == (nseg, grow)
    for n in jc:
        assert jc[n].dtype == tc[n].dtype and np.array_equal(jc[n], tc[n])


def _fields(NN, types):
    return [NN.PlanField(n, t, None) for n, t in types]


@pytest.mark.parametrize("from_seg,to_seg,cap", [(8, 8, 16), (8, 5, 30),
                                                 (8, 3, 64)])
def test_pooled_round_robin_equals_jax(from_seg, to_seg, cap):
    """Pooled partial rows re-placed round-robin onto another segment
    count: the same blocks in both engines."""
    import cloudberry_tpu.types as JT
    from cloudberry_tpu.plan import nodes as JN
    from cloudberry_tpu_torch.plan import nodes as TN

    p = _acc_payload(np.random.default_rng(from_seg * 10 + to_seg),
                     from_seg, 16)
    (jrows, jn), (trows, tn) = JR._pooled_rows(p), R._pooled_rows(p)
    assert jn == tn
    jf = _fields(JN, [("g", JT.INT64), ("s", JT.INT64), ("f", JT.FLOAT64)])
    tf = _fields(TN, [("g", INT64), ("s", INT64), ("f", FLOAT64)])
    jc, jsel = JR._round_robin_acc(jrows, jn, jf, to_seg, cap)
    tc, tsel = R._round_robin_acc(trows, tn, tf, to_seg, cap)
    assert np.array_equal(jsel, tsel)
    for n in jc:
        assert jc[n].dtype == tc[n].dtype and np.array_equal(jc[n], tc[n])


@pytest.mark.parametrize("m", [5, 40, 400])
def test_host_topn_equals_jax(m):
    """The best ``m`` pooled top-N rows by the device key normalization:
    mixed signs, floats with ties, ascending and descending keys."""
    import cloudberry_tpu.plan.expr as jex
    import cloudberry_tpu.types as JT

    rng = np.random.default_rng(m)
    rows = {"a": rng.integers(-20, 20, 300),
            "b": np.round(rng.standard_normal(300), 1),
            "c": np.arange(300)}
    jkeys = [(jex.ColumnRef("a", JT.INT64), True),
             (jex.ColumnRef("b", JT.FLOAT64), False),
             (jex.ColumnRef("c", JT.INT64), True)]
    tkeys = [(ex.ColumnRef("a", INT64), True),
             (ex.ColumnRef("b", FLOAT64), False),
             (ex.ColumnRef("c", INT64), True)]
    (jr, jn) = JR._host_topn(dict(rows), 300, jkeys, m)
    (tr, tn) = R._host_topn(dict(rows), 300, tkeys, m)
    assert jn == tn == min(m, 300)
    for n in jr:
        assert np.array_equal(np.asarray(jr[n]), tr[n]), n
    # a non-column key declines in both engines
    assert JR._host_topn(dict(rows), 300, [(jex.Literal(1, JT.INT64),
                                            True)], 5) is None
    assert R._host_topn(dict(rows), 300, [(ex.Literal(1, INT64), True)],
                        5) is None


def test_replaceable_covers_the_checkpoint_modes_as_in_jax():
    from cloudberry_tpu.exec.tiled import CHECKPOINT_MODES as JMODES
    from cloudberry_tpu_torch.exec.tiled import CHECKPOINT_MODES

    assert CHECKPOINT_MODES == JMODES
    assert R.REPLACEABLE == JR.REPLACEABLE
    assert set(R.REPLACEABLE) == set(CHECKPOINT_MODES)
    # a TileReplan is no executor error: the adaptive grow/halve loop
    # must let it through to the session
    from cloudberry_tpu_torch.exec.executor import ExecError

    assert not issubclass(R.TileReplan, ExecError)
    e = R.TileReplan("x", tiles_done=3, ratio=4.5)
    assert (e.tiles_done, e.ratio) == (3, 4.5)


# ------------------------------------------------- device loss at a tile

# one merge-motion aggregate (dim distributed on another key than the
# join key: the probe redistributes and the GROUP BY needs a merge motion
# — the placement-free degraded-resume case) ...
DIST_Q = ("SELECT g, sum(v) AS sv, count(*) AS c "
          "FROM fact JOIN dim ON fact.d = dim.d "
          "GROUP BY g ORDER BY g")
# ... and one COLOCATED one-stage aggregate (grouping on the distribution
# key: no merge motion, so a changed-nseg resume declines)
COLOC_Q = "SELECT k, sum(v) AS sv FROM fact GROUP BY k ORDER BY k LIMIT 20"
SINGLE_Q = ("SELECT g, sum(v) AS sv, count(*) AS c "
            "FROM fact JOIN dim ON fact.k = dim.k "
            "GROUP BY g ORDER BY g")
RECOVERY_COUNTERS = ("tiles_replayed", "tile_resumes", "tile_checkpoints",
                     "tile_resume_declined", "topo_resharded_resumes",
                     "recoveries")


@pytest.fixture
def clean_faults():
    reset_both()
    yield
    chaos_teardown()


def _load_single(s, n=200_000, nd=500):
    rng = np.random.default_rng(3)
    s.sql("CREATE TABLE dim (k BIGINT, g BIGINT) DISTRIBUTED BY (k)")
    s.sql("CREATE TABLE fact (k BIGINT, v BIGINT) DISTRIBUTED BY (k)")
    s.catalog.table("dim").set_data(
        {"k": np.arange(nd), "g": np.arange(nd) % 9})
    s.catalog.table("fact").set_data(
        {"k": rng.integers(0, nd, n), "v": rng.integers(0, 100, n)})


def _load_dist(n=400_000, nd=500):
    def load(s):
        rng = np.random.default_rng(3)
        s.sql("CREATE TABLE dim (d BIGINT, g BIGINT) DISTRIBUTED BY (g)")
        s.sql("CREATE TABLE fact (k BIGINT, d BIGINT, v BIGINT) "
              "DISTRIBUTED BY (k)")
        s.catalog.table("dim").set_data(
            {"d": np.arange(nd), "g": np.arange(nd) % 9})
        # k: 997 distinct values — a colocatable GROUP BY key
        s.catalog.table("fact").set_data(
            {"k": np.arange(n) % 997, "d": rng.integers(0, nd, n),
             "v": rng.integers(0, 100, n)})
    return load


def _recovery_pair(load, nseg, budget=2 << 20, **extra):
    ov = {"recovery.checkpoint_every": 2, "health.backoff_s": 0.01}
    if nseg > 1:
        ov["planner.broadcast_threshold"] = 0
    return dist_pair(load, budget=budget, nseg=nseg, **{**ov, **extra})


def _report(ts, js) -> dict:
    if ts.config.n_segments > 1:
        return same_dist_tiled_report(ts, js)
    return same_tiled_report(ts, js)


def _kill_and_run(js, ts, q, k: int, want):
    """Arm a device loss at 0-based tile ``k`` of the next attempt in both
    engines, run, hold both results equal to ``want`` and both reports
    and recovery counters equal; returns (replayed, resumed, report)."""
    reset_both("tile_device_lost")
    arm_both("tile_device_lost", start_hit=k + 1, end_hit=k + 1)
    before = same_counters(ts, js, RECOVERY_COUNTERS)
    got, jgot = ts.sql(q), js.sql(q)
    assert_same(got, jgot)
    assert_same(got, want)
    rep = _report(ts, js)
    after = same_counters(ts, js, RECOVERY_COUNTERS)
    return (after["tiles_replayed"] - before["tiles_replayed"],
            after["tile_resumes"] - before["tile_resumes"], rep)


def _clean(js, ts, q):
    got = ts.sql(q)
    assert_same(got, js.sql(q))
    return got, _report(ts, js)["n_tiles"]


@pytest.mark.parametrize("nseg", [1, 8])
def test_kill_matrix_resumes_from_the_last_checkpoint(nseg, clean_faults):
    """Kill at tile 0 / mid / last: equal results, replay bounded by K
    once a checkpoint exists, never a full restart; the segment count
    stays (no probe arm)."""
    if nseg == 1:
        js, ts = _recovery_pair(_load_single, 1)
        q = SINGLE_Q
    else:
        js, ts = _recovery_pair(_load_dist(), 8)
        q = DIST_Q
    want, total = _clean(js, ts, q)
    assert total >= 4
    for k in (0, total // 2, total - 1):
        replayed, resumed, rep = _kill_and_run(js, ts, q, k, want)
        assert replayed < total, f"kill@{k} replayed everything"
        if k >= 2:
            assert resumed == 1 and rep["resumed_from_tile"] > 0
            assert replayed <= 2
        assert rep["n_tiles"] == total
        assert ts.config.n_segments == nseg


@pytest.mark.parametrize("mode,q", [
    ("agg", DIST_Q),
    ("topn", "SELECT v, k, d FROM fact ORDER BY v DESC, k, d LIMIT 25"),
    ("sort", "SELECT v, k FROM fact WHERE v > 90 ORDER BY v, k")])
def test_degraded_resume_on_seven_segments(mode, q, clean_faults):
    """A device loss mid-stream and a probe that lost one slot: the
    statement resumes on the SEVEN survivors from its checkpoint — the
    remaining rows re-sharded by the placement hash, partials re-placed
    ahead of the merge — equal to the clean 8-segment run."""
    budget = (2 << 20) if mode == "agg" else (1 << 20)
    js, ts = _recovery_pair(_load_dist(), 8, budget=budget)
    want, total = _clean(js, ts, q)
    assert (ts.last_tiled_report.get("mode") or "agg") == mode
    assert total >= 4
    arm_both("probe_degraded", "skip")  # the probe sees 7 slots
    replayed, resumed, rep = _kill_and_run(js, ts, q, max(total // 2, 2),
                                           want)
    assert ts.config.n_segments == js.config.n_segments == 7
    assert resumed == 1 and rep["resumed_from_tile"] > 0
    assert replayed < total and replayed <= 2
    assert rep["n_segments"] == 7
    c = same_counters(ts, js, ("topo_resharded_resumes",))
    assert c["topo_resharded_resumes"] == 1
    # the degraded session keeps serving afterwards
    reset_both()
    got = ts.sql(q)
    assert_same(got, js.sql(q))
    assert_same(got, want)


def test_colocated_degraded_resume_declines_and_completes(clean_faults):
    """Colocated one-stage partials would need the group-key hash to
    re-place on fewer segments: the resume declines (counted) and the
    statement re-runs fresh on the survivors; on an unchanged layout the
    same statement resumes from its snapshot."""
    js, ts = _recovery_pair(_load_dist(n=800_000), 8, budget=1 << 20)
    want, total = _clean(js, ts, COLOC_Q)
    assert total >= 3
    k = min(max(total // 2, 2), total - 1)
    replayed, resumed, _ = _kill_and_run(js, ts, COLOC_Q, k, want)
    assert resumed == 1 and replayed <= 2 < total
    arm_both("probe_degraded", "skip")
    before = same_counters(ts, js, ("tile_resume_declined",))
    replayed, resumed, _ = _kill_and_run(js, ts, COLOC_Q, k, want)
    assert ts.config.n_segments == 7
    assert resumed == 0 and replayed == k
    after = same_counters(ts, js, ("tile_resume_declined",))
    assert after["tile_resume_declined"] > \
        before["tile_resume_declined"]


def test_checkpoint_hygiene_and_chaos_arms(clean_faults):
    """Checkpoints die with their statement, recovered or not; with
    ``ckpt_save`` skipped recovery replays the whole consumed prefix, and
    with ``ckpt_resume`` skipped it runs fresh — in both engines."""
    js, ts = _recovery_pair(_load_single, 1)
    want, total = _clean(js, ts, SINGLE_Q)
    assert ts._recovery._ckpts == js._recovery._ckpts == {}
    k = max(total // 2, 2)
    _kill_and_run(js, ts, SINGLE_Q, k, want)
    assert ts._recovery._ckpts == js._recovery._ckpts == {}
    for seam in ("ckpt_save", "ckpt_resume"):
        arm_both(seam, "skip")
        replayed, resumed, _ = _kill_and_run(js, ts, SINGLE_Q, k, want)
        assert resumed == 0 and replayed == k, seam
        reset_both(seam)


def test_recovery_is_liveness_and_the_deadline_still_governs(clean_faults):
    """A statement recovering inside its deadline is not cancelled by the
    watchdog; a huge backoff never sleeps past the deadline (the
    statement dies of StatementTimeout, in both engines); a retry budget
    stops re-dispatch; the activity history shows the retry."""
    import time

    from cloudberry_tpu import lifecycle as JL
    from cloudberry_tpu.utils import faultinject as JFI
    from cloudberry_tpu_torch import lifecycle as TL
    from cloudberry_tpu_torch.utils import faultinject as TFI

    js, ts = _recovery_pair(_load_single, 1, **{
        "statement_timeout_s": 120.0, "health.backoff_s": 0.05})
    dogs = [JL.Watchdog(js.stmt_log, interval_s=0.01).start(),
            TL.Watchdog(ts.stmt_log, interval_s=0.01).start()]
    try:
        want, total = _clean(js, ts, SINGLE_Q)
        _, resumed, _ = _kill_and_run(js, ts, SINGLE_Q, max(total // 2, 2),
                                      want)
        assert resumed == 1
        assert same_counters(ts, js, ("watchdog_timeouts",)) == \
            {"watchdog_timeouts": 0}
    finally:
        for d in dogs:
            d.stop()

    def t1(s):
        s.sql("create table t1 (x bigint)")
        s.catalog.table("t1").set_data({"x": np.arange(64, dtype=np.int64)})

    js, ts = dist_pair(t1, nseg=1, **{
        "statement_timeout_s": 0.5, "health.backoff_s": 30.0,
        "health.retries": 3})
    arm_both("exec_device_lost")  # every dispatch
    for s, L in ((js, JL), (ts, TL)):
        t0 = time.monotonic()
        with pytest.raises(L.StatementTimeout):
            s.sql("select sum(x) from t1")
        assert time.monotonic() - t0 < 5.0  # not 30 s of backoff
    reset_both()
    js, ts = dist_pair(t1, nseg=1, **{
        "health.retries": 5, "health.backoff_s": 0.01,
        "health.retry_budget_s": 1e-6})
    arm_both("exec_device_lost")
    for s, FI in ((js, JFI), (ts, TFI)):
        with pytest.raises(FI.InjectedFault):
            s.sql("select sum(x) from t1")
        # the budget refused every re-dispatch: one attempt ran
        assert FI._registry["exec_device_lost"].fired == 1
    reset_both()
    js, ts = dist_pair(t1, nseg=1, **{"health.backoff_s": 0.01})
    arm_both("exec_device_lost", start_hit=1, end_hit=1)
    for s in (js, ts):
        s.sql("select sum(x) from t1")
    got, want = ts.stmt_log.recent(1)[0], js.stmt_log.recent(1)[0]
    for key in ("attempts", "last_error"):
        assert got[key] == want[key], key
    assert got["attempts"] == 1 and got["backoff_s"] > 0
    assert got["last_error"] == "InjectedFault"
    c = same_counters(ts, js, ("recoveries",))
    assert c["recoveries"] == 1
    assert ts.stmt_log.counter("recovery_wall_ms") >= 0
