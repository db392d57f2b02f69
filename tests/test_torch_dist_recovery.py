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
"""

import numpy as np
import pytest

from cloudberry_tpu.exec import recovery as JR
from cloudberry_tpu_torch.exec import recovery as R
from cloudberry_tpu_torch.plan import expr as ex
from cloudberry_tpu_torch.types import INT64, FLOAT64
from torch_parity import assert_same, dist_pair, same_dist_tiled_report

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
