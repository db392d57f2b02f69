"""The windowed in-flight tile dispatch (exec/tilepipe.py) and the
checkpoint store behind its deferred-failure replay (exec/recovery.py),
against the JAX package's ``test_tilepipe.py`` (single segment).

Window on/off is BIT-IDENTICAL in every tiled mode because the window only
moves WHEN the host learns a tile's check flags, never what runs; a merge
overflow observed behind newer in-flight tiles is counted as deferred and
replays from the last drained-clean checkpoint, converging to the
synchronous answer. A CPU session's auto window is 1, so the tests force
``inflight_tiles=4`` where the window is under test.
"""

import numpy as np
import pytest
import torch

import cloudberry_tpu as cb
from cloudberry_tpu.exec import tilepipe as JTP
from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch.exec import recovery as R
from cloudberry_tpu_torch.exec import tilepipe as TP
from cloudberry_tpu_torch.utils import faultinject as FI
from torch_parity import (assert_same, assert_same_rows, budget_pair,
                          same_tiled_report)

AGG_Q = ("SELECT g, sum(v) AS sv, count(*) AS c "
         "FROM fact JOIN dim ON fact.k = dim.k GROUP BY g ORDER BY g")
TOPN_Q = ("SELECT fact.k AS k, v, g FROM fact JOIN dim ON fact.k = dim.k "
          "WHERE v < 90 ORDER BY v, fact.k, g LIMIT 25")
SORT_Q = ("SELECT g, v FROM fact JOIN dim ON fact.k = dim.k "
          "WHERE v < 50 ORDER BY g, v DESC, fact.k")
WIN_Q = ("SELECT g, v, rank() over (partition by g order by v desc) AS r,"
         " sum(v) over (partition by g) AS sv "
         "FROM fact JOIN dim ON fact.k = dim.k")


def _load(s, n_fact=120_000, n_dim=500, n_groups=9):
    rng = np.random.default_rng(3)
    s.sql("CREATE TABLE dim (k BIGINT, g BIGINT) DISTRIBUTED BY (k)")
    s.sql("CREATE TABLE fact (k BIGINT, v BIGINT) DISTRIBUTED BY (k)")
    s.catalog.table("dim").set_data(
        {"k": np.arange(n_dim), "g": np.arange(n_dim) % n_groups})
    s.catalog.table("fact").set_data(
        {"k": rng.integers(0, n_dim, n_fact),
         "v": rng.integers(0, 100, n_fact)})


@pytest.fixture(autouse=True)
def _clean_faults():
    FI.reset_fault()
    yield
    FI.reset_fault()


# ------------------------------------------------------ window semantics


def test_effective_window_defaults():
    """auto (inflight_tiles=0) is 1 on a CPU device — the synchronous loop
    exactly — and the accelerator default on CUDA, as the JAX package's
    is on its accelerators; explicit values clamp."""
    cfg = TorchConfig()
    jcfg = cb.get_config()
    assert TP.effective_window(cfg, "cpu") == 1 \
        == JTP.effective_window(jcfg, "cpu")
    assert TP.effective_window(cfg, "cuda") == TP._AUTO_ACCEL_WINDOW \
        == JTP.effective_window(jcfg, "gpu") == 4
    cfg3 = cfg.with_overrides(**{"tile_pipeline.inflight_tiles": 3})
    assert TP.effective_window(cfg3, "cpu") == 3
    off = cfg.with_overrides(**{"tile_pipeline.enabled": False,
                                "tile_pipeline.inflight_tiles": 8})
    assert TP.effective_window(off, "cuda") == 1
    huge = cfg.with_overrides(**{"tile_pipeline.inflight_tiles": 10_000})
    assert TP.effective_window(huge, "cpu") == TP._MAX_WINDOW \
        == JTP._MAX_WINDOW


def test_window_charge_zero_at_one():
    """window=1 charges nothing extra; wider windows charge (W-1)
    in-flight tiles, as in the JAX package."""
    reps = {}
    for w in (1, 4):
        js, ts = budget_pair(_load, 3 << 20,
                             **{"tile_pipeline.inflight_tiles": w})
        assert_same(ts.sql(AGG_Q), js.sql(AGG_Q))
        reps[w] = same_tiled_report(ts, js)
        assert reps[w]["est_pipeline_bytes"] == \
            js.last_tiled_report["est_pipeline_bytes"]
    per_tile = (reps[4]["est_pipeline_bytes"]
                - reps[1]["est_pipeline_bytes"]) // 3
    assert per_tile > 0


# ------------------------------------------------- on/off bit-identity


@pytest.mark.parametrize("q,mode", [(AGG_Q, None), (TOPN_Q, "topn"),
                                    (SORT_Q, "sort"), (WIN_Q, "window")],
                         ids=["agg", "topn", "sort", "window"])
def test_windows_1_and_4_bit_identical(q, mode):
    got = {}
    for w in (1, 4):
        js, ts = budget_pair(_load, 3 << 20,
                             **{"tile_pipeline.inflight_tiles": w})
        got[w] = ts.sql(q)
        want = js.sql(q)
        if mode == "window":
            assert_same_rows(got[w], want)
        else:
            assert_same(got[w], want)
        rep = same_tiled_report(ts, js)
        assert rep["n_tiles"] > 1 and rep.get("mode") == mode
        assert rep["tile_window"] == w
        assert 1 <= rep["inflight_depth"] <= w
        assert rep["drain_stall_s"] >= 0.0
        if w > 1:
            assert rep["inflight_depth"] > 1
    a, b = got[1], got[4]
    for f in a.schema.fields:
        assert np.array_equal(np.asarray(a.columns[f.name]),
                              np.asarray(b.columns[f.name])), f.name


# ------------------------------------------- deferred overflow + replay


def test_deferred_overflow_replays_bit_identical():
    """A merge overflow whose check drains AFTER newer tiles were
    enqueued: the deferral is counted, the adaptive retry replays from the
    last drained-clean checkpoint, and the answer and the grown
    accumulator match the synchronous run and the JAX session exactly."""
    def load(s):
        rng = np.random.default_rng(3)
        s.sql("CREATE TABLE fact (k BIGINT, v BIGINT) "
              "DISTRIBUTED BY (k)")
        s.catalog.table("fact").set_data(
            {"k": rng.integers(0, 10_000, 200_000),
             "v": rng.integers(0, 100, 200_000)})

    q = ("SELECT k % 7000 AS kk, count(*) AS c, sum(v) AS sv "
         "FROM fact GROUP BY k % 7000 ORDER BY kk LIMIT 50")
    res = {}
    for w in (1, 4):
        js, ts = budget_pair(load, 4 << 20,
                             **{"tile_pipeline.inflight_tiles": w})
        res[w] = ts.sql(q)
        assert_same(res[w], js.sql(q))
        c = ts.counters
        if w == 1:
            assert c.counter("tile_deferred_overflows") == 0
            assert c.counter("tile_window_replays") == 0
        else:
            assert c.counter("tile_deferred_overflows") >= 1
            assert c.counter("tile_window_replays") >= 1
        assert c.counter("tile_deferred_overflows") == \
            js.stmt_log.counter("tile_deferred_overflows")
        assert same_tiled_report(ts, js)["acc_capacity"] >= 7000
    assert_same(res[4], res[1])


def test_replay_resumes_from_a_checkpoint():
    """With enough tiles before the overflow surfaces, the replay resumes
    from a drained-clean checkpoint (``resumed_from_tile`` > 0) instead of
    re-streaming, and still equals the synchronous run."""
    def load(s):
        rng = np.random.default_rng(4)
        s.sql("CREATE TABLE fact (k BIGINT, v BIGINT) "
              "DISTRIBUTED BY (k)")
        # the first half of the stream holds few groups, the second many:
        # the overflow fires late, behind several checkpoints
        k = np.concatenate([rng.integers(0, 200, 400_000),
                            rng.integers(0, 30_000, 100_000)])
        s.catalog.table("fact").set_data(
            {"k": k, "v": rng.integers(0, 100, 500_000)})

    q = ("SELECT k % 20000 AS kk, count(*) AS c, sum(v) AS sv "
         "FROM fact GROUP BY k % 20000 ORDER BY kk LIMIT 50")
    res, reps = {}, {}
    for w in (1, 4):
        js, ts = budget_pair(load, 4 << 20,
                             **{"tile_pipeline.inflight_tiles": w,
                                "recovery.checkpoint_every": 2})
        res[w] = ts.sql(q)
        assert_same(res[w], js.sql(q))
        reps[w] = same_tiled_report(ts, js)
        for k in ("resumed_from_tile", "tiles_replayed"):
            assert reps[w][k] == js.last_tiled_report[k], k
        for k in ("tile_checkpoints", "tile_resumes", "tiles_replayed"):
            assert ts.counters.counter(k) == js.stmt_log.counter(k), k
    assert reps[4]["resumed_from_tile"] > 0
    assert_same(res[4], res[1])


# --------------------------------------------------------- fault seams


def test_enqueue_drain_seams_fire_and_recover():
    """The dispatch seams are live: an error on either raises out of the
    statement, a sleep on tile_drain lands in drain_stall_s, and a reset
    rerun is bit-identical."""
    js, ts = budget_pair(_load, 3 << 20,
                         **{"tile_pipeline.inflight_tiles": 4})
    exp = ts.sql(AGG_Q)
    assert_same(exp, js.sql(AGG_Q))
    for seam in ("tile_enqueue", "tile_drain"):
        FI.inject_fault(seam, "error", start_hit=2, end_hit=2)
        with pytest.raises(FI.InjectedFault, match=seam):
            ts.sql(AGG_Q)
        FI.reset_fault()
        assert_same(ts.sql(AGG_Q), exp)
    FI.inject_fault("tile_drain", "sleep", sleep_s=0.02)
    assert_same(ts.sql(AGG_Q), exp)
    FI.reset_fault()
    assert ts.last_tiled_report["drain_stall_s"] >= 0.02


# ------------------------------------------- no host read at submit


def test_submit_reads_no_device_tensor(monkeypatch):
    """``submit`` (and the checkpoint staging) must not read a tensor on
    the host: no ``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()`` or
    ``bool()`` — each would synchronize the whole stream on the card."""
    pipe = TP.TilePipe(None, 4)
    checks = {"a": torch.tensor([False, False]), "b": torch.tensor(False)}
    acc = ({"x": torch.arange(5)}, torch.ones(5, dtype=torch.bool))

    def forbidden(*a, **kw):
        raise AssertionError("host read inside submit")

    for name in ("item", "cpu", "numpy", "tolist", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, forbidden)
    payload = TP.stage_checkpoint(acc)
    drained = [pipe.submit(i, checks, (i, payload)) for i in range(3)]
    monkeypatch.undo()
    assert drained == [[], [], []] and pipe.max_depth == 3
    out = pipe.drain_all()
    assert [d.idx for d in out] == [0, 1, 2]
    p = out[0].payload[1]()
    assert np.array_equal(p["cols"]["x"], np.arange(5))
    assert p["sel"].all()


def test_deferred_failure_flag_and_counter():
    """A check that fires with newer tiles still in flight marks the pipe
    deferred and bumps ``tile_deferred_overflows``; the same failure on
    the last in-flight tile is not deferred."""
    from cloudberry_tpu_torch.exec.executor import ExecError
    from cloudberry_tpu_torch.exec.instrument import StatementLog

    class S:
        stmt_log = StatementLog()

    for tail, deferred in ((2, True), (0, False)):
        pipe = TP.TilePipe(S, 8)
        pipe.submit(0, {"tile merge overflow": torch.tensor(True)})
        for i in range(tail):
            pipe.submit(i + 1, {"ok": torch.tensor(False)})
        with pytest.raises(ExecError, match=r"^\[tile 0\] tile merge"):
            pipe.drain_one()
        assert pipe.deferred_fail is deferred
    assert S.stmt_log.counter("tile_deferred_overflows") == 1


# --------------------------------------------------- recovery store


def test_recovery_store_lru_by_statements_and_bytes():
    from cloudberry_tpu_torch.exec.instrument import StatementLog

    log = StatementLog()
    store = R.RecoveryStore(max_statements=2, max_bytes=1000, log=log)

    def ck(nbytes, sig=("s",)):
        return R.TileCheckpoint(sig, "agg", 1, 16,
                                {"a": np.zeros(nbytes, dtype=np.uint8)})

    store.save(1, ck(100))
    store.save(2, ck(100))
    store.save(3, ck(100))          # evicts statement 1 (count bound)
    assert store.load(1, ("s",)) is None
    assert store.load(2, ("s",)) is not None
    store.save(4, ck(900))          # evicts by bytes
    assert store.pinned_bytes() <= 1000
    store.save(5, ck(2000))         # alone over the budget: refused
    assert store.load(5, ("s",)) is None
    assert store.load(4, ("other",)) is None   # signature mismatch
    store.discard(4)
    assert store.load(4, ("s",)) is None
    assert log.counter("ckpt_evictions") >= 2
    assert log.counter("ckpt_oversize_refused") == 1
