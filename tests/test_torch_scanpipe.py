"""The asynchronous scan pipeline (exec/scanpipe.py) and the tile feeds of
exec/tiled.py, against the JAX package's ``test_scan_pipeline.py`` (single
segment).

Pipeline on/off is BIT-IDENTICAL in every tiled mode, from RAM and from a
store, because it only moves host work off the critical path; a stream
that crosses a pooled/cold boundary inside one tile assembles that tile on
the device; an abandoned pipeline joins its reader; the bounded queue
respects its depth; ``_PendBuf`` copies each row at most once and skips
without copying; the prefetch/decode seams fire and recover; the queue
charge rides the report.
"""

import threading
import time

import numpy as np
import pytest
import torch

import cloudberry_tpu as cb
from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch import lifecycle
from cloudberry_tpu_torch.exec import scanpipe as SP
from cloudberry_tpu_torch.exec.tiled import _pad_tile, _PendBuf
from cloudberry_tpu_torch.utils import faultinject as FI
from torch_parity import (assert_same, assert_same_rows, budget_pair,
                          carry_tables, same_tiled_report)

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


def _no_orphan_readers(timeout=5.0) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if not any(t.name.startswith("cbtpu_torch-scan-reader")
                   and t.is_alive() for t in threading.enumerate()):
            return True
        time.sleep(0.05)
    return False


def _same_bits(a, b) -> None:
    for f in a.schema.fields:
        assert np.array_equal(np.asarray(a.columns[f.name]),
                              np.asarray(b.columns[f.name])), f.name


# ------------------------------------------------- on/off bit-identity


@pytest.mark.parametrize("q,mode", [(AGG_Q, None), (TOPN_Q, "topn"),
                                    (SORT_Q, "sort"), (WIN_Q, "window")],
                         ids=["agg", "topn", "sort", "window"])
def test_pipeline_on_off_bit_identical(q, mode):
    got = {}
    for pipe in (True, False):
        js, ts = budget_pair(_load, 3 << 20,
                             **{"scan_pipeline.enabled": pipe,
                                "tile_pipeline.inflight_tiles": 4})
        got[pipe] = ts.sql(q)
        want = js.sql(q)
        if mode == "window":
            assert_same_rows(got[pipe], want)
        else:
            assert_same(got[pipe], want)
        rep = same_tiled_report(ts, js)
        assert rep["n_tiles"] > 1 and rep.get("mode") == mode
        assert rep["pipeline"]["enabled"] is pipe
    _same_bits(got[True], got[False])
    assert _no_orphan_readers()


def _store_pair(tmp_path, rpp, budget, **extra):
    """Each engine writes the fact/dim tables to a store of its own; fresh
    sessions open them cold under ``budget``."""
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    rp = {"storage.rows_per_partition": rpp}
    jcfg = cb.get_config().with_overrides(
        n_segments=1, **{"sched.generic_plans": False,
                         "storage.root": jroot, **rp})
    js0 = cb.Session(jcfg)
    _load(js0)
    carry_tables(js0, TorchSession(TorchConfig().with_overrides(
        **{"storage.root": troot, **rp}), device="cpu"))
    ov = {"resource.query_mem_bytes": budget, **extra}
    js = cb.Session(jcfg.with_overrides(**ov))
    tcfg = TorchConfig().with_overrides(**{"storage.root": troot, **ov})
    return js0, js, tcfg


def test_cold_store_pipeline_bit_identical(tmp_path):
    """Micro-partition files stream through the prefetch pipeline with
    column-parallel decode: on/off bit-identical, decode accounting on
    the report, the queue bound respected."""
    js0, js, tcfg = _store_pair(tmp_path, 20_000, 3 << 20)
    exp = js0.sql(AGG_Q)
    got = {}
    for pipe in (True, False):
        ts = TorchSession(tcfg.with_overrides(
            **{"scan_pipeline.enabled": pipe}), device="cpu")
        assert ts.catalog.table("fact").cold
        got[pipe] = ts.sql(AGG_Q)
        assert_same(got[pipe], exp)
        assert_same(got[pipe], js.sql(AGG_Q))
        rep = same_tiled_report(ts, js)
        p = rep["pipeline"]
        assert p["enabled"] is pipe
        assert p["parts_read"] == 6 and p["decode_s"] >= 0.0
        assert p["bytes_decoded"] > 0
        if pipe:
            assert p["tiles_prefetched"] == rep["n_tiles"]
            assert p["max_depth"] <= tcfg.scan_pipeline.prefetch_tiles
            assert 0.0 <= p["overlap_frac"] <= 1.0
    _same_bits(got[True], got[False])
    assert _no_orphan_readers()


@pytest.mark.parametrize("pipe", [True, False], ids=["pipeline", "plain"])
def test_pooled_cold_boundary_inside_one_tile(tmp_path, pipe, monkeypatch):
    """Some partitions of the stream sit in the device buffer pool, the
    rest are read cold, and the tiles do not align with partitions: a tile
    takes rows from a pooled chunk (a device tensor) and from a decoded one
    (host memory). The tile is assembled on the device; the result equals
    the cold run, the one-shot result and the JAX session."""
    from cloudberry_tpu_torch.exec import bufferpool as BUF

    # 120,000 rows in partitions of 20,000; tiles of 16,384 rows at 1 MiB:
    # no partition boundary falls on a tile boundary
    js0, js, tcfg = _store_pair(
        tmp_path, 20_000, 1 << 20,
        **{"bufferpool.admit_min_scans": 1,
           "scan_pipeline.enabled": pipe})
    exp = js0.sql(AGG_Q)
    ts = TorchSession(tcfg, device="cpu")
    cold = ts.sql(AGG_Q)                  # reads (and admits) all six
    assert_same(cold, exp)
    assert ts.last_tiled_report["pipeline"]["parts_read"] == 6
    pool = BUF.pool_for(ts)
    files = sorted({k[3] for k in pool._entries if k[1] == "fact"})
    assert len(files) == 6
    pool.sweep(lambda k: k[1] == "fact" and k[3] not in files[:2])
    mixed = []
    real_ready = SP.DeviceStage.ready

    def ready(self, staged):
        mixed.extend(k for k, v in staged[0].items()
                     if isinstance(v, SP.Mixed))
        return real_ready(self, staged)

    monkeypatch.setattr(SP.DeviceStage, "ready", ready)
    got = ts.sql(AGG_Q)
    assert_same(got, exp)
    assert_same(got, js.sql(AGG_Q))
    _same_bits(got, cold)
    rep = same_tiled_report(ts, js)
    p = rep["pipeline"]
    assert p["parts_resident"] == 2 and p["parts_read"] == 4
    assert rep["tile_rows"] == 16_384 and mixed


def test_mixed_tile_assembles_on_the_device():
    """``_PendBuf`` over a pooled (tensor) chunk and a decoded (numpy)
    chunk: the tile that crosses them is a Mixed column, and the device
    stage assembles exactly the concatenated rows, padding included."""
    buf = _PendBuf(SP.ScanStats())
    pooled = torch.arange(0, 10, dtype=torch.int64)
    decoded = np.arange(10, 25, dtype=np.int64)
    buf.append({"a": pooled})
    buf.append({"a": decoded})
    first = _pad_tile(buf.take(8), 0, 8, 8)
    assert torch.is_tensor(first["a"])          # a view of the pooled chunk
    mixed = _pad_tile(buf.take(8), 0, 8, 8)
    assert isinstance(mixed["a"], SP.Mixed)
    tail = _pad_tile(buf.take(buf.rows), 0, 9, 12)
    assert tail["a"].shape == (12,)
    stage = SP.DeviceStage("cpu", pinned=True)
    got = [stage.now(t)["a"] for t in (first, mixed, tail)]
    assert all(torch.is_tensor(g) for g in got)
    assert torch.equal(got[0], torch.arange(0, 8))
    assert torch.equal(got[1], torch.arange(8, 16))
    assert torch.equal(got[2], torch.cat([torch.arange(16, 25),
                                          torch.zeros(3, dtype=torch.int64)]))
    pad_pooled = _pad_tile({"a": pooled}, 0, 10, 16)
    assert torch.equal(stage.now(pad_pooled)["a"],
                       torch.cat([pooled, torch.zeros(6, dtype=torch.int64)]))


# -------------------------------------------------- threads and queue


def test_queue_bound_respected_tiny_tiles():
    """500 one-row tiles through a depth-3 queue with a slow consumer:
    every tile arrives in order and the high-water mark stays within the
    bound."""
    def gen():
        for i in range(500):
            yield ({"x": np.array([i], dtype=np.int64)}, 1)

    p = SP.ScanPipeline(gen(), depth=3)
    seen = []
    try:
        for i, (tile, n) in enumerate(p):
            assert n == 1
            seen.append(int(tile["x"][0]))
            if i % 50 == 0:
                time.sleep(0.01)  # let the reader race ahead
    finally:
        p.close()
    assert seen == list(range(500))
    assert p.max_depth <= 3
    assert p.stats()["tiles_prefetched"] == 500
    assert _no_orphan_readers()


def test_abandoned_pipeline_close_joins_reader():
    """close() mid-stream (the adaptive-retry restart shape): the reader
    joins promptly and staged buffers release."""
    def gen():
        for _ in range(10_000):
            yield ({"x": np.zeros(1024, dtype=np.int64)}, 1024)

    p = SP.ScanPipeline(gen(), depth=2,
                        stage=SP.DeviceStage("cpu", pinned=True),
                        prestage=True)
    tile, n = next(iter(p))
    assert torch.is_tensor(tile["x"]) and n == 1024
    p.close()
    assert _no_orphan_readers()


def test_reader_runs_in_the_statement_scope():
    """The reader installs the statement's lifecycle scope: a cancelled
    statement stops the prefetch, the consumer raises StatementCancelled,
    and the reader joins."""
    handle = lifecycle.StatementHandle(1)

    def gen():
        for i in range(1000):
            if i == 5:
                handle.token.cancel()
            yield ({"x": np.array([i])}, 1)

    with lifecycle.statement_scope(handle):
        p = SP.ScanPipeline(gen(), depth=2)
        with pytest.raises(lifecycle.StatementCancelled):
            for _ in p:
                pass
        p.close()
    assert _no_orphan_readers()


def test_pendbuf_linear_copies():
    """Chunk-exact tiles hand the decoded chunk over zero-copy; every other
    tile copies its rows EXACTLY once, and never emits a sub-chunk view."""
    st = SP.ScanStats()
    buf = _PendBuf(st)
    src = [np.arange(c * 250, (c + 1) * 250) for c in range(16)]
    for c in src:
        buf.append({"a": c})
    outs = []
    while buf.rows >= 250:
        outs.append(buf.take(250)["a"])
    assert st.copy_rows == 0 and st.view_rows == 4_000
    for got, chunk in zip(outs, src):
        assert got is chunk

    st1 = SP.ScanStats()
    buf1 = _PendBuf(st1)
    for _ in range(64):
        buf1.append({"a": np.arange(1000), "b": np.ones(1000)})
    out_rows = 0
    while buf1.rows >= 250:
        t = buf1.take(250)
        assert t["a"].base is None  # owned copy, not a view
        out_rows += len(t["a"])
    assert out_rows == 64_000
    assert st1.copy_rows == 64_000 and st1.view_rows == 0

    st2 = SP.ScanStats()
    buf2 = _PendBuf(st2)
    for c in range(16):
        buf2.append({"a": np.arange(c * 1000, (c + 1) * 1000)})
    got = []
    while buf2.rows > 0:
        got.append(buf2.take(min(300, buf2.rows))["a"])
    assert np.array_equal(np.concatenate(got), np.arange(16_000))
    assert st2.copy_rows + st2.view_rows == 16_000


def test_pendbuf_skip_is_cursor_only():
    st = SP.ScanStats()
    buf = _PendBuf(st)
    for c in range(8):
        buf.append({"a": np.arange(c * 100, (c + 1) * 100)})
    buf.skip(350)  # crosses 3.5 chunks: no take, no copy
    assert st.copy_rows == 0 and st.view_rows == 0
    assert buf.rows == 450
    assert np.array_equal(buf.take(50)["a"], np.arange(350, 400))


# ----------------------------------------------------------- fault arms


def test_scan_prefetch_seam_fires_and_recovers():
    js, ts = budget_pair(_load, 3 << 20)
    exp = ts.sql(AGG_Q)
    assert_same(exp, js.sql(AGG_Q))
    FI.inject_fault("scan_prefetch", "error", start_hit=2, end_hit=2)
    with pytest.raises(FI.InjectedFault):
        ts.sql(AGG_Q)
    assert _no_orphan_readers()
    FI.reset_fault()
    assert_same(ts.sql(AGG_Q), exp)


def test_scan_decode_seam_fires_and_recovers(tmp_path):
    js0, js, tcfg = _store_pair(tmp_path, 20_000, 3 << 20)
    exp = js0.sql(AGG_Q)
    ts = TorchSession(tcfg, device="cpu")
    FI.inject_fault("scan_decode", "error", start_hit=2, end_hit=2)
    with pytest.raises(FI.InjectedFault):
        ts.sql(AGG_Q)
    assert _no_orphan_readers()
    FI.reset_fault()
    assert_same(ts.sql(AGG_Q), exp)


# --------------------------------------------------------- accounting


def test_queue_charge_rides_report():
    js, ts = budget_pair(_load, 3 << 20)
    ts.sql(AGG_Q)
    js.sql(AGG_Q)
    rep = same_tiled_report(ts, js)
    assert rep["est_pipeline_bytes"] == \
        js.last_tiled_report["est_pipeline_bytes"] > 0
    cfg = ts.config.scan_pipeline
    assert rep["est_pipeline_bytes"] % cfg.prefetch_tiles == 0
    assert rep["est_pipeline_bytes"] // cfg.prefetch_tiles \
        >= rep["tile_rows"]
    js_off, ts_off = budget_pair(_load, 3 << 20,
                                 **{"scan_pipeline.enabled": False})
    ts_off.sql(AGG_Q)
    assert ts_off.last_tiled_report["est_pipeline_bytes"] == 0


@pytest.mark.parametrize("pipe", [True, False], ids=["pipeline", "plain"])
def test_tiled_run_leaves_no_tensor_in_a_reference_cycle(pipe):
    """Every tile's tensors are freed by reference counting as the stream
    moves on: none sits in a reference cycle, where it would stay
    allocated until the garbage collector ran (on the card, device memory
    above the budget)."""
    import gc

    js, ts = budget_pair(_load, 3 << 20,
                         **{"scan_pipeline.enabled": pipe,
                            "tile_pipeline.inflight_tiles": 4})
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        assert_same(ts.sql(AGG_Q), js.sql(AGG_Q))
        assert ts.last_tiled_report["n_tiles"] > 1
        gc.collect()
        cyclic = [o for o in gc.garbage if torch.is_tensor(o)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert cyclic == []
