"""Background compaction (storage/compact.py) through the port against the
JAX package, on the CPU — the cases of ``tests/test_compaction.py``.

Each scenario runs the same store operations in both engines, each on a
store root of its own (``torch_parity.twin``): a bulk load, small appends
through the ingest plane, a delete pass, an online rebalance, then a
compaction pass. Held equal between the engines: the ``delta_parts``
census, partition counts, live rows, each pass's counters, the
``compact_*`` counters and every query result (integers, DECIMAL and
counts exactly; there are no float columns here). Within each engine, a
compacted store answers exactly as it did before the pass. The TPC-H
case writes one fragmented store with the JAX package, compacts a copy
with each engine and reads each copy back with both engines (float
columns at rtol 1e-9, ``torch_parity.assert_same``). The last cases are
the port's own: its device caches after a compaction commit, and the
compactor in the port's ``Server``."""

import os
import shutil
import threading
import time

import numpy as np
import pytest

from torch_parity import assert_same, chaos_teardown, twin, twin_servers

RPP = 512
TIMEOUT = 60
_Q = "select count(*) as c, sum(v) as sv, min(k) as mn, max(k) as mx from t"
_ROWS = "select k, v from t order by k"


@pytest.fixture(autouse=True)
def _clean_faults():
    chaos_teardown()
    yield
    chaos_teardown()


def _relation(batch) -> dict:
    return {k: np.asarray(v).tolist()
            for k, v in batch.decoded_columns().items()}


def _same_relation(got, want) -> None:
    assert _relation(got) == _relation(want)


def _store_session(e, nseg=1, n=4000, **ov):
    over = {"storage.root": e.root(), "storage.rows_per_partition": RPP,
            "ingest.flush_rows": 32, "ingest.flush_ms": 10.0, **ov}
    s = e.session(nseg, **over)
    s.sql("create table t (k bigint, v bigint) distributed by (k)")
    s.catalog.table("t").set_data(
        {"k": np.arange(n, dtype=np.int64),
         "v": (np.arange(n, dtype=np.int64) * 3) % 97}, {})
    s._sync_store()
    return s


def _fragment(e, s, lo=100_000, batches=12, rows=16):
    """Small appends (tiny tail partitions) + a visimap delete pass
    (dirty partitions) — the debt compaction exists to fold."""
    ing = e.mod("storage.ingest").IngestService(s)
    for b in range(batches):
        ing.append("t", [[lo + b * rows + j, 5] for j in range(rows)])
    ing.stop()
    s.store.delete_rows("t", lambda c: c["k"] % 11 == 3)
    s._sync_store()


def _census(e, s, name="t"):
    return e.mod("storage.compact").delta_parts(
        s.store.read_manifest(name), RPP, 0.5)


def _shape(man) -> tuple:
    """A manifest's partition story without its (random) file names."""
    parts = man["partitions"]
    return (len(parts), sum(p["num_rows"] - len(p["deleted"])
                            for p in parts),
            sum(1 for p in parts if p["deleted"]),
            sorted(((p.get("seg"), p.get("seg_nseg"), p["num_rows"])
                    for p in parts), key=str))


# -------------------------------------------------------------- the fold


def test_merge_applies_deletes_and_repacks(tmp_path):
    def run(e):
        C = e.mod("storage.compact")
        s = _store_session(e)
        _fragment(e, s)
        before, rows_before = s.sql(_Q), s.sql(_ROWS)
        e.keep(before)
        e.keep(rows_before)
        man0 = s.store.read_manifest("t")
        e.keep((_census(e, s), _shape(man0)))
        e.keep(C.CompactionService(s).run_once(force=True))
        man = s.store.read_manifest("t")
        e.keep((_census(e, s), _shape(man)))
        live = sum(p["num_rows"] for p in man["partitions"])
        assert len(man["partitions"]) <= live // RPP + 1
        _same_relation(s.sql(_Q), before)
        _same_relation(s.sql(_ROWS), rows_before)
        # a FRESH session over the compacted store reads the same relation
        s2 = e.session(**{"storage.root": e.root()})
        e.keep(s2.sql(_ROWS))
        _same_relation(s2.sql(_ROWS), rows_before)
    got = twin(run, tmp_path)
    (c0, shape0), out, (c1, shape1) = got[2], got[3], got[4]
    assert c0 > 0 and shape0[2] > 0
    assert out["chunks"] >= 1 and out["parts_merged"] >= 2
    assert c1 == 0 and shape1[2] == 0, "compaction folds to census zero"


def test_resort_toward_declared_scan_order(tmp_path):
    """With a range partition column declared, merged partitions come
    out sorted by it — min/max stats tighten back to prunable."""
    def run(e):
        mp = e.mod("storage.micropartition")
        s = e.session(**{"storage.root": e.root(),
                         "storage.rows_per_partition": RPP})
        s.sql("create table t (k bigint, v bigint) "
              "partition by range (k) (start 0 end 4000 every 1000)")
        rng = np.random.default_rng(7)
        s.catalog.table("t").set_data(
            {"k": rng.permutation(1000).astype(np.int64),
             "v": np.arange(1000, dtype=np.int64)}, {})
        s._sync_store()
        ing = e.mod("storage.ingest").IngestService(s)
        for b in range(6):
            ks = rng.permutation(40) + 2000 + b * 100
            ing.append("t", [[int(k), 1] for k in ks])
        ing.stop()
        before = {p["file"] for p in
                  s.store.read_manifest("t")["partitions"]}
        e.keep(e.mod("storage.compact").CompactionService(s).run_once(
            force=True))
        man = s.store.read_manifest("t")
        written = [p for p in man["partitions"] if p["file"] not in before]
        assert written, "compaction must have rewritten the small tails"
        ks = []
        for p in written:
            k = np.asarray(mp.read_columns(
                os.path.join(s.store.root, "t", p["file"]), ["k"])["k"])
            assert np.all(k[:-1] <= k[1:]), p["file"]
            ks.append((p.get("pkey"), k.tolist()))
        e.keep(sorted(ks, key=str))
        e.keep(s.sql("select count(*) c, sum(k) sk from t"))
    got = twin(run, tmp_path)
    exp_k = int(np.arange(1000).sum() + sum(
        (np.arange(40) + 2000 + b * 100).sum() for b in range(6)))
    assert int(got[2].columns["c"][0]) == 1240
    assert int(got[2].columns["sk"][0]) == exp_k


def test_compaction_is_a_logged_statement(tmp_path):
    def run(e):
        s = _store_session(e)
        _fragment(e, s, batches=6)
        comp = e.mod("storage.compact").CompactionService(s)
        comp.run_once(force=True)
        compacts = [r for r in s.stmt_log.recent(20)
                    if r["sql"].startswith("COMPACT ")]
        e.keep([(r["sql"], r["status"]) for r in compacts])
        snap = comp.snapshot()
        e.keep({k: v for k, v in snap.items() if k != "running"})
        s._compactor = comp
        vals = e.mod("obs.capacity").refresh_gauges(s)
        e.keep(vals["compact_delta_parts_max"])
    got = twin(run, tmp_path)
    assert got[0] and got[0][0] == ("COMPACT t", "ok")
    snap = got[1]
    assert snap["enabled"] and snap["chunks"] >= 1
    assert any(row["table"] == "t" and row["delta_parts"] == 0
               for row in snap["tables"])
    assert got[2] == 0


# ----------------------------------------------- rebalance folding


def test_post_rebalance_delta_partitions_converge(tmp_path):
    """An online expand leaves seg-tagged delta partitions plus movement
    delete vectors; compaction folds BOTH to a clean manifest, tags
    preserved, the relation unchanged — in both engines alike."""
    def run(e):
        s = _store_session(e, nseg=4, n=5000)
        rows_before = s.sql(_ROWS)
        e.keep(rows_before)
        s._topology.online_resize(6)
        man0 = s.store.read_manifest("t")
        tagged0 = [p for p in man0["partitions"] if p.get("seg_nseg") == 6]
        assert tagged0 and any(p["deleted"] for p in man0["partitions"])
        e.keep((_census(e, s), _shape(man0)))
        e.keep(e.mod("storage.compact").CompactionService(s).run_once(
            force=True))
        man = s.store.read_manifest("t")
        tagged = [p for p in man["partitions"] if p.get("seg_nseg") == 6]
        assert sum(p["num_rows"] for p in tagged) == sum(
            p["num_rows"] - len(p["deleted"]) for p in tagged0)
        assert all(0 <= p["seg"] < 6 for p in tagged)
        e.keep((_census(e, s), _shape(man)))
        _same_relation(s.sql(_ROWS), rows_before)
        s2 = e.session(6, **{"storage.root": e.root()})
        e.keep(s2.sql(_ROWS))
    got = twin(run, tmp_path)
    assert got[1][0] > 0 and got[3][0] == 0


# ----------------------------------------------------------------- chaos


def test_cancel_mid_chunk(tmp_path):
    """A hang at the chunk seam is cancellable via the StatementLog; the
    pass aborts with a CONSISTENT manifest, and the next pass converges."""
    def run(e):
        FI = e.mod("utils.faultinject")
        s = _store_session(e)
        _fragment(e, s)
        before = s.sql(_Q)
        comp = e.mod("storage.compact").CompactionService(s)
        FI.inject_fault("compact_chunk", "hang")
        cancelled = []

        def canceller():
            deadline = time.monotonic() + TIMEOUT
            while time.monotonic() < deadline:
                act = [r for r in s.stmt_log.activity()
                       if r["sql"].startswith("COMPACT ")]
                if act:
                    cancelled.append(s.stmt_log.cancel(act[0]["id"]))
                    return
                time.sleep(0.01)

        bg = threading.Thread(target=canceller)
        bg.start()
        e.error(comp.run_once, force=True)
        bg.join(timeout=TIMEOUT)
        FI.reset_fault()
        e.keep(cancelled)
        _same_relation(s.sql(_Q), before)
        e.keep(comp.run_once(force=True))
        e.keep(_census(e, s))
        e.keep(s.sql(_Q))
    got = twin(run, tmp_path)
    assert got[0][0] == "StatementCancelled" and got[1] == [True]
    assert got[3] == 0


def test_crash_restart_journal_resume(tmp_path):
    """An 'error' inside the locked commit window dies AFTER the
    replacement files exist: the journal's pending record survives, a
    fresh service's restore() deletes exactly the never-committed
    orphans, and the next pass converges with nothing lost."""
    def run(e):
        FI = e.mod("utils.faultinject")
        C = e.mod("storage.compact")
        s = _store_session(e)
        _fragment(e, s)
        before = s.sql(_Q)
        comp = C.CompactionService(s)
        FI.inject_fault("compact_commit", "error", start_hit=1, end_hit=1)
        e.error(comp.run_once, force=True)
        FI.reset_fault()
        rec = comp._read_journal(s.store)
        tdir = os.path.join(e.root(), "t")
        orphans = [f for f in rec["pending"]["files"]
                   if os.path.exists(os.path.join(tdir, f))]
        committed = {p["file"] for p in
                     s.store.read_manifest("t")["partitions"]}
        assert orphans and not set(orphans) & committed
        e.keep((rec["pending"]["table"], len(orphans), rec["counters"]))
        comp2 = C.CompactionService(s)   # the crash-restart analog
        e.keep(comp2._read_journal(s.store)["pending"])
        e.keep([os.path.exists(os.path.join(tdir, f)) for f in orphans])
        e.keep(s.stmt_log.counter("compact_journal_restores"))
        _same_relation(s.sql(_Q), before)
        e.keep(comp2.run_once(force=True))
        e.keep(_census(e, s))
        _same_relation(s.sql(_Q), before)
    got = twin(run, tmp_path)
    assert got[0][0] == "InjectedFault"
    assert got[1][0] == "t" and got[2] is None and not any(got[3])
    assert got[4] == 1 and got[6] == 0


def test_fault_soak_holds_bounded_invariant(tmp_path):
    """Seeded chunk faults + concurrent appends, then quiesce: the
    bounded delta-partition invariant still lands and no row is lost —
    the worker survives every injected error. The pass counters depend
    on the worker's timing, so only the relation and the invariant are
    held equal."""
    def run(e):
        FI = e.mod("utils.faultinject")
        s = _store_session(e, **{"compact.interval_s": 0.05,
                                 "compact.max_delta_parts": 4})
        comp = e.mod("storage.compact").CompactionService(s)
        comp.start()
        try:
            FI.inject_fault("compact_chunk", "error", p=0.3, seed=1234)
            ing = e.mod("storage.ingest").IngestService(s)
            for b in range(20):
                ing.append("t", [[200_000 + b * 8 + j, 2]
                                 for j in range(8)])
                if b == 10:
                    s.store.delete_rows("t", lambda c: c["k"] % 13 == 5)
            ing.stop()
            time.sleep(0.3)
            FI.reset_fault()
            comp.wake()
            time.sleep(0.3)
        finally:
            comp.stop()
        final = comp.run_once()
        e.keep(final["delta_parts_max"] <= comp.max_delta_parts)
        s._sync_store()
        e.keep(s.sql(_Q))
    got = twin(run, tmp_path)
    keep = np.arange(4000)[np.arange(4000) % 13 != 5]
    app = np.arange(200_000, 200_160)
    app_live = app[~((app % 13 == 5) & (app < 200_088))]
    assert got[0] is True
    assert int(got[1].columns["c"][0]) == len(keep) + len(app_live)


def test_worker_defers_while_breaker_open(tmp_path):
    def run(e):
        s = _store_session(e, **{"compact.interval_s": 0.05,
                                 "compact.max_delta_parts": 0})
        _fragment(e, s, batches=4)
        debt = e.keep(_census(e, s))

        class _Breaker:
            state = "open"

        s._breaker = _Breaker()
        comp = e.mod("storage.compact").CompactionService(s)
        comp.start()
        try:
            comp.wake()
            time.sleep(0.2)
            e.keep(_census(e, s) == debt)
            s._breaker.state = "closed"
            comp.wake()
            deadline = time.monotonic() + TIMEOUT
            while _census(e, s) and time.monotonic() < deadline:
                time.sleep(0.02)
        finally:
            comp.stop()
        e.keep(_census(e, s))
    got = twin(run, tmp_path)
    assert got[0] > 0 and got[1] is True and got[2] == 0


# ------------------------------------------- version-bump invalidation


def _pool(e, on: bool) -> dict:
    if e.is_port:
        return {"bufferpool.max_bytes": (256 << 20) if on else 0}
    return {"bufferpool.enabled": on}


def test_version_bump_invalidates_pooled_state(tmp_path):
    """Compaction rewrites files under the SAME table name; every cache
    keyed by store version rides on the commit bumping that version."""
    def run(e):
        s = _store_session(e, **_pool(e, True))
        _fragment(e, s)
        before = e.keep(s.sql(_Q))
        v0 = s.store.current_version("t")
        e.mod("storage.compact").CompactionService(s).run_once(force=True)
        e.keep(s.store.current_version("t") > v0)
        _same_relation(s.sql(_Q), before)
        e.keep(s.catalog.table("t")._store_version > v0)
    got = twin(run, tmp_path)
    assert got[1] is True and got[2] is True


def test_port_device_caches_follow_a_compaction_commit(tmp_path):
    """The port's own caches after a compaction commit: the table's
    device copy, the store-scan LRU and the buffer pool serve the
    compacted files only, and every answer equals the pre-compaction
    one (ROADMAP C 12, C 48)."""
    from cloudberry_tpu_torch import Session
    from cloudberry_tpu_torch.config import Config
    from cloudberry_tpu_torch.exec import bufferpool as BUF
    from cloudberry_tpu_torch.storage.compact import CompactionService
    from cloudberry_tpu_torch.storage.ingest import IngestService

    cfg = Config().with_overrides(**{
        "storage.root": str(tmp_path), "storage.rows_per_partition": RPP,
        "bufferpool.max_bytes": 256 << 20})
    s = Session(cfg, device="cpu")
    s.sql("create table t (k bigint, v bigint) distributed by (k)")
    s.catalog.table("t").set_data(
        {"k": np.arange(4000, dtype=np.int64),
         "v": (np.arange(4000, dtype=np.int64) * 3) % 97}, {})
    s._sync_store()
    ing = IngestService(s)
    for b in range(12):
        ing.append("t", [[100_000 + b * 16 + j, 5] for j in range(16)])
    ing.stop()
    s.store.delete_rows("t", lambda c: c["k"] % 11 == 3)
    s._sync_store()
    before, rows_before = s.sql(_Q), s.sql(_ROWS)
    point = "select k, v from t where k = 100005"
    pt_before = s.sql(point)
    dev_before = {k: v.clone() for k, v in s.device_table("t").items()}
    old_copy = s._device_tables["t"]
    v0 = s.store.current_version("t")
    assert any(k[0] == "t" and k[1] == v0 for k in s._store_scan_cache)
    pool = BUF.pool_for(s)
    assert any(k[1] == "t" and k[2] == v0 for k in pool._entries)

    CompactionService(s).run_once(force=True)
    v1 = s.store.current_version("t")
    files = {p["file"] for p in s.store.read_manifest("t")["partitions"]}
    _same_relation(s.sql(_Q), before)
    _same_relation(s.sql(_ROWS), rows_before)
    _same_relation(s.sql(point), pt_before)
    # the store-scan LRU: the old version's entries went with _sync_store
    keys = [k for k in s._store_scan_cache if k[0] == "t"]
    assert keys and all(k[1] == v1 and set(k[2]) <= files for k in keys)
    # the pool: entries at the new version name only committed files
    fresh = [k for k in pool._entries if k[1] == "t" and k[2] == v1]
    assert fresh and all(k[3] in files for k in fresh)
    # the device copy went with the old version; a new one holds the
    # same live rows, read from the compacted files
    assert s._device_tables.get("t") is not old_copy
    dev_after = s.device_table("t")
    order_b = np.argsort(dev_before["k"].numpy(), kind="stable")
    order_a = np.argsort(dev_after["k"].numpy(), kind="stable")
    for c in ("k", "v"):
        assert np.array_equal(dev_after[c].numpy()[order_a],
                              dev_before[c].numpy()[order_b])


# ------------------------------------------------------- the server


def test_server_runs_the_compactor(tmp_path):
    """``compact.enabled`` builds a running compactor in the server,
    shared by every backend, woken by ingest commits; ``meta
    compaction`` answers the JAX package's keys and settings, and the
    background passes fold the appended tails in both engines."""
    def run(e):
        cfg = e.config(**{"storage.root": e.root(),
                          "storage.rows_per_partition": RPP,
                          "compact.enabled": True,
                          "compact.interval_s": 0.05,
                          "compact.max_delta_parts": 2,
                          "ingest.flush_ms": 10.0})
        srv = e.server(config=cfg)
        assert srv.compactor is not None
        assert srv.ingest.on_commit == srv.compactor.wake
        if e.is_port:
            assert srv.compactor._thread.name == "cbtpu_torch-compactor"
        c = e.client(srv, timeout=TIMEOUT)
        c.sql("create table ev (k bigint, v bigint)")
        for b in range(8):
            c.append("ev", [[b * 10 + j, j] for j in range(10)])
        deadline = time.monotonic() + TIMEOUT
        while time.monotonic() < deadline:
            rows = {r["table"]: r for r in c.meta("compaction")["tables"]}
            if rows.get("ev", {}).get("delta_parts", 99) <= 2 \
                    and c.meta("compaction")["chunks"] >= 1:
                break
            time.sleep(0.05)
        snap = c.meta("compaction")
        e.keep(sorted(snap))
        e.keep({k: snap[k] for k in ("enabled", "running", "interval_s",
                                     "throttle_s", "chunk_partitions",
                                     "max_delta_parts", "target_fill")})
        e.keep(snap["chunks"] >= 1 and {r["table"]: r["delta_parts"] <= 2
                                        for r in snap["tables"]})
        e.wire(c.sql, "select count(*) as n, sum(k) as sk from ev")
        srv.compactor.stop()
        assert srv.compactor._thread is None
    got = twin_servers(run, tmp_path)
    assert "journal" in got[0] and got[1]["running"] is True
    assert got[2] == {"ev": True}


# ------------------------------------------------------- TPC-H identity


TPCH_Q = ("q1", "q3", "q6")


def _pyv(v):
    import pandas as pd

    if isinstance(v, pd.Timestamp):
        return str(v.date())
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.bool_):
        return bool(v)
    return v


@pytest.fixture(scope="module")
def tpch_store(tmp_path_factory):
    """One fragmented TPC-H sf=0.01 store written by the JAX package
    (duplicate tail appends through the ingest plane, a delete pass on
    lineitem and orders), copied, and each copy compacted by one engine:
    the store format is shared, so each engine's pass runs over the same
    bytes. Returns the two roots, each pass's counters and the JAX
    package's pre-compaction answers."""
    import cloudberry_tpu as cb
    from cloudberry_tpu.storage.compact import \
        CompactionService as JCompaction
    from cloudberry_tpu.storage.ingest import IngestService
    from cloudberry_tpu_torch import Session
    from cloudberry_tpu_torch.config import Config
    from cloudberry_tpu_torch.storage.compact import \
        CompactionService as TCompaction
    from tools.tpch_queries import QUERIES
    from tools.tpchgen import load_tpch

    base = tmp_path_factory.mktemp("tpch_compact")
    jroot, troot = str(base / "jax"), str(base / "port")
    over = {"storage.rows_per_partition": 2048, "ingest.flush_rows": 64,
            "ingest.flush_ms": 10.0}
    js = cb.Session(cb.get_config().with_overrides(
        **{"storage.root": jroot, "sched.generic_plans": False, **over}))
    load_tpch(js, sf=0.01, seed=7)
    li = js.catalog.table("lineitem").to_pandas()
    ing = IngestService(js)
    for b in range(4):
        ing.append("lineitem",
                   [[_pyv(v) for v in li.iloc[-(b * 50 + j) - 1]]
                    for j in range(50)])
    ing.stop()
    js.store.delete_rows("lineitem", lambda c: c["l_orderkey"] % 37 == 0)
    js.store.delete_rows("orders", lambda c: c["o_orderkey"] % 37 == 0)
    js._sync_store()
    baseline = {q: js.sql(QUERIES[q]) for q in TPCH_Q}
    shutil.copytree(jroot, troot)
    ts = Session(Config().with_overrides(
        **{"storage.root": troot, **over}), device="cpu")
    passes = {"jax": JCompaction(js).run_once(force=True),
              "port": TCompaction(ts).run_once(force=True)}
    return jroot, troot, passes, baseline


def test_tpch_compaction_pass_equals_jax(tpch_store):
    """The two engines' passes over the same fragmented store: equal
    counters, and equal manifests but for the new files' names."""
    from cloudberry_tpu.storage.table_store import TableStore

    jroot, troot, passes, _ = tpch_store
    assert passes["port"] == passes["jax"]
    assert passes["port"]["chunks"] >= 1
    jst, tst = TableStore(jroot), TableStore(troot)
    assert sorted(jst.table_names()) == sorted(tst.table_names())
    for name in jst.table_names():
        jm, tm = jst.read_manifest(name), tst.read_manifest(name)
        assert _shape(tm) == _shape(jm), name
        assert [p["stats"] for p in tm["partitions"]] == \
            [p["stats"] for p in jm["partitions"]], name


@pytest.mark.parametrize("pool", [True, False], ids=["pool", "nopool"])
def test_tpch_compacted_identical_subset(tpch_store, pool):
    """Fresh readers over each compacted copy answer the pre-compaction
    results: the port over its own pass and over the JAX package's pass,
    the JAX package over the port's pass."""
    import cloudberry_tpu as cb
    from cloudberry_tpu_torch import Session
    from cloudberry_tpu_torch.config import Config
    from tools.tpch_queries import QUERIES

    jroot, troot, _, baseline = tpch_store
    pool_t = {"bufferpool.max_bytes": (256 << 20) if pool else 0}
    for root in (troot, jroot):
        ts = Session(Config().with_overrides(
            **{"storage.root": root, **pool_t}), device="cpu")
        for q, want in baseline.items():
            assert_same(ts.sql(QUERIES[q]), want)
    js = cb.Session(cb.get_config().with_overrides(
        **{"storage.root": troot, "bufferpool.enabled": pool,
           "sched.generic_plans": False}))
    for q, want in baseline.items():
        assert_same(js.sql(QUERIES[q]), want)
