"""Transactions through the port against the JAX package, on the CPU:
BEGIN / COMMIT / ROLLBACK over RAM and store-backed tables, the OCC
commit (first committer wins for rewrites, concurrent appends merge), the
crash and cancel windows of COMMIT, sequences and ANALYZE inside a rolled
back transaction, and the breaker's exemption of transaction control —
the cases of ``test_sql_api.py::test_transactions``, ``test_occ.py``, the
transaction cases of ``test_storage_scan.py``, ``test_sequences.py`` and
``test_stats.py``, and two of ``test_lifecycle.py``, each run in both
engines (``torch_parity.twin``) with every result held equal: integers,
DECIMAL and counts exactly, floats to rtol 1e-9, status texts and errors
exactly.

The last cases are the port's own: a ROLLBACK must drop the device copies
and shard layouts of the tables it restores (the JAX package keeps no
device copy), and reads inside a transaction on a store must see the
transaction's writes, never a cache entry keyed by the unchanged store
version."""

import numpy as np
import pytest

import torch_parity
from torch_parity import twin


@pytest.fixture(autouse=True)
def _disarm():
    yield
    torch_parity.chaos_teardown()


def count(s, table="t"):
    return int(np.asarray(s.sql(f"select count(*) as n from {table}")
                          .columns["n"])[0])


def test_transactions():
    def run(e):
        s = e.session()
        s.sql("create table tx (k int, s text)")
        s.sql("insert into tx values (1,'a')")
        e.keep(s.sql("begin"))
        s.sql("insert into tx values (2,'brandnew')")
        s.sql("update tx set s = 'changed' where k = 1")
        s.sql("create table tx2 (x int)")
        s.sql("create view txv as select k from tx")
        e.keep(s.sql("select k, s from tx order by k"))   # read your writes
        e.keep(s.sql("rollback"))
        e.keep(s.sql("select k, s from tx"))   # data AND dictionary back
        e.error(s.sql, "select * from tx2")
        e.error(s.sql, "select * from txv")
        e.keep(s.sql("begin transaction"))
        e.keep(s.sql("delete from tx where k = 1"))
        e.keep(s.sql("commit"))
        e.keep(count(s, "tx"))
        e.error(s.sql, "commit")
        s.sql("begin")
        e.error(s.sql, "begin")
        e.keep(s.sql("abort"))
    got = twin(run)
    assert got[0] == "BEGIN" and got[1].num_rows() == 2
    assert got[2] == "ROLLBACK"
    assert got[3].decoded_columns()["s"].tolist() == ["a"]
    assert got[6:9] == ["BEGIN", "DELETE 1", "COMMIT"] and got[9] == 0
    assert got[10][0] == got[11][0] == "BindError"


# ------------------------------------------------------------ OCC, store


def _mk(e):
    s = e.session(**{"storage.root": e.root("s")})
    s.sql("create table t (a bigint, v bigint) distributed by (a)")
    s.sql("insert into t values (1, 10), (2, 20)")
    return s


def _open(e):
    return e.session(**{"storage.root": e.root("s")})


def test_commit_is_durable_across_crash(tmp_path):
    def run(e):
        a = _mk(e)
        a.sql("begin")
        a.sql("insert into t values (3, 30)")
        e.keep(a.sql("commit"))
        del a   # "crash"
        e.keep(count(_open(e)))
    assert twin(run, tmp_path) == ["COMMIT", 3]


def test_crash_during_commit_preserves_old_snapshot(tmp_path):
    def run(e):
        FI = e.mod("utils.faultinject")
        a = _mk(e)
        a.sql("begin")
        a.sql("insert into t values (3, 30)")
        FI.inject_fault("storage_commit_before_current", "skip")
        try:
            a.sql("commit")
        finally:
            FI.reset_fault("storage_commit_before_current")
        e.keep(count(_open(e)))
    assert twin(run, tmp_path) == [2]


def test_concurrent_writer_conflict(tmp_path):
    def run(e):
        a = _mk(e)
        b = _open(e)
        a.sql("begin")
        a.sql("update t set v = v + 1 where a = 1")
        b.sql("insert into t values (200, 2)")    # B commits first
        kind, msg = e.error(a.sql, "commit")
        assert kind == "SerializationError" and "another session" in msg
        e.keep(a.sql("select a, v from t order by a"))
        e.keep(_open(e).sql("select a, v from t order by a"))
    got = twin(run, tmp_path)
    assert got[1].columns["a"].tolist() == [1, 2, 200]


def test_non_conflicting_tables_commit_fine(tmp_path):
    def run(e):
        a = _mk(e)
        b = _open(e)
        b.sql("create table u (x bigint) distributed by (x)")
        a.sql("begin")
        a.sql("insert into t values (100, 1)")
        b.sql("insert into u values (7)")   # another table: no conflict
        e.keep(a.sql("commit"))
        c = _open(e)
        e.keep((count(c), count(c, "u")))
    assert twin(run, tmp_path) == ["COMMIT", (3, 1)]


def test_concurrent_appends_merge(tmp_path):
    """Two transactions that only append to one table both commit: the
    later COMMIT merges onto the other's snapshot."""
    def run(e):
        a = _mk(e)
        b = _open(e)
        a.sql("begin")
        b.sql("begin")
        a.sql("insert into t values (3, 30)")
        b.sql("insert into t values (4, 40), (5, 50)")
        e.keep(b.sql("commit"))
        e.keep(a.sql("commit"))
        e.keep(a.sql("select a, v from t order by a"))
        e.keep(_open(e).sql("select a, v from t order by a"))
    got = twin(run, tmp_path)
    assert got[3].columns["a"].tolist() == [1, 2, 3, 4, 5]


def test_cross_session_visibility(tmp_path):
    def run(e):
        a = _mk(e)
        b = _open(e)
        b.sql("insert into t values (3, 30)")
        e.keep(count(a))
        b.sql("create table fresh (x bigint) distributed by (x)")
        e.keep(count(a, "fresh"))
        b.sql("drop table fresh")
        e.error(a.sql, "select * from fresh")
    got = twin(run, tmp_path)
    assert got[:2] == [3, 0]


def test_analyze_then_drop_in_txn_no_ghost(tmp_path):
    def run(e):
        a = _mk(e)
        a.sql("begin")
        a.sql("analyze t")
        a.sql("drop table t")
        e.keep(a.sql("commit"))
        e.keep(a.store.table_names())
        e.keep("t" in _open(e).catalog.tables)
    assert twin(run, tmp_path) == ["COMMIT", [], False]


def test_snapshot_isolation_within_txn(tmp_path):
    def run(e):
        a = _mk(e)
        b = _open(e)
        a.sql("begin")
        e.keep(count(a))
        b.sql("insert into t values (3, 30)")
        e.keep(count(a))     # B's commit stays invisible
        e.keep(a.sql("commit"))
        e.keep(count(a))
    assert twin(run, tmp_path) == [2, 2, "COMMIT", 3]


# ---------------------------------------- cold tables, sequences, stats


def _mk_store(e):
    cfg = {"storage.root": e.root("store"), "storage.rows_per_partition": 50}
    s = e.session(**cfg)
    s.sql("create table t (a bigint, b bigint, c text, d double) "
          "distributed by (a)")
    s.sql("insert into t values " + ",".join(
        f"({i}, {i * 10}, '{'xyz'[i % 3]}', {i}.5)" for i in range(200)))
    return lambda: e.session(**cfg)


def test_rollback_never_truncates_cold_table(tmp_path):
    def run(e):
        reopen = _mk_store(e)
        s2 = reopen()
        e.keep(s2.catalog.table("t").cold)
        s2.sql("begin")
        s2.sql("insert into t values (999, 1, 'x', 0.1)")
        e.keep(count(s2))
        s2.sql("rollback")
        e.keep(count(s2))
        e.keep(count(reopen()))
        e.keep(s2.sql("select a, b, c, d from t where a > 190 order by a"))
    assert twin(run, tmp_path)[:4] == [True, 201, 200, 200]


def test_txn_commit_persists(tmp_path):
    def run(e):
        reopen = _mk_store(e)
        s2 = reopen()
        s2.sql("begin")
        s2.sql("insert into t values (999, 1, 'x', 0.1)")
        e.keep(s2.sql("commit"))
        s3 = reopen()
        e.keep(count(s3))
        e.keep(s3.sql("select a, b, c, d from t where a > 190 order by a"))
    assert twin(run, tmp_path)[:2] == ["COMMIT", 201]


def test_rollback_keeps_cold_stats(tmp_path):
    def run(e):
        s2 = _mk_store(e)()
        t = s2.catalog.table("t")
        e.keep((t.num_rows, t.is_unique("a")))
        s2.sql("begin")
        s2.sql("create table scratch (x int) distributed by (x)")
        s2.sql("rollback")
        t = s2.catalog.table("t")
        e.keep((t.cold, t.num_rows, t.is_unique("a")))
    assert twin(run, tmp_path) == [(200, True), (True, 200, True)]


def test_nextval_survives_rollback(tmp_path):
    def run(e):
        s = e.session(**{"storage.root": e.root()})
        s.sql("create sequence r")
        s.sql("begin")
        e.keep(s.sql("select nextval('r') as v"))
        s.sql("rollback")
        # PostgreSQL semantics: nextval is never undone by ROLLBACK
        e.keep(s.sql("select nextval('r') as v"))
    got = twin(run, tmp_path)
    assert [int(g.columns["v"][0]) for g in got] == [1, 2]


def test_analyze_in_rolled_back_txn_not_durable(tmp_path):
    def run(e):
        root = {"storage.root": e.root()}
        s = e.session(**root)
        s.sql("create table t (a bigint, g bigint) distributed by (a)")
        s.sql("insert into t values " +
              ",".join(f"({i}, {i % 5})" for i in range(50)))
        s.sql("begin")
        s.sql("insert into t values " +
              ",".join(f"({i + 100}, {i})" for i in range(50)))
        s.sql("analyze t")
        s.sql("rollback")
        e.keep(e.session(**root).catalog.table("t").ndv("g"))
        s.sql("analyze t")
        e.keep(e.session(**root).catalog.table("t").ndv("g"))
    got = twin(run, tmp_path)
    assert got[0] in (None, 5) and got[1] == 5


# ------------------------------------------------- lifecycle cases


def _load_lc(e, **ov):
    s = e.session(**ov)
    s.sql("create table t (k bigint, v bigint) distributed by (k)")
    s.catalog.table("t").set_data(
        {"k": np.arange(64, dtype=np.int64),
         "v": (np.arange(64, dtype=np.int64) * 7) % 13})
    return s


def test_breaker_exempts_transaction_control():
    """An open breaker never traps a session in its transaction: BEGIN
    and ROLLBACK bypass the write gate."""
    def run(e):
        lifecycle = e.mod("lifecycle")
        FI = e.mod("utils.faultinject")
        s = _load_lc(e, **{"health.breaker_threshold": 1,
                           "health.breaker_cooldown_s": 60.0})
        s.sql("begin")
        s.sql("insert into t values (999, 0)")
        FI.inject_fault("exec_device_lost", "error", start_hit=1,
                        end_hit=1)
        e.keep(s.sql("select sum(v) as sv from t"))    # trips at K=1
        e.keep(s._breaker.snapshot()["state"])
        with pytest.raises(lifecycle.BreakerOpen):
            s.sql("insert into t values (1000, 0)")
        e.keep(s.sql("rollback"))    # always allowed
        e.keep(count(s))
        FI.reset_fault()
    got = twin(run)
    assert got[1:] == ["open", "ROLLBACK", 64]


def test_occ_commit_window_cancel_aborts_clean(tmp_path):
    """Cancellation inside the OCC commit window aborts the transaction
    (nothing published) and releases the store lock."""
    def run(e):
        lifecycle = e.mod("lifecycle")
        s = e.session(**{"storage.root": e.root()})
        s.sql("create table t (a bigint)")
        s.sql("insert into t values (1)")
        h = lifecycle.StatementHandle(0)
        h.token.cancel("cancelled")
        s.txn("begin")
        s.sql("insert into t values (2)")
        with lifecycle.statement_scope(h):
            with pytest.raises(lifecycle.StatementCancelled):
                s.txn("commit")
        e.keep(count(s))
        s.txn("begin")
        s.sql("insert into t values (3)")
        e.keep(s.txn("commit"))
        e.keep(count(s))
    assert twin(run, tmp_path) == [1, "COMMIT", 2]


# ------------------------------------------------- the port's own traps


def _cpu(nseg=1, **ov):
    from cloudberry_tpu_torch import Config, Session

    return Session(Config(n_segments=nseg).with_overrides(**ov),
                   device="cpu")


@pytest.mark.parametrize("nseg", [1, 8])
def test_rollback_drops_device_copies_of_recreated_table(nseg):
    """Drop and re-create a table in a transaction, fill it and read it
    (its device copy and shard layout are cached under the name), then
    ROLLBACK: the next SELECT returns the pre-transaction rows, and no
    cache entry of the name outlives the rollback."""
    s = _cpu(nseg)
    s.sql("create table t (k bigint, v bigint) distributed by (k)")
    s.sql("insert into t values " + ", ".join(
        f"({i}, {i * 3})" for i in range(40)))
    q = "select k, v from t order by k"
    before = s.sql(q).decoded_columns()
    s.sql("begin")
    s.sql("drop table t")
    s.sql("create table t (k bigint, v bigint) distributed by (k)")
    s.sql("insert into t values (1000, 1), (1001, 2)")
    assert s.sql(q).decoded_columns()["k"].tolist() == [1000, 1001]
    assert "t" in s._device_tables or any(
        k.startswith("t@") for k in s._device_shards)
    assert s.sql("rollback") == "ROLLBACK"
    assert "t" not in s._device_tables
    assert not any(k.startswith("t@") for k in s._device_shards)
    after = s.sql(q).decoded_columns()
    for c in ("k", "v"):
        np.testing.assert_array_equal(after[c], before[c])
    # and the same statement once more, now through the caches
    np.testing.assert_array_equal(s.sql(q).decoded_columns()["v"],
                                  before["v"])


def test_rollback_drops_join_index_and_pool_entries(tmp_path):
    """A store-backed build side read before and inside a transaction:
    ROLLBACK drops the scope's join indexes and buffer-pool chunks of the
    table it wrote, and keeps those of a store table it never wrote
    (they are shared with every session over the store)."""
    root = {"storage.root": str(tmp_path / "s"),
            "storage.rows_per_partition": 50,
            "bufferpool.admit_min_scans": 1}
    s = _cpu(**root)
    s.sql("create table d (k bigint, g bigint) distributed by (k)")
    s.sql("create table f (k bigint, v bigint) distributed by (k)")
    s.sql("insert into d values " + ", ".join(
        f"({i}, {i % 7})" for i in range(100)))
    s.sql("insert into f values " + ", ".join(
        f"({i % 100}, {i})" for i in range(600)))
    w = _cpu(**root)
    w.sql("create table u (a bigint, b bigint) distributed by (a)")
    w.sql("insert into u values " + ", ".join(
        f"({i}, {i * 3})" for i in range(300)))
    qu = "select count(*) as n, sum(b) as sb from u where a >= 100"
    want_u = s.sql(qu).decoded_columns()
    s.sql(qu)
    assert s.catalog.table("u").cold
    pool = s._cache_scope.bufferpool
    assert pool is not None
    u_bytes = pool.table_bytes("u")
    assert u_bytes > 0
    q = ("select g, sum(v) as sv, count(*) as c from f join d "
         "on f.k = d.k group by g order by g")
    want = s.sql(q).decoded_columns()
    s.sql("begin")
    s.sql("update d set g = g + 100 where k < 50")
    inside = s.sql(q).decoded_columns()
    assert max(inside["g"]) >= 100
    s.sql("rollback")
    scope = s._cache_scope
    assert not [k for k in scope.joinindex if k[0][0] == "d"]
    assert pool.table_bytes("d") == 0
    assert pool.table_bytes("u") == u_bytes
    got = s.sql(q).decoded_columns()
    for c in ("g", "sv", "c"):
        np.testing.assert_array_equal(got[c], want[c])
    got_u = s.sql(qu).decoded_columns()
    for c in ("n", "sb"):
        np.testing.assert_array_equal(got_u[c], want_u[c])


def test_reads_inside_txn_see_own_writes_on_store(tmp_path):
    """Trap 2: a cold table's pruned reads are cached by store version,
    which does not move inside a transaction. The transaction's own
    writes make the table RAM-resident and key the shared caches by
    table object, so every read inside sees them; after ROLLBACK the
    store's rows come back."""
    from cloudberry_tpu_torch.sched import sharedcache

    root = {"storage.root": str(tmp_path / "s"),
            "storage.rows_per_partition": 50,
            "bufferpool.admit_min_scans": 1}
    w = _cpu(**root)
    w.sql("create table t (a bigint, b bigint) distributed by (a)")
    w.sql("insert into t values " + ", ".join(
        f"({i}, {i * 10})" for i in range(300)))
    s = _cpu(**root)
    q = "select count(*) as n, sum(b) as sb from t where a >= 100"
    first = s.sql(q).decoded_columns()
    s.sql(q)    # the store-scan cache and the pool now hold t's reads
    assert s.catalog.table("t").cold
    assert sharedcache.table_key(s, "t")[1] == "sv"
    s.sql("begin")
    assert sharedcache.table_key(s, "t")[1] == "uid"
    s.sql("insert into t values (1000, 5), (1001, 6)")
    got = s.sql(q).decoded_columns()
    assert int(got["n"][0]) == int(first["n"][0]) + 2
    assert int(got["sb"][0]) == int(first["sb"][0]) + 11
    s.sql("update t set b = 0 where a < 200")
    got = s.sql(q).decoded_columns()
    assert int(got["sb"][0]) == int(first["sb"][0]) + 11 - sum(
        i * 10 for i in range(100, 200))
    s.sql("rollback")
    back = s.sql(q).decoded_columns()
    assert back["n"].tolist() == first["n"].tolist()
    assert back["sb"].tolist() == first["sb"].tolist()
    # a second session never saw the rolled-back rows
    assert _cpu(**root).sql(q).decoded_columns()["n"].tolist() == \
        first["n"].tolist()
