"""Durable storage through the port against the JAX package, on the CPU.

Every test runs the same statements on a store-backed JAX
``Session(Config(n_segments=1))`` and a store-backed port
``Session(config, device="cpu")``, each on a root of its own
(``torch_parity.store_pair``), and holds them equal: results (ints,
DECIMALs, dates, strings and NULL masks exactly, floats as
``torch_parity.assert_same`` states), status texts, prune reports
(candidates, min/max, bloom and dynamic skips, scan capacity) and the
columns each scan reads. The cases follow the JAX package's
test_storage_scan.py, test_partitioning.py, test_sreh.py and
test_storage.py, without the transaction cases (the port's store runs in
autocommit mode).
"""

import os
import threading

import numpy as np
import pytest

import cloudberry_tpu as cb
from cloudberry_tpu.storage import micropartition as jmp
from cloudberry_tpu_torch import Config as TorchConfig
from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch.exec import executor as X
from cloudberry_tpu_torch.lifecycle import StorageCorruptionError
from cloudberry_tpu_torch.plan import nodes as N
from cloudberry_tpu_torch.plan import planner as TP
from cloudberry_tpu_torch.storage import micropartition as tmp_
from torch_parity import assert_same, plan_scans, store_pair


def _mk_store(tmp_path, rpp=50):
    p = store_pair(tmp_path, rpp)
    p.sql("create table t (a bigint, b bigint, c text, d double) "
          "distributed by (a)")
    rows = ",".join(f"({i}, {i * 10}, '{'xyz'[i % 3]}', {i}.5)"
                    for i in range(200))
    p.sql(f"insert into t values {rows}")
    return p


def _reports(p, sql):
    """(prune report, partition count, capacity) of every scan, both
    engines — equal by assertion."""
    out = []
    for s in (p.js, p.ts):
        out.append([(dict(sc._prune_report), len(sc._store_parts),
                     sc.capacity, sc.num_rows)
                    for sc in plan_scans(s, sql)
                    if hasattr(sc, "_store_parts")])
    assert out[0] == out[1], out
    return out[1]


def test_durability_across_sessions(tmp_path):
    p = _mk_store(tmp_path).reopen()
    for s in (p.js, p.ts):
        t = s.catalog.table("t")
        assert t.cold and t.num_rows == 200
    p.sql("select count(*) as n from t")
    p.sql("select c, count(*) as n, sum(b) as sb, avg(d) as ad from t "
          "group by c order by c")
    assert p.ts.catalog.table("t").cold  # queries never materialized it


@pytest.mark.parametrize("sql, expect", [
    ("select b from t where a >= 150 order by b",
     {"candidates": 4, "skipped_minmax": 3, "skipped_bloom": 0}),
    ("select b from t where a > 49 and a < 100 order by b",
     {"candidates": 4, "skipped_minmax": 3, "skipped_bloom": 0}),
    ("select count(*) as n from t where d < 10.0",
     {"candidates": 4, "skipped_minmax": 3, "skipped_bloom": 0}),
    ("select count(*) as n from t",
     {"candidates": 4, "skipped_minmax": 0, "skipped_bloom": 0}),
])
def test_minmax_prune_reports_match(tmp_path, sql, expect):
    p = _mk_store(tmp_path).reopen()
    (rep, nparts, cap, rows), = _reports(p, sql)
    assert rep == expect
    assert nparts == 4 - expect["skipped_minmax"] and cap == rows
    p.sql(sql)


def test_bloom_prune_report_matches(tmp_path):
    # interleaved values: every partition's [min,max] covers the range, so
    # only the bloom can exclude files for a point predicate
    p = store_pair(tmp_path)
    p.sql("create table t (a bigint, b bigint) distributed by (a)")
    vals = list(range(0, 1000, 7)) + list(range(3, 1000, 11))
    p.sql("insert into t values " +
          ",".join(f"({v}, {v * 2})" for v in vals))
    p = p.reopen()
    (rep, _, cap, _), = _reports(p, "select b from t where a = 700")
    assert rep["skipped_bloom"] >= 1
    got, _ = p.sql("select b from t where a = 700")
    assert got.decoded_columns()["b"].tolist() == [1400]


def test_subquery_cold_scan_is_pruned(tmp_path):
    p = _mk_store(tmp_path).reopen()
    q = ("select count(*) as n from t "
         "where b > (select max(b) from t where a < 50)")
    got, _ = p.sql(q)
    assert got.decoded_columns()["n"].tolist() == [150]
    assert p.ts.catalog.table("t").cold


def _spy(monkeypatch, module):
    log = []
    orig = module.read_columns

    def spy(path, names=None, footer=None, **kw):
        log.append(sorted(names) if names is not None else None)
        return orig(path, names, footer, **kw)

    monkeypatch.setattr(module, "read_columns", spy)
    return log


def test_column_projection_reads_only_referenced(tmp_path, monkeypatch):
    p = _mk_store(tmp_path).reopen()
    jlog, tlog = _spy(monkeypatch, jmp), _spy(monkeypatch, tmp_)
    p.sql("select b from t where a >= 150 order by b")
    assert tlog and tlog == jlog
    assert all(names == ["a", "b"] for names in tlog), tlog


def test_nulls_in_a_cold_scan(tmp_path):
    p = store_pair(tmp_path)
    p.sql("create table t (a int, b int, s text) distributed by (a)")
    p.sql("insert into t values (1, 10, 'x'), (2, null, null), "
          "(3, 30, 'y')")
    p = p.reopen()
    assert p.ts.catalog.table("t").cold
    p.sql("select a from t where b is null")
    p.sql("select sum(b) as s, count(b) as c, count(s) as cs from t")
    p.sql("select a, b, s from t order by a")


def test_cold_insert_update_delete(tmp_path):
    p = _mk_store(tmp_path).reopen()
    p.sql("insert into t values (500, 5000, 'w', 0.5)")
    p.sql("update t set b = -1 where a = 0")
    p.sql("delete from t where a = 1")
    p = p.reopen()
    p.sql("select count(*) as n, min(b) as mb from t")
    p.sql("select a, b, c, d from t order by a")


def test_ctas_and_insert_select_persist(tmp_path):
    p = _mk_store(tmp_path)
    p.sql("create table t2 as select a, b, c from t where a < 10 "
          "distributed by (a)")
    p.sql("insert into t2 select a + 1000, b, c from t where a >= 190")
    p = p.reopen()
    assert p.ts.catalog.table("t2").cold
    p.sql("select a, b, c from t2 order by a")


def test_copy_to_and_from_a_cold_table(tmp_path):
    p = _mk_store(tmp_path).reopen()
    out = {}
    for name, s in (("jax", p.js), ("port", p.ts)):
        path = tmp_path / f"{name}.csv"
        assert s.sql(f"copy t to '{path}'") == "COPY 200"
        out[name] = path
    assert out["jax"].read_text() == out["port"].read_text()
    assert len(out["port"].read_text().splitlines()) == 200
    p.sql("create table back (a bigint, b bigint, c text, d double)")
    want = p.js.sql(f"copy back from '{out['jax']}'")
    assert p.ts.sql(f"copy back from '{out['port']}'") == want
    p.reopen().sql("select a, b, c, d from back order by a")


GOOD_AND_BAD = ("1|10.50|aa\n"
                "oops|20.00|bb\n"      # bad int
                "3|not-a-num|cc\n"     # bad decimal
                "4|40.25|dd\n"
                "5|50.00\n"            # short row
                "6|60.75|ff\n")


def test_copy_log_errors_rejects(tmp_path):
    p = store_pair(tmp_path)
    p.sql("create table ld (k bigint, amt decimal(8,2), name text)")
    path = tmp_path / "in.csv"
    path.write_text(GOOD_AND_BAD)
    got, _ = p.sql(f"copy ld from '{path}' with segment reject limit 5 "
                   "log errors")
    assert got == "COPY 3 (rejected 3 rows)"
    assert p.ts.copy_errors == p.js.copy_errors
    assert {e["line"] for e in p.ts.copy_errors["ld"]} == {2, 3, 5}
    with pytest.raises(Exception, match="reject limit"):
        p.ts.sql(f"copy ld from '{path}' with segment reject limit 3")
    with pytest.raises(Exception, match="PERCENT"):
        p.ts.sql(f"copy ld from '{path}' with segment reject limit 40 "
                 "percent")
    p = p.reopen()
    p.sql("select k, amt, name from ld order by k")


def test_zero_row_append_is_not_a_duplication(tmp_path):
    p = _mk_store(tmp_path)
    p.sql("create table e (a bigint, b bigint) distributed by (a)")
    p.sql("insert into e values (1, 2)")
    empty = tmp_path / "empty.csv"
    empty.write_text("")
    p.sql(f"copy e from '{empty}'")
    got, _ = p.reopen().sql("select count(*) as n from e")
    assert got.decoded_columns()["n"].tolist() == [1]


def test_insert_appends_one_partition(tmp_path):
    p = _mk_store(tmp_path)
    p.sql("insert into t values (1000, 1, 'x', 0.1)")
    counts = [len(s.store.read_manifest("t")["partitions"])
              for s in (p.js, p.ts)]
    assert counts == [5, 5]


def test_unique_and_not_null_survive_cold_registration(tmp_path):
    p = _mk_store(tmp_path)
    p.sql("create table nn (a bigint not null, b bigint) "
          "distributed by (a)")
    p.sql("insert into nn values (1, 2)")
    p = p.reopen()
    for s in (p.js, p.ts):
        t = s.catalog.table("t")
        assert t.cold and t.is_unique("a") is True
        assert t.is_unique("c") is False
    for s in (p.js, p.ts):
        with pytest.raises(Exception, match="NOT NULL"):
            s.sql("insert into nn values (null, 3)")


def test_drop_table_removes_files(tmp_path):
    p = _mk_store(tmp_path)
    root = p.ts.config.storage.root
    assert os.path.isdir(os.path.join(root, "t"))
    p.sql("drop table t")
    assert not os.path.isdir(os.path.join(root, "t"))
    with pytest.raises(KeyError):
        p.reopen().ts.sql("select * from t")


def test_sequences_share_the_store_number_line(tmp_path):
    p = store_pair(tmp_path)
    p.sql("create sequence sq start 10 increment 5")
    q = p.reopen()
    p.sql("select nextval('sq') as v")
    q.sql("select nextval('sq') as v")
    got, _ = p.sql("select nextval('sq') as v")
    assert got.decoded_columns()["v"].tolist() == [20]


# ------------------------------------------------------------ PARTITION BY


def _mk_fact(p, n=3000):
    p.sql("create table fact (k bigint, d bigint, v bigint) "
          "partition by range (d) (start 0 end 100 every 10)")
    rng = np.random.default_rng(11)
    rows = ", ".join(
        f"({int(rng.integers(0, 50))}, {int(rng.integers(0, 100))}, {i})"
        for i in range(n))
    p.sql(f"insert into fact values {rows}")


def test_partition_spec_and_static_elimination(tmp_path):
    p = store_pair(tmp_path, rpp=1 << 16)
    _mk_fact(p)
    p = p.reopen()
    for s in (p.js, p.ts):
        assert s.catalog.table("fact").partition_spec == \
            ("range", "d", 0, 100, 10)
    j = [pt["pkey"] for pt in p.js.store.read_manifest("fact")["partitions"]]
    t = [pt["pkey"] for pt in p.ts.store.read_manifest("fact")["partitions"]]
    assert j == t and len(t) == 10
    q = "select count(*) as c, sum(v) as s from fact where d >= 20 and d < 30"
    (rep, nparts, _, _), = _reports(p, q)
    assert nparts == 1 and rep["skipped_minmax"] == 9
    assert "parts 1/10" in p.ts.explain(q)
    p.sql(q)


def test_list_partitioning_and_default_partition(tmp_path):
    p = store_pair(tmp_path, rpp=1 << 16)
    p.sql("create table lp (r bigint, v bigint) partition by list (r)")
    p.sql("insert into lp values " +
          ", ".join(f"({i % 4}, {i})" for i in range(400)))
    p.sql("create table dr (d bigint) "
          "partition by range (d) (start 0 end 10 every 5)")
    p.sql("insert into dr values (1), (7), (99), (-3)")
    p = p.reopen()
    assert sorted(pt["pkey"] for pt in
                  p.ts.store.read_manifest("dr")["partitions"]) == \
        ["default", "r0", "r5"]
    _reports(p, "select count(*) as c from lp where r = 2")
    p.sql("select count(*) as c from lp where r = 2")
    p.sql("select d from dr order by d")


def test_dynamic_partition_elimination(tmp_path):
    p = store_pair(tmp_path, rpp=1 << 16)
    _mk_fact(p)
    p.sql("create table dim (d bigint, tag bigint)")
    p.sql("insert into dim values (3, 1), (17, 1), (42, 2)")
    p = p.reopen()
    q = ("select count(*) as c, sum(v) as s from fact, dim "
         "where fact.d = dim.d and dim.tag = 1")
    reps = _reports(p, q)
    fact = [r for r in reps if r[0]["candidates"] == 10]
    assert fact[0][0]["skipped_dynamic"] == 8
    assert "partition-selector-skip 8" in p.ts.explain(q)
    p.sql(q)
    # a LEFT join keeps unmatched probe rows: no selector
    q = "select count(*) as c from fact left join dim on fact.d = dim.d"
    assert "partition-selector-skip" not in p.ts.explain(q)
    p.sql(q)


def test_partitioned_results_match_unpartitioned(tmp_path):
    p = store_pair(tmp_path, rpp=1 << 16)
    _mk_fact(p)
    p.sql("create table flat (k bigint, d bigint, v bigint)")
    p.sql("insert into flat select k, d, v from fact")
    p = p.reopen()
    a, _ = p.sql("select d, sum(v) as s from fact where d < 37 "
                 "group by d order by d")
    b, _ = p.sql("select d, sum(v) as s from flat where d < 37 "
                 "group by d order by d")
    assert_same(a, b)


# ------------------------------------------------------ corruption, caches


def _corrupt_one_blob(root, table, col):
    tdir = os.path.join(root, table)
    name = sorted(f for f in os.listdir(tdir) if f.endswith(".cbmp"))[0]
    path = os.path.join(tdir, name)
    footer = tmp_.read_footer(path)
    enc = next(c for c in footer["columns"] if c["name"] == col)
    with open(path, "r+b") as fh:
        fh.seek(enc["offset"] + enc["length"] // 2)
        b = fh.read(1)
        fh.seek(enc["offset"] + enc["length"] // 2)
        fh.write(bytes([b[0] ^ 0xFF]))


def test_checksum_mismatch_raises(tmp_path):
    p = _mk_store(tmp_path)
    for s in (p.js, p.ts):
        _corrupt_one_blob(s.config.storage.root, "t", "b")
    p = p.reopen()
    with pytest.raises(Exception) as jerr:
        p.js.sql("select sum(b) as s from t")
    with pytest.raises(StorageCorruptionError):
        p.ts.sql("select sum(b) as s from t")
    assert type(jerr.value).__name__ == "StorageCorruptionError"


def test_store_scan_cache_is_lru(monkeypatch):
    """Scan-cache eviction is LRU, not FIFO: a hit moves the entry to
    most-recently-used (exec/executor.py _load_store_scan)."""

    class FakeStore:
        def __init__(self):
            self.reads = []

        def effective_version(self, name):
            return 1

        def read_partitions(self, name, parts, cols):
            self.reads.append(name)
            return {c: np.zeros(4) for c in cols}, {}

    class Holder:
        pass

    sess = Holder()
    sess.config = TorchConfig()
    sess._store_scan_cache = {}
    sess._store_scan_lock = threading.Lock()
    sess.catalog = Holder()
    sess.catalog.store = FakeStore()
    sess.device = "cpu"

    def scan(name):
        s = N.PScan(name, {"c": "c"}, 4)
        s._store_parts = [{"file": f"{name}.part"}]
        return s

    monkeypatch.setattr(X, "_STORE_SCAN_CACHE_MAX", 2)
    X._load_store_scan(scan("hot"), sess)    # miss
    X._load_store_scan(scan("one"), sess)    # miss — cache full
    X._load_store_scan(scan("hot"), sess)    # hit: hot becomes MRU
    X._load_store_scan(scan("two"), sess)    # miss: evicts "one", not "hot"
    X._load_store_scan(scan("hot"), sess)    # must still be a hit
    assert sess.catalog.store.reads == ["hot", "one", "two"]


def test_sync_store_drops_stale_device_copies_and_scans(tmp_path):
    """Another session's write moves a cold table's store version: the
    reader drops the table's device copy and its store-scan cache
    entries with the old version, and reads the new rows."""
    p = _mk_store(tmp_path).reopen()
    reader, writer = p.ts, TorchSession(p.tcfg, device="cpu")
    reader.sql("select sum(b) as s from t where a < 100")
    assert reader._store_scan_cache
    reader.device_table("t")                     # loads t whole
    assert "t" in reader._device_tables
    writer.sql("update t set b = b + 1 where a < 10")
    got = reader.sql("select sum(b) as s from t where a < 100")
    assert got.decoded_columns()["s"].tolist() == [49500 + 10]
    assert "t" not in reader._device_tables
    v = reader.store.current_version("t")
    assert all(k[1] == v for k in reader._store_scan_cache)


def test_eval_aligned_keeps_canonical_order(tmp_path):
    """DML's read path (``_eval_aligned``) over a cold multi-partition
    table returns rows in the table's canonical order — part order —
    with a pruned scan of another cold table beside it, so an UPDATE
    writes each value to its own row."""
    p = _mk_store(tmp_path, rpp=37)
    p.sql("create table u (x bigint)")
    p.sql("insert into u values " + ",".join(f"({i})" for i in range(90)))
    p = p.reopen()
    from cloudberry_tpu_torch.sql.parser import parse_sql

    items = parse_sql("select a, b + (select max(x) from u where x < 40) "
                      "as b2 from t").items
    assert p.ts.catalog.table("t").cold and p.ts.catalog.table("u").cold
    cols, _, _ = TP._eval_aligned(p.ts, "t", items)
    t = p.ts.catalog.table("t")
    t.ensure_loaded()
    np.testing.assert_array_equal(cols["a"], t.data["a"])
    np.testing.assert_array_equal(cols["b2"], t.data["b"] + 39)
    p.sql("update t set b = b + (select max(x) from u where x < 40) "
          "where a > 20")
    p.reopen().sql("select a, b from t order by a")


def test_port_reads_a_store_the_jax_package_wrote(tmp_path):
    """The micro-partition format is a copy: a store the JAX package
    wrote opens cold in the port and gives the same results."""
    jcfg = cb.config.Config(n_segments=1).with_overrides(**{
        "storage.root": str(tmp_path / "shared"),
        "storage.rows_per_partition": 64, "sched.generic_plans": False})
    js = cb.Session(jcfg)
    js.sql("create table m (k bigint, p decimal(12,2), s text, d date, "
           "f double, n int)")
    rows = ",".join(
        f"({i}, {i * 3}.25, '{'abc'[i % 3]}{i % 7}', "
        f"date '1995-01-{1 + i % 28:02d}', {i / 7}, "
        f"{'null' if i % 5 == 0 else i})" for i in range(300))
    js.sql(f"insert into m values {rows}")
    js = cb.Session(jcfg)
    ts = TorchSession(TorchConfig().with_overrides(**{
        "storage.root": str(tmp_path / "shared"),
        "storage.rows_per_partition": 64}), device="cpu")
    assert ts.catalog.table("m").cold
    for q in ("select k, p, s, d, f, n from m order by k",
              "select s, sum(p) as sp, count(n) as cn, avg(f) as af from m "
              "where d >= date '1995-01-10' group by s order by s",
              "select k from m where k = 123"):
        assert_same(ts.sql(q), js.sql(q))


def test_encrypted_store_matches(tmp_path):
    pytest.importorskip("cryptography")
    p = store_pair(tmp_path, **{"storage.encryption_key": "k3y"})
    p.sql("create table t (a bigint, s text)")
    p.sql("insert into t values (1, 'x'), (2, 'y'), (3, null)")
    p = p.reopen()
    p.sql("select a, s from t order by a")
    with pytest.raises(Exception):
        TorchSession(TorchConfig().with_overrides(**{
            "storage.root": p.tcfg.storage.root}), device="cpu").sql(
            "select * from t")
