"""External, foreign and directory tables and CLUSTER through the port
against the JAX package, on the CPU — the cases of ``test_external.py``
(file:// and cbfdist:// sources, single-row error handling), ``test_fdw.py``,
``test_dirtable.py`` and the clustering cases of ``test_stats_hist.py``,
each run in both engines (``torch_parity.twin``) with every result held
equal: integers, DECIMAL and counts exactly, floats to rtol 1e-9, status
texts, errors and pruning reports exactly. The cbfdist source is the
port's scatter file server (serve/fdist.py), started by the test on
localhost; one case holds its bytes equal to the JAX package's server's."""

import hashlib
import sqlite3

import numpy as np
import pytest

from torch_parity import twin


@pytest.fixture
def data_dir(tmp_path):
    (tmp_path / "t.csv").write_text(
        "".join(f"{i}|{i * 10}|n{i % 3}\n" for i in range(100)))
    return tmp_path


@pytest.fixture
def fdist(data_dir):
    from cloudberry_tpu_torch.serve.fdist import serve

    srv, port = serve(str(data_dir))
    yield port
    srv.shutdown()


EXT = "create external table {name} (k bigint, v bigint, name text) " \
      "location('{url}')"


def test_external_table_file_scheme(data_dir):
    def run(e):
        s = e.session()
        e.keep(s.sql(EXT.format(name="fx", url=f"file://{data_dir}/t.csv")))
        e.keep(s.sql("select count(*) as c, sum(v) as s from fx"))
        e.keep(s.sql("select k, v, name from fx order by k"))
    got = twin(run)
    assert got[0] == "CREATE EXTERNAL TABLE fx"
    assert int(got[1].columns["c"][0]) == 100


def test_external_table_cbfdist(data_dir, fdist):
    def run(e):
        s = e.session()
        s.sql(EXT.format(name="ext", url=f"cbfdist://127.0.0.1:{fdist}/t.csv"))
        e.keep(s.sql("select count(*) as c, sum(v) as s from ext"))
        s.sql("create table dim (name text, w bigint)")
        s.sql("insert into dim values ('n0', 1), ('n1', 2), ('n2', 3)")
        e.keep(s.sql("select d.w, count(*) as c from ext e, dim d "
                     "where e.name = d.name group by d.w order by d.w"))
    got = twin(run)
    assert int(got[0].columns["s"][0]) == sum(i * 10 for i in range(100))
    assert got[1].columns["c"].tolist() == [34, 33, 33]


def test_external_table_rereads_source(data_dir, fdist):
    q = "select count(*) as c from ext"

    def run(e):
        (data_dir / "t.csv").write_text(
            "".join(f"{i}|{i * 10}|n{i % 3}\n" for i in range(100)))
        s = e.session()
        s.sql(EXT.format(name="ext", url=f"cbfdist://127.0.0.1:{fdist}/t.csv"))
        e.keep(s.sql(q))
        with open(data_dir / "t.csv", "a") as f:
            f.write("100|1000|n0\n")
        e.keep(s.sql(q))   # the same text sees the new row
    got = twin(run)
    assert [int(g.columns["c"][0]) for g in got] == [100, 101]


def test_external_table_distributed(data_dir, fdist):
    def run(e):
        s = e.session(8)
        s.sql(EXT.format(name="ext", url=f"cbfdist://127.0.0.1:{fdist}/t.csv"))
        e.keep(s.sql("select sum(v) as s from ext"))
        e.keep(s.sql("select name, count(*) as c, sum(k) as sk from ext "
                     "group by name order by name"))
    got = twin(run)
    assert int(got[0].columns["s"][0]) == sum(i * 10 for i in range(100))


def test_unreachable_location_does_not_break_other_queries():
    def run(e):
        s = e.session()
        s.sql("create external table dead (k bigint) "
              "location('cbfdist://127.0.0.1:1/x.csv')")
        s.sql("create table plain (k bigint)")
        s.sql("insert into plain values (1)")
        e.keep(s.sql("select k from plain"))
        e.error(s.sql, "select k from dead")
    got = twin(run)
    assert got[1][0] == "BindError" and "cbfdist fetch failed" in got[1][1]


def test_dml_into_external_rejected(data_dir, fdist):
    def run(e):
        s = e.session()
        s.sql(EXT.format(name="ext", url=f"cbfdist://127.0.0.1:{fdist}/t.csv"))
        e.error(s.sql, "insert into ext values (1, 2, 'x')")
        e.error(s.sql, "cluster ext by (k)")
    got = twin(run)
    assert "external" in got[0][1] and "external" in got[1][1]


def test_fdist_bytes_equal_jax(tmp_path):
    """The port's cbfdist server and the JAX package's serve the same
    bytes: every stripe (segment, nseg) for nseg <= 8, the whole file,
    a file without its final newline, and a 404 for a missing file and
    for a path that climbs out of the root."""
    import urllib.error
    import urllib.request

    from cloudberry_tpu.serve.fdist import serve as jserve
    from cloudberry_tpu_torch.serve.fdist import serve as tserve

    (tmp_path / "t.csv").write_text(
        "".join(f"{i}|{i * 10}|n{i % 3}\n" for i in range(101)))
    (tmp_path / "nt.csv").write_bytes(b"1|10\n2|20\r\n3|30")
    (tmp_path.parent / "secret.txt").write_text("outside the root\n")
    servers = [jserve(str(tmp_path)), tserve(str(tmp_path))]

    def get(port, path):
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/{path}", timeout=30) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, None

    try:
        paths = ["t.csv", "nt.csv", "missing.csv", "../secret.txt",
                 "%2e%2e/secret.txt"]
        paths += [f"{f}?segment={i}&nseg={n}" for f in ("t.csv", "nt.csv")
                  for n in range(1, 9) for i in range(n)]
        for path in paths:
            want, got = (get(port, path) for _, port in servers)
            assert got == want, path
        assert get(servers[1][1], "../secret.txt")[0] == 404
        assert get(servers[1][1], "t.csv?segment=3&nseg=8")[1] == b"".join(
            f"{i}|{i * 10}|n{i % 3}\n".encode() for i in range(3, 101, 8))
    finally:
        for srv, _ in servers:
            srv.shutdown()


def test_no_trailing_newline_never_merges_rows(tmp_path):
    from cloudberry_tpu_torch.serve.fdist import serve

    (tmp_path / "nt.csv").write_bytes(b"1|10\n2|20\n3|30")
    srv, port = serve(str(tmp_path))
    try:
        def run(e):
            s = e.session()
            s.sql(f"create external table nt (k bigint, v bigint) "
                  f"location('cbfdist://127.0.0.1:{port}/nt.csv')")
            e.keep(s.sql("select k, v from nt order by k"))
        got = twin(run)
    finally:
        srv.shutdown()
    assert got[0].columns["v"].tolist() == [10, 20, 30]


def test_copy_external_to_file_sees_current_source(data_dir, fdist):
    def run(e):
        s = e.session()
        s.sql(EXT.format(name="cx", url=f"cbfdist://127.0.0.1:{fdist}/t.csv"))
        out = data_dir / f"out_{e.pkg}.csv"
        e.keep(s.sql(f"copy cx to '{out}'"))
        e.keep(out.read_text())
    got = twin(run)
    assert len(got[1].strip().splitlines()) == 100


def test_file_scheme_missing_is_clean_error(tmp_path):
    def run(e):
        s = e.session()
        s.sql(f"create external table gone (k bigint) "
              f"location('file://{tmp_path}/nope.csv')")
        e.error(s.sql, "select k from gone")
    got = twin(run)
    assert got[0][0] == "BindError" and "cannot read source" in got[0][1]


@pytest.mark.parametrize("scheme", ["cbfdist", "file"])
def test_external_table_sreh(data_dir, fdist, scheme):
    (data_dir / "bad.csv").write_text(
        "1|10|aa\nxx|20|bb\n3|30|cc\n4|x|dd\n5|50|ee\n")
    url = f"cbfdist://127.0.0.1:{fdist}/bad.csv" if scheme == "cbfdist" \
        else f"file://{data_dir}/bad.csv"

    def run(e):
        s = e.session()
        s.sql(f"create external table bx (k bigint, v bigint, name text) "
              f"location('{url}') segment reject limit 5 log errors")
        e.keep(s.sql("select k, v, name from bx order by k"))
        s.sql("select count(*) as c from bx")   # the log is per read
        e.keep(list(map(list, s.copy_errors.get("bx", []))))
        s.sql("create external table tight (k bigint, v bigint, "
              f"name text) location('{url}') segment reject limit 1")
        e.error(s.sql, "select k from tight")
    got = twin(run)
    assert got[0].columns["k"].tolist() == [1, 3, 5]
    assert len(got[1]) == 2


# ------------------------------------------------------------------- FDW


@pytest.fixture
def db(tmp_path):
    path = str(tmp_path / "src.db")
    con = sqlite3.connect(path)
    con.execute("create table emp (id integer, name text, sal real, "
                "hired text)")
    con.executemany("insert into emp values (?,?,?,?)", [
        (1, "ann", 100.5, "2024-01-02"),
        (2, "bob", 90.0, "2023-06-30"),
        (3, None, None, "2022-12-01")])
    con.commit()
    con.close()
    return path


def test_sqlite_foreign_table_scans_and_joins(db):
    def run(e):
        s = e.session()
        e.keep(s.sql(f"""create foreign table femp
                  (id bigint, name text, sal double, hired date)
                  server sqlite options (database '{db}', table 'emp')"""))
        e.keep(s.sql("select id, name, sal, hired from femp order by id"))
        s.sql("create table bonus (id bigint, b bigint)")
        s.sql("insert into bonus values (1, 10), (3, 30)")
        e.keep(s.sql("select f.id, b.b from femp f join bonus b "
                     "on f.id = b.id order by f.id"))
        e.keep(s.sql("select id from femp where hired >= date '2023-01-01' "
                     "order by id"))
    got = twin(run)
    assert got[1].decoded_columns()["name"].tolist() == ["ann", "bob", None]
    assert got[2].columns["b"].tolist() == [10, 30]
    assert got[3].columns["id"].tolist() == [1, 2]


def test_foreign_table_tracks_source(db):
    def run(e):
        con = sqlite3.connect(db)
        con.execute("delete from emp where id = 4")
        con.commit()
        s = e.session()
        s.sql(f"create foreign table ft (id bigint, name text, sal double, "
              f"hired date) server sqlite options (database '{db}', "
              f"table 'emp')")
        e.keep(s.sql("select count(*) as c from ft"))
        con.execute("insert into emp values (4, 'dee', 70.0, '2025-01-01')")
        con.commit()
        con.close()
        e.keep(s.sql("select count(*) as c from ft"))
    got = twin(run)
    assert [int(g.columns["c"][0]) for g in got] == [3, 4]


def test_foreign_query_option(db):
    def run(e):
        s = e.session()
        s.sql(f"""create foreign table top (name text) server sqlite
                  options (database '{db}',
                           query 'select name from emp where sal > 95')""")
        e.keep(s.sql("select name from top"))
    assert twin(run)[0].decoded_columns()["name"].tolist() == ["ann"]


def test_unknown_server_and_bad_source(db, tmp_path):
    def run(e):
        s = e.session()
        e.error(s.sql, "create foreign table x (a int) server nope")
        s.sql(f"create foreign table y (a int) server sqlite "
              f"options (database '{tmp_path}/missing.db', table 'emp')")
        e.error(s.sql, "select * from y")
    got = twin(run)
    assert got[0][0] == "BindError" and "unknown foreign server" in got[0][1]
    assert got[1][0] == "FdwError"


def test_register_custom_provider():
    """register_fdw is the CustomScan-style hook: any callable becomes a
    scannable relation."""
    def run(e):
        e.mod("storage.fdw").register_fdw(
            "range", lambda opts, schema:
            ((i, i * i) for i in range(int(opts.get("n", "5")))))
        s = e.session()
        s.sql("create foreign table sq (i bigint, isq bigint) server range "
              "options (n '4')")
        e.keep(s.sql("select sum(isq) as t from sq where i > 0"))
    assert int(twin(run)[0].columns["t"][0]) == 1 + 4 + 9


# ---------------------------------------------------------- directories


def test_directory_table_upload_query_read(tmp_path):
    def run(e):
        s = e.session(**{"storage.root": e.root()})
        e.keep(s.sql("create directory table docs"))
        e.keep(s.sql("select relative_path, size, md5 from docs"))
        s.dir_upload("docs", "a/report.txt", b"hello world")
        s.dir_upload("docs", "b.bin", b"\x00\x01\x02")
        e.keep(s.sql("select relative_path, size, md5 from docs "
                     "order by relative_path"))
        e.keep(s.dir_read("docs", "a/report.txt"))
        e.keep(s.sql("select count(*) as c from docs where size > 5"))
        s.dir_remove("docs", "b.bin")
        e.keep(s.sql("select relative_path, size, md5 from docs"))
    got = twin(run, tmp_path)
    d = got[2].decoded_columns()
    assert d["relative_path"].tolist() == ["a/report.txt", "b.bin"]
    assert d["md5"][0] == hashlib.md5(b"hello world").hexdigest()
    assert got[3] == b"hello world" and got[5].num_rows() == 1


def test_directory_table_needs_store():
    def run(e):
        e.error(e.session().sql, "create directory table nope")
    got = twin(run)
    assert got[0][0] == "BindError" and "durable storage" in got[0][1]


def test_directory_table_path_safety(tmp_path):
    def run(e):
        s = e.session(**{"storage.root": e.root()})
        s.sql("create directory table dt")
        e.error(s.dir_upload, "dt", "../escape.txt", b"x")
        e.error(s.dir_read, "dt", "missing.txt")
    got = twin(run, tmp_path)
    assert "bad relative path" in got[0][1] and "no file" in got[1][1]


def test_directory_table_tde(tmp_path):
    def run(e):
        s = e.session(**{"storage.root": e.root(),
                         "storage.encryption_key": "k1"})
        s.sql("create directory table sec")
        s.dir_upload("sec", "secret.txt", b"the payload text")
        on_disk = (tmp_path / e.pkg / "store" / "_dirtab" / "sec" /
                   "secret.txt").read_bytes()
        e.keep(b"the payload text" in on_disk)
        e.keep(s.dir_read("sec", "secret.txt"))
        e.keep(s.sql("select md5, size from sec"))
    got = twin(run, tmp_path)
    assert got[0] is False and got[1] == b"the payload text"
    assert got[2].decoded_columns()["md5"][0] == \
        hashlib.md5(b"the payload text").hexdigest()


# ------------------------------------------------------------ clustering


def test_zorder_key_matches_reference():
    from cloudberry_tpu.utils.zorder import zorder_key as jz
    from cloudberry_tpu_torch.utils.zorder import zorder_key as tz

    rng = np.random.default_rng(3)
    for k in (1, 2, 3):
        cols = [rng.integers(0, 1000, 4000) for _ in range(k)]
        np.testing.assert_array_equal(tz(cols), jz(cols))
    x, y = cols[0], cols[1]
    key = tz([x, y])
    assert key[(x < 500) & (y < 500)].max() < key[(x >= 500)
                                                  & (y >= 500)].min()


def test_cluster_sharpens_pruning(tmp_path):
    """Partitions read before and after CLUSTER BY (a, b), for a range on
    either column, equal in both engines, with equal results."""
    def pruned(e, q):
        fresh = e.session(**{"storage.root": e.root(),
                             "planner.autostats": "none"})
        X = e.mod("exec.executor")
        res = e.mod("plan.planner").plan_statement(
            e.mod("sql.parser").parse_sql(q), fresh, {})
        rep = next(iter(X.scans_of(res.plan)))._prune_report
        e.keep((rep["skipped_minmax"], rep["candidates"]))
        e.keep(fresh.sql(q))

    def run(e):
        s = e.session(**{"storage.root": e.root(),
                         "storage.rows_per_partition": 512,
                         "planner.autostats": "none"})
        s.sql("create table zt (a bigint, b bigint, payload bigint)")
        rng = np.random.default_rng(11)
        n = 16384
        s.catalog.table("zt").set_data({
            "a": rng.integers(0, 10_000, n).astype(np.int64),
            "b": rng.integers(0, 10_000, n).astype(np.int64),
            "payload": np.arange(n, dtype=np.int64)})
        qa = "select sum(payload) as sp, count(*) as c from zt " \
             "where a <= 500"
        qb = "select sum(payload) as sp, count(*) as c from zt " \
             "where b <= 500"
        pruned(e, qa)
        e.keep(s.sql("cluster zt by (a, b)"))
        pruned(e, qa)
        pruned(e, qb)
    got = twin(run, tmp_path)
    (skip0, cand), _, status, (skip_a, cand2), after, (skip_b, _), _ = got
    assert cand == cand2 == 32 and skip0 == 0
    assert status == "CLUSTER zt (16384 rows)"
    assert skip_a >= cand2 // 2 and skip_b >= cand2 // 4
    np.testing.assert_array_equal(after.columns["sp"], got[1].columns["sp"])


def test_cluster_rejects_bad_columns():
    def run(e):
        s = e.session()
        s.sql("create table cb1 (x bigint, s text)")
        s.sql("insert into cb1 values (1, 'a')")
        e.error(s.sql, "cluster cb1 by (nope)")
        e.error(s.sql, "cluster cb1 by (s)")
        e.keep(s.sql("cluster cb1 by (x)"))
    got = twin(run)
    assert got[0][0] == got[1][0] == "BindError"
