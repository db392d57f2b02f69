"""The port's serving front end against the JAX package's on the same
request streams: a JAX ``Server`` on CPU JAX and a port
``Server(device="cpu")``, each over its own RAM session or store root,
each driven by its own package's ``Client``; every response is held
equal field by field, less statement ids, timings and random tokens
(``torch_parity.twin_servers``). Mirrors tests/test_serve.py,
test_async_serve.py, test_server_txn.py and test_endpoint.py's wire
retrieval."""

import json
import socket
import threading
import time

import pytest
import torch

from torch_parity import twin_servers

# every socket read and thread join here is bounded: a hang fails the
# test instead of eating the suite's time limit
TIMEOUT = 60


def _load(s, n=200):
    s.sql("create table t (a bigint, b bigint, d decimal(10,2), s text, "
          "dt date) distributed by (a)")
    s.sql("insert into t values " + ", ".join(
        f"({i}, {i * 2}, {i}.25, 'n{i % 7}', date '1995-01-{1 + i % 28:02d}')"
        if i % 11 else f"({i}, null, null, null, null)" for i in range(n)))
    return s


@pytest.mark.parametrize("threaded", [False, True],
                         ids=["async", "threaded"])
def test_roundtrip_and_errors_keep_the_connection(threaded):
    """DDL, DML and SELECT over the wire render the same rows (DECIMAL
    as float, dates as ISO text, NULLs as null, dictionary strings), and
    an error answers with the same etype and retryable verdict without
    closing the connection — on both transports."""
    def run(e):
        s = _load(e.session(**{"serve.threaded": threaded,
                               "resource.max_concurrency": 2}))
        srv = e.server(session=s)
        c = e.client(srv, timeout=TIMEOUT)
        e.keep(type(srv._transport).__name__)
        e.wire(c.sql, "create table u (x int, y text) distributed by (x)")
        e.wire(c.sql, "insert into u values (1, 'a'), (2, null)")
        e.wire(c.sql, "select a, b, d, s, dt from t where a < 13 "
                      "order by a")
        e.wire(c.sql, "select s, count(*) as n, sum(d) as sd, "
                      "min(dt) as md from t group by s order by s")
        e.wire(c.sql, "select * from nope")
        e.wire(c.sql, "select nosuchfunc(a) from t")
        e.wire(c.sql, "select x, y from u order by x")
        e.wire(c.sql, "begin")     # one shared session: refused
        e.wire(c.cancel, 424242)
        e.wire(c.meta, "tables")
    got = twin_servers(run)
    assert got[0] == ("_ThreadedTransport" if threaded else "AsyncFrontEnd")
    assert got[3]["rows"][0] == [0, None, None, None, None]
    assert got[3]["rows"][1] == [1, 2, 1.25, "n1", "1995-01-02"]
    assert got[5][1] == "KeyError" and got[5][2] is False
    assert got[8][0] == "ServerError" and "share one session" in got[8][3]


def test_concurrent_clients_pipelined_order_and_admission():
    """Eight clients at once get the same answers in both engines; a
    client that writes ten requests before reading any gets ten answers
    in request order; every statement passed the admission gate."""
    def run(e):
        s = _load(e.session(**{"resource.max_concurrency": 2,
                               "serve.workers": 4}))
        srv = e.server(session=s)
        results, errors = {}, []

        def worker(i):
            try:
                with e.mod("serve.client").Client(
                        srv.host, srv.port, timeout=TIMEOUT) as c:
                    for k in range(3):
                        results[(i, k)] = c.sql(
                            f"select count(*) as n, sum(b) as sb from t "
                            f"where a > {i * 10 + k}")["rows"]
            except Exception as ex:  # noqa: BLE001 — reported below
                errors.append(repr(ex))

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=TIMEOUT)
        e.keep(errors)
        e.keep(sorted(results.items()))
        sock = socket.create_connection((srv.host, srv.port),
                                        timeout=TIMEOUT)
        try:
            sock.sendall(b"".join(
                json.dumps({"sql": f"select b from t where a = {i}"})
                .encode() + b"\n" for i in range(1, 11)))
            f = sock.makefile("rb")
            e.keep([json.loads(f.readline()) for _ in range(10)])
        finally:
            sock.close()
        gate = srv.session._gate
        e.keep(gate.total_admitted >= 24 and gate.peak <= 2)
    got = twin_servers(run)
    assert got[0] == [] and len(got[1]) == 24 and got[3] is True
    assert [r["rows"] for r in got[2]] == [[[i * 2]] for i in range(1, 11)]


def test_connection_cap_server_busy_and_reconnect():
    """Past ``serve.max_connections`` a new connection gets one
    retryable ServerBusy line and closes; a client with ``retry_reads``
    reconnects and succeeds once a slot frees."""
    def run(e):
        s = _load(e.session(**{"serve.max_connections": 1}))
        srv = e.server(session=s)
        blocker = e.client(srv, timeout=TIMEOUT)
        e.wire(blocker.sql, "select count(*) as n from t")
        extra = e.client(srv, timeout=TIMEOUT)
        e.wire(extra.sql, "select count(*) as n from t")

        def free_slot():
            time.sleep(0.15)
            blocker.close()

        th = threading.Thread(target=free_slot)
        th.start()
        c = e.client(srv, timeout=TIMEOUT, retry_reads=True,
                     max_retries=8, backoff_s=0.05)
        e.wire(c.sql, "select count(*) as n from t")
        th.join(timeout=TIMEOUT)
    got = twin_servers(run)
    assert got[1][:3] == ("ServerError", "ServerBusy", True)
    assert got[2] == {"columns": ["n"], "rows": [[200]], "rowcount": 1}


def test_drain_never_drops_an_accepted_request():
    """``stop(drain_s)`` while six clients pound the event-loop server:
    every accepted request gets its answer (a result or the retryable
    ServerDraining), and a request after the drain began is refused
    with it."""
    def run(e):
        s = _load(e.session())
        srv = e.server(session=s)
        Client = e.mod("serve.client").Client
        results, errors, refused = [], [], []
        stop = threading.Event()

        def pound(i):
            try:
                with Client(srv.host, srv.port, timeout=TIMEOUT) as c:
                    while not stop.is_set():
                        try:
                            out = c.sql(f"select b from t where a = {1 + i}")
                            results.append(out["rows"] == [[2 + 2 * i]])
                        except e.ServerError as ex:
                            if ex.etype == "ServerDraining" or str(
                                    ex).startswith("server closed"):
                                refused.append(ex.retryable
                                               or ex.etype is None)
                                return
                            raise
                        except OSError:
                            return  # never accepted: a visible failure
            except Exception as ex:  # noqa: BLE001 — reported below
                errors.append(repr(ex))

        threads = [threading.Thread(target=pound, args=(i,))
                   for i in range(6)]
        for th in threads:
            th.start()
        deadline = time.monotonic() + TIMEOUT
        while len(results) < 6 and time.monotonic() < deadline:
            time.sleep(0.01)
        late = e.client(srv, timeout=TIMEOUT)
        srv._draining = True        # the drain's first step, then stop
        e.wire(late.sql, "select count(*) as n from t")
        srv.stop(drain_s=10.0)
        stop.set()
        for th in threads:
            th.join(timeout=TIMEOUT)
        e.keep(errors)
        e.keep(bool(results) and all(results) and all(refused))
    got = twin_servers(run)
    assert got[0][:3] == ("ServerError", "ServerDraining", True)
    assert got[1] == [] and got[2] is True


def test_auth_and_lockout():
    """A server with ``auth_token``: a bad token is refused and closes;
    repeated failures lock the address out even for the right token."""
    def run(e):
        srv = e.server(session=_load(e.session()), auth_token="hunter2",
                       max_login_failures=2, lockout_s=30.0)
        for _ in range(2):
            e.error(e.mod("serve.client").Client, srv.host, srv.port,
                    token="nope", timeout=TIMEOUT)
        e.error(e.mod("serve.client").Client, srv.host, srv.port,
                token="hunter2", timeout=TIMEOUT)
        ok = e.server(session=_load(e.session()), auth_token="hunter2")
        c = e.client(ok, token="hunter2", timeout=TIMEOUT)
        e.wire(c.sql, "select count(*) as n from t")
    got = twin_servers(run)
    assert "authentication failed" in got[0][1]
    assert "locked" in got[2][1]
    assert got[3]["rows"] == [[200]]


def test_standby_refuses_writes_and_reads_the_primary(tmp_path):
    """A read-only standby over the primary's store serves the
    primary's commits and refuses writes, appends and cron changes with
    the same ReadOnlyError."""
    def run(e):
        cfg = e.config(**{"storage.root": e.root()})
        primary = e.server(config=cfg)
        standby = e.server(config=cfg, read_only=True)
        p = e.client(primary, timeout=TIMEOUT)
        r = e.client(standby, timeout=TIMEOUT)
        e.wire(p.sql, "create table k (x bigint, y text)")
        e.wire(p.sql, "insert into k values (1, 'a'), (2, 'b')")
        e.wire(r.sql, "select x, y from k order by x")
        e.wire(r.sql, "insert into k values (3, 'c')")
        e.wire(r.append, "k", [[4, "d"]])
        e.wire(r._request, {"cron": {"op": "schedule", "name": "j",
                                     "interval_s": 5, "sql": "select 1"}})
        e.wire(p.sql, "insert into k values (5, 'e')")
        e.wire(r.sql, "select count(*) as n from k")
    got = twin_servers(run, tmp_path)
    assert got[2]["rows"] == [[1, "a"], [2, "b"]]
    assert got[3][1] == "ReadOnlyError" and got[4][1] == "ReadOnlyError"
    assert got[7]["rows"] == [[3]]


def test_wire_transactions_occ_conflict_and_merge(tmp_path):
    """Per-connection backends over a store: wire BEGIN/COMMIT ride the
    store's OCC — the first committer wins against a rewrite and the
    loser gets SerializationError; two appending transactions merge; a
    transaction keeps its BEGIN snapshot; ROLLBACK restores it."""
    def run(e):
        srv = e.server(config=e.config(**{"storage.root": e.root()}))
        e.keep(srv.per_connection)
        c1 = e.client(srv, timeout=TIMEOUT)
        c2 = e.client(srv, timeout=TIMEOUT)
        for c, q in ((c1, "create table t (x bigint) distributed by (x)"),
                     (c1, "insert into t values (1)"),
                     (c2, "select count(*) as n from t"),
                     (c1, "begin"), (c2, "begin"),
                     (c1, "insert into t values (2)"),
                     (c2, "update t set x = x * 10 where x = 1"),
                     (c1, "commit"), (c2, "commit"),
                     (c2, "select x from t order by x"),
                     (c1, "begin"), (c2, "begin"),
                     (c1, "insert into t values (4)"),
                     (c2, "insert into t values (5)"),
                     (c1, "commit"), (c2, "commit"),
                     (c1, "select x from t order by x"),
                     (c2, "begin"),
                     (c2, "select count(*) as n from t"),
                     (c1, "insert into t values (6)"),
                     (c2, "select count(*) as n from t"),
                     (c2, "rollback"),
                     (c2, "select count(*) as n from t")):
            e.wire(c.sql, q)
    got = twin_servers(run, tmp_path)
    assert got[0] is True
    assert got[9][:2] == ("ServerError", "SerializationError")
    assert "could not serialize" in got[9][3]
    assert got[10]["rows"] == [[1], [2]]
    assert got[17]["rows"] == [[1], [2], [4], [5]]
    assert got[19]["rows"] == got[21]["rows"] == [[4]]
    assert got[23]["rows"] == [[5]]


@pytest.mark.parametrize("threaded", [False, True],
                         ids=["async", "threaded"])
def test_disconnect_rolls_back_the_open_transaction(tmp_path, threaded):
    """A connection that dies inside BEGIN aborts its transaction (the
    backend-exit rollback), on both transports."""
    def run(e):
        srv = e.server(config=e.config(**{"storage.root": e.root(),
                                          "serve.threaded": threaded}))
        c = e.client(srv, timeout=TIMEOUT)
        e.wire(c.sql, "create table d (x bigint) distributed by (x)")
        e.wire(c.sql, "insert into d values (1)")
        doomed = e.client(srv, timeout=TIMEOUT)
        e.wire(doomed.sql, "begin")
        e.wire(doomed.sql, "insert into d values (7)")
        doomed.close()
        deadline = time.monotonic() + TIMEOUT
        n = None
        while time.monotonic() < deadline:
            with e.mod("serve.client").Client(srv.host, srv.port,
                                              timeout=TIMEOUT) as c3:
                n = c3.rows("select count(*) as n from d")
            if n == [[1]]:
                break
            time.sleep(0.05)
        e.keep(n)
    got = twin_servers(run, tmp_path)
    assert got[-1] == [[1]]


def test_retrieve_verb_with_token():
    """The ``retrieve`` verb drains a parallel retrieve cursor's 8
    endpoints from 8 connections at once; a wrong token is refused."""
    from concurrent.futures import ThreadPoolExecutor

    def run(e):
        s = e.session(n_segments=8)
        s.sql("create table w (k bigint, v bigint) distributed by (k)")
        s.sql("insert into w values " +
              ", ".join(f"({i}, {i * 3})" for i in range(256)))
        srv = e.server(session=s)
        boss = e.client(srv, timeout=TIMEOUT)
        info = boss.sql("declare wc parallel retrieve cursor for "
                        "select k, v from w")
        e.keep(wire_safe_info(info))
        Client = e.mod("serve.client").Client

        def drain(seg):
            with Client(srv.host, srv.port, timeout=TIMEOUT) as c:
                return c.retrieve("wc", seg, info["token"])["rows"]

        with ThreadPoolExecutor(max_workers=8) as ex:
            chunks = list(ex.map(drain, range(8)))
        e.keep([sorted(map(tuple, ch)) for ch in chunks])
        e.wire(boss.retrieve, "wc", 0, "wrong-token")
    got = twin_servers(run)
    assert len(got[0]["endpoints"]) == 8
    assert sorted(r for ch in got[1] for r in ch) == \
        [(i, i * 3) for i in range(256)]
    assert got[2][0] == "ServerError" and "token" in got[2][3]


def wire_safe_info(info):
    from torch_parity import wire_safe

    return wire_safe(info)


def test_server_runs_on_cuda_unless_asked(monkeypatch, tmp_path):
    """``Server()`` builds its session on CUDA and raises without a card,
    like ``Session()``; ``device="cpu"`` runs it (and every backend it
    creates) on the CPU; a device that contradicts a given session is
    refused."""
    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch.serve import Client, Server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Server()
    with pytest.raises(RuntimeError, match="CUDA"):
        Server(device="cuda")
    with pytest.raises(ValueError, match="over a session"):
        Server(session=ct.Session(device="cpu"), device="cuda")
    cfg = ct.Config().with_overrides(**{"storage.root": str(tmp_path)})
    with Server(config=cfg, device="cpu") as srv:
        assert srv.session.device.type == "cpu"
        backend = srv._connection_session()
        assert backend.device.type == "cpu"
        assert backend._gate is srv.session._gate
        assert backend.stmt_log is srv.session.stmt_log
        assert backend._obs_root is srv.session
        with Client(srv.host, srv.port, timeout=TIMEOUT) as c:
            c.sql("create table q (x int)")
            assert c.sql("select count(*) as n from q")["rows"] == [[0]]


def test_backends_share_one_store_scan_cache(tmp_path):
    """Per-connection backends read through the server session's one
    store-scan cache: a scan another connection made is a hit, and the
    cache's LRU holds every backend's copies and the shared pool inside
    ``bufferpool.max_bytes`` together (port-only, ROADMAP C 48)."""
    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch.exec import executor as X
    from cloudberry_tpu_torch.serve import Client, Server

    cfg = ct.Config().with_overrides(**{"storage.root": str(tmp_path)})
    q = "select sum(a) as s, count(*) as n from t where b > 10"
    with Server(config=cfg, device="cpu") as srv:
        assert srv.per_connection
        with Client(srv.host, srv.port, timeout=TIMEOUT) as c:
            _load(c)
            want = c.sql(q)
        # the loading backend holds t in RAM; the next one reads it cold
        # from the store (a miss), and the one after finds that copy
        reg = srv.session.counters
        for n in (1, 2):
            with Client(srv.host, srv.port, timeout=TIMEOUT) as c2:
                assert c2.sql(q) == want
            assert reg.counter("store_scan_cache_misses") == 1
            assert reg.counter("store_scan_cache_hits") == n - 1
        a, b = srv._connection_session(), srv._connection_session()
        assert a._store_scan_cache is b._store_scan_cache \
            is srv.session._store_scan_cache
        assert a._store_scan_lock is srv.session._store_scan_lock
        cache = srv.session._store_scan_cache
        assert cache and sum(X._nbytes(v) for v in cache.values()) \
            <= cfg.bufferpool.max_bytes


def test_port_server_threads_carry_the_port_prefix(tmp_path):
    """Every thread a port server starts — the event loops, the worker
    pool, the watchdog, cron, the dispatcher and the ingest flusher — is
    named ``cbtpu_torch-``, never the JAX package's ``cbtpu-``, whose
    tests assert no such thread outlives them; all of them stop with the
    server."""
    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch.serve import Client, Server

    before = {t.ident for t in threading.enumerate()}
    cfg = ct.Config().with_overrides(**{
        "storage.root": str(tmp_path), "sched.enabled": True,
        "sched.generic_plans": True})
    srv = Server(config=cfg, device="cpu").start()
    try:
        with Client(srv.host, srv.port, timeout=TIMEOUT) as c:
            c.sql("create table q (x bigint)")
            c.append("q", [[1], [2]])
            assert c.sql("select x from q where x = 2")["rows"] == [[2]]
        started = [t for t in threading.enumerate()
                   if t.ident not in before]
        names = sorted(t.name for t in started)
        assert all(n.startswith("cbtpu_torch-") for n in names), names
        for part in ("-io0", "-serve-w0", "-watchdog", "-cron",
                     "-dispatcher", "-ingest-flusher"):
            assert any(n.endswith(part) for n in names), (part, names)
    finally:
        srv.stop()
    deadline = time.monotonic() + TIMEOUT
    while time.monotonic() < deadline and any(
            t.is_alive() for t in started):
        time.sleep(0.05)
    assert not [t.name for t in started if t.is_alive()]
