"""The port's streaming ingest plane (storage/ingest.py and the wire
``append`` verb) against the JAX package's: the flush renders the same
INSERT texts, wire appends equal the INSERT sequence bit for bit on both
transports, a full buffer refuses with the retryable IngestQueueFull, a
fault at ``ingest_flush`` fails the whole batch, ``stop`` flushes what is
buffered, a deadline times an append out, and ``meta "ingest"`` and the
buffer gauge report the buffers. Mirrors tests/test_ingest.py but for its
serve-bench smoke."""

import threading
import time

import numpy as np
import pytest

from torch_parity import twin, twin_servers

TIMEOUT = 60


@pytest.fixture(autouse=True)
def _clean_faults():
    from cloudberry_tpu.utils import faultinject as JF
    from cloudberry_tpu_torch.utils import faultinject as TF

    JF.reset_fault()
    TF.reset_fault()
    yield
    JF.reset_fault()
    TF.reset_fault()


def _store_session(e, root="store", **ov):
    over = {"storage.root": e.root(root), "storage.rows_per_partition": 256,
            "ingest.flush_rows": 8, "ingest.flush_ms": 10.0}
    over.update(ov)
    s = e.session(**over)
    s.sql("create table ev (k bigint, v bigint)")
    s.catalog.table("ev").set_data({
        "k": np.arange(16, dtype=np.int64),
        "v": np.arange(16, dtype=np.int64) * 3}, {})
    return s


def _buffered(ing, rows):
    """Wait until ``rows`` rows sit in the service's buffers."""
    deadline = time.monotonic() + TIMEOUT
    while ing.snapshot()["buffered_rows"] < rows \
            and time.monotonic() < deadline:
        time.sleep(0.001)


def _count(s, where):
    return int(s.sql(f"select count(*) as c from ev where {where}")
               .decoded_columns()["c"][0])


def test_render_and_validation(tmp_path):
    """The flush statement is the identity on literal text (ints, float
    reprs, quoted strings, NULL, booleans), and bad names, empty or
    ragged rows are refused before anything buffers."""
    def run(e):
        I = e.mod("storage.ingest")
        e.keep(I.render_insert("t", ("k", "s"),
                               [[1, "it's"], [None, "x"], [True, "y"]]))
        e.keep(I.render_insert("t", None, [[1.5, False, -3, 0.1]]))
        e.error(I.render_insert, "t", None, [[object()]])
        ing = I.IngestService(_store_session(e))
        for args in (("ev; drop table ev", [[1, 2]]), ("ev", []),
                     ("ev", [[1, 2], [3]])):
            e.error(ing.append, *args)
        e.error(ing.append, "ev", [[1, 2]], columns=["k", "v; --"])
        ing.stop()
    got = twin(run, tmp_path)
    assert got[0] == ("INSERT INTO t (k, s) VALUES "
                      "(1, 'it''s'), (NULL, 'x'), (TRUE, 'y')")


@pytest.mark.parametrize("threaded", [True, False],
                         ids=["threaded", "async"])
def test_wire_append_equals_the_insert_sequence(tmp_path, threaded):
    """The same rows through the append verb and as hand-written INSERTs
    give bit-identical tables — mixed types, NULLs, explicit column
    lists, quotes, floats — and the same responses in both engines."""
    rows = [[i, i * 0.25, f"n'{i}", i % 2 == 0] for i in range(23)]

    def run(e):
        srv = e.server(config=e.config(**{
            "storage.root": e.root(), "serve.threaded": threaded,
            "storage.rows_per_partition": 64,
            "ingest.flush_rows": 4, "ingest.flush_ms": 5.0}),
            auth_token="t")
        c = e.client(srv, token="t", timeout=TIMEOUT)
        for name in ("a", "b"):
            e.wire(c.sql, f"create table {name} (k bigint, v double, "
                          "s text, f boolean)")
        for i, r in enumerate(rows):
            cols = ["k", "v", "s", "f"] if i % 3 == 0 else None
            e.wire(c.append, "a", [r], columns=cols)
        e.wire(c.append, "a", [[99, None, None, None]])
        for i, r in enumerate(rows):
            cols = " (k, v, s, f)" if i % 3 == 0 else ""
            lit = (f"({r[0]}, {r[1]!r}, '{r[2]}'".replace("n'", "n''")
                   + f", {'TRUE' if r[3] else 'FALSE'})")
            e.wire(c.sql, f"INSERT INTO b{cols} VALUES {lit}")
        e.wire(c.sql, "INSERT INTO b VALUES (99, NULL, NULL, NULL)")
        a = e.wire(c.sql, "select k, v, s, f from a order by k, v")
        b = e.wire(c.sql, "select k, v, s, f from b order by k, v")
        assert a == b
        snap = c.meta("ingest")
        e.keep((snap["enabled"], snap["rows"], snap["appends"],
                snap["buffered_rows"], snap["flushes"] >= 1))
        e.keep(sorted(snap))
    got = twin_servers(run, tmp_path)
    assert got[-2] == (True, 24, 24, 0, True)


def test_group_commit_and_size_threshold(tmp_path):
    """Eight concurrent appenders commit in fewer flushes than appends,
    every row durable at its appender's return; a buffer at flush_rows
    flushes at once however long the age window."""
    def run(e):
        I = e.mod("storage.ingest")
        s = _store_session(e, **{"ingest.flush_rows": 64,
                                 "ingest.flush_ms": 20.0})
        ing = I.IngestService(s)
        errs = []

        def feed(base):
            try:
                for j in range(10):
                    ing.append("ev", [[10_000 + base * 100 + j, base]])
            except BaseException as ex:  # noqa: BLE001 — reported below
                errs.append(repr(ex))

        threads = [threading.Thread(target=feed, args=(i,))
                   for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=TIMEOUT)
        ing.stop()
        log = s.stmt_log
        e.keep(errs)
        e.keep((log.counter("ingest_rows"), log.counter("ingest_appends"),
                0 < log.counter("ingest_flushes") < 80))
        e.keep(_count(s, "k >= 10000"))
        s2 = _store_session(e, "thr", **{"ingest.flush_rows": 4,
                                         "ingest.flush_ms": 10_000.0})
        ing2 = I.IngestService(s2)
        t0 = time.monotonic()
        e.keep(ing2.append("ev", [[100 + i, i] for i in range(8)]))
        e.keep(time.monotonic() - t0 < 5.0)
        ing2.stop()
        e.keep(_count(s2, "k >= 100"))
    got = twin(run, tmp_path)
    assert got[:3] == [[], (80, 80, True), 80]
    assert got[3:] == [8, True, 8]


def test_ingest_queue_full_is_retryable(tmp_path):
    """A buffer at max_buffered_rows refuses with IngestQueueFull
    (retryable, counted); the retry after the flush drained it lands."""
    def run(e):
        I, lc = e.mod("storage.ingest"), e.mod("lifecycle")
        # the buffered rows age for a second before their flush: the
        # second append meets a full buffer, however loaded the machine
        s = _store_session(e, **{"ingest.max_buffered_rows": 4,
                                 "ingest.flush_rows": 100,
                                 "ingest.flush_ms": 1000.0})
        ing = I.IngestService(s)
        bg = threading.Thread(target=lambda: ing.append(
            "ev", [[200 + i, 0] for i in range(4)]))
        bg.start()
        _buffered(ing, 4)
        try:
            ing.append("ev", [[300, 0]])
            e.keep("accepted")
        except lc.IngestQueueFull as ex:
            e.keep(("IngestQueueFull", lc.is_retryable(ex)))
        e.keep(s.stmt_log.counter("ingest_queue_full"))
        bg.join(timeout=TIMEOUT)
        e.keep(ing.append("ev", [[300, 0]]))
        ing.stop()
        e.keep(_count(s, "k >= 200"))
    got = twin(run, tmp_path)
    assert got == [("IngestQueueFull", True), 1, 1, 5]


def test_flush_fault_fails_the_whole_batch_then_retry_lands(tmp_path):
    """An armed ``ingest_flush`` error fails the batch before any
    statement commits: the appender sees it, nothing partial is durable,
    the retry commits."""
    def run(e):
        I, FI = e.mod("storage.ingest"), e.mod("utils.faultinject")
        s = _store_session(e)
        ing = I.IngestService(s)
        FI.inject_fault("ingest_flush", "error", start_hit=1, end_hit=1)
        e.error(ing.append, "ev", [[400 + i, i] for i in range(10)])
        e.keep(_count(s, "k >= 400"))
        e.keep(s.stmt_log.counter("ingest_flush_errors"))
        e.keep(ing.append("ev", [[400 + i, i] for i in range(10)]))
        ing.stop()
        e.keep(_count(s, "k >= 400"))
    got = twin(run, tmp_path)
    assert got[0][0] == "InjectedFault" and got[1:] == [0, 1, 10, 10]


def test_stop_flushes_buffered_rows_and_deadline(tmp_path):
    """``stop`` commits the buffered rows of a blocked appender, then
    refuses with ServerDraining; an append whose flush outlives its
    deadline raises StatementTimeout."""
    def run(e):
        I, FI = e.mod("storage.ingest"), e.mod("utils.faultinject")
        s = _store_session(e, **{"ingest.flush_rows": 1000,
                                 "ingest.flush_ms": 60_000.0})
        ing = I.IngestService(s)
        done = []
        bg = threading.Thread(target=lambda: done.append(
            ing.append("ev", [[500 + i, i] for i in range(6)])))
        bg.start()
        _buffered(ing, 6)
        ing.stop()
        bg.join(timeout=TIMEOUT)
        e.keep(done)
        e.keep(_count(s, "k >= 500"))
        e.error(ing.append, "ev", [[600, 0]])
        ing2 = I.IngestService(s)
        FI.inject_fault("ingest_flush", "sleep", sleep_s=2.0)
        bg = threading.Thread(target=_swallow, args=(
            lambda: ing2.append("ev", [[700 + i, 0] for i in range(8)],
                                deadline_s=1.0),))
        bg.start()
        e.error(ing2.append, "ev", [[699, 0]], deadline_s=0.1)
        FI.reset_fault()
        bg.join(timeout=TIMEOUT)
        ing2.stop()
    got = twin(run, tmp_path)
    assert got[0] == [6] and got[1] == 6
    assert got[2][0] == "ServerDraining"
    assert got[3][0] == "StatementTimeout"


def _swallow(fn):
    try:
        fn()
    except BaseException:  # noqa: BLE001 — the other appender's verdict
        pass


def test_drain_flushes_appends_through_the_server(tmp_path, monkeypatch):
    """A server draining with an append blocked on its age window flushes
    it on stop, and the append verb refuses new work with the retryable
    drain error. The port also answers the released appender before its
    sockets close (ROADMAP C 63): its reply is held back 0.5 s here (the
    event loop's response write, once the drain begins), which the port
    waits for and the JAX package's stop does not, so only the port's ack
    is checked; both engines' durable rows and refusals are equal."""
    from cloudberry_tpu_torch.serve import asyncore as TA

    complete = TA.AsyncFrontEnd._complete

    def late_complete(fe, conn, resp):
        if fe.server._draining:
            time.sleep(0.5)
        complete(fe, conn, resp)

    monkeypatch.setattr(TA.AsyncFrontEnd, "_complete", late_complete)
    acks = {}

    def run(e):
        srv = e.server(config=e.config(**{
            "storage.root": e.root(), "ingest.flush_rows": 1000,
            "ingest.flush_ms": 60_000.0}))
        c = e.client(srv, timeout=TIMEOUT)
        e.wire(c.sql, "create table z (k bigint)")
        late = e.client(srv, timeout=TIMEOUT)
        out = acks.setdefault(e.pkg, [])

        def append():
            try:
                out.append(e.mod("serve.client").Client(
                    srv.host, srv.port, timeout=TIMEOUT)
                    .append("z", [[1], [2], [3]]))
            except Exception as err:  # noqa: BLE001 — kept for the assert
                out.append(repr(err))

        bg = threading.Thread(target=append)
        bg.start()
        _buffered(srv.ingest, 3)
        srv._draining = True
        e.wire(late.append, "z", [[4]])
        srv.stop(drain_s=0.3)
        bg.join(timeout=TIMEOUT)
        assert not bg.is_alive()
        s = e.session(**{"storage.root": e.root()})
        e.keep(s.sql("select k from z order by k")
               .decoded_columns()["k"].tolist())
    got = twin_servers(run, tmp_path)
    assert got[1][:3] == ("ServerError", "ServerDraining", True)
    assert acks["cloudberry_tpu_torch"] == [3]
    assert got[2] == [1, 2, 3]


def test_meta_ingest_and_the_buffer_gauge(tmp_path):
    """``meta "ingest"`` answers disabled without a service, then the
    buffer's table and rows while an appender waits, and the capacity
    plane's ``mem_ingest_buffer_bytes`` gauge counts the buffered rows."""
    def run(e):
        I = e.mod("storage.ingest")
        describe = e.mod("serve.meta").describe
        capacity = e.mod("obs.capacity")
        s = _store_session(e, **{"ingest.flush_rows": 1000,
                                 "ingest.flush_ms": 60_000.0})
        e.keep(describe(s, "ingest"))
        ing = I.IngestService(s)
        s._ingest = ing
        bg = threading.Thread(target=lambda: ing.append(
            "ev", [[800, 1], [801, 2]]))
        bg.start()
        _buffered(ing, 2)
        snap = describe(s, "ingest")
        e.keep((snap["enabled"], snap["buffered_rows"],
                snap["buffers"][0]["table"], sorted(snap)))
        e.keep(capacity.refresh_gauges(s)["mem_ingest_buffer_bytes"])
        ing.stop()
        bg.join(timeout=TIMEOUT)
        snap = describe(s, "ingest")
        e.keep((snap["draining"], snap["buffered_rows"],
                snap["flush_ms_p95"] >= 0.0))
    got = twin(run, tmp_path)
    assert got[0] == {"enabled": False}
    assert got[1][:3] == (True, 2, "ev") and got[2] > 0
    assert got[3] == (True, 0, True)
