"""The port's micro-batch dispatcher and stacked launch against the JAX
package's (sched/dispatcher.py, sched/paramplan.py ``run_batch``): the
same request streams give the same results and the same scheduler
counters — ``batch_rung_compiles``, ``fast_rebinds``, ``generic_hits``,
``batched_statements`` and ``dispatches`` — in both engines, with generic
plans on in both (the JAX package's default; the port's is off). Mirrors
tests/test_dispatcher.py but for its serve-bench smoke."""

import threading
import time

import numpy as np
import pytest

from torch_parity import assert_same, twin, twin_servers

TIMEOUT = 60
ROWS = 40_000      # over pointlookup.MIN_ROWS: equality reads point-slice
COUNTERS = ("batch_rung_compiles", "fast_rebinds", "generic_hits",
            "batched_statements", "dispatches")
POINT = "select k, v from pts where k = {}"
RANGE = "select count(*) as n, sum(v) as sv, min(k) as mk from pts " \
        "where k < {} and v > 3"


@pytest.fixture(autouse=True)
def _clean_faults():
    from cloudberry_tpu.utils import faultinject as JF
    from cloudberry_tpu_torch.utils import faultinject as TF

    JF.reset_fault()
    TF.reset_fault()
    yield
    JF.reset_fault()
    TF.reset_fault()


def _session(e, **over):
    s = e.session(**{"sched.generic_plans": True, **over})
    s.sql("create table pts (k bigint, v bigint) distributed by (k)")
    s.catalog.table("pts").set_data({
        "k": np.arange(ROWS, dtype=np.int64),
        "v": (np.arange(ROWS, dtype=np.int64) * 3) % 997}, {})
    return s


def _counters(s):
    return {k: s.stmt_log.counter(k) for k in COUNTERS}


@pytest.mark.parametrize("mode,text,keys", [
    ("sliced", POINT, [3, 1414, 500, 42, 777, 12, ROWS - 1]),
    ("shared", RANGE, [5, 1414, 500, 42, 777, 12, ROWS])],
    ids=["sliced", "shared"])
def test_run_batch_equals_sequential(mode, text, keys):
    """One stacked launch of seven same-skeleton statements returns each
    statement's own sequential result; a second batch of five rides the
    same rung runner (no new ``batch_rung_compiles``); the counters equal
    the JAX package's after each batch."""
    def run(e):
        s = _session(e)
        pp = e.mod("sched.paramplan")
        outs = pp.run_batch(s, [text.format(k) for k in keys])
        e.keep(len(outs))
        e.keep(_counters(s))
        prep = pp.prepare_one(s, text.format(keys[0]))
        e.keep(prep.gp.stack_mode)
        e.keep(prep.gp.fast is not None)
        more = [k // 3 + 1 for k in keys[:5]]
        outs2 = pp.run_batch(s, [text.format(k) for k in more])
        e.keep(_counters(s))
        for k, b in zip(keys + more, outs + outs2):
            e.keep(b)
            assert_same(b, s.sql(text.format(k)))
    got = twin(run)
    assert got[0] == 7 and got[2] == mode and got[3] == (mode == "sliced")
    first, second = got[1], got[4]
    assert first["batched_statements"] == 7 and first["dispatches"] == 1
    assert second["batch_rung_compiles"] == first["batch_rung_compiles"] + 0
    assert second["batched_statements"] == 12


def test_stacked_launch_keeps_one_runner_per_rung():
    """Batches of 2, 3, 4 and 5 statements build runners for the rungs 2,
    4 and 8 only; a group whose statements drift to another skeleton
    signature mid-batch is not stackable (None), as in the reference."""
    def run(e):
        s = _session(e)
        pp = e.mod("sched.paramplan")
        for n in (2, 3, 4, 5):
            e.keep(len(pp.run_batch(s, [RANGE.format(10 * i + n)
                                        for i in range(n)])))
            e.keep(s.stmt_log.counter("batch_rung_compiles"))
        e.keep(pp.run_batch(s, [RANGE.format(5)]))     # one: not a batch
        e.keep(pp.run_batch(s, ["select count(*) as n from pts", RANGE
                                .format(5)]))          # nothing to hoist
    got = twin(run)
    assert got[:8] == [2, 1, 3, 2, 4, 2, 5, 3]
    assert got[8] is None and got[9] is None


def test_lane_check_failure_falls_back_to_sequential():
    """A lane whose runtime check fires (a scalar subquery returning
    more than one row) fails the stacked launch: ``run_batch`` answers
    None, and the dispatcher re-routes the batch sequentially so every
    member gets the verdict it gets alone — an error for the bad lane, a
    result for its batchmates."""
    text = ("select count(*) as n from pts where v = "
            "(select v from pts where k < {})")

    def run(e):
        s = _session(e)
        pp = e.mod("sched.paramplan")
        e.keep(pp.run_batch(s, [text.format(k) for k in (1, 5, 1)]))
        d = e.mod("sched.dispatcher").Dispatcher(s)
        done = {}
        ev = threading.Event()

        def on_done(i):
            def f(r):
                done[i] = r
                if len(done) == 3:
                    ev.set()
            return f

        for i, k in enumerate((1, 5, 2)):
            d.submit_nowait(text.format(k), on_done=on_done(i))
        d.start()
        try:
            assert ev.wait(TIMEOUT)
        finally:
            d.stop()
        for i in range(3):
            r = done[i]
            e.keep(type(r.error).__name__ if r.error is not None
                   else r.result)
        snap = d.snapshot()
        e.keep({k: snap[k] for k in ("batches", "seq_fallbacks",
                                     "singles", "enqueued")})
    got = twin(run)
    assert got[0] is None
    assert got[2] == "ExecError"
    assert got[4] == {"batches": 0, "seq_fallbacks": 1, "singles": 3,
                      "enqueued": 3}


def test_dispatcher_coalesces_with_the_reference_counters():
    """Twenty-four point lookups queued before the worker starts
    coalesce into stacked launches of at most eight; every answer is
    right, and the batches, the rung runners, the fast rebinds, the
    generic hits and the dispatches equal the JAX package's."""
    def run(e):
        s = _session(e, **{"sched.max_batch": 8, "sched.tick_s": 0.01})
        d = e.mod("sched.dispatcher").Dispatcher(s)
        res = {}
        ev = threading.Event()

        def cb(k):
            def f(r):
                res[k] = r.error if r.error is not None else \
                    r.result.decoded_columns()["v"].tolist()
                if len(res) == 24:
                    ev.set()
            return f

        for k in range(100, 124):
            d.submit_nowait(POINT.format(k), on_done=cb(k))
        d.start()
        try:
            assert ev.wait(TIMEOUT)
        finally:
            d.stop()
        e.keep(sorted(res.items()))
        snap = d.snapshot()
        e.keep({k: snap[k] for k in ("batches", "batched_requests",
                                     "avg_occupancy", "singles",
                                     "seq_fallbacks")})
        e.keep(_counters(s))
    got = twin(run)
    assert got[0] == [(k, [(k * 3) % 997]) for k in range(100, 124)]
    assert got[1]["batches"] == 3 and got[1]["batched_requests"] == 24
    assert got[2]["batched_statements"] == 24


def test_solo_statements_deadline_backpressure_and_faults():
    """Non-parameterizable statements ride alone; an expired deadline
    fails without executing (SchedDeadline); a full bounded queue refuses
    (SchedQueueFull); the ``sched_enqueue`` fault surfaces to the caller
    and the ``sched_flush`` fault fails the batch without losing a
    request; a stopped dispatcher refuses with ServerDraining."""
    def run(e):
        FI = e.mod("utils.faultinject")
        sched = e.mod("sched")
        s = _session(e, **{"sched.tick_s": 0.05})
        d = sched.Dispatcher(s).start()
        try:
            e.keep(d.submit("select count(*) as n from pts"))
            e.error(d.submit, "select k from pts where k = 5",
                    deadline_s=0.0)
            FI.inject_fault("sched_enqueue", "error")
            e.error(d.submit, "select k from pts where k = 1")
            FI.reset_fault("sched_enqueue")
            e.keep(d.submit("select k from pts where k = 1"))
            FI.inject_fault("sched_flush", "error", start_hit=1,
                            end_hit=1)
            out = []
            threads = [threading.Thread(target=lambda k=k: out.append(
                _outcome(d.submit, POINT.format(k)))) for k in range(6)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=TIMEOUT)
            e.keep(len(out))
        finally:
            d.stop()
        e.error(d.submit, "select k from pts where k = 3")
        # backpressure: stall the worker in group formation so the one
        # queue slot stays taken
        s2 = _session(e, **{"sched.max_queue": 1, "sched.tick_s": 0.0})
        FI.inject_fault("sched_coalesce", "sleep", sleep_s=1.0)
        d2 = sched.Dispatcher(s2).start()
        try:
            t1 = threading.Thread(
                target=lambda: d2.submit("select k from pts where k = 1"))
            t1.start()
            # the worker holds request 1 in the stalled group formation
            _until(lambda: d2.snapshot()["enqueued"] == 1
                   and d2.queue_depth() == 0 and d2._busy)
            t2 = threading.Thread(
                target=lambda: d2.submit("select k from pts where k = 2"))
            t2.start()
            _until(lambda: d2.queue_depth() == 1)  # the one queue slot
            e.error(d2.submit, "select k from pts where k = 3",
                    enqueue_wait_s=0.05)
            t1.join(timeout=TIMEOUT)
            t2.join(timeout=TIMEOUT)
            e.keep(d2.snapshot()["rejected"])
        finally:
            d2.stop()
    got = twin(run)
    assert got[1][0] == "SchedDeadline" and got[2][0] == "InjectedFault"
    assert got[4] == 6 and got[5][0] == "ServerDraining"
    assert got[6][0] == "SchedQueueFull" and got[7] == 1


def _until(cond):
    deadline = time.monotonic() + TIMEOUT
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.002)


def _outcome(fn, *a):
    try:
        fn(*a)
        return "ok"
    except Exception as ex:  # noqa: BLE001 — the outcome is the point
        return type(ex).__name__


def test_server_dispatch_end_to_end():
    """A server with the dispatcher on batches concurrent point reads
    from six connections; writes and metadata keep working; meta
    "sched" carries the same keys and queue story in both engines."""
    def run(e):
        s = _session(e, **{"sched.enabled": True, "sched.tick_s": 0.005})
        srv = e.server(session=s)
        c = e.client(srv, timeout=TIMEOUT)
        e.wire(c.sql, "create table aux (a int) distributed by (a)")
        e.wire(c.sql, "insert into aux values (1), (2)")
        e.wire(c.sql, "select count(*) as n from aux")
        results, errors = [], []
        Client = e.mod("serve.client").Client

        def client(wid):
            try:
                with Client(srv.host, srv.port, timeout=TIMEOUT) as cc:
                    for i in range(6):
                        k = wid * 100 + i
                        out = cc.sql(POINT.format(k))
                        results.append(out["rows"] == [[k, (k * 3) % 997]])
            except Exception as ex:  # noqa: BLE001 — reported below
                errors.append(repr(ex))

        threads = [threading.Thread(target=client, args=(w,))
                   for w in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=TIMEOUT)
        e.keep(errors)
        e.keep(len(results) == 36 and all(results))
        sched = c.meta("sched")
        e.keep(sorted(sched))
        e.keep(sorted(sched["dispatcher"]))
        e.keep(sched["generic_plans"])
        e.keep(sched["dispatcher"]["enqueued"] >= 36)
        srv.stop()
        e.error(s._dispatcher.submit, "select 1")
    got = twin_servers(run)
    assert got[3] == [] and got[4] is True
    assert got[7] is True and got[8] is True
    assert got[9][0] == "ServerDraining"
