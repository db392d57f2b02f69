"""Resource queues, statement priority, the vmem red zone, runaway
termination and statement timeouts: the port against the JAX package, on
the CPU.

Every case of ``tests/test_resqueue.py`` runs against both engines (the
queue, tracker and gate classes are copies; the sessions are each
engine's own) and must give the same outcome. Beside them: a skew join
whose join-expansion growth crosses the red line must raise
``RunawayError`` at the same growth in both engines and tile in neither;
a tiny ``statement_timeout_s`` must raise ``StatementTimeout`` in both;
the watchdog cancels an over-deadline handle in both; and two threads
sharing one port Session under ``ACTIVE_STATEMENTS 1`` run one at a time.
"""

import threading
import time

import numpy as np
import pytest

import cloudberry_tpu as cb
import cloudberry_tpu_torch as ct
from cloudberry_tpu import lifecycle as JL
from cloudberry_tpu.exec import instrument as JI
from cloudberry_tpu.exec import resource as JR
from cloudberry_tpu.plan.binder import BindError as JBindError
from cloudberry_tpu_torch import lifecycle as TL
from cloudberry_tpu_torch.exec import instrument as TI
from cloudberry_tpu_torch.exec import resource as TR
from cloudberry_tpu_torch.plan.binder import BindError as TBindError
from torch_parity import carry_tables

ENGINES = {
    "jax": (JR, JBindError,
            lambda ov: cb.Session(cb.config.Config(n_segments=1)
                                  .with_overrides(**ov))),
    "port": (TR, TBindError,
             lambda ov: ct.Session(ct.Config().with_overrides(**ov),
                                   device="cpu")),
}
engines = pytest.mark.parametrize("engine", list(ENGINES))


@engines
def test_create_drop_resource_queue_sql(engine):
    _, bind_error, session = ENGINES[engine]
    s = session({})
    s.sql("create resource queue etl with (active_statements=2, "
          "priority='high')")
    q = s.catalog.resource_queues["etl"]
    assert q.active_statements == 2 and q.priority == "high"
    with pytest.raises(bind_error):
        s.sql("create resource queue etl")
    s.sql("drop resource queue etl")
    with pytest.raises(bind_error):
        s.sql("drop resource queue etl")
    with pytest.raises(bind_error):
        s.sql("drop resource queue default")
    with pytest.raises(bind_error, match="priority"):
        s.sql("create resource queue bad with (priority='urgent')")
    assert s.sql("drop resource queue if exists nope") == \
        "DROP RESOURCE QUEUE"


@engines
def test_max_cost_rejects_expensive_statements(engine):
    R, _, session = ENGINES[engine]
    s = session({"resource.queue": "small"})
    s.sql("create resource queue small with (max_cost=1024)")
    s.sql("create table big (k bigint, v bigint)")
    s.sql("insert into big values " +
          ", ".join(f"({i}, {i})" for i in range(500)))
    with pytest.raises(R.ResourceError, match="MAX_COST"):
        s.sql("select sum(v) as s from big")


@engines
def test_active_statements_bounds_concurrency(engine):
    R = ENGINES[engine][0]
    qm = R.QueueManager()
    q = R.ResourceQueue("q", active_statements=2)
    running, peak, done = [0], [0], []
    lock = threading.Lock()

    def work(i):
        with qm.slot(q, 0, "medium"):
            with lock:
                running[0] += 1
                peak[0] = max(peak[0], running[0])
            time.sleep(0.05)
            with lock:
                running[0] -= 1
            done.append(i)

    ts = [threading.Thread(target=work, args=(i,)) for i in range(6)]
    [t.start() for t in ts]
    [t.join(10) for t in ts]
    assert not any(t.is_alive() for t in ts)
    assert len(done) == 6
    assert peak[0] == 2


@engines
def test_priority_orders_waiters(engine):
    R = ENGINES[engine][0]
    qm = R.QueueManager()
    q = R.ResourceQueue("q", active_statements=1)
    order = []
    hold = threading.Event()
    started = threading.Event()

    def holder():
        with qm.slot(q, 0, "medium"):
            started.set()
            hold.wait(5)

    def waiter(prio, tag, delay):
        time.sleep(delay)
        with qm.slot(q, 0, prio):
            order.append(tag)

    th = threading.Thread(target=holder)
    th.start()
    started.wait(5)
    ws = [threading.Thread(target=waiter, args=("low", "low", 0.0)),
          threading.Thread(target=waiter, args=("max", "max", 0.1))]
    [w.start() for w in ws]
    time.sleep(0.3)  # both queued: low arrived first, max outranks it
    assert q.waiting == 2
    hold.set()
    th.join(5)
    [w.join(5) for w in ws]
    assert order == ["max", "low"]
    assert q.active == 0 and q.waiting == 0


@engines
def test_vmem_red_zone_blocks_then_admits(engine):
    R = ENGINES[engine][0]
    vm = R.VmemTracker(1000)
    vm.reserve(1, 800)
    t0 = time.monotonic()
    done = []

    def second():
        vm.reserve(2, 500, timeout_s=10)
        done.append(time.monotonic() - t0)
        vm.release(2)

    th = threading.Thread(target=second)
    th.start()
    time.sleep(0.15)
    assert not done  # still waiting: 800 + 500 > 1000
    vm.release(1)
    th.join(5)
    assert done and done[0] >= 0.1
    assert vm.used == 0
    with pytest.raises(R.ResourceError, match="entire engine budget"):
        vm.reserve(3, 1001)


@engines
def test_runaway_growth_terminated(engine):
    R = ENGINES[engine][0]
    vm = R.VmemTracker(1000)
    vm.reserve(1, 400)
    vm.reserve(2, 400)
    vm.grow(1, 550)  # fits: 550 + 400
    with pytest.raises(R.RunawayError, match="runaway"):
        vm.grow(1, 700)  # 700 + 400 > 1000
    assert issubclass(R.RunawayError, R.ResourceError)
    vm.release(1)
    vm.grow(2, 900)  # after the release there is room
    assert vm.used == 900


@engines
def test_queue_admission_visible_through_session(engine):
    session = ENGINES[engine][2]
    s = session({"resource.queue": "one"})
    s.sql("create resource queue one with (active_statements=1)")
    s.sql("create table t (k bigint)")
    s.sql("insert into t values (1), (2)")
    # statements run (and release their slot) normally
    assert s.sql("select count(*) as c from t").to_pandas()["c"].iloc[0] == 2
    q = s.catalog.resource_queues["one"]
    assert q.active == 0 and q.waiting == 0
    assert s._gate.total_admitted >= 1 and s._gate.active == 0
    assert s._vmem.used == 0


@engines
def test_admission_gate_bounds_and_counts(engine):
    R = ENGINES[engine][0]
    gate = R.AdmissionGate(2)
    inside = threading.Barrier(2, timeout=5)
    release = threading.Event()

    def work():
        with gate:
            inside.wait()
            release.wait(5)

    ts = [threading.Thread(target=work) for _ in range(2)]
    [t.start() for t in ts]
    time.sleep(0.1)
    assert gate.active == 2 and gate.peak == 2
    release.set()
    [t.join(5) for t in ts]
    assert gate.active == 0 and gate.total_admitted == 2


def test_two_threads_share_one_port_session(monkeypatch):
    """ACTIVE_STATEMENTS 1 on one port Session shared by two threads: the
    second statement waits for the first's slot, then runs; both
    results are right, and the queue never runs two at once."""
    from cloudberry_tpu_torch.exec import executor as TX

    s = ct.Session(ct.Config().with_overrides(**{"resource.queue": "one"}),
                   device="cpu")
    s.sql("create resource queue one with (active_statements=1)")
    s.sql("create table t (k bigint, v bigint)")
    s.sql("insert into t values " +
          ", ".join(f"({i % 5}, {i})" for i in range(100)))
    q = s.catalog.resource_queues["one"]
    real = TX.run_executable
    spans, lock = [], threading.Lock()
    waited = []

    def slow(exe, tables):
        t0 = time.monotonic()
        if not waited:
            time.sleep(0.3)
            waited.append(q.waiting)
        out = real(exe, tables)
        with lock:
            spans.append((t0, time.monotonic()))
        return out

    monkeypatch.setattr(TX, "run_executable", slow)
    out = {}

    def run(i):
        out[i] = s.sql("select k, sum(v) as sv from t group by k "
                       "order by k").to_pandas()

    ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    ts[0].start()
    time.sleep(0.05)
    ts[1].start()
    [t.join(10) for t in ts]
    assert not any(t.is_alive() for t in ts)
    assert waited == [1]                 # the second one was waiting
    (a0, a1), (b0, b1) = sorted(spans)
    assert b0 >= a1                      # one at a time
    want = [sum(v for v in range(100) if v % 5 == k) for k in range(5)]
    for i in range(2):
        assert out[i]["sv"].tolist() == want
    assert q.active == 0 and q.waiting == 0 and s._vmem.used == 0


# ------------------------------------------------ runaway on real SQL

Q = ("select count(*) as n, sum(x + y) as s from probe, build "
     "where probe.k = build.k")


def _skew_pair(total_mem):
    """tests/test_torch_growth.py's skew join in both engines under the
    same red line."""
    rng = np.random.default_rng(13)
    n = 40_000
    pk = np.where(rng.random(n) < 0.3, 0,
                  rng.integers(1, 30_000, n)).astype(np.int64)
    bk = np.concatenate([np.zeros(12, dtype=np.int64),
                         np.arange(1, 2000, dtype=np.int64)])
    ov = {"resource.total_mem_bytes": total_mem}
    js = cb.Session(cb.config.Config().with_overrides(**ov))
    js.sql("create table probe (k bigint, x bigint) distributed by (k)")
    js.sql("create table build (k bigint, y bigint) distributed by (k)")
    js.catalog.table("probe").set_data(
        {"k": pk, "x": np.arange(n, dtype=np.int64)}, {})
    js.catalog.table("build").set_data(
        {"k": bk, "y": np.arange(len(bk), dtype=np.int64) * 3}, {})
    ts = ct.Session(ct.Config().with_overrides(**ov), device="cpu")
    carry_tables(js, ts)
    return js, ts


def _estimates(ts):
    """(first, grown) memory estimates of the skew join in the port:
    the plan as planned, and after one growth of its pair buffer."""
    from cloudberry_tpu_torch.exec.executor import grow_expansion
    from cloudberry_tpu_torch.plan.planner import plan_statement
    from cloudberry_tpu_torch.sql.parser import parse_sql

    plan = plan_statement(parse_sql(Q), ts, {}).plan
    first = TR.estimate_plan_memory(plan).peak_bytes
    assert grow_expansion(plan, "expansion overflow", allow_fallback=True)
    return first, TR.estimate_plan_memory(plan).peak_bytes


def test_runaway_on_the_skew_join_in_both_engines():
    _, probe = _skew_pair(16 << 30)
    first, grown = _estimates(probe)
    assert grown > first
    budget = (first + grown) // 2
    js, ts = _skew_pair(budget)
    with pytest.raises(JR.RunawayError, match="runaway"):
        js.sql(Q)
    with pytest.raises(TR.RunawayError, match="runaway"):
        ts.sql(Q)
    # the same growth, and neither engine tiled
    assert js.growth_events == ts.growth_events == 1
    assert js.last_tiled_report is None and ts.last_tiled_report is None
    assert ts._vmem.used == 0
    err = ts.stmt_log.recent(1)[0]
    assert err["status"] == "error" and "RunawayError" in err["error"]
    # with the red line above the grown estimate, both run to the end
    js, ts = _skew_pair(16 << 30)
    want = js.sql(Q).to_pandas()
    assert ts.sql(Q).to_pandas().equals(want)


# ------------------------------------------------------------- timeouts


@engines
def test_statement_timeout_raises(engine):
    session = ENGINES[engine][2]
    s = session({"statement_timeout_s": 1e-9})
    s.sql("create table t (k bigint)")
    s.sql("insert into t values (1), (2)")
    lc = JL if engine == "jax" else TL
    with pytest.raises(lc.StatementTimeout):
        s.sql("select count(*) as c from t")
    assert s.stmt_log.counter("statement_timeouts") == 1
    assert s.stmt_log.recent(1)[0]["status"] == "error"
    assert s.stmt_log.activity() == []


@engines
def test_watchdog_cancels_an_over_deadline_handle(engine):
    lc, ins = (JL, JI) if engine == "jax" else (TL, TI)
    log = ins.StatementLog()
    sid = log.begin("select 1")
    late = lc.StatementHandle(sid, deadline=time.monotonic() - 1.0)
    log.attach(sid, late)
    other = log.begin("select 2")
    log.attach(other, lc.StatementHandle(other,
                                         deadline=time.monotonic() + 60))
    wd = lc.Watchdog(log)
    assert wd.scan() == 1
    assert late.token.cancelled
    assert {r["id"]: r["state"] for r in log.activity()} == {
        sid: "cancelling", other: "running"}
    assert log.counter("watchdog_timeouts") == 1
    with pytest.raises(lc.StatementTimeout, match="watchdog"):
        late.check()
    assert wd.scan() == 0   # already cancelled: not counted twice
    # the thread form cancels too
    wd2 = lc.Watchdog(log, interval_s=0.01)
    third = log.begin("select 3")
    h3 = lc.StatementHandle(third, deadline=time.monotonic() + 0.02)
    log.attach(third, h3)
    wd2.start()
    try:
        end = time.monotonic() + 5
        while not h3.token.cancelled and time.monotonic() < end:
            time.sleep(0.01)
    finally:
        wd2.stop()
    assert h3.token.cancelled
