"""The port's scheduled statements (serve/cron.py, the pg_cron analog)
against the JAX package's: deterministic runs on a fixed clock, job
failure isolation, jobs persisted in the store's ``_cron/jobs.json`` in
one format both engines load, and the ``cron`` verb over the wire.
Mirrors tests/test_cron.py."""

import json
import os
import time

from torch_parity import twin, twin_servers

TIMEOUT = 60


def test_runs_on_a_fixed_clock_and_failures_stay_isolated(tmp_path):
    def run(e):
        Scheduler = e.mod("serve.cron").Scheduler
        s = e.session(**{"storage.root": e.root()})
        s.sql("create table log (x bigint)")
        sched = Scheduler(s)
        sched.schedule("tick", 10.0, "insert into log values (1)")
        sched.schedule("bad", 5.0, "select * from missing_table")
        now = time.monotonic()
        e.keep([sched.run_due(now + t) for t in (11, 12, 22)])
        e.keep(s.sql("select count(*) as n from log"))
        e.keep([{k: (v.replace("cloudberry_tpu_torch", "cloudberry_tpu")
                     if isinstance(v, str) else v) for k, v in j.items()}
                for j in sched.status()])
        e.error(sched.schedule, "neg", 0.0, "select 1")
    got = twin(run, tmp_path)
    assert got[0] == [2, 0, 2]
    assert got[1].decoded_columns()["n"].tolist() == [2]
    bad = next(j for j in got[2] if j["name"] == "bad")
    assert bad["failures"] == 2 and "missing_table" in bad["last_error"]


def test_jobs_persist_in_one_format_both_engines_load(tmp_path):
    """Jobs written by one engine's scheduler load in the other's: the
    store's ``_cron/jobs.json`` is the JAX package's format."""
    import cloudberry_tpu as cb
    import cloudberry_tpu_torch as ct
    from cloudberry_tpu.serve.cron import Scheduler as JS
    from cloudberry_tpu_torch.serve.cron import CronError
    from cloudberry_tpu_torch.serve.cron import Scheduler as TS

    root = str(tmp_path / "st")
    jcfg = cb.config.Config().with_overrides(**{"storage.root": root})
    tcfg = ct.Config().with_overrides(**{"storage.root": root})
    JS(cb.Session(jcfg)).schedule("keep", 60.0, "select 1")
    TS(ct.Session(tcfg, device="cpu")).load().schedule(
        "more", 5.0, "select 2")
    with open(os.path.join(root, "_cron", "jobs.json")) as f:
        assert json.load(f) == [
            {"name": "keep", "interval_s": 60.0, "sql": "select 1"},
            {"name": "more", "interval_s": 5.0, "sql": "select 2"}]
    j = JS(cb.Session(jcfg)).load()
    assert [x["name"] for x in j.status()] == ["keep", "more"]
    j.unschedule("keep")
    t = TS(ct.Session(tcfg, device="cpu")).load()
    assert [x["name"] for x in t.status()] == ["more"]
    t.unschedule("more")
    assert TS(ct.Session(tcfg, device="cpu")).load().status() == []
    try:
        t.unschedule("more")
        raise AssertionError("unschedule of a missing job passed")
    except CronError:
        pass


def test_cron_over_the_wire(tmp_path):
    """``{"cron": ...}`` schedules, reports and unschedules a job through
    the server, which runs it under its own statement scope."""
    def run(e):
        cfg = e.config(**{"storage.root": e.root()})
        boot = e.session(**{"storage.root": e.root()})
        boot.sql("create table wlog (x bigint)")
        srv = e.server(config=cfg)
        srv.cron.tick_s = 0.05
        c = e.client(srv, timeout=TIMEOUT)
        e.wire(c._request, {"cron": {"op": "schedule", "name": "w",
                                     "interval_s": 0.1,
                                     "sql": "insert into wlog values (1)"}})
        deadline = time.monotonic() + TIMEOUT
        n = 0
        while time.monotonic() < deadline:
            n = c.rows("select count(*) from wlog")[0][0]
            if n >= 2:
                break
            time.sleep(0.05)
        e.keep(n >= 2)
        jobs = c._request({"cron": {"op": "status"}})["jobs"]
        e.keep((jobs[0]["name"], jobs[0]["runs"] >= 2, sorted(jobs[0])))
        e.wire(c._request, {"cron": {"op": "unschedule", "name": "w"}})
        e.wire(c._request, {"cron": {"op": "status"}})
        e.wire(c._request, {"cron": {"op": "unschedule", "name": "w"}})
        e.wire(c._request, {"cron": {"op": "nope"}})
    got = twin_servers(run, tmp_path)
    assert got[1] is True and got[2][:2] == ("w", True)
    assert got[4] == {"jobs": []}
    assert got[5][:2] == ("ServerError", "CronError")


def test_cron_runs_under_the_server_statement_lock():
    """A shared-session server runs job SQL through its readers-writer
    lock (``_cron_execute``), never raw ``session.sql``."""
    def run(e):
        sess = e.session()
        sess.sql("create table clk (x bigint)")
        srv = e.server(session=sess)
        e.keep((srv.per_connection, srv.cron.execute == srv._cron_execute))
        srv._cron_execute("insert into clk values (1)")
        e.keep(srv._cron_execute("select count(*) as n from clk"))
        srv.cron.schedule("j", 0.05, "insert into clk values (2)")
        deadline = time.monotonic() + TIMEOUT
        while time.monotonic() < deadline:
            if srv.cron.status()[0]["runs"] >= 1:
                break
            srv.cron.run_due(time.monotonic() + 1)
        e.keep(srv.cron.status()[0]["failures"])
    got = twin_servers(run)
    assert got[0] == (False, True) and got[2] == 0
