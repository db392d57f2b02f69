"""Parallel retrieve cursors through the port against the JAX package, on
the CPU at 8 segments — the in-process cases of ``test_endpoint.py``, each
run in both engines (``torch_parity.twin``): the endpoints, their row
counts, the retrieved rows of every endpoint and the errors held equal
(integers exactly). The cursor's token is random in both, so only its
presence is compared."""

from concurrent.futures import ThreadPoolExecutor

import pytest

from torch_parity import twin


def sess(e):
    s = e.session(8)
    s.sql("create table t (k bigint, v bigint) distributed by (k)")
    s.sql("insert into t values " +
          ", ".join(f"({i}, {i * 3})" for i in range(500)))
    return s


def info_of(info: dict) -> dict:
    """The cursor's info without its random token."""
    assert len(info["token"]) == 32
    return {k: v for k, v in info.items() if k != "token"}


def drained(out: dict) -> tuple:
    return (out["columns"], [tuple(int(x) for x in r) for r in out["rows"]],
            out["remaining"], out["segment"])


def test_declare_creates_per_segment_endpoints():
    def run(e):
        s = sess(e)
        e.keep(info_of(s.sql("declare c1 parallel retrieve cursor for "
                             "select k, v from t where v % 2 = 0")))
        e.keep(s.sql("select count(*) as c from t where v % 2 = 0"))
    info, want = twin(run)
    assert info["parallel"] is True and len(info["endpoints"]) == 8
    assert sum(x["rows"] for x in info["endpoints"]) == \
        int(want.columns["c"][0])


def test_retrieve_union_equals_direct_result():
    def run(e):
        s = sess(e)
        s.sql("declare c2 parallel retrieve cursor for select k, v from t")
        with ThreadPoolExecutor(8) as ex:
            outs = list(ex.map(lambda g: s.retrieve("c2", g), range(8)))
        for out in outs:
            e.keep(drained(out))
        e.keep(s.sql("select k, v from t order by k"))
    got = twin(run)
    rows = sorted(r for d in got[:8] for r in d[1])
    direct = got[8].columns
    assert rows == list(zip(direct["k"].tolist(), direct["v"].tolist()))
    assert all(d[2] == 0 for d in got[:8])


def test_incremental_retrieve():
    def run(e):
        s = sess(e)
        s.sql("declare c3 parallel retrieve cursor for select k from t")
        e.keep(drained(s.retrieve("c3", 0, limit=10)))
        e.keep(drained(s.retrieve("c3", 0)))
    first, rest = twin(run)
    assert len(first[1]) == 10 and rest[2] == 0
    assert len(first[1]) + len(rest[1]) == first[2] + 10


def test_gathered_plan_falls_back_to_entry_endpoint():
    def run(e):
        s = sess(e)
        e.keep(info_of(s.sql("declare c4 parallel retrieve cursor for "
                             "select k, v from t order by v desc limit 7")))
        e.keep(drained(s.retrieve("c4", 0)))
    info, out = twin(run)
    assert info["parallel"] is False and len(info["endpoints"]) == 1
    assert len(out[1]) == 7


def test_close_and_errors():
    def run(e):
        s = sess(e)
        s.sql("declare c5 parallel retrieve cursor for select k from t")
        e.error(s.sql, "declare c5 parallel retrieve cursor for "
                       "select k from t")
        e.error(s.retrieve, "c5", 0, token="not-the-token")
        e.error(s.retrieve, "c5", 9)
        e.keep(s.sql("close c5"))
        e.error(s.retrieve, "c5", 0)
        e.error(s.sql, "close c5")
    got = twin(run)
    assert got[0][0] == "BindError" and got[3] == "CLOSE c5"


def test_cursor_respects_queue_max_cost():
    def run(e):
        s = sess(e)
        s.sql("create resource queue tiny with (max_cost=1024)")
        s.config = s.config.with_overrides(**{"resource.queue": "tiny"})
        kind, msg = e.error(s.sql, "declare cq parallel retrieve cursor "
                                   "for select k, v from t")
        e.keep("MAX_COST" in msg)
        e.keep("cq" in s.parallel_cursors)
    got = twin(run)
    assert got[0][0] == "ResourceError" and got[1:] == [True, False]


def test_cursor_holds_vmem_until_close():
    """The held rows stay reserved until CLOSE. The port's endpoints hold
    the selected rows only (every result of the port is compacted), the
    JAX package's the padded (segment, capacity) shards, so the port
    reserves fewer bytes for the same rows."""
    held = {}

    def run(e):
        s = sess(e)
        before = s._vmem.used
        s.sql("declare ch parallel retrieve cursor for select k, v from t")
        held[e.pkg] = s._vmem.used - before
        s.sql("close ch")
        e.keep(s._vmem.used == before)
    assert twin(run) == [True]
    assert held["cloudberry_tpu_torch"] == 500 * 16
    assert held["cloudberry_tpu"] >= held["cloudberry_tpu_torch"]


@pytest.mark.parametrize("q, parallel", [
    ("select k, v * 2 as w from t where k % 7 = 1", True),
    ("select t.k, u.v from t join t as u on t.k = u.v", True),
    # a small grouped result gathers to one segment: ON_ENTRY
    ("select k % 10 as g, count(*) as c, sum(v) as s from t "
     "group by k % 10", False),
])
def test_endpoints_equal_reference_per_segment(q, parallel):
    """Every endpoint's rows equal the JAX package's endpoint of the same
    segment, in order: a filtered projection, a join with a motion, and a
    grouped aggregate."""
    def run(e):
        s = sess(e)
        info = e.keep(info_of(s.sql(
            f"declare cx parallel retrieve cursor for {q}")))
        for ep in info["endpoints"]:
            e.keep(drained(s.retrieve("cx", ep["segment"])))
        e.keep(s.sql("close cx"))
    got = twin(run)
    assert got[0]["parallel"] is parallel


def test_direct_dispatched_cursor_runs_on_its_segment():
    """A cursor over a point predicate on the distribution key plans
    direct dispatch: its one ON_ENTRY endpoint runs the plan on the
    segment that owns the key and holds the row the direct SELECT
    returns. (The JAX package's cursor runs such a plan through its
    gang executor and its endpoint comes back empty — ROADMAP Queue
    C 44.)"""
    def run(e):
        s = sess(e)
        e.keep(s.sql("select k, v from t where k = 17"))
    want = twin(run)[0]

    from torch_parity import Engine

    s = sess(Engine("cloudberry_tpu_torch"))
    info = s.sql("declare cd parallel retrieve cursor for "
                 "select k, v from t where k = 17")
    assert info["parallel"] is False
    assert [x["rows"] for x in info["endpoints"]] == [1]
    rows = s.retrieve("cd", 0)["rows"]
    assert [tuple(int(x) for x in r) for r in rows] == \
        list(zip(want.columns["k"].tolist(), want.columns["v"].tolist()))
