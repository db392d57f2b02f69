"""The MCP server (serve/mcp.py, ``mgmt mcp``) through the port against
the JAX package, on the CPU — the cases of ``tests/test_mcp.py``.

One JSON-RPC request stream goes to a JAX ``McpServer`` and to a port
``McpServer``, each over its engine's session holding the same tables
(made by the same SQL), and every response must be equal: the tools'
rows through ``serve/server._json_safe`` (DECIMAL, dates, NULLs), the
read-only gate's refusals, ``max_rows``, the resources and the errors.
Tool texts are compared as parsed JSON with the package names made
equal (``torch_parity.wire_safe``); ``get_activity``'s statement ids and
timings are dropped the same way. The stdio transport and the wire
engine (an MCP server over a live ``Server``) run the same stream."""

import io
import json

import pytest

from torch_parity import wire_safe

DDL = (
    "create table emp (id bigint, dept text, sal bigint, "
    "pay decimal(10,2), hired date) distributed by (id)",
    "insert into emp values (1,'eng',100,1000.50,'2020-01-02'),"
    "(2,'eng',90,900.25,'2021-03-04'),(3,'ops',70,null,'2019-12-31')",
    "create table tiny (x int)",
    "create view v_eng as select * from emp where dept = 'eng'",
    "create sequence s1",
    "analyze emp",
)


def _session(pkg, **over):
    if pkg == "port":
        from cloudberry_tpu_torch import Session
        from cloudberry_tpu_torch.config import Config

        return Session(Config().with_overrides(**over), device="cpu")
    import cloudberry_tpu as cb
    from cloudberry_tpu.config import get_config

    return cb.Session(get_config().with_overrides(
        **{"n_segments": 1, "sched.generic_plans": False, **over}))


def _mcp(pkg):
    import importlib

    name = "cloudberry_tpu_torch" if pkg == "port" else "cloudberry_tpu"
    return importlib.import_module(f"{name}.serve.mcp")


@pytest.fixture(scope="module")
def servers():
    out = {}
    for pkg in ("jax", "port"):
        s = _session(pkg)
        for q in DDL:
            s.sql(q)
        m = _mcp(pkg)
        out[pkg] = m.McpServer(m.SessionEngine(s))
    return out


def _norm(resp):
    """A response with its tool text parsed and package names, ids and
    timings made engine-neutral."""
    if resp is None:
        return None
    resp = json.loads(json.dumps(resp))
    content = (resp.get("result") or {}).get("content") \
        or (resp.get("result") or {}).get("contents")
    for c in content or ():
        try:
            c["text"] = json.loads(c["text"])
        except (TypeError, ValueError):
            pass
    return wire_safe(resp)


def _call(name, rid, **args):
    return {"jsonrpc": "2.0", "id": rid, "method": "tools/call",
            "params": {"name": name, "arguments": args}}


STREAM = [
    {"jsonrpc": "2.0", "id": 1, "method": "initialize"},
    {"jsonrpc": "2.0", "method": "notifications/initialized"},
    {"jsonrpc": "2.0", "id": 2, "method": "ping"},
    {"jsonrpc": "2.0", "id": 3, "method": "tools/list"},
    _call("list_tables", 4),
    _call("list_columns", 5, table="emp"),
    _call("list_views", 6),
    _call("list_matviews", 7),
    _call("get_table_stats", 8, table="emp"),
    _call("execute_query", 9, sql="select dept, sum(sal) as s, sum(pay) "
          "as p, count(*) as n from emp group by dept order by dept"),
    _call("execute_query", 10, sql="select id, pay, hired from emp "
          "order by id"),
    _call("explain_query", 11, sql="select count(*) from emp"),
    _call("list_large_tables", 12, limit=1),
    # the read-only gate and its edge cases
    _call("execute_query", 13, sql="drop table emp"),
    _call("execute_query", 14, sql="select 1; drop table emp"),
    _call("execute_query", 15,
          sql="select count(*) as c from emp where dept = 'a;b'"),
    _call("execute_query", 16, sql="select nextval('s1')"),
    _call("execute_query", 17, sql="   "),
    _call("execute_query", 18, sql="update emp set sal = 0"),
    _call("execute_query", 19, sql="select id from emp order by id;"),
    _call("execute_query", 20, sql="with w as (select id from emp) "
          "select count(*) as c from w"),
    _call("explain_query", 21, sql="insert into tiny values (1)"),
    # max_rows
    _call("execute_query", 22, sql="select id from emp order by id",
          max_rows=2),
    _call("execute_query", 23, sql="select id from emp order by id",
          max_rows=3),
    # errors that reach the agent as tool errors, and protocol errors
    _call("execute_query", 24, sql="select nope from emp"),
    _call("get_table_stats", 25, table="missing"),
    _call("nope", 26),
    {"jsonrpc": "2.0", "id": 27, "method": "nope"},
    {"jsonrpc": "2.0", "id": 28, "method": "resources/list"},
    {"jsonrpc": "2.0", "id": 29, "method": "resources/read",
     "params": {"uri": "cbtpu://database/info"}},
    {"jsonrpc": "2.0", "id": 30, "method": "resources/read",
     "params": {"uri": "cbtpu://database/summary"}},
    {"jsonrpc": "2.0", "id": 31, "method": "resources/read",
     "params": {"uri": "cbtpu://schemas"}},
    {"jsonrpc": "2.0", "id": 32, "method": "resources/read",
     "params": {"uri": "cbtpu://nope"}},
    _call("get_stats_for_nothing", 33),
]


def test_request_stream_equals_jax(servers):
    got = [_norm(servers["port"].handle(r)) for r in STREAM]
    want = [_norm(servers["jax"].handle(r)) for r in STREAM]
    for r, g, w in zip(STREAM, got, want):
        assert g == w, r
    # wire_safe drops "id" keys: index the responses by their requests
    by_id = {r["id"]: g for r, g in zip(STREAM, got) if "id" in r}
    assert got[1] is None        # a notification gets no response
    body = by_id[9]["result"]["content"][0]["text"]
    assert body["rows"] == [["eng", 190, 1900.75, 2], ["ops", 70, None, 1]]
    body = by_id[10]["result"]["content"][0]["text"]
    assert body["rows"][0] == [1, 1000.5, "2020-01-02"]
    assert "read-only" in by_id[13]["error"]["message"]
    assert "stacked" in by_id[14]["error"]["message"]
    assert by_id[15]["result"]["content"][0]["text"]["rows"] == [[0]]
    assert "read-only" in by_id[16]["error"]["message"]
    assert by_id[22]["result"]["content"][0]["text"]["truncated"] is True
    assert "truncated" not in by_id[23]["result"]["content"][0]["text"]
    assert by_id[24]["result"]["isError"] is True
    info = by_id[29]["result"]["contents"][0]["text"]
    assert info["engine"] == "cloudberry_tpu" and info["tables"] == 2


def test_activity_tool_equals_jax(servers):
    """``get_activity`` lists the statements the stream ran: the same
    texts and states in both engines (ids, the session's id and timings
    dropped, and ``compiles``, which counts nvcc builds in the port:
    ROADMAP C 24)."""
    def shape(out):
        text = _norm(out)["result"]["content"][0]["text"]
        return {k: [{f: v for f, v in r.items()
                     if f not in ("session", "compiles")}
                    for r in rows] for k, rows in text.items()}
    req = _call("get_activity", 1, limit=5)
    assert shape(servers["port"].handle(req)) == \
        shape(servers["jax"].handle(req))


def test_stdio_transport_equals_jax(servers):
    lines = [json.dumps(r) for r in STREAM[:12]] + ["not json", ""] + \
        [json.dumps(r) for r in STREAM[12:]]
    outs = {}
    for pkg, m in servers.items():
        out = io.StringIO()
        m.serve_stdio(stdin=io.StringIO("\n".join(lines) + "\n"),
                      stdout=out)
        outs[pkg] = [_norm(json.loads(x))
                     for x in out.getvalue().splitlines()]
    assert outs["port"] == outs["jax"]
    # the notification is dropped; the bad line is a parse error
    assert len(outs["port"]) == len(STREAM)
    assert any(r.get("error", {}).get("code") == -32700
               for r in outs["port"])


def test_meta_sees_other_sessions_ddl(tmp_path):
    """A thin MCP session that only asks metadata questions still sees
    another session's committed DDL, in both engines alike."""
    got = {}
    for pkg in ("jax", "port"):
        cfg = {"storage.root": str(tmp_path / pkg)}
        m = _mcp(pkg)
        srv = m.McpServer(m.SessionEngine(_session(pkg, **cfg)))
        first = _norm(srv.handle(_call("list_tables", 1)))
        writer = _session(pkg, **cfg)
        writer.sql("create table late (x bigint)")
        writer.sql("insert into late values (1)")
        got[pkg] = [first, _norm(srv.handle(_call("list_tables", 2))),
                    _norm(srv.handle(_call("get_table_stats", 3,
                                           table="late")))]
    assert got["port"] == got["jax"]
    assert got["port"][0]["result"]["content"][0]["text"] == []
    assert got["port"][2]["result"]["content"][0]["text"]["rows"] == 1


def test_wire_engine_against_a_port_server(tmp_path):
    """An MCP server backed by a LIVE socket server, per engine: the
    JAX package's MCP over a JAX server, the port's over a port
    ``Server``; metadata rides the ``{"meta": ...}`` requests, rows the
    server's rendering. Every response equal."""
    import cloudberry_tpu as cb
    from cloudberry_tpu.serve.server import Server as JServer
    from cloudberry_tpu_torch import Config as TConfig
    from cloudberry_tpu_torch.serve.server import Server as TServer

    stream = [_call("list_tables", 1),
              _call("execute_query", 2, sql="select sum(b) as s, "
                    "sum(d) as sd, max(t) as mt from wt"),
              _call("execute_query", 3, sql="select a, d, t from wt "
                    "order by a", max_rows=1),
              _call("explain_query", 4, sql="select a from wt"),
              _call("execute_query", 5, sql="delete from wt"),
              {"jsonrpc": "2.0", "id": 6, "method": "resources/read",
               "params": {"uri": "cbtpu://database/info"}}]
    got = {}
    for pkg in ("jax", "port"):
        root = str(tmp_path / pkg)
        if pkg == "jax":
            server = JServer(config=cb.get_config().with_overrides(
                **{"storage.root": root}), port=0)
        else:
            server = TServer(config=TConfig().with_overrides(
                **{"storage.root": root}), port=0, device="cpu")
        with server:
            boot = _session(pkg, **{"storage.root": root})
            boot.sql("create table wt (a bigint, b bigint, "
                     "d decimal(8,2), t date) distributed by (a)")
            boot.sql("insert into wt values (1, 10, 1.25, '2024-02-29'), "
                     "(2, 20, null, '1999-12-31')")
            m = _mcp(pkg)
            mcp = m.McpServer(m.WireEngine(server.host, server.port))
            try:
                got[pkg] = [_norm(mcp.handle(r)) for r in stream]
            finally:
                mcp.engine.client.close()
    assert got["port"] == got["jax"]
    rows = got["port"][1]["result"]["content"][0]["text"]["rows"]
    assert rows == [[30, 1.25, "2024-02-29"]]
    assert got["port"][2]["result"]["content"][0]["text"]["truncated"]
    assert got["port"][4]["error"]["code"] == -32602
    info = got["port"][5]["result"]["contents"][0]["text"]
    assert info["durable"] is True
