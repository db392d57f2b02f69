"""MCP server analog — the engine as an AI-agent tool surface.

The reference ships an MCP (Model Context Protocol) server exposing the
database to AI agents: metadata resources plus read-only query tools over
a security layer (mcp-server/src/cbmcp/server.py:56-175, security.py).
This is the tpu-native analog with zero dependencies: the MCP wire format
is JSON-RPC 2.0 over newline-delimited stdio (the protocol's stdio
transport), implemented directly — ``handle()`` takes one request dict,
``serve_stdio()`` runs the transport loop — and the engine side is either
an in-process Session or a wire connection to a running server
(serve/server.py), whose {"meta": ...} requests carry the catalog
snapshots (serve/meta.py).

Security model (security.py role): tools execute READ-ONLY statements
only — the statement head must be a query starter, and statement bodies
are single statements (no stacked ';'). DDL/DML through an agent goes
through a human-operated connection instead.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Optional

PROTOCOL_VERSION = "2024-11-05"
SERVER_INFO = {"name": "cloudberry-tpu-mcp", "version": "1.0"}

class McpError(RuntimeError):
    pass


def _check_read_only(sql: str) -> None:
    from cloudberry_tpu_torch.sql.classify import read_only, \
        strip_string_literals

    s = sql.strip()
    if not read_only(s):
        head = s.split(None, 1)[0].lower() if s else ""
        raise McpError(f"only read-only statements are allowed "
                       f"(got {head or 'empty'!r})")
    # stacked-statement check on the literal-stripped text: a ';' inside
    # a string ('a;b') is data, not a second statement
    bare = strip_string_literals(s).rstrip().rstrip(";")
    if ";" in bare:
        raise McpError("stacked statements are not allowed")


# ------------------------------------------------------------- engines


class SessionEngine:
    """In-process engine: a Session owned by this process."""

    def __init__(self, session):
        self.session = session

    def sql(self, query: str) -> dict:
        result = self.session.sql(query)
        if hasattr(result, "decoded_columns"):
            cols = result.decoded_columns()
            from cloudberry_tpu_torch.serve.server import _json_safe

            names = list(cols)
            arrays = list(cols.values())
            n = len(arrays[0]) if arrays else 0
            return {"columns": names,
                    "rows": [[_json_safe(a[i]) for a in arrays]
                             for i in range(n)],
                    "rowcount": n}
        return {"status": str(result)}

    def explain(self, query: str) -> str:
        return self.session.explain(query)

    def meta(self, kind: str, arg=None):
        from cloudberry_tpu_torch.serve.meta import describe

        return describe(self.session, kind, arg)


class WireEngine:
    """Remote engine: a serve/server.py instance over TCP."""

    def __init__(self, host: str, port: int):
        from cloudberry_tpu_torch.serve.client import Client

        self.client = Client(host, port)

    def sql(self, query: str) -> dict:
        return self.client.sql(query)

    def explain(self, query: str) -> str:
        out = self.client.sql(f"explain {query}")
        if "rows" in out:
            return "\n".join(r[0] for r in out["rows"])
        return out.get("status", "")

    def meta(self, kind: str, arg=None):
        return self.client.meta(kind, arg)


# ---------------------------------------------------------------- tools


def _tool(name, desc, props, required):
    return {"name": name, "description": desc,
            "inputSchema": {"type": "object", "properties": props,
                            "required": required}}


_STR = {"type": "string"}
_INT = {"type": "integer"}

TOOLS = [
    _tool("list_tables", "List tables with row counts and distribution",
          {}, []),
    _tool("list_columns", "Columns of one table: name/type/nullable/unique",
          {"table": _STR}, ["table"]),
    _tool("list_views", "List view names", {}, []),
    _tool("list_matviews",
          "List materialized views with freshness and maintenance mode",
          {}, []),
    _tool("get_table_stats",
          "Statistics for one table: rows, per-column NDV and min/max",
          {"table": _STR}, ["table"]),
    _tool("execute_query",
          "Run a READ-ONLY SQL statement; returns columns and rows "
          "(row count capped by max_rows)",
          {"sql": _STR, "max_rows": _INT}, ["sql"]),
    _tool("explain_query", "The engine's distributed plan for a statement",
          {"sql": _STR}, ["sql"]),
    _tool("list_large_tables", "Largest tables by row count",
          {"limit": _INT}, []),
    _tool("get_activity",
          "Running and recently-completed statements across all "
          "connections (the pg_stat_activity role)",
          {"limit": _INT}, []),
]

RESOURCES = [
    {"uri": "cbtpu://database/info", "name": "database-info",
     "description": "Engine identity, segment count, object counts",
     "mimeType": "application/json"},
    {"uri": "cbtpu://database/summary", "name": "database-summary",
     "description": "Every table with its columns and row count",
     "mimeType": "application/json"},
    {"uri": "cbtpu://schemas", "name": "schemas",
     "description": "Table names (the flat-namespace schema list)",
     "mimeType": "application/json"},
]


class McpServer:
    """One MCP endpoint over an engine. ``handle`` maps a JSON-RPC request
    dict to a response dict (None for notifications)."""

    def __init__(self, engine):
        self.engine = engine

    # --------------------------------------------------------- dispatch

    def handle(self, req: dict) -> Optional[dict]:
        rid = req.get("id")
        method = req.get("method", "")
        if method.startswith("notifications/"):
            return None
        try:
            result = self._dispatch(method, req.get("params") or {})
            return {"jsonrpc": "2.0", "id": rid, "result": result}
        except McpError as e:
            return {"jsonrpc": "2.0", "id": rid,
                    "error": {"code": -32602, "message": str(e)}}
        except Exception as e:  # noqa: BLE001 — agent-facing boundary
            return {"jsonrpc": "2.0", "id": rid,
                    "error": {"code": -32603,
                              "message": f"{type(e).__name__}: {e}"}}

    def _dispatch(self, method: str, params: dict) -> Any:
        if method == "initialize":
            return {"protocolVersion": PROTOCOL_VERSION,
                    "capabilities": {"tools": {}, "resources": {}},
                    "serverInfo": SERVER_INFO}
        if method == "ping":
            return {}
        if method == "tools/list":
            return {"tools": TOOLS}
        if method == "tools/call":
            return self._call_tool(params.get("name", ""),
                                   params.get("arguments") or {})
        if method == "resources/list":
            return {"resources": RESOURCES}
        if method == "resources/read":
            return self._read_resource(params.get("uri", ""))
        raise McpError(f"unknown method {method!r}")

    # ------------------------------------------------------------ tools

    def _call_tool(self, name: str, args: dict) -> dict:
        try:
            out = self._tool_impl(name, args)
            return {"content": [{"type": "text",
                                 "text": json.dumps(out, default=str)}],
                    "isError": False}
        except McpError:
            raise
        except Exception as e:  # noqa: BLE001 — tool errors flow to agent
            return {"content": [{"type": "text",
                                 "text": f"{type(e).__name__}: {e}"}],
                    "isError": True}

    def _tool_impl(self, name: str, args: dict) -> Any:
        eng = self.engine
        if name == "list_tables":
            return eng.meta("tables")
        if name == "list_columns":
            return eng.meta("columns", args["table"])
        if name == "list_views":
            return eng.meta("views")
        if name == "list_matviews":
            return eng.meta("matviews")
        if name == "get_table_stats":
            return eng.meta("stats", args["table"])
        if name == "execute_query":
            _check_read_only(args["sql"])
            out = eng.sql(args["sql"])
            cap = int(args.get("max_rows", 1000))
            if "rows" in out and len(out["rows"]) > cap:
                out["rows"] = out["rows"][:cap]
                out["truncated"] = True
            return out
        if name == "explain_query":
            _check_read_only(args["sql"])
            return {"plan": eng.explain(args["sql"])}
        if name == "get_activity":
            return eng.meta("activity", args.get("limit"))
        if name == "list_large_tables":
            tables = eng.meta("tables")
            tables.sort(key=lambda t: -t["rows"])
            return tables[:int(args.get("limit", 10))]
        raise McpError(f"unknown tool {name!r}")

    # -------------------------------------------------------- resources

    def _read_resource(self, uri: str) -> dict:
        kinds = {"cbtpu://database/info": "info",
                 "cbtpu://database/summary": "summary",
                 "cbtpu://schemas": "tables"}
        kind = kinds.get(uri)
        if kind is None:
            raise McpError(f"unknown resource {uri!r}")
        body = self.engine.meta(kind)
        if kind == "tables":
            body = [t["name"] for t in body]
        return {"contents": [{"uri": uri, "mimeType": "application/json",
                              "text": json.dumps(body, default=str)}]}

    # -------------------------------------------------------- transport

    def serve_stdio(self, stdin=None, stdout=None) -> None:
        """The MCP stdio transport: one JSON-RPC message per line."""
        stdin = stdin if stdin is not None else sys.stdin
        stdout = stdout if stdout is not None else sys.stdout
        for line in stdin:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except json.JSONDecodeError:
                resp = {"jsonrpc": "2.0", "id": None,
                        "error": {"code": -32700, "message": "parse error"}}
            else:
                resp = self.handle(req)
            if resp is not None:
                stdout.write(json.dumps(resp) + "\n")
                stdout.flush()
