"""Client for the JSON-over-TCP serving layer (the libpq analog).

Errors carry the server's lifecycle taxonomy (lifecycle.py): ``etype``
names the engine error class and ``retryable`` is the server's verdict —
True for failures about WHEN the statement ran (drain, backpressure,
deadline pressure), False for failures about the statement itself.
``retry_reads=True`` opts into automatic retries of IDEMPOTENT reads on
retryable errors with jittered exponential backoff (writes never retry:
the engine does not replay DML, and neither may the client). The retry
policy honors the taxonomy BY NAME too (lifecycle.is_retryable), so the
per-tenant backpressure refusal (``TenantQueueFull``) and the accept-path
connection cap (``ServerBusy`` — which CLOSES the connection after its
one refusal line) retry even against a server build that did not stamp
the verdict; connection-severing refusals transparently reconnect before
the next attempt.

``tenant`` stamps every statement with a workload-tenant name
(sched/tenancy.py): the server's fair scheduler charges the request to
that named resource group.
"""

from __future__ import annotations

import json
import random
import socket
import time


class ServerError(RuntimeError):
    """An error response from the server. ``etype`` is the engine error
    class name; ``retryable`` is the server's taxonomy verdict."""

    def __init__(self, message: str, etype: str | None = None,
                 retryable: bool = False):
        super().__init__(message)
        self.etype = etype
        self.retryable = retryable


# errors that sever the connection as they are raised: a retry must
# reconnect first (the busy refusal is written at accept time and the
# socket closed right after)
_CONN_SEVERING = ("ServerBusy",)


class Client:
    # class-level default: harnesses that bypass __init__ (tests' flaky
    # transports) still read a tenant
    tenant: str | None = None

    def __init__(self, host: str, port: int, timeout: float = 120.0,
                 token: str | None = None, retry_reads: bool = False,
                 max_retries: int = 3, backoff_s: float = 0.05,
                 tenant: str | None = None):
        self._host = host
        self._port = port
        self._timeout = timeout
        self._token = token
        self.tenant = tenant
        self.retry_reads = retry_reads
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self._connect()

    def _connect(self) -> None:
        self._sock = socket.create_connection(
            (self._host, self._port), timeout=self._timeout)
        self._r = self._sock.makefile("rb")
        self._w = self._sock.makefile("wb")
        if self._token is not None:
            self._request({"auth": self._token})

    def _reconnect(self) -> None:
        try:
            self.close()
        except OSError:
            pass
        self._connect()

    def _request(self, req: dict) -> dict:
        self._w.write(json.dumps(req).encode() + b"\n")
        self._w.flush()
        line = self._r.readline()
        if not line:
            raise ServerError("server closed the connection")
        resp = json.loads(line)
        if not resp.get("ok"):
            raise ServerError(resp.get("error", "unknown server error"),
                              etype=resp.get("etype"),
                              retryable=bool(resp.get("retryable")))
        resp.pop("ok")
        return resp

    def sql(self, query: str, deadline_s: float | None = None) -> dict:
        """Execute one statement; returns {"columns", "rows", "rowcount"}
        for queries or {"status": ...} for DDL/DML; raises ServerError on
        engine errors. ``deadline_s`` bounds the statement end to end
        (queueing AND execution — the per-request statement_timeout).

        With ``retry_reads`` enabled, a READ that fails with a retryable
        error (server draining, queue/tenant backpressure, the
        connection cap, deadline pressure) retries up to ``max_retries``
        times with jittered exponential backoff, reconnecting when the
        refusal severed the connection. Writes are never auto-retried —
        a retried write could double-apply."""
        req: dict = {"sql": query}
        if deadline_s is not None:
            req["deadline_s"] = deadline_s
        if self.tenant is not None:
            req["tenant"] = self.tenant
        if not self.retry_reads:
            return self._request(req)
        from cloudberry_tpu_torch.sql.classify import read_only

        if not read_only(query):
            return self._request(req)
        from cloudberry_tpu_torch.lifecycle import is_retryable

        delay = self.backoff_s
        for attempt in range(self.max_retries + 1):
            reconnect = False
            try:
                return self._request(req)
            except ServerError as e:
                # the taxonomy by NAME backs up the server's stamped
                # verdict: TenantQueueFull / ServerBusy / SchedQueueFull
                # ... retry even if a response lacked "retryable". A
                # clean close (no response line at all — e.g. the busy
                # refusal's own write failed) is retryable for READS:
                # nothing executed, and reconnecting is the only out.
                closed = str(e).startswith("server closed the connection")
                retry = e.retryable or closed \
                    or (e.etype is not None and is_retryable(e.etype))
                if not retry or attempt == self.max_retries:
                    raise
                reconnect = closed or e.etype in _CONN_SEVERING
            except (OSError, ValueError):
                # connection dropped mid-request (ValueError: writing a
                # file object a failed reconnect closed): reads are
                # idempotent, so reconnect-and-retry is safe
                if attempt == self.max_retries:
                    raise
                reconnect = True
            # full jitter: desynchronize a thundering herd of retrying
            # clients (they all saw the same drain/overload)
            time.sleep(delay * (0.5 + random.random()))
            delay *= 2
            if reconnect:
                try:
                    self._reconnect()
                except (OSError, ServerError):
                    # still down/full: the next loop iteration retries
                    # (a broken half-connected state re-raises there)
                    pass
        raise AssertionError("unreachable")

    def rows(self, query: str) -> list[list]:
        return self.sql(query)["rows"]

    def append(self, table: str, rows: list, columns: list | None = None,
               deadline_s: float | None = None) -> int:
        """Streaming append: buffer ``rows`` server-side and return only
        when the covering group-commit flush has made them durable —
        bit-identical to issuing the equivalent INSERTs, at a fraction
        of the per-statement cost. Raises ServerError; IngestQueueFull
        (etype, retryable) is the back-off-and-retry signal. Appends are
        writes, so like sql() writes they are never auto-retried — the
        caller owns idempotency."""
        a: dict = {"table": table, "rows": rows}
        if columns is not None:
            a["columns"] = columns
        req: dict = {"append": a}
        if deadline_s is not None:
            req["deadline_s"] = deadline_s
        if self.tenant is not None:
            req["tenant"] = self.tenant
        return int(self._request(req).get("rows", 0))

    def cancel(self, statement_id: int) -> dict:
        """Cancel a running statement by its activity id (the
        pg_cancel_backend analog; ids via meta("activity"))."""
        return self._request({"cancel": statement_id})

    def meta(self, kind: str, arg=None):
        """Catalog metadata snapshot (tables/columns/stats/views/matviews/
        sequences/info/tenants/summary) — the pg_catalog role for thin
        clients."""
        return self._request({"meta": kind, "arg": arg})["meta"]

    def retrieve(self, cursor: str, segment: int, token: str,
                 limit: int | None = None) -> dict:
        """Drain one endpoint of a PARALLEL RETRIEVE CURSOR (the
        retrieve-mode connection, cdbendpointretrieve.c)."""
        return self._request({"retrieve": {"cursor": cursor,
                                           "segment": segment,
                                           "token": token,
                                           "limit": limit}})

    def close(self) -> None:
        try:
            self._r.close()
            self._w.close()
        finally:
            self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
