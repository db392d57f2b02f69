"""Socket serving layer — the engine as a database, not a library.

The reference's serving surface is the libpq wire protocol into a
PER-CONNECTION backend process (exec_simple_query,
src/backend/tcop/postgres.c:506, 1655) over shared storage. Here the same
shape: when the server runs over a durable store (config.storage.root),
every connection gets its OWN Session — the backend analog — over the
shared TableStore, so wire transactions (BEGIN/COMMIT/ROLLBACK) ride the
storage layer's multi-session OCC exactly like in-process sessions do, and
a dropped connection rolls its open transaction back (the backend-exit
abort). Resource governance stays engine-wide: every connection session
shares the server's admission gate, resource queues, and vmem tracker, and
parallel-retrieve-cursor endpoints live in a server-shared registry so a
cursor declared on one connection drains from any other (the shmem
endpoint directory, cdbendpoint.c).

Without a store there is nothing durable for backends to share, so all
connections fall back to ONE shared Session: reads run concurrently,
catalog mutations serialize behind a WRITER-PRIORITY rw-lock (a stream of
readers can never starve DDL/DML), and wire transactions are refused —
one client's BEGIN would absorb other clients' autocommit writes.

The port's Server runs on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do): every backend it creates runs on the
server session's device, and without a CUDA device ``Server()`` raises,
like ``Session()``. The statements reach the same kernels through the
same statement pipeline as in-process calls.

Clients speak a newline-delimited JSON protocol:

    → {"sql": "select ..."}
    ← {"ok": true, "columns": [...], "rows": [[...]], "rowcount": N}
    ← {"ok": true, "status": "CREATE TABLE t"}          (DDL/DML)
    ← {"ok": false, "error": "...", "etype": "BindError"}
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
from typing import Optional

import numpy as np
import torch

from cloudberry_tpu_torch.sql.classify import read_only as _is_read
# shared classifier (sql/classify.py): the standby gate, the rw-lock
# choice, and the Session retry policy must agree on what a "read" is —
# notably `select nextval(...)` is a WRITE (plan-time sequence allocation)

_TXN_STARTERS = ("begin", "commit", "rollback", "abort", "start", "end")


def _first_word(sql: str) -> str:
    s = sql.lstrip()
    if s.startswith("("):
        return "("
    head = s.split(None, 1)
    return head[0].lower() if head else ""


class _RWLock:
    """Readers-writer lock with WRITER PRIORITY: reads share, catalog
    mutations exclude, and a waiting writer blocks NEW readers — a stream
    of reads can delay a write by at most the in-flight readers (the
    lock-queue fairness ProcSleep gives the reference's lmgr)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self):
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self):
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True

    def release_write(self):
        with self._cond:
            self._writer = False
            self._cond.notify_all()


def _resp_bytes(resp: dict) -> int:
    """Estimated wire bytes of one response WITHOUT re-serializing big
    row sets: sample the first rows and scale (the transport serializes
    exactly once; this estimate feeds the statements table's wire_bytes
    aggregate, where ±a few percent on huge results is fine)."""
    rows = resp.get("rows")
    if not rows:
        try:
            return len(json.dumps(resp))
        except (TypeError, ValueError):
            return 0
    k = min(len(rows), 64)
    try:
        per = len(json.dumps(rows[:k])) / k
    except (TypeError, ValueError):
        return 0
    return int(per * len(rows)) + 64


def _json_safe(v):
    if v is None:
        return None
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating, float)):
        f = float(v)
        return None if f != f else f  # NaN (NULL rendering) → null
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, np.datetime64):
        return str(v)
    if hasattr(v, "isoformat"):
        return v.isoformat()
    return v


class Server:
    """One engine process serving many clients over TCP.

    ``read_only=True`` runs the process as a HOT STANDBY (the
    hot_standby / mirroring analog): a second server over the SAME store
    serves reads while refusing writes. No WAL ships and nothing
    promotes-on-command — immutable snapshot manifests ARE the
    replication stream (the standby's epoch sync picks up every commit),
    and "promotion" is restarting without the flag.

    ``auth_token`` enables authentication: clients must send
    {"auth": "<token>"} before anything else. Repeated failures from one
    client address lock that address out for ``lockout_s`` seconds (the
    login-monitor analog — the reference disables accounts after
    consecutive failed logins)."""

    def __init__(self, session=None, config=None,
                 host: str = "127.0.0.1", port: int = 0,
                 read_only: bool = False,
                 auth_token: Optional[str] = None,
                 max_login_failures: int = 3,
                 lockout_s: float = 60.0,
                 watchdog_interval_s: float = 0.05,
                 device=None):
        import cloudberry_tpu_torch as cb

        own = session is None
        if own:
            # None: CUDA, raising without a card (Session's own rule)
            session = cb.Session(config, device=device)
        elif device is not None and session.device != torch.device(device):
            raise ValueError(f"Server(device={device!r}) over a session "
                             f"on {session.device}")
        self.session = session
        # per-connection backends need shared durable storage to see each
        # other's commits; an explicit session= pins legacy shared mode
        self._config = self.session.config
        self.per_connection = own and self.session.store is not None
        self.read_only = read_only
        self.auth_token = auth_token
        self.max_login_failures = max_login_failures
        self.lockout_s = lockout_s
        # login monitor state: client address -> (failures, locked_until)
        self._login_failures: dict[str, list] = {}
        self._login_lock = threading.Lock()
        self._rw = _RWLock()
        # statement-lifecycle state (lifecycle.py): the watchdog cancels
        # over-deadline statements (statement_timeout enforcement even
        # when the worker thread is wedged at an interruptible seam);
        # _draining + the in-flight request count drive graceful drain
        from cloudberry_tpu_torch.lifecycle import Watchdog

        self.watchdog = Watchdog(self.session.stmt_log,
                                 interval_s=watchdog_interval_s)
        self._draining = False
        self._inflight = 0
        self._inflight_cond = threading.Condition()
        # accept-path connection cap (config.serve.max_connections): past
        # it, a new connection gets ONE retryable SERVER_BUSY line and
        # closes — bounded fds/threads instead of unbounded accept growth
        self.max_connections = self._config.serve.max_connections
        self._conn_count = 0
        self._conn_lock = threading.Lock()
        # per-tenant workload governance (sched/tenancy.py): named
        # resource groups with DWRR weights, concurrency slots, and
        # bounded queues; requests pick their group via {"tenant": name}
        self.tenancy = None
        if self._config.tenancy.enabled:
            from cloudberry_tpu_torch.sched.tenancy import TenantScheduler

            self.tenancy = TenantScheduler(self._config.tenancy)
        # tenancy observability spans the wire (serve/meta.py "tenants")
        self.session._tenancy = self.tenancy
        # transport: the event-loop front end (serve/asyncore.py) is the
        # default — a handful of I/O threads multiplex every connection;
        # config.serve.threaded keeps the thread-per-connection path
        if self._config.serve.threaded:
            self._transport = _ThreadedTransport(self, host, port)
        else:
            from cloudberry_tpu_torch.serve.asyncore import AsyncFrontEnd

            self._transport = AsyncFrontEnd(self, host, port)
        self.host, self.port = self._transport.host, self._transport.port
        # scheduled statements (pg_cron analog): jobs persist in the store
        # and run in the serving process's session
        from cloudberry_tpu_torch.serve.cron import Scheduler

        self.cron = Scheduler(self.session,
                              execute=self._cron_execute).load()
        # continuous micro-batch dispatcher (sched/dispatcher.py, the
        # gang-dispatch analog): opt-in via config.sched.enabled — read
        # statements coalesce into stacked launches on the SERVER session;
        # executions hold the same statement-level lock scope direct
        # dispatch would, and the tenancy scheduler (when enabled) owns
        # the pick order inside its tick
        self.dispatcher = None
        if self.session.config.sched.enabled:
            from cloudberry_tpu_torch.sched import Dispatcher

            self.dispatcher = Dispatcher(self.session,
                                         exec_scope=self._locked,
                                         tenancy=self.tenancy)
        # streaming ingest plane (storage/ingest.py): ONE service on the
        # SERVER session in both sharing modes — group commit must span
        # connections (per-connection backends see the flushed commits
        # through the store's epoch sync like any other writer's)
        self.ingest = None
        if self._config.ingest.enabled:
            from cloudberry_tpu_torch.storage.ingest import IngestService

            self.ingest = IngestService(self.session,
                                        exec_scope=self._locked)
            self.session._ingest = self.ingest
        # background compaction (storage/compact.py): opt-in (a read-
        # mostly server pays nothing) and store-backed only; committed
        # ingest flushes poke it so write bursts fold promptly. Host work
        # only: its thread never touches the device
        self.compactor = None
        if self._config.compact.enabled and self.session.store is not None:
            from cloudberry_tpu_torch.storage.compact import \
                CompactionService

            self.compactor = CompactionService(self.session)
            self.session._compactor = self.compactor
            if self.ingest is not None:
                self.ingest.on_commit = self.compactor.wake

    # -------------------------------------------------- lifecycle plumbing

    def _request_begin(self) -> None:
        with self._inflight_cond:
            self._inflight += 1

    def _request_end(self) -> None:
        with self._inflight_cond:
            self._inflight -= 1
            self._inflight_cond.notify_all()

    # ------------------------------------------------- connection admission

    def _try_admit_conn(self) -> bool:
        """Accept-path cap: True admits (counted), False means the caller
        must send the SERVER_BUSY line and close."""
        with self._conn_lock:
            if self.max_connections and \
                    self._conn_count >= self.max_connections:
                return False
            self._conn_count += 1
            return True

    def _conn_closed(self) -> None:
        with self._conn_lock:
            self._conn_count -= 1

    def _busy_resp(self) -> dict:
        from cloudberry_tpu_torch.lifecycle import ServerBusy

        return {"ok": False, "etype": ServerBusy.__name__,
                "retryable": True,
                "fatal": True,
                "error": f"SERVER_BUSY: connection limit "
                         f"({self.max_connections}) reached; retry "
                         "shortly"}

    def _busy_line(self) -> bytes:
        return json.dumps(self._busy_resp()).encode() + b"\n"

    def _process_line(self, line: bytes, sess, authed: bool, addr: str,
                      async_cb=None):
        """One wire line → (response dict | None, authed'): the
        transport-independent request core. ``None`` means an async
        completion owns the response (``async_cb`` will fire exactly
        once with it — event-loop transport only)."""
        try:
            req = json.loads(line)
            if not authed:
                resp, authed = self._authenticate(req, addr)
            else:
                resp = self._execute(req, sess, async_cb=async_cb)
        except Exception as e:
            # bad client/statement must not kill the connection handler
            resp = self._error_resp(e)
        return resp, authed

    @staticmethod
    def _error_resp(e: BaseException) -> dict:
        """Wire error with the shared taxonomy: ``etype`` names the
        error class, ``retryable`` is the server's verdict (the client's
        auto-retry trusts it — one classifier, lifecycle.is_retryable,
        for both sides)."""
        from cloudberry_tpu_torch.lifecycle import is_retryable

        return {"ok": False, "etype": type(e).__name__,
                "retryable": is_retryable(e),
                "error": f"{type(e).__name__}: {e}"}

    def _locked(self, write: bool = False):
        """Statement-level lock scope: a no-op in per-connection mode
        (each backend has its own catalog; the store's OCC arbitrates),
        shared read/exclusive write otherwise. Every path that touches
        the shared session — wire SQL, meta, retrieve, cron jobs — must
        go through this one helper so the lock discipline has a single
        home."""
        import contextlib

        if self.per_connection:
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def scope():
            acq = self._rw.acquire_write if write else self._rw.acquire_read
            rel = self._rw.release_write if write else self._rw.release_read
            acq()
            try:
                yield
            finally:
                rel()

        return scope()

    def _cron_execute(self, sql: str):
        """Run a cron job's statement under the same statement-level
        locking a wire client would get: in shared-session mode a
        scheduled write must exclude concurrent reader threads."""
        with self._locked(write=not _is_read(sql)):
            return self.session.sql(sql)

    # ----------------------------------------------------- authentication

    def _authenticate(self, req: dict, addr: str) -> tuple[dict, bool]:
        """First-request auth + the login-monitor lockout. Returns
        (response, now_authenticated); a lockout or bad token closes the
        connection (resp["fatal"])."""
        import time

        with self._login_lock:
            fails, until = self._login_failures.get(addr, [0, 0.0])
            if time.monotonic() < until:
                return ({"ok": False, "fatal": True, "retryable": False,
                         "error": "too many failed logins; address locked "
                                  f"for {self.lockout_s:.0f}s"}, False)
        import hmac

        # bytes, not str: compare_digest on str raises for non-ASCII,
        # which would lock out any server with a non-ASCII token
        token = req.get("auth")
        if hmac.compare_digest(str(token or "").encode(),
                               str(self.auth_token).encode()):
            with self._login_lock:
                self._login_failures.pop(addr, None)
            return ({"ok": True, "status": "authenticated"}, True)
        with self._login_lock:
            fails, until = self._login_failures.get(addr, [0, 0.0])
            fails += 1
            if fails >= self.max_login_failures:
                until = time.monotonic() + self.lockout_s
            self._login_failures[addr] = [fails, until]
        msg = ("authentication required: send {\"auth\": \"<token>\"} first"
               if "auth" not in req else "authentication failed")
        return ({"ok": False, "fatal": True, "retryable": False,
                 "error": msg}, False)

    @staticmethod
    def _parameterizable(sql: str) -> bool:
        """Reads worth coalescing: the skeleton normalizer hoists at
        least one literal (same-shape statements can share a launch)."""
        from cloudberry_tpu_torch.sched import paramplan

        norm = paramplan.normalize(sql)
        return norm is not None and bool(norm[1])

    # ------------------------------------------------- connection sessions

    def _connection_session(self):
        """A backend for one connection (postgres.c:1655 fork analog):
        its own Session/catalog over the shared store, sharing the
        server's resource governance and endpoint registry."""
        if not self.per_connection:
            return self.session
        import cloudberry_tpu_torch as cb

        s = cb.Session(self._config, device=self.session.device)
        s.parallel_cursors = self.session.parallel_cursors
        s._gate = self.session._gate
        s._queues = self.session._queues
        s._vmem = self.session._vmem
        # one activity/history log across ALL backends: "who runs what"
        # must span connections (pg_stat_activity is cluster-wide)
        s.stmt_log = self.session.stmt_log
        # one circuit breaker: device-loss flapping is an ENGINE
        # condition, so read-only-degraded spans backends like the gate
        s._breaker = self.session._breaker
        # one topology manager (parallel/topology.py): the cluster shape
        # is engine state — a cutover on any backend's statement flips
        # every backend at its next epoch pin
        s._topology = self.session._topology
        # dispatcher + tenancy observability (serve/meta.py "sched" /
        # "tenants") spans backends
        s._dispatcher = getattr(self.session, "_dispatcher", None)
        s._tenancy = self.tenancy
        # one store-scan cache (exec/executor.py): its keys name immutable
        # partition files, so one backend's device copy serves every
        # other, and its LRU keeps the scan copies of ALL backends plus
        # the shared pool inside bufferpool.max_bytes (the reference
        # keeps one per backend, which bounds each alone; ROADMAP C 48)
        s._store_scan_cache = self.session._store_scan_cache
        s._store_scan_lock = self.session._store_scan_lock
        # one checkpoint store: recovery.max_statements bounds the
        # ENGINE's held checkpoints, not each backend's (statement ids
        # come from the shared stmt_log, so keys never collide)
        s._recovery = self.session._recovery
        # the write plane lives on the server session (group commit spans
        # backends); meta "ingest" answered by any backend must see it
        s._ingest = getattr(self.session, "_ingest", None)
        s._compactor = getattr(self.session, "_compactor", None)
        # memory-gauge anchor (obs/capacity.refresh_gauges): session-
        # private holders (stmt/store-scan caches) report the SERVING
        # session's, not whichever backend answered meta "metrics" —
        # stable values instead of per-connection flapping
        s._obs_root = self.session
        return s

    def _end_connection(self, sess) -> None:
        """Backend exit: an open wire transaction aborts (the reference
        rolls back on backend death — no orphaned prepared state)."""
        if sess is self.session:
            return
        if getattr(sess, "_txn_snapshot", None) is not None:
            try:
                sess.txn("rollback")
            except Exception:
                pass

    # --------------------------------------------------------------- control

    def start(self) -> "Server":
        self._transport.start()
        if not self.read_only:
            # a standby never runs jobs: the primary owns the schedule
            # (pg_cron likewise runs on the primary only)
            self.cron.start()
        if self.dispatcher is not None:
            self.dispatcher.start()
        if self.compactor is not None and not self.read_only:
            self.compactor.start()
        self.watchdog.start()
        return self

    def serve_forever(self) -> None:
        if not self.read_only:
            self.cron.start()  # foreground entry point runs jobs too
        if self.dispatcher is not None:
            self.dispatcher.start()
        if self.compactor is not None and not self.read_only:
            # parity with start(): the CLI serve path must run the
            # background compactor too, or `--set compact.enabled=true`
            # silently does nothing
            self.compactor.start()
        self.watchdog.start()
        self._transport.serve_forever()

    def stop(self, drain_s: float = 0.0) -> None:
        """Shut down; with ``drain_s`` > 0, gracefully (smart shutdown):
        new requests refuse with the retryable SERVER_DRAINING error
        while accepted in-flight work (handler threads AND the
        dispatcher queue) finishes; whatever is still running at the
        budget's end is CANCELLED with the same retryable drain error —
        every accepted request gets an answer, never a silent drop."""
        import time as _t

        self._draining = True
        if drain_s > 0:
            end = _t.monotonic() + drain_s
            with self._inflight_cond:
                while self._inflight and _t.monotonic() < end:
                    self._inflight_cond.wait(
                        timeout=min(0.1, max(end - _t.monotonic(), 0.01)))
            if self.dispatcher is not None:
                self.dispatcher.drain(max(0.0, end - _t.monotonic()))
            # stragglers past the budget: cancel cooperatively so their
            # handlers write the retryable drain error before we close
            for _sid, h in self.session.stmt_log.active_handles():
                h.token.cancel(
                    "drain", "statement abandoned by server drain; "
                    "retry against the serving primary")
            with self._inflight_cond:
                grace = _t.monotonic() + 2.0
                while self._inflight and _t.monotonic() < grace:
                    self._inflight_cond.wait(timeout=0.1)
        self.cron.stop()
        if self.dispatcher is not None:
            self.dispatcher.stop()
        if self.ingest is not None:
            # drain flush-on-stop: buffered rows whose appenders are
            # still blocked commit now (their acks turn true), and the
            # append verb has been refusing since _draining flipped
            self.ingest.stop()
        if self.compactor is not None:
            self.compactor.stop()
        self.watchdog.stop()
        self._transport.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------------- execution

    def _tenant_slot(self, tenant):
        """Per-tenant concurrency gate for statements that bypass the
        dispatcher (writes, non-parameterizable reads): a no-op without
        tenancy; otherwise bounded-wait admission that refuses with the
        retryable TenantQueueFull (sched/tenancy.py)."""
        import contextlib

        if self.tenancy is None:
            return contextlib.nullcontext()
        return self.tenancy.slot(tenant)

    def _execute(self, req: dict, sess, async_cb=None) -> Optional[dict]:
        if "cancel" in req:
            # the pg_cancel_backend analog: cancel a running statement by
            # its activity id ({"meta": "activity"} lists them). The
            # target fails with StatementCancelled at its next seam.
            # Deliberately ABOVE the drain gate: cancelling your own
            # straggler is most useful exactly while the server drains.
            try:
                sid = int(req["cancel"])
            except (TypeError, ValueError):
                return {"ok": False, "etype": "ValueError",
                        "retryable": False,
                        "error": "cancel needs an integer statement id"}
            if sess.stmt_log.cancel(sid):
                return {"ok": True, "status": f"CANCEL {sid}"}
            return {"ok": False, "etype": "UnknownStatement",
                    "retryable": False,
                    "error": f"no active statement {sid} "
                             "(already finished, or never started)"}
        if self._draining:
            # smart shutdown: accepted in-flight work finishes, NEW work
            # is refused with the RETRYABLE drain error so clients fail
            # over (the promoted standby / restarted primary serves it)
            return {"ok": False, "etype": "ServerDraining",
                    "retryable": True,
                    "error": "SERVER_DRAINING: server is draining for "
                             "shutdown; retry against the serving "
                             "primary"}
        if "meta" in req:
            # catalog metadata over the wire (the pg_catalog role for thin
            # clients)
            from cloudberry_tpu_torch.serve.meta import describe

            with self._locked():
                return {"ok": True,
                        "meta": describe(sess, req["meta"],
                                         req.get("arg"))}
        if "cron" in req:
            # scheduled statements over the wire (cron.schedule role)
            from cloudberry_tpu_torch.serve.cron import CronError

            c = req["cron"] if isinstance(req["cron"], dict) else {}
            op = c.get("op")
            try:
                if op == "status":
                    return {"ok": True, "jobs": self.cron.status()}
                if self.read_only:
                    return {"ok": False, "etype": "ReadOnlyError",
                            "retryable": False,
                            "error": "read-only standby: the primary "
                                     "owns the cron schedule"}
                if op == "schedule":
                    self.cron.schedule(c.get("name", ""),
                                       float(c.get("interval_s", 0)),
                                       c.get("sql", ""))
                    return {"ok": True, "status": f"SCHEDULE {c['name']}"}
                if op == "unschedule":
                    self.cron.unschedule(c.get("name", ""))
                    return {"ok": True,
                            "status": f"UNSCHEDULE {c['name']}"}
                return {"ok": False, "retryable": False,
                        "error": f"unknown cron op {op!r}"}
            except (CronError, ValueError) as e:
                return {"ok": False, "etype": type(e).__name__,
                        "retryable": False, "error": str(e)}
        if "retrieve" in req:
            # retrieve-mode request (cdbendpointretrieve.c analog): drain
            # one endpoint of a parallel cursor; token REQUIRED on the wire
            r = req["retrieve"]
            if not isinstance(r, dict) or "token" not in r:
                return {"ok": False, "retryable": False,
                        "error": "retrieve needs cursor/segment/token"}
            with self._locked():
                out = sess.retrieve(
                    r.get("cursor", ""), int(r.get("segment", 0)),
                    r.get("limit"), r["token"])
            out["rows"] = [[_json_safe(v) for v in row]
                           for row in out["rows"]]
            return {"ok": True, **out}
        if "append" in req:
            # streaming ingest verb: rows buffer server-side and the
            # response is written only when the covering flush COMMITS
            # (durability-at-ack, same contract as a successful INSERT).
            # Works on both transports — the handler blocks for at most
            # the flush latency, which is the point of group commit.
            a = req["append"]
            if not isinstance(a, dict) or "table" not in a \
                    or "rows" not in a:
                return {"ok": False, "retryable": False,
                        "error": "append needs "
                                 "{table, rows[, columns]}"}
            if self.read_only:
                return {"ok": False, "etype": "ReadOnlyError",
                        "retryable": False,
                        "error": "read-only standby: route appends to "
                                 "the primary server"}
            if self.ingest is None:
                return {"ok": False, "etype": "IngestDisabled",
                        "retryable": False,
                        "error": "streaming ingest is disabled "
                                 "(config.ingest.enabled)"}
            dl = req.get("deadline_s")
            n = self.ingest.append(
                a["table"], a["rows"], columns=a.get("columns"),
                tenant=req.get("tenant"),
                deadline_s=float(dl) if dl is not None else None)
            return {"ok": True, "status": f"APPEND {n}", "rows": n}
        sql = req.get("sql")
        if not isinstance(sql, str):
            return {"ok": False, "retryable": False,
                    "error": "request must carry a 'sql' string"}
        # per-request deadline: every dispatch path converts it to the
        # session's monotonic deadline, so it governs execution (cancel
        # seams, watchdog), not just the dispatcher queue
        deadline = None
        if req.get("deadline_s") is not None:
            import time as _t

            deadline = _t.monotonic() + float(req["deadline_s"])
        if self.read_only and not _is_read(sql):
            # hot standby: reads only; the store's epoch sync delivers the
            # primary's commits, nothing here may produce one
            return {"ok": False, "etype": "ReadOnlyError",
                    "retryable": False,
                    "error": "read-only standby: route writes to the "
                             "primary server"}
        tenant = req.get("tenant")
        if self.dispatcher is not None and _is_read(sql) \
                and _first_word(sql) not in _TXN_STARTERS \
                and getattr(sess, "_txn_snapshot", None) is None \
                and self._parameterizable(sql):
            # micro-batch dispatch: PARAMETERIZABLE reads coalesce on the
            # server session (same committed snapshot a fresh backend
            # would read); a connection holding an open transaction keeps
            # its own session so its snapshot stays visible.
            # Non-parameterizable reads keep the concurrent handler-thread
            # path — routing them through the single dispatcher worker
            # would head-of-line-block point lookups behind heavy scans.
            if async_cb is not None:
                # event-loop serving: the worker hands the request to the
                # dispatcher and RETURNS — thousands of queued reads cost
                # queue slots, not blocked worker threads; the response
                # is rendered and written when the batch lands
                def _done(r):
                    if r.error is not None:
                        async_cb(self._error_resp(r.error))
                        return
                    try:
                        async_cb(self._finish_render(sql, r.result,
                                                     tenant=tenant))
                    except Exception as e:
                        async_cb(self._error_resp(e))

                self.dispatcher.submit_nowait(
                    sql, deadline_s=req.get("deadline_s"),
                    tenant=tenant, on_done=_done)
                return None
            result = self.dispatcher.submit(
                sql, deadline_s=req.get("deadline_s"), tenant=tenant)
        elif self.per_connection:
            # each connection is its own backend: statement-level locking
            # is unnecessary (no shared catalog objects) and transactions
            # ride the store's multi-session OCC
            with self._tenant_slot(tenant):
                result = sess.sql(sql, _deadline=deadline)
        elif _first_word(sql) in _TXN_STARTERS:
            # all connections share ONE session: a wire-level BEGIN would
            # absorb other clients' autocommit writes into its rollback
            # scope — refuse rather than silently break their durability
            return {"ok": False, "retryable": False, "error":
                    "transactions over the wire need a durable store "
                    "(connections share one session); start the server "
                    "with config.storage.root set, or use the in-process "
                    "API for BEGIN/COMMIT/ROLLBACK"}
        else:
            # shared session: reads share, catalog mutations exclude —
            # concurrent readers would race the data/stats swap (the OCC
            # layer handles cross-PROCESS writers; this lock, threads)
            with self._tenant_slot(tenant), \
                    self._locked(write=not _is_read(sql)):
                result = sess.sql(sql, _deadline=deadline)
        return self._finish_render(sql, result, tenant=tenant)

    def _finish_render(self, sql: str, result, tenant=None) -> dict:
        """Render one SQL result with serving-side observability: render
        time feeds the stage histogram and the
        response's estimated wire bytes feed the per-skeleton
        statements table (obs/statements.py)."""
        import time as _t

        t0 = _t.perf_counter()
        resp = self._render(result)
        log = self.session.stmt_log
        if log.obs_enabled:
            from cloudberry_tpu_torch.obs.metrics import observe_stage

            observe_stage(log, "render", _t.perf_counter() - t0)
            log.statements.add_wire(sql, _resp_bytes(resp))
            # tenant-labeled served counter: the registry's per-tenant
            # attribution (obs/metrics.py bump tenant=) without a new
            # snapshot surface
            log.bump("requests_served", tenant=tenant)
        return resp

    def _render(self, result) -> dict:
        """One execution result → the wire response dict (shared by the
        synchronous paths and the dispatcher's async completion)."""
        if isinstance(result, dict):
            # DECLARE PARALLEL RETRIEVE CURSOR: endpoint directory + token
            return {"ok": True, **{k: _json_safe(v) if not isinstance(
                v, (list, dict)) else v for k, v in result.items()}}
        if hasattr(result, "decoded_columns"):
            # pandas-free serialization: DataFrame construction with arrow
            # string dtypes is not thread-safe, and handlers run threaded
            cols = result.decoded_columns()
            names = list(cols)
            arrays = list(cols.values())
            n = len(arrays[0]) if arrays else 0
            return {
                "ok": True,
                "columns": names,
                "rows": [[_json_safe(a[i]) for a in arrays]
                         for i in range(n)],
                "rowcount": n,
            }
        return {"ok": True, "status": str(result)}


# --------------------------------------------------------------- transports


class _ThreadedTransport:
    """The legacy thread-per-connection transport (socketserver), kept
    behind ``config.serve.threaded``: one OS thread per connection,
    blocking line reads, the same request core (Server._process_line)
    the event-loop front end uses — plus the shared accept-path
    connection cap."""

    def __init__(self, server: Server, host: str, port: int):
        outer = server

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                from cloudberry_tpu_torch.utils.faultinject import fault_point

                fault_point("serve_handler")
                addr = self.client_address[0]
                authed = outer.auth_token is None
                sess = None
                try:
                    # inside the try: a failed backend-session creation
                    # must still release the admitted connection slot
                    sess = outer._connection_session()
                    for line in self.rfile:
                        line = line.strip()
                        if not line:
                            continue
                        # in-flight window covers compute AND response
                        # write: drain waits until every accepted request
                        # has its answer on the wire
                        outer._request_begin()
                        try:
                            resp, authed = outer._process_line(
                                line, sess, authed, addr)
                            self.wfile.write(
                                json.dumps(resp).encode() + b"\n")
                            self.wfile.flush()
                        finally:
                            outer._request_end()
                        if resp.get("fatal"):
                            return
                finally:
                    try:
                        if sess is not None:
                            outer._end_connection(sess)
                    finally:
                        outer._conn_closed()

        class TCP(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True
            # bound the kernel accept queue too (socketserver's default
            # is 5 — too small under bursts; unbounded is the other sin)
            request_queue_size = max(16, outer._config.serve.listen_backlog)

            def verify_request(self, request, client_address):
                # the connection cap, enforced at accept: past it the
                # client gets ONE retryable SERVER_BUSY line and a close
                if outer._try_admit_conn():
                    return True
                try:
                    # best-effort, non-blocking: the refusal must never
                    # stall the accept thread on an unresponsive peer
                    request.setblocking(False)
                    request.send(outer._busy_line())
                except OSError:
                    pass
                return False

        self._server = TCP((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self._server.serve_forever()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
